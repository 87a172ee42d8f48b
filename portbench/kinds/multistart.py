"""``multistart``: a closed loop of
`viabel_tpu_torch.validated_vi_multistart` of the mix's ``n_starts``
starts, which the program perturbs itself by the mix's
``perturb_scale`` (start 0 at the configuration's init, start o >= 1 at
it plus N(0, 1) (o + 1) perturb_scale, from the call's generator).
``fit_s``: the window's seconds over the starts it completed.

A start perturbed far enough can leave float32's range, end in NaN, or
follow float64 only loosely.  Every start checked is therefore also
replayed by the reference in float32, the configuration's precision
(its ``witness``): a start whose own float32 replay misses the float64
reference by more than the cell's limits is one that float32 arithmetic
cannot be held to, and `correct` compares nothing of it."""
import torch

import viabel_tpu_torch as vt

from portbench import loops


def end_to_end(times, span, loop):
    return dict(fit_s=span / (len(times) * loop.units))


class Loop(loops.Loop):
    @property
    def units(self):
        return self.mix['n_starts']

    def call(self, seed, n_iters=None):
        out = vt.validated_vi_multistart(
            self.model, self.fam, self.init, n_iters or self.cfg['n_iters'],
            n_starts=self.mix['n_starts'],
            perturb_scale=self.mix['perturb_scale'],
            generator=self.generator(seed), **self.fit_kwargs())
        return [loops.summary(out['opt_param'][k], out['bounds'][k],
                              out['khat'][k], out['psis_mean'][k],
                              out['psis_cov'][k])
                for k in range(self.mix['n_starts'])]

    def _ref(self, side, seed):
        return side.multistart(seed, torch.as_tensor(self.init_host),
                               self.mix['n_starts'],
                               self.mix['perturb_scale'])

    def check(self, ref, seed, out):
        refs = self._ref(ref, seed)
        for r, w in zip(refs, self._ref(ref.at(torch.float32), seed)):
            r['witness'] = w
        return refs

    def control_pairs(self, ctl, ref, seed):
        ctls = self._ref(ctl, seed)
        return list(zip(ctls, self.check(ref, seed, ctls)))
