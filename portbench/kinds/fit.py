"""``fit``: a closed loop of `viabel_tpu_torch.validated_vi` on the
configuration, one validated fit a call.  ``fit_s``: the window's
seconds over the fits it completed."""
import torch

import viabel_tpu_torch as vt

from portbench import loops


def end_to_end(times, span, loop):
    return dict(fit_s=span / (len(times) * loop.units))


class Loop(loops.Loop):
    def call(self, seed, n_iters=None):
        out = vt.validated_vi(self.model, self.fam, self.init,
                              n_iters or self.cfg['n_iters'],
                              generator=self.generator(seed),
                              **self.fit_kwargs())
        return [loops.summary(out['opt_param'], out['bounds'], out['khat'],
                              out['psis_mean'], out['psis_cov'])]

    def check(self, ref, seed, out):
        return [ref.fit(seed, torch.as_tensor(self.init_host))]

    def control_pairs(self, ctl, ref, seed):
        init = torch.as_tensor(self.init_host)
        return [(ctl.fit(seed, init), ref.fit(seed, init))]
