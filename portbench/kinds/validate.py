"""``validate``: a closed loop of validation passes at a q fitted once,
at set-up, by `validated_vi` from the run's seed; a pass is the calls a
validating user makes: ``fam.base_sample`` (span ``draw``),
`experiments.draw_and_score` (``score``), `all_bounds` with ``q_var``
and `family_moment_bounds` (``bounds``), `psislw` then
`weighted_moments` (``psis``).  ``validate_ms``: the window over its
passes; ``validate_p95_ms``: the 95th percentile of every pass's
latency."""
import numpy as np
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch.experiments import draw_and_score

from portbench import loops
from portbench.loops import derive


def end_to_end(times, span, loop):
    return dict(validate_ms=1e3 * span / len(times),
                validate_p95_ms=1e3 * float(np.percentile(times, 95)))


class Loop(loops.Loop):
    def setup(self, seed):
        """q fitted by `validated_vi` from the run's seed, and what a
        validating user computes once for it."""
        self.fit_seed, self._ref_fit = derive(seed, 'fit'), None
        out = vt.validated_vi(self.model, self.fam, self.init,
                              self.cfg['n_iters'],
                              generator=self.generator(self.fit_seed),
                              **self.fit_kwargs())
        self.fit_out = loops.summary(out['opt_param'], out['bounds'],
                                     out['khat'], out['psis_mean'],
                                     out['psis_cov'])
        self.param = out['opt_param']
        self.q_var = self.fam.mean_and_cov(self.param)[1].cpu().numpy()
        self.moment_bound_fn = vt.family_moment_bounds(self.fam, self.param)

    def call(self, seed):
        g = self.generator(seed)
        with self.span('draw'):
            z = self.fam.base_sample(g, self.cfg['n_bound_samples'],
                                     self.param.dtype)
        with self.span('score'):
            samples, lw, _ = draw_and_score(self.model, self.fam, self.param,
                                            z)
        with self.span('bounds'):
            bounds = vt.all_bounds(lw, q_var=self.q_var,
                                   moment_bound_fn=self.moment_bound_fn)
        with self.span('psis'):
            slw, khat = vt.psislw(lw)
            mean, cov = vt.weighted_moments(samples, slw)
        return [loops.summary(self.param, bounds, khat, mean, cov)]

    def trace_call(self, seed):
        """The traced slice: ``trace_passes`` passes with their spans."""
        self.spans = True
        try:
            for i in range(self.mix['trace_passes']):
                self.call(derive(seed, 'trace pass', i))
        finally:
            self.spans = False
        return None

    def ref_fit(self, ref):
        if self._ref_fit is None:
            self._ref_fit = ref.fit(self.fit_seed,
                                    torch.as_tensor(self.init_host))
        return self._ref_fit

    def check(self, ref, seed, out):
        """A pass at the reference's own fit of q from the set-up seed."""
        return [ref.validate(seed, self.ref_fit(ref)['param'])]

    def control_pairs(self, ctl, ref, seed):
        """A run's set-up fit and its first passes, each side at its own
        fit."""
        init = torch.as_tensor(self.init_host)
        fits = [side.fit(derive(seed, 'fit'), init) for side in (ctl, ref)]
        pairs = [tuple(fits)]
        for i in range(self.mix['check_calls']):
            s = derive(seed, 'call', i)
            pairs.append(tuple(side.validate(s, f['param'])
                               for side, f in zip((ctl, ref), fits)))
        return pairs

    def setup_check(self, ref):
        """The set-up fit against the reference's fit from its seed."""
        return [(self.fit_out, self.ref_fit(ref))]
