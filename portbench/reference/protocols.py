"""The timed calls worked out again from their seeds, in plain PyTorch.

`fit` is `validated_vi`'s protocol, `multistart` that of
`validated_vi_multistart` with its own perturbed starts, and `validate`
the validation pass of the public calls (draw, score, bounds, PSIS).
Each returns the numbers that the comparison reads.  `work` is the dtype
everything after the raw draws is computed in; the raw draws come from
generators on `device`, where the program draws them, which also runs
the bound pass; `opt_device` runs the optimizer (small per-iteration
tensors run faster on the host).  `tf32` lets the products
of the bound pass and the optimizer run in TF32 (the control of a
float32 configuration whose products are pinned to full float32).
"""
import contextlib

import torch

from . import philox, psis, vi


@contextlib.contextmanager
def matmul_tf32(on):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reference:
    """A configuration's reference: `ref` is its module under
    `reference/` (``family(cfg)`` and ``Target(cfg, work, device)``)."""

    def __init__(self, ref, cfg, work=torch.float64, device='cuda',
                 opt_device=None, tf32=False):
        self.module, self.cfg, self.work, self.tf32 = ref, cfg, work, tf32
        self.device = torch.device(device)
        self.opt_device = torch.device(opt_device or device)
        self.fam = ref.family(cfg)
        self.target = ref.Target(cfg, work, self.device)
        self.opt_target = (self.target if self.opt_device == self.device
                           else ref.Target(cfg, work, self.opt_device))

    def at(self, work):
        """This reference computed in `work` (products in full float32)."""
        return Reference(self.module, self.cfg, work, self.device,
                         self.opt_device)

    def _optimize(self, draws, init):
        cfg = self.cfg
        lrs = vi.learning_rates(cfg['n_iters'], cfg['learning_rate'],
                                cfg['learning_rate_end'])

        def grad(p, i):
            return self.fam.gradient(p, draws[..., i, :, :].to(self.work),
                                     self.opt_target.grad)

        with matmul_tf32(self.tf32):
            return vi.adagrad(grad, init.to(self.opt_device, self.work), lrs,
                              cfg['window'], cfg['epsilon'])

    def _opt_draws(self, gen):
        cfg = self.cfg
        z = self.fam.draws(gen, cfg['n_iters'] * cfg['n_mc'], self.work,
                           self.opt_device)
        return z.reshape(cfg['n_iters'], cfg['n_mc'], -1)

    def bound_pass(self, param, z):
        """Log-weights, bounds, PSIS and the corrected moments at `param`
        on base draws `z`, in blocks of rows."""
        p = param.to(self.device, self.work)
        block = self.cfg.get('reference_block', len(z))
        with matmul_tf32(self.tf32):
            xs, lws = [], []
            for lo in range(0, len(z), block):
                x = self.fam.transform(p,
                                       z[lo:lo + block].to(self.work))
                xs.append(x)
                lws.append(self.target.log_p(x) - self.fam.log_q(p, x))
            x, lw = torch.cat(xs), torch.cat(lws)
            q_cov = self.fam.cov(p)
            c2, c4 = self.fam.moments(p)
            out = vi.bounds(vi.lw_stats(lw), c2, c4,
                            q_cov.cpu().double().numpy())
            slw, khat = psis.psislw(lw)
            mean, cov = vi.weighted_moments(x, slw)
        out.update(khat=khat, psis_mean=mean, psis_cov=cov,
                   q_scale=float(torch.sqrt(torch.trace(q_cov.double()))))
        return out

    def fit(self, seed, init):
        """`validated_vi` from a generator of `seed` on the card: the
        optimizer's draws, then the bound pass's."""
        gen = vi.generator(seed, self.device)
        draws = self._opt_draws(gen)
        z = self.fam.draws(gen, self.cfg['n_bound_samples'], self.work,
                           self.device)
        param = self._optimize(draws, init)
        del draws
        return dict(param=param, **self.bound_pass(param, z))

    def inits(self, gen, init, n_starts, scale):
        """The starts that `validated_vi_multistart` makes: a Philox seed
        from `gen`, start 0 at `init`, start o >= 1 at ``init + z_o (o +
        1) scale`` with z the stream's normals."""
        z = philox.normal(n_starts, init.shape[0], vi.start_seed(gen))
        mult = (torch.arange(n_starts, dtype=torch.float64) + 1) * scale
        mult[0] = 0.0
        return (init.double()[None, :]
                + torch.as_tensor(z) * mult[:, None])

    def multistart(self, seed, init, n_starts, scale):
        """`validated_vi_multistart` of `n_starts` starts perturbed by
        `scale` around `init`: the perturbation's seed and then one seed
        for each start from `seed`'s generator, each start's draws from
        its own; the runs as one batch, then each bound pass in turn."""
        gen = vi.generator(seed, self.device)
        inits = self.inits(gen, init, n_starts, scale)
        gens = [vi.generator(vi.start_seed(gen), self.device)
                for _ in range(n_starts)]
        draws = torch.stack([self._opt_draws(g) for g in gens])
        zs = [self.fam.draws(g, self.cfg['n_bound_samples'], self.work,
                             self.device) for g in gens]
        params = self._optimize(draws, inits)
        del draws
        return [dict(param=p, **self.bound_pass(p, z))
                for p, z in zip(params, zs)]

    def validate(self, seed, param):
        """One validation pass at `param` from a generator of `seed`."""
        gen = vi.generator(seed, self.device)
        z = self.fam.draws(gen, self.cfg['n_bound_samples'], self.work,
                           self.device)
        return dict(param=param, **self.bound_pass(param, z))
