"""In-repo MCMC ground truth: adaptive Hamiltonian Monte Carlo.

PyTorch port of viabel_tpu/mcmc.py: fixed-length HMC with uniformly
jittered trajectory lengths, dual-averaging step-size adaptation (Hoffman
& Gelman 2014, the scheme Stan uses) and a pooled diagonal mass matrix
estimated from warmup draws, for the smooth, low-dimensional posteriors
whose moments the repo uses as ground truth (the eight-schools CP truth is
NCP draws mapped to the CP scale, as the reference does).

The JAX package compiles each phase into one ``lax.scan`` over vmapped
chains, where the per-chain ``fori_loop`` with a batched trip count runs
to the longest chain and holds finished chains with a select.  The port
does the same explicitly, so that a transition needs no host decision:

* every chain runs `max_steps` leapfrog steps, and step k moves chain c
  only where ``k < n_steps[c]`` (`_leapfrog`);
* a phase's random numbers (momentum base normals, trajectory lengths,
  accept uniforms) are drawn before it in one block (`_phase_draws`), and
  each transition reads its row by a counter on the device;
* the chain state (position, its log density and gradient, the dual
  averaging's three scalars a chain, the counter, the draws written so
  far) lives on the device and is updated in place (`_ChainState`);
* on the card one transition is captured as a CUDA graph and replayed
  (`_run_graph`); on the CPU, and for a host-side log density
  (`models.external`), the same body runs eagerly (`_device.pick_driver`).

The gradient is `torch.autograd.grad` of the sum of the chains' log
densities; the log density and gradient at each chain's position are
carried from one leapfrog step to the next and from one transition to the
next, so a transition evaluates the density `max_steps` times.
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from ._device import (capture, default_generator, on_device, pick_driver,
                      resolve_device)
from .diagnostics import compute_R_hat
from .models.external import is_host_callback

__all__ = ['hmc_sample', 'hmc_ground_truth']

# dual-averaging hyperparameters (Hoffman & Gelman 2014, Alg. 5 / Stan
# defaults; viabel_tpu/mcmc.py:85-89)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75
# eager transitions on a side stream before a phase's capture: they warm
# autograd's and the allocator's state and the model's device data cache
_WARM = 3

# transitions run by the eager body and by graph replays since
# `reset_counts` (read by chip_smoke.py)
transitions = {'eager': 0, 'replayed': 0}


def reset_counts():
    for key in transitions:
        transitions[key] = 0


class _Draws(NamedTuple):
    """One phase's randomness: row i feeds transition i."""
    normals: torch.Tensor   # (n_iters, chains, d) momentum base normals
    lengths: torch.Tensor   # (n_iters, chains) int64 in 1..max_steps
    uniforms: torch.Tensor  # (n_iters, chains) accept uniforms in [0, 1)


class _ChainState(NamedTuple):
    """A phase's device-side state, updated in place by each transition."""
    q: torch.Tensor            # (chains, d) positions
    lp: torch.Tensor           # (chains,) log density at q
    grad: torch.Tensor         # (chains, d) its gradient
    log_eps: torch.Tensor      # (chains,) current log step size
    h_bar: torch.Tensor        # (chains,) dual-averaging statistic
    log_eps_bar: torch.Tensor  # (chains,) averaged log step size
    counter: torch.Tensor      # (1,) int64: the transition to run next
    qs: torch.Tensor           # (chains, n_iters, d) positions after each
    accepts: torch.Tensor      # (chains, n_iters) accept probabilities


def _phase_draws(generator, n_iters, n_chains, d, max_steps, dtype):
    """A phase's `_Draws` from `generator`, in one block each."""
    kw = dict(generator=generator, device=generator.device)
    return _Draws(
        torch.randn((n_iters, n_chains, d), dtype=dtype, **kw),
        torch.randint(1, max_steps + 1, (n_iters, n_chains), **kw),
        torch.rand((n_iters, n_chains), dtype=dtype, **kw))


def _value_and_grad(log_prob, q):
    """The chains' log densities ``(chains,)`` and their gradients
    ``(chains, d)``: `torch.autograd.grad` of their sum (each chain's
    density depends on its own row only)."""
    with torch.enable_grad():
        x = q.detach().requires_grad_(True)
        lp = log_prob(x)
        grad, = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), grad


def _leapfrog(log_prob, q, p, grad, lp, eps, inv_mass, n_steps, max_steps):
    """`max_steps` leapfrog steps of every chain under diagonal mass, step
    k moving chain c only where ``k < n_steps[c]``
    (viabel_tpu/mcmc.py:41-58 under ``vmap``).  `grad` and `lp` are the
    gradient and log density at `q`; the gradient is carried between
    steps, as the JAX package carries it.  Returns ``(q, p, grad, lp)`` at
    each chain's end."""
    eps = eps[:, None]
    for k in range(max_steps):
        p_half = p + 0.5 * eps * grad
        q_k = q + eps * inv_mass * p_half
        lp_k, grad_k = _value_and_grad(log_prob, q_k)
        p_k = p_half + 0.5 * eps * grad_k
        moving = k < n_steps
        row = moving[:, None]
        q = torch.where(row, q_k, q)
        p = torch.where(row, p_k, p)
        grad = torch.where(row, grad_k, grad)
        lp = torch.where(moving, lp_k, lp)
    return q, p, grad, lp


def _transition(log_prob, q, lp, grad, eps, inv_mass, normal, n_steps,
                uniform, max_steps):
    """One jittered-length HMC proposal and Metropolis accept of every
    chain (viabel_tpu/mcmc.py:61-82) on given draws: momentum ``sqrt(1 /
    inv_mass) * normal``, ``n_steps`` leapfrog steps, accept where
    ``log(uniform) < min(0, h0 - h1)`` (a non-finite value -inf).  Returns
    ``(q, lp, grad, accept_prob)``."""
    p = torch.sqrt(1.0 / inv_mass) * normal
    h0 = -lp + 0.5 * torch.sum(inv_mass * p * p, dim=-1)
    q_new, p_new, grad_new, lp_new = _leapfrog(
        log_prob, q, p, grad, lp, eps, inv_mass, n_steps, max_steps)
    h1 = -lp_new + 0.5 * torch.sum(inv_mass * p_new * p_new, dim=-1)
    log_accept = torch.clamp(h0 - h1, max=0.0)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                             -math.inf)
    accept = torch.log(uniform) < log_accept
    row = accept[:, None]
    return (torch.where(row, q_new, q), torch.where(accept, lp_new, lp),
            torch.where(row, grad_new, grad), torch.exp(log_accept))


def _new_state(log_prob, q0, eps0, n_iters):
    lp, grad = _value_and_grad(log_prob, q0)
    log_eps = torch.log(eps0)
    C, d = q0.shape
    return _ChainState(
        q0.clone(), lp, grad, log_eps.clone(), torch.zeros_like(eps0),
        log_eps.clone(), torch.zeros(1, dtype=torch.int64, device=q0.device),
        q0.new_empty((C, n_iters, d)), q0.new_empty((C, n_iters)))


def _step(log_prob, st, draws, inv_mass, mu, adapt, target_accept,
          max_steps):
    """The transition the device counter names, on `st` in place: the
    step of the JAX package's scan (viabel_tpu/mcmc.py:107-124), with dual
    averaging of the log step size toward `target_accept` when `adapt`.
    Nothing in it waits for the device or decides on the host, so the same
    body runs eagerly and under capture."""
    i = st.counter

    def row(block):
        return block.index_select(0, i).squeeze(0)

    q, lp, grad, accept_prob = _transition(
        log_prob, st.q, st.lp, st.grad, torch.exp(st.log_eps), inv_mass,
        row(draws.normals), row(draws.lengths), row(draws.uniforms),
        max_steps)
    st.q.copy_(q)
    st.lp.copy_(lp)
    st.grad.copy_(grad)
    st.qs.index_copy_(1, i, q[:, None])
    st.accepts.index_copy_(1, i, accept_prob[:, None])
    if adapt:
        t = i.to(q.dtype) + 1.0
        w = 1.0 / (t + _T0)
        h_bar = (1.0 - w) * st.h_bar + w * (target_accept - accept_prob)
        log_eps = mu - torch.sqrt(t) / _GAMMA * h_bar
        w2 = t ** (-_KAPPA)
        st.log_eps_bar.copy_(w2 * log_eps + (1.0 - w2) * st.log_eps_bar)
        st.h_bar.copy_(h_bar)
        st.log_eps.copy_(log_eps)
    st.counter.add_(1)


def _run_eager(body, n):
    for _ in range(n):
        body()
        transitions['eager'] += 1


def _run_graph(body, n, device):
    """`n` runs of `body` on the card: `_WARM` eagerly on a side stream,
    then the body captured once in a CUDA graph and replayed for the rest.
    A failed capture raises."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    warm = min(_WARM, n)
    with torch.cuda.stream(side):
        _run_eager(body, warm)
    if n > warm:
        graph = capture(body, side)
    main.wait_stream(side)
    for _ in range(n - warm):
        graph.replay()
        transitions['replayed'] += 1


def _phase(log_prob, q0, draws, eps0, inv_mass, adapt, target_accept,
           max_steps, driver=None):
    """One HMC phase of ``len(draws.lengths)`` transitions from `q0`
    ``(chains, d)`` with per-chain step sizes `eps0` (viabel_tpu/mcmc.py:
    92-130).  With `adapt` the step size follows dual averaging and the
    averaged one is returned; else it stays `eps0`.  The driver follows
    `_device.pick_driver`'s rule.  Returns ``(positions (chains, n_iters,
    d), final q, step sizes, mean accept probability a chain)``."""
    n_iters = draws.lengths.shape[0]
    driver = pick_driver(driver, q0.device, is_host_callback(log_prob))
    mu = math.log(10.0) + torch.log(eps0)
    st = _new_state(log_prob, q0, eps0, n_iters)

    def body():
        _step(log_prob, st, draws, inv_mass, mu, adapt, target_accept,
              max_steps)

    if driver == 'graph':
        _run_graph(body, n_iters, q0.device)
    else:
        _run_eager(body, n_iters)
    if int(st.counter[0]) != n_iters:
        raise RuntimeError('the HMC phase stopped at transition {} of {}'
                           .format(int(st.counter[0]), n_iters))
    eps = torch.exp(st.log_eps_bar) if adapt else eps0
    return st.qs, st.q, eps, st.accepts.mean(dim=1)


def _phases(log_prob, mesh, q0, draws, eps0, inv_mass, adapt, target_accept,
            max_steps):
    """`_phase` of every chain: one group on `q0`'s device, or with `mesh`
    its ``chain`` axis groups (`optimizers._placement`), each on its
    device; every rank gathers the groups' ``(positions, final q, step
    sizes, accept)`` in chain order, on `q0`'s device."""
    from .optimizers import _gather_groups, _placement
    C, d = q0.shape
    n = draws.lengths.shape[0]
    groups, devices = _placement(mesh, 'chain', C, q0.device)
    local = {}
    for g, dev in devices.items():
        lo, hi, _ = groups[g]
        with on_device(dev):
            part = _Draws(*(t[:, lo:hi].to(dev) for t in draws))
            qs, q, eps, accept = _phase(
                log_prob, q0[lo:hi].to(dev), part, eps0[lo:hi].to(dev),
                inv_mass.to(dev), adapt, target_accept, max_steps)
            local[g] = torch.cat([qs.reshape(hi - lo, -1), q, eps[:, None],
                                  accept[:, None]], dim=1)
    qs, q, eps, accept = _gather_groups(groups, local, (n * d, d, 1, 1),
                                        q0.dtype, q0.device)
    return qs.reshape(C, n, d), q, eps[:, 0], accept[:, 0]


def _hmc_core(log_prob, q0, phase_draws, eps0, max_steps, target_accept,
              mesh=None):
    """The three phases from the chains' initial positions `q0` ``(chains,
    d)`` and each phase's `_Draws` (viabel_tpu/mcmc.py:203-236): warmup I
    adapts the step size under unit mass; the inverse mass is the pooled
    variance of the second half of its draws (at least 1e-8); warmup II
    re-adapts the step size under that mass; sampling runs at each chain's
    averaged step size.  The parity tests feed it the draws the JAX
    package derives from its keys.  With `mesh` each phase's chains split
    over its ``chain`` axis (`_phases`).  Returns ``(samples
    (chains, n_samples, d), step sizes, inv_mass, mean accept probability
    a chain)`` as tensors."""
    draws_w1, draws_w2, draws_s = phase_draws
    C, d = q0.shape
    eps_init = torch.full((C,), float(eps0), dtype=q0.dtype,
                          device=q0.device)
    unit_mass = torch.ones(d, dtype=q0.dtype, device=q0.device)

    def phase(q, draws, eps, inv_mass, adapt):
        return _phases(log_prob, mesh, q, draws, eps, inv_mass, adapt,
                       target_accept, max_steps)

    qs, q1, eps1, _ = phase(q0, draws_w1, eps_init, unit_mass, True)
    n_w1 = qs.shape[1]
    inv_mass = torch.var(qs[:, n_w1 // 2:].reshape(-1, d), dim=0,
                         correction=0).clamp_min(1e-8)
    _, q2, eps2, _ = phase(q1, draws_w2, eps1, inv_mass, True)
    samples, _, _, accept = phase(q2, draws_s, eps2, inv_mass, False)
    return samples, eps2, inv_mass, accept


def hmc_sample(log_prob, init, generator=None, n_samples=5000,
               n_warmup=1000, n_chains=4, max_steps=32, target_accept=0.8,
               init_jitter=1.0, eps0=0.1, device=None, mesh=None):
    """Adaptive-HMC posterior draws (viabel_tpu/mcmc.py:133-246).

    Parameters
    ----------
    log_prob : callable
        Batched log density ``(n, d) -> (n,)`` (the `Model.log_prob`
        convention works directly), rows independent.
    init : (d,) tensor or array
        Center of the overdispersed chain initialization
        ``init + N(0, init_jitter^2)``; its floating dtype is the run's
        (anything else runs in the default dtype).
    generator : torch.Generator, optional
        Draws the initial jitter, then each phase's block of randomness
        (default: seed 0 on `device`).
    n_samples, n_warmup, n_chains, max_steps, target_accept, eps0 :
        Sampler configuration.  Warmup runs in two halves, ``max(n_warmup
        // 2, 20)`` transitions of step-size dual averaging under a unit
        mass, then ``max(n_warmup - that, 20)`` of re-adaptation under the
        pooled diagonal mass estimated from the first half's second-half
        draws.
    device : the device to run on (None: the CUDA card).  On the card each
        transition is one replayed CUDA graph; a host-side log density
        (`models.make_callback_log_density`) runs eagerly.
    mesh : a `parallel.Mesh` with a ``chain`` axis that divides
        `n_chains`, optional.  The chains split over it: each device
        group runs its chains' phases on its device (on the card, each
        device captures and replays its own transition graph) from the
        same draws as without a mesh, and the pooled mass and the results
        are gathered on every rank.  `device` is then this rank's first
        device of the mesh.

    Returns
    -------
    dict with numpy ``samples`` (n_chains, n_samples, d), ``mean``,
    ``cov`` (pooled over chains), ``r_hat`` (split R-hat per dim),
    ``accept_rate`` (float), ``step_size`` (n_chains,), ``inv_mass`` (d,).
    """
    if mesh is not None:
        if 'chain' not in mesh.axis_names:
            raise ValueError(
                "hmc_sample partitions chains over a mesh axis named "
                "'chain'; the given mesh has axes {} (build it with "
                "make_mesh(axis_names=('chain',), ...))".format(
                    mesh.axis_names))
        if n_chains % mesh.shape['chain']:
            raise ValueError('the mesh chain axis size ({}) must divide '
                             'n_chains ({})'.format(mesh.shape['chain'],
                                                    n_chains))
        device = mesh.home()
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    init = torch.as_tensor(init, device=device)
    if not init.is_floating_point():
        init = init.to(torch.get_default_dtype())
    d, dtype = init.shape[0], init.dtype
    q0 = init[None, :] + init_jitter * torch.randn(
        (n_chains, d), generator=generator, dtype=dtype, device=device)
    n_w1 = max(n_warmup // 2, 20)
    n_w2 = max(n_warmup - n_w1, 20)
    phase_draws = [_phase_draws(generator, n, n_chains, d, max_steps, dtype)
                   for n in (n_w1, n_w2, n_samples)]
    samples, eps, inv_mass, accept = _hmc_core(
        log_prob, q0, phase_draws, eps0, max_steps, target_accept, mesh)
    samples = samples.cpu().numpy()
    flat = samples.reshape(-1, d)
    _, r_hat = compute_R_hat(samples, warmup=0)
    return dict(samples=samples,
                mean=flat.mean(axis=0),
                cov=np.cov(flat.T),
                r_hat=np.asarray(r_hat),
                accept_rate=float(accept.mean()),
                step_size=eps.cpu().numpy(),
                inv_mass=inv_mass.cpu().numpy())


def hmc_ground_truth(model, generator=None, transform=None, r_hat_tol=1.01,
                     **kwargs):
    """Posterior mean and covariance of a `Model` by `hmc_sample` from the
    origin (in the default dtype), with an R-hat convergence gate
    (viabel_tpu/mcmc.py:249-272).

    `transform` optionally maps the ``(n, d)`` numpy draws to a reporting
    scale before the moments are taken (e.g.
    `models.eight_schools_ncp_to_cp`, as the reference derives the CP
    truth from NCP draws).  Raises RuntimeError if any split R-hat exceeds
    `r_hat_tol`.  `kwargs` go to `hmc_sample`.
    """
    out = hmc_sample(model.log_prob, torch.zeros(model.dim),
                     generator=generator, **kwargs)
    bad = np.max(out['r_hat'])
    if bad > r_hat_tol:
        raise RuntimeError(
            'HMC not converged: max split R-hat {:.4f} > {}'.format(
                bad, r_hat_tol))
    samples = out['samples'].reshape(-1, model.dim)
    if transform is not None:
        samples = np.asarray(transform(samples))
    return dict(mean=samples.mean(axis=0), cov=np.cov(samples.T),
                diagnostics=out)
