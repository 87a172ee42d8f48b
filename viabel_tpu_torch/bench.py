"""The port's benchmark: the eight-schools story of bench.py on one card.

    python -m viabel_tpu_torch bench              # on the CUDA card
    python -m viabel_tpu_torch bench --device cpu # plain versions, CPU

The configurations of bench.py (the JAX package's benchmark, which stays
as it is), run through the port's entry points on eight-schools CP with a
mean-field Student-t(40) family, float32:

* KLVI, n_mc = 100, 5000 adagrad iterations, lr 0.01 -> 0.001 (the
  headline: ELBO-gradient evaluations a second; the reference laptop ran
  278.19 it/s);
* CHIVI, alpha 2, n_mc = 500, 5000 iterations (reference laptop 48.41
  it/s);
* the 2.5e6-sample draw + score pass and `all_bounds` (reference laptop
  25.4 s), with the card's kernel time of one draw + score pass from a
  `utils.profile_trace` trace (`utils.trace_device_time`);
* `psislw` over 2.5e6 log-weights;
* the fused `validated_vi`: 10000 KLVI iterations, a 2.5e6-sample bound
  pass, PSIS and the corrected moments;
* `validated_vi_multistart` with 8 starts of the same;
* `parallel.sharded_bound_psis` on a one-entry ``sample`` mesh.

Each configuration is called once to warm (the first call of a fit
captures its CUDA graphs), then timed over distinct seeds; each timed
region ends in ``torch.cuda.synchronize()``.  The KLVI headline is the
median of two groups of reps taken minutes apart, as bench.py's is.  The
one JSON line on standard output carries bench.py's `metric`, `unit`,
`vs_baseline` (against the reference laptop) and every key of its
`extra`, plus ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  Progress goes to standard error.  The sizes are keyword arguments
of `main`, bench.py's values by default.
"""
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BASE_KLVI_IT_S = 278.19      # reference laptop it/s, eight-schools CP KLVI
BASE_CHIVI_IT_S = 48.41      # reference laptop it/s, eight-schools CP CHIVI
BASE_BOUND_S = 25.4          # reference laptop 2.5e6-sample bound pass, s
N_MC_KLVI, N_MC_CHIVI = 100, 500
N_ITERS = 5000
N_BOUND = 2500000
N_STARTS = 8
REPS = 3                     # timed reps a configuration, after a warm call
# a profiler trace now and then comes back without kernel records; it is
# taken again this many times in all, then the device time is not measured
TRACE_ATTEMPTS = 6
METRIC = 'eight_schools_cp_klvi_elbo_grad_evals_per_s_per_chip'


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_line(device):
    """The card's name and power limit as nvidia-smi prints them, or the
    CPU's name."""
    if device.type != 'cuda':
        return 'cpu'
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '--id={}'.format(index)],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        log('nvidia-smi did not answer ({}): the power limit is not read'
            .format(e))
        return '{}, power limit not read'.format(
            torch.cuda.get_device_name(index))


def _timed(fn, device):
    """``(seconds, fn())`` on the host clock, the region closed by a
    synchronize of the card."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def steady_state_times(fn, device, reps):
    """The seconds of ``fn(1) .. fn(reps)`` after one warm call ``fn(0)``
    (bench.py:63-76); `fn` takes a seed, so each rep runs on its own
    draws."""
    _timed(lambda: fn(0), device)
    return [_timed(lambda r=r: fn(r + 1), device)[0] for r in range(reps)]


def draw_score_device_s(bound_pass, device):
    """The card's kernel time (s) of one draw + score pass from a
    `utils.profile_trace` trace, the trace taken again while it holds no
    kernel record (`TRACE_ATTEMPTS` in all); None, with the reason
    logged, when it is not measured."""
    from .utils import profile_trace, trace_device_time

    if device.type != 'cuda':
        log('draw+score device time: not measured (no card)')
        return None
    for attempt in range(TRACE_ATTEMPTS):
        trace_dir = tempfile.mkdtemp(prefix='viabel_torch_bench_trace_')
        try:
            with profile_trace(trace_dir):
                bound_pass(0)
            seconds = trace_device_time(trace_dir)
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        if seconds:
            return seconds
        log('profiler trace {} of {} held no kernel records'.format(
            attempt + 1, TRACE_ATTEMPTS))
        time.sleep(1.0)
    log('draw+score device time: not measured ({} traces without kernel '
        'records)'.format(TRACE_ATTEMPTS))
    return None


def main(device=None, n_iters=N_ITERS, n_bound=N_BOUND, n_starts=N_STARTS,
         reps=REPS):
    """Run the benchmark on `device` (None: the CUDA card) and print its
    JSON line; returns the line's object."""
    from . import (adagrad_optimize, black_box_chivi, black_box_klvi,
                   mean_field_t_variational_family, validated_vi,
                   validated_vi_multistart)
    from ._device import resolve_device
    from .bounds import all_bounds, family_moment_bounds
    from .experiments import get_samples_and_log_weights
    from .models import eight_schools_cp_model
    from .parallel import make_mesh, sharded_bound_psis
    from .psis import psislw

    device = resolve_device(device)
    card = device_line(device)
    log('device: {}'.format(card))
    model = eight_schools_cp_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    init = torch.zeros(fam.var_param_dim, dtype=torch.float32,
                       device=device)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # -- KLVI optimizer (headline) --
    klvi = black_box_klvi(fam, model, N_MC_KLVI, presampled=True)

    def klvi_fit(seed):
        return adagrad_optimize(n_iters, klvi, init, generator=gen(seed),
                                learning_rate=.01, learning_rate_end=.001,
                                device=device)[0]

    t_first, opt_param = _timed(lambda: klvi_fit(0), device)
    log('KLVI first call (incl. graph capture): {:.3f}s'.format(t_first))
    klvi_times_a = steady_state_times(klvi_fit, device, reps)
    klvi_it_s = n_iters / float(np.median(klvi_times_a))
    log('KLVI: median {:.3f}s of {} = {:.0f} it/s ({:.3g} evals/s); '
        'reference laptop {}'.format(
            float(np.median(klvi_times_a)),
            ['{:.3f}'.format(t) for t in klvi_times_a], klvi_it_s,
            klvi_it_s * N_MC_KLVI, BASE_KLVI_IT_S))
    mean, _ = fam.mean_and_cov(opt_param)
    log('posterior mean head: {}'.format(mean[:3].cpu().numpy()))

    # -- CHIVI optimizer --
    chivi = black_box_chivi(2, fam, model, N_MC_CHIVI, presampled=True)
    dt_chivi = min(steady_state_times(
        lambda r: adagrad_optimize(
            n_iters, chivi, opt_param, generator=gen(100 + r),
            learning_rate=.01, learning_rate_end=.001, device=device)[0],
        device, reps))
    chivi_it_s = n_iters / dt_chivi
    log('CHIVI: {:.3f}s = {:.0f} it/s; reference laptop {}'.format(
        dt_chivi, chivi_it_s, BASE_CHIVI_IT_S))

    # -- the bound pass: draw + score, then all_bounds --
    def bound_pass(r):
        return get_samples_and_log_weights(model, fam, opt_param, n_bound,
                                           generator=gen(200 + r),
                                           device=device)[1]

    dt_draw = min(steady_state_times(bound_pass, device, reps))
    device_s = draw_score_device_s(bound_pass, device)
    lw = bound_pass(0)
    q_var = fam.mean_and_cov(opt_param)[1].cpu().numpy()
    moment_bound_fn = family_moment_bounds(fam, opt_param)
    all_bounds(lw, q_var=q_var, moment_bound_fn=moment_bound_fn)  # warm
    lw_timed = bound_pass(1)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    dt_bounds_host, bounds = _timed(
        lambda: all_bounds(lw_timed, q_var=q_var,
                           moment_bound_fn=moment_bound_fn), device)
    dt_bound_total = dt_draw + dt_bounds_host
    log('bound pass: draw+score {:.4f}s + bounds {:.4f}s = {:.4f}s '
        '(reference laptop {}s); d2 = {:.3g}'.format(
            dt_draw, dt_bounds_host, dt_bound_total, BASE_BOUND_S,
            bounds['d2']))
    if device_s is not None:
        log('draw+score kernel time on the card (trace): {:.3f} ms of the '
            '{:.3f} ms wall'.format(device_s * 1e3, dt_draw * 1e3))

    # -- the fused pipeline: 2 n_iters KLVI + bound pass + PSIS + moments
    def fused(r):
        return validated_vi(model, fam, init, 2 * n_iters,
                            objective_and_grad=klvi, n_bound_samples=n_bound,
                            generator=gen(300 + r), learning_rate=.01,
                            learning_rate_end=.001,
                            device=device)['smoothed_log_weights']

    dt_fused = min(steady_state_times(fused, device, reps))
    log('fused validated_vi ({} KLVI iterations + {:.2g}-sample bounds + '
        'PSIS): {:.3f}s'.format(2 * n_iters, n_bound, dt_fused))

    # -- multistart: n_starts fused pipelines as one batch --
    def multistart(r):
        return validated_vi_multistart(
            model, fam, init, 2 * n_iters, n_starts=n_starts,
            objective_and_grad=klvi, n_bound_samples=n_bound,
            generator=gen(400 + r), learning_rate=.01,
            learning_rate_end=.001, device=device)['smoothed_log_weights']

    dt_multi = min(steady_state_times(multistart, device, reps))
    base_pipeline_s = 2 * n_iters / BASE_KLVI_IT_S + BASE_BOUND_S
    log('multistart ({} x validated_vi): {:.3f}s (reference laptop ~{:.0f}s '
        'one after another)'.format(n_starts, dt_multi,
                                    n_starts * base_pipeline_s))

    # -- the sharded bound + PSIS pass on a one-entry sample mesh --
    mesh1 = make_mesh(('sample',), shape=(1,), devices=[device])

    def sharded_pass(r):
        return sharded_bound_psis(model, fam, opt_param, n_bound, 500 + r,
                                  mesh1, moment_bound_fn=moment_bound_fn,
                                  q_var=q_var)[1]

    dt_sharded = min(steady_state_times(sharded_pass, device, reps))
    log('sharded bound+PSIS pass (one-entry mesh): {:.4f}s'.format(
        dt_sharded))

    # -- PSIS over the bound pass's log-weights, a distinct input a rep --
    psislw(lw)  # warm
    lw_reps = [lw_timed] + [bound_pass(r) for r in range(2, reps + 1)]
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    times = []
    for lw_r in lw_reps:
        dt, out = _timed(lambda lw_r=lw_r: psislw(lw_r), device)
        times.append(dt)
    dt_psis = min(times)
    khat = float(out[1])
    log('PSIS ({:.2g} weights): {:.4f}s, khat = {:.3f}'.format(
        n_bound, dt_psis, khat))

    # -- the headline again, minutes later in the same process --
    klvi_times_b = steady_state_times(lambda r: klvi_fit(600 + r), device,
                                      reps)
    klvi_it_s2 = n_iters / float(np.median(klvi_times_b))
    spread_pct = 100.0 * abs(klvi_it_s2 - klvi_it_s) / klvi_it_s
    klvi_reps_it_s = [n_iters / t for t in klvi_times_a + klvi_times_b]
    klvi_headline_it_s = float(np.median(klvi_reps_it_s))
    log('KLVI again: {:.0f} it/s against {:.0f} first ({:.1f}% apart); '
        'headline = median of {} reps = {:.0f} it/s'.format(
            klvi_it_s2, klvi_it_s, spread_pct, len(klvi_reps_it_s),
            klvi_headline_it_s))

    line = {
        'metric': METRIC,
        'value': round(klvi_headline_it_s * N_MC_KLVI, 1),
        'unit': 'evals/s/chip',
        'vs_baseline': round(klvi_headline_it_s / BASE_KLVI_IT_S, 2),
        'extra': {
            'klvi_evals_per_s_reps': [round(v * N_MC_KLVI, 1)
                                      for v in klvi_reps_it_s],
            'chivi_it_per_s': round(chivi_it_s, 1),
            'chivi_vs_baseline': round(chivi_it_s / BASE_CHIVI_IT_S, 2),
            'bound_2p5e6_s': round(dt_bound_total, 4),
            'bound_vs_baseline_speedup': round(
                BASE_BOUND_S / dt_bound_total, 1),
            'psis_2p5e6_s': round(dt_psis, 4),
            'khat': round(khat, 3),
            'fused_pipeline_s': round(dt_fused, 4),
            'fused_pipeline_vs_baseline_speedup': round(
                base_pipeline_s / dt_fused, 1),
            'multistart8_pipeline_s': round(dt_multi, 4),
            'multistart8_vs_baseline_speedup': round(
                n_starts * base_pipeline_s / dt_multi, 1),
            'draw_score_device_ms': (round(device_s * 1e3, 3)
                                     if device_s is not None else None),
            'draw_score_wall_ms': round(dt_draw * 1e3, 1),
            'sharded_bound_psis_s': round(dt_sharded, 4),
            'klvi_evals_per_s_rerun': round(klvi_it_s2 * N_MC_KLVI, 1),
            'within_session_spread_pct': round(spread_pct, 2),
            'device': card,
        },
    }
    print(json.dumps(line), flush=True)
    return line
