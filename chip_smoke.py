#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases, each printed as it goes; any failure exits non-zero before the
result line:

1. the card's name and power limit (``nvidia-smi``), then every CUDA
   source of ``viabel_tpu_torch/csrc`` built at once (one ``nvcc`` each,
   started together), with the build time and each kernel's registers;
2. the eight-schools path, with every kernel launch count set to 0 just
   before it and read just after: ``validated_vi`` on eight-schools CP
   with a mean-field Student-t(40) family (5000 presampled-KLVI adagrad
   iterations, n_mc = 100, lr 0.01 -> 0.001, a 2.5e6-sample bound pass,
   PSIS) in float32, then ``get_samples_and_log_weights`` + ``all_bounds``
   at 2.5e6 samples; bounds and khat must be finite and K1, K3 and the
   combine must have launched;
3. K1, K3 and the combine against their plain PyTorch versions at that
   path's shapes (the fitted q, n = 2.5e6, d = 10) in float64 (logic:
   1e-10 relative) and float32 (lw atol 2e-4 + rtol 2e-6, statistics rtol
   2e-5), then each kernel's time and its plain version's time in float32,
   by CUDA events (median of 15 launches after 3 warm-ups, L2 flushed
   before each);
4. that path's pipeline core at a small size on the card (kernels) against
   the same on the CPU (plain versions), float64, on shared draws;
5. where its time goes, at steady state: ``validated_vi`` again, the
   optimizer alone (it/s), the bound pass's draws and fused score, PSIS,
   and the card's busy share during the optimizer (``torch.profiler``; a
   trace without device time fails the run);
6. the regression path, with every launch count set to 0 just before it
   and read just after: ``rmsprop_IA_optimize_with_rhat`` on Bayesian
   linear regression (N = 100, D = 10, 4 chains, 5000 iterations, n_mc =
   100, lr 0.02) with a mean-field Gaussian in float32, the averaged fit,
   ``get_samples_and_log_weights`` + ``all_bounds`` at 1e6 samples, then
   ``improve_with_psis`` at 1e6 against the exact posterior; the fit's and
   PSIS's errors, d2, khat and W2 must be finite, and K2,
   ``philox_normal``, K3 and the combine must have launched; then the
   card's busy share during 500 IA iterations (``torch.profiler``);
7. K2 and ``philox_normal`` against their plain versions at that path's
   shapes (n = 1e6, d = 10, the averaged fit; f64 to 1e-10, f32 to the
   K1 tolerances), the device Philox's bits against the plain version's
   and Random123's known answers, and K1 with the regression density
   (mean-field t(40) on the robust-regression model) against its plain
   version; then the times of K2, ``philox_normal``, their plain versions
   and ``torch.randn`` for the same (n, d);
8. the regression path at a small size (2 chains, 300 iterations, 2e4
   samples, float64, one seed) on the card (kernels) against the CPU
   (plain versions): the same Philox streams give the same draws;
9. K2's draws held statistically: a KS test of ``philox_normal`` against
   N(0, 1), and d2 and khat from K2 against K1 fed ``torch.randn`` z at
   the same fit over 8 seeds each (|z| < 2 against K1's seed spread, the
   benchmarks/KHAT_NOISE.md method);
10. the ``run_experiment`` path, with every launch count set to 0 just
    before it and read just after: KLVI then CHIVI (mean-field t(40),
    lr 0.01 -> 0.001, n_mc 100 and 500, 1e6-sample bound and PSIS passes,
    float32) on eight-schools NCP (5000 + 5000 iterations from the stored
    NCP moments, examples/eight_schools.py ``--full``) and on the funnel
    (10000 + 10000 iterations from ``[0, -1, 1, 1]``, examples/funnel.py
    ``--full``); every khat, d2, W2 and mean error must be finite, K1, K3
    and the combine must have launched, and each of the four khats must lie
    within |z| < 3 of the JAX package's 16-seed band; then the card's busy
    share during 500 CHIVI iterations (``torch.profiler``);
11. K1 and K2 with the NCP and funnel densities against their plain
    versions at that path's shapes (the fitted q, n = 1e6; f64 to 1e-10,
    f32 to the K1 tolerances but the funnel's lw rtol 3e-5, printed with
    its reason), then K1's time with each density beside its plain
    version's and its bound, printed as per-model rows.

The line before the last is a JSON object with one entry per kernel:
route, source, the TPU kernel it replaces, launches on the paths of phases
2, 6 and 10 (summed), the float32 max abs error, its time, the plain
version's time, its bound (the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s float32, H100 SXM data-sheet peaks; integer
operations are counted at the float32 rate) and the library call's time
(``torch.randn`` for ``philox_normal``; no single PyTorch call computes
the others, so theirs is null).  The last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_ITERS, N_MC, N_BOUND = 5000, 100, 2_500_000
# the regression path (examples/linear_regression_ia.py main(full=True),
# depth cut from 20000 iterations to 5000)
IA_ITERS, IA_CHAINS, IA_LR, IA_BOUND = 5000, 4, 0.02, 1_000_000
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations a sample, counted from csrc/bound_pass.cuh and lw_stats.cu
# (each add, multiply, divide, compare, integer op and transcendental
# counts one, an FMA two): K1 = transform 20 + Student-t base 60 + the
# eight-schools CP density 137 + statistics 16; K3 = statistics 16 + load
# 1; the combine ~20 a partials row.  K2 = Philox and Box-Muller ~128 a
# group of 4 normals (10 rounds of 2 mulhi, 2 mullo, 4 xor and 2 key adds;
# 4 uniforms of 3; 2 pairs of log, sqrt, sincos (2) and 4 multiplies) +
# log q 3 a coordinate + transform 2 a coordinate + the regression
# density N (2 D + 7) + 6 D + 1 + statistics 16.
OPS_K1, OPS_K3, OPS_COMBINE = 233, 17, 20
OPS_PHILOX_GROUP = 128
# the same count for run_experiment's densities: eight-schools NCP 128
# (its CP 137 without the centring's divides and one log, plus an FMA for
# theta per school), the funnel 13; K1 adds transform 2, Student-t base 6
# a coordinate and statistics 16
OPS_DENSITY = {'eight_schools_ncp': 128, 'funnel': 13}
# run_experiment on the protocols of examples/eight_schools.py and
# examples/funnel.py with --full (nothing cut)
EXP_N, EXP_LR, EXP_LR_END = 1_000_000, 0.01, 0.001
EXP_ITERS = {'eight_schools_ncp': 5000, 'funnel': 10000}
# the JAX package's 16-seed khat bands, mean and sd, for these runs
# (benchmarks/RESULTS.md:19-20, 31-32, from benchmarks/khat_noise.py)
KHAT_BAND = {('eight_schools_ncp', 'KLVI'): (0.654, 0.029),
             ('eight_schools_ncp', 'CHIVI'): (0.568, 0.031),
             ('funnel', 'KLVI'): (0.80, 0.029),
             ('funnel', 'CHIVI'): (0.85, 0.026)}


def ops_k2(d, n_rows):
    return (OPS_PHILOX_GROUP * -(-d // 4) + 5 * d
            + n_rows * (2 * d + 7) + 6 * d + 1 + 16)


TOL = {'float64': dict(lw_atol=1e-10, lw_rtol=1e-10, rtol=1e-10),
       'float32': dict(lw_atol=2e-4, lw_rtol=2e-6, rtol=2e-5)}
# the regression density's statistics in float32: its log-weights sit near
# -120 (a float32 ulp is 7.6e-6 there), and the rescaled moments
# exp(lw - max)^alpha move by alpha times any difference in the max
REGRESSION_STATS_RTOL = {'float64': 1e-10, 'float32': 1e-4}
# the funnel's log-weights in float32: lw is about -z^2 / 2 with z = mu /
# exp(log_sigma), so an error e in log_sigma moves lw by 2 e |lw|, and
# log_sigma = mean + scale * t is rounded once by the kernel's FMA and twice
# by PyTorch (2.05e-6 relative seen at |lw| = 2.4e6 in a card test)
FUNNEL_F32_LW_RTOL = 3e-5
REPLACES = {
    'transform_score_partials':
        'viabel_tpu/ops/sample_score.py:364 (fused_location_scale_lw_stats, '
        'at 2e6dc2c^)',
    'lw_partials':
        'viabel_tpu/ops/sample_score.py:115 (streaming_lw_stats, at '
        '2e6dc2c^)',
    'combine_partials':
        'viabel_tpu/ops/sample_score.py:67 (_combine_tiles, the epilogue of '
        'both, at 2e6dc2c^)',
    'gaussian_sample_score_partials':
        'viabel_tpu/ops/sample_score.py:260 (fused_gaussian_lw_stats, at '
        '2e6dc2c^)',
    'philox_normal':
        'viabel_tpu/ops/sample_score.py:164 (_box_muller and '
        '_uniform_from_bits, the PRNG of fused_gaussian_lw_stats, at '
        '2e6dc2c^)',
}
SOURCE = {'transform_score_partials': 'lw_stats.cu', 'lw_partials':
          'lw_stats.cu', 'combine_partials': 'lw_stats.cu',
          'gaussian_sample_score_partials': 'gaussian_lw.cu',
          'philox_normal': 'gaussian_lw.cu'}
# device kernel names in nvcc's output -> the wrapper that launches them
_MANGLED = (('LoadedDraws', 'transform_score_partials'),
            ('PhiloxDraws', 'gaussian_sample_score_partials'),
            ('lw_partials_kernel', 'lw_partials'),
            ('combine_partials_kernel', 'combine_partials'),
            ('philox_normal_kernel', 'philox_normal'),
            ('philox_bits_kernel', 'philox_bits'))


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def log_ptxas(text):
    """Each kernel's registers, spills and shared memory from nvcc's
    ``-Xptxas=-v`` output, named by wrapper, type and the d it takes."""
    kernel = '?'
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            mangled = line.split("'")[1]
            name = next((v for k, v in _MANGLED if k in mangled), mangled)
            dtype = ('f64' if 'IdL' in mangled or 'IdE' in mangled
                     else 'f32' if 'IfL' in mangled or 'IfE' in mangled
                     else '')
            maxd = next((label for key, label in (
                ('Li10ELi10E', 'd=10'), ('Li32ELi0E', 'd<=32'))
                if key in mangled), '')
            kernel = ' '.join(w for w in (name, dtype, maxd) if w)
        elif 'registers' in line or 'spill' in line:
            log('  {}: {}'.format(kernel, line.split(':', 1)[-1].strip()
                                  if 'ptxas' in line else line.strip()))


def is_finite(value):
    return value == value and abs(value) != float('inf')


def median_ms(fn, reps=15, warmup=3):
    """Median device time of one ``fn()`` by CUDA events, with the L2
    cache flushed before each launch (the flush also keeps the queue busy
    while the host enqueues ``fn``)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device='cuda')
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name, got, want, atol, rtol):
    """Print the max abs and rel errors of `got` against `want`; raise
    unless every element is finite and within atol + rtol * |want|.
    Returns the max abs error."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    abs_err = float(err.max())
    rel_err = float((err / want.abs().clamp_min(1e-300)).max())
    log('  {}: max abs err {:.3e}, max rel err {:.3e} (atol {}, rtol {})'
        .format(name, abs_err, rel_err, atol, rtol))
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError('{} is outside its tolerance'.format(name))
    return abs_err


def reset_launches():
    from viabel_tpu_torch.ops import gaussian_lw, lw_stats
    lw_stats.reset_launches()
    gaussian_lw.reset_launches()


def read_launches():
    from viabel_tpu_torch.ops import gaussian_lw, lw_stats
    return {**lw_stats.launches, **gaussian_lw.launches}


def require_launched(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError('kernel {} never launched on the {} path'
                                 .format(name, path))


def main_path(vt, model, fam):
    """Phase 2: the eight-schools path, with the launch counts it made."""
    from viabel_tpu_torch.bounds import family_moment_bounds

    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    reset_launches()
    t0 = time.perf_counter()
    out = vt.validated_vi(model, fam, init, N_ITERS, n_mc_samples=N_MC,
                          n_bound_samples=N_BOUND, learning_rate=0.01,
                          learning_rate_end=0.001, device='cuda')
    torch.cuda.synchronize()
    t_vvi = time.perf_counter() - t0
    opt = out['opt_param']
    g = torch.Generator(device='cuda').manual_seed(1)
    t0 = time.perf_counter()
    _, lw = vt.get_samples_and_log_weights(model, fam, opt, N_BOUND,
                                           generator=g, device='cuda')
    bounds = vt.all_bounds(lw, q_var=out['q_cov'].cpu().numpy(),
                           moment_bound_fn=family_moment_bounds(fam, opt))
    torch.cuda.synchronize()
    t_bound = time.perf_counter() - t0
    launches = read_launches()

    b = out['bounds']
    log('validated_vi (first call, {} iters + {:.1e}-sample bound pass + '
        'PSIS): {:.3f} s'.format(N_ITERS, N_BOUND, t_vvi))
    log('  d2 = {!r}, khat = {!r}, W2 = {!r}'.format(
        float(b['d2']), out['khat'], b['W2']))
    log('  q mean head = {}'.format(out['q_mean'][:3].cpu().tolist()))
    log('  psis mean head = {}'.format(out['psis_mean'][:3].cpu().tolist()))
    log('get_samples_and_log_weights + all_bounds at {:.1e}: {:.3f} s, '
        'd2 = {!r}'.format(N_BOUND, t_bound, float(bounds['d2'])))
    log('kernel launches on the eight-schools path: {}'.format(launches))
    for name, value in (('d2', b['d2']), ('khat', out['khat']),
                        ('bound-pass d2', bounds['d2']),
                        ('W2', b['W2'])):
        if not is_finite(value):
            raise AssertionError('{} is not finite: {}'.format(name, value))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials'), 'eight-schools')
    return out, launches


def kernel_checks(model, fam, opt):
    """Phase 3: every kernel against its plain version, then timings."""
    from viabel_tpu_torch.ops import lw_stats as ops

    errs = {}
    g = torch.Generator(device='cuda').manual_seed(2)
    z64 = fam.base_sample(g, N_BOUND, torch.float64)
    d = fam.dim
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split('.')[1]]
        z = z64.to(dtype).contiguous()
        mean = opt[:d].to(dtype).contiguous()
        log_scale = opt[d:].to(dtype).contiguous()
        args = (z, mean, log_scale, model.kernel, model.kernel_data, fam.df)
        lw, parts = ops.transform_score_partials(*args)
        lw_p, parts_p = ops.transform_score_partials_plain(*args)
        stats_p = ops.combine_partials_plain(parts_p)
        rtol = tol['rtol']
        log('kernels vs plain versions, {}, n = {}:'.format(dtype, N_BOUND))
        # the float32 pass's errors are the ones kept for the JSON line
        errs = {
            'transform_score_partials': check_close(
                'K1 lw', lw, lw_p, tol['lw_atol'], tol['lw_rtol']),
            'lw_partials': check_close(
                'K3 partials, plain combine',
                ops.combine_partials_plain(ops.lw_partials(lw_p)), stats_p,
                0, rtol),
            'combine_partials': check_close(
                'combine of plain partials', ops.combine_partials(parts_p),
                stats_p, 0, rtol)}
        check_close('K1 + combine statistics', ops.combine_partials(parts),
                    stats_p, 0, rtol)
        check_close('K3 + combine statistics', ops.lw_stats(lw_p), stats_p,
                    0, rtol)

    n, nc = N_BOUND, parts.shape[0]
    times = {
        'transform_score_partials': (
            lambda: ops.transform_score_partials(*args),
            lambda: ops.transform_score_partials_plain(*args),
            n * d * 4 + n * 4 + nc * 6 * 4 + 4 * (4 * d + 16),
            n * OPS_K1),
        'lw_partials': (
            lambda: ops.lw_partials(lw_p),
            lambda: ops.lw_partials_plain(lw_p),
            n * 4 + nc * 6 * 4, n * OPS_K3),
        'combine_partials': (
            lambda: ops.combine_partials(parts_p),
            lambda: ops.combine_partials_plain(parts_p),
            nc * 6 * 4 + 5 * 4, nc * OPS_COMBINE),
    }
    return {name: timed_row(name, *spec, err=errs[name], n=n)
            for name, spec in times.items()}


def timed_row(name, kernel, plain, nbytes, nops, err, n, library=None):
    """The kernel's, its plain version's and the library call's device
    times, float32, beside the bound of the work."""
    ms = median_ms(kernel)
    plain_ms = median_ms(plain)
    library_ms = median_ms(library) if library is not None else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               max_abs_err=err, library_ms=library_ms)
    log('{}: {:.4f} ms (plain {:.4f} ms, library {}), bound {:.4f} ms by {} '
        '({} B, {} ops), float32, n = {}'.format(
            name, ms, plain_ms, 'none' if library_ms is None
            else '{:.4f} ms'.format(library_ms), row['bound_ms'],
            row['bound_by'], nbytes, nops, n))
    return row


def small_reference_check(vt, model, fam):
    """Phase 4: the pipeline core with the kernels (card) against the same
    core with the plain versions (CPU), float64, on shared draws."""
    from viabel_tpu_torch.optimizers import _wrap_objective
    from viabel_tpu_torch.pipeline import _pipeline_core
    from viabel_tpu_torch.psis import _tail_len

    n_iters, n_mc, n_bound = 200, 20, 20000
    obj = vt.black_box_klvi(fam, model, n_mc, presampled=True)
    g = torch.Generator().manual_seed(3)
    draws = obj.make_draws(g, n_iters, torch.float64)
    z = fam.base_sample(g, n_bound, torch.float64)
    outs = {}
    for dev in ('cpu', 'cuda'):
        outs[dev] = _pipeline_core(
            _wrap_objective(obj, None), fam, model, n_iters, 10, 0.01, 0.1,
            0.001, 2.0, _tail_len(n_bound, 1.0),
            torch.zeros(fam.var_param_dim, dtype=torch.float64, device=dev),
            draws.to(dev), z.to(dev))
    worst = 0.0
    for key in ('opt_param', 'log_weights', 'stats', 'khat', 'psis_mean',
                'psis_cov'):
        worst = max(worst, check_close(
            'pipeline core {} (cuda vs cpu)'.format(key),
            outs['cuda'][key].cpu(), outs['cpu'][key], 1e-9, 1e-8))
    log('pipeline core, card vs CPU at n_iters {}, n_bound {}, float64: '
        'max abs diff {:.3e}'.format(n_iters, n_bound, worst))


def wall(fn):
    """Host seconds of ``fn()`` between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def time_breakdown(vt, model, fam, opt):
    """Phase 5: where the main path's time goes, at steady state (every
    stage has run once already), and the card's busy share during the
    optimizer from a profiler trace."""
    from viabel_tpu_torch.experiments import draw_and_score
    from viabel_tpu_torch.psis import _psislw_1d, _tail_len, weighted_moments

    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    kw = dict(learning_rate=0.01, learning_rate_end=0.001, device='cuda')
    t_vvi, _ = wall(lambda: vt.validated_vi(
        model, fam, init, N_ITERS, n_mc_samples=N_MC,
        n_bound_samples=N_BOUND, **kw))
    obj = vt.black_box_klvi(fam, model, N_MC, presampled=True)
    g = torch.Generator(device='cuda').manual_seed(4)
    t_opt, _ = wall(lambda: vt.adagrad_optimize(
        N_ITERS, obj, init, generator=g, return_history=False, **kw))
    t_draw, z = wall(lambda: fam.base_sample(g, N_BOUND, torch.float32))
    t_score, (samples, lw, _) = wall(
        lambda: draw_and_score(model, fam, opt, z))
    tail_len = _tail_len(N_BOUND, 1.0)
    t_psis, _ = wall(lambda: weighted_moments(samples,
                                              _psislw_1d(lw, tail_len)[0]))
    log('steady state: validated_vi {:.3f} s; adagrad {} iters {:.3f} s '
        '({:.1f} it/s); t(40) draws {}x{} {:.4f} s; transform+score+stats '
        '{:.4f} s; PSIS+weighted moments {:.4f} s'.format(
            t_vvi, N_ITERS, t_opt, N_ITERS / t_opt, N_BOUND, fam.dim,
            t_draw, t_score, t_psis))
    n_prof = 500
    busy_s, launches, t_prof = profile_busy(lambda: vt.adagrad_optimize(
        n_prof, obj, init, generator=g, return_history=False, **kw))
    log('optimizer under the profiler ({} iters): wall {:.3f} s, device '
        'busy {:.4f} s ({:.1f} %), {:.0f} kernels an iteration'.format(
            n_prof, t_prof, busy_s, 100 * busy_s / t_prof,
            launches / n_prof))


def profile_busy(fn):
    """``(device busy s, kernels launched, wall s)`` of ``fn()`` under
    ``torch.profiler``; raises if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof, _ = wall(fn)
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in on_card) * 1e-6
    if busy_s == 0:
        raise AssertionError('the profiler trace holds no device time')
    return busy_s, sum(e.count for e in on_card), t_prof


def regression_model():
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model)
    data = data_generator_linear(N=100, D=10, alpha=1.0, noise_variance=0.25,
                                 rho=0.5, seed=42)
    return linear_regression_model(data['X'], data['Y'])


def ia_fit(vt, model, fam, n_iters, n_chains, dtype, device, generator):
    """The IA run of examples/linear_regression_ia.py main(): RMSProp-IA
    with R-hat windows of n_iters // 10 (at least 100), a tail of
    n_iters // 4, and the fit [avg_means[0][-1], avg_sigmas[0][-1]]."""
    obj = vt.black_box_klvi(fam, model, N_MC, presampled=True)
    init = torch.zeros(fam.var_param_dim, dtype=dtype, device=device)
    out = vt.rmsprop_IA_optimize_with_rhat(
        n_iters, obj, init, fam.dim, generator=generator,
        learning_rate=IA_LR, n_optimisers=n_chains,
        rhat_window=max(n_iters // 10, 100), tail_avg_iters=n_iters // 4,
        device=device)
    _, chains, avg_means, avg_sigmas, _, _, ia_log = out
    ia_param = torch.as_tensor(np.concatenate([avg_means[0][-1],
                                               avg_sigmas[0][-1]]),
                               dtype=dtype, device=device)
    return ia_param, chains, ia_log


def regression_path(vt):
    """Phase 6: the regression path, with the launch counts it made."""
    from viabel_tpu_torch.bounds import family_moment_bounds

    model = regression_model()
    fam = vt.mean_field_gaussian_variational_family(model.dim)
    reset_launches()
    t_ia, (ia_param, _, ia_log) = wall(lambda: ia_fit(
        vt, model, fam, IA_ITERS, IA_CHAINS, torch.float32, 'cuda',
        torch.Generator(device='cuda').manual_seed(0)))
    fit = vt.check_approx_accuracy(fam, ia_param, model.true_mean,
                                   model.true_cov)
    g = torch.Generator(device='cuda').manual_seed(1)

    def bound_pass():
        _, lw = vt.get_samples_and_log_weights(model, fam, ia_param,
                                               IA_BOUND, generator=g,
                                               device='cuda')
        return vt.all_bounds(
            lw, q_var=fam.mean_and_cov(ia_param)[1].cpu().numpy(),
            moment_bound_fn=family_moment_bounds(fam, ia_param))

    t_bound, bounds = wall(bound_pass)
    t_psis, (psis, _, _) = wall(lambda: vt.improve_with_psis(
        model, fam, ia_param, IA_BOUND, model.true_mean, model.true_cov,
        generator=torch.Generator(device='cuda').manual_seed(2),
        device='cuda'))
    launches = read_launches()

    log('regression IA ({} chains x {} iters, n_mc {}, lr {}, float32): '
        '{:.3f} s ({:.1f} it/s)'.format(IA_CHAINS, IA_ITERS, N_MC, IA_LR,
                                        t_ia, IA_ITERS / t_ia))
    log('  IA start iterations: mean {}, sigma {}'.format(
        ia_log['start_avg_mean_iters'], ia_log['start_avg_sigma_iters']))
    log('  fit mean error {!r} (std error {!r}) against the exact '
        'posterior'.format(float(fit['mean_error']),
                           float(fit['std_error'])))
    log('  bound pass at {:.1e} (K2 + philox_normal + K3 + combine): '
        '{:.3f} s; d2 = {!r}, W2 = {!r}'.format(
            IA_BOUND, t_bound, float(bounds['d2']), float(bounds['W2'])))
    log('  improve_with_psis at {:.1e}: {:.3f} s; khat = {!r}, PSIS mean '
        'error {!r} (std error {!r})'.format(
            IA_BOUND, t_psis, psis['khat'], float(psis['mean_error']),
            float(psis['std_error'])))
    log('kernel launches on the regression path: {}'.format(launches))
    for name, value in (('fit mean error', fit['mean_error']),
                        ('PSIS mean error', psis['mean_error']),
                        ('d2', bounds['d2']), ('khat', psis['khat']),
                        ('W2', bounds['W2'])):
        if not is_finite(float(value)):
            raise AssertionError('{} is not finite: {}'.format(name, value))
    require_launched(launches, ('gaussian_sample_score_partials',
                                'philox_normal', 'lw_partials',
                                'combine_partials'), 'regression')
    n_prof = 500
    busy_s, kernels, t_prof = profile_busy(lambda: ia_fit(
        vt, model, fam, n_prof, IA_CHAINS, torch.float32, 'cuda',
        torch.Generator(device='cuda').manual_seed(0)))
    log('regression IA under the profiler ({} iters, after the launch '
        'counts were read): wall {:.3f} s, device busy {:.4f} s ({:.1f} %), '
        '{:.0f} kernels an iteration'.format(
            n_prof, t_prof, busy_s, 100 * busy_s / t_prof,
            kernels / n_prof))
    return model, fam, ia_param, launches


def regression_kernel_checks(vt, model, fam, ia_param):
    """Phase 7: K2, philox_normal and the Philox bits against their plain
    versions, K1 with the regression density, then timings."""
    from viabel_tpu_torch.models import robust_regression_model
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops import lw_stats as ops
    from viabel_tpu_torch.ops.philox import philox4x32, philox_normal_plain

    n, d = IA_BOUND, fam.dim
    seed, offset = 0x9E3779B97F4A7C15, 0
    errs = {}
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split('.')[1]]
        mean = ia_param[:d].to(dtype).contiguous()
        log_std = ia_param[d:].to(dtype).contiguous()
        args = (mean, log_std, n, seed, offset, model.kernel,
                model.kernel_data)
        log('K2 and philox_normal vs plain versions, {}, n = {}, d = {}:'
            .format(dtype, n, d))
        lw, parts = gops.gaussian_sample_score_partials(*args)
        lw_p, parts_p = gops.gaussian_sample_score_partials_plain(*args)
        stats_p = ops.combine_partials_plain(parts_p)
        errs['gaussian_sample_score_partials'] = check_close(
            'K2 lw', lw, lw_p, tol['lw_atol'], tol['lw_rtol'])
        stats_rtol = REGRESSION_STATS_RTOL[str(dtype).split('.')[1]]
        check_close('K2 + combine statistics', ops.combine_partials(parts),
                    stats_p, 0, stats_rtol)
        z = gops.philox_normal(n, d, seed, offset, 0, dtype, 'cuda')
        z_p = philox_normal_plain(n, d, seed, offset, 0, dtype, 'cuda')
        ztol = 1e-12 if dtype == torch.float64 else 2e-6
        errs['philox_normal'] = check_close('philox_normal z', z, z_p, ztol,
                                            ztol)
    # the device generator's bits, on the stream's own counters
    s = torch.arange(n, dtype=torch.int64, device='cuda')
    counters = torch.stack([s & 0xFFFFFFFF, torch.ones_like(s),
                            torch.full_like(s, offset), s >> 32], dim=1)
    bits = gops.philox_bits(counters, seed)
    plain_bits = torch.stack(philox4x32(counters.unbind(1), (
        seed & 0xFFFFFFFF, seed >> 32)), dim=1)
    if not torch.equal(bits, plain_bits):
        raise AssertionError('device Philox bits differ from the plain '
                             'version')
    kat = gops.philox_bits(torch.tensor([[0x243f6a88, 0x85a308d3,
                                          0x13198a2e, 0x03707344]],
                                        device='cuda'), 0x299f31d0a4093822)
    if kat[0].tolist() != [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]:
        raise AssertionError('device Philox fails the known answer')
    log('  Philox bits: {} x 4 words equal to the plain version; known '
        'answer ok'.format(n))
    # K1 with the regression density: mean-field t(40), robust regression
    robust = robust_regression_model()
    tfam = vt.mean_field_t_variational_family(robust.dim, 40)
    g = torch.Generator(device='cuda').manual_seed(3)
    zt = tfam.base_sample(g, n, torch.float64)
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split('.')[1]]
        mean = torch.as_tensor(robust.true_mean, dtype=dtype, device='cuda')
        log_scale = torch.as_tensor(0.5 * np.log(np.diag(robust.true_cov)),
                                    dtype=dtype, device='cuda')
        k1_args = (zt.to(dtype).contiguous(), mean, log_scale, robust.kernel,
                   robust.kernel_data, 40.0)
        lw, parts = ops.transform_score_partials(*k1_args)
        lw_p, parts_p = ops.transform_score_partials_plain(*k1_args)
        check_close('K1 regression (robust, mf-t(40)) lw, {}'.format(dtype),
                    lw, lw_p, tol['lw_atol'], tol['lw_rtol'])
        check_close('K1 regression statistics, {}'.format(dtype),
                    ops.combine_partials(parts),
                    ops.combine_partials_plain(parts_p), 0,
                    REGRESSION_STATS_RTOL[str(dtype).split('.')[1]])

    n_rows = model.kernel_data[0].shape[0]
    lib_gen = torch.Generator(device='cuda').manual_seed(4)
    return {
        'gaussian_sample_score_partials': timed_row(
            'gaussian_sample_score_partials',
            lambda: gops.gaussian_sample_score_partials(*args),
            lambda: gops.gaussian_sample_score_partials_plain(*args),
            n * 4 + ops.n_chunks(n) * 6 * 4 + 4 * (2 * d + n_rows * (d + 1)),
            n * ops_k2(d, n_rows), errs['gaussian_sample_score_partials'],
            n),
        'philox_normal': timed_row(
            'philox_normal',
            lambda: gops.philox_normal(n, d, seed, offset, 0, torch.float32,
                                       'cuda'),
            lambda: philox_normal_plain(n, d, seed, offset, 0, torch.float32,
                                        'cuda'),
            n * d * 4, n * OPS_PHILOX_GROUP * -(-d // 4),
            errs['philox_normal'], n,
            library=lambda: torch.randn((n, d), generator=lib_gen,
                                        device='cuda')),
    }


def regression_card_vs_cpu(vt):
    """Phase 8: the regression path at a small size with the kernels (card)
    against the plain versions (CPU), float64, one seed: the Philox streams
    give both the same draws."""
    from viabel_tpu_torch.psis import weighted_moments

    model = regression_model()
    fam = vt.mean_field_gaussian_variational_family(model.dim)
    outs = {}
    for dev in ('cpu', 'cuda'):
        ia_param, chains, _ = ia_fit(vt, model, fam, 300, 2, torch.float64,
                                     dev, torch.Generator().manual_seed(5))
        samples, lw = vt.get_samples_and_log_weights(
            model, fam, ia_param, 20000,
            generator=torch.Generator().manual_seed(6), device=dev)
        slw, khat = vt.psislw(lw)
        mean, cov = weighted_moments(samples, slw)
        outs[dev] = dict(chains=torch.as_tensor(chains), ia_param=ia_param,
                         log_weights=lw, khat=khat, psis_mean=mean,
                         psis_cov=cov)
    worst = 0.0
    for key in outs['cpu']:
        worst = max(worst, check_close(
            'regression path {} (cuda vs cpu)'.format(key),
            outs['cuda'][key].cpu(), outs['cpu'][key], 1e-9, 1e-8))
    log('regression path, card vs CPU at 2 chains x 300 iters, 2e4 '
        'samples, float64: max abs diff {:.3e}'.format(worst))


def k2_statistics(vt, model, fam, ia_param, seeds=8):
    """Phase 9: K2's draws held statistically against N(0, 1) and against
    K1 fed torch.randn draws at the same fit."""
    from scipy import stats as sps

    from viabel_tpu_torch.bounds import divergence_bound
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops import lw_stats as ops
    from viabel_tpu_torch.ops.philox import philox_seed

    n, d = IA_BOUND, fam.dim
    z = gops.philox_normal(n // 10, d, 2024, 0, 0, torch.float64, 'cuda')
    ks = sps.kstest(z.flatten().cpu().numpy(), 'norm')
    log('KS of philox_normal against N(0, 1), {} values: D = {:.3e}, '
        'p = {:.3f}'.format(z.numel(), ks.statistic, ks.pvalue))
    if ks.pvalue < 1e-3:
        raise AssertionError('philox_normal fails the KS test')
    mean = ia_param[:d].contiguous()
    log_std = ia_param[d:].contiguous()
    results = {'K2': [], 'K1': []}
    for i in range(seeds):
        g = torch.Generator(device='cuda').manual_seed(100 + i)
        lw2, parts2 = gops.gaussian_sample_score_partials(
            mean, log_std, n, philox_seed(g), 0, model.kernel,
            model.kernel_data)
        st2 = ops.combine_partials(parts2)
        zr = torch.randn((n, d), generator=g, device='cuda')
        lw1, st1 = ops.transform_score_stats(zr, mean, log_std, model.kernel,
                                             model.kernel_data)
        for key, lw, st in (('K2', lw2, st2), ('K1', lw1, st1)):
            d2 = divergence_bound(None, _stats=dict(
                zip(vt.bounds.STAT_KEYS, st.cpu().tolist()), n=n))
            results[key].append((d2, float(vt.psislw(lw)[1])))
    for j, name in enumerate(('d2', 'khat')):
        a = np.array([r[j] for r in results['K2']])
        b = np.array([r[j] for r in results['K1']])
        z_score = (a.mean() - b.mean()) / max(b.std(ddof=1), 1e-12)
        log('{} over {} seeds: K2 {:.4f} +- {:.4f}, K1 on torch.randn '
            '{:.4f} +- {:.4f}; z = {:+.2f}'.format(
                name, seeds, a.mean(), a.std(ddof=1), b.mean(),
                b.std(ddof=1), z_score))
        if not abs(z_score) < 2:
            raise AssertionError('K2 {} is outside K1\'s seed noise'
                                 .format(name))


def ops_k1(d, density_ops):
    return 2 * d + 6 * d + density_ops + 16


def k1_bytes(n, d, staged):
    """K1's bytes in float32: z in, lw and the partials out, the mean,
    log-scales and the model's staged data in."""
    return n * d * 4 + n * 4 + -(-n // 2048) * 6 * 4 + 4 * (2 * d + staged)


def experiment_models(vt):
    """(model, family, float32 init on the card) of each run_experiment
    protocol."""
    from viabel_tpu_torch.models import eight_schools_ncp_model, funnel_model
    ncp, funnel = eight_schools_ncp_model(), funnel_model()
    fam10 = vt.mean_field_t_variational_family(10, 40)
    return [(ncp, fam10, vt.init_from_moments(fam10, ncp.true_mean,
                                              ncp.true_cov)),
            (funnel, vt.mean_field_t_variational_family(2, 40),
             torch.tensor([0.0, -1.0, 1.0, 1.0]))]


def experiment_path(vt):
    """Phase 10: run_experiment on eight-schools NCP and the funnel, with
    the launch counts the two runs made."""
    runs = {}
    reset_launches()
    for seed, (model, fam, init) in enumerate(experiment_models(vt)):
        t_run, out = wall(lambda: vt.run_experiment(
            model, fam, init.to('cuda', torch.float32), model.true_mean,
            model.true_cov, learning_rate=EXP_LR,
            learning_rate_end=EXP_LR_END, n_iters=EXP_ITERS[model.name],
            bound_w2=EXP_N, n_psis_samples=EXP_N, plot_contours=False,
            generator=torch.Generator(device='cuda').manual_seed(seed),
            device='cuda'))
        runs[model.name] = (t_run, out)
    launches = read_launches()

    for name, (t_run, out) in runs.items():
        n_iters = EXP_ITERS[name]
        log('run_experiment on {} (mf-t(40), {} + {} iterations, n_mc 100 '
            'and 500, bound and PSIS at {:.0e}, float32): {:.3f} s'.format(
                name, n_iters, n_iters, EXP_N, t_run))
        for fit, other in ((out[2], out[4]), (out[3], out[5])):
            method, psis, sec = fit['method'], other['psis_results'], \
                other['seconds']
            mean, sd = KHAT_BAND[(name, method)]
            z = (psis['khat'] - mean) / sd
            log('  {:5s} khat {!r} (JAX 16-seed band {} +- {}: z = {:+.2f}), '
                'd2 {!r}, W2 {!r}, fit mean error {!r}, PSIS mean error {!r}'
                .format(method, psis['khat'], mean, sd, z, float(other['d2']),
                        float(other['W2']), float(fit['mean_error']),
                        float(psis['mean_error'])))
            log('        optimizer {:.3f} s ({:.1f} it/s), bound pass {:.4f} '
                's, PSIS pass {:.4f} s'.format(
                    sec['optimize'], n_iters / sec['optimize'],
                    sec['bounds'], sec['psis']))
            for key, value in (('khat', psis['khat']), ('d2', other['d2']),
                               ('W2', other['W2']),
                               ('fit mean error', fit['mean_error']),
                               ('PSIS mean error', psis['mean_error'])):
                if not is_finite(float(value)):
                    raise AssertionError('{} {} {} is not finite: {}'.format(
                        name, method, key, value))
            if not abs(z) < 3:
                raise AssertionError('{} {} khat {} is outside the JAX '
                                     'package\'s band'.format(
                                         name, method, psis['khat']))
    log('kernel launches on the run_experiment path: {}'.format(launches))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials'), 'run_experiment')

    model, fam, init = experiment_models(vt)[0]
    chivi = vt.black_box_chivi(2, fam, model, 500, presampled=True)
    n_prof = 500
    busy_s, kernels, t_prof = profile_busy(lambda: vt.adagrad_optimize(
        n_prof, chivi, init.to('cuda', torch.float32), has_log_norm=False,
        learning_rate=EXP_LR, learning_rate_end=EXP_LR_END,
        return_history=False, device='cuda',
        generator=torch.Generator(device='cuda').manual_seed(9)))
    log('CHIVI on eight-schools NCP under the profiler ({} iters, after the '
        'launch counts were read): wall {:.3f} s ({:.1f} it/s), device busy '
        '{:.4f} s ({:.1f} %), {:.0f} kernels an iteration'.format(
            n_prof, t_prof, n_prof / t_prof, busy_s, 100 * busy_s / t_prof,
            kernels / n_prof))
    return {name: out[4]['opt_param'] for name, (_, out) in runs.items()}, \
        launches


def experiment_kernel_checks(vt, fits):
    """Phase 11: K1 and K2 with the NCP and funnel densities against their
    plain versions at the run_experiment path's shapes, then K1's times
    with each density."""
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops import lw_stats as ops

    rows = []
    for model, fam, _ in experiment_models(vt):
        name, d, n = model.name, model.dim, EXP_N
        fit = torch.as_tensor(fits[name], device='cuda')
        z64 = fam.base_sample(torch.Generator(device='cuda').manual_seed(7),
                              n, torch.float64)
        errs = {}
        for dtype in (torch.float64, torch.float32):
            tol = dict(TOL[str(dtype).split('.')[1]])
            if name == 'funnel' and dtype == torch.float32:
                tol['lw_rtol'] = FUNNEL_F32_LW_RTOL
                log('  funnel lw rtol {}: an error e in log_sigma moves lw '
                    '(about -z^2 / 2, z = mu / exp(log_sigma)) by 2 e |lw|'
                    .format(tol['lw_rtol']))
            mean = fit[:d].to(dtype).contiguous()
            log_scale = fit[d:].to(dtype).contiguous()
            log('K1 and K2 with the {} density vs plain versions, {}, n = {}, '
                'd = {}:'.format(name, dtype, n, d))
            k1_args = (z64.to(dtype).contiguous(), mean, log_scale,
                       model.kernel, model.kernel_data, fam.df)
            k2_args = (mean, log_scale, n, 0x5DEECE66D, 0, model.kernel,
                       model.kernel_data)
            for label, kernel, plain, args in (
                    ('K1', ops.transform_score_partials,
                     ops.transform_score_partials_plain, k1_args),
                    ('K2', gops.gaussian_sample_score_partials,
                     gops.gaussian_sample_score_partials_plain, k2_args)):
                lw, parts = kernel(*args)
                lw_p, parts_p = plain(*args)
                errs[label] = check_close(
                    '{} {} lw'.format(label, name), lw, lw_p, tol['lw_atol'],
                    tol['lw_rtol'])
                check_close('{} {} + combine statistics'.format(label, name),
                            ops.combine_partials(parts),
                            ops.combine_partials_plain(parts_p), 0,
                            tol['rtol'])
        staged = 0 if name == 'funnel' else 16
        row = timed_row(
            'transform_score_partials ({})'.format(name),
            lambda: ops.transform_score_partials(*k1_args),
            lambda: ops.transform_score_partials_plain(*k1_args),
            k1_bytes(n, d, staged), n * ops_k1(d, OPS_DENSITY[name]),
            errs['K1'], n)
        rows.append(dict(name='transform_score_partials', model=name, d=d,
                         n=n, **row))
    log('K1 by model density: {}'.format(json.dumps(rows)))


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import viabel_tpu_torch as vt
    from viabel_tpu_torch.models import eight_schools_cp_model
    from viabel_tpu_torch.ops import _build

    log(card_line())
    log('python {}, torch {}, cuda {}'.format(
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    t0 = time.perf_counter()
    nvcc_logs = _build.build_all()
    log('built {} in {:.1f} s'.format(', '.join(_build.SOURCES),
                                      time.perf_counter() - t0))
    for text in nvcc_logs.values():
        log_ptxas(text)

    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    out, launches = main_path(vt, model, fam)
    rows = kernel_checks(model, fam, out['opt_param'])
    small_reference_check(vt, model, fam)
    time_breakdown(vt, model, fam, out['opt_param'])

    rmodel, rfam, ia_param, r_launches = regression_path(vt)
    rows.update(regression_kernel_checks(vt, rmodel, rfam, ia_param))
    regression_card_vs_cpu(vt)
    k2_statistics(vt, rmodel, rfam, ia_param)

    fits, e_launches = experiment_path(vt)
    experiment_kernel_checks(vt, fits)

    kernels = [dict(name=name, route='cuda',
                    source='viabel_tpu_torch/csrc/' + SOURCE[name],
                    replaces=REPLACES[name],
                    launches=(launches[name] + r_launches[name]
                              + e_launches[name]),
                    max_abs_err=rows[name]['max_abs_err'],
                    ms=rows[name]['ms'], plain_ms=rows[name]['plain_ms'],
                    bound_ms=rows[name]['bound_ms'],
                    bound_by=rows[name]['bound_by'],
                    library_ms=rows[name]['library_ms'])
               for name in REPLACES]
    log(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        code = main()
    except Exception:  # report any phase's failure and exit non-zero
        import traceback
        traceback.print_exc()
        print('chip_smoke: FAIL', file=sys.stderr)
        code = 1
    sys.exit(code)
