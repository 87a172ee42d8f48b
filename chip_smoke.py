#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases, each printed as it goes; any failure exits non-zero before the
result line:

1. the card's name and power limit (``nvidia-smi``), then every CUDA
   source of ``viabel_tpu_torch/csrc`` built at once, with the build time;
2. the main path, with every kernel launch count set to 0 just before it
   and read just after: ``validated_vi`` on eight-schools CP with a
   mean-field Student-t(40) family (5000 presampled-KLVI adagrad
   iterations, n_mc = 100, lr 0.01 -> 0.001, a 2.5e6-sample bound pass,
   PSIS) in float32, then ``get_samples_and_log_weights`` + ``all_bounds``
   at 2.5e6 samples; bounds and khat must be finite and every kernel must
   have launched;
3. each kernel against its plain PyTorch version at the main path's shapes
   (the fitted q, n = 2.5e6, d = 10) in float64 (logic: 1e-10 relative)
   and float32 (lw atol 2e-4 + rtol 2e-6, statistics rtol 2e-5), then each
   kernel's time and its plain version's time in float32, by CUDA events
   (median of 15 launches after 3 warm-ups, L2 flushed before each);
4. the whole pipeline core at a small size on the card (kernels) against
   the same on the CPU (plain versions), float64, on shared draws;
5. where the time goes, at steady state: ``validated_vi`` again, the
   optimizer alone (it/s), the bound pass's draws and fused score, PSIS,
   and the card's busy share during the optimizer (``torch.profiler``).

The line before the last is a JSON object with one entry per kernel:
route, source, the TPU kernel it replaces, launches on the main path, the
float32 max abs error, its time, the plain version's time, and its bound
(the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s float32,
H100 SXM data-sheet peaks).  No single PyTorch call computes these
statistics, so ``library_ms`` is null.  The last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_ITERS, N_MC, N_BOUND = 5000, 100, 2_500_000
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations a sample, counted from csrc/lw_stats.cu (each add, multiply,
# divide, compare and transcendental counts one): K1 = transform 20 +
# Student-t base 60 + the eight-schools CP density 137 + statistics 16;
# K3 = statistics 16 + load 1; the combine ~20 a partials row
OPS_K1, OPS_K3, OPS_COMBINE = 233, 17, 20
TOL = {'float64': dict(lw_atol=1e-10, lw_rtol=1e-10, rtol=1e-10),
       'float32': dict(lw_atol=2e-4, lw_rtol=2e-6, rtol=2e-5)}
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
}


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
    ``-Xptxas=-v`` output, named by kernel and type."""
    kernel = '?'
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            mangled = line.split("'")[1]
            name = next((k for k in REPLACES if k in mangled), mangled)
            kernel = '{} {}'.format(name, 'f64' if 'IdE' in mangled
                                    else 'f32' if 'IfE' in mangled else '')
        elif 'registers' in line or 'spill' in line:
            log('  {}: {}'.format(kernel, line.split(':', 1)[-1].strip()
                                  if 'ptxas' in line else line.strip()))


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


def main_path(vt, model, fam):
    """Phase 2: the port's main path, with the launch counts it made."""
    from viabel_tpu_torch.bounds import family_moment_bounds
    from viabel_tpu_torch.ops import lw_stats as ops

    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    ops.reset_launches()
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
    launches = dict(ops.launches)

    b = out['bounds']
    log('validated_vi (first call, {} iters + {:.1e}-sample bound pass + '
        'PSIS): {:.3f} s'.format(N_ITERS, N_BOUND, t_vvi))
    log('  d2 = {!r}, khat = {!r}, W2 = {!r}'.format(
        float(b['d2']), out['khat'], b['W2']))
    log('  q mean head = {}'.format(out['q_mean'][:3].cpu().tolist()))
    log('  psis mean head = {}'.format(out['psis_mean'][:3].cpu().tolist()))
    log('get_samples_and_log_weights + all_bounds at {:.1e}: {:.3f} s, '
        'd2 = {!r}'.format(N_BOUND, t_bound, float(bounds['d2'])))
    log('kernel launches on the main path: {}'.format(launches))
    for name, value in (('d2', b['d2']), ('khat', out['khat']),
                        ('bound-pass d2', bounds['d2']),
                        ('W2', b['W2'])):
        if not (value == value and abs(value) != float('inf')):
            raise AssertionError('{} is not finite: {}'.format(name, value))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('kernel {} never launched on the main path'
                                 .format(name))
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
    rows = {}
    for name, (kernel, plain, nbytes, nops) in times.items():
        ms = median_ms(kernel)
        plain_ms = median_ms(plain)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by='bytes' if t_bytes >= t_ops
                          else 'operations',
                          max_abs_err=errs[name])
        log('{}: {:.4f} ms (plain {:.4f} ms), bound {:.4f} ms by {} '
            '({} B, {} ops), float32, n = {}'.format(
                name, ms, plain_ms, rows[name]['bound_ms'],
                rows[name]['bound_by'], nbytes, nops, n))
    return rows


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
    from torch.profiler import ProfilerActivity, profile

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
    try:  # the profiler is a measurement aid: its failure fails nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_prof, _ = wall(lambda: vt.adagrad_optimize(
                n_prof, obj, init, generator=g, return_history=False, **kw))
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in on_card) * 1e-6
        launches = sum(e.count for e in on_card)
    except Exception as e:
        log('optimizer device busy share: not measured ({!r})'.format(e))
        return
    if busy_s == 0:
        log('optimizer device busy share: not measured (no device time '
            'in the profiler trace)')
        return
    log('optimizer under the profiler ({} iters): wall {:.3f} s, device '
        'busy {:.4f} s ({:.1f} %), {:.0f} kernels an iteration'.format(
            n_prof, t_prof, busy_s, 100 * busy_s / t_prof,
            launches / n_prof))


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

    kernels = [dict(name=name, route='cuda',
                    source='viabel_tpu_torch/csrc/lw_stats.cu',
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]['max_abs_err'],
                    ms=rows[name]['ms'], plain_ms=rows[name]['plain_ms'],
                    bound_ms=rows[name]['bound_ms'],
                    bound_by=rows[name]['bound_by'], library_ms=None)
               for name in REPLACES]
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
