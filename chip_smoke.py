#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1, 3, 7, 11 and 12 and
                                           # the step kernel's check and
                                           # time, at stand-in fits; no
                                           # result line
    python3 chip_smoke.py --mesh-cards     # two cards or more: phase 21
                                           # (b)'s multistart on every
                                           # card, one process and 2
                                           # NCCL ranks, against one
                                           # card; no result line

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
   at 2.5e6 samples; bounds and khat must be finite, K1, K3, the combine
   and the adagrad step kernel must have launched, the step once an
   iteration and every iteration after the window's warm-up from a
   replayed CUDA graph;
3. K1, K3 and the combine against their plain PyTorch versions at that
   path's shapes (the fitted q, n = 2.5e6, d = 10) in float64 (logic:
   1e-10 relative) and float32 (lw atol 2e-4 + rtol 2e-6, statistics rtol
   2e-5), K1 and K3 again at an n that leaves a ragged tile and at an
   input one value off a multiple of 16 bytes, K3 and the combine with
   log-weights of -inf or +inf (against the plain versions and the
   reference's mean_lw and std_lw), then each kernel's two times and its
   plain version's time in float32 (K3 also at n = 1e6): CUDA events
   around the wrapper's call (median of 15 launches after 3 warm-ups, L2
   flushed before each), and the kernel's own duration on the card by
   name from a ``torch.profiler`` trace (mean of 10 launches, L2 flushed
   before each);
4. that path's pipeline core at a small size on the card (kernels, the
   adagrad run as a replayed graph) against the same on the CPU (plain
   versions), float64, on shared draws; then the graph run against the
   eager run of the same body on the card, float64, 2000 iterations, KLVI
   and CHIVI, and 200 iterations of the large-d fit's KLVI (d = 100, P =
   5150, whose step is a cluster launch) (1e-10 relative);
5. where its time goes, at steady state: ``validated_vi`` again, the
   bound pass's draws and fused score, PSIS; the optimizer alone (KLVI
   and CHIVI on eight-schools CP, 2000 iterations, float32) through the
   graph and through the eager loop in turns (graph, eager, eager, graph),
   and under each the card's busy share and kernels an iteration
   (``torch.profiler``; a trace without device time fails the run); the
   step kernel against its plain version (float64 and float32; KLVI
   passes no log-norm), then its times at P = 20 with the shape
   ``ops.adagrad.launch_shape`` chose: L2 flushed (events and the
   trace), hot in L2 inside a replayed CUDA graph (the trace), the plain
   version's, and the launch floor (an empty kernel of the same library
   launched with the same shape) both ways;
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
   K1 tolerances), K2 again on a regression whose padded rows fill the
   staged shared memory (the most rows that keep the kernel tag), the
   device Philox's bits against the plain version's
   and Random123's known answers, and K1 with the regression density
   (mean-field t(40) on the robust-regression model) against its plain
   version, aligned, ragged and off alignment, and its times; then the
   times of K2, ``philox_normal`` and their plain versions, with
   ``torch.randn`` for the same (n, d) timed in turns with ``philox_normal``
   (kernel, library, library, kernel);
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
    ``--full``); every khat, d2, W2 and mean error must be finite, K1, K3,
    the combine and the step kernel must have launched (the step as in
    phase 2), and each of the four khats must lie within |z| < 3 of the
    JAX package's 16-seed band; then the card's busy share during 500
    CHIVI iterations through the graph (``torch.profiler``);
11. K1 and K2 with the NCP and funnel densities against their plain
    versions at that path's shapes (the fitted q, n = 1e6; f64 to 1e-10,
    f32 to the K1 tolerances but the funnel's lw rtol 3e-5, printed with
    its reason; K1 also ragged and off alignment), then K1's times with
    each density beside its plain version's and its bound, printed as
    per-model rows;
12. every instance of the step kernel against its plain version (one
    block a run and clusters of blocks, window 10 and the runtime window
    7, with and without a log-norm: K 1, 4, 16 at P 4 and 5150, (1, 20),
    (2, 5150), (1, 45450), the P on each side of the one-block / cluster
    switch; float64 to 1e-12, float32 to 2e-5 relative plus 8 ulps of the
    largest value), each case with ``launch_shape``'s choice, then phase
    5's times at (K 16, P 4), (K 1, P 5150) and (K 1, P 45450);

13. the robust-regression multistart (benchmarks/khat_noise.py:183-207,
    nothing cut), with every launch count set to 0 just before it and read
    just after: ``validated_vi_multistart`` with 16 starts tiled from one
    init, 5000 iterations and a 1e6-sample bound pass each, float32, for
    mf-t(40) presampled KLVI (n_mc 100, lr 0.01), mf-t(40) CHIVI (n_mc
    500, lr 0.01, from a single 5000-iteration KLVI fit with +3 on the
    log-scales) and full-rank t(100) KLVI (n_mc 100, lr 0.1 -> 0.001); each
    configuration's 16 khats, their mean against the JAX package's 16-seed
    band (benchmarks/KHAT_NOISE.md for the mean-field configurations; for
    the full-rank one the JAX package's own float32 run of the same 16
    starts on the CPU, tools/jax_khat_band.py, with the TPU run's band
    printed for the record; inside or outside one sd is printed, 3 sd or
    more fails), every khat and d2 finite; K1 (the regression
    density), K3, the combine and the step kernel (one launch a batched
    iteration, replayed after the window) must have launched; then each
    configuration's batched optimizer alone (graph, 2000 iterations) and
    the card's busy share over 500;
14. the learning-rate sweep, counted the same way: ``validated_vi_sweep``
    on robust regression, mf-t(40) KLVI, rates 0.003, 0.01, 0.03, 0.1 with
    ends rate / 10, 5000 iterations, 1e5 bound samples; finite khats and
    d2s; K1, the combine and the step kernel (one batched launch an
    iteration, four learning-rate tables) must have launched;
15. (a) examples/large_d.py's default through the port's
    ``examples.large_d``, counted the same way: ``validated_vi`` with a full-rank Gaussian at d = 100 (P = 5150) on
    the N = 400 conjugate regression, from the prior, n_mc 800, 10000
    iterations, lr 0.05 -> 0.001, 1e6 bound samples; the example's own
    criterion (khat < 0.7, |mean - truth| < 0.05) must hold; K3, the
    combine and the step kernel at P = 5150 must have launched; (b) the
    same at examples/large_d.py ``--full``'s d = 300 (P = 45450, N 1200,
    40000 iterations, nothing cut: the presampled block is 38.4 GB), its
    wall, khat, d2, errors and peak memory, held to the same criterion and
    counted the same way; then 200 of its iterations through the graph
    under ``torch.profiler``: the step kernel's share of an iteration,
    kernels an iteration and the 8 kernels that take the most card time;
16. the batched pipelines (each of phase 13's configurations, 4 runs at
    their own rates) and a full-rank t ``validated_vi`` at a small size on
    the card against the CPU, float64, on shared draws (1e-10 relative);
17. the command line and the resume path, float32, each part with every
    launch count set to 0 just before it and read just after (the
    commands run in this process through ``__main__.main``): (a) ``run``
    with the default config (funnel, mf-t(40), presampled KLVI n_mc 100,
    adagrad 5000 iterations at lr 0.01, 1e6 bound samples; nothing cut,
    progress lines on), its bounds and khat finite, K1, K3, the combine and
    the step kernel launched (the step as in phase 2); (b) the same with
    ``--checkpoint-path`` (a checkpoint every 1000 iterations),
    uninterrupted, and interrupted after its second save and resumed: the
    two final checkpoints equal entry for entry, bit for bit, then held
    against plain ``adagrad_optimize`` on the same draws (largest relative
    difference printed; with progress lines the same bits) and the step's
    executions and replays counted; again at float64 through
    ``adagrad_optimize_resumable`` with a generator of seed 7 (resumed
    equals uninterrupted, plain within 1e-12 relative); (c) ``run`` of
    linear regression with 4 RMSProp-IA chains and checkpoints, 2000
    iterations (of the default 5000), interrupted after its first save and
    resumed, its checkpoint equal to the uninterrupted one's; K2,
    ``philox_normal``, K3 and the combine launched; (d) ``run`` of 2
    Adam-IA chains sampling inside the step (``--no-presampled``), mf-t on
    eight-schools CP, 2000 iterations; (e) examples/eight_schools_ia.py's
    protocol in its quick mode (CP 2250 and NCP 2750 iterations of 9000
    and 11000; 2 RMSProp-IA chains, mean-field Gaussian KLVI n_mc 100
    sampling inside the step), the averaging starts inside the history and
    the final-window R-hat maxima finite;
18. the HTTP service (``viabel_tpu_torch.serve``) in this process on
    127.0.0.1, port 0, float32, each part with every launch count set to 0
    just before it and read just after: served from the default config's
    fit (``_fit_from_config``: funnel, mf-t(40), presampled KLVI, adagrad
    5000 iterations; nothing cut); /health, /moments, /sample?n=1000,
    /log_prob of 1000 points and /bounds?n=1e6 (bounds and khat finite; K1
    and the combine launched); /fit of 5000 iterations and 1e6 bound
    samples (the step kernel once an iteration, replayed after the window;
    K1 and the combine), and with 4 starts (the batched step once a
    batched iteration); a second /fit while one runs (503); a thread of
    /sample calls during a /fit (every call succeeds, one before the fit
    ends, and the fit's bounds equal the same fit's with no readers to
    1e-6 relative); each endpoint's latency, the median of 20 calls;
19. external and native densities on the card, float64, counted the same
    way: ``validated_vi`` (mf-t(40), presampled KLVI n_mc 100, 2000
    iterations, 1e6 bound samples) on the native C++ robust regression and
    on the torch model with the same generator (fit, d2 and khat to 1e-9
    relative); the native run takes the eager driver (the step once an
    iteration, 0 replays), K3 and the combine and no K1; both walls and
    the native run's share of host time; then RMSProp-IA (2 chains, 300
    iterations) on the native eight-schools CP under vmap against the
    torch CP model (1e-9 relative);
20. HMC on the card: ``hmc_ground_truth`` on eight-schools NCP mapped to
    the CP scale (examples/eight_schools.py ``--hmc``: 8 chains, n_warmup
    1000; n_samples cut from 20000 to 4000), float32, each transition a
    replayed CUDA graph: max split R-hat < 1.01, the mean within 0.2 and
    the stdevs within 6 % of the stored CP truth (tests/test_mcmc.py:86-89);
    transitions a second, replays against transitions, and the card's busy
    share over 100 sampling transitions; then 50 transitions through the
    graph and through the eager body on the same draws, float64, adaptive
    and sampling (1e-10 relative);
21. the mesh paths (`viabel_tpu_torch.parallel`) on the one card, float32,
    each part with every launch count set to 0 just before it and read
    just after, each wall printed beside the card's name and power limit:
    (a) ``validated_vi`` of phase 2's configuration with its bound pass,
    PSIS and moments on a 4-way sample axis (cuda:0 listed 4 times):
    bounds and khat finite, K1, the combine and the step kernel launched;
    then the bound pass + PSIS + moments unsharded and on S = 1, 2, 4, 8
    shards (its cost on one card), and at float64 and 2e5 samples the
    sharded pass against the unsharded pass on its shards' draws (K1 on
    eight-schools CP, PSIS, and the K2 row-range route on regression, each
    to 1e-10), and standard-normal log-weights with one shard all -inf,
    their sharded statistics against the unsharded ``log_weight_stats``
    (1e-10; equal infinities and two NaNs count 0; the rescaled moments
    finite); (b) phase 13's mf-t KLVI multistart on a (4, 2) (chain,
    sample) mesh, its mean khat inside 3 sd of the JAX package's band; (c)
    the 4 RMSProp-IA regression chains on a 4-way chain axis (2000 of
    phase 6's 5000 iterations), then ``improve_with_psis_sharded`` at 1e6
    on 4 shards (K2 and ``philox_normal``) against ``improve_with_psis``
    on the same Philox draws; (d) ``/bounds?n=1e6`` of the service through
    a 2-way mesh, and its latency beside the service without a mesh; (e) 2
    ranks spawned on the one card over Gloo (over NCCL with a card each
    where there are two cards; the log says which), equal to the
    one-process 2-entry mesh bit for bit;
22. the last modules, float32, (a) and (b) each with every launch count set
    to 0 just before it and read just after, each wall printed beside the
    card's name and power limit: (a) ``python -m viabel_tpu_torch bench`` at
    bench.py's sizes, in a process of its own that reports its launch
    counts, as (c)'s trace is (``--fresh-worker``: traces taken after phase
    20's long one lose kernel records); the bench (`viabel_tpu_torch.bench`)
    runs KLVI and CHIVI 5000 iterations, the 2.5e6-sample bound pass and
    PSIS, the fused ``validated_vi`` of 10000 iterations, 8 starts of it and
    the one-entry sharded pass; its JSON line has bench.py's keys plus
    ``device``, every number finite (``draw_score_device_ms`` may be null
    after its logged retries), and K1, K3, the combine and the step kernel
    launched, the step once an iteration of every run and of the 8-start
    batch; (b) RMSProp-IA with ``perturbed_black_box_vi`` (scale 0.1) on
    phase 6's regression, 4 chains x 2000 of its 5000 iterations, and the
    averaged fit's bound pass at 1e6 (K2): R-hat maxima, the averaged
    parameter and d2 finite; then 2 chains x 200 iterations at float64 on
    the card against the CPU on shared draws (1e-10 of the largest value);
    (c) ``utils``: the kernel time of a ``profile_trace`` around one K1 pass
    is positive and no less than K1's ``device_ms`` (the trace's event
    categories and kernel records logged), ``count_compilations`` around one
    ``validated_vi`` counts at least one capture, and a ``Timer`` with
    ``sync`` of that fit prints its line.
23. the example layer (``viabel_tpu_torch.examples``), float32, each
    example with every launch count set to 0 just before it and read just
    after, each wall printed beside the card's name and power limit: (a)
    ``robust_regression``, ``funnel``, ``normal_mixture`` and
    ``eight_schools`` (stored truth) at ``--full``, nothing cut, and
    benchmarks/parity.py's 20 rows printed as ours, the JAX package's
    CPU-f64 and TPU-f32 columns (benchmarks/RESULTS_*.json) and the
    reference; every row with a seed band (benchmarks/KHAT_NOISE.json)
    within its mean +- 4 sd, the full-rank khat within the JAX package's
    CPU float32 band (-0.9063 +- 0.0635, tools/jax_khat_band.py) and the
    rooted-input W2 within 2 % of 2.72; (b) ``chivi_experiments`` at full
    widths (N, k, df, n_mc, iterations, 1e6 bound samples; each HMC truth
    cut from 20000 samples to 4000, gated at R-hat 1.01), every stage
    beside benchmarks/CHIVI_PROTOCOLS.md's line: each KLVI stage and the
    +0.1 and +0.6 CHIVI stages with a mean error below 0.05, the +1.4
    stage completing with a non-finite khat or a NaN mean error, the
    ESS-damped stage's ``param_move_rel`` finite, K1 launched at d = 10,
    14 and 30; then K1 on those protocols' regressions at d = 14 and 30
    against its plain version (n = 1e6; lw 1e-12 float64, 2e-5 float32);
    (c) ``multistart_pipeline --full``, ``linear_regression_ia``'s
    protocol 2 (N 200, k 20, 1500 of 7000 iterations), ``eight_schools_ia``
    full rank (3000 of 30000) and ``pod_layout`` at its own sizes with the
    card listed 8 times: every printed number finite, each part's kernels
    launched (protocol 2 and the IA run only ``philox_normal``, their
    chains' init noise); the multistart's best PSIS-corrected mean within
    0.25 of the NUTS truth; ``pod_layout``'s HMC chains at R-hat 1.01 or
    less and its multistart's best d2 below that of q at the start.

The line before the last is a JSON object with one entry per kernel:
route, source, the TPU kernel it replaces, launches on the paths of phases
2, 6, 10, 13, 14, 15 (a) and (b), 17, 18, 19, 21, 22 and 23 (summed), the
float32 max abs error, its time by
events around the call (``ms``) and on the card (``device_ms``), the plain
version's time, its bound (the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s float32, H100 SXM data-sheet peaks; integer
operations are counted at the float32 rate, and a division or a
transcendental as one operation though it costs the card many
instructions) and the library call's time (``torch.randn`` for
``philox_normal``; no single PyTorch call computes the others, so theirs
is null).  The adagrad step's row replaces no Pallas kernel but the body
of the JAX package's compiled scan; its launches are its executions,
graph replays included, and its ``instances`` (phase 12's timed rows: a
batch of 16 runs, P = 5150 and P = 45450) add ``graph_device_ms``,
``floor_device_ms``, ``floor_graph_device_ms`` and ``launch_shape`` (phase
5's log gives them for its own row, P = 20).  The last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import json
import math
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
N_OPT_ALONE = 2000   # phase 5 times the optimizer alone at this depth
WINDOW = 10          # adagrad's window, the iterations a graph run warms up
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


# the robust-regression seed-noise protocol of benchmarks/khat_noise.py:183-
# 207 (16 starts from one init, the start axis the seed axis), nothing cut;
# the JAX package's 16-seed khat means and sds (benchmarks/KHAT_NOISE.md)
MS_STARTS, MS_ITERS, MS_BOUND = 16, 5000, 1_000_000
# the full-rank band is the JAX package's own float32 run of the same 16
# starts on the CPU (tools/jax_khat_band.py: float32 -0.9063 +- 0.0635,
# float64 -0.9220 +- 0.0459); the TPU run's band (-0.685 +- 0.165,
# benchmarks/KHAT_NOISE.md) comes from the TPU's arithmetic, not from the
# algorithm, and is printed beside it for the record only
MS_BAND = {'mf-t KLVI': (0.929, 0.028), 'mf-t CHIVI': (0.354, 0.027),
           'full-rank t KLVI': (-0.906, 0.064)}
TPU_BAND = {'full-rank t KLVI': (-0.685, 0.165)}
# the learning-rate sweep on robust regression (mf-t(40) KLVI, ends rate /
# 10, the API's default 1e5 bound samples)
SWEEP_RATES, SWEEP_ITERS = (0.003, 0.01, 0.03, 0.1), 5000
# examples/large_d.py's default: d = 100 (P = 5150), full-rank Gaussian
LD_D, LD_ITERS, LD_MC, LD_BOUND = 100, 10000, 800, 1_000_000
# examples/large_d.py --full: d = 300 (P = 45450), 40000 iterations, the
# rest as the default.  Its presampled (40000, 800, 300) float32 block is
# 38.4 GB, and the bound pass's (1e6, 1200) means 4.8 GB each, within the
# card's 80 GB, so nothing is cut.  Then 200 iterations under the profiler
LD_FULL_D, LD_FULL_ITERS, LD_PROFILE_ITERS = 300, 40000, 200
# the JAX package's fits of the same configurations (benchmarks/
# DIM_SCALING.md, its TPU runs), printed for the record
LD_JAX = {100: 'khat +0.045, |mean - truth| 0.0010',
          300: 'khat +0.50, d2 2.2, |mean - truth| 0.0006, rel cov err '
               '0.040'}
# phase 17: the command line on the card.  (c) and (d) run 2000
# iterations, (e) the quick mode of examples/eight_schools_ia.py (2250 and
# 2750 of 9000 and 11000), to keep the eager IA chain steps within about a
# minute; every width is full
CLI_IA_ITERS = 2000
CLI_SAVE_EVERY = 1000  # the resumable drivers' default, which run uses
ES_IA = (('eight-schools CP', 'eight_schools_cp_model', 9000 // 4, 1.20, 0),
         ('eight-schools NCP', 'eight_schools_ncp_model', 11000 // 4, 1.15,
          1))
# phase 18: the service from the default config; each /fit 5000
# iterations with 1e6 bound samples (a start)
SERVE_BOUND = 1_000_000
SERVE_FIT = dict(n_iters=5000, n_bound_samples=SERVE_BOUND)
# phase 19: the native densities, validated_vi and the IA chains
NATIVE_ITERS, NATIVE_BOUND, NATIVE_IA_ITERS = 2000, 1_000_000, 300
# phase 20: examples/eight_schools.py --hmc's protocol (8 chains, n_warmup
# 1000), n_samples cut from 20000 to 4000; 50 transitions graph vs eager;
# the busy share over 100 sampling transitions (500 took ~130 s to trace)
HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, HMC_COMPARE = 8, 1000, 4000, 50
HMC_TRACE = 100
# phase 21: the mesh paths on the one card: a 4-way sample axis (cuda:0
# listed 4 times), phase 13's mf-t KLVI on a (4, 2) (chain, sample) mesh,
# the 4 regression IA chains on a 4-way chain axis (2000 of phase 6's 5000
# iterations, each chain's group one after another), /bounds through a
# 2-way mesh, and 2 ranks against one process; the f64 comparisons at
# 2e5 samples
MESH_S, MESH_IA_ITERS, MESH_SMALL, MESH_RANK_N = 4, 2000, 200_000, 1_000_000
MESH_COSTS = (1, 2, 4, 8)
# the IA chains on a chain mesh against the run without one, largest
# difference over largest value: float32 10x the reading on an H100
# (5.7e-5 of 5.44, 1.05e-5), float64 the optimizer runs' 1e-8 at 500
# iterations
MESH_IA_F64_ITERS = 500
MESH_IA_TOL = {'float32': 1e-4, 'float64': 1e-8}
# phase 22: the port's bench at bench.py's sizes; RMSProp-IA with
# perturbed_black_box_vi on phase 6's regression (4 chains, 2000 of its
# 5000 iterations, any fixed perturbation scale), and at float64 2 chains
# x 200 iterations on the card against the CPU
PERTURB_SCALE, PERTURB_ITERS, PERTURB_SMALL = 0.1, 2000, 200


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
    'adagrad_step':
        'viabel_tpu/optimizers.py:201-230 (_make_adagrad_step, the body of '
        'the compiled lax.scan; no Pallas kernel)',
}
SOURCE = {'transform_score_partials': 'lw_stats.cu', 'lw_partials':
          'lw_stats.cu', 'combine_partials': 'lw_stats.cu',
          'gaussian_sample_score_partials': 'gaussian_lw.cu',
          'philox_normal': 'gaussian_lw.cu', 'adagrad_step': 'adagrad.cu'}
# device kernel names in nvcc's output -> the wrapper that launches them
_MANGLED = (('LoadedDraws', 'transform_score_partials'),
            ('PhiloxDraws', 'gaussian_sample_score_partials'),
            ('lw_partials_kernel', 'lw_partials'),
            ('combine_partials_kernel', 'combine_partials'),
            ('philox_normal_kernel', 'philox_normal'),
            ('philox_bits_kernel', 'philox_bits'),
            ('adagrad_step_kernel', 'adagrad_step'))
# the wrapper -> the part of its device kernel's name that a trace shows
KERNEL_KEY = {wrapper: key for key, wrapper in _MANGLED}
FLOOR_KEY = 'launch_floor_kernel'  # the empty kernel of csrc/adagrad.cu
RANDN_KEY = 'distribution_elementwise'  # torch.randn's kernel, in a trace


def log(msg):
    print(msg, flush=True)


_START = time.perf_counter()


def phases_done(phases):
    """Log the host seconds since the script started, after `phases`."""
    log('-- phases {} done at {:.1f} s'.format(phases,
                                                time.perf_counter() - _START))


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def log_ptxas(text, only=''):
    """Each kernel's registers, spills and shared memory from nvcc's
    ``-Xptxas=-v`` output, named by wrapper, type and the d it takes
    (only the kernels whose name holds `only`)."""
    kernel = '?'
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            mangled = line.split("'")[1]
            name = next((v for k, v in _MANGLED if k in mangled), mangled)
            dtype = ('f64' if 'IdL' in mangled or 'IdE' in mangled
                     else 'f32' if 'IfL' in mangled or 'IfE' in mangled
                     else '')
            maxd = next((label for key, label in (
                ('Li10ELi10E', 'd=10'), ('Li2ELi2E', 'd=2'),
                ('Li32ELi0E', 'd<=32'),
                ('Li10ELb1E', 'window 10, cluster'),
                ('Li10ELb0E', 'window 10, one block'),
                ('Li0ELb1E', 'runtime window, cluster'),
                ('Li0ELb0E', 'runtime window, one block'))
                if key in mangled), '')
            kernel = ' '.join(w for w in (name, dtype, maxd) if w)
        elif only in kernel and ('registers' in line or 'spill' in line):
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


def device_ms(fn, key, reps=10, attempts=6, clean=False):
    """Mean duration on the card of the kernel whose name holds `key`, from
    a ``torch.profiler`` trace of `reps` calls of ``fn()`` with the L2 cache
    flushed before each.  The flush writes 256 MB, so the kernel finds L2
    full of dirty lines and its reads make the card write them back; with
    `clean` it reads the 256 MB instead, leaving clean lines.  Unlike
    `median_ms` it holds none of the time the host takes to enqueue the
    launch, nor the copies and casts the wrapper makes before it.  A trace
    now and then comes back without its kernel records (up to three traces
    in a row, after a short trace as after a long one), so a trace without
    the kernel is taken again after a pause, `attempts` times in all; then
    this returns None (not measured).  It times, and checks nothing: the
    kernels' launches and results are held elsewhere."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device='cuda')
    fn()

    def run():
        for _ in range(reps):
            if clean:
                flush.sum()
            else:
                flush.zero_()
            fn()

    return traced_kernel_ms(run, key, attempts)


def traced_kernel_ms(run, key, attempts=6):
    """Mean duration on the card of the kernels whose name holds `key` in
    a ``torch.profiler`` trace of ``run()``, taken again after a pause
    when it holds none, `attempts` times in all; then None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / count * 1e-3
        log('  no kernel named *{}* in this trace'.format(key))
    log('  {} profiler traces held no kernel named *{}*: not measured'
        .format(attempts, key))
    return None


def graph_device_ms(fn, key, steps=20, replays=10):
    """Mean duration on the card of the kernel whose name holds `key` as a
    path finds it: ``fn()`` captured `steps` times in one CUDA graph
    (through `_device.capture`, as the optimizers capture) and the graph
    replayed `replays` times under ``torch.profiler``, each launch finding
    in L2 what the one before left there (`traced_kernel_ms`)."""
    from viabel_tpu_torch._device import capture

    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    graph = capture(lambda: [fn() for _ in range(steps)], side)
    main.wait_stream(side)
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()

    return traced_kernel_ms(run, key)


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
    from viabel_tpu_torch.ops import adagrad, gaussian_lw, lw_stats
    lw_stats.reset_launches()
    gaussian_lw.reset_launches()
    adagrad.reset_launches()


def read_launches():
    """Every kernel's launches, and under ``'adagrad_step (replayed)'`` the
    step kernel's executions that came from graph replays."""
    from viabel_tpu_torch.ops import adagrad, gaussian_lw, lw_stats
    return {**lw_stats.launches, **gaussian_lw.launches, **adagrad.launches,
            'adagrad_step (replayed)': adagrad.replayed['adagrad_step']}


def require_adagrad_steps(launches, runs, path):
    """Every adagrad run of a path went through the step kernel: one
    execution an iteration, and every iteration after each run's
    `WINDOW` eager ones a graph replay (`runs` lists the runs' lengths)."""
    want = sum(runs)
    want_replayed = sum(max(r - WINDOW, 0) for r in runs)
    got = (launches['adagrad_step'], launches['adagrad_step (replayed)'])
    log('adagrad_step on the {} path: {} executions ({} from graph '
        'replays) for {} iterations'.format(path, got[0], got[1], want))
    if got != (want, want_replayed):
        raise AssertionError('the {} path ran {} adagrad steps ({} replayed), '
                             'expected {} ({} replayed)'.format(
                                 path, got[0], got[1], want, want_replayed))


def require_launched(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError('kernel {} never launched on the {} path'
                                 .format(name, path))


RAGGED_N = 300_007  # leaves a ragged 256-sample tile and a ragged chunk


def check_k1_ragged_unaligned(label, k1_args, tol, stats_rtol):
    """K1 against its plain version on the first `RAGGED_N` rows of z,
    placed 8 bytes off 16-byte alignment (a contiguous slice of a larger
    tensor): the kernel's scalar head, tail and direct-load paths."""
    from viabel_tpu_torch.ops import lw_stats as ops

    z = k1_args[0]
    off = 8 // z.element_size()
    buf = torch.empty(RAGGED_N * z.shape[1] + off, dtype=z.dtype,
                      device=z.device)
    z_u = buf[off:].view(RAGGED_N, z.shape[1])
    z_u.copy_(z[:RAGGED_N])
    if z_u.data_ptr() % 16 != 8 or not z_u.is_contiguous():
        raise AssertionError('the slice is not 8 bytes off alignment')
    for name, zz in (('ragged n = {}'.format(RAGGED_N),
                      z[:RAGGED_N].contiguous()),
                     ('ragged, z 8 B off 16-byte alignment', z_u)):
        args = (zz,) + tuple(k1_args[1:])
        lw, parts = ops.transform_score_partials(*args)
        lw_p, parts_p = ops.transform_score_partials_plain(*args)
        check_close('K1 {} lw, {}'.format(label, name), lw, lw_p,
                    tol['lw_atol'], tol['lw_rtol'])
        check_close('K1 {} statistics, {}'.format(label, name),
                    ops.combine_partials(parts),
                    ops.combine_partials_plain(parts_p), 0, stats_rtol)


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
    log('  d2 = {!r}, khat = {!r} (the eager loop before the step kernel '
        'and the graph: d2 15.52, khat 1.002), W2 = {!r}'.format(
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
                                'combine_partials', 'adagrad_step'),
                     'eight-schools')
    require_adagrad_steps(launches, [N_ITERS], 'eight-schools')
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
        args = (z, mean, log_scale, model.kernel, model.kernel_data_like(z),
                fam.df)
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
        check_k3_ragged_unaligned(lw_p, rtol)
        check_k1_ragged_unaligned('eight_schools_cp', args, tol, rtol)
        check_infinite_log_weights(lw_p[:RAGGED_N], rtol)

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
    rows = {name: timed_row(name, *spec, err=errs[name], n=n)
            for name, spec in times.items()}
    n1 = EXP_N  # K3 at 1e6 samples: 489 chunks, all in one wave
    lw1 = lw_p[:n1].contiguous()
    row = timed_row('lw_partials', lambda: ops.lw_partials(lw1),
                    lambda: ops.lw_partials_plain(lw1),
                    n1 * 4 + ops.n_chunks(n1) * 6 * 4, n1 * OPS_K3,
                    errs['lw_partials'], n1,
                    label='lw_partials (n = {})'.format(n1))
    log('K3 at n = {}: {}'.format(n1, json.dumps(dict(
        name='lw_partials', n=n1, **row))))
    return rows


def check_k3_ragged_unaligned(lw, rtol):
    """K3 against its plain version on the first `RAGGED_N` log-weights
    (a ragged last chunk), and on them placed one value (4 bytes in float32,
    8 in float64) off 16-byte alignment: the kernel's value-by-value
    route.  Counts and maxima must agree exactly."""
    from viabel_tpu_torch.ops import lw_stats as ops

    buf = torch.empty(RAGGED_N + 1, dtype=lw.dtype, device=lw.device)
    lw_u = buf[1:]
    lw_u.copy_(lw[:RAGGED_N])
    if lw_u.data_ptr() % 16 == 0:
        raise AssertionError('the slice is 16-byte aligned')
    for name, x in (('ragged n = {}'.format(RAGGED_N),
                     lw[:RAGGED_N].contiguous()),
                    ('ragged, lw {} B off 16-byte alignment'.format(
                        lw.element_size()), lw_u)):
        parts, parts_p = ops.lw_partials(x), ops.lw_partials_plain(x)
        if not torch.equal(parts[:, :2], parts_p[:, :2]):
            raise AssertionError('K3 counts or maxima differ, ' + name)
        check_close('K3 partials, plain combine, {}'.format(name),
                    ops.combine_partials_plain(parts),
                    ops.combine_partials_plain(parts_p), 0, rtol)


# the reference's statistics (viabel_tpu/bounds.py:124-156, jnp.mean and
# jnp.std in IEEE arithmetic) where log-weights are infinite: mean_lw is
# the IEEE mean, std_lw NaN
INF_CASES = {'-inf first': ([0], '-'), '-inf last': ([-1], '-'),
             '-inf at a chunk edge': ([2047, 2048], '-'),
             '-inf filling a chunk': (slice(2048, 4096), '-'),
             '+inf': ([5000], '+'), '-inf and +inf': ([7, 9000], '+-')}
INF_MEAN_LW = {'-': -math.inf, '+': math.inf, '+-': math.nan}


def check_infinite_log_weights(lw, rtol):
    """K3 + the combine (and the combine alone, of the plain partials) on
    the card against the plain versions and the reference's values, with a
    log-weight of -inf or +inf: NaN and inf in the same fields, finite
    fields to `rtol`, and mean_lw and std_lw as the constants above."""
    from viabel_tpu_torch.ops import lw_stats as ops

    for name, (where, sign) in INF_CASES.items():
        x = lw.clone()
        if sign == '+-':
            x[where[0]], x[where[1]] = -math.inf, math.inf
        else:
            x[where] = math.inf if sign == '+' else -math.inf
        want = ops.lw_stats(x.cpu())
        for label, got in (('K3 + combine', ops.lw_stats(x)),
                           ('combine', ops.combine_partials(
                               ops.lw_partials_plain(x)))):
            got = got.cpu()
            same = torch.equal(torch.isnan(got), torch.isnan(want)) and \
                torch.equal(torch.isinf(got), torch.isinf(want)) and \
                torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
            mean_lw, std_lw = float(got[3]), float(got[4])
            ref = INF_MEAN_LW[sign]
            if not (same and math.isnan(std_lw)
                    and (math.isnan(ref) and math.isnan(mean_lw)
                         or mean_lw == ref)):
                raise AssertionError('{}, lw with {}: {} against the plain '
                                     '{}'.format(label, name, got.tolist(),
                                                 want.tolist()))
            finite = torch.isfinite(want)
            if finite.any():
                check_close('{}, lw with {}: {} (finite fields)'.format(
                    label, name, got.tolist()), got[finite], want[finite],
                    0, rtol)
            else:
                log('  {}, lw with {}: {}, as the plain version'.format(
                    label, name, got.tolist()))


def timed_row(name, kernel, plain, nbytes, nops, err, n, library=None,
              label=None, library_key=None):
    """The kernel's, its plain version's and the library call's times,
    float32, beside the bound of the work.  ``ms`` is `median_ms` of the
    wrapper's call (events on the stream around it: it holds what the
    wrapper enqueues before the kernel and, where the host is slower than
    the flush, the enqueue itself); ``device_ms`` is the kernel's own
    duration on the card (`device_ms`).  With a library call the two are
    timed in turns (kernel, library, library, kernel), all four logged;
    ``ms`` and ``library_ms`` are the first turn of each, so that ``ms``
    is taken as in every other row;
    ``library_device_ms`` is the library kernel's duration on the card
    where the trace names it `library_key`."""
    label = label or name
    ms = median_ms(kernel)
    library_ms = library_dev_ms = None
    if library is not None:
        lib_turns = [median_ms(library), median_ms(library)]
        turns = [ms, median_ms(kernel)]
        log('{} in turns with the library call: kernel {:.4f}, library '
            '{:.4f}, library {:.4f}, kernel {:.4f} ms'.format(
                label, turns[0], lib_turns[0], lib_turns[1], turns[1]))
        library_ms = lib_turns[0]
        library_dev_ms = device_ms(library, library_key)
        log('{}: the library call on the card: {} ms'.format(
            label, library_dev_ms))
    dev_ms = device_ms(kernel, KERNEL_KEY[name])
    plain_ms = median_ms(plain)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    row = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               max_abs_err=err, library_ms=library_ms,
               library_device_ms=library_dev_ms)
    log('{}: {:.4f} ms by events around the call, {} ms on the card by '
        'the profiler (plain {:.4f} ms, library {}), bound {:.4f} ms by {} '
        '({} B, {} ops), float32, n = {}'.format(
            label, ms, fmt_ms(dev_ms), plain_ms,
            'none' if library_ms is None
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


def adagrad_inputs(vt, model, fam, objective, n_iters, dtype, seed):
    """(wrapped objective, f32/f64 init at 0, presampled draws) of KLVI
    (n_mc 100) or CHIVI (alpha 2, n_mc 500, with its log-norm rescaling,
    the run_experiment protocol's sizes) on `model` with `fam`."""
    from viabel_tpu_torch.optimizers import _wrap_objective

    if objective == 'KLVI':
        obj = vt.black_box_klvi(fam, model, N_MC, presampled=True)
    else:
        obj = vt.black_box_chivi(2, fam, model, 500, presampled=True)
    g = torch.Generator(device='cuda').manual_seed(seed)
    draws = obj.make_draws(g, n_iters, dtype)
    init = torch.zeros(fam.var_param_dim, dtype=dtype, device='cuda')
    return _wrap_objective(obj, None), init, draws


def adagrad_run(inputs, n_iters, driver, keep_history=False):
    from viabel_tpu_torch.optimizers import _adagrad_run

    obj, init, draws = inputs
    return _adagrad_run(obj, n_iters, WINDOW, 0.01, 0.1, 0.001, init, draws,
                        keep_history=keep_history, driver=driver)


# phase 4's graph against eager at the large-d fit's P = 5150 (a cluster
# step), float64, n_mc 100
GRAPH_LD_ITERS = 200


def graph_against_eager(vt, model, fam):
    """The graph run against the eager run of the same body on the card,
    float64, 2000 iterations, KLVI and CHIVI on shared draws, with the
    history kept: values, log-norms, params and the tail mean to 1e-10
    relative; then the same for `GRAPH_LD_ITERS` iterations of the large-d
    fit's KLVI (d = 100), whose step is a cluster launch."""
    from viabel_tpu_torch.optimizers import _wrap_objective

    for objective in ('KLVI', 'CHIVI'):
        inputs = adagrad_inputs(vt, model, fam, objective, N_OPT_ALONE,
                                torch.float64, 5)
        outs = {driver: adagrad_run(inputs, N_OPT_ALONE, driver, True)
                for driver in ('graph', 'eager')}
        for key, j in (('values', 0), ('log_norms', 1), ('params', 2),
                       ('tail mean', 3)):
            check_close('{} {} (graph vs eager, float64, {} iterations)'
                        .format(objective, key, N_OPT_ALONE),
                        outs['graph'][j], outs['eager'][j], 1e-300, 1e-10)
    # a step that is a cluster launch: the large-d fit's P = 5150
    from viabel_tpu_torch.ops.adagrad import launch_shape
    model, fam, init = large_d_setup(vt, LD_D)
    obj = vt.black_box_klvi(fam, model, 100, presampled=True)
    draws = obj.make_draws(card_generator(5), GRAPH_LD_ITERS, torch.float64)
    log('large-d KLVI step, float64: {}'.format(launch_shape(
        1, fam.var_param_dim, WINDOW, torch.float64).describe()))
    outs = {driver: adagrad_run((_wrap_objective(obj, None), init.double(),
                                 draws), GRAPH_LD_ITERS, driver, True)
            for driver in ('graph', 'eager')}
    for key, j in (('values', 0), ('log_norms', 1), ('params', 2),
                   ('tail mean', 3)):
        check_close('large-d KLVI {} (graph vs eager, float64, {} '
                    'iterations)'.format(key, GRAPH_LD_ITERS),
                    outs['graph'][j], outs['eager'][j], 1e-300, 1e-10)


def step_kernel_check(vt, model, fam):
    """The step kernel against its plain version on the card, float64 and
    float32: the same gradients, values and log-norms (those of the
    objective along a KLVI or CHIVI run's first iterations; KLVI has none
    and passes None, as the drivers do) fed to two copies of one state, 3
    windows' worth of steps with the tail from iteration 0 and the history
    kept; then its times beside the plain version's, at the steady state
    of the ring (`step_row`).  Returns the timed row."""
    from viabel_tpu_torch.ops import adagrad as aops

    n_steps = 3 * WINDOW + 7
    err = None
    for dtype in (torch.float64, torch.float32):
        tol = 1e-12 if dtype == torch.float64 else 2e-5
        for objective in ('KLVI', 'CHIVI'):
            obj, init, draws = adagrad_inputs(vt, model, fam, objective,
                                              n_steps, dtype, 6)
            lr = torch.linspace(0.02, 0.01, n_steps, dtype=dtype)
            states = [aops.new_state(init, lr, WINDOW, 0.1, True)
                      for _ in range(2)]
            states = [s._replace(tail_start=0) for s in states]
            for i in range(n_steps):
                value, grad, log_norm = obj(states[1].param, draws[i])
                args = (grad.to(dtype), value.to(dtype),
                        None if log_norm is None else log_norm.to(dtype))
                aops.adagrad_step(states[0], *args)
                aops.adagrad_step_plain(states[1], *args)
            for key in ('param', 'values', 'log_norms', 'params',
                        'tail_sum', 'grads', 'ring_log_norms', 'counter'):
                e = check_close('adagrad_step {} ({}, {}, {} steps)'.format(
                    key, objective, dtype, n_steps),
                    getattr(states[0], key), getattr(states[1], key),
                    tol * 1e-3, tol)
                if dtype == torch.float32:
                    err = max(err or 0.0, e)
    # the time of one step at P = 20, window 10, the ring full, the history
    # kept and the tail summed (the most a step does), with no log-norm (the
    # KLVI path's step)
    obj, init, draws = adagrad_inputs(vt, model, fam, 'KLVI', 1,
                                      torch.float32, 7)
    value, grad, _ = obj(init, draws[0])
    state = aops.new_state(init, torch.full((STEP_TABLE,), 0.01), WINDOW,
                           0.1, True)._replace(tail_start=0)
    state.counter.fill_(WINDOW)
    _, plain_kernels, _ = profile_busy(
        lambda: aops.adagrad_step_plain(state, grad, value, None))
    log('adagrad_step_plain: {} kernels a step on the card (the eager step '
        'it replaces launched ~17, and decided slot, fill, rate and tail on '
        'the host)'.format('not measured' if plain_kernels is None
                           else plain_kernels))
    return step_row(state, (grad, value, None), err)


# the learning-rate table of a timed step state: every timing starts at
# iteration WINDOW (the ring full) and stays inside the table
STEP_TABLE = 4096


def step_row(state, args, err):
    """The step kernel's timed row at `state`'s shape (K runs of P, window
    10, the ring full, the history kept, the tail summed): `timed_row`
    (``ms`` by events and ``device_ms`` from a trace, L2 flushed before
    each launch, as every kernel is timed), ``graph_device_ms`` (as the
    paths find it: hot in L2 inside a replayed graph), the launch floor
    (``floor_device_ms`` and ``floor_graph_device_ms``: an empty kernel of
    the same library launched with the same shape, timed both ways) and
    ``launch_shape``, the shape `ops.adagrad.launch_shape` chose."""
    from viabel_tpu_torch.ops import adagrad as aops

    K, P = state.counter.shape[0], state.param.shape[-1]
    shape = aops.launch_shape(K, P, WINDOW, state.param.dtype)
    label = 'adagrad_step (K = {}, P = {}, window {})'.format(K, P, WINDOW)
    log('{}: launch_shape chose {} ({})'.format(label, shape.describe(),
                                               json.dumps(shape._asdict())))
    # bytes: grad, the ring (window rows and log-norms), param, the tail
    # sum, lr, value, log-norm and the counter read; param, the new ring
    # slot and log-norm, the history row, the tail sum, value, log-norm and
    # the counter written, each run.  Operations: an exp, 2 multiplies and
    # an FMA a slot and coordinate, and ~6 a coordinate for the update
    nbytes = K * (4 * (P * (WINDOW + 3) + WINDOW + 3) + 8
                  + 4 * (4 * P + 3) + 8)
    nops = K * P * (5 * WINDOW + 6)

    def step():
        aops.adagrad_step(state, *args)

    state.counter.fill_(WINDOW)
    row = timed_row('adagrad_step', step,
                    lambda: aops.adagrad_step_plain(state, *args), nbytes,
                    nops, err, 1, label=label)
    state.counter.fill_(WINDOW)
    row['graph_device_ms'] = graph_device_ms(step, KERNEL_KEY['adagrad_step'])
    row['floor_device_ms'] = device_ms(lambda: aops.launch_floor(shape),
                                       FLOOR_KEY)
    row['floor_graph_device_ms'] = graph_device_ms(
        lambda: aops.launch_floor(shape), FLOOR_KEY)
    if int(state.counter.max()) >= STEP_TABLE:
        raise AssertionError('{}: the timings ran past the learning-rate '
                             'table'.format(label))
    row['launch_shape'] = dict(shape._asdict(), nonportable=shape.nonportable)
    log('{}: {} ms on the card hot in L2 inside a replayed graph; the '
        'launch floor (an empty kernel, {}) {} ms L2 flushed, {} ms in a '
        'graph'.format(label, fmt_ms(row['graph_device_ms']),
                       shape.describe(), fmt_ms(row['floor_device_ms']),
                       fmt_ms(row['floor_graph_device_ms'])))
    return row


def fmt_ms(ms):
    return 'not measured' if ms is None else '{:.4f}'.format(ms)


def time_breakdown(vt, model, fam, opt):
    """Phase 5: where the main path's time goes, at steady state (every
    stage has run once already): validated_vi again; the optimizer alone,
    KLVI and CHIVI on eight-schools CP in float32, through the graph and
    through the eager loop in turns (graph, eager, eager, graph); the bound
    pass's draws and fused score; PSIS; the card's busy share and kernels
    an iteration under the graph and under the eager loop (profiler); the
    step kernel's check and time beside its plain version's.  Returns the
    step kernel's timed row."""
    from viabel_tpu_torch.experiments import draw_and_score
    from viabel_tpu_torch.psis import _psislw_1d, _tail_len, weighted_moments

    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    kw = dict(learning_rate=0.01, learning_rate_end=0.001, device='cuda')
    t_vvi, _ = wall(lambda: vt.validated_vi(
        model, fam, init, N_ITERS, n_mc_samples=N_MC,
        n_bound_samples=N_BOUND, **kw))
    g = torch.Generator(device='cuda').manual_seed(4)
    t_draw, z = wall(lambda: fam.base_sample(g, N_BOUND, torch.float32))
    t_score, (samples, lw, _) = wall(
        lambda: draw_and_score(model, fam, opt, z))
    tail_len = _tail_len(N_BOUND, 1.0)
    t_psis, _ = wall(lambda: weighted_moments(samples,
                                              _psislw_1d(lw, tail_len)[0]))
    log('steady state: validated_vi {:.3f} s; t(40) draws {}x{} {:.4f} s; '
        'transform+score+stats {:.4f} s; PSIS+weighted moments {:.4f} s'
        .format(t_vvi, N_BOUND, fam.dim, t_draw, t_score, t_psis))
    for objective in ('KLVI', 'CHIVI'):
        inputs = adagrad_inputs(vt, model, fam, objective, N_OPT_ALONE,
                                torch.float32, 4)
        rates = {'graph': [], 'eager': []}
        for driver in ('graph', 'eager', 'eager', 'graph'):
            t, _ = wall(lambda: adagrad_run(inputs, N_OPT_ALONE, driver))
            rates[driver].append(N_OPT_ALONE / t)
        log('adagrad alone, {} on eight-schools CP, {} iterations, float32, '
            'in turns (graph, eager, eager, graph): graph {:.1f} / {:.1f} '
            'it/s, eager {:.1f} / {:.1f} it/s'.format(
                objective, N_OPT_ALONE, rates['graph'][0], rates['graph'][1],
                rates['eager'][0], rates['eager'][1]))
        n_prof = 500
        for driver in ('graph', 'eager'):
            log('  {} under the profiler ({}, {} iters): {}'.format(
                objective, driver, n_prof, busy_text(profile_busy(
                    lambda: adagrad_run(inputs, n_prof, driver)), n_prof,
                    'an iteration')))
    return step_kernel_check(vt, model, fam)


def profile_busy(fn, attempts=6, key=None, top=0, per=1):
    """``(device busy s, kernels launched, wall s)`` of ``fn()`` under
    ``torch.profiler``, and with `key` a fourth entry: the mean duration
    in ms of the kernels whose name holds it (None where the trace has
    none).  With `top`, the log gets the `top` kernels by card time, each
    in ms a unit of work (`per` units in ``fn()``).  A trace now and then
    comes back with no device records at all (see `device_ms`), so such a
    trace is taken again, with ``fn()`` run anew after a pause, `attempts`
    times in all; then busy and kernels are None (not measured).  It times, and checks nothing: the
    launches are counted and held by the wrappers' counts elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        if attempt:
            log('  the trace held no device time; taking it again')
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_prof, _ = wall(fn)
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.self_device_time_total for e in on_card) * 1e-6
        if busy_s > 0:
            for e in sorted(on_card, key=lambda e: -e.self_device_time_total
                            )[:top]:
                log('  {:.4f} ms, {} launches a unit: {}'.format(
                    e.self_device_time_total * 1e-3 / per, e.count / per,
                    e.key[:90]))
            out = busy_s, sum(e.count for e in on_card), t_prof
            if key is None:
                return out
            hits = [e for e in on_card if key in e.key]
            count = sum(e.count for e in hits)
            return out + ((sum(e.self_device_time_total for e in hits)
                           / count * 1e-3) if count else None,)
    log('  {} profiler traces held no device time: not measured'
        .format(attempts))
    return (None, None, t_prof) + (() if key is None else (None,))


def busy_text(profiled, n, unit):
    """The log's words for `profile_busy`'s result over n units of work."""
    busy_s, kernels, t_prof = profiled
    if busy_s is None:
        return 'wall {:.3f} s, device busy not measured'.format(t_prof)
    return 'wall {:.3f} s, device busy {:.4f} s ({:.1f} %), {:.1f} kernels ' \
        '{}'.format(t_prof, busy_s, 100 * busy_s / t_prof, kernels / n, unit)


def regression_model():
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model)
    data = data_generator_linear(N=100, D=10, alpha=1.0, noise_variance=0.25,
                                 rho=0.5, seed=42)
    return linear_regression_model(data['X'], data['Y'])


def ia_fit(vt, model, fam, n_iters, n_chains, dtype, device, generator,
           mesh=None):
    """The IA run of examples/linear_regression_ia.py main(): RMSProp-IA
    with R-hat windows of n_iters // 10 (at least 100), a tail of
    n_iters // 4, and the fit [avg_means[0][-1], avg_sigmas[0][-1]]
    (with `mesh`, the chains split over its chain axis)."""
    obj = vt.black_box_klvi(fam, model, N_MC, presampled=True)
    init = torch.zeros(fam.var_param_dim, dtype=dtype, device=device)
    out = vt.rmsprop_IA_optimize_with_rhat(
        n_iters, obj, init, fam.dim, generator=generator,
        learning_rate=IA_LR, n_optimisers=n_chains,
        rhat_window=max(n_iters // 10, 100), tail_avg_iters=n_iters // 4,
        device=device, mesh=mesh)
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
    log('regression IA under the profiler ({} iters, after the launch '
        'counts were read): {}'.format(n_prof, busy_text(profile_busy(
            lambda: ia_fit(vt, model, fam, n_prof, IA_CHAINS, torch.float32,
                           'cuda',
                           torch.Generator(device='cuda').manual_seed(0))),
            n_prof, 'an iteration')))
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
                model.kernel_data_like(mean))
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
    check_k2_staging_limit(vt, n // 10)
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
                   robust.kernel_data_like(mean), 40.0)
        lw, parts = ops.transform_score_partials(*k1_args)
        lw_p, parts_p = ops.transform_score_partials_plain(*k1_args)
        check_close('K1 regression (robust, mf-t(40)) lw, {}'.format(dtype),
                    lw, lw_p, tol['lw_atol'], tol['lw_rtol'])
        k1_err = check_close(
            'K1 regression statistics, {}'.format(dtype),
            ops.combine_partials(parts),
            ops.combine_partials_plain(parts_p), 0,
            REGRESSION_STATS_RTOL[str(dtype).split('.')[1]])
        check_k1_ragged_unaligned(
            'regression', k1_args, tol,
            REGRESSION_STATS_RTOL[str(dtype).split('.')[1]])
    rn, rd = robust.kernel_data[0].shape
    k1_row = timed_row(
        'transform_score_partials',
        lambda: ops.transform_score_partials(*k1_args),
        lambda: ops.transform_score_partials_plain(*k1_args),
        k1_bytes(n, rd, rn * (rd + 1)),
        n * ops_k1(rd, rn * (2 * rd + 7) + 6 * rd + 1), k1_err, n,
        label='transform_score_partials (regression, N = {}, d = {})'
        .format(rn, rd))
    log('K1 with the regression density: {}'.format(json.dumps(dict(
        name='transform_score_partials', model='robust regression', d=rd,
        n=n, n_rows=rn, **k1_row))))

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
                                        device='cuda'),
            library_key=RANDN_KEY),
    }


def check_k2_staging_limit(vt, n):
    """K2 against its plain version, f64 and f32, on a linear regression
    (D = 10) with the most rows whose padded float64 rows still fit the
    staged shared memory: the kernel stages and reads every byte the host
    lets through."""
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model)
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops import limits

    d, row = 10, limits.regression_row(10, 8)
    n_rows = (limits.MAX_STAGED_BYTES // 8 - 2 * limits.MAX_DIM) // row
    data = data_generator_linear(N=n_rows, D=d, seed=11)
    model = linear_regression_model(data['X'], data['Y'])
    wider = linear_regression_model(*(np.concatenate([data[k], data[k][:1]])
                                      for k in ('X', 'Y')))
    if model.kernel != 'regression' or wider.kernel is not None:
        raise AssertionError('{} rows are not the staging limit'
                             .format(n_rows))
    beta = np.linalg.lstsq(data['X'], data['Y'], rcond=None)[0]
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split('.')[1]]
        mean = torch.as_tensor(beta, dtype=dtype, device='cuda')
        args = (mean, torch.full_like(mean, -3.0), n, 77, 0, model.kernel,
                model.kernel_data_like(mean))
        lw, _ = gops.gaussian_sample_score_partials(*args)
        lw_p, _ = gops.gaussian_sample_score_partials_plain(*args)
        check_close('K2 lw at the staging limit (N = {}, d = {}), {}'
                    .format(n_rows, d, dtype), lw, lw_p, tol['lw_atol'],
                    tol['lw_rtol'])


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
            model.kernel_data_like(mean))
        st2 = ops.combine_partials(parts2)
        zr = torch.randn((n, d), generator=g, device='cuda')
        lw1, st1 = ops.transform_score_stats(zr, mean, log_std, model.kernel,
                                             model.kernel_data_like(mean))
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
                                'combine_partials', 'adagrad_step'),
                     'run_experiment')
    require_adagrad_steps(launches, [n for name in runs
                                     for n in (EXP_ITERS[name],) * 2],
                          'run_experiment')

    model, fam, init = experiment_models(vt)[0]
    chivi = vt.black_box_chivi(2, fam, model, 500, presampled=True)
    n_prof = 500
    profiled = profile_busy(lambda: vt.adagrad_optimize(
        n_prof, chivi, init.to('cuda', torch.float32), has_log_norm=False,
        learning_rate=EXP_LR, learning_rate_end=EXP_LR_END,
        return_history=False, device='cuda',
        generator=torch.Generator(device='cuda').manual_seed(9)))
    log('CHIVI on eight-schools NCP under the profiler ({} iters, after the '
        'launch counts were read, {:.1f} it/s): {}'.format(
            n_prof, n_prof / profiled[2],
            busy_text(profiled, n_prof, 'an iteration')))
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
                       model.kernel, model.kernel_data_like(mean), fam.df)
            k2_args = (mean, log_scale, n, 0x5DEECE66D, 0, model.kernel,
                       model.kernel_data_like(mean))
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
            check_k1_ragged_unaligned(name, k1_args, tol, tol['rtol'])
        staged = 0 if name == 'funnel' else 16
        row = timed_row(
            'transform_score_partials',
            lambda: ops.transform_score_partials(*k1_args),
            lambda: ops.transform_score_partials_plain(*k1_args),
            k1_bytes(n, d, staged), n * ops_k1(d, OPS_DENSITY[name]),
            errs['K1'], n,
            label='transform_score_partials ({})'.format(name))
        rows.append(dict(name='transform_score_partials', model=name, d=d,
                         n=n, **row))
    log('K1 by model density: {}'.format(json.dumps(rows)))


def card_generator(seed):
    return torch.Generator(device='cuda').manual_seed(seed)


def multistart_configs(vt, model):
    """The three configurations of benchmarks/khat_noise.py:183-207 on
    robust regression: (name, family, objective, init, lr, lr end); the
    CHIVI init is filled in by the warm-start fit."""
    fam = vt.mean_field_t_variational_family(2, 40)
    tfam = vt.t_variational_family(2, 100)
    return [
        ('mf-t KLVI', fam, vt.black_box_klvi(fam, model, N_MC,
                                             presampled=True),
         torch.tensor([0.0, 0.0, 1.0, 1.0], device='cuda'), 0.01, None),
        ('mf-t CHIVI', fam, vt.black_box_chivi(2, fam, model, 500,
                                               presampled=True),
         None, 0.01, None),
        ('full-rank t KLVI', tfam, vt.black_box_klvi(tfam, model, N_MC,
                                                     presampled=True),
         tfam.init_param(device='cuda'), 0.1, 0.001)]


def batched_rate(vt, obj, fam, init, lr, lr_end, n_iters=2000, seed=8):
    """Batched iterations a second of the 16-start optimizer alone
    (graph), and the log's words for the card's busy share over 500
    iterations."""
    from viabel_tpu_torch.optimizers import _adagrad_runs, _learning_rates
    from viabel_tpu_torch.objectives import stack_draws

    g = card_generator(seed)
    draws = stack_draws([obj.make_draws(g, n_iters, torch.float32)
                          for _ in range(MS_STARTS)])
    lr_tables = _learning_rates(n_iters, lr, lr_end,
                                torch.float32).repeat(MS_STARTS, 1)
    inits = init.repeat(MS_STARTS, 1)

    def run(n):
        return _adagrad_runs(obj, None, n, WINDOW, lr_tables[:, :n]
                             .contiguous(), 0.1, inits,
                             {k: v[:, :n] for k, v in draws.items()}
                             if isinstance(draws, dict) else draws[:, :n])

    t, _ = wall(lambda: run(n_iters))
    return n_iters / t, busy_text(profile_busy(lambda: run(500)), 500,
                                  'an iteration')


def multistart_path(vt):
    """Phase 13: the robust-regression multistart (path a), with the launch
    counts it made: three 16-start validated_vi_multistart runs and the
    single KLVI fit that warm-starts CHIVI."""
    from viabel_tpu_torch.models import robust_regression_model

    model = robust_regression_model()
    configs = multistart_configs(vt, model)
    runs = {}
    reset_launches()
    for name, fam, obj, init, lr, lr_end in configs:
        if init is None:  # CHIVI warm-starts from a KLVI fit, +3 on scales
            t_warm, (warm, _, _, _) = wall(lambda: vt.adagrad_optimize(
                MS_ITERS, configs[0][2], configs[0][3], learning_rate=0.01,
                return_history=False, generator=card_generator(0),
                device='cuda'))
            init = warm.clone()
            init[2:] += 3.0
            log('KLVI warm-start fit for CHIVI ({} iterations): {:.3f} s'
                .format(MS_ITERS, t_warm))
        t, out = wall(lambda: vt.validated_vi_multistart(
            model, fam, init, MS_ITERS,
            init_params=init.repeat(MS_STARTS, 1), objective_and_grad=obj,
            n_bound_samples=MS_BOUND, learning_rate=lr,
            learning_rate_end=lr_end, generator=card_generator(20260819),
            device='cuda'))
        runs[name] = (t, out, init)
    launches = read_launches()
    for name, fam, obj, _, lr, lr_end in configs:
        t, out, init = runs[name]
        khat = np.asarray(out['khat'])
        d2 = np.asarray([b['d2'] for b in out['bounds']])
        mean, sd = MS_BAND[name]
        z = (khat.mean() - mean) / sd
        inside = abs(khat.mean() - mean) <= sd
        log('multistart {} ({} starts x {} iterations, n_bound {:.0e} each, '
            'float32): {:.3f} s; khat mean {!r} sd {!r} (JAX 16-seed {} +- '
            '{}: {:+.2f} sd, {} the accepted range), best {}, d2 median '
            '{!r}'.format(name, MS_STARTS, MS_ITERS, MS_BOUND, t,
                          float(khat.mean()), float(khat.std(ddof=1)), mean,
                          sd, z, 'inside' if inside else 'OUTSIDE',
                          out['best'], float(np.median(d2))))
        log('  khats: {}'.format(json.dumps([float(k) for k in khat])))
        if name in TPU_BAND:
            log('  (for the record: the JAX package\'s TPU run gave {} +- {}; '
                'the band above is its CPU float32 run, '
                'tools/jax_khat_band.py)'.format(*TPU_BAND[name]))
        if not (np.all(np.isfinite(khat)) and np.all(np.isfinite(d2))):
            raise AssertionError('multistart {}: a khat or d2 is not finite'
                                 .format(name))
        if abs(z) >= 3:
            raise AssertionError('multistart {}: the mean khat is {:+.2f} '
                                 'sd from the JAX package\'s'.format(name, z))
        rate, busy = batched_rate(vt, obj, fam, init, lr, lr_end)
        log('  the 16-start optimizer alone (graph, 2000 iterations): '
            '{:.1f} batched it/s = {:.0f} start-iterations/s; under the '
            'profiler (500): {}'.format(rate, MS_STARTS * rate, busy))
    log('kernel launches on the multistart path: {}'.format(launches))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials', 'adagrad_step'),
                     'multistart')
    require_adagrad_steps(launches, [MS_ITERS] * 4, 'multistart')
    return launches


def sweep_path(vt):
    """Phase 14: the learning-rate sweep (path b), with its launch counts."""
    from viabel_tpu_torch.models import robust_regression_model

    model = robust_regression_model()
    fam = vt.mean_field_t_variational_family(2, 40)
    init = torch.tensor([0.0, 0.0, 1.0, 1.0], device='cuda')
    reset_launches()
    t, out = wall(lambda: vt.validated_vi_sweep(
        model, fam, init, SWEEP_ITERS, learning_rates=SWEEP_RATES,
        learning_rate_ends=[r / 10 for r in SWEEP_RATES],
        generator=card_generator(3), device='cuda'))
    launches = read_launches()
    log('sweep over rates {} (ends rate / 10, {} iterations, mf-t KLVI, '
        'n_bound 1e5, float32): {:.3f} s; best rate {}'.format(
            list(SWEEP_RATES), SWEEP_ITERS, t,
            out['learning_rates'][out['best']]))
    for k, rate in enumerate(out['learning_rates']):
        b = out['bounds'][k]
        log('  rate {}: khat {!r}, d2 {!r}, W2 {!r}, q mean {}'.format(
            rate, out['khat'][k], float(b['d2']), float(b['W2']),
            out['q_mean'][k].cpu().tolist()))
        if not (is_finite(out['khat'][k]) and is_finite(float(b['d2']))):
            raise AssertionError('sweep rate {}: khat or d2 is not finite'
                                 .format(rate))
    log('kernel launches on the sweep path: {}'.format(launches))
    require_launched(launches, ('transform_score_partials',
                                'combine_partials', 'adagrad_step'), 'sweep')
    require_adagrad_steps(launches, [SWEEP_ITERS], 'sweep')
    return launches


def large_d_setup(vt, d):
    """examples/large_d.py's model, family and q at the prior at `d`, q on
    the card."""
    from viabel_tpu_torch.examples import large_d

    model, fam, init = large_d.setup(d)
    return model, fam, init.to('cuda')


def large_d_fit(vt, d, n_iters, label):
    """examples/large_d.py's fit at `d` for `n_iters` iterations, with the
    launch counts it made; the fit must meet the example's own criterion
    (khat < 0.7, |mean - truth| < 0.05)."""
    from viabel_tpu_torch.examples import large_d

    model, fam, init = large_d_setup(vt, d)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t, out = wall(lambda: large_d.fit(model, fam, init, n_iters, 'cuda'))
    launches = read_launches()
    mean, cov = out['q_mean'].double().cpu().numpy(), \
        out['q_cov'].double().cpu().numpy()
    mean_err = float(np.linalg.norm(mean - model.true_mean))
    cov_err = float(np.linalg.norm(cov - model.true_cov)
                    / np.linalg.norm(model.true_cov))
    log('{} (d = {}, P = {}, full-rank Gaussian, n_mc {}, {} iterations, '
        'n_bound {:.0e}, float32): validated_vi {:.3f} s; khat {!r}, d2 '
        '{!r}, |mean - truth| {!r}, rel cov err {!r} (the JAX package at '
        'd = {}: {}); peak memory {:.2f} GB; {}'.format(
            label, d, fam.var_param_dim, LD_MC, n_iters, LD_BOUND, t,
            out['khat'], float(out['bounds']['d2']), mean_err, cov_err, d,
            LD_JAX[d], torch.cuda.max_memory_allocated() / 1e9,
            card_line()))
    if not (out['khat'] < 0.7 and mean_err < 0.05):
        raise AssertionError('the {} fit is not certified (khat {}, mean '
                             'error {})'.format(label, out['khat'],
                                                mean_err))
    log('kernel launches on the {} path: {}'.format(label, launches))
    require_launched(launches, ('lw_partials', 'combine_partials',
                                'adagrad_step'), label)
    require_adagrad_steps(launches, [n_iters], label)
    return launches


def large_d_path(vt):
    """Phase 15 (a): examples/large_d.py's default (path c), with its
    launch counts."""
    return large_d_fit(vt, LD_D, LD_ITERS, 'large-d')


def large_d_full_path(vt):
    """Phase 15 (b): examples/large_d.py --full (d = 300, P = 45450,
    `LD_FULL_ITERS` iterations), with its launch counts, then
    `large_d_profile` of its optimizer."""
    launches = large_d_fit(vt, LD_FULL_D, LD_FULL_ITERS, 'd = 300')
    torch.cuda.empty_cache()
    large_d_profile(vt, LD_FULL_D)
    return launches


def large_d_profile(vt, d, n=LD_PROFILE_ITERS, top=8):
    """`n` iterations of examples/large_d.py's optimizer at `d` through
    the graph under the profiler: the card's busy share, kernels an
    iteration, the step kernel's share of an iteration, and the `top`
    kernels by card time."""
    from viabel_tpu_torch.optimizers import _adagrad_run, _wrap_objective

    model, fam, init = large_d_setup(vt, d)
    obj = vt.black_box_klvi(fam, model, LD_MC, presampled=True)
    draws = obj.make_draws(card_generator(1), n, torch.float32)

    def run():
        return _adagrad_run(_wrap_objective(obj, None), n, WINDOW, 0.05, 0.1,
                            0.001, init, draws, keep_history=False)

    run()  # the graph's first capture and the allocator's pools
    busy, kernels, t_prof, step_ms = profile_busy(
        run, key=KERNEL_KEY['adagrad_step'], top=top, per=n)
    label = 'd = {} under the profiler ({} iterations through the graph)' \
        .format(d, n)
    if busy is None or step_ms is None:
        log('{}: wall {:.3f} s, the step\'s share not measured'.format(
            label, t_prof))
        return
    log('{}: wall {:.3f} s ({:.4f} ms an iteration), device busy {:.1f} %, '
        '{:.1f} kernels an iteration; the step kernel {:.4f} ms an '
        'iteration, {:.2f} % of an iteration\'s wall and {:.2f} % of its '
        'busy time ({})'.format(
            label, t_prof, 1e3 * t_prof / n, 100 * busy / t_prof,
            kernels / n, step_ms, 100 * step_ms * 1e-3 * n / t_prof,
            100 * step_ms * 1e-3 * n / busy, card_line()))


def batched_card_vs_cpu(vt):
    """Phase 16: the batched pipelines and a full-rank validated_vi at a
    small size on the card (kernels, the graph) against the CPU (plain
    versions), float64, on shared draws made on the CPU; 1e-10 relative."""
    from viabel_tpu_torch.models import robust_regression_model
    from viabel_tpu_torch.optimizers import _learning_rates, _wrap_objective
    from viabel_tpu_torch.objectives import stack_draws
    from viabel_tpu_torch.pipeline import _batch_core, _pipeline_core
    from viabel_tpu_torch.psis import _tail_len

    model = robust_regression_model()
    n_iters, n_bound, K = 200, 20000, 4
    tail = _tail_len(n_bound, 1.0)
    keys = ('opt_param', 'value_history', 'log_norm_history',
            'log_weights', 'stats', 'khat', 'psis_mean', 'psis_cov')

    def to(block, dev):
        return ({k: v.to(dev) for k, v in block.items()}
                if isinstance(block, dict) else block.to(dev))

    worst = 0.0
    for name, fam, obj, init, lr, lr_end in multistart_configs(vt, model):
        g = torch.Generator().manual_seed(12)
        init = (torch.tensor([-2.5, 1.5, 0.5, 0.5]) if init is None
                else init.cpu()).double()
        opt = stack_draws([obj.make_draws(g, n_iters, torch.float64)
                            for _ in range(K)])
        bound = stack_draws([fam.base_sample(g, n_bound, torch.float64)
                              for _ in range(K)])
        inits = init + 0.1 * torch.randn(K, init.shape[0], generator=g,
                                         dtype=torch.float64)
        rates = [_learning_rates(n_iters, lr * (k + 1), lr_end,
                                 torch.float64) for k in range(K)]
        outs = {dev: _batch_core(obj, None, fam, model, n_iters, WINDOW,
                                 torch.stack(rates).to(dev), 0.1, 2.0, tail,
                                 inits.to(dev), to(opt, dev), to(bound, dev))
                for dev in ('cpu', 'cuda')}
        for key in keys:
            worst = max(worst, check_close(
                'batch {} {} (cuda vs cpu)'.format(name, key),
                outs['cuda'][key].cpu(), outs['cpu'][key], 1e-12, 1e-10))
    fam = multistart_configs(vt, model)[2][1]
    obj = vt.black_box_klvi(fam, model, 20, presampled=True)
    g = torch.Generator().manual_seed(13)
    opt = obj.make_draws(g, n_iters, torch.float64)
    bound = fam.base_sample(g, n_bound, torch.float64)
    outs = {dev: _pipeline_core(
        _wrap_objective(obj, None), fam, model, n_iters, WINDOW, 0.1, 0.1,
        0.001, 2.0, tail, fam.init_param(torch.float64, dev), to(opt, dev),
        to(bound, dev)) for dev in ('cpu', 'cuda')}
    for key in keys:
        worst = max(worst, check_close(
            'full-rank t validated_vi {} (cuda vs cpu)'.format(key),
            outs['cuda'][key].cpu(), outs['cpu'][key], 1e-12, 1e-10))
    log('batched pipelines (mf-t KLVI, mf-t CHIVI, full-rank t KLVI, {} '
        'runs each at their own rate) and a full-rank validated_vi, card vs '
        'CPU at {} iterations, n_bound {}, float64: max abs diff {:.3e}'
        .format(K, n_iters, n_bound, worst))


# phase 12's step instances against the plain version: (K, P, window,
# with a log-norm); the P on each side of the one-block / cluster switch
# (`ops.adagrad.BLOCK_BYTES`: 512 float32 or 256 float64 columns) is
# added for each dtype
STEP_CASES = ([(K, P, WINDOW, True) for K in (1, 4, 16) for P in (4, 5150)]
              + [(1, 20, WINDOW, True), (2, 5150, WINDOW, True),
                 (1, 45450, WINDOW, True), (1, 20, 7, True),
                 (2, 5150, 7, True), (1, 20, WINDOW, False),
                 (16, 4, WINDOW, False), (1, 5150, WINDOW, False),
                 (1, 45450, WINDOW, False)])
# phase 12's timed shapes (phase 5 times K 1, P 20): robust regression's 16
# starts, the large-d fit (d = 100) and the d = 300 fit
STEP_TIMED = ((MS_STARTS, 4), (1, 5150), (1, 45450))


def batched_step_check(vt):
    """Phase 12: every instance of the step kernel against its plain
    version on the card (`STEP_CASES`: one block a run and clusters, K
    runs each with its own learning-rate table, window 10 and the runtime
    window 7, with and without a log-norm): float64 to 1e-12 relative,
    float32 to 2e-5 relative plus 8 float32 ulps of the largest value
    compared (the two sum the ring in another order, and a parameter that
    walks near zero, or a tail sum of O(1) terms that cancel, keeps the
    error of its O(1) terms); each case prints `launch_shape`'s choice.
    Then `step_row` at `STEP_TIMED`, with no log-norm (the KLVI paths'
    step).  Returns the timed instances."""
    from viabel_tpu_torch.ops import adagrad as aops
    from viabel_tpu_torch.optimizers import _learning_rates

    rng = np.random.default_rng(16)
    err = 0.0
    for dtype in (torch.float64, torch.float32):
        tol = 1e-12 if dtype == torch.float64 else 2e-5
        share = aops.BLOCK_BYTES // torch.empty((), dtype=dtype) \
            .element_size()
        for K, P, window, with_ln in STEP_CASES + [
                (3, share, WINDOW, True), (3, share + 1, WINDOW, True)]:
            n_steps = 2 * window + 3
            shape = aops.launch_shape(K, P, window, dtype)
            lr = torch.stack([
                _learning_rates(n_steps, a, a / 10, dtype)
                for a in np.geomspace(0.01, 0.1, K)]).cuda()
            init = torch.as_tensor(rng.normal(size=(K, P)), dtype=dtype,
                                   device='cuda')
            states = [aops.new_state(init, lr, window, 0.1, True)
                      for _ in range(2)]
            for _ in range(n_steps):
                args = [torch.as_tensor(a, dtype=dtype, device='cuda')
                        for a in (rng.normal(size=(K, P)),
                                  rng.normal(size=K),
                                  3.0 * rng.normal(size=K))]
                if not with_ln:
                    args[2] = None
                aops.adagrad_step(states[0], *args)
                aops.adagrad_step_plain(states[1], *args)
            case = 'K {}, P {}, window {}, {}, {}: {}'.format(
                K, P, window, 'log-norm' if with_ln else 'no log-norm',
                dtype, shape.describe())
            for key in ('param', 'values', 'log_norms', 'params',
                        'tail_sum', 'grads', 'ring_log_norms', 'counter'):
                want = getattr(states[1], key)
                atol = (tol * 1e-3 if dtype == torch.float64 else
                        8 * torch.finfo(dtype).eps
                        * float(want.abs().max()))
                e = check_close('adagrad_step {} ({})'.format(key, case),
                                getattr(states[0], key), want, atol, tol)
                if dtype == torch.float32:
                    err = max(err, e)
    rows = []
    for K, P in STEP_TIMED:
        state = aops.new_state(
            torch.zeros(K, P, device='cuda'),
            torch.full((K, STEP_TABLE), 0.01, device='cuda'), WINDOW, 0.1,
            True)._replace(tail_start=0)
        args = (torch.randn(K, P, device='cuda'),
                torch.randn(K, device='cuda'), None)
        rows.append(dict(K=K, P=P, **step_row(state, args, err)))
    return rows


def moments_fit(model):
    """A stand-in fit: the model's ground-truth mean and marginal scales."""
    return torch.as_tensor(np.concatenate([
        model.true_mean, 0.5 * np.log(np.diag(model.true_cov))]),
        dtype=torch.float32, device='cuda')


def kernels_only(vt, model, fam):
    """``--kernels-only``: phases 3, 7, 11 and 12 alone (every kernel against
    its plain version and its times at the paths' shapes) at stand-in fits,
    with no path driven and no result line.  For work on the kernels."""
    rows = kernel_checks(model, fam, moments_fit(model))
    rows['adagrad_step'] = step_kernel_check(vt, model, fam)
    rows['adagrad_step']['instances'] = batched_step_check(vt)
    rmodel = regression_model()
    rfam = vt.mean_field_gaussian_variational_family(rmodel.dim)
    rows.update(regression_kernel_checks(vt, rmodel, rfam,
                                         moments_fit(rmodel)))
    ncp = experiment_models(vt)[0][0]
    experiment_kernel_checks(vt, {
        ncp.name: moments_fit(ncp).cpu().numpy(),
        'funnel': np.array([0.0, 0.0, 1.0, 0.3], dtype=np.float32)})
    log(card_line())
    log(json.dumps({'kernels_only': rows}))
    return 0


def run_cli(argv):
    """``python -m viabel_tpu_torch`` in this process: ``(host seconds,
    stdout)``, the time closed by a device synchronization."""
    from viabel_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t, _ = wall(lambda: cli_main(argv))
    return t, buf.getvalue()


def cli_results(out):
    """The printed bounds and khat of a ``run``: every value under 'Upper
    bounds on the approximation error:' and the khat, each required
    finite; the lines after the config are logged, progress lines
    dropped."""
    lines = [line for line in out.split('\n') if '\r' not in line]
    body = lines[lines.index('}') + 1:]
    for line in body:
        log('    ' + line)
    start = body.index('Upper bounds on the approximation error:')
    bounds = {}
    for line in body[start + 1:]:
        if not line.startswith('    '):
            break
        label, value = line.strip().rsplit(None, 1)
        bounds[label] = float(value)
    khat = float(next(line for line in body
                      if line.startswith('khat = ')).split()[2])
    for name, value in list(bounds.items()) + [('khat', khat)]:
        if not is_finite(value):
            raise AssertionError('run: {} is not finite: {}'.format(name,
                                                                    value))
    return bounds, khat


def interrupted(ck, after, fn):
    """``fn()`` with `checkpoint.save_checkpoint` raising KeyboardInterrupt
    once it has written `after` checkpoints.  The adagrad run passes the
    interrupt on; the chain runs return their partial results, as the JAX
    package's do."""
    real = ck.save_checkpoint
    calls = {'n': 0, 'raised': False}

    def save(path, tree):
        if calls['n'] >= after:
            calls['raised'] = True
            raise KeyboardInterrupt
        calls['n'] += 1
        return real(path, tree)

    ck.save_checkpoint = save
    try:
        fn()
    except KeyboardInterrupt:
        pass
    finally:
        ck.save_checkpoint = real
    if not calls['raised']:
        raise AssertionError('the run was not interrupted')


def max_rel(got, want):
    got, want = (torch.as_tensor(t).double().cpu() for t in (got, want))
    return float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())


def same_entries(ck, path, other, names):
    for name in names:
        a, b = (ck.load_checkpoint_entry(p, name) for p in (path, other))
        if not np.array_equal(a, b):
            raise AssertionError('{}: entry {} differs from the '
                                 'uninterrupted run\'s'.format(path, name))


def add_launches(total, launches):
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count


def cli_default(vt, tmp):
    """Phase 17 (a): ``run`` with the default config, progress lines on."""
    reset_launches()
    t, out = run_cli(['run'])
    launches = read_launches()
    log('run, the default config (funnel, mf-t(40), presampled KLVI n_mc '
        '100, adagrad 5000 iterations at lr 0.01, 1e6 bound samples, '
        'float32, progress lines on): {:.3f} s; {} progress lines'.format(
            t, out.count('\r  iter ')))
    cli_results(out)
    log('kernel launches on the run path: {}'.format(launches))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials'), 'run')
    require_adagrad_steps(launches, [5000], 'run')
    return launches


def cli_resume(vt, tmp):
    """Phase 17 (b): ``run --checkpoint-path`` uninterrupted, interrupted
    after its second save and resumed, held against each other bit for bit
    and against plain `adagrad_optimize` on the same draws (with and
    without progress lines); then the same at float64 through
    `adagrad_optimize_resumable` with a generator of seed 7."""
    from viabel_tpu_torch import checkpoint as ck
    from viabel_tpu_torch.config import ExperimentConfig, build
    from viabel_tpu_torch.experiments import _split

    full, part = (os.path.join(tmp, n) for n in ('full.npz', 'part.npz'))
    reset_launches()
    t_full, out = run_cli(['run', '--quiet', '--checkpoint-path', full])
    t_int, _ = wall(lambda: interrupted(ck, 2, lambda: run_cli(
        ['run', '--quiet', '--checkpoint-path', part])))
    stopped = int(ck.load_checkpoint_entry(part, 'i'))
    t_res, _ = run_cli(['run', '--quiet', '--checkpoint-path', part])
    same_entries(ck, part, full, ('i', 'param', 'grads', 'log_norms',
                                  'values', 'lns', 'params'))
    log('run --checkpoint-path (save every {}): uninterrupted {:.3f} s; '
        'interrupted after its second save {:.3f} s (checkpoint at '
        'iteration {}), resumed {:.3f} s; the resumed checkpoint equals the '
        'uninterrupted one, bit for bit'.format(CLI_SAVE_EVERY, t_full,
                                                t_int, stopped, t_res))
    cli_results(out)
    model, family, objective = build(ExperimentConfig())
    init = family.init_param(device='cuda')

    def gen():
        return _split(card_generator(0), 3)[0]

    plains = [vt.adagrad_optimize(5000, objective, init, generator=gen(),
                                  device='cuda')]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        plains.append(vt.adagrad_optimize(5000, objective, init,
                                          generator=gen(), progress=True,
                                          device='cuda'))
    if printed.getvalue().count('\r  iter ') != 101:
        raise AssertionError('adagrad_optimize printed {} progress lines'
                             .format(printed.getvalue().count('\r  iter ')))
    launches = read_launches()
    if not all(torch.equal(a, b) for a, b in zip(*plains)):
        raise AssertionError('progress lines changed a result bit')
    values = ck.load_checkpoint_entry(full, 'values')
    lns = ck.load_checkpoint_entry(full, 'lns')
    smoothed = ck.load_checkpoint_entry(full, 'params')[3750:].mean(axis=0)
    log('  against plain adagrad_optimize on the same draws (float32; '
        'with progress lines the same bits): values {!r}, log-norms {!r}, '
        'smoothed parameter {!r} (a history mean against a running tail '
        'sum) largest relative difference'.format(
            max_rel(values, plains[0][2]), max_rel(lns, plains[0][3]),
            max_rel(smoothed, plains[0][0])))
    # executions: the uninterrupted run, the 3000 iterations before the
    # interrupt, the 3000 after the resume, the two plain runs; the
    # window's 10 eager iterations once a run that starts at 0
    runs = [5000, 3000, 3000, 5000, 5000]
    want = (sum(runs), sum(runs) - 10 * 4)
    got = (launches['adagrad_step'], launches['adagrad_step (replayed)'])
    log('  adagrad_step: {} executions ({} replayed), expected {} ({})'
        .format(got[0], got[1], *want))
    if got != want:
        raise AssertionError('the resumed runs ran {} steps ({} replayed)'
                             .format(*got))

    init64 = family.init_param(torch.float64, 'cuda')
    kw = dict(save_every=CLI_SAVE_EVERY, learning_rate=0.01, device='cuda')
    p64, q64 = (os.path.join(tmp, n) for n in ('full64.npz', 'part64.npz'))

    def plain64():
        return vt.adagrad_optimize(5000, objective, init64,
                                   generator=card_generator(7),
                                   learning_rate=0.01, device='cuda')

    # in turns: plain, segmented, (interrupted, resumed), plain
    t_plain = [wall(plain64)[0]]
    t_whole, whole = wall(lambda: ck.adagrad_optimize_resumable(
        5000, objective, init64, checkpoint_path=p64,
        generator=card_generator(7), **kw))
    t_int, _ = wall(lambda: interrupted(
        ck, 2, lambda: ck.adagrad_optimize_resumable(
            5000, objective, init64, checkpoint_path=q64,
            generator=card_generator(7), **kw)))
    t_res, resumed = wall(lambda: ck.adagrad_optimize_resumable(
        5000, objective, init64, checkpoint_path=q64,
        generator=card_generator(7), **kw))
    t, plain = wall(plain64)
    t_plain.append(t)
    if not all(torch.equal(a, b) for a, b in zip(resumed, whole)):
        raise AssertionError('the resumed float64 run differs from the '
                             'uninterrupted one')
    worst = max(max_rel(a, b) for a, b in zip(resumed, plain))
    log('  float64 (seed 7): resumed equals uninterrupted bit for bit; '
        'against plain adagrad_optimize the largest relative difference '
        'is {!r} (limit 1e-12)'.format(worst))
    log('  float64 walls, 5000 iterations: plain adagrad_optimize {:.3f} / '
        '{:.3f} s, adagrad_optimize_resumable in 5 segments with 5 saves '
        '{:.3f} s ({:.0f} KB a checkpoint), interrupted at its third save '
        '{:.3f} s, resumed from iteration 2000 (redraw, load, 3 segments) '
        '{:.3f} s'.format(t_plain[0], t_plain[1], t_whole,
                          os.path.getsize(p64) / 1e3, t_int, t_res))
    if worst > 1e-12:
        raise AssertionError('the resumable run differs from '
                             'adagrad_optimize by {}'.format(worst))
    return read_launches()


def cli_chains(vt, tmp):
    """Phase 17 (c): ``run`` of the regression IA path with checkpoints
    (4 RMSProp-IA chains), uninterrupted, and interrupted after its first
    save and resumed; the resumed checkpoint must equal the uninterrupted
    one."""
    from viabel_tpu_torch import checkpoint as ck

    full, part = (os.path.join(tmp, n) for n in ('chains.npz',
                                                 'chains_part.npz'))
    argv = ['run', '--model', 'linear_regression', '--family',
            'mean_field_gaussian', '--optimizer', 'rmsprop_ia',
            '--n-chains', '4', '--n-iters', str(CLI_IA_ITERS), '--quiet',
            '--checkpoint-path']
    reset_launches()
    t_full, out = run_cli(argv + [full])
    launches = read_launches()
    t_int, _ = wall(lambda: interrupted(ck, 1, lambda: run_cli(
        argv + [part])))
    t_res, _ = run_cli(argv + [part])
    same_entries(ck, part, full, ('i', 'params', 'v', 'm', 'avg', 'values',
                                  'lns', 'hist'))
    log('run, linear regression (N 100, D 5), mean-field Gaussian, 4 '
        'RMSProp-IA chains x {} iterations, checkpoints every {}, float32: '
        'uninterrupted {:.3f} s, interrupted after its first save (the run '
        'returns its partial results) {:.3f} s, resumed {:.3f} s; the '
        'resumed checkpoint equals the uninterrupted one, bit for bit'.format(
            CLI_IA_ITERS, CLI_SAVE_EVERY, t_full, t_int, t_res))
    cli_results(out)
    log('kernel launches on the IA run path (the uninterrupted run): {}'
        .format(launches))
    require_launched(launches, ('gaussian_sample_score_partials',
                                'philox_normal', 'lw_partials',
                                'combine_partials'), 'IA run')
    return launches


def cli_generator_chains(vt, tmp):
    """Phase 17 (d): ``run`` with 2 Adam-IA chains that sample inside the
    step (``--no-presampled``), mean-field t on eight-schools CP."""
    reset_launches()
    t, out = run_cli(['run', '--model', 'eight_schools_cp', '--family',
                      'mean_field_t', '--optimizer', 'adam_ia',
                      '--n-chains', '2', '--no-presampled', '--n-iters',
                      str(CLI_IA_ITERS), '--quiet'])
    launches = read_launches()
    log('run, eight-schools CP, mf-t(40), 2 Adam-IA chains x {} iterations '
        'sampling inside the step, float32: {:.3f} s ({:.1f} it/s)'.format(
            CLI_IA_ITERS, t, CLI_IA_ITERS / t))
    cli_results(out)
    log('kernel launches: {}'.format(launches))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials'), 'generator-driven IA')
    return launches


def eight_schools_ia(vt):
    """Phase 17 (e): examples/eight_schools_ia.py's protocol through the
    port (quick mode): RMSProp-IA, 2 chains, mean-field Gaussian KLVI n_mc
    100 sampling inside the step, from each model's stored moments."""
    from viabel_tpu_torch import models

    reset_launches()
    for label, name, n_iters, r_mean, seed in ES_IA:
        model = getattr(models, name)()
        K = model.dim
        fam = vt.mean_field_gaussian_variational_family(K)
        obj = vt.black_box_klvi(fam, model.log_prob, N_MC)
        init = vt.init_from_moments(fam, model.true_mean,
                                    np.diag(np.diag(model.true_cov)))
        t, out = wall(lambda: vt.rmsprop_IA_optimize_with_rhat(
            n_iters, obj, init.to('cuda', torch.float32), K,
            generator=card_generator(seed), learning_rate=.01,
            n_optimisers=2, r_mean_threshold=r_mean, rhat_window=500,
            tail_avg_iters=3000 // 4, device='cuda'))
        chains, ia_log = out[1], out[6]
        m0, s0 = ia_log['start_avg_mean_iters'], \
            ia_log['start_avg_sigma_iters']
        rhm, rhs = ia_log['r_hat_mean'][-1].max(), \
            ia_log['r_hat_sigma'][-1].max()
        log('{} ({} iterations, 2 chains, float32): {:.3f} s ({:.1f} it/s); '
            'averaging starts: mean block {}, sigma block {}; final-window '
            'R-hat max: mean block {!r}, sigma block {!r}'.format(
                label, n_iters, t, n_iters / t, m0, s0, float(rhm),
                float(rhs)))
        hist_len = chains.shape[1]
        if not (is_finite(float(rhm)) and is_finite(float(rhs))
                and 0 <= m0 <= hist_len and 0 <= s0 <= hist_len):
            raise AssertionError('{}: R-hat or averaging start out of range'
                                 .format(label))
    return read_launches()


def cli_path(vt):
    """Phase 17: the command line and the resume path on the card, f32;
    the launch counts of its parts summed."""
    import tempfile

    total = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix='.phase17-') as tmp:
        for part in (cli_default, cli_resume, cli_chains,
                     cli_generator_chains):
            add_launches(total, part(vt, tmp))
    add_launches(total, eight_schools_ia(vt))
    return total


def http_get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=600) as r:
        return json.loads(r.read())


def http_post(base, path, body):
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def require_finite(label, values):
    for name, value in values.items():
        if not is_finite(value):
            raise AssertionError('{}: {} is not finite: {}'.format(
                label, name, value))


def service_reads(base, points):
    """Phase 18 (b): /health, /moments, /sample?n=1000, /log_prob of 1000
    points and /bounds?n=1e6, once each; returns the bounds."""
    health = http_get(base, '/health')
    moments = http_get(base, '/moments')
    samples = np.asarray(http_get(base, '/sample?n=1000')['samples'])
    lp = np.asarray(http_post(base, '/log_prob', {'x': points})['log_prob'])
    bounds = http_get(base, '/bounds?n={}'.format(SERVE_BOUND))
    log('  /health {}; /moments mean {}; /sample {} draws of shape {}; '
        '/log_prob {} values, finite {}'.format(
            health, moments['mean'], samples.shape[0], samples.shape,
            lp.shape[0], bool(np.all(np.isfinite(lp)))))
    log('  /bounds?n={}: {}'.format(SERVE_BOUND, bounds))
    if samples.shape != (1000, 2) or lp.shape != (1000,) or \
            not np.all(np.isfinite(lp)) or not np.all(np.isfinite(samples)):
        raise AssertionError('/sample or /log_prob returned a wrong result')
    require_finite('/bounds', bounds)
    return bounds


def service_fit_with_readers(base, service, quiet_fit):
    """Phase 18 (f): /sample in a loop on this thread while a /fit runs on
    another, the readers starting once the fit has taken its seed; every
    read must succeed and one must finish before the fit; the fit's bounds
    must equal `quiet_fit`'s (the same fit of a service of the same seed
    and parameter, with no readers) to 1e-6 relative."""
    import threading

    start = service._seeds.get_state()
    result, failures = {}, []

    def fit():
        try:
            result['fit'] = http_post(base, '/fit', SERVE_FIT)
        except Exception as e:  # noqa: BLE001 -- reported below
            failures.append(e)
        result['t_end'] = time.perf_counter()

    fitter = threading.Thread(target=fit)
    fitter.start()
    while torch.equal(service._seeds.get_state(), start) and \
            fitter.is_alive():
        time.sleep(0.0005)
    ends, errors = [], []
    while fitter.is_alive():
        try:
            got = http_get(base, '/sample?n=1000')['samples']
            if len(got) != 1000:
                raise AssertionError('/sample returned {} draws'.format(
                    len(got)))
            ends.append(time.perf_counter())
        except Exception as e:  # noqa: BLE001 -- counted below
            errors.append(e)
    fitter.join(timeout=600)
    if failures or errors or fitter.is_alive():
        raise AssertionError('reads during a fit: fit failures {}, read '
                             'errors {}'.format(failures, errors[:3]))
    before = sum(t < result['t_end'] for t in ends)
    worst = max(abs(result['fit']['bounds'][k] - v) / abs(v)
                for k, v in quiet_fit['bounds'].items())
    log('  /fit with a /sample loop beside it: {} reads, all succeeded, {} '
        'finished before the fit; the fit\'s bounds against the same fit '
        'with no readers: largest relative difference {!r} (limit 1e-6), '
        'khat {!r} against {!r}'.format(len(ends), before, worst,
                                        result['fit']['khat'],
                                        quiet_fit['khat']))
    if before < 1 or not worst <= 1e-6:
        raise AssertionError('the readers did not overlap the fit, or the '
                             'fit changed')


def service_path(vt):
    """Phase 18: the HTTP service on the card, float32, in this process on
    127.0.0.1, port 0: served from the default config's fit, its reads
    (K1 d = 2 and the combine for /bounds), a /fit and a 4-start /fit
    (the step kernel, replayed), a second /fit while one runs (503), reads
    during a fit (unchanged fit), and each endpoint's latency."""
    import threading
    import urllib.error

    from viabel_tpu_torch import serve
    from viabel_tpu_torch.config import ExperimentConfig, build

    cfg = ExperimentConfig()
    model, family, objective = build(cfg)
    reset_launches()
    t_fit, var_param = wall(lambda: serve._fit_from_config(
        cfg, model, family, objective, device='cuda'))
    total = read_launches()
    require_adagrad_steps(total, [cfg.n_iters], 'serve start-up fit')
    log('served parameter from the default config (funnel, mf-t(40), '
        'presampled KLVI, adagrad {} iterations): {:.3f} s'.format(
            cfg.n_iters, t_fit))

    def new_service():
        return serve.PosteriorService(model, family, var_param,
                                      seed=cfg.seed, device='cuda')

    service = new_service()
    httpd, thread = serve.start_server(service, port=0, host='127.0.0.1')
    base = 'http://127.0.0.1:{}'.format(httpd.server_address[1])
    points = np.random.RandomState(18).randn(1000, 2).tolist()
    try:
        reset_launches()
        service_reads(base, points)
        launches = read_launches()
        log('  kernel launches of the reads: {}'.format(launches))
        require_launched(launches, ('transform_score_partials',
                                    'combine_partials'), 'service /bounds')
        add_launches(total, launches)

        fits = {}
        for label, body in (('/fit', SERVE_FIT),
                            ('/fit n_starts 4', dict(SERVE_FIT,
                                                     n_starts=4))):
            reset_launches()
            t, fits[label] = wall(lambda: http_post(base, '/fit', body))
            launches = read_launches()
            fit = fits[label]
            log('  {} ({} iterations, {:.0e} bound samples{}): {:.3f} s; '
                'd2 {!r}, khat {!r}{}; launches {}'.format(
                    label, body['n_iters'], body['n_bound_samples'],
                    ' a start' if 'n_starts' in body else '', t,
                    fit['bounds']['d2'], fit['khat'],
                    ', best start {}'.format(fit['best'])
                    if 'best' in fit else '', launches))
            require_finite(label, dict(fit['bounds'], khat=fit['khat']))
            require_launched(launches, ('transform_score_partials',
                                        'combine_partials'), label)
            # one step launch an iteration (a batched one for 4 starts)
            require_adagrad_steps(launches, [body['n_iters']], label)
            add_launches(total, launches)

        # (e) a second fit while one runs
        busy = {}
        running = threading.Thread(target=lambda: busy.update(
            fit=http_post(base, '/fit', SERVE_FIT)))
        running.start()
        while not service._fit_lock.locked() and running.is_alive():
            time.sleep(0.0005)
        try:
            http_post(base, '/fit', SERVE_FIT)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        running.join(timeout=600)
        log('  a second /fit while one runs: HTTP {} (the running one: '
            'd2 {!r})'.format(code, busy.get('fit', {}).get('bounds', {})
                              .get('d2')))
        if code != 503 or 'fit' not in busy:
            raise AssertionError('a concurrent /fit was not refused with '
                                 '503')

        # (f) reads during a fit, against the same fit with no readers
        quiet = new_service().fit(**SERVE_FIT)
        readers = new_service()
        httpd2, thread2 = serve.start_server(readers, port=0,
                                             host='127.0.0.1')
        try:
            service_fit_with_readers('http://127.0.0.1:{}'.format(
                httpd2.server_address[1]), readers, quiet)
        finally:
            httpd2.shutdown()
            httpd2.server_close()
            thread2.join(timeout=60)

        # (g) latencies: the median of 20 calls, the fits once each
        calls = (('/health', lambda: http_get(base, '/health')),
                 ('/moments', lambda: http_get(base, '/moments')),
                 ('/sample?n=1000', lambda: http_get(base,
                                                     '/sample?n=1000')),
                 ('/log_prob (1000 points)', lambda: http_post(
                     base, '/log_prob', {'x': points})),
                 ('/bounds?n={}'.format(SERVE_BOUND), lambda: http_get(
                     base, '/bounds?n={}'.format(SERVE_BOUND))))
        lat = {}
        for label, call in calls:
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t0)
            lat[label] = statistics.median(times) * 1e3
        log('  latency, median of 20 calls (ms, host clock around the HTTP '
            'call): {}'.format(json.dumps(
                {k: round(v, 3) for k, v in lat.items()})))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return total


class HostTimer:
    """Host seconds spent in the host-density bridge's calls (the copy to
    the host, the C++ evaluation and the copy back), by wrapping
    `models.external._Host` while the block runs."""

    def __enter__(self):
        from viabel_tpu_torch.models import external

        self.cls, self.seconds, self.calls = external._Host, 0.0, 0
        self.real = self.cls.value, self.cls.grad

        def timed(fn):
            def call(host, x):
                t0 = time.perf_counter()
                try:
                    return fn(host, x)
                finally:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
            return call

        self.cls.value, self.cls.grad = (timed(f) for f in self.real)
        return self

    def __exit__(self, *exc):
        self.cls.value, self.cls.grad = self.real


def native_path(vt):
    """Phase 19: external and native densities on the card, float64:
    validated_vi on the native robust regression against the torch model
    (eager step kernel, K3 and the combine, no K1), and the IA chains under
    vmap on the native eight-schools CP against the torch CP model."""
    from viabel_tpu_torch import native
    from viabel_tpu_torch.models import (eight_schools_cp_model,
                                         robust_regression_model)

    fam = vt.mean_field_t_variational_family(2, 40)
    init = torch.zeros(fam.var_param_dim, dtype=torch.float64, device='cuda')

    def fit(density):
        return vt.validated_vi(density, fam, init, NATIVE_ITERS,
                               n_mc_samples=N_MC,
                               n_bound_samples=NATIVE_BOUND,
                               generator=card_generator(19), device='cuda')

    density = native.native_robust_regression_log_density()
    fit(density)  # warm: the first run builds and loads the library
    reset_launches()
    with HostTimer() as host:
        t_native, out_n = wall(lambda: fit(density))
    launches = read_launches()
    t_torch, out_t = wall(lambda: fit(robust_regression_model()))
    log('validated_vi on robust regression, mf-t(40), presampled KLVI n_mc '
        '{}, {} iterations, {:.0e} bound samples, float64: native C++ '
        'density {:.3f} s ({} host calls, {:.3f} s of it in them: {:.1f} '
        '%), the torch model {:.3f} s'.format(
            N_MC, NATIVE_ITERS, NATIVE_BOUND, t_native, host.calls,
            host.seconds, 100 * host.seconds / t_native, t_torch))
    log('  native: d2 {!r}, khat {!r}; torch: d2 {!r}, khat {!r}'.format(
        float(out_n['bounds']['d2']), out_n['khat'],
        float(out_t['bounds']['d2']), out_t['khat']))
    log('  kernel launches of the native run: {}'.format(launches))
    worst = max(max_rel(out_n['opt_param'], out_t['opt_param']),
                max_rel(out_n['bounds']['d2'], out_t['bounds']['d2']),
                max_rel(out_n['khat'], out_t['khat']))
    log('  native against torch: largest relative difference of the fit, '
        'd2 and khat {!r} (limit 1e-9)'.format(worst))
    if not worst <= 1e-9:
        raise AssertionError('the native and torch fits differ')
    if (launches['adagrad_step'], launches['adagrad_step (replayed)']) != \
            (NATIVE_ITERS, 0):
        raise AssertionError('the native run did not take the eager driver')
    require_launched(launches, ('lw_partials', 'combine_partials'),
                     'native')
    if launches['transform_score_partials']:
        raise AssertionError('K1 launched on a host density')
    total = dict(launches)

    mg = vt.mean_field_gaussian_variational_family(10)

    def ia_chains(name, dens):
        obj = vt.black_box_klvi(mg, dens, N_MC, presampled=True)
        t, out = wall(lambda: vt.rmsprop_IA_optimize_with_rhat(
            NATIVE_IA_ITERS, obj, torch.zeros(20, dtype=torch.float64,
                                              device='cuda'), 10,
            generator=card_generator(19), n_optimisers=2, rhat_window=100,
            tail_avg_iters=NATIVE_IA_ITERS // 4, device='cuda'))
        log('  RMSProp-IA, 2 chains x {} iterations on eight-schools CP, '
            'mean-field Gaussian KLVI n_mc {}, float64, {}: {:.3f} s'.format(
                NATIVE_IA_ITERS, N_MC, name, t))
        return out

    # only the native run is the path; the torch model's is its reference
    reset_launches()
    got = ia_chains('native', native.native_eight_schools_cp_log_density())
    launches = read_launches()
    log('  kernel launches of the native IA chains: {}'.format(launches))
    add_launches(total, launches)
    want = ia_chains('torch', eight_schools_cp_model())
    worst = max(max_rel(got[j], want[j]) for j in (0, 1))
    log('  native under vmap against torch: finite {}, largest relative '
        'difference of the chains and the final iterate {!r} (limit 1e-9)'
        .format(bool(np.all(np.isfinite(got[1]))), worst))
    if not (np.all(np.isfinite(got[1])) and worst <= 1e-9):
        raise AssertionError('the native IA chains differ from the torch '
                             'model\'s')
    return total


def hmc_path(vt):
    """Phase 20: HMC on the card: the eight-schools ground truth from NCP
    draws (8 chains, float32) against the stored CP truth, its rate,
    replays and busy share, and the graph against the eager body on the
    same draws at float64."""
    from viabel_tpu_torch import mcmc
    from viabel_tpu_torch.models import (eight_schools_cp_model,
                                         eight_schools_ncp_model,
                                         eight_schools_ncp_to_cp)

    ncp, cp = eight_schools_ncp_model(), eight_schools_cp_model()
    mcmc.reset_counts()
    t, gt = wall(lambda: vt.hmc_ground_truth(
        ncp, generator=card_generator(20), transform=eight_schools_ncp_to_cp,
        n_chains=HMC_CHAINS, n_warmup=HMC_WARMUP, n_samples=HMC_SAMPLES,
        device='cuda'))
    diag = gt['diagnostics']
    n = HMC_WARMUP + HMC_SAMPLES
    counts = dict(mcmc.transitions)
    log('hmc_ground_truth, eight-schools NCP -> CP, {} chains, n_warmup {}, '
        'n_samples {} (of 20000), float32: {:.3f} s, {:.1f} transitions/s; '
        '{} transitions eager and {} from graph replays of {}; accept rate '
        '{!r}, step sizes {}'.format(
            HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, t, n / t, counts['eager'],
            counts['replayed'], n, diag['accept_rate'],
            np.round(diag['step_size'], 4).tolist()))
    r_hat = float(np.max(diag['r_hat']))
    mean_err = np.abs(gt['mean'] - cp.true_mean)
    sd = np.sqrt(np.diag(gt['cov']))
    sd_true = np.sqrt(np.diag(cp.true_cov))
    sd_rel = np.abs(sd / sd_true - 1)
    log('  max split R-hat {!r} (limit 1.01); mean against the stored CP '
        'truth: largest error {!r} (atol 0.2); stdevs: largest relative '
        'error {!r} (rtol 0.06)'.format(r_hat, float(mean_err.max()),
                                        float(sd_rel.max())))
    if counts != {'eager': 3 * mcmc._WARM, 'replayed': n - 3 * mcmc._WARM}:
        raise AssertionError('HMC did not replay its graphs: {}'.format(
            counts))
    if not (r_hat < 1.01 and mean_err.max() <= 0.2 and sd_rel.max() <= 0.06):
        raise AssertionError('HMC missed the stored truth')

    # busy share over HMC_TRACE transitions of the sampling phase
    C, d = HMC_CHAINS, ncp.dim
    g = card_generator(21)
    q0 = torch.randn((C, d), generator=g, device='cuda')
    eps = torch.as_tensor(diag['step_size'], device='cuda')
    mass = torch.as_tensor(diag['inv_mass'], device='cuda')
    draws = mcmc._phase_draws(g, HMC_TRACE, C, d, 32, torch.float32)
    log('  {} sampling transitions under the profiler: {}'.format(
        HMC_TRACE, busy_text(profile_busy(lambda: mcmc._phase(
            ncp.log_prob, q0, draws, eps, mass, False, 0.8, 32)), HMC_TRACE,
            'a transition')))

    # the graph against the eager body on the same draws, float64
    q64 = q0.double()
    draws64 = mcmc._phase_draws(g, HMC_COMPARE, C, d, 32, torch.float64)
    for adapt in (True, False):
        outs = {driver: mcmc._phase(ncp.log_prob, q64, draws64,
                                    eps.double(), mass.double(), adapt, 0.8,
                                    32, driver)
                for driver in ('graph', 'eager')}
        worst = max(max_rel(a, b) for a, b in zip(outs['graph'],
                                                  outs['eager']))
        log('  {} transitions, {}, float64: graph against eager, largest '
            'relative difference {!r} (limit 1e-10)'.format(
                HMC_COMPARE, 'adaptive' if adapt else 'sampling', worst))
        if not worst <= 1e-10:
            raise AssertionError('the HMC graph differs from the eager '
                                 'body')


def new_phases(vt):
    """Phases 18-21; the launch counts of 18, 19 and 21."""
    launches = [service_path(vt)]
    phases_done('18')
    launches.append(native_path(vt))
    phases_done('19')
    hmc_path(vt)
    phases_done('20')
    launches.append(mesh_path(vt))
    phases_done('21')
    return launches


def card_mesh(names, shape):
    """A mesh of the one card, listed once an entry."""
    from viabel_tpu_torch import parallel
    return parallel.make_mesh(names, shape=shape,
                              devices=['cuda:0'] * int(np.prod(shape)))


def part_line(label, seconds):
    log('  {}: {:.3f} s on {}'.format(label, seconds, card_line()))


def mesh_validated_vi(vt, model, fam):
    """Phase 21 (a): validated_vi on eight-schools CP with the bound pass,
    PSIS and the moments on a 4-way sample axis; then the S-way pass's
    cost against the unsharded pass; returns its fit and launches."""
    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    mesh = card_mesh(('sample',), (MESH_S,))
    reset_launches()
    t, out = wall(lambda: vt.validated_vi(
        model, fam, init, N_ITERS, n_mc_samples=N_MC,
        n_bound_samples=N_BOUND, learning_rate=0.01, learning_rate_end=0.001,
        generator=card_generator(21), mesh=mesh))
    launches = read_launches()
    b = out['bounds']
    log('validated_vi on a {}-way sample axis of cuda:0 ({} iterations, '
        '{:.1e} bound samples, float32): d2 {!r}, khat {!r}, W2 {!r}; q '
        'mean head {}'.format(MESH_S, N_ITERS, N_BOUND, float(b['d2']),
                              out['khat'], b['W2'],
                              out['q_mean'][:3].cpu().tolist()))
    part_line('(a) validated_vi(mesh=)', t)
    log('  kernel launches: {}'.format(launches))
    require_finite('validated_vi(mesh=)', dict(d2=b['d2'], W2=b['W2'],
                                               khat=out['khat']))
    require_launched(launches, ('transform_score_partials',
                                'combine_partials', 'adagrad_step'),
                     'validated_vi(mesh=)')
    require_adagrad_steps(launches, [N_ITERS], 'validated_vi(mesh=)')
    return out['opt_param'], launches


def mesh_costs(model, fam, opt):
    """What an S-way sample axis on one card costs: the bound pass, PSIS
    and the corrected moments at 2.5e6 samples, unsharded and on S
    shards (draws included), median of 5 after a warm-up."""
    from viabel_tpu_torch.pipeline import _bound_and_psis, _sharded_run
    from viabel_tpu_torch.psis import _tail_len

    tail = _tail_len(N_BOUND, 1.0)

    def unsharded():
        z = fam.base_sample(card_generator(5), N_BOUND, torch.float32)
        return _bound_and_psis(fam, model, 2.0, tail, opt, z)

    def sharded(S):
        line = card_mesh(('sample',), (S,)).line('sample')
        return _sharded_run(fam, model, 2.0, N_BOUND, opt, 12345, line,
                            torch.device('cuda:0'))

    costs = {}
    for label, fn in [('unsharded', unsharded)] + [
            ('S={}'.format(S), lambda S=S: sharded(S)) for S in MESH_COSTS]:
        fn()
        costs[label] = statistics.median(wall(fn)[0] for _ in range(5))
    log('  the bound pass + PSIS + moments at {:.1e} samples, float32, '
        'median of 5 (s): {} on {}'.format(
            N_BOUND, json.dumps({k: round(v, 5) for k, v in costs.items()}),
            card_line()))
    return costs


def bound_rel(got, want):
    """`max_rel` of two bounds, 0 where both are the same infinity."""
    if float(got) == float(want):
        return 0.0
    return max_rel(got, want)


def mesh_f64_checks(vt, model, fam, opt):
    """Phase 21 (a), f64 at 2e5 samples: the sharded pass against the
    unsharded pass on its shards' draws (K1 on eight-schools CP, the
    generators fold_in(seed, i)), PSIS, and the K2 row-range route on
    regression against the unsharded stream, each to 1e-10."""
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.experiments import draw_and_score
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops.philox import fold_in

    mesh = card_mesh(('sample',), (MESH_S,))
    vp = opt.double()
    n, seed, worst = MESH_SMALL, 777, {}
    got, lw = parallel.sharded_all_bounds(model, fam, vp, n, seed, mesh,
                                          return_log_weights=True)
    z = torch.cat([fam.base_sample(card_generator(fold_in(seed, i)),
                                   n // MESH_S, torch.float64)
                   for i in range(MESH_S)])
    samples, want_lw, _ = draw_and_score(model, fam, vp, z)
    want = vt.all_bounds(want_lw, samples=samples)
    worst['K1 bounds'] = max(bound_rel(got[k], want[k]) for k in want)
    worst['K1 lw'] = max_rel(parallel.fetch_global(lw), want_lw)
    slw, khat = parallel.psislw_sharded(lw, mesh)
    want_slw, want_khat = vt.psislw(want_lw)
    worst['PSIS khat'] = max_rel(khat, want_khat)
    worst['PSIS smoothed (abs)'] = float(np.abs(
        parallel.fetch_global(slw) - want_slw.cpu().numpy()).max())

    rmodel = regression_model()
    gfam = vt.mean_field_gaussian_variational_family(rmodel.dim)
    gvp = torch.as_tensor(np.concatenate([
        rmodel.true_mean, 0.5 * np.log(np.diag(rmodel.true_cov))]),
        device='cuda')
    got, lw, smp = parallel.sharded_all_bounds(
        rmodel, gfam, gvp, n, seed, mesh, return_log_weights=True,
        return_samples=True)
    want_lw, _ = gops.gaussian_sample_score_partials(
        gvp[:10], gvp[10:], n, seed, 0, rmodel.kernel,
        rmodel.kernel_data_like(gvp))
    want_smp = gfam.transform(gvp, gops.philox_normal(
        n, 10, seed, 0, 0, torch.float64, 'cuda'))
    want = vt.all_bounds(want_lw, samples=want_smp)
    finite = {k: bool(np.all(np.isfinite(np.asarray(want[k])))) for k in want}
    log('  K2 bounds finite (compared to 1e-10): {}; infinite in both '
        'passes (equal infinities count 0): {}'.format(
            sorted(k for k in want if finite[k]),
            sorted(k for k in want if not finite[k])))
    worst['K2 bounds'] = max(bound_rel(got[k], want[k]) for k in want)
    worst['K2 lw'] = max_rel(parallel.fetch_global(lw), want_lw)
    worst['philox_normal rows'] = max_rel(parallel.fetch_global(smp),
                                          want_smp)
    worst.update(all_inf_shard_check(vt, mesh, n))
    log('  sharded against unsharded on the same draws, float64, {:.0e} '
        'samples on {} shards: {} (limit 1e-10)'.format(
            n, MESH_S, json.dumps(worst)))
    if not all(v <= 1e-10 for v in worst.values()):
        raise AssertionError('a sharded pass differs from the unsharded '
                             'pass on its draws')


def stat_rel(got, want):
    """`bound_rel` of two statistics, 0 where both are NaN (a NaN on one
    side only counts infinite)."""
    if math.isnan(got) or math.isnan(want):
        return 0.0 if math.isnan(got) and math.isnan(want) else math.inf
    return bound_rel(got, want)


def all_inf_shard_check(vt, mesh, n):
    """Phase 21 (a), f64 (ROADMAP C.1): standard-normal log-weights with
    one shard's all -inf, the sharded statistics against the unsharded
    `bounds.log_weight_stats`, both on the card; returns the largest
    relative difference (equal infinities and two NaNs count 0)."""
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.bounds import STAT_KEYS

    lw = torch.randn(n, dtype=torch.float64, device='cuda',
                     generator=card_generator(31))
    shard = n // MESH_S
    lw[shard:2 * shard] = -math.inf
    got = parallel.sharded_log_weight_stats(lw, mesh)
    want = vt.log_weight_stats(lw)
    log('  one shard of {} all -inf, float64, {:.0e} log-weights: sharded '
        '{} against unsharded {}'.format(
            MESH_S, n, json.dumps({k: got[k] for k in STAT_KEYS}),
            json.dumps({k: want[k] for k in STAT_KEYS})))
    if not all(is_finite(got[k]) for k in ('mean_rescaled_alpha',
                                            'std_rescaled_alpha')):
        raise AssertionError('an all -inf shard made the sharded statistics '
                             'NaN')
    return {'all -inf shard stats': max(stat_rel(got[k], want[k])
                                        for k in STAT_KEYS)}


def mesh_multistart(vt):
    """Phase 21 (b): phase 13's mf-t KLVI multistart (16 starts, 1e6 bound
    samples each) on a (4, 2) (chain, sample) mesh of the card."""
    from viabel_tpu_torch.models import robust_regression_model

    model = robust_regression_model()
    name, fam, obj, init, lr, lr_end = multistart_configs(vt, model)[0]
    reset_launches()
    t, out = wall(lambda: vt.validated_vi_multistart(
        model, fam, init, MS_ITERS, init_params=init.repeat(MS_STARTS, 1),
        objective_and_grad=obj, n_bound_samples=MS_BOUND, learning_rate=lr,
        learning_rate_end=lr_end, generator=card_generator(20260819),
        mesh=card_mesh(('chain', 'sample'), (4, 2))))
    launches = read_launches()
    khat = np.asarray(out['khat'])
    d2 = np.asarray([b['d2'] for b in out['bounds']])
    mean, sd = MS_BAND[name]
    z = (khat.mean() - mean) / sd
    log('multistart {} on a (4, 2) mesh of cuda:0 ({} starts x {} '
        'iterations, n_bound {:.0e} each, float32): khat mean {!r} sd {!r} '
        '(JAX 16-seed {} +- {}: {:+.2f} sd), best {}, d2 median {!r}'
        .format(name, MS_STARTS, MS_ITERS, MS_BOUND, float(khat.mean()),
                float(khat.std(ddof=1)), mean, sd, z, out['best'],
                float(np.median(d2))))
    part_line('(b) validated_vi_multistart(mesh=)', t)
    log('  kernel launches: {}'.format(launches))
    if not (np.all(np.isfinite(khat)) and np.all(np.isfinite(d2))):
        raise AssertionError('multistart on a mesh: a khat or d2 is not '
                             'finite')
    if abs(z) >= 3:
        raise AssertionError('multistart on a mesh: the mean khat is {:+.2f}'
                             ' sd from the JAX package\'s'.format(z))
    require_launched(launches, ('transform_score_partials',
                                'combine_partials', 'adagrad_step'),
                     'multistart(mesh=)')
    # each chain group one batched run of its 4 starts
    require_adagrad_steps(launches, [MS_ITERS] * 4, 'multistart(mesh=)')
    return launches


def mesh_ia_chains(vt):
    """Phase 21 (c): the 4 RMSProp-IA regression chains on a 4-way chain
    axis, against the same run without a mesh; then improve_with_psis on a
    4-way sample axis (K2 and philox_normal on each shard's rows) against
    the unsharded pass on the same Philox draws."""
    model = regression_model()
    fam = vt.mean_field_gaussian_variational_family(model.dim)
    reset_launches()
    t, (ia_param, chains, ia_log) = wall(lambda: ia_fit(
        vt, model, fam, MESH_IA_ITERS, IA_CHAINS, torch.float32, 'cuda',
        card_generator(0), mesh=card_mesh(('chain',), (IA_CHAINS,))))
    t_psis, (psis, mean, cov) = wall(
        lambda: vt.experiments.improve_with_psis_sharded(
            model, fam, ia_param, IA_BOUND, model.true_mean, model.true_cov,
            card_mesh(('sample',), (MESH_S,)), generator=card_generator(2)))
    launches = read_launches()
    want, want_mean, want_cov = vt.improve_with_psis(
        model, fam, ia_param, IA_BOUND, model.true_mean, model.true_cov,
        generator=card_generator(2), device='cuda')
    # a group of one chain batches the objective's products otherwise
    # than four chains do, so the card rounds them otherwise (on the CPU
    # they agree bit for bit, tests/test_torch_parallel.py): in float32
    # the chains part by a few ulps of their largest value, and in float64
    # by what float64 rounding gives; a group given another chain's draws
    # or rows would part by the chains' own spread
    parted = {}
    for dtype, n_iters, mesh_chains in (
            (torch.float32, MESH_IA_ITERS, chains),
            (torch.float64, MESH_IA_F64_ITERS, None)):
        if mesh_chains is None:
            _, mesh_chains, _ = ia_fit(
                vt, model, fam, n_iters, IA_CHAINS, dtype, 'cuda',
                card_generator(0), mesh=card_mesh(('chain',), (IA_CHAINS,)))
        _, plain_chains, _ = ia_fit(vt, model, fam, n_iters, IA_CHAINS,
                                    dtype, 'cuda', card_generator(0))
        parted[str(dtype).split('.')[-1]] = float(
            np.abs(mesh_chains - plain_chains).max()
            / np.abs(plain_chains).max())
    log('regression IA, {} chains x {} iterations on a {}-way chain axis of '
        'cuda:0, float32: start iterations {} / {}; the chains against the '
        'run without a mesh ({} iterations in float64), largest difference '
        'over the largest value: {} (limits {})'.format(
            IA_CHAINS, MESH_IA_ITERS, IA_CHAINS,
            ia_log['start_avg_mean_iters'], ia_log['start_avg_sigma_iters'],
            MESH_IA_F64_ITERS, json.dumps(parted), json.dumps(MESH_IA_TOL)))
    if not all(parted[k] <= MESH_IA_TOL[k] for k in MESH_IA_TOL):
        raise AssertionError('the IA chains on a chain mesh differ from the '
                             'run without a mesh')
    part_line('(c) rmsprop_IA_optimize_with_rhat(mesh=)', t)
    diffs = dict(khat=max_rel(psis['khat'], want['khat']),
                 mean=max_rel(mean, want_mean), cov=max_rel(cov, want_cov))
    log('  improve_with_psis_sharded at {:.0e} on {} shards: khat {!r}, '
        'PSIS mean error {!r}; against improve_with_psis on the same draws: '
        '{}'.format(IA_BOUND, MESH_S, psis['khat'],
                    float(psis['mean_error']), json.dumps(diffs)))
    part_line('(c) improve_with_psis_sharded', t_psis)
    log('  kernel launches: {}'.format(launches))
    require_finite('IA chains on a mesh', dict(
        khat=psis['khat'], mean_error=float(psis['mean_error'])))
    # the tail candidates are the same lw bits, so khat matches to the
    # fit's rounding; the sums over shards reassociate the moments
    if not (diffs['khat'] <= 1e-5 and diffs['mean'] <= 1e-4
            and diffs['cov'] <= 1e-3):
        raise AssertionError('improve_with_psis_sharded differs from '
                             'improve_with_psis on its draws')
    require_launched(launches, ('gaussian_sample_score_partials',
                                'philox_normal', 'combine_partials'),
                     'IA chains and PSIS on a mesh')
    return launches


def mesh_service(vt):
    """Phase 21 (d): /bounds?n=1e6 of the service through a 2-way mesh of
    the card, and its latency beside the service without a mesh."""
    from viabel_tpu_torch import serve
    from viabel_tpu_torch.config import ExperimentConfig, build

    cfg = ExperimentConfig()
    model, family, objective = build(cfg)
    var_param = serve._fit_from_config(cfg, model, family, objective,
                                       device='cuda')
    lat = {}
    for label, devices in (('2-way mesh', ['cuda:0'] * 2), ('no mesh', [])):
        service = serve.PosteriorService(model, family, var_param,
                                         seed=cfg.seed, device='cuda',
                                         mesh_devices=devices)
        httpd, thread = serve.start_server(service, port=0,
                                           host='127.0.0.1')
        base = 'http://127.0.0.1:{}'.format(httpd.server_address[1])
        path = '/bounds?n={}'.format(SERVE_BOUND)
        try:
            if devices:
                reset_launches()
                bounds = http_get(base, path)
                launches = read_launches()
                log('service /bounds?n={} through a 2-way sample axis of '
                    'cuda:0: {}'.format(SERVE_BOUND, bounds))
                log('  kernel launches: {}'.format(launches))
                require_finite('/bounds through a mesh', bounds)
                require_launched(launches, ('transform_score_partials',
                                            'combine_partials'),
                                 '/bounds through a mesh')
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                http_get(base, path)
                times.append(time.perf_counter() - t0)
            lat[label] = statistics.median(times)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
    part_line('(d) /bounds?n={} median of 5, 2-way mesh'.format(SERVE_BOUND),
              lat['2-way mesh'])
    part_line('(d) /bounds?n={} median of 5, no mesh'.format(SERVE_BOUND),
              lat['no mesh'])
    return launches


def rank_workloads(devices):
    """Phase 21 (e)'s work on a 2-entry mesh of `devices`, as host numpy:
    a sharded bound pass and PSIS on eight-schools CP (K1, float32) and 2
    RMSProp-IA regression chains on the chain axis."""
    import viabel_tpu_torch as vt
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.models import eight_schools_cp_model

    mesh = parallel.make_mesh(('sample',), devices=devices)
    fam = vt.mean_field_t_variational_family(10, 40)
    vp = torch.cat([torch.full((10,), 0.5), torch.full((10,), -0.5)]).to(
        'cuda')
    res, lw = parallel.sharded_all_bounds(eight_schools_cp_model(), fam, vp,
                                          MESH_RANK_N, 4321, mesh,
                                          return_log_weights=True)
    slw, khat = parallel.psislw_sharded(lw, mesh)
    rmodel = regression_model()
    gfam = vt.mean_field_gaussian_variational_family(rmodel.dim)
    ia = vt.rmsprop_IA_optimize_with_rhat(
        300, vt.black_box_klvi(gfam, rmodel, N_MC, presampled=True),
        torch.zeros(20, device='cuda'), 10, generator=card_generator(3),
        learning_rate=IA_LR, n_optimisers=2, rhat_window=100,
        tail_avg_iters=75, mesh=parallel.make_mesh(('chain',),
                                                   devices=devices))
    return dict(d2=np.asarray(res['d2']), W2=np.asarray(res['W2']),
                lw=parallel.fetch_global(lw), slw=parallel.fetch_global(slw),
                khat=parallel.fetch_global(khat), chains=ia[1],
                avg=ia[6]['averaged_variational_param'])


def rank_worker(rank, world, init, out):
    """`chip_smoke.py --rank-worker`: phase 21 (e)'s work as `rank` of
    `world` (1: one process on a 2-entry mesh of the card, or of two cards
    for NCCL), saved to `out`."""
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.ops import _build

    _build.build_all()
    nccl = torch.cuda.device_count() > 1
    if world > 1:
        # a card each (NCCL) where there are two, else both on cuda:0
        info = parallel.initialize_distributed(
            init, world, rank,
            local_devices=['cuda:{}'.format(rank if nccl else 0)])
        assert info['global_devices'] == 2, info
        devices = parallel.devices()
    else:
        devices = ['cuda:0', 'cuda:1'] if nccl else ['cuda:0'] * 2
    np.savez(out, **rank_workloads(devices))
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


def spawn_workers(flag, specs, names):
    """Run ``chip_smoke.py <flag> rank world init out`` once a ``(rank,
    world)`` of `specs`, all at once, sharing one ``file://`` rendezvous;
    returns each one's saved npz as a dict.  Every process is stopped
    before it returns; one that fails raises with its output."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix='chip_smoke_ranks_')
    init = 'file://' + os.path.join(tmp, 'init')
    outs = [os.path.join(tmp, n + '.npz') for n in names]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(w),
         init, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for (r, w), out in zip(specs, outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError('a rank failed:\n' + text[-3000:])
    return [dict(np.load(o)) for o in outs]


def mesh_ranks():
    """Phase 21 (e): 2 ranks spawned on the one card over Gloo (over NCCL,
    a card each, where there are two cards) against the one-process
    2-entry mesh, bit for bit."""
    backend = 'NCCL' if torch.cuda.device_count() > 1 else 'Gloo'
    t0 = time.perf_counter()
    r0, r1, one = spawn_workers('--rank-worker', ((0, 2), (1, 2), (0, 1)),
                                ('r0', 'r1', 'one'))
    t = time.perf_counter() - t0
    same = all(np.array_equal(r[k], one[k]) for r in (r0, r1) for k in one)
    log('2 ranks over {} ({} each of the 2-entry mesh) against one process '
        'on the 2-entry mesh: bound pass of {:.0e} samples (d2 {!r}), PSIS '
        '(khat {!r}), 2 IA chains: equal bit for bit {}'.format(
            backend, 'a card' if backend == 'NCCL' else 'cuda:0',
            MESH_RANK_N, float(one['d2']), float(one['khat']), same))
    part_line('(e) 3 processes spawned, start to finish', t)
    if not same:
        raise AssertionError('the ranks differ from one process')


def cards_multistart(mesh):
    """Phase 21 (b)'s multistart (mf-t KLVI, 16 starts x 5000 iterations,
    1e6 bound samples each, float32) on `mesh` (None: one card, no mesh):
    the wall of its second call (the first builds the graphs) and its
    khats and fits as host numpy."""
    import viabel_tpu_torch as vt
    from viabel_tpu_torch.models import robust_regression_model

    model = robust_regression_model()
    _, fam, obj, init, lr, lr_end = multistart_configs(vt, model)[0]

    def run():
        out = vt.validated_vi_multistart(
            model, fam, init, MS_ITERS, init_params=init.repeat(MS_STARTS, 1),
            objective_and_grad=obj, n_bound_samples=MS_BOUND,
            learning_rate=lr, learning_rate_end=lr_end,
            generator=card_generator(20260819), mesh=mesh)
        return dict(khat=np.asarray(out['khat']),
                    opt=out['opt_param'].cpu().numpy())

    run()
    return wall(run)


def cards_worker(rank, world, init, out):
    """`chip_smoke.py --cards-worker`: `cards_multistart` on
    `parallel.auto_mesh`'s mesh of every card, as `rank` of `world` ranks
    that share the host's cards out (NCCL), saved to `out`."""
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.ops import _build

    _build.build_all()
    info = parallel.initialize_distributed(init, world, rank)
    mesh, note = parallel.auto_mesh(MS_STARTS, MS_BOUND)
    t, res = cards_multistart(mesh)
    np.savez(out, wall=t, note=note, local=info['local_devices'], **res)
    torch.distributed.destroy_process_group()
    return 0


def mesh_cards():
    """``--mesh-cards`` (two cards or more; no result line): phase 21
    (b)'s multistart on every card, in one process on `auto_mesh`'s mesh
    of the cards and as 2 NCCL ranks holding half the cards each, against
    the same 16 starts on one card without a mesh; each the wall of a
    second call, the ranks' results held to the one process's bit for
    bit."""
    from viabel_tpu_torch import parallel
    from viabel_tpu_torch.ops import _build

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit('--mesh-cards needs two cards or more')
    log(card_line())
    _build.build_all()
    t_one, one = cards_multistart(None)
    mesh, note = parallel.auto_mesh(MS_STARTS, MS_BOUND)
    t_mesh, got = cards_multistart(mesh)
    ranks = spawn_workers('--cards-worker', ((0, 2), (1, 2)), ('r0', 'r1'))
    same = all(np.array_equal(r[k], got[k]) for r in ranks for k in got)
    log('multistart mf-t KLVI, {} starts x {} iterations, {:.0e} bound '
        'samples each, float32, second call: one card without a mesh {:.3f}'
        ' s; one process on {} ({}): {:.3f} s; 2 NCCL ranks of {} cards '
        'each ({}): {} s (each rank\'s); the ranks equal the one process '
        'bit for bit {}; khat mean {!r} without a mesh, {!r} on the mesh'
        .format(MS_STARTS, MS_ITERS, MS_BOUND, t_one, mesh, note, t_mesh,
                int(ranks[0]['local']), str(ranks[0]['note']),
                [round(float(r['wall']), 3) for r in ranks], same,
                float(one['khat'].mean()), float(got['khat'].mean())))
    log(card_line())
    if not same:
        raise AssertionError('the ranks differ from one process')
    return 0


def mesh_path(vt):
    """Phase 21: the mesh paths on the card, each part counted alone;
    returns the sum of their launch counts."""
    from viabel_tpu_torch.models import eight_schools_cp_model

    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    opt, total = mesh_validated_vi(vt, model, fam)
    mesh_costs(model, fam, opt)
    mesh_f64_checks(vt, model, fam, opt)
    for part in (mesh_multistart, mesh_ia_chains, mesh_service):
        add_launches(total, part(vt))
    mesh_ranks()
    return total


def jax_bench_line():
    """bench.py's printed dict, read from its source: its keys, `metric`,
    `unit` and the keys of its `extra`."""
    import ast

    with open(os.path.join(HERE, 'bench.py')) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, 'attr', None)
                == 'dumps' and isinstance(node.args[0], ast.Dict)):
            keys = [k.value for k in node.args[0].keys]
            values = dict(zip(keys, node.args[0].values))
            return (keys, values['metric'].value, values['unit'].value,
                    [k.value for k in values['extra'].keys])
    raise AssertionError('bench.py prints no JSON dict')


def fresh_worker(part, out):
    """Phase 22's profiled parts in a process of their own (``chip_smoke.py
    --fresh-worker <part> <out>``): 'bench' runs ``__main__.main(['bench'])``
    with the launch counts set to 0 just before and read just after,
    'trace' `k1_trace`; the results go to `out` as JSON.  Profiler traces
    taken late in this script's process, after phase 20's trace of ~3e5
    kernel records, came back without kernel records or with only some of
    them (six empty in a row, and a draw + score pass read at 3.1 ms
    against 5.3 ms in a fresh process, on an NVIDIA H100 80GB HBM3,
    700.00 W), so these traces start in a process of their own."""
    if part == 'bench':
        reset_launches()
        t, stdout = run_cli(['bench'])
        result = dict(seconds=t, stdout=stdout, launches=read_launches())
    else:
        result = k1_trace()
    with open(out, 'w') as f:
        json.dump(result, f)
    return 0


def fresh_process(part):
    """`fresh_worker`'s result for `part`, its output logged; the process
    is stopped before this returns, and one that fails raises with its
    output."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix='chip_smoke_fresh_') as tmp:
        out = os.path.join(tmp, part + '.json')
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--fresh-worker',
             part, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            text = proc.communicate(timeout=600)[0].decode()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for line in text.splitlines():
            log('  | ' + line)
        if proc.returncode != 0:
            raise AssertionError('the {} process failed'.format(part))
        with open(out) as f:
            return json.load(f)


def bench_part(vt):
    """Phase 22 (a): ``python -m viabel_tpu_torch bench`` at bench.py's
    sizes, in a process of its own (`fresh_worker`); its line against
    bench.py's keys, its numbers finite, and K1, K3, the combine and the
    step (runs at K = 1 and the multistart batch at K = 8) launched;
    returns its launches."""
    from viabel_tpu_torch import bench

    res = fresh_process('bench')
    t, launches = res['seconds'], res['launches']
    line = json.loads(res['stdout'].strip().splitlines()[-1])
    log('  bench line: {}'.format(json.dumps(line)))
    part_line('(a) python -m viabel_tpu_torch bench', t)
    log('  kernel launches: {}'.format(launches))
    keys, metric, unit, extra = jax_bench_line()
    if (list(line) != keys or list(line['extra']) != extra + ['device']
            or (line['metric'], line['unit']) != (metric, unit)):
        raise AssertionError('the bench line is not bench.py\'s: {}'.format(
            sorted(line)))
    device_ms_value = line['extra']['draw_score_device_ms']
    log('  draw_score_device_ms: {}'.format(
        'not measured (the retries are logged above)'
        if device_ms_value is None else device_ms_value))
    numbers = {k: v for k, v in line['extra'].items() if k != 'device'}
    if device_ms_value is None:
        del numbers['draw_score_device_ms']
    flat = [line['value'], line['vs_baseline']] + [
        x for v in numbers.values()
        for x in (v if isinstance(v, list) else [v])]
    if not all(isinstance(x, (int, float)) and is_finite(x) for x in flat):
        raise AssertionError('a bench number is not finite: {}'.format(line))
    require_launched(launches, ('transform_score_partials', 'lw_partials',
                                'combine_partials'), 'bench')
    # KLVI 1 + 2 (1 + reps) runs, CHIVI 1 + reps, the fused validated_vi
    # 1 + reps of 2 n_iters, and the multistart's 1 + reps batches, each
    # one step launch a batched iteration (at K = 1 it would be n_starts)
    n, reps = bench.N_ITERS, bench.REPS
    runs = ([n] * (1 + 2 * (1 + reps)) + [n] * (1 + reps)
            + [2 * n] * (1 + reps) + [2 * n] * (1 + reps))
    require_adagrad_steps(launches, runs, 'bench')
    return launches


def perturbed_ia_part(vt):
    """Phase 22 (b): RMSProp-IA with perturbed_black_box_vi on phase 6's
    regression (4 chains, `PERTURB_ITERS`, float32), its averaged fit's
    bound pass (K2), then the chains at float64 on the card against the
    CPU; returns the launches of the run and its bound pass."""
    from viabel_tpu_torch.bounds import family_moment_bounds

    model = regression_model()
    fam = vt.mean_field_gaussian_variational_family(model.dim)
    obj = vt.perturbed_black_box_vi(fam, model, N_MC,
                                    perturbation_scale=PERTURB_SCALE)
    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    reset_launches()
    t, out = wall(lambda: vt.rmsprop_IA_optimize_with_rhat(
        PERTURB_ITERS, obj, init, fam.dim, generator=card_generator(22),
        learning_rate=IA_LR, n_optimisers=IA_CHAINS,
        rhat_window=max(PERTURB_ITERS // 10, 100),
        tail_avg_iters=PERTURB_ITERS // 4, device='cuda'))
    _, _, avg_means, avg_sigmas, _, _, ia_log = out
    ia_param = torch.as_tensor(np.concatenate([avg_means[0][-1],
                                               avg_sigmas[0][-1]]),
                               device='cuda')
    t_bound, (_, lw) = wall(lambda: vt.get_samples_and_log_weights(
        model, fam, ia_param, IA_BOUND, generator=card_generator(23),
        device='cuda'))
    bounds = vt.all_bounds(
        lw, q_var=fam.mean_and_cov(ia_param)[1].cpu().numpy(),
        moment_bound_fn=family_moment_bounds(fam, ia_param))
    launches = read_launches()
    fit = vt.check_approx_accuracy(fam, ia_param, model.true_mean,
                                   model.true_cov)
    rhat = {k: float(np.max(ia_log[k])) for k in (
        'r_hat_mean', 'r_hat_sigma', 'r_hat_mean_halfway',
        'r_hat_sigma_halfway')}
    log('  RMSProp-IA with perturbed_black_box_vi (perturbation scale {}, '
        '{} chains x {} iterations, n_mc {}, lr {}, float32): {:.1f} it/s; '
        'R-hat maxima {}; averaging starts {} / {}; fit mean error {!r}; '
        'bound pass at {:.0e} {:.3f} s, d2 {!r}'.format(
            PERTURB_SCALE, IA_CHAINS, PERTURB_ITERS, N_MC, IA_LR,
            PERTURB_ITERS / t, json.dumps(rhat),
            ia_log['start_avg_mean_iters'], ia_log['start_avg_sigma_iters'],
            float(fit['mean_error']), IA_BOUND, t_bound,
            float(bounds['d2'])))
    part_line('(b) perturbed RMSProp-IA', t)
    log('  kernel launches: {}'.format(launches))
    require_finite('perturbed IA', dict(rhat, d2=bounds['d2'],
                                        mean_error=fit['mean_error']))
    if not torch.isfinite(ia_param).all():
        raise AssertionError('the perturbed chains\' averaged parameter is '
                             'not finite')
    require_launched(launches, ('gaussian_sample_score_partials',
                                'philox_normal', 'combine_partials'),
                     'perturbed IA')
    perturbed_card_vs_cpu(vt, model, fam)
    return launches


def perturbed_card_vs_cpu(vt, model, fam):
    """Phase 22 (b), float64: the perturbed chains (2 x `PERTURB_SMALL`
    iterations) on the card against the CPU on shared draws: each
    iteration's noise and base draws come from the CPU's generators of
    the chains' seeds (a CUDA generator of the same seed draws another
    torch.randn stream), the inits from the Philox stream; values,
    history, final and averaged parameters each to 1e-10 of their largest
    value."""
    from viabel_tpu_torch import optimizers as topt
    from viabel_tpu_torch.ops.philox import philox_normal_plain

    obj = vt.perturbed_black_box_vi(fam, model, N_MC,
                                    perturbation_scale=PERTURB_SCALE)
    P, C, n = fam.var_param_dim, 2, PERTURB_SMALL
    draw = topt._generator_draws(obj, [41, 42], 'cpu', torch.float64)
    per_iter = [draw(i) for i in range(n)]
    block = {k: torch.stack([d[k] for d in per_iter], dim=1)
             for k in per_iter[0]}
    inits = topt._perturbed_inits(
        torch.zeros(P, dtype=torch.float64), C, 0.5,
        philox_normal_plain(C, P, 43, 0, dtype=torch.float64))
    outs = {}
    for dev in ('cpu', 'cuda'):
        (values, lns, hist), final, avg = topt._chains_run(
            topt._batched_step(obj, None), 'rmsprop', n, IA_LR, 1e-6, None,
            inits.to(dev), {k: v.to(dev) for k, v in block.items()},
            avg_start=int(n // 1.3))
        outs[dev] = (values, hist, final, avg)
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(outs['cuda'], outs['cpu']))
    log('  perturbed chains, card against CPU on shared draws, float64, {} '
        'chains x {} iterations: largest difference over the largest value '
        '{:.3e} (limit 1e-10)'.format(C, n, worst))
    if not worst <= 1e-10:
        raise AssertionError('the perturbed chains on the card differ from '
                             'the CPU\'s')


def read_trace(log_dir):
    """The newest Chrome trace under `log_dir`: its events' categories
    counted, and its kernel records' names and durations (us)."""
    import glob

    path = max(glob.glob(os.path.join(log_dir, '*.pt.trace.json')),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    cats = {}
    for e in events:
        cats[str(e.get('cat'))] = cats.get(str(e.get('cat')), 0) + 1
    kernels = [(e.get('name', ''), e.get('dur', 0)) for e in events
               if e.get('ph') == 'X'
               and str(e.get('cat', '')).lower() == 'kernel']
    return cats, kernels


def k1_trace():
    """Phase 22 (c)'s trace, in a process of its own: K1's `device_ms` on
    eight-schools CP at a stand-in fit (its ground-truth moments) and
    2.5e6 samples, and `utils.trace_device_time` of a `profile_trace`
    around one K1 pass (`draw_and_score` on drawn z, after an L2 flush,
    the conditions of `device_ms`), the trace taken again, up to 6 times,
    while it holds no kernel record; each trace's event categories and
    kernel records are logged."""
    import tempfile
    import viabel_tpu_torch as vt
    from viabel_tpu_torch.experiments import draw_and_score
    from viabel_tpu_torch.models import eight_schools_cp_model
    from viabel_tpu_torch.utils import profile_trace, trace_device_time

    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    opt = moments_fit(model)
    z = fam.base_sample(card_generator(7), N_BOUND, torch.float32)
    k1_ms = device_ms(lambda: draw_and_score(model, fam, opt, z),
                      KERNEL_KEY['transform_score_partials'])
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device='cuda')
    seconds = None
    for attempt in range(6):
        with tempfile.TemporaryDirectory(dir=HERE, prefix='.phase22-') as d:
            torch.cuda.synchronize()
            with profile_trace(d):
                flush.zero_()
                draw_and_score(model, fam, opt, z)
            seconds = trace_device_time(d)
            cats, kernels = read_trace(d)
        log('trace {}: event categories {}; kernel records {}'.format(
            attempt + 1, json.dumps(cats),
            json.dumps([(name[:60], dur) for name, dur in kernels])))
        if seconds:
            break
        time.sleep(1.0)
    return dict(k1_device_ms=k1_ms, trace_s=seconds)


def utils_part(vt, model, fam):
    """Phase 22 (c): `utils` on the card.  The kernel time of a
    `profile_trace` around one K1 pass (`k1_trace`, in a process of its
    own) must be positive and no less than K1's `device_ms` there;
    `count_compilations` around one validated_vi counts its captures, and
    a `Timer` with `sync` of that fit prints its line."""
    import re
    from viabel_tpu_torch.utils import Timer, count_compilations

    res = fresh_process('trace')
    seconds, k1_ms = res['trace_s'], res['k1_device_ms']
    log('  trace_device_time of one K1 pass: {} ms; K1 device_ms {} ms'
        .format(None if seconds is None else seconds * 1e3, k1_ms))
    if not seconds or (k1_ms is not None and seconds * 1e3 < k1_ms):
        raise AssertionError('trace_device_time read {} s, below K1\'s '
                             'device_ms or none'.format(seconds))
    init = torch.zeros(fam.var_param_dim, dtype=torch.float32, device='cuda')
    held = {}
    buf = io.StringIO()
    with count_compilations() as captures, contextlib.redirect_stdout(buf):
        with Timer('validated_vi (phase 22 (c))',
                   sync=lambda: [held['out']['opt_param'],
                                 held['out']['smoothed_log_weights']]):
            held['out'] = vt.validated_vi(
                model, fam, init, N_ITERS, n_mc_samples=N_MC,
                n_bound_samples=N_BOUND, learning_rate=0.01,
                learning_rate_end=0.001, generator=card_generator(24),
                device='cuda')
    printed = buf.getvalue()
    log('  Timer: {!r}; count_compilations: {} captures'.format(
        printed, captures[0]))
    if not re.match(r'^validated_vi \(phase 22 \(c\)\) took \d+\.\d{3} '
                    r'(microsec|millisec|sec) to run\n$', printed):
        raise AssertionError('Timer printed {!r}'.format(printed))
    if captures[0] < 1:
        raise AssertionError('count_compilations counted no capture of a '
                             'validated_vi on the card')


def phase22(vt, model, fam):
    """Phase 22: the port's bench, perturbed IA chains and `utils` on the
    card, each part counted alone; returns the sum of (a)'s and (b)'s
    launch counts."""
    total = {}
    add_launches(total, bench_part(vt))
    add_launches(total, perturbed_ia_part(vt))
    utils_part(vt, model, fam)
    return total


# phase 23: the example layer (viabel_tpu_torch.examples) on the card.  (a)
# the four examples behind benchmarks/parity.py's 20 rows at --full, nothing
# cut; (b) examples/chivi_experiments.py at full widths, each protocol's HMC
# truth cut from 20000 samples to 4000 (the example's quick mode); (c)
# multistart_pipeline --full, linear_regression_ia's protocol 2 at N 200, k
# 20 (1500 of its 7000 iterations), eight_schools_ia's full-rank protocol
# (3000 of 30000) and pod_layout at its own sizes with the card listed 8
# times
EX_HMC_SAMPLES, EX_IA2_ITERS, EX_ESIA_ITERS, EX_POD_DEVICES = \
    4000, 1500, 3000, 8
# multistart_pipeline's best start: its PSIS-corrected mean within 0.25 of
# the NUTS truth (the JAX example's test, tests/test_examples.py)
EX_MS_MEAN_ATOL = 0.25
# a parity row inside mean +- 4 sd of its seed band: 20 rows at once, so 4
# sd (not one row's 3) keeps the phase's false-alarm rate near 0.1 %
PARITY_SD = 4
# the full-rank robust-regression khat: the JAX package's own float32 band
# on the CPU (tools/jax_khat_band.py), phase 13's rule, in place of the
# TPU band of benchmarks/KHAT_NOISE.json
FULL_RANK_KHAT = (-0.9063, 0.0635)
ROOTED_W2, ROOTED_RTOL = 2.72, 0.02   # the notebook's own (rooted) input
CHIVI_MEAN_ERR = 0.05                 # the JAX run gives 0.002-0.007
# benchmarks/parity.py:180-243: row, example, its number, the reference
PARITY_ROWS = (
    ('robust-regression mf-t KLVI khat', 'robust_regression',
     ('khat_klvi',), '0.92'),
    ('robust-regression mf-t CHIVI khat', 'robust_regression',
     ('khat_chivi',), '0.341'),
    ('robust-regression full-rank KLVI khat', 'robust_regression',
     ('khat_full',), '-0.93'),
    ('robust-regression full-rank KLVI W2', 'robust_regression',
     ('W2_full',), '0.385'),
    ('robust-regression full-rank KLVI d2', 'robust_regression',
     ('d2_full',), '5.92e-4'),
    ('robust-regression full-rank KLVI mean_error', 'robust_regression',
     ('mean_err_full',), '0.0456'),
    ('funnel KLVI khat', 'funnel', ('khat_klvi',), '0.768'),
    ('funnel CHIVI khat', 'funnel', ('khat_chivi',), '0.894'),
    ('normal-mixture samples-only W2', 'normal_mixture',
     ('samples_only', 'W2'), '6.08'),
    ('normal-mixture samples-only d2', 'normal_mixture',
     ('samples_only', 'd2'), '0.768'),
    ('normal-mixture samples-only mean_error', 'normal_mixture',
     ('samples_only', 'mean_error'), '4.79'),
    ('normal-mixture q_var+log_norm W2', 'normal_mixture',
     ('q_var_lnb', 'W2'), '4.41'),
    ('normal-mixture q_var+log_norm d2', 'normal_mixture',
     ('q_var_lnb', 'd2'), '0.277'),
    ('normal-mixture q_var+log_norm mean_error', 'normal_mixture',
     ('q_var_lnb', 'mean_error'), '2.52'),
    ('normal-mixture analytic-moment (corrected) W2', 'normal_mixture',
     ('analytic_mb', 'W2'), '6.08 (empirical)'),
    ('normal-mixture analytic-moment (ref rooted input) W2',
     'normal_mixture', ('analytic_mb_ref_input', 'W2'), '2.72'),
    ('eight-schools CP KLVI khat', 'eight_schools', ('cp', 'khat_klvi'),
     '0.906'),
    ('eight-schools CP CHIVI khat', 'eight_schools', ('cp', 'khat_chivi'),
     '0.875'),
    ('eight-schools NCP KLVI khat', 'eight_schools', ('ncp', 'khat_klvi'),
     '0.649'),
    ('eight-schools NCP CHIVI khat', 'eight_schools', ('ncp', 'khat_chivi'),
     '0.552'),
)
# benchmarks/parity.py:133-158: each banded row's seed band in
# benchmarks/KHAT_NOISE.json (config, metric); the rooted-input row has none
NOISE_KEY = {
    'robust-regression mf-t KLVI khat': ('rr_klvi', 'khat'),
    'robust-regression mf-t CHIVI khat': ('rr_chivi', 'khat'),
    'robust-regression full-rank KLVI khat': ('rr_full_klvi', 'khat'),
    'robust-regression full-rank KLVI W2': ('rr_full_klvi', 'W2'),
    'robust-regression full-rank KLVI d2': ('rr_full_klvi', 'd2'),
    'robust-regression full-rank KLVI mean_error':
        ('rr_full_klvi', 'mean_error'),
    'funnel KLVI khat': ('funnel_klvi', 'khat'),
    'funnel CHIVI khat': ('funnel_chivi', 'khat'),
    'eight-schools CP KLVI khat': ('es_cp_klvi', 'khat'),
    'eight-schools CP CHIVI khat': ('es_cp_chivi', 'khat'),
    'eight-schools NCP KLVI khat': ('es_ncp_klvi', 'khat'),
    'eight-schools NCP CHIVI khat': ('es_ncp_chivi', 'khat'),
    'normal-mixture samples-only W2': ('nm_samples_only', 'W2'),
    'normal-mixture samples-only d2': ('nm_samples_only', 'd2'),
    'normal-mixture samples-only mean_error': ('nm_samples_only',
                                               'mean_error'),
    'normal-mixture q_var+log_norm W2': ('nm_qvar_lnb', 'W2'),
    'normal-mixture q_var+log_norm d2': ('nm_qvar_lnb', 'd2'),
    'normal-mixture q_var+log_norm mean_error': ('nm_qvar_lnb',
                                                 'mean_error'),
    'normal-mixture analytic-moment (corrected) W2': ('nm_analytic', 'W2'),
}
# what each part of (a) must launch, and the adagrad runs it makes, all
# through the graph
EX_PARTS = {
    'normal_mixture': (('lw_partials', 'combine_partials'), []),
    'robust_regression': (('transform_score_partials', 'lw_partials',
                           'combine_partials', 'adagrad_step'), [5000] * 6),
    'funnel': (('transform_score_partials', 'lw_partials',
                'combine_partials', 'adagrad_step'), [10000] * 2),
    'eight_schools': (('transform_score_partials', 'lw_partials',
                       'combine_partials', 'adagrad_step'),
                      [10000] * 2 + [5000] * 2),
}


def read_json(path):
    with open(os.path.join(HERE, path)) as f:
        return json.load(f)


def example_part(label, fn, names, runs=None):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: its wall beside the card, and every kernel of `names`
    launched (with `runs`, the adagrad runs' lengths, each through the
    graph after its window).  Returns ``(fn(), launches)``."""
    reset_launches()
    seconds, out = wall(fn)
    launches = read_launches()
    part_line(label, seconds)
    log('kernel launches on {}: {}'.format(label, launches))
    require_launched(launches, names, label)
    if runs:
        require_adagrad_steps(launches, runs, label)
    return out, launches


def parity_rows(outs):
    """Phase 23 (a)'s 20 rows: ours beside the JAX package's CPU-f64 and
    TPU-f32 columns and the reference, each banded row held to mean +- 4
    sd of its seed band."""
    cols = [{r[0]: r[1] for r in read_json(
        'benchmarks/RESULTS_{}.json'.format(c))['rows']}
        for c in ('cpu-f64', 'tpu-f32')]
    noise = read_json('benchmarks/KHAT_NOISE.json')['configs']
    out_of_band = []
    log('parity rows: ours (H100 f32) | JAX CPU f64 | JAX TPU f32 | '
        'reference | band')
    for name, example, path, ref in PARITY_ROWS:
        ours = outs[example]
        for k in path:
            ours = ours[k]
        ours = float(ours)
        if name == 'robust-regression full-rank KLVI khat':
            mean, sd = FULL_RANK_KHAT
            tpu = noise['rr_full_klvi']['khat']
            band = ('JAX CPU f32 {} +- {} (TPU band {:.4f} +- {:.4f}, for '
                    'the record)'.format(mean, sd, tpu['mean'], tpu['sd']))
        elif name in NOISE_KEY:
            cfg, metric = NOISE_KEY[name]
            mean, sd = (noise[cfg][metric][k] for k in ('mean', 'sd'))
            band = '{:.5g} +- {:.3g}'.format(mean, sd)
        else:
            mean = sd = None
            band = 'none; within {:.0%} of {}'.format(ROOTED_RTOL,
                                                       ROOTED_W2)
        z = None if sd is None else (ours - mean) / sd
        log('  {:<52} {:>11.5g} | {:>8} | {:>8} | {:>16} | {}{}'.format(
            name, ours, cols[0].get(name, '-'), cols[1].get(name, '-'), ref,
            band, '' if z is None else ' (z = {:+.2f})'.format(z)))
        if z is None:
            ok = abs(ours - ROOTED_W2) <= ROOTED_RTOL * ROOTED_W2
        else:
            ok = math.isfinite(ours) and abs(z) <= PARITY_SD
        if not ok:
            out_of_band.append(name)
    if out_of_band:
        raise AssertionError('parity rows outside their bands: {}'.format(
            out_of_band))


def parity_part(vt):
    """Phase 23 (a): the examples behind benchmarks/parity.py at --full,
    float32, each counted alone; returns the summed launches."""
    from viabel_tpu_torch.examples import (eight_schools, funnel,
                                           normal_mixture, robust_regression)
    mains = dict(robust_regression=robust_regression.main,
                 funnel=funnel.main, normal_mixture=normal_mixture.main,
                 eight_schools=eight_schools.main)
    total, outs = {}, {}
    for name, main in mains.items():
        names, runs = EX_PARTS[name]
        outs[name], launches = example_part(
            '23 (a) {} --full'.format(name),
            lambda: main(full=True, device='cuda'), names, runs)
        add_launches(total, launches)
    parity_rows(outs)
    return total


def chivi_records():
    """benchmarks/CHIVI_PROTOCOLS.md's recorded lines, by protocol and
    stage."""
    with open(os.path.join(HERE, 'benchmarks', 'CHIVI_PROTOCOLS.md')) as f:
        text = f.read().split('```')[1]
    records, proto = {}, None
    for line in text.splitlines():
        if line.startswith('== '):
            proto = line.split()[1]
            proto = 'perturbed_klvi' if proto == 'perturbed' else proto
        elif ': mean_err' in line:
            records.setdefault(proto, {})[
                line.split(': mean_err')[0].strip()] = line.strip()
    return records


def check_k1_regression(vt, model, label):
    """K1 against its plain version on the chivi protocol's regression at
    its width: mean-field t(10) draws, n = 1e6, q at the least-squares
    coefficients; lw to 1e-12 (float64) and 2e-5 (float32) relative plus
    the K1 tolerance's atol (for lw near 0), the
    statistics to 1e-12 and the regression rule (float32 moments move by
    twice a few ulps of |lw|, ``REGRESSION_STATS_RTOL`` at |lw| ~ 120,
    scaled with |lw|)."""
    from viabel_tpu_torch.ops import lw_stats as ops

    x, y = model.kernel_data[0], model.kernel_data[1]
    d = x.shape[1]
    fam = vt.mean_field_t_variational_family(d, 10)
    z = fam.base_sample(card_generator(23), EXP_N, torch.float64)
    beta = np.linalg.lstsq(x, y, rcond=None)[0]
    for dtype, lw_rtol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        name = str(dtype).split('.')[1]
        mean = torch.as_tensor(beta, dtype=dtype, device='cuda')
        log_scale = torch.full((d,), math.log(0.05), dtype=dtype,
                               device='cuda')
        args = (z.to(dtype).contiguous(), mean, log_scale, model.kernel,
                model.kernel_data_like(mean), 10.0)
        lw, parts = ops.transform_score_partials(*args)
        lw_p, parts_p = ops.transform_score_partials_plain(*args)
        check_close('K1 regression at d = {} ({}) lw, {}'.format(
            d, label, name), lw, lw_p, TOL[name]['lw_atol'], lw_rtol)
        stats_rtol = 1e-12 if dtype == torch.float64 else \
            REGRESSION_STATS_RTOL[name] * max(
                1.0, float(lw_p.abs().max()) / 120.0)
        check_close('K1 regression at d = {} statistics, {}'.format(
            d, name), ops.combine_partials(parts),
            ops.combine_partials_plain(parts_p), 0, stats_rtol)


def chivi_part(vt):
    """Phase 23 (b): examples/chivi_experiments.py at full widths, each
    protocol and the perturbed stage counted alone, every stage beside its
    recorded line; then K1 at d = 14 and 30 against its plain version.
    Returns the summed launches."""
    from viabel_tpu_torch.examples import chivi_experiments as ce
    from viabel_tpu_torch.models import (data_generator_linear,
                                         robust_regression_model)

    records, total, results = chivi_records(), {}, {}
    for name, args, kw in ce.protocols(full=True,
                                       hmc_samples=EX_HMC_SAMPLES,
                                       device='cuda'):
        runs = [args[5]] + [cfg[3] for cfg in args[4]]
        # HMC's R-hat gate (hmc_ground_truth's r_hat_tol = 1.01) raises
        # inside the run above 1.01
        results[name], launches = example_part(
            '23 (b) {} (N {}, k {})'.format(name, args[1], args[2]),
            lambda: ce.run_protocol(*args, **kw),
            ('transform_score_partials', 'combine_partials',
             'adagrad_step'), runs)
        log('K1 launched at d = {}: {} times'.format(
            args[2], launches['transform_score_partials']))
        add_launches(total, launches)
    results['perturbed_klvi'], launches = example_part(
        '23 (b) perturbed KLVI', lambda: ce.perturbed_klvi(
            full=True, device='cuda'),
        ('transform_score_partials', 'combine_partials', 'adagrad_step'))
    if launches['adagrad_step (replayed)'] != 0:
        raise AssertionError('the perturbed objective samples inside its '
                             'step and must run eagerly')
    add_launches(total, launches)

    log('chivi stages: ours (H100 f32) | recorded (TPU v5e f32, '
        'benchmarks/CHIVI_PROTOCOLS.md)')
    bad = []
    for proto, stages in results.items():
        if 'khat' in stages:
            stages = {'perturbed_klvi': stages}
        for stage, res in stages.items():
            key = 'klvi mf-t(10)' if stage == 'klvi' else stage
            log('  {:<14} {:>26}: mean_err = {:.4f}  khat = {:+.3f}{} | {}'
                .format(proto, key, res['mean_err'], res['khat'],
                        '  param_move_rel = {:.4g}'.format(
                            res['param_move_rel'])
                        if 'param_move_rel' in res else '',
                        records.get(proto, {}).get(key, 'none recorded')))
            well_started = stage == 'klvi' or '+0.1' in stage \
                or '+0.6' in stage
            if well_started and not res['mean_err'] < CHIVI_MEAN_ERR:
                bad.append('{} {}: mean_err {}'.format(proto, stage,
                                                       res['mean_err']))
            if '(bad)' in stage and math.isfinite(res['khat']) and \
                    not math.isnan(res['mean_err']):
                bad.append('{} {}: finite khat and mean_err'.format(
                    proto, stage))
            if 'param_move_rel' in res and \
                    not math.isfinite(res['param_move_rel']):
                bad.append('{} {}: param_move_rel {}'.format(
                    proto, stage, res['param_move_rel']))
    if bad:
        raise AssertionError('chivi stages off their protocol: {}'.format(
            bad))
    for N, k in ((80, 14), (90, 30)):
        data = data_generator_linear(N, k, alpha=1.0, noise_variance=0.25,
                                     rho=0.1, seed=5080)
        model = robust_regression_model(data['X'], data['Y'], df=40.0)
        check_k1_regression(vt, model, 'N = {}'.format(N))
    return total


def finite_leaves(label, value):
    """Every number in a nested result is finite."""
    if isinstance(value, dict):
        for k, v in value.items():
            finite_leaves('{} {}'.format(label, k), v)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            finite_leaves('{} [{}]'.format(label, i), v)
    elif isinstance(value, (int, float, np.floating, np.integer)) and \
            not is_finite(value):
        raise AssertionError('{} is not finite: {}'.format(label, value))


def rest_part(vt):
    """Phase 23 (c): the other examples at full width, depths cut as
    listed; returns the summed launches."""
    from viabel_tpu_torch.examples import (eight_schools_ia,
                                           linear_regression_ia,
                                           multistart_pipeline, pod_layout)
    from viabel_tpu_torch.models import robust_regression_model

    total = {}
    out, launches = example_part(
        '23 (c) multistart_pipeline --full',
        lambda: multistart_pipeline.main(full=True, device='cuda'),
        ('transform_score_partials', 'combine_partials', 'adagrad_step'),
        [5000])
    finite_leaves('multistart khat', out['khat'])
    finite_leaves('multistart best bounds', {
        k: out['bounds'][out['best']][k] for k in ('d2', 'W2', 'mean_error')})
    psis_err = float(np.max(np.abs(
        out['psis_mean'][out['best']].double().cpu().numpy()
        - robust_regression_model().true_mean)))
    log('  best start {}: PSIS-corrected mean off the NUTS truth by {!r} '
        '(limit {})'.format(out['best'], psis_err, EX_MS_MEAN_ATOL))
    if not psis_err <= EX_MS_MEAN_ATOL:
        raise AssertionError('multistart_pipeline: the best start\'s PSIS '
                             'mean is {} off the truth'.format(psis_err))
    add_launches(total, launches)
    out, launches = example_part(
        '23 (c) linear_regression_ia protocol 2 (N 200, k 20, {} of 7000 '
        'iterations)'.format(EX_IA2_ITERS),
        lambda: linear_regression_ia.protocol2(
            full=True, n_iters=EX_IA2_ITERS, device='cuda'),
        ('philox_normal',))
    finite_leaves('protocol 2', out)
    add_launches(total, launches)
    out, launches = example_part(
        '23 (c) eight_schools_ia full rank ({} of 30000 iterations)'.format(
            EX_ESIA_ITERS),
        lambda: eight_schools_ia.run_full_rank(
            full=True, n_iters=EX_ESIA_ITERS, device='cuda'),
        ('philox_normal',))
    finite_leaves('eight_schools_ia full rank', {
        k: out[k] for k in ('raw_mean_err', 'ia_mean_err', 'ia_cov_err',
                            'start_avg_mean_iters', 'start_avg_sigma_iters')})
    finite_leaves('eight_schools_ia R-hat', out['r_hat_mean'].tolist())
    add_launches(total, launches)
    out, launches = example_part(
        '23 (c) pod_layout on the card listed {} times'.format(
            EX_POD_DEVICES),
        lambda: pod_layout.main(['--devices', str(EX_POD_DEVICES)]),
        ('transform_score_partials', 'combine_partials', 'adagrad_step'))
    finite_leaves('pod_layout', out)
    # the HMC chains must meet hmc_ground_truth's R-hat rule, and the
    # multistart's best fit must be closer to p than q at the start (layout
    # 1's pass); the IA chains' R-hat is the example's report at its depth
    if not out['hmc']['r_hat_max'] <= 1.01:
        raise AssertionError('pod_layout: the HMC chains\' R-hat is {}'
                             .format(out['hmc']['r_hat_max']))
    if not out['multistart']['d2'] < out['sharded']['d2']:
        raise AssertionError('pod_layout: the best start\'s d2 {} is not '
                             'below the start\'s {}'.format(
                                 out['multistart']['d2'],
                                 out['sharded']['d2']))
    finite_leaves('pod_layout', out)
    add_launches(total, launches)
    return total


def phase23(vt):
    """Phase 23: the example layer on the card; returns the summed launch
    counts of its parts."""
    t0 = time.perf_counter()
    total = {}
    add_launches(total, parity_part(vt))
    add_launches(total, chivi_part(vt))
    add_launches(total, rest_part(vt))
    part_line('phase 23 in all', time.perf_counter() - t0)
    return total


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
    phases_done('1')

    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    if '--kernels-only' in sys.argv[1:]:
        return kernels_only(vt, model, fam)
    out, launches = main_path(vt, model, fam)
    rows = kernel_checks(model, fam, out['opt_param'])
    small_reference_check(vt, model, fam)
    graph_against_eager(vt, model, fam)
    rows['adagrad_step'] = time_breakdown(vt, model, fam, out['opt_param'])
    phases_done('2-5')

    rmodel, rfam, ia_param, r_launches = regression_path(vt)
    rows.update(regression_kernel_checks(vt, rmodel, rfam, ia_param))
    regression_card_vs_cpu(vt)
    k2_statistics(vt, rmodel, rfam, ia_param)
    phases_done('6-9')

    fits, e_launches = experiment_path(vt)
    experiment_kernel_checks(vt, fits)
    phases_done('10-11')

    # timed before the long traces of phases 13-15, after which the
    # profiler's traces come back without kernel records
    rows['adagrad_step']['instances'] = batched_step_check(vt)
    phases_done('12')
    path_launches = [launches, r_launches, e_launches, multistart_path(vt)]
    phases_done('13')
    path_launches += [sweep_path(vt), large_d_path(vt)]
    phases_done('14-15 (a)')
    path_launches.append(large_d_full_path(vt))
    phases_done('15 (b)')
    batched_card_vs_cpu(vt)
    phases_done('16')
    path_launches.append(cli_path(vt))
    phases_done('17')
    path_launches.extend(new_phases(vt))
    path_launches.append(phase22(vt, model, fam))
    phases_done('22')
    path_launches.append(phase23(vt))
    phases_done('23')

    kernels = [dict(name=name, route='cuda',
                    source='viabel_tpu_torch/csrc/' + SOURCE[name],
                    replaces=REPLACES[name],
                    launches=sum(p[name] for p in path_launches),
                    max_abs_err=rows[name]['max_abs_err'],
                    ms=rows[name]['ms'], device_ms=rows[name]['device_ms'],
                    plain_ms=rows[name]['plain_ms'],
                    bound_ms=rows[name]['bound_ms'],
                    bound_by=rows[name]['bound_by'],
                    library_ms=rows[name]['library_ms'],
                    **({'instances': rows[name]['instances']}
                       if 'instances' in rows[name] else {}))
               for name in REPLACES]
    log(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        workers = {'--rank-worker': rank_worker,
                   '--cards-worker': cards_worker}
        if sys.argv[1:2] and sys.argv[1] in workers:
            code = workers[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4], sys.argv[5])
        elif sys.argv[1:2] == ['--fresh-worker']:
            code = fresh_worker(sys.argv[2], sys.argv[3])
        elif sys.argv[1:] == ['--mesh-cards']:
            code = mesh_cards()
        else:
            code = main()
    except Exception:  # report any phase's failure and exit non-zero
        import traceback
        traceback.print_exc()
        print('chip_smoke: FAIL', file=sys.stderr)
        code = 1
    sys.exit(code)
