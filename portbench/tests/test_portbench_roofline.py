"""Operation and byte counts against counts worked by hand, and the
per-layer readers on a context built by hand."""
import os

import pytest

from portbench.roofline import counts, peaks
from portbench.run import Context, load_module
from portbench.trace import Record, Trace

H100 = 'NVIDIA H100 80GB HBM3'


def test_adagrad_step_bytes():
    # P = 45450, window 10: read 4 (13 P + 13) + 8 = 2363460, written
    # 4 (3 P + 3) + 8 = 545420; a history row adds 4 P = 181800 (the
    # kernel table's 3.09 MB)
    assert counts.adagrad_step_bytes(1, 45450, 10) == 2908880
    assert counts.adagrad_step_bytes(1, 45450, 10, history=True) == 3090680
    assert counts.adagrad_step_bytes(8, 20, 10) == 8 * (
        4 * (20 * 13 + 13) + 8 + 4 * (3 * 20 + 3) + 8)


def test_k1_bytes():
    # 2.5e6 x 10 draws in (1e8 B), 2.5e6 log-weights out (1e7 B), 1221
    # partial rows of 6 (29304 B), mean, log-scales and 16 staged values
    assert counts.k1_bytes(2500000, 10, 16) == 110029448
    assert counts.k1_bytes(2500000, 10, 16) / 3.35e12 == pytest.approx(
        3.2844e-5, rel=1e-4)


def test_fit_flops():
    # an iteration: 800 (2 * 300 * 301 + 4 * 1200 * 300) = 1.29648e9;
    # the bound pass: 1e6 (2 * 300 * 301 + 2 * 1200 * 300) = 9.006e11
    f = counts.full_rank_regression_fit_flops(1200, 300, 800, 40000, 10 ** 6)
    assert f == 40000 * 1296480000 + 900600000000
    assert counts.validation_pass_flops(2500000, 10) == 6e8
    assert counts.param_count({'dim': 300, 'family': 'full_rank_gaussian'}) \
        == 45450
    assert counts.param_count({'dim': 10, 'family': 'mean_field_t'}) == 20


def test_peaks():
    assert peaks.peak(H100, 'bytes_per_s') == 3.35e12
    assert peaks.peak(H100, 'f32_flops') == 67e12
    assert peaks.peak('some other card', 'f32_flops') is None


def _reader(name):
    return load_module('metrics', name + '.py').read


def _ctx(recs, **kw):
    cfg = dict(dim=300, family='full_rank_gaussian',
               model='linear_regression', n_rows=1200, n_mc=800,
               n_iters=40000, n_bound_samples=10 ** 6, window=10,
               schools=8)
    cfg.update(kw.pop('cfg', {}))
    return Context(trace=Trace(recs), cfg=cfg, kind=H100, **kw)


def test_readers():
    us = 1000
    recs = [Record('slice', 'user_annotation', 0, 1000 * us)]
    recs += [Record('void adagrad_step_kernel<float>()', 'kernel',
                    i * 100 * us, i * 100 * us + 8 * us) for i in range(10)]
    ctx = _ctx(recs, iters=5, e2e=dict(fit_s=8.0))
    assert _reader('kernels_per_iter.fit')(ctx) == 2.0
    assert _reader('device_idle_share.fit')(ctx) == pytest.approx(92.0)
    assert _reader('adagrad_step_roofline.fit')(ctx) == pytest.approx(
        100 * 2908880 / 3.35e12 / 8e-6)
    flops = counts.full_rank_regression_fit_flops(1200, 300, 800, 40000,
                                                  10 ** 6)
    assert _reader('fit_mfu')(ctx) == pytest.approx(
        100 * flops / (8.0 * 67e12))
    # nothing to read: None, never 0
    empty = _ctx([Record('slice', 'user_annotation', 0, 1000)], iters=5,
                 e2e=dict(fit_s=8.0))
    assert _reader('adagrad_step_roofline.fit')(empty) is None
    assert _reader('kernels_per_iter.fit')(empty) is None
    assert _reader('k1_roofline.validate')(empty) is None
    assert _reader('draw_ms.validate')(empty) is None
    assert _reader('psis_ms.validate')(empty) is None


def test_every_reader_loads():
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'metrics')
    for f in os.listdir(here):
        if f.endswith('.py'):
            assert callable(load_module('metrics', f).read)
