"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: float64 holds the kernels' logic with rounding out of the way
(lw and statistics to 1e-10 relative); float32 uses the retired TPU
kernels' test tolerances, lw atol 2e-4 and statistics rtol 2e-5, plus an
lw rtol of 2e-6 (a few float32 ulps) for the log-weights of magnitude
above 100 that a heavy-tailed q produces.  The CUDA and PyTorch math
libraries round exp/log/log1p differently in the last bits, and sums run
in another order.
"""
import numpy as np
import pytest
import torch

from viabel_tpu_torch.families import mean_field_t_variational_family
from viabel_tpu_torch.models import eight_schools_cp_model
from viabel_tpu_torch.ops import _build
from viabel_tpu_torch.ops import lw_stats as ops

pytestmark = pytest.mark.cuda

TOL = {torch.float64: dict(lw_atol=1e-10, lw_rtol=1e-10, rtol=1e-10),
       torch.float32: dict(lw_atol=2e-4, lw_rtol=2e-6, rtol=2e-5)}


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    _build.build_all()
    return torch.device('cuda')


def _inputs(n, dtype, device, seed=0, df=40.0):
    """Base draws z and a q near the posterior (its ground-truth mean and
    marginal scales)."""
    model = eight_schools_cp_model()
    fam = mean_field_t_variational_family(model.dim, df)
    g = torch.Generator(device=device).manual_seed(seed)
    z = fam.base_sample(g, n, dtype)
    mean = torch.as_tensor(model.true_mean, dtype=dtype, device=device)
    log_scale = torch.as_tensor(0.5 * np.log(np.diag(model.true_cov)),
                                dtype=dtype, device=device)
    return model, z, mean, log_scale


def _assert_stats_close(got, want, rtol):
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 2048 * 3 + 17, 200_003])
@pytest.mark.parametrize('df', [40.0, None])
def test_transform_score_partials_matches_plain(cuda, dtype, n, df):
    model, z, mean, log_scale = _inputs(n, dtype, cuda)
    if df is None:  # the Gaussian family's standard normal base
        z = torch.randn(z.shape, dtype=dtype, device=cuda)
    before = ops.launches['transform_score_partials']
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    assert ops.launches['transform_score_partials'] == before + 1
    lw_p, parts_p = ops.transform_score_partials_plain(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=tol['lw_rtol'])
    assert parts.shape == parts_p.shape == (-(-n // ops.CHUNK), 6)
    np.testing.assert_array_equal(parts[:, 0].cpu().numpy(),
                                  parts_p[:, 0].cpu().numpy())
    stats = ops.combine_partials(parts)
    _assert_stats_close(stats, ops.combine_partials_plain(parts_p),
                        tol['rtol'])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [5, 2048, 2048 * 7 + 1, 1_000_003])
def test_lw_partials_and_combine_match_plain(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    lw = 3.0 * torch.randn(n, generator=g, dtype=dtype, device=cuda) - 50.0
    parts = ops.lw_partials(lw)
    parts_p = ops.lw_partials_plain(lw)
    torch.cuda.synchronize()
    rtol = TOL[dtype]['rtol']
    got, want = parts.cpu().double().numpy(), parts_p.cpu().double().numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # count, max
    np.testing.assert_allclose(got[:, [2, 4]], want[:, [2, 4]], rtol=rtol)
    np.testing.assert_allclose(got[:, [3, 5]], want[:, [3, 5]],
                               rtol=100 * rtol, atol=1e-30)
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p), rtol)
    _assert_stats_close(ops.lw_stats(lw), ops.lw_stats(lw.cpu()), rtol)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_combine_underflowing_chunks_stay_finite(cuda, dtype):
    """Chunks whose max lies ~1e4 below the global max rescale by an
    r_b that underflows to 0: the statistics stay finite and equal those
    of the plain version."""
    n = 2048 * 40 + 333
    g = torch.Generator(device=cuda).manual_seed(1)
    lw = torch.randn(n, generator=g, dtype=dtype, device=cuda)
    lw[2048 * 5:2048 * 30] -= 1e4
    stats = ops.lw_stats(lw)
    assert torch.isfinite(stats).all()
    _assert_stats_close(stats, ops.lw_stats(lw.cpu()), TOL[dtype]['rtol'])


def test_wrappers_reject_bad_inputs(cuda):
    lw = torch.zeros(100, device=cuda)
    with pytest.raises(TypeError):
        ops.lw_partials(lw.to(torch.float16))
    with pytest.raises(ValueError):
        ops.lw_partials(torch.zeros(100, 2, device=cuda)[:, 0])
    model, z, mean, log_scale = _inputs(64, torch.float32, cuda)
    with pytest.raises(TypeError):
        ops.transform_score_partials(z, mean.double(), log_scale,
                                     model.kernel, model.kernel_data, 40.0)
    with pytest.raises(ValueError):
        ops.transform_score_partials(z, mean.cpu(), log_scale,
                                     model.kernel, model.kernel_data, 40.0)
