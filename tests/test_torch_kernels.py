"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: float64 holds the kernels' logic with rounding out of the way
(lw and statistics to 1e-10 relative); float32 uses the retired TPU
kernels' test tolerances, lw atol 2e-4 and statistics rtol 2e-5, plus an
lw rtol of 2e-6 (a few float32 ulps) for the log-weights of magnitude
above 100 that a heavy-tailed q produces.  The CUDA and PyTorch math
libraries round exp/log/log1p/sincos differently in the last bits, and
sums run in another order.  The regression density's float32 statistics
get rtol 1e-4: its log-weights sit near -120, where a float32 ulp is
7.6e-6, and the rescaled moments ``exp(lw - max)^alpha`` move by alpha
times any difference in the max (a 1.5e-5 difference in the max moved
them 2.5e-5 on the card).  The funnel's float32 log-weights get lw rtol
3e-5: lw is about -z^2 / 2 with z = mu / exp(log_sigma), so an error e in
log_sigma moves lw by 2 e |lw|, and log_sigma = mean + scale * t (up to
|20| at the wide q tested here, a float32 ulp of 1.9e-6) is rounded once
by the kernel's FMA and twice by PyTorch, from scales that expf and
torch.exp may round apart (2.05e-6 relative seen on the card).
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
REGRESSION_STATS_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FUNNEL_LW_RTOL = {torch.float64: 1e-10, torch.float32: 3e-5}


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


# --------------------------------------------------------------------------
# the regression density, K2 and the Philox stream
# --------------------------------------------------------------------------

def _regression(robust):
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model,
                                         robust_regression_model)
    if robust:
        return robust_regression_model()
    data = data_generator_linear(N=100, D=10, seed=42)
    return linear_regression_model(data['X'], data['Y'])


def _fit(model, dtype, device, widen=1.5):
    mean = torch.as_tensor(model.true_mean, dtype=dtype, device=device)
    log_scale = torch.as_tensor(0.5 * np.log(widen * np.diag(model.true_cov)),
                                dtype=dtype, device=device)
    return mean, log_scale


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 2048 * 3 + 17, 200_003])
@pytest.mark.parametrize('robust,df', [(False, None), (True, 40.0)])
def test_transform_score_partials_regression_matches_plain(cuda, dtype, n,
                                                           robust, df):
    model = _regression(robust)
    mean, log_scale = _fit(model, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    z = torch.randn((n, model.dim), generator=g, dtype=dtype, device=cuda)
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    lw_p, parts_p = ops.transform_score_partials_plain(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=tol['lw_rtol'])
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p),
                        REGRESSION_STATS_RTOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 2048 * 3 + 17, 200_003])
@pytest.mark.parametrize('model_name', ['linear', 'robust', 'eight_schools'])
def test_gaussian_sample_score_partials_matches_plain(cuda, dtype, n,
                                                      model_name):
    from viabel_tpu_torch.ops import gaussian_lw as gops
    model = (eight_schools_cp_model() if model_name == 'eight_schools'
             else _regression(model_name == 'robust'))
    mean, log_std = _fit(model, dtype, cuda, widen=1.0)
    seed, offset = 2 ** 63 + n, 7
    before = gops.launches['gaussian_sample_score_partials']
    lw, parts = gops.gaussian_sample_score_partials(
        mean, log_std, n, seed, offset, model.kernel, model.kernel_data)
    assert gops.launches['gaussian_sample_score_partials'] == before + 1
    lw_p, parts_p = gops.gaussian_sample_score_partials_plain(
        mean, log_std, n, seed, offset, model.kernel, model.kernel_data)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=tol['lw_rtol'])
    rtol = (tol['rtol'] if model_name == 'eight_schools'
            else REGRESSION_STATS_RTOL[dtype])
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p), rtol)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n,d,start', [(1, 1, 0), (1000, 10, 2 ** 32 - 500),
                                       (300_001, 13, 7)])
def test_philox_normal_matches_plain(cuda, dtype, n, d, start):
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops.philox import philox_normal_plain
    z = gops.philox_normal(n, d, 99, 3, start, dtype, cuda)
    z_p = philox_normal_plain(n, d, 99, 3, start, dtype, cuda)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2e-6  # last-bit log/sincos
    np.testing.assert_allclose(z.cpu().numpy(), z_p.cpu().numpy(), rtol=tol,
                               atol=tol)


def test_philox_bits_known_answers_and_plain(cuda):
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops.philox import philox4x32
    kat = [((0, 0, 0, 0), 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xFFFFFFFF,) * 4, 2 ** 64 - 1,
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            0x299f31d0a4093822,
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for counter, seed, want in kat:
        got = gops.philox_bits(torch.tensor([counter], device=cuda), seed)
        assert tuple(got[0].tolist()) == want
    c = torch.randint(0, 2 ** 32, (100_000, 4), dtype=torch.int64,
                      device=cuda)
    seed = 0xDEADBEEF12345678
    plain = torch.stack(philox4x32(c.unbind(1), (seed & 0xFFFFFFFF,
                                                 seed >> 32)), dim=1)
    assert torch.equal(gops.philox_bits(c, seed), plain)


# --------------------------------------------------------------------------
# the non-centred eight-schools and funnel densities in K1 and K2
# --------------------------------------------------------------------------

def _ncp_or_funnel(name, dtype, device):
    """The model and a q its run_experiment bound pass meets: the NCP's
    ground-truth moments, or the funnel's start ``[0, -1]`` with unit
    log-scales (log-weights down to -1e6 and below)."""
    from viabel_tpu_torch.models import eight_schools_ncp_model, funnel_model
    if name == 'ncp':
        model = eight_schools_ncp_model()
        return (model,) + _fit(model, dtype, device, widen=1.0)
    return (funnel_model(), torch.tensor([0.0, -1.0], dtype=dtype,
                                         device=device),
            torch.ones(2, dtype=dtype, device=device))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 2048 * 3 + 17, 200_003])
@pytest.mark.parametrize('name,df', [('ncp', 40.0), ('ncp', None),
                                     ('funnel', 40.0), ('funnel', None)])
def test_transform_score_partials_ncp_and_funnel_match_plain(cuda, dtype, n,
                                                             name, df):
    model, mean, log_scale = _ncp_or_funnel(name, dtype, cuda)
    fam = mean_field_t_variational_family(model.dim, 40.0)
    g = torch.Generator(device=cuda).manual_seed(n)
    z = (fam.base_sample(g, n, dtype) if df is not None else
         torch.randn((n, model.dim), generator=g, dtype=dtype, device=cuda))
    before = ops.launches['transform_score_partials']
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    assert ops.launches['transform_score_partials'] == before + 1
    lw_p, parts_p = ops.transform_score_partials_plain(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    lw_rtol = FUNNEL_LW_RTOL[dtype] if name == 'funnel' else tol['lw_rtol']
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=lw_rtol)
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p), tol['rtol'])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 2048 * 3 + 17, 200_003])
@pytest.mark.parametrize('name', ['ncp', 'funnel'])
def test_gaussian_sample_score_partials_ncp_and_funnel_match_plain(
        cuda, dtype, n, name):
    from viabel_tpu_torch.ops import gaussian_lw as gops
    model, mean, log_std = _ncp_or_funnel(name, dtype, cuda)
    seed, offset = 2 ** 62 + n, 11
    lw, parts = gops.gaussian_sample_score_partials(
        mean, log_std, n, seed, offset, model.kernel, model.kernel_data)
    lw_p, parts_p = gops.gaussian_sample_score_partials_plain(
        mean, log_std, n, seed, offset, model.kernel, model.kernel_data)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    lw_rtol = FUNNEL_LW_RTOL[dtype] if name == 'funnel' else tol['lw_rtol']
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=lw_rtol)
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p), tol['rtol'])
