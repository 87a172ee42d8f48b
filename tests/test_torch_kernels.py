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
from viabel_tpu_torch.ops import _build, _launch
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
    before = _launch.launches['transform_score_partials']
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    assert _launch.launches['transform_score_partials'] == before + 1
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
    before = _launch.launches['gaussian_sample_score_partials']
    lw, parts = gops.gaussian_sample_score_partials(
        mean, log_std, n, seed, offset, model.kernel, model.kernel_data)
    assert _launch.launches['gaussian_sample_score_partials'] == before + 1
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
    before = _launch.launches['transform_score_partials']
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, df)
    assert _launch.launches['transform_score_partials'] == before + 1
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


# --------------------------------------------------------------------------
# the redesigned K1 and philox_normal: instances, tiles and alignment
# --------------------------------------------------------------------------

# more chunks than the card holds blocks at once (132 SMs x 8 blocks at
# most), so that every block strides on to a second chunk
N_ABOVE_RESIDENT = 132 * 8 * 2048 + 2048 * 5 + 301


def _off_alignment(z):
    """A contiguous copy of z whose address is 8 bytes off a multiple of
    16: a slice of a larger tensor."""
    off = 8 // z.element_size()
    buf = torch.empty(z.numel() + off, dtype=z.dtype, device=z.device)
    out = buf[off:].view(z.shape)
    out.copy_(z)
    assert out.data_ptr() % 16 == 8 and out.is_contiguous()
    return out


def _model_at(name, dtype, device):
    """(model, mean, log_scale, lw rtol, statistics rtol) for the d = 2
    instance (funnel, robust regression), the runtime-d one (a d = 3
    regression) and the staged d = 10 one (eight-schools CP)."""
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model)
    tol = TOL[dtype]
    if name == 'funnel':
        model, mean, log_scale = _ncp_or_funnel('funnel', dtype, device)
        return model, mean, log_scale, FUNNEL_LW_RTOL[dtype], tol['rtol']
    if name == 'cp':
        model, _, mean, log_scale = _inputs(1, dtype, device)
        return model, mean, log_scale, tol['lw_rtol'], tol['rtol']
    if name == 'robust':
        model = _regression(True)
    else:
        data = data_generator_linear(N=40, D=3, seed=7)
        model = linear_regression_model(data['X'], data['Y'])
    return (model,) + _fit(model, dtype, device) + (
        tol['lw_rtol'], REGRESSION_STATS_RTOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('n', [1, 2047, 2048 * 3 + 17, N_ABOVE_RESIDENT])
@pytest.mark.parametrize('name', ['funnel', 'robust', 'linear_d3', 'cp'])
def test_transform_score_partials_instances_and_alignment(cuda, dtype,
                                                          aligned, n, name):
    model, mean, log_scale, lw_rtol, stats_rtol = _model_at(name, dtype, cuda)
    fam = mean_field_t_variational_family(model.dim, 40.0)
    z = fam.base_sample(torch.Generator(device=cuda).manual_seed(n), n, dtype)
    if not aligned:
        z = _off_alignment(z)
    lw, parts = ops.transform_score_partials(
        z, mean, log_scale, model.kernel, model.kernel_data, 40.0)
    lw_p, parts_p = ops.transform_score_partials_plain(
        z, mean, log_scale, model.kernel, model.kernel_data, 40.0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=TOL[dtype]['lw_atol'], rtol=lw_rtol)
    np.testing.assert_array_equal(parts[:, 0].cpu().numpy(),
                                  parts_p[:, 0].cpu().numpy())
    _assert_stats_close(ops.combine_partials(parts),
                        ops.combine_partials_plain(parts_p), stats_rtol)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_score_chunks_with_nan_and_underflow(cuda, dtype):
    """A NaN among the draws reaches its chunk's max and the statistics,
    and a chunk whose weights all underflow against the global max stays
    finite, as with the plain version.  z[:, 1] = -12 puts the chunk's lw
    near -1e15, the lowest at which float32 still holds the squared
    deviations; the next test goes beyond."""
    model, _, mean, log_scale = _inputs(1, dtype, cuda)
    n = 2048 * 6
    z = torch.randn((n, model.dim), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    z[2048 * 2: 2048 * 3, 1] = -12.0    # tau tiny: lw far below the rest
    args = (mean, log_scale, model.kernel, model.kernel_data, None)
    lw, parts = ops.transform_score_partials(z, *args)
    lw_p, parts_p = ops.transform_score_partials_plain(z, *args)
    stats = ops.combine_partials(parts)
    assert torch.isfinite(parts).all() and torch.isfinite(stats).all()
    _assert_stats_close(stats, ops.combine_partials_plain(parts_p),
                        TOL[dtype]['rtol'])
    z[2048 * 4 + 5, 3] = float('nan')
    _, parts = ops.transform_score_partials(z, *args)
    assert torch.isnan(parts[4, 1:]).all() and parts[4, 0] == 2048
    assert torch.isfinite(parts[[0, 1, 2, 3, 5]]).all()
    assert torch.isnan(ops.combine_partials(parts)).any()


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_score_chunk_beyond_float32_range_matches_plain(cuda, dtype):
    """At z[:, 1] = -30 tau is ~1e-14 and the chunk's lw ~ -1e31: the
    squared deviations of lw leave float32's range.  The kernel's partials
    are then non-finite exactly where the plain version's are, the rest
    agree, and in float64 everything is finite."""
    model, _, mean, log_scale = _inputs(1, dtype, cuda)
    n = 2048 * 6
    z = torch.randn((n, model.dim), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    z[2048 * 2: 2048 * 3, 1] = -30.0
    args = (mean, log_scale, model.kernel, model.kernel_data, None)
    lw, parts = ops.transform_score_partials(z, *args)
    lw_p, parts_p = ops.transform_score_partials_plain(z, *args)
    tol = TOL[dtype]
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=tol['lw_rtol'])
    got, want = parts.cpu().double().numpy(), parts_p.cpu().double().numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert finite[:, [0, 1, 2, 4]].all()    # count, max and the means
    assert finite.all() == (dtype == torch.float64)
    np.testing.assert_allclose(got[:, [1, 2, 4]], want[:, [1, 2, 4]],
                               rtol=tol['rtol'])
    np.testing.assert_allclose(got[finite], want[finite],
                               rtol=100 * tol['rtol'], atol=1e-30)
    stats = ops.combine_partials(parts).cpu().double().numpy()
    stats_p = ops.combine_partials_plain(parts_p).cpu().double().numpy()
    np.testing.assert_array_equal(np.isfinite(stats), np.isfinite(stats_p))
    ok = np.isfinite(stats_p)
    np.testing.assert_allclose(stats[ok], stats_p[ok], rtol=tol['rtol'])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('start', [1, 2 ** 32 - 12345])
@pytest.mark.parametrize('n,d', [(100_003, 1), (50_001, 2), (33_335, 3),
                                 (25_001, 4), (20_001, 5), (100_001, 10),
                                 (9_091, 11), (803, 131), (5, 5001)])
def test_philox_normal_tiles_match_plain(cuda, dtype, start, n, d):
    """Every row width class: one group with a dropped pair (d = 1, 2),
    whole groups (4), a short last group (3, 5, 10, 11), tiles that start
    off 16-byte alignment (131) and rows cut into column segments (5001),
    with an odd n d and a start that is odd or crosses 2^32."""
    from viabel_tpu_torch.ops import gaussian_lw as gops
    from viabel_tpu_torch.ops.philox import philox_normal_plain
    before = _launch.launches['philox_normal']
    z = gops.philox_normal(n, d, 99, 3, start, dtype, cuda)
    assert _launch.launches['philox_normal'] == before + 1
    z_p = philox_normal_plain(n, d, 99, 3, start, dtype, cuda)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2e-6  # last-bit log/sincos
    np.testing.assert_allclose(z.cpu().numpy(), z_p.cpu().numpy(), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------
# the statistics of a bound pass: K1 or K3, then combine_rows in one block
# --------------------------------------------------------------------------

RAGGED_N = 300_007
# more chunks than K3's grid (the blocks the card holds at once, 792 or
# fewer), so that its blocks walk several chunks each
N_ABOVE_K3_GRID = 4096 * 2048 + 2048 * 3 + 5


def _lw(n, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return 3.0 * torch.randn(n, generator=g, dtype=dtype, device=device) - 50.0


def _plain_stats(lw):
    return ops.combine_partials_plain(ops.lw_partials_plain(lw))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, ops.CHUNK - 1, ops.CHUNK, ops.CHUNK + 1,
                               RAGGED_N, 2_500_000, N_ABOVE_K3_GRID])
def test_lw_stats_match_plain(cuda, dtype, n):
    lw = _lw(n, dtype, cuda, seed=n)
    before = dict(_launch.launches)
    stats = ops.lw_stats(lw)
    assert _launch.launches['lw_partials'] == before['lw_partials'] + 1
    assert _launch.launches['combine_partials'] == before['combine_partials'] + 1
    _assert_stats_close(stats, _plain_stats(lw), TOL[dtype]['rtol'])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, ops.CHUNK - 1, ops.CHUNK, ops.CHUNK + 1,
                               RAGGED_N, 2_500_000, N_ABOVE_RESIDENT])
def test_transform_score_stats_match_plain(cuda, dtype, n):
    model, z, mean, log_scale = _inputs(n, dtype, cuda, seed=n)
    args = (z, mean, log_scale, model.kernel, model.kernel_data, 40.0)
    before = dict(_launch.launches)
    lw, stats = ops.transform_score_stats(*args)
    assert _launch.launches['transform_score_partials'] == \
        before['transform_score_partials'] + 1
    assert _launch.launches['combine_partials'] == before['combine_partials'] + 1
    lw_p, parts_p = ops.transform_score_partials_plain(*args)
    tol = TOL[dtype]
    np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                               atol=tol['lw_atol'], rtol=tol['lw_rtol'])
    _assert_stats_close(stats, ops.combine_partials_plain(parts_p),
                        tol['rtol'])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_stats_with_nan_and_underflow(cuda, dtype):
    """A chunk whose weights underflow against the global max leaves finite
    statistics equal to the plain version's; a NaN in one chunk reaches
    them, after K3 and after K1 alike."""
    n = 2048 * 40 + 333
    lw = _lw(n, dtype, cuda, seed=1)
    lw[2048 * 5:2048 * 30] -= 1e4
    stats = ops.lw_stats(lw)
    assert torch.isfinite(stats).all()
    _assert_stats_close(stats, _plain_stats(lw), TOL[dtype]['rtol'])
    lw[2048 * 33 + 7] = float('nan')
    assert torch.isnan(ops.lw_stats(lw)).all()
    model, _, mean, log_scale = _inputs(1, dtype, cuda)
    z = torch.randn((2048 * 6, model.dim), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    z[2048 * 2: 2048 * 3, 1] = -12.0    # lw near -1e15: weights underflow
    args = (mean, log_scale, model.kernel, model.kernel_data, None)
    _, stats = ops.transform_score_stats(z, *args)
    _, parts_p = ops.transform_score_partials_plain(z, *args)
    assert torch.isfinite(stats).all()
    _assert_stats_close(stats, ops.combine_partials_plain(parts_p),
                        TOL[dtype]['rtol'])
    z[2048 * 4 + 5, 3] = float('nan')
    assert torch.isnan(ops.transform_score_stats(z, *args)[1]).all()


# --------------------------------------------------------------------------
# the regression density on padded rows
# --------------------------------------------------------------------------

def _limit_rows(d):
    """The most rows of a D = d regression that still carry the kernel tag
    (its float64 padded rows fill the staged shared memory)."""
    from viabel_tpu_torch.ops import limits
    n_rows = 1
    while limits.fits(d, (n_rows + 1) * limits.regression_row(d, 8), 8):
        n_rows += 1
    return n_rows


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
# d = 14 and 30: the chivi protocols' widths (examples/chivi_experiments.py)
@pytest.mark.parametrize('d', [2, 3, 10, 14, 30])
@pytest.mark.parametrize('n_rows', [1, 25, 100, 'limit'])
@pytest.mark.parametrize('robust', [False, True])
def test_regression_rows_in_k1_and_k2_match_plain(cuda, dtype, d, n_rows,
                                                  robust):
    from viabel_tpu_torch.models import (data_generator_linear,
                                         linear_regression_model,
                                         robust_regression_model)
    from viabel_tpu_torch.ops import gaussian_lw as gops
    n_rows = _limit_rows(d) if n_rows == 'limit' else n_rows
    data = data_generator_linear(N=n_rows, D=d, seed=n_rows)
    model = (robust_regression_model(data['X'], data['Y'], df=5.0)
             if robust else linear_regression_model(data['X'], data['Y']))
    assert model.kernel == 'regression'
    beta = np.linalg.lstsq(data['X'], data['Y'], rcond=None)[0]
    mean = torch.as_tensor(beta, dtype=dtype, device=cuda)
    log_scale = torch.full((d,), -3.0, dtype=dtype, device=cuda)
    n = 2048 * 3 + 17
    tol = TOL[dtype]
    k2_args = (mean, log_scale, n, 12345, 3, model.kernel, model.kernel_data)
    z = torch.randn((n, d), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(d))
    k1_args = (z, mean, log_scale, model.kernel, model.kernel_data, 40.0)
    for kernel, plain, args in (
            (gops.gaussian_sample_score_partials,
             gops.gaussian_sample_score_partials_plain, k2_args),
            (ops.transform_score_partials, ops.transform_score_partials_plain,
             k1_args)):
        lw, parts = kernel(*args)
        lw_p, parts_p = plain(*args)
        torch.cuda.synchronize()
        # the kernel sums the N rows' terms in order, the plain version
        # pairwise: in float32 they part by ~sqrt(N) ulps of the sum, so
        # lw_rtol, held at the paths' N <= 100, scales by sqrt(N / 100)
        # (the staging limit is 3056 rows at d = 2)
        lw_rtol = tol['lw_rtol'] * max(1.0, (n_rows / 100.0) ** 0.5)
        np.testing.assert_allclose(lw.cpu().numpy(), lw_p.cpu().numpy(),
                                   atol=tol['lw_atol'], rtol=lw_rtol)
        # REGRESSION_STATS_RTOL holds the rescaled moments at |lw| ~ 120,
        # where they move by alpha times a difference of a few ulps in the
        # max; at the staging limit (3056 rows at d = 2) |lw| reaches
        # ~1200, ten times the ulp, so the same rule scales with |lw|
        scale = max(1.0, float(lw_p.abs().max()) / 120.0)
        _assert_stats_close(ops.combine_partials(parts),
                            ops.combine_partials_plain(parts_p),
                            REGRESSION_STATS_RTOL[dtype] * scale)


# --------------------------------------------------------------------------
# K3's routes: 16-byte words, a ragged last chunk, a misaligned lw
# --------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('route', ['aligned', 'ragged', 'misaligned'])
@pytest.mark.parametrize('n', [2048 * 5, RAGGED_N, 2_500_000])
def test_lw_partials_routes_match_plain(cuda, dtype, route, n):
    """K3 reads whole chunks of an aligned lw as 16-byte words and the
    rest value by value; every route gives the plain version's rows (counts
    and maxima exactly) and statistics."""
    lw = _lw(n + (17 if route == 'ragged' else 0), dtype, cuda, seed=7)
    if route == 'misaligned':  # one value off a multiple of 16 bytes
        buf = torch.empty(lw.shape[0] + 1, dtype=dtype, device=cuda)
        buf[1:] = lw
        lw = buf[1:]
        assert lw.data_ptr() % 16 != 0
    parts = ops.lw_partials(lw)
    parts_p = ops.lw_partials_plain(lw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(parts[:, :2].cpu().numpy(),
                                  parts_p[:, :2].cpu().numpy())
    _assert_stats_close(ops.combine_partials_plain(parts),
                        ops.combine_partials_plain(parts_p),
                        TOL[dtype]['rtol'])


# --------------------------------------------------------------------------
# infinite log-weights: the reference's statistics (jnp.mean, jnp.std)
# --------------------------------------------------------------------------

INF_CASES = {'-inf first': ([0], '-'), '-inf last': ([-1], '-'),
             '-inf at a chunk edge': ([2047, 2048], '-'),
             '-inf filling a chunk': (slice(2048, 4096), '-'),
             '+inf': ([5000], '+'), 'both': ([7, 9000], '+-')}
INF_MEAN_LW = {'-': -np.inf, '+': np.inf, '+-': np.nan}


def _with_infinities(lw, case):
    where, sign = INF_CASES[case]
    lw = lw.clone()
    if sign == '+-':
        lw[where[0]], lw[where[1]] = -np.inf, np.inf
    else:
        lw[where] = np.inf if sign == '+' else -np.inf
    return lw


def _assert_same_stats(got, want, rtol):
    """NaN and inf in the same fields, the finite ones to `rtol`."""
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', list(INF_CASES))
def test_infinite_log_weights_in_k3_and_the_combine(cuda, dtype, case):
    """K3 + the combine, and the combine of the plain partials, equal the
    plain statistics with an infinite log-weight, and give mean_lw as IEEE
    arithmetic does and std_lw NaN."""
    lw = _with_infinities(_lw(RAGGED_N, dtype, cuda, seed=3), case)
    want = _plain_stats(lw.cpu())
    for got in (ops.lw_stats(lw),
                ops.combine_partials(ops.lw_partials_plain(lw))):
        _assert_same_stats(got, want, TOL[dtype]['rtol'])
        mean_lw, std_lw = float(got[3]), float(got[4])
        np.testing.assert_array_equal(mean_lw, INF_MEAN_LW[INF_CASES[case][1]])
        assert np.isnan(std_lw)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', ['-inf first', '-inf last',
                                  '-inf at a chunk edge',
                                  '-inf filling a chunk'])
def test_infinite_log_weights_from_k1(cuda, dtype, case):
    """K1 with the funnel density scores -inf where sigma = exp(log_sigma)
    is so small that (mu / sigma)^2 overflows (log_sigma = -80 in float32,
    -700 in float64, mu = 1): lw and the statistics equal the plain
    version's, mean_lw -inf and std_lw NaN."""
    model = _ncp_or_funnel('funnel', dtype, cuda)[0]
    n = RAGGED_N
    g = torch.Generator(device=cuda).manual_seed(5)
    z = torch.randn((n, 2), generator=g, dtype=dtype, device=cuda)
    where = INF_CASES[case][0]
    z[where, 0] = 1.0
    z[where, 1] = -80.0 if dtype == torch.float32 else -700.0
    zero = torch.zeros(2, dtype=dtype, device=cuda)
    args = (z, zero, zero, model.kernel, model.kernel_data, None)
    lw, stats = ops.transform_score_stats(*args)
    lw_p, parts_p = ops.transform_score_partials_plain(*args)
    assert torch.isneginf(lw_p[where]).all()
    np.testing.assert_array_equal(torch.isneginf(lw).cpu().numpy(),
                                  torch.isneginf(lw_p).cpu().numpy())
    _assert_same_stats(stats, ops.combine_partials_plain(parts_p),
                       TOL[dtype]['rtol'])
    assert float(stats[3]) == -np.inf and np.isnan(float(stats[4]))
