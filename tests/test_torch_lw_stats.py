"""The plain versions of the log-weight kernels, on the CPU.

K1's plain version is held to the live JAX composition that the TPU kernel
used to replace, ``model.log_prob(family.transform(p, z)) -
family.log_prob(p, x)`` (viabel_tpu/pipeline.py:155-156), at float64; the
wrappers' dispatch and input checks run here too.  The CUDA kernels
themselves are held to these plain versions on the card
(tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
from viabel_tpu.bounds import _log_weight_stats_arrays
from viabel_tpu.models import eight_schools_cp_model as jcp
from viabel_tpu_torch import interop
from viabel_tpu_torch.bounds import STAT_KEYS
from viabel_tpu_torch.models import eight_schools_cp_model as tcp
from viabel_tpu_torch.ops import lw_stats as ops


@pytest.mark.parametrize('family', ['mf_t', 'mf_gaussian'])
def test_transform_score_plain_matches_live_composition(family):
    jf = (vt.mean_field_t_variational_family(10, 40) if family == 'mf_t'
          else vt.mean_field_gaussian_variational_family(10))
    jm, tm = jcp(), tcp()
    n = ops.CHUNK * 5 + 77
    z = jf.base_sample(jax.random.PRNGKey(0), n, jnp.float64)
    vp = np.concatenate([jm.true_mean, 0.5 * np.log(np.diag(jm.true_cov))])
    x = jf.transform(jnp.asarray(vp), z)
    want = np.asarray(jm.log_prob(x) - jf.log_prob(jnp.asarray(vp), x))
    tz, tvp = interop.base_draws(z), interop.var_param(vp)
    df = 40.0 if family == 'mf_t' else None
    lw, parts = ops.transform_score_partials(
        tz, tvp[:10], tvp[10:], tm.kernel, tm.kernel_data, df)
    np.testing.assert_allclose(lw.numpy(), want, rtol=1e-12, atol=1e-12)
    assert parts.shape == (6, 6)
    stats = ops.combine_partials(parts).numpy()
    ref = _log_weight_stats_arrays(jnp.asarray(want), 2.0)
    np.testing.assert_allclose(stats, [float(ref[k]) for k in STAT_KEYS],
                               rtol=1e-11)
    lw2, stats2 = ops.transform_score_stats(
        tz, tvp[:10], tvp[10:], tm.kernel, tm.kernel_data, df)
    assert torch.equal(lw, lw2) and torch.equal(stats2, ops.combine_partials(
        parts))


def test_float32_plain_k1_within_kernel_tolerance():
    """The f32 plain version stays within the stated kernel tolerance
    (lw atol 2e-4 + rtol 2e-6) of the f64 composition."""
    tm = tcp()
    fam = vt.mean_field_t_variational_family(10, 40)
    z = np.asarray(fam.base_sample(jax.random.PRNGKey(1), 20000,
                                   jnp.float64))
    vp = np.concatenate([tm.true_mean, 0.5 * np.log(np.diag(tm.true_cov))])
    out = {}
    for dtype in (torch.float32, torch.float64):
        tz, tvp = (interop.base_draws(z, dtype=dtype),
                   interop.var_param(vp, dtype=dtype))
        out[dtype] = ops.transform_score_partials(
            tz, tvp[:10], tvp[10:], tm.kernel, tm.kernel_data, 40.0)[0]
    np.testing.assert_allclose(out[torch.float32].double().numpy(),
                               out[torch.float64].numpy(), atol=2e-4,
                               rtol=2e-6)


def test_underflowing_and_ragged_partials_combine_finite():
    rng = np.random.default_rng(4)
    lw = rng.normal(size=ops.CHUNK * 9 + 5)
    lw[:ops.CHUNK * 4] -= 1e5          # r_b = exp(-1e5)^2 = 0 exactly
    for dtype in (torch.float32, torch.float64):
        stats = ops.lw_stats(torch.as_tensor(lw, dtype=dtype))
        assert torch.isfinite(stats).all()
    ref = _log_weight_stats_arrays(jnp.asarray(lw), 2.0)
    np.testing.assert_allclose(
        ops.lw_stats(torch.as_tensor(lw)).numpy(),
        [float(ref[k]) for k in STAT_KEYS], rtol=1e-12)


def test_nan_propagates_like_jnp():
    lw = np.random.default_rng(5).normal(size=5000)
    lw[4100] = np.nan
    stats = ops.lw_stats(torch.as_tensor(lw)).numpy()
    ref = _log_weight_stats_arrays(jnp.asarray(lw), 2.0)
    np.testing.assert_array_equal(np.isnan(stats),
                                  [np.isnan(float(ref[k]))
                                   for k in STAT_KEYS])
    assert np.isnan(stats).all()


def test_wrappers_check_inputs_and_count_only_launches():
    tm = tcp()
    z = torch.zeros(100, 10, dtype=torch.float64)
    mean = torch.zeros(10, dtype=torch.float64)
    before = dict(ops.launches)
    ops.transform_score_partials(z, mean, mean, tm.kernel, tm.kernel_data)
    ops.lw_stats(torch.zeros(10, dtype=torch.float64))
    assert ops.launches == before  # the plain versions launch nothing
    with pytest.raises(TypeError):
        ops.lw_partials(torch.zeros(10, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.lw_partials(torch.zeros(10, 2, dtype=torch.float64)[:, 0])
    with pytest.raises(ValueError):
        ops.lw_partials(torch.zeros(0, dtype=torch.float64))
    with pytest.raises(ValueError):  # d must be the kernel density's 10
        ops.transform_score_partials(z[:, :9].contiguous(), mean[:9],
                                     mean[:9], tm.kernel, tm.kernel_data)
    with pytest.raises(TypeError):
        ops.transform_score_partials(z, mean.float(), mean, tm.kernel,
                                     tm.kernel_data)
    with pytest.raises(ValueError):
        ops.transform_score_partials(z, mean, mean, 'no_such_density',
                                     tm.kernel_data)
    with pytest.raises(ValueError):  # the density unrolls 8 schools
        ops.transform_score_partials(z, mean, mean, tm.kernel,
                                     (torch.zeros(5), torch.zeros(5)))
    with pytest.raises(ValueError):
        ops.combine_partials(torch.zeros(3, 5, dtype=torch.float64))
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}
