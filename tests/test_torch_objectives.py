"""The port's KLVI against viabel_tpu.objectives on shared draws, float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu.models import eight_schools_cp_model as jcp
from viabel_tpu_torch import interop
from viabel_tpu_torch.models import eight_schools_cp_model as tcp


@pytest.mark.parametrize('family', ['mf_t', 'mf_gaussian'])
def test_klvi_value_and_grad_on_shared_draws(family):
    make = {'mf_t': lambda m: m.mean_field_t_variational_family(10, 40),
            'mf_gaussian':
                lambda m: m.mean_field_gaussian_variational_family(10)}[family]
    jf, tf = make(vt), make(pt)
    jm, tm = jcp(), tcp()
    jobj = vt.black_box_klvi(jf, jm.log_prob, 50, presampled=True)
    tobj = pt.black_box_klvi(tf, tm, 50, presampled=True)
    vp = np.random.default_rng(0).normal(0, 0.3, 20)
    draws = jobj.make_draws(jax.random.PRNGKey(2), 3, jnp.float64)
    for i in range(3):
        jv, jg = jobj(jnp.asarray(vp), draws[i])
        tv, tg = tobj(interop.var_param(vp),
                      interop.presampled_draws(draws)[i])
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                                   atol=1e-12)
    assert tobj.presampled and not tobj.has_log_norm


def test_make_draws_block_and_key_mix_up():
    fam = pt.mean_field_t_variational_family(10, 40)
    obj = pt.black_box_klvi(fam, tcp(), 7, presampled=True)
    d = obj.make_draws(torch.Generator().manual_seed(0), 4, torch.float64)
    assert d.shape == (4, 7, 10) and d.dtype == torch.float64
    with pytest.raises(TypeError):  # a generator where draws belong
        obj(torch.zeros(20, dtype=torch.float64), torch.Generator())


def test_unpresampled_objective_draws_from_generator():
    """Without presampling the objective samples itself: the same
    generator state gives the value of the presampled objective fed the
    same base draws."""
    fam = pt.mean_field_gaussian_variational_family(10)
    model = tcp()
    vp = torch.full((20,), 0.1, dtype=torch.float64)
    live = pt.black_box_klvi(fam, model, 30)
    pre = pt.black_box_klvi(fam, model, 30, presampled=True)
    v1, g1 = live(vp, torch.Generator().manual_seed(5))
    z = fam.base_sample(torch.Generator().manual_seed(5), 30, torch.float64)
    v2, g2 = pre(vp, z)
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    assert not vp.requires_grad  # the caller's parameter is untouched


def test_make_draws_range_reads_the_generator_as_a_key():
    """Row i is the same whatever range draws it and the generator is not
    advanced: the Gaussian family's rows are Philox rows of the initial
    seed; other families draw from a fresh generator of it, from 0 only."""
    from viabel_tpu_torch.ops.philox import philox_normal_plain
    gauss = pt.black_box_klvi(pt.mean_field_gaussian_variational_family(3),
                              tcp(), 4, presampled=True)
    g = torch.Generator().manual_seed(9)
    block = gauss.make_draws_range(g, 0, 6, torch.float64)
    assert block.shape == (6, 4, 3)
    assert torch.equal(gauss.make_draws_range(g, 2, 3, torch.float64),
                       block[2:5])
    np.testing.assert_array_equal(
        block.reshape(-1, 3).numpy(),
        philox_normal_plain(24, 3, 9, dtype=torch.float64).numpy())
    t_obj = pt.black_box_klvi(pt.mean_field_t_variational_family(3, 40),
                              tcp(), 4, presampled=True)
    want = t_obj.make_draws(torch.Generator().manual_seed(9), 5,
                            torch.float64)
    assert torch.equal(t_obj.make_draws_range(g, 0, 5, torch.float64), want)
    with pytest.raises(NotImplementedError):
        t_obj.make_draws_range(g, 1, 5, torch.float64)
