"""The port's plots (`experiments.plot_approx_and_exact_contours`,
`plot_history`, `plot_dist_to_opt_param`) run headless as
tests/test_plots.py runs the JAX package's, and draw what the JAX
package's draw: the contour grids and the plotted lines are captured from
both packages on the same inputs and compared at float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')  # headless; plt.show() draws nothing

import matplotlib.pyplot as plt  # noqa: E402

import viabel_tpu as vt  # noqa: E402
import viabel_tpu_torch as pt  # noqa: E402
from viabel_tpu import experiments as jexp  # noqa: E402
from viabel_tpu.models import funnel_model as jfunnel  # noqa: E402
from viabel_tpu_torch import experiments as texp  # noqa: E402
from viabel_tpu_torch.models import funnel_model as tfunnel  # noqa: E402

pytestmark = pytest.mark.filterwarnings('ignore::UserWarning')


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close('all')


def _lines(draw):
    """The y data of every line `draw()` puts on new axes."""
    before = set(plt.get_fignums())
    draw()
    figs = [plt.figure(n) for n in plt.get_fignums() if n not in before]
    return [line.get_ydata() for f in figs for ax in f.axes
            for line in ax.lines]


def test_plot_history_and_dist_to_opt_param_match_jax():
    hist = np.exp(-np.linspace(0, 5, 400)) + 1.0
    traj = np.cumsum(np.ones((300, 4)) * 0.01, axis=0)
    cases = [
        lambda m: m.plot_history(hist),
        lambda m: m.plot_history(hist, B=25, ylabel='-ELBO'),
        lambda m: m.plot_history(hist - 1.05),  # crosses zero: linear
        lambda m: m.plot_dist_to_opt_param(traj, traj[-1]),
    ]
    for draw in cases:
        want = _lines(lambda: draw(jexp))
        got = _lines(lambda: draw(texp))
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    # tensors are plotted as their host values
    got = _lines(lambda: texp.plot_history(torch.as_tensor(hist)))
    np.testing.assert_allclose(got[0], _lines(
        lambda: jexp.plot_history(hist))[0], rtol=1e-12)
    assert plt.gca().get_yscale() == 'log'


def _contour_grids(monkeypatch, draw):
    grids = []
    real = plt.contour

    def record(X, Y, Z, **kw):
        grids.append((np.asarray(X), np.asarray(Y), np.asarray(Z)))
        return real(X, Y, Z, **kw)

    monkeypatch.setattr(plt, 'contour', record)
    draw()
    monkeypatch.setattr(plt, 'contour', real)
    return grids


@pytest.mark.parametrize('aux', [False, True])
def test_plot_contours_match_jax(monkeypatch, tmp_path, aux):
    """The funnel's density and q's on the 100 x 100 grid, with and
    without `aux_var` (appended to the parameter), the figure saved."""
    vp = np.array([0.3, -0.5, 0.2, -0.1])
    kw = dict(xlim=(-4, 4), ylim=(-3, 2))
    if aux:
        args, kw['aux_var'] = vp[:3], vp[3]
    else:
        args = vp
        kw['savepath'] = str(tmp_path / 'c.png')
    want = _contour_grids(
        monkeypatch, lambda: jexp.plot_approx_and_exact_contours(
            jfunnel().log_prob, vt.mean_field_gaussian_variational_family(2),
            jnp.asarray(args), **kw))
    got = _contour_grids(
        monkeypatch, lambda: texp.plot_approx_and_exact_contours(
            tfunnel(), pt.mean_field_gaussian_variational_family(2),
            torch.as_tensor(args), **kw))
    assert len(got) == len(want) == 2
    for (gx, gy, gz), (wx, wy, wz) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_allclose(gz, wz, rtol=1e-10, atol=1e-300)
    if not aux:
        assert (tmp_path / 'c.png').exists()


def test_format_seconds():
    """tests/test_plots.py's check, on the port's `utils`."""
    from viabel_tpu_torch.utils import format_seconds
    assert format_seconds(2.5).endswith('sec')
    assert 'milli' in format_seconds(0.005)
    assert 'micro' in format_seconds(2e-6)
