"""The port's posterior service (viabel_tpu_torch/serve.py) on the CPU:
its endpoints, schema and status codes (those of tests/test_cli_serve.py
for the JAX service), its results against the JAX package's service and
the port's own bound pass, its limits and its concurrency, and the served
parameter read from checkpoints the JAX package's writers wrote.
"""
import json
import math
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu as vt
import viabel_tpu_torch as pt
from viabel_tpu import serve as jserve
from viabel_tpu.models import funnel_model as j_funnel_model
from viabel_tpu_torch import serve
from viabel_tpu_torch.bounds import all_bounds, family_moment_bounds
from viabel_tpu_torch.config import ExperimentConfig, build
from viabel_tpu_torch.experiments import _split
from viabel_tpu_torch.models import funnel_model
from viabel_tpu_torch.ops.philox import philox_seed
from viabel_tpu_torch.psis import psislw

VP = [0.0, 0.0, -0.4, -0.4]
SMALL_FIT = dict(n_iters=50, n_mc_samples=20, n_bound_samples=1000)


def _make_service(**kwargs):
    return serve.PosteriorService(
        funnel_model(), pt.mean_field_gaussian_variational_family(2),
        torch.tensor(VP, dtype=torch.float64), device='cpu', **kwargs)


class _Server:
    """`start_server` on port 0, shut down and closed on exit."""

    def __init__(self, service):
        self.httpd, self.thread = serve.start_server(service, port=0)
        self.base = 'http://127.0.0.1:{}'.format(self.httpd.server_address[1])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def get(self, path):
        return json.loads(urllib.request.urlopen(self.base + path).read())

    def post(self, path, body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data,
            headers={'Content-Type': 'application/json'})
        return json.loads(urllib.request.urlopen(req).read())

    def status(self, path, body=None):
        try:
            if body is None:
                urllib.request.urlopen(self.base + path)
            else:
                self.post(path, body)
        except urllib.error.HTTPError as e:
            return e.code
        return 200


def test_posterior_service_endpoints():
    """tests/test_cli_serve.py:147-236 on the port's service: the direct
    API, every endpoint's schema, the fit's swap, and the 400 and 404
    answers."""
    service = _make_service()
    s = service.sample(100)
    assert s.shape == (100, 2)
    m = service.moments()
    np.testing.assert_allclose(m['mean'], [0.0, 0.0], atol=1e-12)
    assert np.isfinite(service.log_prob([[0.0, 0.0]])).all()
    b = service.bounds(20000)
    assert {'W1', 'W2', 'mean_error', 'std_error', 'cov_error', 'd2',
            'log_norm_bound', 'khat'} == set(b)

    with _Server(service) as srv:
        health = srv.get('/health')
        assert health == dict(status='ok', model='funnel',
                              family='mf_gaussian', dim=2)
        assert np.asarray(srv.get('/sample?n=5')['samples']).shape == (5, 2)
        mom = srv.get('/moments')
        assert len(mom['mean']) == 2 and np.asarray(mom['cov']).shape == \
            (2, 2)
        lp = srv.post('/log_prob', {'x': [[0.0, 0.0], [0.5, -1.0]]})
        assert np.isfinite(lp['log_prob']).all() and len(lp['log_prob']) == 2
        assert set(srv.get('/bounds?n=5000')) == set(b)
        fit = srv.post('/fit', {'n_iters': 500, 'n_mc_samples': 50,
                                'n_bound_samples': 20000})
        assert {'bounds', 'khat', 'mean', 'final_loss'} == set(fit)
        assert np.isfinite(fit['bounds']['d2'])
        # the served posterior now reflects the new fit
        assert not np.allclose(service.moments()['cov'], m['cov'])
        np.testing.assert_allclose(service.moments()['mean'], fit['mean'])
        for bad_body in (json.dumps({'bogus': 1}),
                         json.dumps({'n_bound_samples': 0}),
                         json.dumps({'n_iters': 1000,
                                     'n_mc_samples': 1000000}),
                         json.dumps({'learning_rate': 0.01,
                                     'learning_rate_end': 0.5}),
                         '"abc"', '[1, 2]'):
            assert srv.status('/fit', bad_body.encode()) == 400, bad_body
        for bad_url in ('/sample?n=0', '/sample?n=-3', '/bounds?n=1',
                        '/bounds?n=-1', '/sample?n=abc', '/bounds?n=1e6'):
            assert srv.status(bad_url) == 400, bad_url
        for payload in (b'{}', b'{"x": ["not", "numbers"]}', b'{bad json',
                        b'{"x": [[0.0, 0.0, 1.0]]}'):
            assert srv.status('/log_prob', payload) == 400, payload
        assert srv.status('/nope') == 404
        assert srv.status('/nope', b'{}') == 404


def test_moments_and_log_prob_match_jax_service():
    """`/moments` and `/log_prob` (float32 input) against the JAX
    package's service on the same parameter, rtol 1e-6."""
    x = np.random.RandomState(0).randn(37, 2)
    for family in ('mean_field_gaussian_variational_family',
                   'mean_field_t_variational_family'):
        args = (2,) if 'gaussian' in family else (2, 5.0)
        jsvc = jserve.PosteriorService(
            j_funnel_model(), getattr(vt, family)(*args),
            jnp.asarray(VP, dtype=jnp.float64))
        tsvc = serve.PosteriorService(
            funnel_model(), getattr(pt, family)(*args),
            torch.tensor(VP, dtype=torch.float64), device='cpu')
        for key in ('mean', 'cov'):
            np.testing.assert_allclose(tsvc.moments()[key],
                                       jsvc.moments()[key], rtol=1e-6)
        np.testing.assert_allclose(tsvc.log_prob(x), jsvc.log_prob(x),
                                   rtol=1e-6)
        np.testing.assert_allclose(tsvc.log_prob(x.astype(np.float32)),
                                   jsvc.log_prob(x), rtol=1e-6)


@pytest.mark.parametrize('df', [None, 3.0])
def test_bounds_match_all_bounds_on_the_same_generator(df):
    """`/bounds` rounds n up to a power of two and equals the port's
    `all_bounds` and `psislw` on the draws of the request's generator
    (the first seed the service's generator gives), rtol 1e-9; a t family
    with df <= 4 falls back to the samples' empirical moments."""
    fam = (pt.mean_field_gaussian_variational_family(2) if df is None
           else pt.mean_field_t_variational_family(2, df))
    model = funnel_model()
    vp = torch.tensor(VP, dtype=torch.float64)
    service = serve.PosteriorService(model, fam, vp, seed=7, device='cpu')
    got = service.bounds(3000)
    seed = philox_seed(torch.Generator().manual_seed(7))
    z = fam.base_sample(torch.Generator().manual_seed(seed), 4096,
                        torch.float64)
    samples = fam.transform(vp, z)
    lw = model.log_prob(samples) - fam.log_prob(vp, samples)
    mb = family_moment_bounds(fam, vp)
    assert (mb is None) == (df is not None)
    want = all_bounds(lw, samples=samples if mb is None else None,
                      q_var=fam.mean_and_cov(vp)[1].numpy(),
                      moment_bound_fn=mb)
    want['khat'] = float(psislw(lw)[1])
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=1e-9), key


def test_fit_limits_and_no_config_cap():
    """The size checks of tests/test_cli_serve.py:239-262; the cap on
    distinct fit configurations is not ported (it bounded XLA's executable
    cache), so nine distinct configurations are all served."""
    service = _make_service(max_fit_iters=1000, max_bound_samples=50000)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.fit(n_iters=2000)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.fit(n_iters=10, n_bound_samples=10 ** 10)
    with pytest.raises(ValueError, match='n_starts \\* n_bound_samples'):
        service.fit(n_iters=10, n_bound_samples=20000, n_starts=3)
    with pytest.raises(ValueError, match='n_starts \\* n_iters'):
        service.fit(n_iters=1000, n_mc_samples=100000, n_bound_samples=1000)
    with pytest.raises(ValueError, match='must all be positive'):
        service.fit(n_starts=0)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.sample(50001)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.log_prob(np.zeros((50001, 2)))
    assert service.sample(37).shape == (37, 2)
    assert service.log_prob(np.zeros((600, 2))).shape == (600,)
    for n_iters in range(20, 29):
        out = service.fit(n_iters=n_iters, n_mc_samples=10,
                          n_bound_samples=500)
        assert np.isfinite(out['bounds']['d2'])


def test_fit_multistart_swaps_in_the_best_start():
    service = _make_service()
    out = service.fit(n_iters=300, n_mc_samples=20, n_bound_samples=4000,
                      n_starts=4, perturb_scale=0.1)
    assert out['n_starts'] == 4 and 0 <= out['best'] < 4
    assert np.isfinite(out['bounds']['d2'])
    np.testing.assert_allclose(service.moments()['mean'], out['mean'])


def test_fit_busy_rejected_not_queued():
    """A concurrent /fit gets ServiceBusyError, HTTP 503; once the running
    fit is done the same request succeeds."""
    service = _make_service()
    assert service._fit_lock.acquire(blocking=False)
    try:
        with pytest.raises(serve.ServiceBusyError, match='already running'):
            service.fit(**SMALL_FIT)
        with _Server(service) as srv:
            assert srv.status('/fit', SMALL_FIT) == 503
    finally:
        service._fit_lock.release()
    assert np.isfinite(service.fit(**SMALL_FIT)['bounds']['d2'])


def test_reads_during_a_fit_and_the_fit_unchanged():
    """Readers calling /sample in a loop during a /fit all succeed, and the
    fit's result equals the same fit on a service of the same seed with no
    readers (the readers take their seeds after the fit took its)."""
    fit_kw = dict(n_iters=400, n_mc_samples=50, n_bound_samples=20000)
    quiet = _make_service(seed=3).fit(**fit_kw)
    service = _make_service(seed=3)
    start = service._seeds.get_state()
    results, errors = {}, []
    with _Server(service) as srv:
        fitter = threading.Thread(
            target=lambda: results.update(fit=srv.post('/fit', fit_kw)))
        fitter.start()
        while torch.equal(service._seeds.get_state(), start):
            assert fitter.is_alive()  # the fit has not drawn its seed yet
        reads = 0
        while fitter.is_alive():
            try:
                assert len(srv.get('/sample?n=50')['samples']) == 50
                reads += 1
            except Exception as e:  # noqa: BLE001 -- counted below
                errors.append(e)
        fitter.join(timeout=60)
        assert not fitter.is_alive()
    assert not errors and reads > 0
    assert results['fit']['bounds'] == quiet['bounds']
    assert results['fit']['khat'] == quiet['khat']


def test_request_seeds_are_never_lost_under_contention():
    """Many threads (more than cores) drawing request generators with a
    tiny switch interval: the service's generator advances exactly once a
    request, so no two requests share a seed."""
    service = _make_service()
    seeds, n_threads, per_thread = [], 32, 20
    lock = threading.Lock()

    def work():
        for _ in range(per_thread):
            s = service._generator().initial_seed()
            with lock:
                seeds.append(s)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(seeds) == n_threads * per_thread == len(set(seeds))
    ref = torch.Generator().manual_seed(0)
    for _ in range(n_threads * per_thread):
        philox_seed(ref)
    assert torch.equal(service._seeds.get_state(), ref.get_state())


def test_serve_json_sanitizes_nonfinite():
    obj = dict(bounds=dict(W2=math.inf, d2=0.5, mean_error=-math.inf),
               khat=math.nan, xs=[1.0, math.inf], t=(math.nan, 2.0))
    back = json.loads(json.dumps(serve._null_nonfinite(obj),
                                 allow_nan=False))
    assert back == dict(bounds=dict(W2=None, d2=0.5, mean_error=None),
                        khat=None, xs=[1.0, None], t=[None, 2.0])


def test_nonfinite_fit_results_reach_the_client_as_null():
    service = _make_service()
    service.bounds = lambda n: dict(d2=math.inf, khat=math.nan, W2=1.0)
    with _Server(service) as srv:
        assert srv.get('/bounds?n=10') == dict(d2=None, khat=None, W2=1.0)


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
    """Checkpoints of the four kinds, written by the JAX package's
    writers (tests/test_cli_serve.py:290-372)."""
    from viabel_tpu.checkpoint import (adagrad_optimize_resumable,
                                       save_checkpoint)
    tmp = tmp_path_factory.mktemp('jax_checkpoints')
    fam = vt.mean_field_gaussian_variational_family(2)
    obj = vt.black_box_klvi(fam, j_funnel_model().log_prob, 10)
    init = fam.init_param()
    paths = {k: str(tmp / (k + '.npz'))
             for k in ('chains', 'history', 'tail', 'partial', 'raw')}
    vt.rmsprop_IA_optimize_with_rhat(
        60, obj, init, 2, n_optimisers=2, rhat_window=20, tail_avg_iters=20,
        checkpoint_path=paths['chains'], save_every=30)
    adagrad_optimize_resumable(40, obj, init,
                               checkpoint_path=paths['history'],
                               save_every=20)
    adagrad_optimize_resumable(40, obj, init, checkpoint_path=paths['tail'],
                               save_every=20, return_history=False)
    save_checkpoint(paths['partial'], dict(
        i=np.asarray(10), key=np.zeros(2, np.uint32),
        param=np.full(4, 7.0), grads=np.zeros((10, 4)),
        log_norms=np.zeros(10), values=np.zeros(40), lns=np.zeros(40),
        tail_sum=np.zeros(4)))
    np.savez(paths['raw'], w=np.asarray(init) + 0.25)
    return paths


@pytest.mark.parametrize('kind', ['chains', 'history', 'tail', 'partial',
                                  'raw'])
def test_param_from_checkpoint_of_jax_writers(jax_checkpoints, kind):
    """The served parameter from each kind of checkpoint the JAX package
    writes (its three formats, a format-less legacy file and a bare
    vector) equals the JAX service's, 1e-12."""
    path = jax_checkpoints[kind]
    got = serve._param_from_checkpoint(path)
    want = np.asarray(jserve._param_from_checkpoint(path))
    assert got.shape == want.shape == (4,)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_fit_from_config_honours_the_optimizer():
    """tests/test_cli_serve.py:502: the served fit is the command line's
    fit of the same config (`config.fit`): the IA optimizer when the
    config names it, and adagrad on the first of the three generators
    split from the config's seed."""
    cfg = ExperimentConfig(model='funnel', family='mean_field_gaussian',
                           optimizer='rmsprop_ia', n_chains=2, n_iters=300,
                           n_mc=10)
    vp = serve._fit_from_config(cfg, *build(cfg), device='cpu')
    assert vp.shape == (4,) and torch.all(torch.isfinite(vp))
    cfg2 = ExperimentConfig(model='funnel', family='mean_field_gaussian',
                            n_iters=80, n_mc=10)
    model2, family2, objective2 = build(cfg2)
    vp2 = serve._fit_from_config(cfg2, model2, family2, objective2,
                                 device='cpu')
    opt_gen = _split(torch.Generator().manual_seed(cfg2.seed), 3)[0]
    ref = pt.adagrad_optimize(80, objective2, family2.init_param(),
                              generator=opt_gen,
                              learning_rate=cfg2.learning_rate,
                              device='cpu')[0]
    torch.testing.assert_close(vp2, ref, rtol=0, atol=0)


def test_main_builds_the_service(tmp_path, jax_checkpoints, monkeypatch):
    """``main`` from a config, with ``--param`` (a JAX package checkpoint)
    and without (a fit), on the CPU; `serve` is replaced by a recorder."""
    served = []
    monkeypatch.setattr(serve, 'serve',
                        lambda service, port, host: served.append(
                            (service, port, host)))
    cfg = ExperimentConfig(model='funnel', family='mean_field_gaussian',
                           n_iters=50, n_mc=10, seed=2)
    path = tmp_path / 'cfg.json'
    path.write_text(cfg.to_json())
    serve.main(['--config', str(path), '--param',
                jax_checkpoints['history'], '--port', '0', '--device',
                'cpu'])
    serve.main(['--config', str(path), '--device', 'cpu', '--host',
                '0.0.0.0'])
    (with_param, port, _), (fitted, _, host) = served
    np.testing.assert_allclose(
        with_param.var_param.numpy(),
        np.asarray(jserve._param_from_checkpoint(jax_checkpoints['history'])),
        rtol=1e-12)
    assert port == 0 and host == '0.0.0.0'
    torch.testing.assert_close(fitted.var_param, serve._fit_from_config(
        cfg, *build(cfg), device='cpu'))
    assert fitted.device == torch.device('cpu')
