"""Posterior serving: an HTTP service over a fitted variational posterior.

PyTorch port of viabel_tpu/serve.py.  It loads a fitted variational
parameter (fitted from an `ExperimentConfig` through `config.fit`, or read
from a checkpoint of either package) and serves

* ``GET /health``            — liveness + model/family metadata
* ``GET /moments``           — posterior mean and covariance (JSON)
* ``GET /sample?n=K``        — K posterior draws (JSON array)
* ``POST /log_prob``         — log q(x) for a JSON batch of points (cast to
  float32, as the JAX service casts them)
* ``GET /bounds?n=K``        — validated error bounds + PSIS khat from K
  fresh Monte Carlo log-weights (K rounded up to a power of two): the
  family's draws scored by the fused kernel K1 where the model has a CUDA
  log density, else by the plain composition (`experiments.draw_and_score`),
  and the bounds taken from the log-weights by `bounds.all_bounds` (K3 and
  the combine), as the command line takes them
* ``POST /fit``              — re-fit server-side with `validated_vi` (or
  `validated_vi_multistart` for ``n_starts > 1``), warm-starting from the
  served parameter; swaps in the new fit and returns its validated bounds
  and khat

on the stdlib ``http.server``.  The endpoints, the response schema (every
numeric field is ``number | null``, null exactly when the value is
non-finite) and the status codes (400, 404, 500, 503 for a concurrent fit)
are the JAX service's.  Not ported: the power-of-two buckets of
``/sample`` and ``/log_prob`` and the cap on distinct ``/fit``
configurations, which bound XLA's cache of compiled executables (the port
compiles no program per size, and a fit's CUDA graphs are freed with it);
the mesh placement of ``/fit`` and the sharded ``/bounds``, which wait for
the port of ``parallel/``.

Threads: the server runs each request on its own thread.  A ``/fit``
captures CUDA graphs, and a capture in PyTorch's default mode fails if
another thread allocates or synchronizes on the card meanwhile, so the
readers (``/sample``, ``/log_prob``, ``/bounds``) do their device work
under `_device.between_captures`, which holds off a capture; a capture
(`_device.capture`) takes the same lock only from its begin to its end,
so a read waits at most one capture, never a fit.  The readers run on a
stream of their own, so their work does not queue behind the fit's on the
card.  Start with::

    python -m viabel_tpu_torch.serve --config cfg.json --param ckpt.npz
    python -m viabel_tpu_torch.serve --config cfg.json --device cpu
"""
import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ._device import between_captures, resolve_device
from .ops.philox import philox_seed

__all__ = ['PosteriorService', 'ServiceBusyError', 'serve', 'start_server']


class ServiceBusyError(RuntimeError):
    """A `/fit` is already running; the request was rejected, not queued
    (mapped to HTTP 503 by the handler).  Re-fits hold the device for
    seconds to minutes, so silently serializing concurrent fits behind a
    lock would stall every later request with no backpressure signal."""


class PosteriorService:
    """Query layer over (model, family, var_param) on `device` (None: the
    CUDA card).

    Every size is bounded: ``/sample`` and ``/log_prob`` by
    `max_bound_samples`, ``/bounds`` rounds its count up to a power of two
    and clamps it to `max_bound_samples`, and ``/fit`` checks `n_iters`
    against `max_fit_iters`, ``n_starts * n_bound_samples`` against
    `max_bound_samples`, and ``n_starts * n_iters * n_mc_samples`` (the
    presampled draws it materializes) against `max_fit_evals`.

    Randomness: each request takes one seed from the service's generator
    (seeded with `seed`) under a lock, and draws from a generator of its
    own seeded with it, so concurrent requests never share a generator.
    """

    def __init__(self, model, family, var_param, seed=0,
                 max_fit_iters=200000, max_bound_samples=4000000,
                 max_fit_evals=20000000, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.family = family
        self.var_param = torch.as_tensor(var_param, device=self.device)
        self.max_fit_iters = int(max_fit_iters)
        self.max_bound_samples = int(max_bound_samples)
        self.max_fit_evals = int(max_fit_evals)
        self._seeds = torch.Generator().manual_seed(seed)
        self._lock = threading.Lock()
        self._fit_lock = threading.Lock()  # held for a /fit's full duration
        self._reads = (torch.cuda.Stream(self.device)
                       if self.device.type == 'cuda' else None)
        mean, cov = family.mean_and_cov(self.var_param)
        self.mean = mean.cpu().numpy()
        self.cov = cov.cpu().numpy()

    def _generator(self):
        """A generator of its own for one request, seeded from the
        service's generator under the lock."""
        with self._lock:
            seed = philox_seed(self._seeds)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _snapshot(self):
        """Consistent (var_param, mean, cov) triple.  `/fit` swaps all
        three under the lock, so readers must take them together — reading
        the fields piecemeal during a concurrent fit would mix posteriors
        (e.g. bounds drawn from the old parameter but scaled by the new
        covariance)."""
        with self._lock:
            return self.var_param, self.mean, self.cov

    @contextlib.contextmanager
    def _reading(self):
        """A reader's device work, from its generator to its last copy to
        the host: on the card between captures (see the module
        docstring) and on the readers' stream."""
        if self._reads is None:
            yield
            return
        with between_captures(), torch.cuda.stream(self._reads):
            yield

    @staticmethod
    def _bucket(n):
        """Round a requested count up to the next power of two (the JAX
        service's rule for `/bounds`, whose estimates it changes)."""
        return 1 << max(int(n) - 1, 0).bit_length()

    def sample(self, n):
        n = int(n)
        if n > self.max_bound_samples:
            raise ValueError('n = {} exceeds the service limit {}'.format(
                n, self.max_bound_samples))
        var_param, _, _ = self._snapshot()
        with self._reading():
            return self.family.sample(self._generator(), var_param,
                                      n).cpu().numpy()

    def moments(self):
        _, mean, cov = self._snapshot()
        return dict(mean=mean.tolist(), cov=cov.tolist())

    def log_prob(self, x):
        x = np.atleast_2d(np.asarray(x, dtype=np.float32))
        n = x.shape[0]
        if n > self.max_bound_samples:
            raise ValueError('batch of {} points exceeds the service limit '
                             '{}'.format(n, self.max_bound_samples))
        if x.ndim != 2 or x.shape[1] != self.model.dim:
            raise ValueError('x must be a list of points of dimension {}, '
                             'got shape {}'.format(self.model.dim, x.shape))
        var_param, _, _ = self._snapshot()
        with self._reading():
            points = torch.as_tensor(x).to(self.device, var_param.dtype)
            return self.family.log_prob(var_param, points).cpu().numpy()

    def bounds(self, n):
        from .bounds import all_bounds, family_moment_bounds
        from .experiments import draw_and_score
        from .psis import psislw
        var_param, _, cov = self._snapshot()
        # rounding the MC size up to a power of two only tightens the
        # estimates, and keeps the JAX service's results for a given n
        n = min(self._bucket(n), self.max_bound_samples)
        with self._reading():
            z = self.family.base_sample(self._generator(), n,
                                        var_param.dtype)
            samples, lw, _ = draw_and_score(self.model, self.family,
                                            var_param, z)
            # None for families without a finite closed-form 4th moment
            # (t with df <= 4): empirical central moments of the samples
            mb = family_moment_bounds(self.family, var_param)
            res = all_bounds(lw, samples=samples if mb is None else None,
                             q_var=cov, moment_bound_fn=mb)
            res['khat'] = psislw(lw)[1]
            return {k: float(v) for k, v in res.items()}

    def fit(self, n_iters=2000, n_mc_samples=100, n_bound_samples=100000,
            learning_rate=0.01, learning_rate_end=None, n_starts=1,
            perturb_scale=0.5):
        """Re-fit with the validated pipeline, warm-starting from the
        served parameter, and swap in the result under the lock.  Returns
        the new fit's validated bounds, khat, mean and final loss.  Raises
        `ServiceBusyError` (HTTP 503) if another fit is in flight.

        With ``n_starts > 1`` `validated_vi_multistart` runs K pipelines as
        one batch (start 0 = the served parameter unperturbed), swaps in
        the start with the tightest validated 2-divergence bound, and
        reports its index as ``best``; `n_starts` multiplies the resource
        checks."""
        n_iters, n_mc_samples, n_bound_samples, n_starts = (
            int(n_iters), int(n_mc_samples), int(n_bound_samples),
            int(n_starts))
        if min(n_iters, n_mc_samples, n_bound_samples, n_starts) <= 0:
            raise ValueError('n_iters, n_mc_samples, n_bound_samples, and '
                             'n_starts must all be positive')
        if n_iters > self.max_fit_iters:
            raise ValueError('n_iters {} exceeds the service limit {}'
                             .format(n_iters, self.max_fit_iters))
        if n_starts * n_bound_samples > self.max_bound_samples:
            raise ValueError('n_starts * n_bound_samples = {} exceeds the '
                             'service limit {}'.format(
                                 n_starts * n_bound_samples,
                                 self.max_bound_samples))
        if n_starts * n_iters * n_mc_samples > self.max_fit_evals:
            raise ValueError(
                'n_starts * n_iters * n_mc_samples = {} exceeds the '
                'service limit {} (the presampled pipeline materializes '
                'an (n_iters, n_mc_samples, dim) draw array per '
                'start)'.format(n_starts * n_iters * n_mc_samples,
                                self.max_fit_evals))
        lr = float(learning_rate)
        lr_end = None if learning_rate_end is None else float(
            learning_rate_end)
        pscale = float(perturb_scale)
        # reject (not queue) a concurrent fit: the caller gets an immediate
        # 503 instead of an unbounded wait behind the running one
        if not self._fit_lock.acquire(blocking=False):
            raise ServiceBusyError(
                'a fit is already running; retry when it completes '
                '(concurrent fits are rejected, not queued)')
        try:
            return self._fit_locked(n_iters, n_mc_samples, n_bound_samples,
                                    lr, lr_end, n_starts, pscale)
        finally:
            self._fit_lock.release()

    def _fit_locked(self, n_iters, n_mc_samples, n_bound_samples, lr,
                    lr_end, n_starts, pscale):
        from .pipeline import validated_vi, validated_vi_multistart
        var_param, _, _ = self._snapshot()
        kw = dict(n_mc_samples=n_mc_samples, n_bound_samples=n_bound_samples,
                  generator=self._generator(), learning_rate=lr,
                  learning_rate_end=lr_end, device=self.device)
        best = None
        if n_starts > 1:
            ms = validated_vi_multistart(
                self.model, self.family, var_param, n_iters,
                n_starts=n_starts, perturb_scale=pscale, **kw)
            best = ms['best']
            # the winning start's slices in the single-fit layout
            out = dict(opt_param=ms['opt_param'][best],
                       q_mean=ms['q_mean'][best], q_cov=ms['q_cov'][best],
                       bounds=ms['bounds'][best], khat=ms['khat'][best],
                       value_history=ms['value_history'][best])
        else:
            out = validated_vi(self.model, self.family, var_param, n_iters,
                               **kw)
        mean = out['q_mean'].cpu().numpy()
        cov = out['q_cov'].cpu().numpy()
        with self._lock:
            self.var_param = out['opt_param'].detach()
            self.mean = mean
            self.cov = cov
        res = dict(
            bounds={k: float(v) for k, v in out['bounds'].items()},
            khat=float(out['khat']),
            mean=mean.tolist(),
            final_loss=float(out['value_history'][-1]))
        if best is not None:
            res['best'] = int(best)
            res['n_starts'] = n_starts
        return res


def _null_nonfinite(obj):
    """Replace non-finite floats with ``None`` (JSON ``null``) so the
    payload is valid (RFC-8259) JSON with a stable per-field schema: every
    numeric field is ``number | null``, where null means the value was
    non-finite (a vacuous inf bound, or an undefined NaN khat on a
    degenerate tail) (viabel_tpu/serve.py:343-360)."""
    import math
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _null_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_null_nonfinite(v) for v in obj]
    return obj


def _make_handler(service):
    """The request handler of `service` (viabel_tpu/serve.py:363-460)."""
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, status=200):
            # `Infinity`/`NaN` are not valid JSON: dump strictly, and only
            # on failure null out the non-finite leaves (`_null_nonfinite`)
            try:
                body = json.dumps(obj, allow_nan=False).encode()
            except ValueError:
                body = json.dumps(_null_nonfinite(obj)).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == '/health':
                    self._json(dict(status='ok',
                                    model=service.model.name,
                                    family=service.family.name,
                                    dim=service.model.dim))
                elif url.path == '/moments':
                    self._json(service.moments())
                elif url.path == '/sample':
                    n = min(int(q.get('n', ['1'])[0]), 1000000)
                    if n <= 0:
                        return self._json(dict(
                            error='n must be positive, got {}'.format(n)),
                            400)
                    self._json(dict(samples=service.sample(n).tolist()))
                elif url.path == '/bounds':
                    n = min(int(q.get('n', ['100000'])[0]), 10000000)
                    if n < 2:  # PSIS khat needs at least two log-weights
                        return self._json(dict(
                            error='n must be at least 2, got {}'.format(n)),
                            400)
                    self._json(service.bounds(n))
                else:
                    self._json(dict(error='unknown endpoint'), 404)
            except (ValueError, TypeError) as e:  # malformed client input
                self._json(dict(error=str(e)), 400)
            except Exception as e:  # surface errors as JSON, keep serving
                self._json(dict(error=str(e)), 500)

        def do_POST(self):
            url = urlparse(self.path)
            try:
                length = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(length) or b'{}')
                if not isinstance(payload, dict):
                    return self._json(dict(
                        error='payload must be a JSON object'), 400)
                if url.path == '/log_prob':
                    x = payload.get('x')
                    if x is None:
                        return self._json(dict(error='missing "x"'), 400)
                    try:
                        lp = service.log_prob(x)
                    except (ValueError, TypeError) as e:  # non-numeric x
                        return self._json(dict(error=str(e)), 400)
                    self._json(dict(log_prob=lp.tolist()))
                elif url.path == '/fit':
                    allowed = {'n_iters', 'n_mc_samples', 'n_bound_samples',
                               'learning_rate', 'learning_rate_end',
                               'n_starts', 'perturb_scale'}
                    unknown = set(payload) - allowed
                    if unknown:
                        return self._json(dict(
                            error='unknown fit options: {}'.format(
                                sorted(unknown))), 400)
                    try:
                        self._json(service.fit(**payload))
                    except ServiceBusyError as e:  # a fit is in flight
                        self._json(dict(error=str(e)), 503)
                    except (ValueError, TypeError) as e:  # bad option values
                        self._json(dict(error=str(e)), 400)
                else:
                    self._json(dict(error='unknown endpoint'), 404)
            except (ValueError, TypeError) as e:  # malformed JSON/input
                self._json(dict(error=str(e)), 400)
            except Exception as e:
                self._json(dict(error=str(e)), 500)

    return Handler


def serve(service, port=8080, host='127.0.0.1'):
    """Run the HTTP server (blocking).  Use `start_server` to run it on a
    background thread instead."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    with httpd:
        httpd.serve_forever()


def start_server(service, port=8080, host='127.0.0.1'):
    """Start the server on a daemon thread; returns (server, thread).
    Stop it with ``server.shutdown()`` and ``server.server_close()``."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


def _param_from_checkpoint(path):
    """Served variational parameter from an optimizer checkpoint of either
    package (viabel_tpu/serve.py:476-551), dispatched on its format
    (`checkpoint.checkpoint_format`):

    * ``adagrad-history/v1``: the tail-quarter mean of the ``(n_iters,
      P)`` iterate history over the ``i`` completed iterations, the fit
      `adagrad_optimize` reports; the current iterate before any;
    * ``adagrad-tail/v1`` (``return_history=False``): ``tail_sum / (i - 3
      * n_iters // 4)`` once the run is past the tail's start, else the
      current iterate;
    * ``chains/v1`` (the IA chain runs): the tail-quarter mean of the
      chronologically ordered ring-buffer history, pooled over chains
      (its ``params`` entry holds the current per-chain parameters, which
      must not be averaged by iteration index);
    * no format: a plain ``.npz`` holding one parameter vector (a
      ``param`` entry, or its first array).
    """
    from .checkpoint import (FORMAT_ADAGRAD_HISTORY, FORMAT_ADAGRAD_TAIL,
                             FORMAT_CHAINS, checkpoint_format,
                             load_checkpoint_entry)
    fmt = checkpoint_format(path)
    if fmt == FORMAT_CHAINS:
        hist = load_checkpoint_entry(path, 'hist')  # (n_chains, cap, P)
        i_done = int(load_checkpoint_entry(path, 'i'))
        if i_done <= 0:
            raise ValueError(
                '{!r} is a multichain checkpoint with no completed '
                'iterations; nothing to serve'.format(path))
        cap = hist.shape[1]
        kept = min(i_done, cap)
        # chronological order of the ring buffer (as the chain runs'
        # post-pass reconstructs it)
        order = (i_done - kept + np.arange(kept)) % cap
        tail = hist[:, order][:, 3 * kept // 4:]
        return tail.mean(axis=(0, 1))
    if fmt == FORMAT_ADAGRAD_HISTORY:
        params = load_checkpoint_entry(path, 'params')
        i_done = int(load_checkpoint_entry(path, 'i'))
        if 0 < i_done <= params.shape[0]:
            return params[3 * i_done // 4:i_done].mean(axis=0)
        return load_checkpoint_entry(path, 'param')
    if fmt == FORMAT_ADAGRAD_TAIL:
        i_done = int(load_checkpoint_entry(path, 'i'))
        n_iters = load_checkpoint_entry(path, 'values').shape[0]
        tail_start = 3 * n_iters // 4
        if i_done > tail_start:
            return (load_checkpoint_entry(path, 'tail_sum')
                    / (i_done - tail_start))
        return load_checkpoint_entry(path, 'param')
    with np.load(path) as d:
        names = {k.split(':', 1)[1].split('/')[-1]
                 for k in d.files if ':' in k}
        if 'param' in names:
            return load_checkpoint_entry(path, 'param')
        return d[d.files[0]]


def _fit_from_config(cfg, model, family, objective, device=None):
    """Fit the served parameter as the command line fits the same config
    (both call `config.fit`, with the generator it derives from
    ``cfg.seed``) on `device` (None: the CUDA card)."""
    from .config import fit
    return fit(cfg, model, family, objective, device=device)[0]


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog='python -m viabel_tpu_torch.serve')
    p.add_argument('--config', required=True, help='ExperimentConfig JSON')
    p.add_argument('--param', help='checkpoint .npz with the fitted param '
                                   '(defaults to fitting from scratch)')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--device', default='cuda',
                   help='the device to serve from (default cuda; cpu runs '
                        'the kernels\' plain versions)')
    args = p.parse_args(argv)

    from .__main__ import _device
    from .config import ExperimentConfig, build

    device = _device(args)
    with open(args.config) as f:
        cfg = ExperimentConfig.from_json(f.read())
    model, family, objective = build(cfg)
    if args.param:
        var_param = _param_from_checkpoint(args.param)
    else:
        print('no --param given; fitting {} iters with {}...'.format(
            cfg.n_iters, cfg.optimizer), flush=True)
        var_param = _fit_from_config(cfg, model, family, objective, device)
    service = PosteriorService(model, family, var_param, seed=cfg.seed,
                               device=device)
    print('serving {} / {} on {}:{}'.format(model.name, family.name,
                                            args.host, args.port),
          flush=True)
    serve(service, port=args.port, host=args.host)


if __name__ == '__main__':
    main()
