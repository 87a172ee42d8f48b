"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  The manifest is ``BENCHMARK.json`` beside this folder; the cell
names a configuration (``configs/<config>.json``, its program objects
from ``configs/<config>.py``, its plain reference in
``reference/<config>.py``) and a traffic mix (``traffic/<mix>.json``,
whose ``kind`` names the loop of calls in ``kinds/<kind>.py`` and its
end-to-end values; `loops` says what a kind's file defines).

A run: set-up (imports, the kernels' build on a first run, the data, the
program objects, the loop's own set-up and one warm call of the timed
call, which captures its CUDA graphs), then a closed loop of timed calls
for ``--seconds`` (a call starts only while it can end inside the
window, judged by the longest call so far; at least one runs), then,
with ``--trace 1``, a profiled slice read by each per-layer metric's
reader (``metrics/<metric>.py``), then the check of a sample of the
window's results against the reference (`correct`).  The last line of
standard output is the result object; the numbers compared, each with
its limit, are the last lines of standard error and the ``checks`` key,
the last of the result.

It exits with a code other than 0 and prints no result when there is no
CUDA device, or fewer than the cell asks for, and when the process holds
JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace as Context  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'viabel_tpu')
CACHE = os.path.join(ROOT, '.portbench_cache')


class Refused(Exception):
    """A run that must print no result."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """A module of this folder by file name (names may hold dots)."""
    path = os.path.join(HERE, *parts)
    name = 'portbench._loaded.' + '.'.join(parts).replace('.py', '')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """The top-level names in `sys.modules` that the port may not load."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric, cell):
    return cell in metric.get('workloads', [cell])


class Cell:
    """One cell: its configuration's program objects in a loop of its
    mix's kind, the reference, and the limits."""

    def __init__(self, manifest, name, device, overrides=None):
        import torch

        cells = {w['name']: w for w in manifest['workloads']}
        if name not in cells:
            raise Refused('no workload named {!r} in BENCHMARK.json'
                          .format(name))
        self.manifest, self.name, self.spec = manifest, name, cells[name]
        config = {c['name']: c for c in manifest['configs']}[
            self.spec['config']]
        self.cfg = load_json(os.path.relpath(
            os.path.join(ROOT, config['file']), HERE))
        self.cfg.update(overrides or {})
        self.mix = load_json('traffic', self.spec['traffic'] + '.json')
        self.ref_module = load_module('reference',
                                      self.spec['config'] + '.py')
        builder = load_module('configs', self.spec['config'] + '.py')
        self.kind = load_module('kinds', self.mix['kind'] + '.py')
        self.device = torch.device(device)
        init = self.ref_module.init(self.cfg)
        program = builder.build(self.cfg, init, self.device)
        self.loop = self.kind.Loop(self.cfg, self.mix, program, init,
                                   self.device)

    def reference(self, control=None):
        """The plain reference, or with `control` ('bfloat16', 'tf32')
        the control: the reference in the precision below the
        configuration's."""
        import torch
        from portbench.reference.protocols import Reference

        cuda = self.device.type == 'cuda'
        work = torch.float64
        if control == 'bfloat16':
            work = torch.bfloat16
        elif control == 'tf32':
            work = torch.float32
        opt = self.cfg.get('reference_opt_device', 'cuda') if cuda else 'cpu'
        return Reference(self.ref_module, self.cfg, work=work,
                         device=self.device, opt_device=opt,
                         tf32=control == 'tf32')

    def warm(self, seed):
        """The loop's set-up and one warm call; returns its seconds."""
        from portbench.loops import derive
        self.loop.setup(seed)
        return self.loop.timed(derive(seed, 'warm'))[0]

    def window(self, seed, seconds):
        """Timed calls for `seconds`, each started only while the longest
        so far would end inside the window (the first always); returns
        (call seconds, their results, seconds from the window's start to
        the last call's end)."""
        from portbench.loops import derive
        times, results = [], []
        t0 = time.perf_counter()
        end = t0 + seconds
        while not times or time.perf_counter() + max(times) <= end:
            dt, out = self.loop.timed(derive(seed, 'call', len(times)))
            times.append(dt)
            results.append(out)
        return times, results, time.perf_counter() - t0

    def pairs(self, seed, results, ref):
        """(program, reference) results of a sample, drawn from the seed,
        of the window's calls (and of the loop's set-up fit)."""
        import numpy as np
        from portbench.loops import derive

        pairs = list(getattr(self.loop, 'setup_check',
                             lambda ref: [])(ref))
        rng = np.random.default_rng(derive(seed, 'check'))
        n = len(results)
        for i in sorted(rng.choice(n, size=min(self.mix['check_calls'], n),
                                   replace=False)):
            refs = self.loop.check(ref, derive(seed, 'call', int(i)),
                                   results[i])
            pairs.extend(zip(results[i], refs))
        return pairs

    def end_to_end(self, times, span):
        """The end-to-end values of the window, by its kind."""
        return self.kind.end_to_end(times, span, self.loop)

    def traced(self, seed, times, span):
        """The per-layer metrics from a profiled slice, the device's busy
        and window seconds, and the breakdown."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench import trace as tr
        from portbench.loops import derive, sync

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            with record_function('slice'):
                iters = self.loop.trace_call(derive(seed, 'trace'))
                sync(self.device)
        t = tr.Trace(tr.records(prof))
        # what a per-layer metric's reader reads
        ctx = Context(trace=t, iters=iters, cfg=self.cfg, mix=self.mix,
                      kind=torch.cuda.get_device_name(self.device),
                      e2e=self.end_to_end(times, span))
        values = {}
        for m in self.manifest['per_layer']:
            if applies(m, self.name):
                v = load_module('metrics', m['name'] + '.py').read(ctx)
                if v is not None:
                    values[m['name']] = dict(value=v, unit=m['unit'])
        device = dict(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = dict(device_ops=t.top_ops(), idle_gaps=t.idle_by_host())
        return values, device, breakdown


def run(manifest, name, seed, seconds, trace, device='cuda', overrides=None,
        t_start=None):
    """One run of the cell; returns the result object."""
    import torch
    from portbench import correct

    t_start = T_START if t_start is None else t_start
    cell = Cell(manifest, name, device, overrides)
    warm = cell.warm(seed)
    setup_s = time.perf_counter() - t_start
    log('set-up {:.3f} s (warm call {:.3f} s)'.format(setup_s, warm))
    times, results, span = cell.window(seed, seconds)
    log('window: {} calls in {:.3f} s'.format(len(times), span))
    cuda = cell.device.type == 'cuda'
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(cell.device) if cuda
               else 'cpu', count=1,
               memory_peak_bytes=(torch.cuda.max_memory_allocated(cell.device)
                                  if cuda else 0))
    result = dict(correct=None, attempted=len(times), failed=0)
    if trace:
        metrics, busy, breakdown = cell.traced(seed, times, span)
        dev.update(busy)
    else:
        e2e = cell.end_to_end(times, span)
        e2e['setup_s'] = setup_s
        metrics = {}
        for m in manifest['end_to_end']:
            if applies(m, name):
                if m['name'] not in e2e:
                    raise Refused('the {!r} loop gives no {}'.format(
                        cell.mix['kind'], m['name']))
                metrics[m['name']] = dict(value=e2e[m['name']],
                                          unit=m['unit'])
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    pairs = cell.pairs(seed, results, cell.reference())
    limits = load_json('limits', name + '.json')
    excused = sum(correct.excused(r, limits) for _, r in pairs)
    log('check {:.3f} s: {} results, {} excused by their float32 witness'
        .format(time.perf_counter() - t_check, len(pairs), excused))
    ok, checks = correct.judge(correct.worst(pairs, limits), limits)
    result.update(correct=ok, metrics=metrics, device=dev)
    if trace:
        result['breakdown'] = breakdown
    result['checks'] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ.setdefault(var, os.path.join(CACHE, sub))
    # one host thread for the CPU's math libraries: the program's host
    # work is small and serial, and idle worker threads only add jitter
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS',
                'OPENBLAS_NUM_THREADS'):
        os.environ.setdefault(var, '1')
    try:
        import torch
        with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
            manifest = json.load(f)
        chips = {w['name']: w['chips'] for w in manifest['workloads']}.get(
            args.workload, 1)
        if not torch.cuda.is_available():
            raise Refused('no CUDA device')
        if torch.cuda.device_count() < chips:
            raise Refused('{} CUDA devices, the cell asks for {}'.format(
                torch.cuda.device_count(), chips))
        result = run(manifest, args.workload, args.seed, args.seconds,
                     args.trace)
        found = forbidden_modules()
        if found:
            raise Refused('the process holds {}'.format(', '.join(found)))
    except Refused as e:
        log('refused: {}'.format(e))
        return 2
    for k, c in result['checks'].items():
        log('check {} {!r} limit {!r}'.format(k, c['value'], c['limit']))
        if not c['value'] < float('inf'):   # NaN and inf have no JSON
            c['value'] = repr(c['value'])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
