"""The program's profiler spans (`viabel_tpu_torch._trace`).

Off (no profiler recording), a span is one shared null context: no
annotation, no synchronize, the same results bit for bit.  On, a
validated fit and a batch of starts emit ``vt.fit`` around properly
nested phase spans, one set of pass spans a run and one ``vt.sync`` a
read of the device; no span opens per optimizer iteration or replay; the
launch and capture counters count as before.  The test marked ``cuda``
profiles a fit at eight-schools sizes on the card and holds the spans to
the device records: they share the device trace's clock.  The file
imports no JAX, so the card test runs where JAX is absent.
"""
import ast
import collections
import inspect
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import viabel_tpu_torch as pt
from viabel_tpu_torch import _device, _trace, optimizers
from viabel_tpu_torch.models import eight_schools_cp_model
from viabel_tpu_torch.ops import adagrad as aops
from viabel_tpu_torch.utils import count_compilations

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

PACKAGE = os.path.dirname(os.path.abspath(pt.__file__))
# the benchmark harness's own span names (portbench/loops.py, run.py)
HARNESS = {'slice', 'draw', 'score', 'bounds', 'psis'}
PASS_SPANS = ('vt.bound_pass', 'vt.psis', 'vt.moments', 'vt.host_bounds')
PHASES = ('vt.draws', 'vt.optimize') + PASS_SPANS
K = 2
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _setup(device, n_mc=20):
    model = eight_schools_cp_model()
    fam = pt.mean_field_t_variational_family(10, 40)
    obj = pt.black_box_klvi(fam, model, n_mc, presampled=True)
    init = torch.zeros(fam.var_param_dim, device=device)
    return model, fam, obj, init


def _fit(batch, n_iters=30, device='cpu', seed=3, n_bound=4000, n_mc=20,
         **kw):
    model, fam, obj, init = _setup(device, n_mc)
    g = torch.Generator(device=device).manual_seed(seed)
    common = dict(objective_and_grad=obj, n_bound_samples=n_bound,
                  generator=g, device=device, **kw)
    if batch:
        return pt.validated_vi_multistart(model, fam, init, n_iters,
                                          n_starts=K, **common)
    return pt.validated_vi(model, fam, init, n_iters, **common)


def _kind(e):
    """An event's trace category; where the profiler gives no activity
    type, worked out from its device, whether it is an annotation, and
    (on the device) its name."""
    activity = getattr(e, 'activity_type', None)
    if activity is not None:
        return str(activity())
    device = str(e.device_type()).endswith('CUDA')
    if e.is_user_annotation():
        return 'gpu_user_annotation' if device else 'user_annotation'
    if not device:
        return 'cpu_op'
    for prefix, kind in (('Memcpy', 'gpu_memcpy'), ('Memset', 'gpu_memset')):
        if e.name().startswith(prefix):
            return kind
    return 'kernel'


def _records(prof):
    """(name, kind, start, end, correlation id) of every event, times in
    ns; a kernel's correlation id is that of the host call that launched
    it."""
    return [(e.name(), _kind(e), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _spans(recs):
    return sorted((r for r in recs if r[1] == 'user_annotation'),
                  key=lambda r: (r[2], -r[3]))


def _profiled(fn, cuda=False):
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    return out, _records(prof)


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _assert_nested(spans):
    """Every two spans are disjoint or one holds the other."""
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            assert (a[3] <= b[2] or b[3] <= a[2] or _inside(a, b)
                    or _inside(b, a)), (a, b)


def _count(monkeypatch):
    """Count `record_function`s made and synchronizes called."""
    made = collections.Counter()
    real = torch.profiler.record_function

    def counting_rf(name, *a, **k):
        made['record_function'] += 1
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, 'record_function', counting_rf)
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a, **k: made.update(['synchronize']))
    return made


# --------------------------------------------------------------------------
# off
# --------------------------------------------------------------------------

def test_span_off_is_one_null_context(monkeypatch):
    made = _count(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    a = _trace.span('fit')
    assert a is _trace.span('optimize', torch.device('cuda'))
    with a, _trace.span('draws', 'cuda:0'):
        pass
    assert pt.utils.span is _trace.span
    _fit(False)
    _fit(True)
    assert made == {}


def test_span_off_changes_no_result():
    plain = _fit(False)
    traced, _ = _profiled(lambda: _fit(False))
    assert torch.equal(plain['opt_param'], traced['opt_param'])
    assert torch.equal(plain['smoothed_log_weights'],
                       traced['smoothed_log_weights'])
    assert plain['bounds'] == traced['bounds']
    assert plain['khat'] == traced['khat']


# --------------------------------------------------------------------------
# on
# --------------------------------------------------------------------------

def test_span_on_synchronizes_a_cuda_device_only(monkeypatch):
    made = _count(monkeypatch)
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda device=None: synced.append(device))

    def body():
        with _trace.span('a', torch.device('cuda:0')):
            with _trace.span('b', 'cpu'), _trace.span('c'):
                pass
        return _trace.to_host(torch.ones(2))

    out, recs = _profiled(body)
    assert torch.equal(out, torch.ones(2))
    assert synced == [torch.device('cuda:0')]
    assert made['record_function'] == 4
    assert [r[0] for r in _spans(recs)] == ['vt.a', 'vt.b', 'vt.c',
                                           'vt.sync']


@pytest.mark.parametrize('batch', [False, True], ids=['single', 'batch'])
def test_fit_spans_nest(batch):
    _, recs = _profiled(lambda: _fit(batch))
    spans = _spans(recs)
    names = collections.Counter(r[0] for r in spans)
    runs = K if batch else 1
    # one read a start's Philox seed and the perturbation's (a batch), one
    # of the optimizer's counter, four a run's bounds
    syncs = (runs + 1 if batch else 0) + 1 + 4 * runs
    assert names == {'vt.fit': 1, 'vt.draws': 1, 'vt.optimize': 1,
                     'vt.bound_pass': runs, 'vt.psis': runs,
                     'vt.moments': runs, 'vt.host_bounds': runs,
                     'vt.sync': syncs}
    _assert_nested(spans)
    fit = spans[0]
    assert fit[0] == 'vt.fit' and all(_inside(r, fit) for r in spans)
    first = {}
    for r in spans:
        first.setdefault(r[0], r)
    order = [first[n][2] for n in PHASES]
    assert order == sorted(order)
    assert first['vt.draws'][3] <= first['vt.optimize'][2]
    assert all(r[2] >= first['vt.optimize'][3] for r in spans
               if r[0] in PASS_SPANS)
    holders = [r for r in spans if r[0] in ('vt.draws', 'vt.optimize',
                                              'vt.host_bounds')]
    for r in spans:
        if r[0] == 'vt.sync':
            assert any(_inside(r, h) for h in holders), r


def _span_names_in_source():
    names = set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r"\bspan\('([^']+)'",
                                            fh.read()))
    return names


def test_no_program_span_bears_a_harness_name():
    named = _span_names_in_source()
    assert named == {'fit', 'draws', 'optimize', 'eager', 'capture',
                     'replay', 'bound_pass', 'psis', 'moments',
                     'host_bounds', 'sync'}
    _, recs = _profiled(lambda: (_fit(False), _fit(True)))
    emitted = {r[0] for r in _spans(recs)}
    assert all(n.startswith('vt.') for n in emitted)
    full = {'vt.' + n for n in named}
    assert emitted <= full and not full & HARNESS


def _loops_with_spans(fn):
    """The span or host reads called inside a loop of `fn`'s body."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    found = []
    for loop in ast.walk(tree):
        if isinstance(loop, (ast.For, ast.While)):
            for node in ast.walk(loop):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id in ('span', 'to_host')):
                    found.append(node.func.id)
    return found


def test_no_span_per_iteration_or_replay():
    for fn in (optimizers._adagrad_eager, optimizers._adagrad_graph,
               optimizers._adagrad_iteration, aops.replay):
        assert _loops_with_spans(fn) == [], fn.__name__
    counts = []
    for n_iters in (20, 60):
        _, recs = _profiled(lambda: _fit(True, n_iters=n_iters))
        counts.append(collections.Counter(r[0] for r in _spans(recs)))
    assert counts[0] == counts[1]


class _StubGraph:
    def capture_begin(self):
        pass

    def capture_end(self):
        pass


@pytest.mark.parametrize('traced', [False, True], ids=['off', 'on'])
def test_counters_count_as_before(traced, monkeypatch):
    n_iters = 40

    def body():
        before = aops.launches['adagrad_step'], aops.replayed['adagrad_step']
        with count_compilations() as n:
            _fit(False, n_iters=n_iters)
            _fit(True, n_iters=n_iters)
        return (aops.launches['adagrad_step'] - before[0],
                aops.replayed['adagrad_step'] - before[1], n[0])

    counted = _profiled(body)[0] if traced else body()
    # the CPU runs the step's plain version eagerly: no launch, no capture
    # (the card test counts launches and replays under the profiler)
    assert counted == (0, 0, 0)
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _StubGraph)
    with count_compilations() as n:
        _, recs = (_profiled(lambda: _device.capture(lambda: None, None))
                   if traced else (_device.capture(lambda: None, None), []))
    assert n[0] == 1
    assert [r[0] for r in _spans(recs)] == (['vt.capture'] if traced
                                            else [])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


# how far the device clock, converted to the host's, may put an
# operation's end past the synchronize that waited for it
CLOCK_SLACK_NS = 50_000


@pytest.mark.cuda
def test_spans_share_the_device_clock(cuda):
    """A profiled fit at eight-schools sizes (n_mc 100, 2.5e6 bound
    samples) on the card: every device operation starts inside
    ``vt.fit``; what starts inside ``vt.draws`` ends before it closes (so
    no queued draw is counted in ``vt.optimize``); ``vt.optimize`` closes
    after the last replayed kernel ends; every graph launch (one an
    iteration past the window) is inside ``vt.replay`` and launched one
    iteration's kernels, the same number each."""
    n_iters, window = 300, 10
    model, fam, obj, init = _setup(cuda, n_mc=100)
    kw = dict(objective_and_grad=obj, n_bound_samples=2_500_000,
              window=window, learning_rate=0.01, learning_rate_end=0.001,
              epsilon=0.1, device=cuda)
    pt.validated_vi(model, fam, init, n_iters, **kw)    # builds the kernels
    g = torch.Generator(device=cuda).manual_seed(5)
    torch.cuda.synchronize()
    before = aops.launches['adagrad_step'], aops.replayed['adagrad_step']
    with count_compilations() as n:
        _, recs = _profiled(lambda: pt.validated_vi(
            model, fam, init, n_iters, generator=g, **kw), cuda=True)
    assert n[0] == 1
    assert aops.launches['adagrad_step'] - before[0] == n_iters
    assert aops.replayed['adagrad_step'] - before[1] == n_iters - window
    spans = _spans(recs)
    names = collections.Counter(r[0] for r in spans)
    assert names['vt.fit'] == names['vt.optimize'] == 1
    assert names['vt.eager'] == names['vt.capture'] == 1
    assert names['vt.replay'] == 1
    _assert_nested(spans)
    by = {r[0]: r for r in spans}
    fit, draws, opt, replay = (by['vt.fit'], by['vt.draws'],
                               by['vt.optimize'], by['vt.replay'])
    device = [r for r in recs if r[1] in DEVICE_KINDS]
    outside = [r for r in device if not fit[2] <= r[2] <= fit[3]]
    assert device and not outside, outside[:5]
    in_draws = [r for r in device if draws[2] <= r[2] <= draws[3]]
    late_draw = max(r[3] - draws[3] for r in in_draws)
    # the replayed operations (kernels and the graph's copies): those a
    # cudaGraphLaunch launched, each such call inside vt.replay
    launches = [r for r in recs if r[0] == 'cudaGraphLaunch']
    assert len(launches) == n_iters - window
    assert all(_inside(r, replay) for r in launches)
    graph = {r[4] for r in launches}
    replayed = [r for r in device if r[4] in graph]
    late_step = max(r[3] - opt[3] for r in replayed)
    per_launch = collections.Counter(r[4] for r in replayed)
    kernels = collections.Counter(r[4] for r in replayed if r[1] == 'kernel')
    print('{} device operations in vt.draws, the last ending {} ns past '
          'it; {} replayed operations ({} a replay, kernels {}), the last '
          'ending {} ns past vt.optimize'.format(
              len(in_draws), late_draw, len(replayed),
              sorted(set(per_launch.values())),
              sorted(set(kernels.values())), late_step))
    assert in_draws and late_draw <= CLOCK_SLACK_NS
    assert all(r[2] >= replay[2] for r in replayed)
    assert late_step <= CLOCK_SLACK_NS
    assert len(per_launch) == len(kernels) == len(launches)
    assert len(set(per_launch.values())) == len(set(kernels.values())) == 1
    assert 20 <= len(replayed) // len(launches) <= 400
