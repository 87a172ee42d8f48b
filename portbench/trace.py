"""Reading a profiler trace: device busy time, idle gaps and the host
activity in them, kernel times by name, and the harness's spans.

The arithmetic follows `viabel_tpu_torch.utils.metrics.trace_device_time`
(a kernel's time is its record's duration in the trace), frozen here so
that a change to the program cannot move it, and adds the union of the
device's intervals, which time-sums of overlapping records overstate.
Records are taken from the profiler in memory (no trace file is
written): `records` is the one place that knows the profiler's API;
everything else reads plain `Record` tuples, so the tests build
synthetic traces.
"""
from collections import namedtuple

import numpy as np

Record = namedtuple('Record', 'name kind start end')   # times in ns
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_KINDS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'python_function')
SPAN_KIND = 'user_annotation'


def _kind(e):
    """The trace category of a profiler event: its activity type where
    the profiler gives one, else worked out from its device, whether it
    is an annotation, and (on the device) its name."""
    activity = getattr(e, 'activity_type', None)
    if activity is not None:
        return str(activity())
    device = str(e.device_type()).endswith('CUDA')
    if e.is_user_annotation():
        return 'gpu_user_annotation' if device else SPAN_KIND
    if not device:
        return 'cpu_op'
    name = e.name()
    for prefix, kind in (('Memcpy', 'gpu_memcpy'), ('Memset', 'gpu_memset')):
        if name.startswith(prefix):
            return kind
    return 'kernel'


def records(prof):
    """The `Record` of every event of a finished `torch.profiler.profile`."""
    return [Record(e.name(), _kind(e), e.start_ns(),
                   e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def short_name(name):
    """A device operation's name without its return type, template
    arguments and parameter list (a copy's or a fill's without its
    detail)."""
    if name.startswith(('Memcpy', 'Memset')):
        return name.split('(')[0].strip()
    name = name.replace('(anonymous namespace)', '{anonymous}')
    depth, kept = 0, []
    for ch in name:
        depth += (ch == '<') - (ch == '>')
        if depth == 0 and ch != '>':
            kept.append(ch)
    return ''.join(kept).split('(')[0].split()[-1]


class Trace:
    """The records of one profiled slice, clipped to the span named
    `window` (the slice itself)."""

    def __init__(self, recs, window='slice'):
        spans = [r for r in recs if r.kind == SPAN_KIND]
        outer = [r for r in spans if r.name == window]
        if len(outer) != 1:
            raise ValueError('the trace holds {} spans named {!r}'.format(
                len(outer), window))
        self.lo, self.hi = outer[0].start, outer[0].end
        self.spans = [r for r in spans if r.name != window]
        self.device = sorted((r for r in recs if r.kind in DEVICE_KINDS
                              and r.end > self.lo and r.start < self.hi),
                             key=lambda r: r.start)
        self.host = [r for r in recs if r.kind in HOST_KINDS]

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        out = []
        for r in self.device:
            a, b = max(r.start, self.lo), min(r.end, self.hi)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, part=None):
        """The kernel records, those whose name holds `part` if given."""
        return [r for r in self.device if r.kind == 'kernel'
                and (part is None or part in r.name)]

    def mean_kernel_s(self, part):
        ks = self.kernels(part)
        return sum(r.end - r.start for r in ks) / len(ks) / 1e9 if ks \
            else None

    def span_walls(self, name):
        return [(r.end - r.start) / 1e9 for r in self.spans if r.name == name]

    def device_s_in_spans(self, name):
        """The device time of the operations that started inside the
        spans named `name`, and the number of such spans.  Each span ends
        in a synchronize, so what it launched ran inside it; an
        operation is placed by its start alone, since the device's clock,
        converted to the host's, may put the last one's end a few
        microseconds past the span's."""
        spans = sorted((r.start, r.end) for r in self.spans
                       if r.name == name)
        if not spans:
            return None, 0
        starts = np.array([s for s, _ in spans])
        total = 0
        for r in self.device:
            i = np.searchsorted(starts, r.start, side='right') - 1
            if i >= 0 and r.start <= spans[i][1]:
                total += r.end - r.start
        return total / 1e9, len(spans)

    def top_ops(self, k=10):
        """[[name, seconds]] of the k device operations that took the most
        time, summed by short name."""
        sums = {}
        for r in self.device:
            n = short_name(r.name)
            sums[n] = sums.get(n, 0) + (min(r.end, self.hi)
                                        - max(r.start, self.lo))
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_by_host(self, k=10):
        """[[label, seconds]]: the device's idle time inside the window,
        each gap given to what the host was doing at its midpoint (the
        harness's innermost span, then the host operation that started
        last before the midpoint and had not ended, else ``python``),
        summed by label, the k largest."""
        busy = self.busy_intervals()
        edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
        gaps = np.array([(edges[i], edges[i + 1])
                         for i in range(0, len(edges), 2)
                         if edges[i + 1] > edges[i]], dtype=np.int64)
        if not len(gaps):
            return []
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        host = sorted(self.host, key=lambda r: r.start)
        starts = np.array([r.start for r in host], dtype=np.int64)
        at = np.searchsorted(starts, mids, side='right') - 1
        spans = sorted(self.spans, key=lambda r: r.start)
        span_starts = np.array([r.start for r in spans], dtype=np.int64)
        at_span = np.searchsorted(span_starts, mids, side='right') - 1
        sums = {}
        for (a, b), m, i, j in zip(gaps, mids, at, at_span):
            op = (host[i].name if i >= 0 and host[i].end >= m
                  else 'python')
            span = (spans[j].name if j >= 0 and spans[j].end >= m
                    else None)
            label = op if span is None else '{}/{}'.format(span, op)
            sums[label] = sums.get(label, 0) + int(b - a)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]
