"""Host calls that put work on the device, a PSIS of a validation pass:
the traced slice's host records of the CUDA runtime's and driver's calls
named ``cudaLaunch*`` or ``cuLaunch*`` (kernels, ``cudaLaunchKernelExC``
too), ``cudaGraphLaunch`` / ``cuGraphLaunch``, ``cudaMemcpy*`` /
``cuMemcpy*`` or ``cudaMemset*`` / ``cuMemset*`` (copies and fills,
asynchronous or not), that started inside the program's ``vt.psis``
spans (`psis._psislw_1d`) or ``vt.moments`` spans
(`psis.weighted_moments`), over the number of ``vt.psis`` spans.  The
name alone picks a record: where the profiler's events carry no activity
type (torch 2.11), `trace.records` files the runtime's calls with the
operators.  None where the program has no such span, or the trace no
such call."""
import numpy as np

PREFIXES = ('cudaLaunch', 'cuLaunch', 'cudaGraphLaunch', 'cuGraphLaunch',
            'cudaMemcpy', 'cuMemcpy', 'cudaMemset', 'cuMemset')


def read(ctx):
    spans = sorted((r.start, r.end) for r in ctx.trace.spans
                   if r.name in ('vt.psis', 'vt.moments'))
    n = sum(1 for r in ctx.trace.spans if r.name == 'vt.psis')
    calls = [r.start for r in ctx.trace.host if r.name.startswith(PREFIXES)]
    if not (n and calls):
        return None
    starts = np.array([a for a, _ in spans])
    at = np.searchsorted(starts, calls, side='right') - 1
    count = sum(1 for t, i in zip(calls, at) if i >= 0 and t <= spans[i][1])
    return count / n
