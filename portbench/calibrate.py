"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 ...
        [--control-seeds 7 8 9] [--faults half_batch unchanged_step]
        [--fault-seeds 4 5 6] [--witness-seeds 4 5 6] [--out <file>]

For each of `--seeds`, the program's results of a run with the mix's
``check_calls`` calls against the reference's, as a run of the cell
reads them (the program's sound runs: the lower readings).  For each of
`--control-seeds`, the control, which is the reference computed in the
precision below the configuration's (its ``control``: bfloat16, or TF32
products for a float32 configuration whose products are pinned to full
float32), in the program's place against the reference (the upper
readings).  For each of `--fault-seeds`, the program with each of
`--faults` (`portbench.faults`) planted, against the reference.  For
each of `--witness-seeds`, the reference computed in float32 (products
in full float32) against the float64 reference, and the program
against it: a second witness for gaps that float32 arithmetic may
explain.  One JSON line a reading on standard output, and all of them in
`--out`.  A reading lists each number's worst gap as a run reads it
(over the results that the cell's limits do not excuse, `correct`), the
results excused, and each result's gaps with its witness's (``each``),
from which the readings can be worked out again for other limits.
The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
import time


class Memo:
    """A reference whose results of a (protocol, seed) are worked out
    once and handed out as copies: every fault of a seed is judged
    against the same reference run."""

    def __init__(self, ref):
        self.ref, self.cache = ref, {}

    def __getattr__(self, name):
        fn = getattr(self.ref, name)
        if name not in ('fit', 'multistart', 'validate'):
            return fn

        def memo(seed, *args):
            if (name, seed) not in self.cache:
                self.cache[name, seed] = fn(seed, *args)
            out = self.cache[name, seed]
            return ([dict(r) for r in out] if isinstance(out, list)
                    else dict(out))
        return memo


def main(argv=None):
    import pytest
    import torch
    from portbench import correct
    from portbench.faults import FAULTS
    from portbench.loops import derive
    from portbench.run import Cell, ROOT, load_json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--faults', nargs='*', default=[], choices=sorted(FAULTS))
    p.add_argument('--fault-seeds', type=int, nargs='*', default=[])
    p.add_argument('--witness-seeds', type=int, nargs='*', default=[])
    p.add_argument('--out')
    args = p.parse_args(argv)
    with open(ROOT + '/BENCHMARK.json') as f:
        manifest = json.load(f)
    lines = []

    def emit(**kw):
        lines.append(kw)
        print(json.dumps(kw), flush=True)

    def program_pairs(cell, seed, ref):
        """The run's calls of `seed` and their pairs with `ref`'s."""
        cell.loop.setup(seed)
        results = [cell.loop.timed(derive(seed, 'call', i))[1]
                   for i in range(cell.mix['check_calls'])]
        if cell.device.type == 'cuda':
            torch.cuda.empty_cache()
        return cell.pairs(seed, results, ref)

    limits = load_json('limits', args.workload + '.json')

    def reading(pairs, **kw):
        each = [dict(program=correct.gaps(p, r),
                     witness=(correct.gaps(r['witness'], r)
                              if 'witness' in r else None))
                for p, r in pairs]
        emit(readings=correct.worst(pairs, limits),
             excused=sum(correct.excused(r, limits) for _, r in pairs),
             each=each, **kw)

    cell = Cell(manifest, args.workload, 'cuda')
    ref = Memo(cell.reference())
    for seed in args.seeds:
        t0 = time.perf_counter()
        reading(program_pairs(cell, seed, ref), side='program', seed=seed,
                seconds=time.perf_counter() - t0)
    if args.control_seeds:
        ctl = cell.reference(cell.cfg['control'])
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            reading(cell.loop.control_pairs(ctl, ref, seed), side='control',
                    control=cell.cfg['control'], seed=seed,
                    seconds=time.perf_counter() - t0)
        del ctl
    if args.witness_seeds:
        f32 = Memo(cell.reference().at(torch.float32))
        for seed in args.witness_seeds:
            t0 = time.perf_counter()
            reading(cell.loop.control_pairs(f32, ref, seed),
                    side='float32 reference', seed=seed,
                    seconds=time.perf_counter() - t0)
            reading(program_pairs(cell, seed, f32),
                    side='program against the float32 reference',
                    seed=seed)
        del f32
    del cell
    for name in args.faults:
        for seed in args.fault_seeds:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                with pytest.MonkeyPatch.context() as mp:
                    FAULTS[name](mp, args.workload)
                    pairs = program_pairs(
                        Cell(manifest, args.workload, 'cuda'), seed, ref)
            except Exception as e:      # a fault that crashes is caught
                emit(side='fault', fault=name, seed=seed, error=repr(e))
                continue
            reading(pairs, side='fault', fault=name, seed=seed,
                    seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
