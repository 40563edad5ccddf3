"""Readings of a cell's compared numbers over many seeds in one process: the program's
(sound runs, for the lower reading of each limit) or the cell's control's (for the
upper).  Each seed is a whole run (its own inputs, weights and set-up) with a short
window; the import, the card and the kernel builds are paid once.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 [--control]
        [--seconds 1] [--out FILE]

Prints one JSON line a seed: the seed, whether it read correct under the current
limits, and every compared number.
"""
import argparse
import json
import os
import sys


def readings(spec, cell, seeds, control=False, seconds=1.0, device='cuda'):
    """[{seed, correct, numbers}] of ``cell`` (its control with ``control``)."""
    from benchmark.harness import run_cell
    ctrl = spec.checks(cell)['control'] if control else None
    out = []
    for seed in seeds:
        numbers = {}
        result = run_cell(spec, cell, seed, seconds, 0, device, control=ctrl,
                          numbers_out=numbers)
        out.append({'seed': seed, 'correct': result['correct'], 'numbers': numbers})
    return out


def main(argv):
    from benchmark.spec import Spec
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control', action='store_true')
    p.add_argument('--seconds', type=float, default=1.0)
    p.add_argument('--out')
    args = p.parse_args(argv)
    spec = Spec(os.getcwd())
    lines = []
    for row in readings(spec, args.workload, args.seeds, args.control, args.seconds):
        row.update(workload=args.workload, control=args.control)
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            f.write('\n'.join(lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run import prepare
    prepare()
    sys.exit(main(sys.argv[1:]))
