"""The two readings each limit in ``limits/<cell>.json`` is set between:

* the lower: the numbers of sound runs of the program, one seed after
  another in one process (set-up, a short window at the cell's own load, the
  check), the largest over the seeds;
* the upper: the numbers of the control (the reference computed in the
  precision below the configuration's, ``harness.control_numbers``), the
  smallest over its seeds.

    python3 -m benchmark.readings --workload <name> --seeds 101-112
        [--control 201-203] [--seconds 2]

One JSON line per seed and side, then the summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import harness


def seeds(text: str) -> list:
    if '-' in text:
        a, b = text.split('-')
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(',') if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control', default='')
    p.add_argument('--seconds', type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 3
    lower, upper = {}, {}
    for seed in seeds(args.seeds):
        out = harness.run_cell(args.workload, seed, args.seconds, False)
        nums = {k: c['value'] for k, c in out['checks'].items()}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps({'side': 'program', 'seed': seed, 'correct': out['correct'],
                          'numbers': nums}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in seeds(args.control):
        nums = harness.control_numbers(args.workload, seed)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({'side': 'control', 'seed': seed, 'numbers': nums}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({'workload': args.workload, 'lower': lower, 'upper': upper}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
