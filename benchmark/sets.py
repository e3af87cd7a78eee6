"""Runs of the benchmark command in sequence, one process each, and the
spread of their metrics: how the bounds in ``BENCHMARK.json`` were measured.

    python3 -m benchmark.sets --workload <name> --seeds 11,12,13 [--sets 2]
        [--seconds <s>] [--trace 0|1] [--out <file>.jsonl]

Each set runs every seed once, in order; every run's result line (or its
exit code and the end of its standard error) is appended to ``--out``.  For
each metric and set it prints the median and the spread: the distance
between the first and third quartiles (``statistics.quantiles(values, n=4)``)
as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--sets', type=int, default=1)
    p.add_argument('--seconds', type=float, default=None)
    p.add_argument('--trace', type=int, default=0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / 'BENCHMARK.json').read_text())['run_seconds']
    seeds = [int(s) for s in args.seeds.split(',')]
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    sets = []
    for set_i in range(args.sets):
        rows = []
        for seed in seeds:
            cmd = [sys.executable, '-m', 'benchmark.run', '--workload', args.workload,
                   '--seed', str(seed), '--seconds', str(seconds), '--trace', str(args.trace)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1300)
            row = {'workload': args.workload, 'set': set_i, 'seed': seed, 'rc': proc.returncode,
                   'wall_s': time.perf_counter() - t0}
            lines = proc.stdout.strip().splitlines()
            try:
                row['result'] = json.loads(lines[-1])
            except (IndexError, ValueError):
                row['stderr'] = proc.stderr[-3000:]
            if proc.returncode:
                row['stderr'] = proc.stderr[-3000:]
            rows.append(row)
            if out:
                with open(out, 'a') as f:
                    f.write(json.dumps(row) + '\n')
            res = row.get('result', {})
            print(json.dumps({'set': set_i, 'seed': seed, 'rc': proc.returncode,
                              'wall_s': round(row['wall_s'], 1),
                              'correct': res.get('correct'),
                              'metrics': {k: v['value'] for k, v in res.get('metrics', {}).items()},
                              'checks': {k: v['value'] for k, v in res.get('checks', {}).items()},
                              'memory_peak_bytes': res.get('device', {}).get('memory_peak_bytes'),
                              'seconds': res.get('seconds')}),
                  flush=True)
            if 'stderr' in row:
                print(row['stderr'][-1500:], flush=True)
        sets.append(rows)
    for set_i, rows in enumerate(sets):
        names = sorted({k for r in rows for k in r.get('result', {}).get('metrics', {})})
        for name in names:
            vals = [r['result']['metrics'][name]['value'] for r in rows
                    if name in r.get('result', {}).get('metrics', {})]
            print(json.dumps({'set': set_i, 'metric': name, 'n': len(vals),
                              'median': statistics.median(vals), 'spread': spread(vals),
                              'values': vals}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
