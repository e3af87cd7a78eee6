"""One run of one benchmark cell on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Exits non-zero, printing no result, without a
card, or if a module of the JAX package or of JAX is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from . import harness
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print('benchmark: no CUDA device; a run needs one card', file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f'benchmark: loaded in this process: {", ".join(found)}', file=sys.stderr)
        return 4
    for key, c in out['checks'].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
