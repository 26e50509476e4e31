"""Spreads of a cell's runs, as the bounds are set from them.

    python benchmark/spread.py 'chiprun_out/sets/<cell>/A_*.out' \
        'chiprun_out/sets/<cell>/B_*.out'

For each set of result files (each run's standard output; its last line
the result): every metric's median and spread — the distance between
the first and third quartiles (`statistics.quantiles(values, n=4)`) as
a share of the median — the spread with the run farthest from the
median left out, and the compared numbers' largest reading.
"""

from __future__ import annotations

import glob
import json
import statistics
import sys


def result(path: str):
    lines = open(path).read().strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values) -> list:
    """`values` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv) -> int:
    for i, pattern in enumerate(argv):
        runs = [r for r in map(result, sorted(glob.glob(pattern))) if r]
        print(f"set {i} ({pattern}): {len(runs)} runs, correct "
              f"{[r['correct'] for r in runs]}")
        for name in sorted({k for r in runs for k in r["metrics"]}):
            v = [r["metrics"][name]["value"] for r in runs
                 if name in r["metrics"]]
            if len(v) < 3:
                continue
            print(f"  {name}: median {statistics.median(v)!r} spread "
                  f"{spread(v):.4%} trimmed {spread(trimmed(v)):.4%}")
        for name in sorted({k for r in runs for k in r.get("checks", {})}):
            v = [r["checks"][name]["value"] for r in runs]
            print(f"  check {name}: largest {max(v)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
