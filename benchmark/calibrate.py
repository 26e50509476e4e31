"""Readings for the limits of `correct`: the program's compared numbers
over many seeds, and the control's (the reference in fp8, one step
below the configurations' bfloat16) on the same outputs, in one process.

    python benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [--first-seed <n>] [--control-seeds <k>]

Each seed is a whole run of the cell's driver at the cell's own size
and load, with a window of `--seconds` (long enough to finish the mix's
longest requests). One JSON line a seed, then a summary: for each
number the largest program reading (the lower end of its limit) and the
smallest control reading (the upper end). Runs only on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 17)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    driver = harness.load_driver(cell.config["entry"])
    prog, ctrl = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        rec = driver.run(cell, seed, args.seconds, False,
                         control=i < args.control_seeds)
        row = {"seed": seed, "failed": rec["failed"],
               "program": {n: v for n, v, _ in rec["checks"]},
               "control": rec["control"]}
        print(json.dumps(row), flush=True)
        for n, v, _ in rec["checks"]:
            prog[n] = max(prog.get(n, 0.0), v)
        for n, v in (rec["control"] or {}).items():
            ctrl[n] = min(ctrl.get(n, float("inf")), v)
        del rec
        gc.collect()
        if torch.cuda.is_available():
            print(f"held after the run: {torch.cuda.memory_allocated()} B",
                  file=sys.stderr)
    print(json.dumps({"summary": {"program_max": prog,
                                  "control_min": ctrl}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
