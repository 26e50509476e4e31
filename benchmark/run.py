"""Run one cell of BENCHMARK.json on the card and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`--trace 0` reports the cell's end-to-end metrics; `--trace 1` profiles
a bounded steady sub-window and reports its per-layer metrics, the
device's busy and window seconds and the breakdown. Every run checks its
outputs against the plain reference and prints each compared number
beside its limit. The last line of standard output is the result, one
JSON object.

Exit codes: 0 with a result; 3 without a card (no result, never the
CPU); 4 when a module of `jax`, `jaxlib`, `flax` or `nnstreamer_tpu` was
loaded; any other failure raises (no result).
"""

from __future__ import annotations

import argparse
import faulthandler
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(run: dict, entries) -> dict:
    """Each metric's reader over the run; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = harness.load_metric(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    # a run ends within its allowance: past it, every thread's stack goes
    # to standard error and the process exits without a result
    faulthandler.dump_traceback_later(harness.RUN_LIMIT_S, exit=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    harness.cache_env()
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    import torch

    torch.set_num_threads(4)
    driver = harness.load_driver(cell.config["entry"])
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    checks = run["checks"]
    result = {
        "correct": all(v <= lim for _, v, lim in checks)
        and run["failed"] == 0,
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": metrics_of(run, cell.per_layer if args.trace
                              else cell.end_to_end),
        "device": dict(run["device"]),
    }
    if args.trace:
        tr = run["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
