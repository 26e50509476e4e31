"""On the card only (marked `cuda`; the `card` fixture skips them where
there is none): each cell runs through the command and comes out
correct with a result line of the contract's keys.

    python -m pytest benchmark/tests -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_each_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 5), "--seconds", "20", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=340)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert result["correct"] and result["device"]["platform"] == "gpu"
