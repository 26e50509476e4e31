"""`python -m nnstreamer_tpu_torch serve` and `top` (JAX
`nnstreamer_tpu/__main__.py`'s subcommands on the port), on the CPU.

`serve --workers 2` (echo) with `--metrics-port 0`, `--slo` and
`--flight-dir`, driven by a port `tensor_query_client`; `top` against its
endpoint for one frame; SIGTERM drains it with rc 0 and no orphan worker.
The flags whose module is not ported yet — `--join`, `--join-name` and
`--zone` (Queue 1 item 4g) — are refused with a message naming the item,
before anything starts.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.serving.metrics import parse_prometheus, scrape
from nnstreamer_tpu_torch.serving.pool import proc_alive
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNSTREAMER_TPU_TORCH_")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _read_until(proc, pattern, timeout_s=90.0):
    """stderr lines of `proc` until one matches → (match, lines)."""
    lines = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(pattern, line)
        if m:
            return m, lines
    raise AssertionError(f"no {pattern!r} in serve's stderr: {lines}")


def test_serve_metrics_slo_top_and_sigterm_drain(tmp_path):
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"p99_budget_ms": 90,
                               "knobs": {"max_pending": {"min": 4,
                                                         "max": 256}}}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "nnstreamer_tpu_torch", "serve",
         "--workers", "2", "--service-ms", "1", "--metrics-port", "0",
         "--slo", str(slo), "--flight-dir", str(tmp_path / "flight")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        m, _ = _read_until(proc, r"metrics on (http://\S+/metrics)")
        url = m.group(1)
        _read_until(proc, r"flight recorder armed")
        m, _ = _read_until(proc, r"pool serving on [\d.]+:(\d+)")
        port = int(m.group(1))
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=8:1 types=float32 ! tensor_query_client "
            f"port={port} timeout=30 ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        xs = [np.full((1, 8), i, np.float32) for i in range(6)]
        for i, x in enumerate(xs):
            pipe.get("src").push(TensorBuffer.of(x, pts=i))
        pipe.get("src").end()
        runner.wait(60)
        runner.stop()
        res = pipe.get("out").results
        assert [r.pts for r in res] == list(range(6))
        for r, x in zip(res, xs):
            np.testing.assert_array_equal(np.asarray(r.tensors[0]), x)
        fams = parse_prometheus(scrape(url))
        assert fams["nns_admission_replied_total"]["samples"][
            "nns_admission_replied_total"] == 6.0
        assert fams["nns_pool_ready"]["samples"]["nns_pool_ready"] == 2.0
        assert "nns_autotune_dry_run" in fams
        # --metrics-port turns the device profiler on: its families
        # render (the echo pool's parent runs no model, so no rows)
        for fam in ("nns_jit_flops", "nns_invoke_mfu",
                    "nns_device_hbm_bytes"):
            assert fam in fams
        top = subprocess.run(
            [sys.executable, "-m", "nnstreamer_tpu_torch", "top", url,
             "--iterations", "1"], cwd=ROOT, env=_env(),
            capture_output=True, text=True, timeout=60)
        assert top.returncode == 0, top.stderr
        assert "nns_admission_replied_total" in top.stdout
        assert "nns_worker_replied_total" in top.stdout
        health = json.loads(scrape(url.replace("/metrics", "/healthz")))
        pids = []
        assert health["ok"] and health["pool"]["ready"] == 2
        for line in subprocess.run(
                ["ps", "-o", "pid=", "--ppid", str(proc.pid)],
                capture_output=True, text=True).stdout.split():
            pids.append(int(line))
        assert len(pids) >= 2              # the two workers at least
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert not any(proc_alive(p) for p in pids)


@pytest.mark.parametrize("flag,value,item", [
    ("--join", "127.0.0.1:1", "4g"),
    ("--join-name", "h0", "4g"),
    ("--zone", "z", "4g"),
])
def test_serve_refuses_flags_of_later_items(flag, value, item, capsys):
    from nnstreamer_tpu_torch.__main__ import main

    assert main(["serve", flag, value]) == 2
    err = capsys.readouterr().err
    assert f"Queue 1 item {item}" in err
    assert "pool serving" not in err


def test_top_needs_a_url():
    from nnstreamer_tpu_torch.__main__ import main

    assert main(["top"]) == 2
