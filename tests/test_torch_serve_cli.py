"""`python -m nnstreamer_tpu_torch serve`, `top`, `mesh` and `llm` (JAX
`nnstreamer_tpu/__main__.py`'s subcommands on the port), on the CPU.

`serve --workers 2` (echo) with `--metrics-port 0`, `--slo` and
`--flight-dir`, driven by a port `tensor_query_client`; `top` against its
endpoint for one frame; SIGTERM drains it with rc 0 and no orphan worker.
`serve --join` registers a pool with a `mesh --listen` router (both
subprocesses), which answers a frame through the pool and shows the host
on its /metrics; the `mesh` demo exits 0 at a small `--requests`; `llm`
prints one `done` line a request, its tokens those of the same
`tensor_llm` driven directly. `traffic` in its in-process modes (echo,
`--host`, `--trace`, `--flight-dir`, `--autotune`) exits as JAX's does
(`test_torch_loadgen.py` runs its pool modes); `scenario list` names
JAX's catalog, `scenario run` then `scenario replay` match
(`test_torch_scenario.py` runs `shrink`). `lint`, the last subcommand
that was refused (exit 2 naming its Queue 1 item), now runs
(`test_torch_lint.py` holds it to JAX's).
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


def _stop(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(30)


def test_serve_join_registers_with_mesh_listen_and_answers():
    router = pool = None
    try:
        router = subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch", "mesh",
             "--listen", "--lease-s", "2", "--metrics-port", "0"],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        m, _ = _read_until(router, r"metrics on (http://\S+/metrics)")
        url = m.group(1)
        m, _ = _read_until(router, r"mesh router on [\d.]+:(\d+)")
        rport = int(m.group(1))
        pool = subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch", "serve",
             "--workers", "1", "--service-ms", "1", "--join",
             f"127.0.0.1:{rport}", "--join-name", "h0", "--zone", "z1"],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        _read_until(pool, r"joined mesh router .* as 'h0'")
        _read_until(pool, r"pool serving on")
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=8:1 types=float32 ! tensor_query_client "
            f"port={rport} timeout=30 ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        x = np.arange(8, dtype=np.float32).reshape(1, 8)
        pipe.get("src").push(TensorBuffer.of(x, pts=0))
        pipe.get("src").end()
        runner.wait(60)
        runner.stop()
        (res,) = pipe.get("out").results
        np.testing.assert_array_equal(np.asarray(res.tensors[0]), x)
        fams = parse_prometheus(scrape(url))
        assert fams["nns_mesh_ready"]["samples"]["nns_mesh_ready"] == 1.0
        replied = fams["nns_host_replied_total"]["samples"]
        assert list(replied.values()) == [1.0]
        assert 'host="h0"' in next(iter(replied))
        pool.send_signal(signal.SIGTERM)
        assert pool.wait(60) == 0
        router.send_signal(signal.SIGTERM)
        assert router.wait(60) == 0
    finally:
        _stop(pool)
        _stop(router)


def test_mesh_demo_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch", "mesh",
         "--requests", "24", "--service-ms", "10", "--load-x", "1.2",
         "--lease-s", "0.8", "--max-redeliver", "2", "--json"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["offered"] == 24 and report["lost"] == 0
    assert report["conserved"]
    assert report["perhost_replied_sum"] == report["admission"]["replied"]
    assert report["orphans"] == []


def test_llm_prints_the_tokens_of_tensor_llm(monkeypatch, capsys):
    from nnstreamer_tpu_torch.__main__ import main
    from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
    from nnstreamer_tpu_torch.graph.pipeline import Pipeline
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNS_PAGED_KERNEL", "pallas")
    n, new, seed = 3, 4, 5
    assert main(["llm", "--requests", str(n), "--max-new-tokens",
                 str(new), "--seed", str(seed)]) == 0
    cli: dict = {}
    done = []
    for line in capsys.readouterr().out.splitlines():
        rid, _, rest = line.strip().partition("  ")
        toks, _, tail = rest.partition("   [")
        cli.setdefault(rid, []).extend(int(t) for t in toks.split())
        if tail.startswith("done"):
            done.append(rid)
    assert sorted(done) == [f"req{i}" for i in range(n)]

    # the same prompts through the same element, driven directly
    src = AppSrc(name="src", spec=TensorsSpec(
        tensors=(), format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(name="llm", max_new_tokens=new)
    sink = TensorSink(name="sink")
    pipe = Pipeline()
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    runner = tnns.PipelineRunner(pipe).start()
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = rng.integers(0, 256, size=int(rng.integers(1, 17)))
        src.push(TensorBuffer(
            tensors=(prompt.astype(np.int32),), pts=i,
            meta={"llm": {"request_id": f"req{i}", "seed": seed + i}}))
    src.end()
    runner.wait(120)
    runner.stop()
    direct: dict = {}
    for buf in sink.results:
        direct.setdefault(buf.meta["llm"]["request_id"], []).extend(
            int(t) for t in np.asarray(buf.tensors[0]))
    assert cli == direct
    assert all(len(v) == new for v in cli.values())


@pytest.mark.parametrize("cmd,item", [("lint", "5d")])
def test_unported_subcommands_exit_2_naming_their_item(cmd, item, capsys):
    """The refusal is gone with the last item that had one: `lint`
    (Queue 1 item 5d) runs instead of exiting 2 naming its item."""
    from nnstreamer_tpu_torch.__main__ import main

    assert main([cmd, "--list-rules"]) == 0
    cap = capsys.readouterr()
    assert f"Queue 1 item {item}" not in cap.err
    assert "not ported yet" not in cap.err and "NNL001" in cap.out


def _cli_json(capsys, argv):
    """main(argv) in this process → (exit code, the report it printed,
    stderr)."""
    from nnstreamer_tpu_torch.__main__ import main

    rc = main(argv)
    cap = capsys.readouterr()
    return rc, (json.loads(cap.out) if cap.out.strip() else None), cap.err


def test_traffic_echo_json_and_replay(monkeypatch, capsys):
    from nnstreamer_tpu_torch.traffic import replay_report

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    rc, rep, _ = _cli_json(capsys, [
        "traffic", "--requests", "40", "--load-x", "0.4",
        "--service-ms", "2", "--seed", "4", "--json"])
    assert rc == 0 and rep["lost"] == 0 and rep["offered"] == 40
    assert rep["completed"] == 40 and rep["seed"] == 4
    assert rep["schedule"]["kind"] == "echo"
    again = replay_report(rep)
    assert again["completed"] == 40 and again["admission"]["replied"] == \
        rep["admission"]["replied"]
    # overload: typed BUSY, nothing lost, the depth sparkline on stderr
    rc, rep, err = _cli_json(capsys, [
        "traffic", "--requests", "80", "--load-x", "4", "--service-ms",
        "4", "--max-pending", "4", "--pattern", "bursty"])
    assert rc == 0 and rep["lost"] == 0 and rep["rejected"] > 0
    assert rep["completed"] + rep["rejected"] == 80
    assert "queue_depth_timeline" not in rep    # drawn on stderr instead
    assert "queue depth (peak" in err


def test_traffic_host_mode_trace_and_flight_dir(monkeypatch, capsys,
                                                tmp_path):
    from nnstreamer_tpu_torch.traffic import EchoServer

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    assert _cli_json(capsys, ["traffic", "--host", "127.0.0.1"])[0] == 2
    srv = EchoServer(service_ms=1.0, dims="4:2", types="int16")
    try:
        rc, rep, err = _cli_json(capsys, [
            "traffic", "--host", "127.0.0.1", "--port", str(srv.port),
            "--dims", "4:2", "--types", "int16", "--rate", "200",
            "--requests", "30", "--trace", "--json"])
        assert rc == 0 and rep["lost"] == 0 and rep["completed"] == 30
        assert rep["traced_replies"] == 30 and rep["seed"] == 0
        assert srv.admission_counters()["replied"] == 30
    finally:
        srv.stop()
    # a budget nothing meets: the post-run scan dumps a flight bundle
    rc, rep, err = _cli_json(capsys, [
        "traffic", "--requests", "30", "--load-x", "0.5", "--service-ms",
        "2", "--budget-ms", "0.001", "--flight-dir", str(tmp_path),
        "--trace", "--json"])
    assert rc == 0 and "flight bundle dumped" in err
    assert list(tmp_path.iterdir())


def test_traffic_autotune_both_arms(monkeypatch, capsys):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    rc, rep, _ = _cli_json(capsys, [
        "traffic", "--autotune", "--autotune-dry-run", "--requests", "100",
        "--service-ms", "3", "--seed", "3", "--json"])
    assert rc == 0
    assert rep["static"]["lost"] == 0 and rep["tuned"]["lost"] == 0
    assert rep["tuned"]["dry_run"] and not rep["static"]["tuned"]
    assert rep["tuned"]["autotune"]["applied_total"] == 0
    assert rep["tuned"]["conservation_final"]


def test_scenario_list_names_jax(capsys):
    from nnstreamer_tpu.scenario import builtin_specs as jspecs
    from nnstreamer_tpu_torch.__main__ import main

    assert main(["scenario", "list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out[2:]] == list(jspecs())
    assert out[2].split()[1] == "pool(1x2w)"


def test_scenario_run_then_replay(monkeypatch, capsys, tmp_path):
    from nnstreamer_tpu_torch.__main__ import main

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "r.json"
    assert main(["scenario", "run", "smoke_pool", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "scenario 'smoke_pool' seed=7" in err and "OK" in err
    saved = json.loads(out.read_text())
    assert saved["check"]["ok"] and "traces" not in saved["report"]
    assert main(["scenario", "replay", str(out), "--out",
                 str(tmp_path / "r2.json")]) == 0
    assert "replay totals match" in capsys.readouterr().err
    assert json.loads((tmp_path / "r2.json").read_text())["replay_match"]


def test_top_needs_a_url():
    from nnstreamer_tpu_torch.__main__ import main

    assert main(["top"]) == 2
