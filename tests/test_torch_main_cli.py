"""The plain run's flags on the port (nnstreamer_tpu_torch/__main__.py)
against the JAX package's `main` (nnstreamer_tpu/__main__.py):
`--inspect`, `--inspect ELEMENT`, `--models`, `--broker [PORT]` with
`--bind`, `--profile DIR`, and a run with no pipeline.

`--inspect` prints the same elements, decoder modes, element headers,
property names and defaults as JAX's; the docs column is each package's
own text (the port's properties name cuda, JAX's the TPU), and
`tensor_trainer` has one property more on the port (`accelerator`).
`--models` prints the same zoo. `--profile` writes a torch.profiler
Chrome trace where JAX writes an xprof trace (ROADMAP N43).
"""

import contextlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from nnstreamer_tpu.__main__ import main as jax_main
from nnstreamer_tpu_torch.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
#: one property line of `--inspect ELEMENT`: name, default repr, doc
PROP = re.compile(r"^  (\S+) +default=(.*?)  (.*)$")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _out(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _listing(text):
    """`--inspect` → (element names, decoder modes)."""
    head, _, modes = text.partition("\ndecoder modes:\n")
    elems = [l.split()[0] for l in head.splitlines()[1:] if l.strip()]
    return elems, [l.strip() for l in modes.splitlines() if l.strip()]


def test_inspect_lists_jax_elements_and_decoder_modes():
    rc, ours = _out(main, ["--inspect"])
    jrc, theirs = _out(jax_main, ["--inspect"])
    assert rc == jrc == 0
    elems, modes = _listing(ours)
    assert (elems, modes) == _listing(theirs)
    assert "tensor_filter" in elems and "image_labeling" in modes
    assert elems == sorted(elems) and len(elems) > 40


def _props(text):
    lines = text.splitlines()
    props = lines[lines.index("properties:") + 1:]
    return lines[0], [PROP.match(l).groups()[:2] for l in props]


def test_inspect_element_headers_properties_and_defaults_equal_jax():
    _, listing = _out(main, ["--inspect"])
    for name in _listing(listing)[0]:
        rc, ours = _out(main, ["--inspect", name])
        jrc, theirs = _out(jax_main, ["--inspect", name])
        assert rc == jrc == 0
        head, props = _props(ours)
        jhead, jprops = _props(theirs)
        assert head == jhead == f"element {name} {head.split()[-1]}"
        if name == "tensor_trainer":
            assert ("accelerator", "''") in props
            props = [p for p in props if p[0] != "accelerator"]
        assert props == jprops, name


def test_inspect_tensor_filter_detail():
    rc, out = _out(main, ["--inspect", "tensor_filter"])
    assert rc == 0
    assert out.startswith("element tensor_filter (TensorFilter)")
    head, props = _props(out)
    assert ("framework", "''") in props and ("accelerator", "''") in props


def test_models_lists_the_jax_zoo():
    rc, ours = _out(main, ["--models"])
    jrc, theirs = _out(jax_main, ["--models"])
    assert rc == jrc == 0 and ours == theirs
    assert "zoo://mobilenet_v2" in ours.splitlines()


def test_no_pipeline_prints_help_and_exits_2(capsys):
    assert main([]) == 2
    assert "usage: nnstreamer_tpu_torch" in capsys.readouterr().out


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    rc = main(["--profile", str(out),
               "videotestsrc num-buffers=2 width=32 height=32 ! "
               "tensor_converter ! tensor_filter framework=pallas "
               "model=normalize_u8 ! tensor_sink"])
    assert rc == 0
    path = out / "trace.json"
    assert str(path) in capsys.readouterr().err
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert events and any(e.get("ph") == "X" for e in events)


def test_broker_runs_until_sigint_then_exits_0():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNSTREAMER_TPU_TORCH_")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "nnstreamer_tpu_torch", "--broker", "0",
         "--bind", "127.0.0.1"], cwd=ROOT, env=env, text=True,
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL)
    try:
        line = proc.stderr.readline()
        m = re.search(r"listening on 127\.0\.0\.1:(\d+) \(mqtt 3\.1\.1 on "
                      r":(\d+);", line)
        assert m, line
        for port in m.groups():
            with socket.create_connection(("127.0.0.1", int(port)), 5):
                pass
        time.sleep(0.2)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stderr.close()
