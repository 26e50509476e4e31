"""The port stands alone: it imports neither jax nor the JAX package, and
it never runs on the CPU unless asked to.

The import check runs in a subprocess: this test process has jax loaded
already (tests/conftest.py imports it first).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nnstreamer_tpu_torch.backends.base import pick_device
from nnstreamer_tpu_torch.core.errors import BackendError, NegotiationError

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nnstreamer_tpu_torch"
TINY = ("videotestsrc num-buffers=2 width=32 height=32 ! tensor_converter ! "
        "{norm} ! tensor_filter model=zoo://mobilenet_v2?width=0.35&"
        "input_size=32 ! tensor_decoder mode=image_labeling ! tensor_sink "
        "name=out")
NORM_A = ("tensor_transform mode=arithmetic "
          "option=typecast:float32,add:-127.5,div:127.5")
NORM_B = "tensor_filter framework=pallas model=normalize_u8"


#: appsrc ! tensor_llm ! tensor_sink on the zoo transformer, kernel path
LLM = """
import numpy as np
from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec
src = AppSrc(spec=TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE))
llm = TensorLLM(paged_kernel="pallas", prefill_chunk=4, max_new_tokens=3)
sink = TensorSink()
pipe = nt.Pipeline()
for e in (src, llm, sink):
    pipe.add(e)
pipe.link(src, llm)
pipe.link(llm, sink)
runner = nt.PipelineRunner(pipe).start()
src.push(np.arange(1, 7, dtype=np.int32))
src.end()
runner.wait(120)
runner.stop()
assert sum(len(b.tensors[0]) for b in sink.results) == 3
"""


def _forbidden(name: str) -> bool:
    # exact names: nnstreamer_tpu_torch shares the nnstreamer_tpu prefix
    return name in ("jax", "nnstreamer_tpu") or name.startswith(
        ("jax.", "nnstreamer_tpu."))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNSTREAMER_TPU_TORCH_")}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_runs_without_jax_or_the_jax_package():
    code = f"""
import sys, torch
torch.set_num_threads(2)
import nnstreamer_tpu_torch as nt
for norm in ({NORM_A!r}, {NORM_B!r}):
    pipe = nt.parse_launch({TINY!r}.format(norm=norm))
    nt.PipelineRunner(pipe).run(120)
    assert len(pipe.get("out").results) == 2
{LLM}
import nnstreamer_tpu_torch.models.quant
import nnstreamer_tpu_torch.parallel.ring_attention
import nnstreamer_tpu_torch.edge
import nnstreamer_tpu_torch.parallel.dispatch
import nnstreamer_tpu_torch.serving.compile_cache
import nnstreamer_tpu_torch.serving.tenancy
import nnstreamer_tpu_torch.traffic
import nnstreamer_tpu_torch.serving.shm
import nnstreamer_tpu_torch.serving.worker
import nnstreamer_tpu_torch.serving.pool
import nnstreamer_tpu_torch.serving.metrics
import nnstreamer_tpu_torch.serving.autotune
import nnstreamer_tpu_torch.serving.placement
import nnstreamer_tpu_torch.serving.sharding
import nnstreamer_tpu_torch.runtime.devprof
import nnstreamer_tpu_torch.runtime.flightrec
import nnstreamer_tpu_torch.parallel.mesh
import nnstreamer_tpu_torch.elements
import nnstreamer_tpu_torch.interop.grpc_elements
import nnstreamer_tpu_torch.trainer.element
import nnstreamer_tpu_torch.parallel.train
import nnstreamer_tpu_torch.parallel
import nnstreamer_tpu_torch.parallel.pipeline
import nnstreamer_tpu_torch.parallel.moe
import nnstreamer_tpu_torch.parallel.multihost
import nnstreamer_tpu_torch.parallel.dryrun
import nnstreamer_tpu_torch.tools.multihost_check
bad = [m for m in sys.modules if m in ("jax", "nnstreamer_tpu")
       or m.startswith(("jax.", "nnstreamer_tpu."))]
assert not bad, bad
print("ISOLATED")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=_env(NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def test_cli_runs_a_pipeline_string():
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch",
         TINY.format(norm=NORM_B), "--timeout", "120"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=_env(NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR="cpu",
                 OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


#: the modules of the placement, segment and profiler slice: the scan above
#: must reach each of them
SLICE_MODULES = ("serving/placement.py", "serving/sharding.py",
                 "parallel/mesh.py", "parallel/dispatch.py",
                 "graph/optimize.py", "runtime/devprof.py",
                 "runtime/flightrec.py", "runtime/sync.py",
                 "backends/torch_backend.py", "elements/filter.py",
                 "__main__.py")


#: the modules of the rest of parallel/ and the multi-host check's
#: worker script: the scan above must reach each of them
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/dispatch.py",
                    "parallel/train.py", "parallel/pipeline.py",
                    "parallel/moe.py", "parallel/multihost.py",
                    "parallel/dryrun.py", "tools/multihost_check.py",
                    "trainer/element.py", "edge/query.py")


@pytest.mark.parametrize("rel", SLICE_MODULES + PARALLEL_MODULES)
def test_scan_covers_the_placement_and_profiler_modules(rel):
    path = PORT / rel
    assert path in sorted(PORT.rglob("*.py"))
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR",
                       raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendError, match="accelerator=cpu"):
        pick_device("")
    with pytest.raises(BackendError, match="no CUDA device"):
        pick_device("cuda:0")
    import nnstreamer_tpu_torch as nt

    pipe = nt.parse_launch(TINY.format(norm=NORM_B))
    with pytest.raises(NegotiationError, match="accelerator=cpu"):
        nt.PipelineRunner(pipe).start()


def test_cpu_runs_only_when_asked(monkeypatch):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR",
                       raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pick_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    assert pick_device("") == torch.device("cpu")
    with pytest.raises(BackendError, match="not a device"):
        pick_device("tpu")


#: a python3 filter that answers with what its own process has imported:
#: [number of jax / JAX-package modules, torch imported]
_MODULES_PROBE = """
import sys
import numpy as np
import nnstreamer_python as nns


class CustomFilter:
    def __init__(self, *args):
        pass

    def getInputDim(self):
        return [nns.TensorShape([8, 1], np.float32)]

    def getOutputDim(self):
        return [nns.TensorShape([2], np.int32)]

    def invoke(self, xs):
        bad = [m for m in sys.modules if m in ("jax", "nnstreamer_tpu")
               or m.startswith(("jax.", "nnstreamer_tpu."))]
        return [np.array([len(bad), int("torch" in sys.modules)],
                         np.int32)]
"""


def test_pool_worker_child_imports_no_jax(tmp_path, monkeypatch):
    """A spawned pool worker is a port process: the pipeline it runs
    reports its own sys.modules, which hold torch and nothing of jax or
    the JAX package (this test process has both loaded)."""
    import numpy as np

    from nnstreamer_tpu.edge import protocol as JP
    from nnstreamer_tpu.edge import wire as jwire
    from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
    from nnstreamer_tpu_torch.serving.pool import (
        PooledQueryServer, proc_alive)
    from nnstreamer_tpu_torch.serving.worker import WorkerSpec

    import json
    import threading

    assert "jax" in sys.modules           # the parent has it
    script = tmp_path / "modules_probe.py"
    script.write_text(_MODULES_PROBE)
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    pqs = PooledQueryServer(
        WorkerSpec(kind="pipeline", dims="8:1", types="float32",
                   pipeline=f"tensor_filter framework=python3 "
                            f"model={script}"),
        workers=1, sid=19900, ready_timeout_s=60.0)
    got = {}
    done = threading.Event()

    def on(mtype, payload):
        if mtype == JP.T_RESULT:
            got["buf"], _ = jwire.decode_buffer(payload)
            done.set()
        elif mtype != JP.T_HELLO_ACK:
            done.set()

    try:
        cli = JP.MsgClient("127.0.0.1", pqs.port, on_message=on)
        try:
            cli.send(JP.T_HELLO, json.dumps(
                {"dims": "8:1", "types": "float32"}).encode())
            cli.send(JP.T_DATA, jwire.encode_buffer(
                JBuffer.of(np.ones((1, 8), np.float32), pts=0)))
            assert done.wait(60)
        finally:
            cli.close()
        n_bad, has_torch = np.asarray(got["buf"].tensors[0]).tolist()
        assert (n_bad, has_torch) == (0, 1)
    finally:
        pids = pqs.pool.all_pids_ever()
        pqs.close()
    assert not any(proc_alive(p) for p in pids)


#: the serving mesh's modules (the router and host agent, the chaos proxy,
#: the mesh half of the load generator): the scan above must reach each
MESH_MODULES = ("serving/mesh.py", "traffic/netchaos.py",
                "traffic/loadgen.py", "traffic/__init__.py", "edge/wire.py")


@pytest.mark.parametrize("rel", MESH_MODULES)
def test_scan_covers_the_mesh_modules(rel):
    path = PORT / rel
    assert path in sorted(PORT.rglob("*.py"))
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


#: the load generator's drills, the scenario engine and MQTT (the codec,
#: the broker's listener, the pub/sub and MQTT elements): the scan above
#: must reach each
TRAFFIC_MQTT_MODULES = (
    "scenario/__init__.py", "scenario/spec.py", "scenario/checker.py",
    "scenario/shrink.py", "scenario/executor.py", "edge/mqtt_wire.py",
    "edge/broker.py", "edge/pubsub.py", "elements/mqtt.py",
    "__main__.py")


@pytest.mark.parametrize("rel", TRAFFIC_MQTT_MODULES)
def test_scan_covers_the_traffic_and_mqtt_modules(rel):
    path = PORT / rel
    assert path in sorted(PORT.rglob("*.py"))
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


#: the interop codecs and gRPC elements, the trainer and the one-device
#: train step: the scan above must reach each
INTEROP_TRAINER_MODULES = (
    "interop/__init__.py", "interop/gst_meta.py", "interop/_codec_base.py",
    "interop/tensors_proto.py", "interop/protobuf_codec.py",
    "interop/flatbuf_build.py", "interop/flatbuf_codec.py",
    "interop/flexbuf_write.py", "interop/flexbuf_codec.py",
    "interop/grpc_elements.py", "trainer/__init__.py",
    "trainer/element.py", "parallel/train.py")


@pytest.mark.parametrize("rel", INTEROP_TRAINER_MODULES)
def test_scan_covers_the_interop_and_trainer_modules(rel):
    path = PORT / rel
    assert path in sorted(PORT.rglob("*.py"))
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
