"""The port's multi-host runtime (parallel/multihost.py) against the
JAX package's tests/test_multihost.py, on the CPU.

Two OS processes run `nnstreamer_tpu_torch/tools/multihost_check.py`
against a localhost rendezvous, ``gloo`` named, 4 logical CPU devices
each → a dp=8 global mesh: a cross-process sum (exact), then one
`make_train_step` over the mesh whose gradient sum spans both
processes, held to the serial numpy step on the whole batch within
1e-5 (JAX's test's own check). Then the one-process fallback, a
global batch gathered back, and the backend refused where it cannot
run (``nccl`` without a card: never a silent switch to ``gloo``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.parallel import multihost
from nnstreamer_tpu_torch.parallel.mesh import MeshSpec

ROOT = Path(__file__).resolve().parents[1]
CHECK = ROOT / "nnstreamer_tpu_torch" / "tools" / "multihost_check.py"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)


def test_two_process_global_mesh_and_train_step():
    from conftest import free_port

    coord = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNSTREAMER_TPU_TORCH_")}
    env.update(NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR="cpu",
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(CHECK), str(pid), coord, "--backend", "gloo",
         "--devices", "4"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert {o["pid"] for o in outs} == {0, 1}
    for o in outs:
        assert o["sum"] == 12.0
        assert o["err"] < 1e-5
        assert o["backend"] == "gloo" and o["jax_free"]
        assert len(o["devices"]) == 8
    # both processes computed the identical global loss
    assert outs[0]["loss"] == outs[1]["loss"]


def test_single_process_fallback():
    assert multihost.initialize() is False
    assert multihost.process_count() == 1
    mesh = multihost.global_mesh(MeshSpec(dp=4, tp=2))
    assert mesh.shape["dp"] == 4 and mesh.shape["tp"] == 2
    assert not mesh.processes.any()


def test_batch_and_fetch_in_one_process():
    mesh = multihost.global_mesh(MeshSpec(dp=8))
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    gx = multihost.host_local_batch(mesh, x)
    assert gx.shape == (8, 2)
    np.testing.assert_array_equal(multihost.fetch_replicated(gx), x)
    np.testing.assert_array_equal(
        multihost.fetch_replicated(torch.from_numpy(x) * 2), x * 2)


def test_backend_is_named_never_guessed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PipelineError, match="gloo"):
        multihost.initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(PipelineError, match="backend"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend="mpi")
    with pytest.raises(PipelineError, match="PROCESS_ID"):
        multihost.initialize("127.0.0.1:1", 2)
