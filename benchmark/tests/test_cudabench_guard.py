"""The import guard (top-level names compared whole), what a run's
process loads, and the command's refusals where there is no card or no
program."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_forbidden_names_are_compared_whole():
    names = ["nnstreamer_tpu_torch", "nnstreamer_tpu_torch.llm.engine",
             "jax_like", "numpy", "flaxen"]
    assert harness.forbidden_loaded(names) == []
    bad = ["nnstreamer_tpu", "nnstreamer_tpu.graph", "jax", "jax.numpy",
           "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_loaded(names + bad) == sorted(bad)


def test_a_runs_modules_load_no_jax():
    """Everything the command imports, the port's pipeline, LLM and
    filter paths included, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, readers, run, calibrate\n"
        "from benchmark.drivers import pipeline_vision, pipeline_llm\n"
        "import nnstreamer_tpu_torch as nt\n"
        "import nnstreamer_tpu_torch.elements\n"
        "from nnstreamer_tpu_torch.llm import engine\n"
        "from nnstreamer_tpu_torch.backends import llm_exec, paged_attn, "
        "torch_backend\n"
        "nt.parse_launch('appsrc name=src dims=3:8:8:1 types=uint8 ! "
        "tensor_converter ! tensor_sink name=out')\n"
        "print(harness.forbidden_loaded())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mbv2.video_file", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_no_card_means_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out)


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
