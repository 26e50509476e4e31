"""The committed TFLite files of nnstreamer_tpu_torch/tools/data/ (written
by tools/tflite_tf_fixtures.py with TensorFlow, which the card's machine
lacks; chip_smoke.py phase 38 runs them there) through the port against
the JAX package's loader, on the CPU, f32:

- the breadth models within atol 1e-4 / rtol 1e-4 (the JAX tests'
  `_golden_vs_interpreter` rule);
- the TFLite_Detection_PostProcess head: the same detection count and
  classes, boxes within 1e-4, scores within 1e-5, the zero padding past
  the count bit for bit;
- the keras LSTM's WHILE graph within 1e-5.

The files are the ones the tool writes: re-running it rewrites them
(the LSTM's keras weights are seeded, so they come out the same).
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.modelio import load_model_file, parse_tflite
from nnstreamer_tpu_torch.tools import tflite_tf_fixtures as tff

FILES = {k: str(tff.DATA / v) for k, v in tff.FILES.items()}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def port_run(path, *xs):
    m = load_model_file(path, compute_dtype="float32")
    with torch.inference_mode():
        return [t.numpy() for t in m.fn(m.params,
                                        *(torch.from_numpy(x) for x in xs))]


def jax_run(path, *xs):
    import jax
    from nnstreamer_tpu.modelio import load_model_file as jload

    m = jload(path, compute_dtype="float32")
    return [np.asarray(t) for t in jax.jit(m.fn)(m.params, *xs)]


def test_committed_files_are_small_tflite():
    for path in FILES.values():
        data = open(path, "rb").read()
        assert data[4:8] == b"TFL3" and len(data) < 64 * 1024
    assert len(parse_tflite(FILES["lstm"]).subgraphs) == 3


@pytest.mark.parametrize("name,shape", [("elementwise", (2, 8)),
                                        ("spatial", (1, 4, 4, 8))])
def test_committed_breadth_models_match_jax(name, shape):
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    ours, ref = port_run(FILES[name], x), jax_run(FILES[name], x)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-4)


def detection_case(seed):
    N, C = tff.DETECT_N, tff.DETECT_C
    rng = np.random.default_rng(seed)
    be = rng.normal(0, 0.5, (1, N, 4)).astype(np.float32)
    sc = rng.uniform(0, 0.25, (1, N, C + 1)).astype(np.float32)
    for i in rng.choice(N, 6, replace=False):
        sc[0, i, rng.integers(1, C + 1)] = rng.uniform(0.6, 0.99)
    return be, sc


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_committed_detect_custom_op_matches_jax(seed):
    be, sc = detection_case(seed)
    ours, ref = port_run(FILES["detect"], be, sc), \
        jax_run(FILES["detect"], be, sc)
    nd = int(ref[3][0])
    assert int(ours[3][0]) == nd > 0
    np.testing.assert_allclose(ours[0][0][:nd], ref[0][0][:nd], atol=1e-4)
    np.testing.assert_array_equal(ours[1][0][:nd], ref[1][0][:nd])
    np.testing.assert_allclose(ours[2][0][:nd], ref[2][0][:nd], atol=1e-5)
    np.testing.assert_array_equal(ours[2][0][nd:], ref[2][0][nd:])


def test_committed_lstm_while_matches_jax():
    x = np.random.default_rng(5).normal(0, 1, (1, 8, 6)).astype(np.float32)
    (ours,), (ref,) = port_run(FILES["lstm"], x), jax_run(FILES["lstm"], x)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
