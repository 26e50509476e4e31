"""Pose (BASELINE config 3) on the port against the JAX package, on the
CPU.

- PoseNet (width 0.35, 129² input → 9² maps: TF SAME pads on odd sizes)
  on the same random parameters (models/bridge.py): heatmaps and offsets
  within 1e-4 of max |.|.
- pose_estimation host decode: image bytes and `keypoints` meta identical
  (the same numpy in both packages); `pose_decode_device` within 1e-6
  of the JAX program (keypoint cells equal).
- Pipeline P through parse_launch: uint8 ingest, the normalize and the
  clamp fused into the filter, host decode with max_in_flight 4 and
  device=true: keypoint cells equal, coordinates within 1e-3 px and
  scores within 1e-4 (the models differ in the last bits); the clamp runs
  once per frame through the clamp_scale wrapper (its plain version on
  the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
from nnstreamer_tpu.decoders import device as jdev
from nnstreamer_tpu.models import posenet as jp
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle as TBundle
from nnstreamer_tpu_torch.decoders import device as tdev
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import posenet as tp
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as TBuf

from test_torch_detection import random_params, run

WIDTH, SIZE, GRID, K = 0.35, 129, 9, 17
NORM = ("tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5")
CLAMP = "tensor_transform mode=clamp option=-1.0:1.0"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pose():
    params = random_params(jp.init_params, width=WIDTH)
    jb = JBundle(fn=lambda p, x: jp.apply(p, x, width=WIDTH,
                                          dtype=jnp.float32),
                 params=params, name="posenet")
    model = bridge.load_posenet(
        tp.PoseNet(width=WIDTH, dtype=torch.float32).eval(), params)
    return jb, TBundle(fn=lambda m, x: m(x), params=model, name="posenet")


def test_posenet_matches_jax(pose):
    jb, tb = pose
    x = np.random.default_rng(1).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = jax.jit(jb.fn)(jb.params, x)
    with torch.inference_mode():
        got = tb.params(torch.from_numpy(x))
    assert got[0].shape == (1, GRID, GRID, K)
    assert got[1].shape == (1, GRID, GRID, 2 * K)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def _maps(seed=0):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 1, (1, GRID, GRID, K)).astype(np.float32)
    off = (rng.standard_normal((1, GRID, GRID, 2 * K)) * 8).astype(np.float32)
    return hm, off


@pytest.mark.parametrize("with_offsets", [True, False])
def test_host_decode_matches_jax(with_offsets, tmp_path):
    labels = tmp_path / "kp.txt"
    labels.write_text("\n".join(f"kp{i}" for i in range(K)))
    hm, off = _maps()
    tensors = (hm, off) if with_offsets else (hm,)
    dims = "17:9:9:1,34:9:9:1" if with_offsets else "17:9:9:1"
    desc = (f"appsrc name=src dims={dims} types=float32 ! tensor_decoder "
            f"mode=pose_estimation option1=200:160 option2=129:129 "
            f"option3={labels} option4=0.2 ! tensor_sink name=out")
    (ref,) = run(jnns, JBuf, desc, [tensors])
    (got,) = run(tnns, TBuf, desc, [tensors])
    assert got.tensors[0].shape == (160, 200, 4)
    np.testing.assert_array_equal(got.tensors[0], np.asarray(ref.tensors[0]))
    np.testing.assert_array_equal(got.meta["keypoints"],
                                  ref.meta["keypoints"])


@pytest.mark.parametrize("in_size", [0, 129])
def test_pose_decode_device_matches_jax(in_size):
    hm, off = _maps(1)
    hm[0, 3, 4, :5] = hm[0, 6, 2, :5] = 2.0      # ties: first cell wins
    ref = np.asarray(jdev.pose_decode_device(hm, off, in_h=in_size,
                                             in_w=in_size))
    got = tdev.pose_decode_device(torch.from_numpy(hm), torch.from_numpy(off),
                                  in_h=in_size, in_w=in_size).numpy()
    assert got.shape == ref.shape == (K, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


MODES = {"host": "max_in_flight=4", "device": "device=true option2=129:129"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_p_matches_jax(pose, mode):
    desc = (f"appsrc name=src dims=3:{SIZE}:{SIZE}:1 types=uint8 ! {NORM} ! "
            f"{CLAMP} ! tensor_filter name=f ! tensor_decoder "
            f"mode=pose_estimation option1={SIZE}:{SIZE} option4=0.0 "
            f"{MODES[mode]} ! tensor_sink name=out")
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (1, SIZE, SIZE, 3), np.uint8)
              for _ in range(3)]
    ref = run(jnns, JBuf, desc, frames, pose[0])
    calls = []
    real = kernels.clamp_scale_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    kernels.clamp_scale_plain = counted
    try:
        got = run(tnns, TBuf, desc, frames, pose[1])
    finally:
        kernels.clamp_scale_plain = real
    assert calls == [(1, SIZE, SIZE, 3)] * len(frames)
    assert len(got) == len(ref) == len(frames)
    for r, g in zip(ref, got):
        rk = np.asarray(r.meta["keypoints"] if mode == "host"
                        else r.tensors[0])
        gk = g.meta["keypoints"] if mode == "host" else g.tensors[0]
        assert gk.shape == rk.shape == (K, 3)
        # the same heatmap cell: the offsets move a point by < 1 cell
        cell = SIZE / GRID
        np.testing.assert_array_equal(np.floor(gk[:, :2] / cell + 0.5),
                                      np.floor(rk[:, :2] / cell + 0.5))
        np.testing.assert_allclose(gk[:, :2], rk[:, :2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(gk[:, 2], rk[:, 2], atol=1e-4, rtol=0)
        if mode == "host":
            assert g.tensors[0].shape == (SIZE, SIZE, 4)
