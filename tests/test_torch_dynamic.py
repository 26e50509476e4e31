"""FLEXIBLE invokes in the port (tensor_crop → tensor_filter
invoke-dynamic=true, the torch backend's invoke_flexible) held to the
JAX package's on the same regions, on the CPU (from
tests/test_dynamic_shapes.py; its crop → tensor_resize static path is
in tests/test_torch_resize.py). The port compiles nothing: its `bucket_shapes` (the
distinct bucket shapes run) is held equal to JAX's `compile_count`."""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
from nnstreamer_tpu.backends.xla import XLABackend
from nnstreamer_tpu.core.errors import NegotiationError as JNegotiationError
from nnstreamer_tpu.core.errors import PipelineError as JPipelineError
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorFormat as JFormat
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.backends.torch_backend import (
    ModelBundle, TorchBackend)
from nnstreamer_tpu_torch.core.errors import NegotiationError, PipelineError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorInfo, TensorsSpec

W = np.linspace(-1, 1, 3 * 5, dtype=np.float32).reshape(3, 5)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _poly_sum_bundles():
    """A shape-polymorphic, padding-invariant toy model in both packages
    with the same weights: spatial sum → a fixed 5-dim projection, so
    zero-padding H and W does not change the output."""
    import jax.numpy as jnp

    def jfn(params, x):
        return jnp.sum(x.astype(jnp.float32), axis=(-3, -2)) @ params["w"]

    def tfn(params, x):
        return x.to(torch.float32).sum(dim=(-3, -2)) @ params["w"]

    return (JBundle(fn=jfn, params={"w": W}, name="poly_sum"),
            ModelBundle(fn=tfn, params={"w": torch.from_numpy(W)},
                        name="poly_sum"))


def _backends(custom=""):
    jb, tbd = _poly_sum_bundles()
    j, t = XLABackend(), TorchBackend()
    j.open({"model": jb, "custom": custom})
    t.open({"model": tbd, "custom": custom})
    return j, t


def _regions(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, s).astype(np.uint8) for s in shapes]


def _expect(r):
    return r.astype(np.float32).sum((-3, -2)) @ W


def _same(j, t, regions):
    ref = j.invoke_flexible(list(regions))
    got = t.invoke_flexible(list(regions))
    assert len(got) == len(ref) == len(regions)
    for r, g, x in zip(ref, got, regions):
        assert tuple(g.shape) == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), _expect(x), rtol=1e-5)
    assert len(t.bucket_shapes) == j.compile_count


def test_invoke_flexible_batches_same_shape_regions():
    j, t = _backends()
    _same(j, t, _regions([(1, 8, 8, 3)] * 3))
    assert t.bucket_shapes == {("bat", 4, 1, 8, 8, 3)}
    _same(j, t, _regions([(1, 8, 8, 3)] * 2))      # batch bucket 2: new
    assert len(t.bucket_shapes) == 2
    _same(j, t, _regions([(1, 8, 8, 3)] * 4))
    _same(j, t, _regions([(1, 8, 8, 3)] * 3))      # 3 pads into 4
    assert len(t.bucket_shapes) == 2
    # mixed shapes in one buffer: one group each, outputs in order
    _same(j, t, _regions([(1, 8, 8, 3), (1, 5, 7, 3), (1, 8, 8, 3)], 4))
    assert len(t.bucket_shapes) == 3     # (1, 5, 7, 3) alone: new


def test_invoke_flexible_stacks_regions_without_leading_one():
    j, t = _backends()
    _same(j, t, _regions([(6, 6, 3)] * 3, seed=2))
    assert t.bucket_shapes == {("bat", 4, 6, 6, 3)}


def test_invoke_flexible_spatial_bucketing():
    j, t = _backends("dynamic_spatial=true")
    _same(j, t, _regions([(1, 20, 30, 3)]))
    n0 = len(t.bucket_shapes)
    _same(j, t, _regions([(1, 25, 31, 3)]))       # also 32 x 32
    assert len(t.bucket_shapes) == n0
    _same(j, t, _regions([(1, 50, 60, 3)]))       # 64 x 64: one more
    assert len(t.bucket_shapes) == n0 + 1
    _same(j, t, _regions([(1, 17, 9, 3)], seed=3))
    assert ("bat", 1, 1, 32, 16, 3) in t.bucket_shapes


def test_invoke_flexible_bucket_set_bounded():
    """Many crop sizes, a bounded set of bucket shapes: every H and W
    from 5 to 64 lands in {16, 32, 64}, so at most 9 spatial buckets
    (times the batch buckets seen), whatever the sizes."""
    j, t = _backends("dynamic_spatial=true")
    rng = np.random.default_rng(5)
    for i in range(12):
        n = int(rng.integers(1, 4))
        h, w = (int(v) for v in rng.integers(5, 65, 2))
        _same(j, t, _regions([(1, h, w, 3)] * n, seed=i))
    spatial = {(k[3], k[4]) for k in t.bucket_shapes}
    assert spatial <= {(a, b) for a in (16, 32, 64) for b in (16, 32, 64)}
    assert {k[1] for k in t.bucket_shapes} <= {1, 2, 4}
    assert len(t.bucket_shapes) <= 27


def test_invoke_flexible_sequential_for_fixed_batch_model():
    """A model with a baked-in batch refuses the batched shape on the
    meta device; regions then run one by one."""
    import jax.numpy as jnp

    def jrigid(params, x):
        assert x.shape[0] == 1, "batch is baked in"
        return jnp.sum(x.astype(jnp.float32), axis=(1, 2))

    def trigid(params, x):
        assert x.shape[0] == 1, "batch is baked in"
        return x.to(torch.float32).sum(dim=(1, 2))

    j, t = XLABackend(), TorchBackend()
    j.open({"model": JBundle(fn=jrigid, params=None), "custom": ""})
    t.open({"model": ModelBundle(fn=trigid, params=None), "custom": ""})
    regions = _regions([(1, 4, 4, 3)] * 3)
    ref = j.invoke_flexible(list(regions))
    got = t.invoke_flexible(list(regions))
    assert len(got) == 3 and tuple(got[0].shape) == (1, 3)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert t.bucket_shapes == {("seq", 1, 4, 4, 3)}
    assert len(t.bucket_shapes) == j.compile_count


def _crop_pipeline(kind, **filter_props):
    if kind == "jax":
        pkg, el, buf, dt, spec = jnns, jel, JBuffer, JDType, JSpec
        info_cls, bundle = JInfo, _poly_sum_bundles()[0]
    else:
        pkg, el, buf, dt, spec = tnns, tel, TensorBuffer, DType, TensorsSpec
        info_cls, bundle = TensorInfo, _poly_sum_bundles()[1]
    src = el.AppSrc(spec=spec.of(info_cls((1, 16, 16, 3), dt.UINT8)),
                    name="raw")
    info = el.AppSrc(spec=spec.of(info_cls((2, 4), dt.UINT32)), name="info")
    crop = el.TensorCrop(name="c")
    filt = el.TensorFilter(name="f", model=bundle, **filter_props)
    sink = el.TensorSink(name="s")
    pipe = pkg.Pipeline()
    for e in (src, info, crop, filt, sink):
        pipe.add(e)
    pipe.link(src, crop, 0, 0)
    pipe.link(info, crop, 0, 1)
    pipe.link(crop, filt)
    pipe.link(filt, sink)
    return pkg, pipe, buf


IMG = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(1, 16, 16, 3)
REGIONS = [np.array([[2, 1, 4, 3], [0, 0, 8, 8]], np.uint32),
           np.array([[3, 3, 9, 5], [1, 2, 5, 9]], np.uint32),
           np.array([[0, 0, 16, 16], [15, 15, 4, 4]], np.uint32)]


def _run_crop(kind):
    pkg, pipe, buf = _crop_pipeline(
        kind, invoke_dynamic="true", custom="dynamic_spatial=true")
    runner = pkg.PipelineRunner(pipe).start()
    for i, reg in enumerate(REGIONS):
        pipe.get("raw").push(buf.of(IMG, pts=i))
        pipe.get("info").push(buf.of(reg, pts=i))
    pipe.get("raw").end()
    pipe.get("info").end()
    runner.wait(60)
    runner.stop()
    return pipe.get("s").results, pipe.get("f")


def test_crop_filter_invoke_dynamic_pipeline_matches_jax():
    ref, jf = _run_crop("jax")
    got, tf = _run_crop("torch")
    assert len(got) == len(ref) == len(REGIONS)
    for r, g, reg in zip(ref, got, REGIONS):
        assert g.format == TensorFormat.FLEXIBLE
        assert r.format == JFormat.FLEXIBLE and g.pts == r.pts
        assert len(g.tensors) == len(r.tensors) == 2
        for (x, y, w, h), rt, gt in zip(reg, r.tensors, g.tensors):
            patch = IMG[:, y:y + h, x:x + w]
            np.testing.assert_allclose(np.asarray(gt), np.asarray(rt),
                                       rtol=1e-5)
            np.testing.assert_allclose(
                np.asarray(gt), patch.astype(np.float32).sum((1, 2)) @ W,
                rtol=1e-5)
    assert len(tf.backend.bucket_shapes) == jf.backend.compile_count


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_flexible_without_invoke_dynamic_fails_actionably(kind):
    pkg, pipe, _ = _crop_pipeline(kind)
    with pytest.raises((NegotiationError, PipelineError, JNegotiationError,
                        JPipelineError), match="invoke.dynamic|tensor_resize"):
        pkg.PipelineRunner(pipe).start()


def test_crop_geometry_matches_jax():
    """tensor_crop alone: the same regions out of the same frame, the
    out-of-frame region clipped the same way; the older of two frames
    whose pts lie beyond `lateness` is dropped."""
    outs = {}
    for kind in ("jax", "torch"):
        pkg, el, buf = (jnns, jel, JBuffer) if kind == "jax" else \
            (tnns, tel, TensorBuffer)
        spec = (JSpec.of(JInfo((16, 16, 3), JDType.UINT8)),
                JSpec.of(JInfo((2, 4), JDType.UINT32))) if kind == "jax" \
            else (TensorsSpec.of(TensorInfo((16, 16, 3), DType.UINT8)),
                  TensorsSpec.of(TensorInfo((2, 4), DType.UINT32)))
        raw = el.AppSrc(spec=spec[0], name="raw")
        info = el.AppSrc(spec=spec[1], name="info")
        crop = el.TensorCrop(name="c", lateness=10)
        sink = el.TensorSink(name="s")
        pipe = pkg.Pipeline()
        for e in (raw, info, crop, sink):
            pipe.add(e)
        pipe.link(raw, crop, 0, 0)
        pipe.link(info, crop, 0, 1)
        pipe.link(crop, sink)
        runner = pkg.PipelineRunner(pipe).start()
        raw.push(buf.of(IMG[0], pts=0))
        raw.push(buf.of(IMG[0] + 1, pts=100))
        info.push(buf.of(REGIONS[2], pts=100))
        raw.end()
        info.end()
        runner.wait(30)
        runner.stop()
        outs[kind] = [(b.pts, [np.asarray(t).tolist() for t in b.tensors])
                      for b in sink.results]
    assert outs["torch"] == outs["jax"]
    assert [p for p, _ in outs["torch"]] == [100]
