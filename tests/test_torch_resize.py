"""The transform's transpose and dimchg modes and tensor_resize
(nnstreamer_tpu_torch/elements/transform.py) against the JAX package's,
on the CPU.

- transpose over all 24 permutations of rank 4 and every permutation of
  ranks 2–3, and dimchg over every (from, to) of ranks 2–4: shapes and
  values equal to JAX's TransformProgram on the host, on a CPU tensor,
  and fused into a filter (the same pipeline with the optimizer on and
  off, bit for bit);
- tensor_resize nearest bit for bit; bilinear (jax.image.resize's
  antialiased triangle weights) f32 within 1e-5·max|.| and uint8 within
  1 LSB (the count of off-by-one elements in the assertion text), down-
  and upsampling, one axis or both, host arrays and CPU tensors;
- FLEXIBLE regions: `tensor_crop ! tensor_resize ! tensor_filter`
  (copies of tests/test_pipelines.py's ROI and static/bilinear/nearest
  tests and tests/test_dynamic_shapes.py's static crop path, each
  package's own backend on a callable model where JAX uses
  framework=custom).
"""

import itertools

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements import transform as jtr
from nnstreamer_tpu.tensor import info as jinfo
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import NegotiationError, PipelineError
from nnstreamer_tpu_torch.elements import transform as ttr
from nnstreamer_tpu_torch.elements import (
    AppSrc, TensorCrop, TensorFilter, TensorSink)
from nnstreamer_tpu_torch.tensor import info as tinfo
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


RNG = np.random.default_rng(0)
PERMS = [":".join(map(str, p)) for r in (2, 3, 4)
         for p in itertools.permutations(range(r))]
DIMCHG = [f"{a}:{b}" for r in (2, 3, 4) for a in range(r) for b in range(r)]
SHAPES = {2: (3, 5), 3: (2, 3, 5), 4: (2, 3, 4, 5)}


def _program_case(mode, option):
    rank = len(option.split(":")) if mode == "transpose" else \
        max(int(v) for v in option.split(":")) + 1
    ranks = [rank] if mode == "transpose" else \
        [r for r in (2, 3, 4) if r >= rank]
    for r in ranks:
        x = RNG.standard_normal(SHAPES[r]).astype(np.float32)
        jp = jtr.TransformProgram(mode, option)
        tp = ttr.TransformProgram(mode, option)
        ref = jp.apply(np, x)
        jinfo_out = jp.out_info(jinfo.TensorInfo(x.shape, JDType.FLOAT32))
        tinfo_out = tp.out_info(tinfo.TensorInfo(x.shape, DType.FLOAT32))
        assert tinfo_out.shape == jinfo_out.shape == ref.shape
        got = tp.apply(x)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, ref)
        gt = tp.apply(torch.from_numpy(x))
        assert isinstance(gt, torch.Tensor)
        np.testing.assert_array_equal(gt.numpy(), ref)
        yield x, ref


def _fused_unfused(mode, option, x):
    """appsrc ! transform ! filter(identity) ! sink with the optimizer
    on (the transform fused into the filter) and off → both outputs."""
    outs = []
    for optimize in (True, False):
        src = AppSrc(spec=tinfo.TensorsSpec.of(
            tinfo.TensorInfo(x.shape, DType.FLOAT32)), name="src")
        tf = ttr.TensorTransform(name="t", mode=mode, option=option)
        f = TensorFilter(name="f", model=ModelBundle(fn=lambda p, a: (a * 1,)))
        sink = TensorSink(name="s")
        pipe = tnns.Pipeline()
        for e in (src, tf, f, sink):
            pipe.add(e)
        pipe.link(src, tf)
        pipe.link(tf, f)
        pipe.link(f, sink)
        runner = tnns.PipelineRunner(pipe, optimize=optimize).start()
        src.push(TensorBuffer.of(x, pts=0))
        src.end()
        runner.wait(30)
        runner.stop()
        assert ("t" in pipe.elements) == (not optimize)
        outs.append(sink.results[0].tensors[0])
    return outs


@pytest.mark.parametrize("option", PERMS)
def test_transpose_every_permutation_matches_jax(option):
    for x, ref in _program_case("transpose", option):
        fused, unfused = _fused_unfused("transpose", option, x)
        np.testing.assert_array_equal(fused, ref)
        np.testing.assert_array_equal(unfused, ref)


@pytest.mark.parametrize("option", DIMCHG)
def test_dimchg_every_move_matches_jax(option):
    for x, ref in _program_case("dimchg", option):
        if x.ndim == 4:
            fused, unfused = _fused_unfused("dimchg", option, x)
            np.testing.assert_array_equal(fused, ref)
            np.testing.assert_array_equal(unfused, ref)


def test_transpose_and_dimchg_refusals_match_jax():
    for mode, option, shape in (("transpose", "0:1", (2, 3, 4)),
                                ("transpose", "0:0:1", (2, 3, 4)),
                                ("dimchg", "0:5", (2, 3))):
        with pytest.raises(Exception) as je:
            jtr.TransformProgram(mode, option).out_info(
                jinfo.TensorInfo(shape, JDType.FLOAT32))
        with pytest.raises(PipelineError) as te:
            ttr.TransformProgram(mode, option).out_info(
                tinfo.TensorInfo(shape, DType.FLOAT32))
        assert str(te.value) == str(je.value)
    for mode, option in (("transpose", "a:b"), ("dimchg", "1")):
        with pytest.raises(PipelineError, match=f"mode={mode}"):
            ttr.TransformProgram(mode, option)


def _resize_pair(size, method, x, channels=0):
    j = jtr.TensorResize(name="r", size=size, method=method,
                         channels=channels)
    t = ttr.TensorResize(name="r", size=size, method=method,
                         channels=channels)
    return j._resize(x), t._resize(x), t._resize(torch.from_numpy(x))


CASES = [((1, 4, 4, 1), "8:8"), ((1, 16, 12, 3), "5:7"),
         ((1, 480, 640, 3), "224:224"), ((2, 7, 9, 2), "7:20"),
         ((9, 6), "4:13"), ((1, 10, 10, 3), "10:10")]


@pytest.mark.parametrize("shape,size", CASES)
def test_resize_nearest_bit_for_bit(shape, size):
    x = RNG.integers(0, 256, size=shape).astype(np.uint8)
    ref, got, gt = _resize_pair(size, "nearest", x)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert isinstance(gt, torch.Tensor)
    np.testing.assert_array_equal(gt.numpy(), ref)


@pytest.mark.parametrize("shape,size", CASES)
def test_resize_bilinear_f32_and_uint8_match_jax(shape, size):
    xf = RNG.standard_normal(shape).astype(np.float32)
    ref, got, gt = _resize_pair(size, "bilinear", xf)
    tol = 1e-5 * float(np.abs(ref).max())
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol
    np.testing.assert_array_equal(gt.numpy(), got)
    xu = RNG.integers(0, 256, size=shape).astype(np.uint8)
    ref, got, gt = _resize_pair(size, "bilinear", xu)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (
        f"{int((diff > 1).sum())} elements more than 1 LSB off, "
        f"{int((diff == 1).sum())} of {diff.size} 1 LSB off")
    np.testing.assert_array_equal(gt.numpy(), got)


def test_bilinear_weights_equal_jax_weight_matrix():
    """The weights are jax.image's own `compute_weight_mat`'s (f32)."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for m, n in ((480, 224), (4, 8), (16, 5), (9, 20), (640, 224)):
        ref = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                            _fill_triangle_kernel, True))
        got = ttr.bilinear_weights(m, n)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=1e-8)


def _resize_cls(el):
    """tensor_resize's class (the JAX package exports it from
    elements.transform only)."""
    return jtr.TensorResize if el.__name__.startswith("nnstreamer_tpu.") \
        else ttr.TensorResize


def _run_resize(nns, mod, buf_cls, spec_mod, dtype_cls, method, x, size):
    src = mod.AppSrc(spec=spec_mod.TensorsSpec.of(
        spec_mod.TensorInfo(x.shape, dtype_cls.FLOAT32)), name="src")
    rs = _resize_cls(mod)(name="r", size=size, method=method)
    sink = mod.TensorSink(name="s")
    pipe = nns.Pipeline()
    for e in (src, rs, sink):
        pipe.add(e)
    pipe.link(src, rs)
    pipe.link(rs, sink)
    assert rs.out_specs == []  # not negotiated yet
    runner = nns.PipelineRunner(pipe).start()
    src.push(buf_cls.of(x, pts=0))
    src.end()
    runner.wait(60)
    runner.stop()
    return sink.results[0].tensors[0]


def test_resize_static_bilinear_and_nearest():
    import nnstreamer_tpu.elements as jel
    import nnstreamer_tpu_torch.elements as tel

    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    for method in ("nearest", "bilinear"):
        ref = _run_resize(jnns, jel, JBuf, jinfo, JDType, method, x, "8:8")
        out = _run_resize(tnns, tel, TensorBuffer, tinfo, DType, method, x,
                          "8:8")
        assert out.shape == ref.shape == (1, 8, 8, 1)
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


def _crop_resize(nns, el, buf_cls, info_mod, dtype_cls, model, img,
                 regions, size="8:8", method="nearest"):
    raw = el.AppSrc(spec=info_mod.TensorsSpec.of(
        info_mod.TensorInfo(img.shape, dtype_cls.UINT8)), name="raw")
    info = el.AppSrc(spec=info_mod.TensorsSpec.of(
        info_mod.TensorInfo(regions.shape, dtype_cls.UINT32)), name="info")
    crop = el.TensorCrop(name="c")
    rs = _resize_cls(el)(name="r", size=size, channels=3, method=method)
    f = el.TensorFilter(name="f", **model)
    sink = el.TensorSink(name="s")
    pipe = nns.Pipeline()
    for e in (raw, info, crop, rs, f, sink):
        pipe.add(e)
    pipe.link(raw, crop, 0, 0)
    pipe.link(info, crop, 0, 1)
    pipe.link(crop, rs)
    pipe.link(rs, f)
    pipe.link(f, sink)
    runner = nns.PipelineRunner(pipe).start()
    raw.push(buf_cls.of(img, pts=0))
    info.push(buf_cls.of(regions, pts=0))
    raw.end()
    info.end()
    runner.wait(60)
    runner.stop()
    return sink.results


def _both_crop_resize(fn, img, regions, **kw):
    """The JAX pipeline with framework=custom, the port's with the same
    function as a callable model → the port's results, each equal to
    JAX's (to f32 rounding after a nearest resize; within 1 LSB of the
    uint8 frame after a bilinear one, whose regions are within 1 LSB)."""
    atol = 1.0 if kw.get("method") == "bilinear" else 0.0
    import nnstreamer_tpu.elements as jel
    import nnstreamer_tpu_torch.elements as tel
    from nnstreamer_tpu.backends.custom import (
        register_custom_easy, unregister_custom_easy)

    register_custom_easy("tr_roi", lambda ts: fn(np, ts[0]))
    try:
        ref = _crop_resize(jnns, jel, JBuf, jinfo, JDType,
                           dict(framework="custom", model="tr_roi"), img,
                           regions, **kw)
    finally:
        unregister_custom_easy("tr_roi")
    got = _crop_resize(tnns, tel, TensorBuffer, tinfo, DType,
                       dict(model=ModelBundle(fn=lambda p, a: fn(torch, a))),
                       img, regions, **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.meta["region_index"] == r.meta["region_index"]
        assert g.meta["num_regions"] == r.meta["num_regions"]
        np.testing.assert_allclose(g.tensors[0], np.asarray(r.tensors[0]),
                                   rtol=1e-6, atol=atol)
    return got


def _mean_hw(xp, a):
    if xp is torch:
        return (a.to(torch.float32).mean(dim=(0, 1), keepdim=True),)
    return (a.astype(np.float32).mean(axis=(0, 1), keepdims=True),)


def test_crop_resize_filter_roi_pipeline():
    """Data-driven ROI inference: crop (flexible) → resize (static) →
    model."""
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8, :8] = 100   # region 1 bright, region 2 dark
    regions = np.array([[0, 0, 8, 8], [8, 8, 8, 8]], np.uint32)
    res = _both_crop_resize(_mean_hw, img, regions)
    assert len(res) == 2  # one inference per region
    means = sorted(float(r.tensors[0].reshape(-1)[0]) for r in res)
    assert means[0] == 0.0 and means[1] == 100.0
    assert {r.meta["region_index"] for r in res} == {0, 1}


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_crop_resize_filter_static_pipeline(method):
    """The semantic fixed-model path: crop → tensor_resize → filter, the
    regions resized down and up."""
    img = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3)
    regions = np.array([[0, 0, 8, 8], [4, 4, 12, 12], [2, 3, 5, 4]],
                       np.uint32)
    res = _both_crop_resize(_mean_hw, img, regions, method=method)
    assert len(res) == 3  # one STATIC buffer per region
    assert res[0].meta["num_regions"] == 3


def test_resize_flexible_regions_on_tensors_stay_tensors():
    """FLEXIBLE CPU-tensor regions (rank 2 and 3) resize to STATIC
    tensors equal to the host regions' resize; a wrong channel count
    raises with the region's shape."""
    rs = ttr.TensorResize(name="r", size="6:5", channels=1,
                          method="bilinear")
    (spec,) = rs.negotiate([tinfo.TensorsSpec(
        tensors=(tinfo.TensorInfo((4, 4, 1), DType.UINT8),),
        format=tinfo.TensorFormat.FLEXIBLE)])
    assert spec.tensors[0].shape == (6, 5, 1)
    a = RNG.integers(0, 256, size=(9, 7)).astype(np.uint8)
    b = RNG.integers(0, 256, size=(3, 4, 1)).astype(np.uint8)
    host = rs.process(0, TensorBuffer.of(a, b, pts=5,
                                         format=tinfo.TensorFormat.FLEXIBLE))
    dev = rs.process(0, TensorBuffer.of(
        torch.from_numpy(a), torch.from_numpy(b), pts=5,
        format=tinfo.TensorFormat.FLEXIBLE))
    assert [h.meta["region_index"] for _, h in host] == [0, 1]
    for (_, h), (_, d) in zip(host, dev):
        assert h.format == tinfo.TensorFormat.STATIC
        assert isinstance(d.tensors[0], torch.Tensor)
        np.testing.assert_array_equal(d.tensors[0].numpy(), h.tensors[0])
    with pytest.raises(PipelineError, match=r"\(3, 4, 2\)"):
        rs.process(0, TensorBuffer.of(np.zeros((3, 4, 2), np.uint8),
                                      format=tinfo.TensorFormat.FLEXIBLE))


def test_resize_refusals():
    with pytest.raises(PipelineError, match="size=H:W"):
        ttr.TensorResize(name="r")
    with pytest.raises(PipelineError, match="nearest|bilinear"):
        ttr.TensorResize(name="r", size="2:2", method="cubic")
    rs = ttr.TensorResize(name="r", size="2:2")
    with pytest.raises(NegotiationError, match="rank-1"):
        rs.negotiate([tinfo.TensorsSpec.of(tinfo.TensorInfo((4,)))])
    with pytest.raises(NegotiationError, match="channels"):
        rs.negotiate([tinfo.TensorsSpec(
            tensors=(tinfo.TensorInfo((4, 4, 3)),),
            format=tinfo.TensorFormat.FLEXIBLE)])
