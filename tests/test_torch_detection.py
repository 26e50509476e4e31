"""Detection (BASELINE config 2) on the port against the JAX package, on
the CPU.

- `generate_anchors` bit for bit; `decode_boxes` on numpy bit for bit,
  on torch within 1e-6.
- SSD-MobileNetV2 at 300² (width 0.35, f32) on the same random
  parameters (a JAX-shaped tree from seeded numpy, carried across by
  models/bridge.py): loc and logits within 1e-4 of max |.|; the
  backbone's maps (the JAX `features_only` list) of the same shapes and
  within 1e-3 of their ReLU6 range.
- bounding_boxes host decode in all five schemes: image bytes and the
  `boxes` meta identical (both packages decode in the same numpy).
- `ssd_decode_device` (greedy and fast NMS) and `ssd_compact_device`
  against the JAX programs: same rows, classes equal, boxes and scores
  within 1e-6 (each side's sigmoid and exp differ in the last ulp),
  including exact score ties, which both order by anchor index.
- Pipeline D through parse_launch, uint8 ingest with the normalize fused
  into the filter: the SSD's outputs within 1e-4 of max |.|; then each
  decoder mode (compact with max_in_flight 4 and 1, device=true, host)
  on outputs made identical in both packages (a fixed-output model with
  well separated scores): images identical, host-decoded metadata
  identical, compact and device=true boxes (decoded on the device, where
  exp differs in the last ulp) within 1e-3 px of JAX's and of the host
  decode's, classes equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
from nnstreamer_tpu.decoders import device as jdev
from nnstreamer_tpu.models import ssd_mobilenet as js
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle as TBundle
from nnstreamer_tpu_torch.decoders import device as tdev
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import ssd_mobilenet as ts
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as TBuf

from test_torch_mobilenet import randomize_bn

WIDTH = 0.35
A, C = 1917, 91
NORM = ("tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5")
DECODE = ("tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
          "option3=0.5:0.5 option4=300:300")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def random_params(init, seed=0, **kw):
    """A JAX-shaped param tree of `init` with seeded numpy leaves: convs
    and denses He-normal over their fan-in, BN statistics random
    (randomize_bn), everything else 0. jax.random init is not run (it
    takes tens of seconds on the CPU for these models)."""
    shapes = jax.eval_shape(functools.partial(init, **kw),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return randomize_bn(jax.tree_util.tree_map(leaf, shapes), seed + 1)


@pytest.fixture(scope="module")
def ssd():
    """(JAX bundle, port bundle) of one SSD, f32, width 0.35."""
    params = random_params(js.init_params, width=WIDTH)
    jb = JBundle(fn=lambda p, x: js.apply(p, x, width=WIDTH,
                                          dtype=jnp.float32),
                 params=params, name="ssd")
    model = bridge.load_ssd_mobilenet(
        ts.SSDMobileNetV2(width=WIDTH, dtype=torch.float32).eval(), params)
    return jb, TBundle(fn=lambda m, x: m(x), params=model, name="ssd")


def frames(n=2, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (1, 300, 300, 3), np.uint8)
            for _ in range(n)]


def run(pkg, buf_cls, desc, inputs, model=None, timeout=300):
    pipe = pkg.parse_launch(desc)
    if model is not None:
        pipe.get("f").set_props(model=model)
    runner = pkg.PipelineRunner(pipe).start()
    src = pipe.get("src")
    for i, x in enumerate(inputs):
        src.push(buf_cls.of(*x, pts=i) if isinstance(x, tuple)
                 else buf_cls.of(x, pts=i))
    src.end()
    runner.wait(timeout)
    runner.stop()
    return pipe.get("out").results


# -- anchors, box coder, model --------------------------------------------

def test_anchors_and_box_decode_match_jax():
    anchors = ts.generate_anchors()
    np.testing.assert_array_equal(anchors, js.generate_anchors())
    assert anchors.shape == (A, 4) and anchors.dtype == np.float32
    loc = np.random.default_rng(0).standard_normal((A, 4)).astype(np.float32)
    ref = js.decode_boxes(loc, anchors)
    np.testing.assert_array_equal(ts.decode_boxes(loc, anchors), ref)
    got = ts.decode_boxes(torch.from_numpy(loc), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_ssd_model_matches_jax(ssd):
    jb, tb = ssd
    x = np.random.default_rng(1).uniform(-1, 1, (1, 300, 300, 3)).astype(
        np.float32)
    ref = jax.jit(jb.fn)(jb.params, x)
    with torch.inference_mode():
        got = tb.params(torch.from_numpy(x))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    assert got[0].shape == (1, A, 4) and got[1].shape == (1, A, C)


def test_mobilenet_features_match_jax_features_only(ssd):
    """The backbone's maps: one entering each stride-2 block, then the
    head — the same list as JAX's features_only, NHWC at the face."""
    from nnstreamer_tpu.models import mobilenet_v2 as jm

    jb, tb = ssd
    x = np.random.default_rng(3).uniform(-1, 1, (1, 300, 300, 3)).astype(
        np.float32)
    ref = jax.jit(lambda p, x: jm.apply(
        p["backbone"], x, width=WIDTH, dtype=jnp.float32,
        features_only=True))(jb.params, x)
    with torch.inference_mode():
        got = tb.params.backbone(torch.from_numpy(x), features_only=True)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert [tuple(g.shape[1:3]) for g in got[-2:]] == [(19, 19), (10, 10)]
    # the maps are ReLU6 outputs (max 6) of pre-activations far larger
    # with these random BN statistics: f32 summation-order differences
    # pass through unclipped elements at the pre-activations' scale, so
    # the limit is 1e-3 of the clip range
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3 * 6.0)


def test_same_pads_on_the_extras_chain_and_size_check():
    """Stride-2 TF SAME on 10 → 5 → 3 → 2 → 1: even and odd sizes; the
    zoo builds only the 300² anchor grid, as the JAX zoo does."""
    from nnstreamer_tpu_torch.core.errors import BackendError
    from nnstreamer_tpu_torch.models.layers import same_pads
    from nnstreamer_tpu_torch.models.zoo import build_model

    n, seen = 10, []
    for _ in range(4):
        seen.append((n, *same_pads(n, 3, 2)))
        n = -(-n // 2)
    assert seen == [(10, 0, 1), (5, 1, 1), (3, 1, 1), (2, 0, 1)]
    with pytest.raises(BackendError, match="300"):
        build_model("ssd_mobilenet?input_size=299")


# -- host decode: all five schemes ----------------------------------------

def _scheme_inputs():
    rng = np.random.default_rng(2)
    loc = (rng.standard_normal((1, A, 4)) * 0.5).astype(np.float32)
    logits = (rng.standard_normal((1, A, C)) * 2 - 3).astype(np.float32)
    n = 12
    boxes = np.sort(rng.uniform(0, 1, (1, n, 4)), axis=-1).astype(np.float32)
    yolo = np.concatenate([rng.uniform(20, 280, (1, 40, 4)),
                           rng.uniform(0, 1, (1, 40, 5))], -1).astype(
        np.float32)
    ov = np.concatenate([np.zeros((1, 1, 30, 1)),
                         rng.integers(0, 5, (1, 1, 30, 1)),
                         rng.uniform(0, 1, (1, 1, 30, 1)),
                         np.sort(rng.uniform(0, 1, (1, 1, 30, 4)), -1)],
                        -1).astype(np.float32)
    palm = np.concatenate([rng.uniform(0.2, 0.8, (1, 25, 4)) * [1, 1, .3, .3],
                           rng.uniform(0, 1, (1, 25, 14))], -1).astype(
        np.float32)
    return {
        "mobilenet-ssd": ("4:1917:1,91:1917:1", (loc, logits)),
        "mobilenet-ssd-postprocess": (
            "4:12:1,12:1,12:1,1", (boxes, rng.integers(0, 8, (1, n)).astype(
                np.float32), rng.uniform(0, 1, (1, n)).astype(np.float32),
                np.array([9.0], np.float32))),
        "yolov5": ("9:40:1", (yolo,)),
        "ov-person-detection": ("7:30:1:1", (ov,)),
        "mp-palm-detection": ("18:25:1", (palm,)),
    }


@pytest.mark.parametrize("scheme", sorted(_scheme_inputs()))
def test_host_decode_matches_jax_in_every_scheme(scheme, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"obj{i}" for i in range(C)))
    dims, tensors = _scheme_inputs()[scheme]
    desc = (f"appsrc name=src dims={dims} types=float32 ! "
            f"tensor_decoder mode=bounding_boxes option1={scheme} "
            f"option2={labels} option3=0.4:0.45 option4=320:240 ! "
            f"tensor_sink name=out")
    (ref,) = run(jnns, JBuf, desc, [tensors])
    (got,) = run(tnns, TBuf, desc, [tensors])
    assert got.tensors[0].shape == (240, 320, 4)
    np.testing.assert_array_equal(got.tensors[0], np.asarray(ref.tensors[0]))
    np.testing.assert_array_equal(got.meta["boxes"], ref.meta["boxes"])
    assert len(got.meta["boxes"]) > 0


# -- device decode programs -----------------------------------------------

def _raw(seed, ties=False):
    rng = np.random.default_rng(seed)
    loc = (rng.standard_normal((1, A, 4)) * 0.5).astype(np.float32)
    logits = (rng.standard_normal((1, A, C)) * 3 - 2).astype(np.float32)
    if ties:
        # 300 anchors tie at the same class score (1.0 after the f32
        # sigmoid), more than the 100 candidates top-K keeps
        logits[0, rng.choice(A, 300, replace=False), 7] = 40.0
    return loc, logits


@pytest.mark.parametrize("nms", ["greedy", "fast"])
@pytest.mark.parametrize("ties", [False, True])
def test_ssd_decode_device_matches_jax(nms, ties):
    loc, logits = _raw(3, ties)
    anchors = ts.generate_anchors()
    ref = np.asarray(jdev.ssd_decode_device(
        loc, logits, anchors, score_thresh=0.5, iou_thresh=0.5, top_k=16,
        nms=nms))
    got = tdev.ssd_decode_device(
        torch.from_numpy(loc), torch.from_numpy(logits),
        torch.from_numpy(anchors), score_thresh=0.5, iou_thresh=0.5,
        top_k_out=16, nms=nms).numpy()
    assert got.shape == ref.shape == (16, 6)
    np.testing.assert_array_equal(got[:, 5], ref[:, 5])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ties", [False, True])
def test_ssd_compact_device_matches_jax(ties):
    loc, logits = _raw(4, ties)
    anchors = ts.generate_anchors()
    ref = np.asarray(jdev.ssd_compact_device(loc, logits, anchors,
                                             top_k=100))
    got = tdev.ssd_compact_device(torch.from_numpy(loc),
                                  torch.from_numpy(logits),
                                  torch.from_numpy(anchors),
                                  top_k_rows=100).numpy()
    assert got.shape == ref.shape == (100, 6)
    np.testing.assert_array_equal(got[:, 5], ref[:, 5])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_top_k_orders_ties_by_index():
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 1.0])
    vals, idx = tdev.top_k(x, 4)
    assert idx.tolist() == [1, 2, 4, 3]
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(ref_i).tolist()


def test_greedy_nms_matches_host_nms():
    from nnstreamer_tpu_torch.decoders.boundingbox import nms

    rng = np.random.default_rng(9)
    yx = rng.uniform(0, 0.8, (60, 2))
    boxes = np.concatenate([yx, yx + rng.uniform(0.05, 0.3, (60, 2))],
                           1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, 60))[::-1].astype(np.float32)
    keep = tdev.greedy_nms_mask(torch.from_numpy(boxes), 0.3).numpy()
    np.testing.assert_array_equal(np.nonzero(keep)[0],
                                  np.sort(nms(boxes, scores, 0.3)))


# -- pipeline D -----------------------------------------------------------

def test_pipeline_d_model_outputs_match_jax(ssd):
    desc = (f"appsrc name=src dims=3:300:300:1 types=uint8 ! {NORM} ! "
            f"tensor_filter name=f ! tensor_sink name=out")
    ref = run(jnns, JBuf, desc, frames(), ssd[0])
    got = run(tnns, TBuf, desc, frames(), ssd[1])
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        for rt, gt in zip(r.tensors, g.tensors):
            rt = np.asarray(rt)
            np.testing.assert_allclose(gt, rt, rtol=0,
                                       atol=1e-4 * np.abs(rt).max())


def _fixed_outputs():
    """Raw SSD outputs with well separated scores: 40 anchors above the
    0.5 threshold, each its own score, the rest far below."""
    rng = np.random.default_rng(11)
    loc = (rng.standard_normal((1, A, 4)) * 0.3).astype(np.float32)
    logits = np.full((1, A, C), -8.0, np.float32)
    hot = rng.choice(A, 40, replace=False)
    logits[0, hot, rng.integers(1, C, 40)] = np.linspace(0.5, 6.0, 40)
    return loc, logits


def _fixed_bundles():
    loc, logits = _fixed_outputs()
    return (JBundle(fn=lambda p, x: (jnp.asarray(loc) + 0 * x.sum(),
                                     jnp.asarray(logits)), name="fixed"),
            TBundle(fn=lambda p, x: (torch.from_numpy(loc).to(x.device)
                                     + 0 * x.sum(),
                                     torch.from_numpy(logits).to(x.device)),
                    name="fixed"))


MODES = {"compact-4": "device=compact max_in_flight=4",
         "compact-1": "device=compact max_in_flight=1",
         "device": "device=true",
         "host": "max_in_flight=1"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_d_decoder_modes_match_jax(mode):
    jb, tb = _fixed_bundles()
    desc = (f"appsrc name=src dims=3:300:300:1 types=uint8 ! {NORM} ! "
            f"tensor_filter name=f ! {DECODE} {MODES[mode]} ! "
            f"tensor_sink name=out")
    ref = run(jnns, JBuf, desc, frames(), jb)
    got = run(tnns, TBuf, desc, frames(), tb)
    assert len(got) == len(ref) == 2
    host = run(tnns, TBuf, desc.replace(MODES[mode], ""), frames()[:1], tb)
    for r, g in zip(ref, got):
        if mode == "device":
            det = g.tensors[0]
            assert det.shape == (16, 6) and det.dtype == np.float32
            np.testing.assert_array_equal(det[:, 5], np.asarray(r.tensors[0])[:, 5])
            np.testing.assert_allclose(det, np.asarray(r.tensors[0]),
                                       atol=1e-3, rtol=0)
            # the host decode's detections, in score order
            hb = host[0].meta["boxes"]
            kept = det[det[:, 4] > 0]
            assert len(kept) == min(16, len(hb))
            np.testing.assert_allclose(kept, hb[:len(kept)], atol=1e-3,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.tensors[0],
                                          np.asarray(r.tensors[0]))
            if mode == "host":
                np.testing.assert_array_equal(g.meta["boxes"],
                                              r.meta["boxes"])
            # compact rows carry boxes decoded on the device (torch's exp
            # against XLA's and numpy's: last-ulp differences)
            for other in (r.meta["boxes"], host[0].meta["boxes"]):
                assert g.meta["boxes"].shape == other.shape
                np.testing.assert_array_equal(g.meta["boxes"][:, 5],
                                              other[:, 5])
                np.testing.assert_allclose(g.meta["boxes"], other,
                                           atol=1e-3, rtol=0)


def test_device_true_folds_into_filter_and_compact_stays():
    from nnstreamer_tpu_torch.graph.optimize import fuse_transforms

    for mode, kinds in (("device=true", ["AppSrc", "TensorFilter",
                                         "TensorSink"]),
                        ("device=compact", ["AppSrc", "TensorDecoder",
                                            "TensorFilter", "TensorSink"])):
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=3:300:300:1 types=uint8 ! {NORM} ! "
            f"tensor_filter name=f model=zoo://ssd_mobilenet ! {DECODE} "
            f"{mode} ! tensor_sink name=out")
        fuse_transforms(pipe)
        assert sorted(type(e).__name__ for e in pipe.elements.values()) \
            == kinds


def test_device_decode_gets_anchors_as_an_argument():
    """Fused: the anchors reach each decode as a tensor on the filter's
    device, made once at negotiation."""
    jb, tb = _fixed_bundles()
    pipe = tnns.parse_launch(
        f"appsrc name=src dims=3:300:300:1 types=uint8 ! {NORM} ! "
        f"tensor_filter name=f ! {DECODE} device=true ! tensor_sink name=out")
    pipe.get("f").set_props(model=tb)
    tnns.PipelineRunner(pipe).start().stop()
    aux = pipe.get("f")._decoder_aux
    assert isinstance(aux["anchors"], torch.Tensor)
    np.testing.assert_array_equal(aux["anchors"].numpy(),
                                  ts.generate_anchors())
