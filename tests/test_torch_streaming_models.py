"""The port's streaming zoo models (nnstreamer_tpu_torch/models/{lstm,
audio_classifier}.py) against the JAX package's, on the CPU.

The JAX package's own params (seeded `jax.random` init) are carried over
through models/bridge.py, and the same seeded numpy inputs go through
both: `apply` within 1e-5 relative (f32), the audio classifier at windows
1024, 256, 64 and 1001 (uneven SAME padding: (3, 4) then (2, 3)), its
batch=N bundle against N batch-1 calls; then the reference's LSTM repo
loop (tests/test_streaming_models.py:36-73) and the keyword-spotting
audio pipeline (:286-301) run in both packages on the same weights and
inputs, the port's outputs held to JAX's. `audio_classifier.loss_fn`
(training through tensor_trainer) is held to JAX's in
tests/test_torch_trainer.py.
"""

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.models import audio_classifier as jaudio
from nnstreamer_tpu.models import lstm as jlstm
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.models import audio_classifier as taudio
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models import lstm as tlstm
from nnstreamer_tpu_torch.models.zoo import build_model, list_models
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- LSTM ---------------------------------------------------------------------

def test_zoo_lists_the_streaming_models():
    assert {"lstm", "audio_classifier"} <= set(list_models())


def test_lstm_zoo_model_shapes():
    """tests/test_streaming_models.py's shape check on the port."""
    params = tlstm.init_params(d_in=8, d_hidden=16)
    y, h2, c2 = tlstm.apply(params, torch.ones(1, 8), torch.zeros(1, 16),
                            torch.zeros(1, 16))
    assert y.shape == h2.shape == c2.shape == (1, 16)
    assert float(h2.abs().sum()) > 0
    b = build_model("lstm")
    assert [t.shape for t in b.in_spec.tensors] == [(1, 32), (1, 64),
                                                    (1, 64)]


@pytest.mark.parametrize("d_in,d_h,batch", [(8, 16, 1), (32, 64, 1),
                                            (5, 12, 3)])
def test_lstm_apply_matches_jax(d_in, d_h, batch):
    jp = np_tree(jlstm.init_params(d_in=d_in, d_hidden=d_h, seed=3))
    tp = bridge.lstm_params(jp)
    assert tp["wx"].shape == (d_in, 4 * d_h)     # JAX layout, no transpose
    rng = np.random.default_rng(d_in)
    x, h, c = (rng.normal(size=(batch, n)).astype(np.float32)
               for n in (d_in, d_h, d_h))
    # three steps: the state carries the recurrence
    for _ in range(3):
        want = [np.asarray(a) for a in jlstm.apply(jp, x, h, c)]
        got = [a.numpy() for a in tlstm.apply(
            tp, torch.from_numpy(x), torch.from_numpy(h),
            torch.from_numpy(c))]
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert rel(g, w) <= TOL
        h, c = (np.array(a) for a in want[1:])


def _lstm_loop(P, model, xs_np, d_in, d_h, slot):
    """The reference's repo-LSTM loop (tests/test_streaming_models.py:
    36-73): tensor_repo_src (h, c) and appsrc x → tensor_mux →
    tensor_filter → tensor_demux tensorpick=0,1+2 → sink and
    tensor_repo_sink → the ys."""
    el = P.el
    el.REPO.reset()
    state = el.TensorRepoSrc(name="state", slot=slot,
                             dims=f"{d_h}:1,{d_h}:1", types="float32,float32",
                             count=len(xs_np) + 1)
    if P is PORT:
        spec = TensorsSpec.of(TensorInfo((1, d_in), DType.FLOAT32))
        Buf = TensorBuffer
    else:
        spec = JSpec.of(JInfo((1, d_in), JDType.FLOAT32))
        Buf = JBuf
    xs = el.AppSrc(spec=spec, name="xs")
    mux = el.TensorMux(name="m", sync_mode="nosync")
    f = el.TensorFilter(name="f", framework="xla", model=model)
    demux = el.TensorDemux(name="d", tensorpick="0,1+2")
    sink = el.TensorSink(name="s")
    back = el.TensorRepoSink(name="back", slot=slot)
    pipe = P.nns.Pipeline()
    for e in (state, xs, mux, f, demux, sink, back):
        pipe.add(e)
    pipe.link(xs, mux, 0, 0)
    pipe.link(state, mux, 0, 1)
    pipe.link(mux, f)
    pipe.link(f, demux)
    pipe.link(demux, sink, 0, 0)
    pipe.link(demux, back, 1, 0)
    runner = P.nns.PipelineRunner(pipe).start()
    for i, x in enumerate(xs_np):
        xs.push(Buf.of(x, pts=i))
    xs.end()
    runner.wait(120)
    runner.stop()
    return [host(r.tensors[0]) for r in sink.results]


class _P:
    def __init__(self, nns, el):
        self.nns, self.el = nns, el


JAX = _P(jnns, jel)
PORT = _P(tnns, tel)


def test_lstm_repo_pipeline_matches_jax():
    """The repo loop in both packages on JAX's zoo weights (seed 0): the
    port's ys equal JAX's within 1e-5 relative, step by step, and the
    state evolves (the JAX test's check)."""
    d_in, d_h, steps = 8, 16, 6
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(1, d_in)).astype(np.float32)
          for _ in range(steps)]
    ref = _lstm_loop(JAX, f"zoo://lstm?d_in={d_in}&d_hidden={d_h}", xs,
                     d_in, d_h, 11)
    bundle = build_model(f"lstm?d_in={d_in}&d_hidden={d_h}")
    bundle.params = bridge.lstm_params(
        np_tree(jlstm.init_params(d_in=d_in, d_hidden=d_h)))
    got = _lstm_loop(PORT, bundle, xs, d_in, d_h, 11)
    assert len(got) == len(ref) == steps
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (1, d_h)
        assert rel(g, r) <= TOL
    assert not np.allclose(got[0], got[-1])
    # and the port's ys are the recurrence of apply() on the same weights
    h = c = torch.zeros(1, d_h)
    for x, g in zip(xs, got):
        y, h, c = tlstm.apply(bundle.params, torch.from_numpy(x), h, c)
        np.testing.assert_array_equal(g, y.numpy())


# -- audio classifier ---------------------------------------------------------

def test_same_pads_uneven_at_1001():
    """XLA/TF SAME at stride 4, K 8: (2, 2) at 1024/256/64; uneven at
    1001 — (3, 4) in the first block, (2, 3) in the second (251 in)."""
    for t in (1024, 256, 64):
        assert L.same_pads(t, 8, 4) == (2, 2)
    assert L.same_pads(1001, 8, 4) == (3, 4)
    assert L.same_pads(251, 8, 4) == (2, 3)


@pytest.mark.parametrize("window", [1024, 1001, 256, 64])
def test_audio_classifier_apply_matches_jax(window):
    jp = np_tree(jaudio.init_params(channels=16, num_classes=12, seed=1))
    tp = bridge.audio_classifier_params(jp)
    assert tp["blocks"][1]["w"].shape == (16, 16, 8)     # (Cout, Cin, K)
    rng = np.random.default_rng(window)
    # int16-scale samples: the per-window standardization absorbs scale
    for x in (rng.normal(0, 3000, (2, window, 1)).astype(np.float32),
              rng.normal(0, 1, (3, window)).astype(np.float32)):
        want = np.asarray(jaudio.apply(jp, x))
        got = taudio.apply(tp, torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert rel(got, want) <= TOL


def test_audio_classifier_population_std():
    """jnp.std is the population std: a window whose unbiased std would
    differ still matches JAX (correction=0)."""
    jp = np_tree(jaudio.init_params(channels=8, num_classes=4))
    x = np.zeros((1, 64, 1), np.float32)
    x[0, :2, 0] = (1.0, -1.0)
    want = np.asarray(jaudio.apply(jp, x))
    got = taudio.apply(bridge.audio_classifier_params(jp),
                       torch.from_numpy(x)).numpy()
    assert rel(got, want) <= TOL


def test_audio_bundles_batch1_and_batch_n():
    """The batch-1 bundle takes a (window, 1) frame, the batch=4 bundle
    (4, window, 1); the batched logits equal four batch-1 calls within
    1e-6 and JAX's batch=4 bundle within 1e-5."""
    jp = np_tree(jaudio.init_params())
    tp = bridge.audio_classifier_params(jp)
    one = build_model("audio_classifier?window=1001")
    four = build_model("audio_classifier?window=1001&batch=4")
    assert one.in_spec.tensors[0].shape == (1001, 1)
    assert four.in_spec.tensors[0].shape == (4, 1001, 1)
    assert four.out_spec.tensors[0].shape == (4, 12)
    x = np.random.default_rng(4).normal(0, 500, (4, 1001, 1)).astype(
        np.float32)
    with torch.inference_mode():
        batched = four.fn(tp, torch.from_numpy(x)).numpy()
        singles = np.stack([one.fn(tp, torch.from_numpy(x[i])).numpy()
                            for i in range(4)])
    assert rel(singles, batched) <= 1e-6
    jfour = jaudio.build(window=1001, batch=4)
    assert rel(batched, np.asarray(jfour.fn(jp, x))) <= TOL


AUDIO = ("audiotestsrc num-buffers={n} samples-per-buffer=256 wave=sine "
         "freq=880 ! tensor_converter frames-per-tensor={w} ! "
         "tensor_transform mode=typecast option=float32 ! ")


def test_audio_pipeline_matches_jax():
    """The keyword-spotting pipeline (tests/test_streaming_models.py:
    286-301) in both packages on JAX's zoo weights: 2048 samples → 2
    windows of 1024, (12,) finite logits, the port's within 1e-5 of
    JAX's."""
    head = AUDIO.format(n=8, w=1024)
    jpipe = jnns.parse_launch(
        head + "tensor_filter model=zoo://audio_classifier?window=1024"
               "&num_classes=12 ! tensor_sink name=s")
    jnns.run_pipeline(jpipe, timeout=60)
    ref = [np.asarray(r.tensors[0]) for r in jpipe.get("s").results]
    tpipe = tnns.parse_launch(head + "tensor_filter name=f ! "
                                     "tensor_sink name=s")
    bundle = build_model("audio_classifier?window=1024&num_classes=12")
    bundle.params = bridge.audio_classifier_params(
        np_tree(jaudio.init_params(num_classes=12)))
    tpipe.get("f").set_props(model=bundle)
    tnns.run_pipeline(tpipe, timeout=60)
    got = [host(r.tensors[0]) for r in tpipe.get("s").results]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (12,) and np.isfinite(g).all()
        assert rel(g, r) <= TOL


def test_audio_pipeline_on_the_zoo_string():
    """The JAX test's string verbatim on the port (the port's own seeded
    weights): 2 windows of finite (12,) logits; window 1001 pads
    unevenly and runs too."""
    for w, n, windows in ((1024, 8, 2), (1001, 8, 2)):
        pipe = tnns.parse_launch(
            AUDIO.format(n=n, w=w) + f"tensor_filter model=zoo://"
            f"audio_classifier?window={w}&num_classes=12 ! "
            f"tensor_sink name=s")
        tnns.run_pipeline(pipe, timeout=60)
        res = pipe.get("s").results
        assert len(res) == windows
        for r in res:
            lg = host(r.tensors[0])
            assert lg.shape == (12,) and np.isfinite(lg).all()
