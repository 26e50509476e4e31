"""The port's training path (parallel/train.py, trainer/element.py, the
models' loss_fn and train-mode BN) against the JAX package's, on the CPU.

Parameters are JAX's, carried across by models/bridge.py. Tolerances:

- train-mode BN: within 1e-6 of JAX's `layers.batch_norm(train=True)`;
  a control with the unbiased variance (or eps 1e-5) misses by far more.
- the audio classifier (no BN), `sgd`, `adam` and `adamw`, 3 steps run
  freely in both packages: losses within 1e-5 relative; `sgd` parameters
  within 1e-5 of the largest parameter. Adam divides by the root of the
  second moment, so where JAX's |grad| was f32 noise at some step (below
  1e-4 of its leaf's largest) an element may move up to lr either way in
  either package: those are held within 2·lr a step, the rest within
  2e-5 of the largest parameter.

The MobileNetV2 forward, its gradients and its teacher-forced `sgd`,
`adam` and `adamw` steps are in tests/test_torch_train_step.py.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.models import audio_classifier as jaudio
from nnstreamer_tpu.models import layers as jlayers
from nnstreamer_tpu.parallel import train as jt
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu.trainer import TensorTrainer as JTrainer
from nnstreamer_tpu_torch.core.errors import NNStreamerTPUError
from nnstreamer_tpu_torch.models import audio_classifier as taudio
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.parallel import train as tt
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec
from nnstreamer_tpu_torch.trainer import TensorTrainer
from nnstreamer_tpu_torch.trainer.element import CHECKPOINT_FILE

W, NC = 0.35, 8


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


# -- train-mode BN --------------------------------------------------------

def test_train_mode_bn_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 5, 6, 7)) * 3 + 1).astype(np.float32)
    p = {k: rng.uniform(0.5, 1.5, 7).astype(np.float32)
         for k in ("scale", "bias", "mean", "var")}
    want = np.asarray(jlayers.batch_norm(p, jnp.asarray(x), train=True)[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    scale, bias = torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"])

    def err(y):
        return np.abs(y.permute(0, 2, 3, 1).numpy() - want).max()

    assert err(L.batch_norm_train(xt, scale, bias)) <= 1e-6
    # controls: the unbiased variance, or torch's eps, miss by far more
    assert err(L.batch_norm(xt, scale, bias, xt.mean(dim=(0, 2, 3)),
                            xt.var(dim=(0, 2, 3), correction=1))) > 1e-3
    assert err(L.batch_norm_train(xt, scale, bias, eps=1e-5)) > 1e-4


# -- the train step against JAX's make_train_step -------------------------

OPTIMIZERS = {"sgd": (optax.sgd, tt.sgd, 0.05),
              "adam": (optax.adam, tt.adam, 1e-2),
              "adamw": (optax.adamw, tt.adamw, 1e-2)}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_audio_train_steps_match_jax(name):
    jopt_f, topt_f, lr = OPTIMIZERS[name]
    rng = np.random.default_rng(3)
    jp = np_tree(jaudio.init_params(num_classes=4))
    batches = [(rng.standard_normal((4, 256, 1)).astype(np.float32),
                (np.arange(4) % 4).astype(np.int32)) for _ in range(3)]
    jopt = jopt_f(lr)
    jstate = jt.init_state(jax.tree_util.tree_map(jnp.asarray, jp), jopt)
    jloss = jaudio.loss_fn
    jstep = jt.make_train_step(jloss, jopt)
    jgrad = jax.jit(jax.grad(jloss))
    params = bridge.audio_classifier_params(jp)
    st = tt.init_state(params, topt_f(lr))
    step = tt.make_train_step(lambda p, x, y: taudio.loss_fn(p, x, y),
                              topt_f(lr))
    # per element: the smallest |grad| JAX saw over the steps
    gmin = None
    for x, y in batches:
        g = tt.leaves(bridge.audio_classifier_params(np_tree(
            jgrad(jstate.params, jnp.asarray(x), jnp.asarray(y)))))
        gmin = [a.abs() for a in g] if gmin is None else \
            [torch.minimum(m, a.abs()) for m, a in zip(gmin, g)]
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        st, tl = step(st, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert st.step == 3
    want = bridge.audio_classifier_params(np_tree(jstate.params))
    scale = max(float(t.abs().max()) for t in tt.leaves(want))
    for got, w, gm in zip(tt.leaves(st.params), tt.leaves(want), gmin):
        d = (got.detach() - w).abs()
        if name == "sgd":
            assert float(d.max()) <= 1e-5 * scale
            continue
        # Adam divides by the root of the second moment: where |grad| was
        # f32 noise (below 1e-4 of the leaf's largest) an update of up to
        # lr goes either way, in either package
        noise = gm < 1e-4 * float(gm.max())
        assert float(d[~noise].max()) <= 2e-5 * scale
        assert float(d.max()) <= 2 * lr * len(batches)


def test_adamw_decays_bn_stats_and_sgd_adam_leave_them():
    """The leaf set is JAX's: every BN mean and var gets a zero gradient,
    so adamw's decay reaches it (torch would skip a leaf with no grad)."""
    for opt, decays in ((tt.adamw(0.1), True), (tt.adam(0.1), False),
                        (tt.sgd(0.1), False)):
        model = tm.init_params(width=W, num_classes=NC)
        var0 = model.stem.var.clone()
        st = tt.init_state(model, opt)
        step = tt.make_train_step(
            lambda p, a, b: tm.loss_fn(p, a, b, dtype=torch.float32), opt)
        x = torch.randn(2, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(0))
        step(st, x, torch.tensor([1, 2]))
        want = var0 * (1 - 0.1 * tt.ADAMW_WEIGHT_DECAY) if decays else var0
        assert torch.allclose(model.stem.var.detach(), want, rtol=0,
                              atol=1e-7)


def test_mesh_paths_train_the_audio_classifier_sharded(monkeypatch):
    """`shard_state` and `make_train_step(mesh=...)` on a tensor tree (the
    audio classifier, JAX's params): 3 sgd steps over dp 2 × tp 2 of 4
    logical CPU devices against the one-device steps, losses within 1e-5
    relative and every leaf within 1e-5 (no BN: the steps do not part)."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "4")
    tree = np_tree(jaudio.init_params(num_classes=4))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 256, 1)).astype(np.float32))
    y = torch.arange(4) % 4

    def loss(p, a, b):
        return taudio.loss_fn(p, a, b)

    one = tt.init_state(bridge.audio_classifier_params(tree), tt.sgd(0.05))
    mesh = make_mesh(MeshSpec(dp=2, tp=2))
    sh = tt.shard_state(tt.init_state(bridge.audio_classifier_params(tree),
                                      tt.sgd(0.05)), mesh)
    step1 = tt.make_train_step(loss, tt.sgd(0.05))
    step2 = tt.make_train_step(loss, tt.sgd(0.05), mesh=mesh)
    for _ in range(3):
        one, l1 = step1(one, x, y)
        sh, l2 = step2(sh, x, y)
        assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    got = tt.leaves(sh.params.unsharded(torch.device("cpu")))
    for g, w in zip(got, tt.leaves(one.params)):
        assert float((g - w.detach()).abs().max()) <= 1e-5


# -- tensor_trainer -------------------------------------------------------

def _run(nns, Buf, trainer, spec, frames, AppSrc, TensorSink):
    src = AppSrc(spec=spec, name="src")
    sink = TensorSink(name="s")
    pipe = nns.Pipeline()
    for e in (src, trainer, sink):
        pipe.add(e)
    pipe.link(src, trainer)
    pipe.link(trainer, sink)
    runner = nns.PipelineRunner(pipe).start()
    for i, (x, y) in enumerate(frames):
        src.push(Buf.of(x, y, pts=i))
    src.end()
    runner.wait(120)
    return [np.asarray(r.tensors[0]) for r in sink.results]


def _tspec(xshape):
    return TensorsSpec.of(TensorInfo(xshape, DType.FLOAT32),
                          TensorInfo((xshape[0],), DType.INT32))


def _jspec(xshape):
    return JSpec.of(JInfo(xshape, JDType.FLOAT32),
                    JInfo((xshape[0],), JDType.INT32))


def _port(trainer, xshape, frames):
    return _run(tnns, TensorBuffer, trainer, _tspec(xshape), frames,
                tel.AppSrc, tel.TensorSink)


def test_trainer_element_loss_decreases(tmp_path):
    """The port case of JAX's test_runtime_extras.py
    ::test_trainer_element_loss_decreases."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.int32)
    tr = TensorTrainer(
        name="tr", model="zoo://mobilenet_v2?width=0.35&num_classes=8",
        optimizer="adam:0.01", checkpoint_dir=str(tmp_path),
        checkpoint_every=6)
    losses = _port(tr, (4, 32, 32, 3), [(x, y)] * 6)
    assert len(losses) == 6
    assert all(l.shape == (1,) and l.dtype == np.float32 for l in losses)
    assert losses[-1][0] < losses[0][0], losses
    assert tr.steps == 6
    assert (tmp_path / "step_6" / CHECKPOINT_FILE).exists()


def test_audio_classifier_tensor_trainer_pipeline_matches_jax(tmp_path):
    """The port case of JAX's test_streaming_models.py
    ::test_audio_classifier_tensor_trainer_pipeline, held to JAX's
    trainer on the same frames from JAX's initial params (a params-only
    checkpoint through resume_from)."""
    rng = np.random.default_rng(0)
    frames = [(rng.normal(size=(4, 256, 1)).astype(np.float32),
               (np.arange(4) % 4).astype(np.int32)) for _ in range(3)]
    jt_ = JTrainer(name="t", model="zoo://audio_classifier?num_classes=4",
                   optimizer="sgd:0.05")
    want = _run(jnns, JBuf, jt_, _jspec((4, 256, 1)), frames,
                jel.AppSrc, jel.TensorSink)
    ck = tmp_path / "init"
    ck.mkdir()
    torch.save(bridge.audio_classifier_params(
        np_tree(jaudio.init_params(num_classes=4))), ck / CHECKPOINT_FILE)
    tr = TensorTrainer(name="t", model="zoo://audio_classifier?num_classes=4",
                       optimizer="sgd:0.05", resume_from=str(ck))
    got = _port(tr, (4, 256, 1), frames)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-5)
    final = bridge.audio_classifier_params(np_tree(jt_.params))
    for g, w in zip(tt.leaves(tr.params), tt.leaves(final)):
        assert float((g.detach() - w).abs().max()) <= 1e-5


def test_checkpoint_resume_continues_the_trajectory(tmp_path):
    """Resume restores params, the optimizer's moments and the step: 3
    steps, a checkpoint, then 3 more from it equal 6 uninterrupted, bit
    for bit on the CPU."""
    rng = np.random.default_rng(0)
    frames = [(rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
               (np.arange(4) % 8).astype(np.int32)) for _ in range(6)]
    model, opt, xs = ("zoo://mobilenet_v2?width=0.35&num_classes=8",
                      "adam:0.01", (4, 16, 16, 3))
    t0 = TensorTrainer(name="t0", model=model, optimizer=opt)
    full = _port(t0, xs, frames)
    t1 = TensorTrainer(name="t1", model=model, optimizer=opt,
                       checkpoint_dir=str(tmp_path), checkpoint_every=3)
    first = _port(t1, xs, frames[:3])
    t2 = TensorTrainer(name="t2", model=model, optimizer=opt,
                       resume_from=str(tmp_path / "step_3"))
    rest = _port(t2, xs, frames[3:])
    assert t2.steps == 6
    np.testing.assert_array_equal(np.concatenate(first + rest),
                                  np.concatenate(full))
    for a, b in zip(tt.leaves(t0.params), tt.leaves(t2.params)):
        assert torch.equal(a, b)


def test_params_only_resume_restarts_the_moments(tmp_path, caplog):
    model = tm.init_params(width=W, num_classes=NC, seed=3)
    ck = tmp_path / "p"
    ck.mkdir()
    torch.save(model.state_dict(), ck / CHECKPOINT_FILE)
    tr = TensorTrainer(name="t", model=f"zoo://mobilenet_v2?width={W}&"
                       f"num_classes={NC}", optimizer="adam:0.01",
                       resume_from=str(ck))
    with caplog.at_level(logging.WARNING):
        tr.negotiate([_tspec((2, 16, 16, 3))])
    assert "legacy params-only checkpoint; optimizer state restarts " \
           "fresh" in caplog.text
    assert tr.steps == 0 and not tr._state.opt_state.state
    for k, v in tr.params.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


ERRORS = [
    ({"model": "foo.tflite"}, 2),
    ({"model": "zoo://posenet"}, 2),
    ({"model": "zoo://no_such_model"}, 2),
    ({"model": "zoo://audio_classifier", "optimizer": "rmsprop:0.1"}, 2),
    ({"model": "zoo://audio_classifier"}, 1),
]


@pytest.mark.parametrize("props,n", ERRORS,
                         ids=["not_zoo", "not_trainable", "no_module",
                              "unknown_optimizer", "one_tensor"])
def test_error_texts_are_jax_texts(props, n):
    tinfo = [TensorInfo((2, 8, 1), DType.FLOAT32),
             TensorInfo((2,), DType.INT32)][:n]
    jinfo = [JInfo((2, 8, 1), JDType.FLOAT32), JInfo((2,), JDType.INT32)][:n]
    with pytest.raises(Exception) as je:
        JTrainer(name="t", **props).negotiate([JSpec.of(*jinfo)])
    with pytest.raises(NNStreamerTPUError) as te:
        TensorTrainer(name="t", **props).negotiate([TensorsSpec.of(*tinfo)])
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value).replace(
        "nnstreamer_tpu.", "nnstreamer_tpu_torch.")


def test_mesh_property_trains_on_the_mesh(monkeypatch):
    """``mesh=dp=2``: the trainer places its state on the mesh and its
    losses follow the one-device trainer's within 1e-5 relative."""
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "2")
    rng = np.random.default_rng(0)
    frames = [(rng.normal(size=(4, 256, 1)).astype(np.float32),
               (np.arange(4) % 4).astype(np.int32)) for _ in range(3)]
    kw = dict(model="zoo://audio_classifier?num_classes=4",
              optimizer="sgd:0.05")
    want = _port(TensorTrainer(name="t0", **kw), (4, 256, 1), frames)
    tr = TensorTrainer(name="t1", mesh="dp=2", **kw)
    got = _port(tr, (4, 256, 1), frames)
    assert isinstance(tr.params, tt.ShardedParams) and tr.steps == 3
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-5)
