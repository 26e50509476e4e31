"""The port's sharded training (parallel/train.py `shard_state`,
`make_train_step(mesh=...)`, trainer/element.py ``mesh=``) against the
JAX package's sharded step, on the CPU.

The port runs on 8 logical CPU devices (``[parallel] virtual_devices=8``),
JAX on its 8 virtual CPU devices (tests/conftest.py). The case is
tests/test_parallel.py's (MobileNetV2 width 0.35, 16 classes, 32²,
batch 8, dp 4 × tp 2, sgd 0.1) on JAX's own initial parameters, carried
across by models/bridge.py, with a seeded random batch in place of ones:
rows that are all alike would give every shard the global batch's BN
statistics, and the control below could not miss.

Tolerances: the loss at the same params within 1e-5 relative (a
free-running later step's within 1e-3, as phase 55's); the parameters
after the
step, per leaf, |port − JAX| over the leaf's movement in JAX's step
(tools/train_spread.agreement): median at most 5e-2, largest at most
3e-1 (chip_smoke.py phase 55's limits; the one-device port reads about
2e-2 and 1e-1 here, float32's own spread at 32², where the last blocks'
BN sees 2 values a shard). The control takes each shard's own BN
statistics (`layers.batch_stats` as a no-op) and must miss the median.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.parallel import MeshSpec as JMeshSpec
from nnstreamer_tpu.parallel import make_mesh as j_make_mesh
from nnstreamer_tpu.parallel import make_train_step as j_make_train_step
from nnstreamer_tpu.parallel.train import init_state as j_init_state
from nnstreamer_tpu.parallel.train import shard_state as j_shard_state
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.parallel import train as tt
from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec
from nnstreamer_tpu_torch.tools.train_spread import agreement
from nnstreamer_tpu_torch.trainer import TensorTrainer
from nnstreamer_tpu_torch.trainer.element import CHECKPOINT_FILE

W, NC, LR = 0.35, 16, 0.1
LOSS_REL, FREE_REL, MEDIAN, LARGEST = 1e-5, 1e-3, 5e-2, 3e-1


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    x = np.random.default_rng(3).standard_normal((8, 32, 32, 3)) \
        .astype(np.float32)
    return x, (np.arange(8) % NC).astype(np.int32)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's sharded step from its initial params → (initial params as
    numpy, loss, params after, as the port's state dict)."""
    import jax as _jax

    if len(_jax.devices()) < 8:
        pytest.skip(f"need 8 virtual devices, got {len(_jax.devices())}")
    params = jm.init_params(width=W, num_classes=NC)
    mesh = j_make_mesh(JMeshSpec(dp=4, tp=2, sp=1))
    state = j_shard_state(j_init_state(params, optax.sgd(LR)), mesh)
    step = j_make_train_step(
        lambda p, a, b: jm.loss_fn(p, a, b, width=W, dtype=jnp.float32),
        optax.sgd(LR), mesh=mesh, batch_spec=(P("dp"), P("dp")),
        donate=False)
    x, y = _batch()
    state2, loss = step(state, jnp.asarray(x), jnp.asarray(y))
    # a sharded JAX TrainState's params cross as its numpy tree would
    after = bridge.train_state_params(state2, bridge.mobilenet_v2_state_dict)
    want = bridge.mobilenet_v2_state_dict(np_tree(state2.params))
    assert all(torch.equal(after[k], want[k]) for k in want)
    return np_tree(params), float(loss), after


def _loss(p, a, b):
    return tm.loss_fn(p, a, b, dtype=torch.float32)


def _port_step(start, per_shard_bn=False, monkeypatch=None):
    model = bridge.load_mobilenet_v2(
        tm.MobileNetV2(W, NC, dtype=torch.float32), start)
    mesh = make_mesh(MeshSpec(dp=4, tp=2))
    state = tt.shard_state(tt.init_state(model, tt.sgd(LR)), mesh)
    step = tt.make_train_step(_loss, tt.sgd(LR), mesh=mesh,
                              batch_spec=[("dp",), ("dp",)])
    if per_shard_bn:
        monkeypatch.setattr(L, "batch_stats",
                            lambda reduce: contextlib.nullcontext())
    x, y = _batch()
    state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert state.step == 1
    got = state.params.unsharded(torch.device("cpu")).state_dict()
    return float(loss), got, step


def _agree(got, want, start):
    prev = bridge.mobilenet_v2_state_dict(start)
    as64 = (lambda d: {k: v.double() for k, v in d.items()})
    return agreement(as64(got), as64(want), as64(prev))


def test_sharded_step_matches_jax_sharded_step(jax_step):
    start, jloss, want = jax_step
    loss, got, step = _port_step(start)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    median, largest = _agree(got, want, start)
    assert median <= MEDIAN and largest <= LARGEST, (median, largest)
    # every leaf gathered onto every dp shard's device and BN's sums
    # sent home and back, each a counted copy between logical devices
    assert step.moves.count > 0


def test_per_shard_bn_statistics_miss(jax_step, monkeypatch):
    """The control: each shard normalized by its own rows' statistics
    (plain data parallelism) is another result."""
    start, jloss, want = jax_step
    loss, got, _ = _port_step(start, per_shard_bn=True,
                              monkeypatch=monkeypatch)
    median, _ = _agree(got, want, start)
    assert median > MEDIAN
    assert abs(loss - jloss) > LOSS_REL * abs(jloss)


def test_tp_split_leaves_live_as_slices(jax_step):
    """A conv's output channels split over tp (default_param_rules), the
    BN vectors whole on the first tp device, every part trainable."""
    start = jax_step[0]
    model = bridge.load_mobilenet_v2(
        tm.MobileNetV2(W, NC, dtype=torch.float32), start)
    mesh = make_mesh(MeshSpec(dp=4, tp=2))
    state = tt.shard_state(tt.init_state(model, tt.sgd(LR)), mesh)
    placed = state.params.placed
    stem = placed["stem.weight"]
    assert stem["dim"] == 0 and len(stem["parts"]) == 2
    assert stem["parts"][0].shape[0] * 2 == model.stem.weight.shape[0]
    assert placed["stem.mean"]["dim"] is None
    assert placed["classifier.weight"]["dim"] == 1
    assert all(p.requires_grad for p in state.params.masters())
    sd = state.params.unsharded(torch.device("cpu")).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_shard_state_keeps_each_moment_beside_its_leaf():
    """Adam's moments after a one-device step are cut as their leaves
    are and placed beside each part; sharding and unsharding give the
    moments back bit for bit."""
    model = tm.init_params(width=W, num_classes=NC)
    state = tt.init_state(model, tt.adam(1e-3))
    step = tt.make_train_step(_loss, tt.adam(1e-3))
    x, y = _batch()
    state, _ = step(state, torch.from_numpy(x[:4]), torch.from_numpy(y[:4]))
    mesh = make_mesh(MeshSpec(dp=4, tp=2))
    sh = tt.shard_state(state, mesh)
    assert type(sh.opt_state) is torch.optim.Adam
    assert sh.opt_state.param_groups[0]["lr"] == 1e-3
    for path, leaf in sh.params.placed.items():
        for part in leaf["parts"]:
            st = sh.opt_state.state[part]
            for k in ("exp_avg", "exp_avg_sq"):
                assert st[k].shape == part.shape and \
                    st[k].device == part.device, (path, k)
    back = tt.unshard_state(sh, torch.device("cpu"))
    old = dict(zip(tt.leaf_paths(model), tt.leaves(model)))
    new = dict(zip(tt.leaf_paths(back.params), tt.leaves(back.params)))
    for path, leaf in old.items():
        a, b = state.opt_state.state[leaf], back.opt_state.state[new[path]]
        assert torch.equal(a["exp_avg"], b["exp_avg"]), path
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]), path
        assert float(a["step"]) == float(b["step"])


def test_sharded_steps_teacher_forced_and_deterministic():
    """Two sgd steps sharded (dp 2 × tp 2), each against a one-device step
    from the sharded run's own params (teacher-forced: free-running f32
    steps part within a few steps at this size, in either package):
    losses within 1e-5 relative, parameters by the agreement rule. A
    second sharded run gives every loss and parameter bit for bit (BN's
    sums are always reduced in shard 0's thread)."""
    x, y = _batch()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    mesh = make_mesh(MeshSpec(dp=2, tp=2))
    runs = []
    for _ in range(2):
        state = tt.shard_state(tt.init_state(
            tm.init_params(width=W, num_classes=NC, seed=2), tt.sgd(LR)),
            mesh)
        step = tt.make_train_step(_loss, tt.sgd(LR), mesh=mesh)
        losses = []
        for k in range(2):
            start = state.params.unsharded(torch.device("cpu"))
            prev = {n: v.clone() for n, v in start.state_dict().items()}
            one = tt.init_state(start, tt.sgd(LR))
            one, l1 = tt.make_train_step(_loss, tt.sgd(LR))(one, xs, ys)
            state, l2 = step(state, xs, ys)
            losses.append(float(l2))
            assert abs(float(l1) - float(l2)) <= LOSS_REL * abs(float(l1))
            got = state.params.unsharded(torch.device("cpu")).state_dict()
            as64 = (lambda d: {n: v.double() for n, v in d.items()})
            median, largest = agreement(as64(got), as64(start.state_dict()),
                                        as64(prev))
            assert median <= MEDIAN and largest <= LARGEST, (k, median,
                                                             largest)
        runs.append((losses, got))
    assert runs[0][0] == runs[1][0]
    for n, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][n]), n


def test_sharded_step_refusals():
    model = tm.init_params(width=W, num_classes=NC)
    mesh = make_mesh(MeshSpec(dp=4, tp=2))
    step = tt.make_train_step(_loss, tt.sgd(LR), mesh=mesh)
    x, y = _batch()
    with pytest.raises(PipelineError, match="shard_state"):
        step(tt.init_state(model, tt.sgd(LR)), torch.from_numpy(x),
             torch.from_numpy(y))
    state = tt.shard_state(tt.init_state(model, tt.sgd(LR)), mesh)
    with pytest.raises(PipelineError, match="does not split"):
        step(state, torch.from_numpy(x[:6]), torch.from_numpy(y[:6]))


# -- tensor_trainer mesh= ------------------------------------------------------

def _run(trainer, frames):
    src = tel.AppSrc(spec=TensorsSpec.of(
        TensorInfo((8, 64, 64, 3), DType.FLOAT32),
        TensorInfo((8,), DType.INT32)), name="src")
    sink = tel.TensorSink(name="s")
    pipe = tnns.Pipeline()
    for e in (src, trainer, sink):
        pipe.add(e)
    pipe.link(src, trainer)
    pipe.link(trainer, sink)
    runner = tnns.PipelineRunner(pipe).start()
    for i, (x, y) in enumerate(frames):
        src.push(TensorBuffer.of(x, y, pts=i))
    src.end()
    runner.wait(120)
    return [float(np.asarray(r.tensors[0])[0]) for r in sink.results]


def _frames(n):
    rng = np.random.default_rng(5)
    return [(rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
             (np.arange(8) % NC).astype(np.int32)) for _ in range(n)]


MODEL = f"zoo://mobilenet_v2?width={W}&num_classes={NC}"
#: the trainer's frames are 64² (the last blocks' maps 2×2, as
#: tests/test_torch_train_step.py's): at 16² BN takes each last-block
#: statistic over 8 values and two adam steps leave the model where f32
#: rounding alone moves the loss at the same params by ~2e-5


def test_trainer_mesh_trains_as_one_device():
    """``mesh=dp=2,tp=2``: the first step's loss (the same zoo params) as
    the one-device trainer's within 1e-5 relative, the state on the
    mesh."""
    frames = _frames(1)
    one = _run(TensorTrainer(name="t0", model=MODEL, optimizer="sgd:0.05"),
               frames)
    tr = TensorTrainer(name="t1", model=MODEL, optimizer="sgd:0.05",
                       mesh="dp=2,tp=2")
    meshed = _run(tr, frames)
    assert len(one) == len(meshed) == 1 and tr.steps == 1
    assert abs(one[0] - meshed[0]) <= LOSS_REL * abs(one[0])
    assert isinstance(tr.params, tt.ShardedParams)


def test_checkpoint_under_a_mesh_resumes_with_or_without_one(tmp_path):
    """A checkpoint written under a mesh holds whole leaves and whole
    moments: 2 adam steps and a checkpoint, then 2 more from it under the
    mesh, bit for bit the 4 uninterrupted ones; and from it without a
    mesh, whose first step (the same params and moments) is within 1e-5
    of the mesh's."""
    frames = _frames(4)
    kw = dict(model=MODEL, optimizer="adam:0.01")
    full = _run(TensorTrainer(name="a", mesh="dp=2,tp=2", **kw), frames)
    _run(TensorTrainer(name="b", mesh="dp=2,tp=2",
                       checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       **kw), frames[:2])
    blob = torch.load(tmp_path / "step_2" / CHECKPOINT_FILE,
                      weights_only=True)
    ref = tm.init_params(width=W, num_classes=NC).state_dict()
    assert set(blob["params"]) == set(ref)
    for k, v in ref.items():
        assert blob["params"][k].shape == v.shape, k
    tr = TensorTrainer(name="c", mesh="dp=2,tp=2",
                       resume_from=str(tmp_path / "step_2"), **kw)
    assert _run(tr, frames[2:]) == full[2:] and tr.steps == 4
    tr = TensorTrainer(name="d", resume_from=str(tmp_path / "step_2"), **kw)
    rest = _run(tr, frames[2:3])
    assert tr.steps == 3
    assert abs(rest[0] - full[2]) <= LOSS_REL * abs(full[2])
