"""The port's MobileNetV2 training step (models/layers.batch_norm_train,
mobilenet_v2.loss_fn, parallel/train.py) against the JAX package's
`jax.grad` and `make_train_step`, on the CPU.

The parameters are a seeded numpy tree in JAX's layout, carried to the
port by models/bridge.py. Width 0.35, 64×64, batch 4. Tolerances:

- the train-mode forward: logits within 1e-4 of the largest; the stored
  BN mean and var untouched; the inference path still the
  stored-statistics BN, bit for bit.
- the gradient, leaf by leaf: within GRAD_RTOL of the leaf's largest
  |grad| plus GRAD_FLOOR of the model's largest; BN mean and var get
  none in either package. A control with the BN statistics detached
  from the graph misses on most leaves.
- `sgd`, `adam` and `adamw`, 3 steps teacher-forced (each step starts
  both packages from JAX's parameters and moments): losses within 1e-4
  relative. `sgd` parameters within lr times the gradient's tolerance.
  Adam divides each gradient by its own root mean square, so an element
  whose gradient is f32 noise moves up to lr with a sign the noise picks,
  in either package: elements whose JAX |grad| is below NOISE of their
  leaf's largest (NOISE_SHARE of all at most) are held within 2.5·lr,
  the rest within ADAM_TIGHT·lr. The BN mean and var, whose gradient is
  zero, stay put under `sgd` and `adam` and decay by (1 − lr·1e-4) under
  `adamw`, as optax's do, within 1e-7.

The input is 64×64: at 32×32 the last blocks see 1×1 maps, so BN takes
statistics over 4 values, the gradients reach ~190 and f32 rounding
alone moves them by tens of percent between the packages (and between
JAX in f32 and in f64). Free running is not compared for the same
reason: JAX in f32 and in f64 part by ~10% of the loss within 3 steps.
These cases sit in a file of their own because JAX compiles the
MobileNetV2 step for ~8 s an optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.parallel import train as jt
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.parallel import train as tt
from nnstreamer_tpu_torch.tools.train_spread import detached_bn

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


@pytest.fixture(scope="module")
def mbv2_params():
    """A MobileNetV2 param tree in JAX's layout, filled from a numpy seed
    (kaiming-scaled convs, xavier dense, BN scale/bias/mean/var off their
    init values so train-mode BN must ignore the stored pair)."""
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: jm.init_params(width=W, num_classes=NC))

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if key.endswith("['w']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_mbv2(params):
    return bridge.load_mobilenet_v2(
        tm.MobileNetV2(W, NC, dtype=torch.float32), params)


def jax_leaves_of(model):
    """The port module's params and buffers in JAX's tree order."""
    return jax.tree_util.tree_leaves(bridge.mobilenet_v2_tree(model))


def test_train_forward_matches_jax_and_keeps_stored_stats(mbv2_params):
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)) \
        .astype(np.float32)
    model = port_mbv2(mbv2_params)
    before = {k: v.clone() for k, v in model.named_buffers()}
    want = np.asarray(jax.jit(lambda p, a: jm.apply(
        p, a, width=W, train=True, dtype=jnp.float32))(
            mbv2_params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k
    # the inference path is the stored-statistics BN, bit for bit
    with torch.no_grad():
        h = model.stem.weight.new_tensor(x).permute(0, 3, 1, 2)
        y = L.conv2d(h, model.stem.weight, stride=2, dtype=h.dtype)
        y = L.relu6(L.batch_norm(y, model.stem.scale, model.stem.bias,
                                 model.stem.mean, model.stem.var))
        assert torch.equal(model.stem(h), y)


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu"))


@pytest.fixture(scope="module")
def jgrad():
    """JAX's gradient of the MobileNetV2 loss, jitted once for the file."""
    return jax.jit(jax.grad(
        lambda p, a, b: jm.loss_fn(p, a, b, width=W, dtype=jnp.float32)))


def _batch(seed):
    x = np.random.default_rng(seed).standard_normal((4, 64, 64, 3)) \
        .astype(np.float32)
    return x, np.arange(4, dtype=np.int32)


def _port_grads(params, x, y):
    """The port's loss and per-leaf gradient (zero where the loss does not
    reach a leaf, as the train step gives it) → (loss, {state key: grad})."""
    model = port_mbv2(params)
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    for t in named.values():
        t.requires_grad_(True)
    loss = tm.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y),
                      width=W, dtype=torch.float32)
    loss.backward()
    return float(loss.detach()), {k: (t.grad if t.grad is not None
                             else torch.zeros_like(t)).detach()
                         for k, t in named.items()}


def _grad_misses(got, want):
    """Per leaf, |port − JAX| over the bound GRAD_RTOL·(the leaf's largest
    |grad|) + GRAD_FLOOR·(the largest |grad| of all leaves) → {key: ratio}
    of the leaves beyond it."""
    gmax = max(float(w.abs().max()) for w in want.values())
    out = {}
    for k, w in want.items():
        d = float((got[k] - w).abs().max())
        bound = GRAD_RTOL * float(w.abs().max()) + GRAD_FLOOR * gmax
        if d > bound:
            out[k] = d / bound
    return out


#: per-leaf gradient tolerance against JAX: GRAD_RTOL of the leaf's largest
#: |grad| (the leaves with a real gradient read at most 1.9e-4), plus
#: GRAD_FLOOR of the largest |grad| of the model for the leaves whose exact
#: gradient is zero and which both packages fill with f32 noise (each
#: block's project BN bias: the next train-mode BN takes a per-channel
#: shift out again; they read at most 5.7e-7 of it)
GRAD_RTOL, GRAD_FLOOR = 2e-3, 2e-6


def test_mobilenet_gradients_match_jax(mbv2_params, jgrad, monkeypatch):
    """The backward through train-mode BN and every block, leaf by leaf;
    and a control that must miss: BN with its batch statistics detached
    (the gradient that does not flow through the mean and var)."""
    x, y = _batch(4)
    want = bridge.mobilenet_v2_state_dict(np_tree(
        jgrad(mbv2_params, jnp.asarray(x), jnp.asarray(y))))
    _, got = _port_grads(mbv2_params, x, y)
    assert not _grad_misses(got, want)
    for k in want:
        if k.endswith((".mean", ".var")):
            assert not want[k].any() and not got[k].any(), k

    monkeypatch.setattr(L, "batch_norm_train", detached_bn)
    _, bad = _port_grads(mbv2_params, x, y)
    assert len(_grad_misses(bad, want)) > len(want) // 2


OPTIMIZERS = {"sgd": (optax.sgd, tt.sgd), "adam": (optax.adam, tt.adam),
              "adamw": (optax.adamw, tt.adamw)}
#: Adam and AdamW: elements whose JAX |grad| is above NOISE of the leaf's
#: largest (and above the gradient floor) within ADAM_TIGHT·lr of JAX's
#: (they read at most 2.8e-3·lr); at most NOISE_SHARE of all elements
#: below it (1.7% are)
NOISE, ADAM_TIGHT, NOISE_SHARE = 1e-3, 2e-2, 5e-2


def _teacher_forced(name, mbv2_params, jgrad, lr=1e-3, steps=3):
    """`steps` steps of `name`, each starting both packages from JAX's
    parameters and moments, held as the module docstring says."""
    jopt_f, topt_f = OPTIMIZERS[name]
    x, y = _batch(4)
    jopt = jopt_f(lr)
    jstate = jt.init_state(jax.tree_util.tree_map(jnp.asarray, mbv2_params),
                           jopt)
    jstep = jt.make_train_step(
        lambda p, a, b: jm.loss_fn(p, a, b, width=W, dtype=jnp.float32),
        jopt)
    tstep = tt.make_train_step(
        lambda p, a, b: tm.loss_fn(p, a, b, width=W, dtype=torch.float32),
        topt_f(lr))
    masked = total = 0
    for k in range(steps):
        start = np_tree(jstate.params)
        g = bridge.mobilenet_v2_state_dict(np_tree(
            jgrad(start, jnp.asarray(x), jnp.asarray(y))))
        gmax = max(float(a.abs().max()) for a in g.values())
        model = port_mbv2(start)
        st = tt.init_state(model, topt_f(lr))
        named = dict(model.named_parameters())
        named.update(model.named_buffers())
        if k and name != "sgd":
            adam = _adam_state(np_tree(jstate.opt_state))
            mu = bridge.mobilenet_v2_state_dict(adam.mu)
            nu = bridge.mobilenet_v2_state_dict(adam.nu)
            for key, p in named.items():
                st.opt_state.state[p] = {
                    "step": torch.tensor(float(adam.count)),
                    "exp_avg": mu[key].clone(), "exp_avg_sq": nu[key].clone()}
        p0 = {key: p.detach().clone() for key, p in named.items()}
        st, tl = tstep(st, torch.from_numpy(x), torch.from_numpy(y))
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), k
        want = bridge.mobilenet_v2_state_dict(np_tree(jstate.params))
        for key, p in named.items():
            d = (p.detach() - want[key]).abs()
            gl = g[key].abs()
            if key.endswith((".mean", ".var")):
                # zero gradient: sgd and adam leave the leaf; adamw's
                # decoupled weight decay alone acts on it
                assert float(d.max()) <= 1e-7, (k, key)
                continue
            # f32 rounding of p − update, in either package
            ulp = 2 * float(p0[key].abs().max()) * 2.0 ** -23
            if name == "sgd":
                # the update is lr·grad: the gradient's tolerance times lr
                bound = lr * (GRAD_RTOL * float(gl.max())
                              + GRAD_FLOOR * gmax) + ulp
                assert float(d.max()) <= bound, (k, key)
                continue
            noise = gl <= NOISE * float(gl.max()) + GRAD_FLOOR * gmax
            masked += int(noise.sum())
            total += noise.numel()
            if (~noise).any():
                assert float(d[~noise].max()) <= ADAM_TIGHT * lr + ulp, \
                    (k, key)
            assert float(d.max()) <= 2.5 * lr, (k, key)
    assert masked <= NOISE_SHARE * max(total, 1)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_mobilenet_steps_match_jax_teacher_forced(name, mbv2_params, jgrad):
    _teacher_forced(name, mbv2_params, jgrad)


def test_mobilenet_adamw_steps_match_jax_teacher_forced(mbv2_params, jgrad):
    _teacher_forced("adamw", mbv2_params, jgrad)
