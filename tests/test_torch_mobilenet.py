"""The port's MobileNetV2 (nnstreamer_tpu_torch/models) against the JAX
package's, on the same parameters carried across by the weights bridge.

Inputs and BN statistics are made from seeded numpy. Both sides run f32
on the CPU. Tolerance: the layer tests 1e-5 absolute on O(1) values; the
whole model 1e-4 relative to max |logit| — the two frameworks' conv
kernels sum in different orders, and that difference grows over the
network's 50-odd layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import layers as jl
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import layers as tl
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def randomize_bn(params, seed=0):
    """Replace every BN's identity init with seeded random statistics, so
    the BN formula is exercised (numpy leaves, returned as a new tree)."""
    rng = np.random.default_rng(seed)

    def walk(p):
        if isinstance(p, dict):
            if set(p) == {"scale", "bias", "mean", "var"}:
                n = p["scale"].shape[0]
                return {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32),
                        "mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return np.asarray(p)

    return walk(params)


def port_model(np_params, width, dtype=torch.float32):
    return bridge.load_mobilenet_v2(
        tm.MobileNetV2(width, dtype=dtype).eval(), np_params)


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("n,stride,k", [(8, 1, 3), (9, 1, 3), (8, 2, 3),
                                        (9, 2, 3), (8, 2, 1), (7, 1, 1)])
def test_same_pads_match_tf_rule(n, stride, k):
    out = -(-n // stride)
    before, after = tl.same_pads(n, k, stride)
    assert before + after == max((out - 1) * stride + k - n, 0)
    assert before == (before + after) // 2
    if (n, stride, k) == (8, 2, 3):
        assert (before, after) == (0, 1)   # stride-2, even size: 0 / 1


@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
def test_conv2d_same_matches_jax(size, stride, depthwise):
    rng = np.random.default_rng(size * 10 + stride)
    c = 6
    cout = c if depthwise else 5
    groups = c if depthwise else 1
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, c // groups, cout)).astype(np.float32)
    ref = np.asarray(jl.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x),
                               stride=stride, groups=groups))
    got = tl.conv2d(_nhwc_to_nchw(x), _hwio_to_oihw(w), stride=stride,
                    groups=groups).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride,groups,act", [(1, 1, True), (2, 1, True),
                                               (2, 6, True), (1, 1, False)],
                         ids=["s1", "s2", "s2-depthwise", "s1-noact"])
def test_conv_bn_matches_jax(stride, groups, act):
    rng = np.random.default_rng(3)
    c, cout = 6, (6 if groups > 1 else 4)
    x = rng.standard_normal((1, 10, 10, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, c // groups, cout)).astype(np.float32)
    p = randomize_bn({"conv": {"w": w}, "bn": {
        k: np.zeros(cout, np.float32)
        for k in ("scale", "bias", "mean", "var")}}, seed=4)
    ref = np.asarray(jl.conv_bn(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), stride=stride, groups=groups,
                                act=jl.relu6 if act else None))
    m = tl.ConvBN(c, cout, 3, stride=stride, groups=groups, act=act)
    m.load_state_dict(bridge.conv_bn_state(p, ""))
    with torch.inference_mode():
        got = m(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_bridge_state_dict_covers_the_module_exactly():
    jp = randomize_bn(_np_tree(jm.init_params(width=0.35, seed=1)))
    sd = bridge.mobilenet_v2_state_dict(jp)
    model = tm.MobileNetV2(0.35)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # depthwise HWIO (3,3,1,C) → (C,1,3,3), dense (cin,cout) → (cout,cin)
    dw = jp["blocks"][1]["depthwise"]["conv"]["w"]
    np.testing.assert_array_equal(sd["blocks.1.depthwise.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["classifier.weight"].numpy(),
                                  jp["classifier"]["w"].T)


def test_zoo_init_is_seeded():
    a = tm.build(width=0.35, input_size=32, seed=3).params.state_dict()
    b = tm.build(width=0.35, input_size=32, seed=3).params.state_dict()
    c = tm.build(width=0.35, input_size=32, seed=4).params.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.weight"], c["stem.weight"])


def _compare_model(width, size, batch, seed):
    jp = randomize_bn(_np_tree(jm.init_params(width=width, seed=seed)),
                      seed=seed)
    x = np.random.default_rng(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                              jnp.asarray(x), width=width,
                              dtype=jnp.float32))
    with torch.inference_mode():
        got = port_model(jp, width)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (batch, 1001)
    assert got.dtype == np.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_mobilenet_v2_width035_input64_matches_jax():
    _compare_model(0.35, 64, 2, seed=5)


def test_mobilenet_v2_full_width_input224_matches_jax():
    _compare_model(1.0, 224, 1, seed=6)
