"""The plain references against outputs computed by hand (explicit loops
in numpy) at a tiny size, against the port as a second witness, and
the control (fp8) as measurably worse."""

import ast
import glob
import math
import os

import numpy as np
import pytest
import torch

from benchmark.reference import decoder, mobilenet_v2
from benchmark.reference.precision import fp8

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_LM = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 6,
           "num_hidden_layers": 2, "vocab_size": 11, "rope_theta": 10000.0,
           "served_rms_norm_eps": 1e-6}


def _lm_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    d, q, kv, ff, v = 8, 8, 4, 6, 11

    def n(*s, norm=False):
        t = torch.randn(*s, generator=g) * 0.5
        return t + 1.0 if norm else t
    return {"embed": n(v, d), "blocks": [
        {"ln1": n(d, norm=True), "wqkv": n(d, q + 2 * kv), "wo": n(q, d),
         "ln2": n(d, norm=True), "wi": n(d, 2 * ff), "wd": n(ff, d)}
        for _ in range(2)], "ln_f": n(d, norm=True), "head": n(d, v)}


def _by_hand(params, ids):
    """The decoder written out with loops: positions, heads, keys."""
    P = {k: (v.double().numpy() if torch.is_tensor(v) else v)
         for k, v in params.items()}
    x = np.stack([P["embed"][i] for i in ids])
    S, H, hd, eps = len(ids), 2, 4, 1e-6

    def norm(v, w):
        return v / np.sqrt((v * v).mean() + eps) * w

    def rot(vec, p):
        out = vec.copy()
        for i in range(hd // 2):
            ang = p / 10000.0 ** (i / (hd // 2))
            a, b = vec[i], vec[i + hd // 2]
            out[i] = a * math.cos(ang) - b * math.sin(ang)
            out[i + hd // 2] = a * math.sin(ang) + b * math.cos(ang)
        return out

    for blk in params["blocks"]:
        B = {k: v.double().numpy() for k, v in blk.items()}
        h = np.stack([norm(x[p], B["ln1"]) for p in range(S)])
        qkv = h @ B["wqkv"]
        out = np.zeros((S, H * hd))
        for p in range(S):
            for hh in range(H):
                q = rot(qkv[p, hh * hd:(hh + 1) * hd], p)
                scores = []
                for k in range(p + 1):         # one kv head for both
                    kk = rot(qkv[k, 8:12], k)
                    scores.append(q @ kk / math.sqrt(hd))
                w = np.exp(np.array(scores) - max(scores))
                w /= w.sum()
                out[p, hh * hd:(hh + 1) * hd] = sum(
                    w[k] * qkv[k, 12:16] for k in range(p + 1))
        x = x + out @ B["wo"]
        h = np.stack([norm(x[p], B["ln2"]) for p in range(S)])
        gu = h @ B["wi"]
        gate, up = gu[:, :6], gu[:, 6:]
        x = x + (gate / (1 + np.exp(-gate)) * up) @ B["wd"]
    return np.stack([norm(x[p], P["ln_f"]) for p in range(S)]) @ P["head"]


def test_decoder_equals_the_hand_computation():
    params = _lm_params()
    ids = [3, 1, 4, 1, 5, 9]
    (got,) = decoder.logits_at(params, [torch.tensor(ids)],
                               [torch.arange(6)], TINY_LM)
    np.testing.assert_allclose(got[0].double().numpy(),
                               _by_hand(params, ids), rtol=1e-4, atol=1e-4)


def test_decoder_agrees_with_the_port_transformer():
    """A second witness: the port's f32 full forward on the same dict."""
    from nnstreamer_tpu_torch.models import transformer as tt

    params = _lm_params(1)
    ids = torch.tensor([[2, 7, 1, 8, 2, 8, 1]])
    want = tt.apply_seq_kv(params, ids, n_heads=2)[0][0]
    (got,) = decoder.logits_at(params, [ids[0]], [torch.arange(7)], TINY_LM)
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)


def test_decoder_fp8_control_is_measurably_worse():
    params = _lm_params(2)
    ids = torch.arange(11)
    f32, f8 = decoder.logits_at(params, [ids], [torch.arange(11)], TINY_LM,
                                ("f32", "fp8"))
    err = (f8[0] - f32[0]).abs().max().item()
    assert err > 1e-2 * f32[0].abs().max().item()


TINY_MB = {"width_multiplier": 1.0, "input_size": 4, "first_channels": 8,
           "last_channels": 16, "num_classes": 3, "bn_eps": 1e-3,
           "inverted_residual_setting": [[1, 8, 1, 1], [2, 8, 1, 1]]}


def _mb_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in mobilenet_v2.param_shapes(TINY_MB):
        t = torch.randn(*shape, generator=g) * 0.3
        if kind in ("scale", "var"):
            t = t.abs() + 0.5
        out[name] = t
    return out


def _conv_same(x, w, stride, groups):
    """NCHW conv by loops, TF SAME padding."""
    n, c, h, wd = x.shape
    o, cg, k, _ = w.shape
    oh = -(-h // stride)
    pad = max((oh - 1) * stride + k - h, 0)
    p0 = pad // 2
    xp = np.pad(x, ((0, 0), (0, 0), (p0, pad - p0), (p0, pad - p0)))
    out = np.zeros((n, o, oh, oh))
    per = o // groups
    for oc in range(o):
        g = oc // per
        for i in range(oh):
            for j in range(oh):
                r, c = i * stride, j * stride
                patch = xp[:, g * cg:(g + 1) * cg, r:r + k, c:c + k]
                out[:, oc, i, j] = (patch * w[oc]).sum(axis=(1, 2, 3))
    return out


def _mb_by_hand(P, frames):
    P = {k: v.double().numpy() for k, v in P.items()}
    x = ((frames.astype(np.float64) - 127.5) / 127.5).transpose(0, 3, 1, 2)

    def unit(name, x, stride, groups, act):
        y = _conv_same(x, P[f"{name}.weight"], stride, groups)
        sh = (1, -1, 1, 1)
        y = (y - P[f"{name}.mean"].reshape(sh)) / np.sqrt(
            P[f"{name}.var"].reshape(sh) + 1e-3) * \
            P[f"{name}.scale"].reshape(sh) + P[f"{name}.bias"].reshape(sh)
        return np.clip(y, 0, 6) if act else y

    x = unit("stem", x, 2, 1, True)                       # 3 -> 8, 2x2
    y = unit("blocks.0.depthwise", x, 1, 8, True)         # t = 1: no expand
    x = unit("blocks.0.project", y, 1, 1, False) + x      # 8 -> 8: residual
    y = unit("blocks.1.expand", x, 1, 1, True)            # 8 -> 16
    y = unit("blocks.1.depthwise", y, 1, 16, True)
    x = unit("blocks.1.project", y, 1, 1, False) + x
    x = unit("head", x, 1, 1, True).mean(axis=(2, 3))
    return x @ P["classifier.weight"].T + P["classifier.bias"]


def test_mobilenet_equals_the_hand_computation():
    P = _mb_params()
    frames = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3),
                                               dtype=np.uint8)
    got = mobilenet_v2.forward(P, torch.from_numpy(frames), TINY_MB)
    np.testing.assert_allclose(got.double().numpy(), _mb_by_hand(P, frames),
                               rtol=1e-4, atol=1e-4)


def test_mobilenet_agrees_with_the_port_in_float32():
    """A second witness: the port's module in f32 on the same weights."""
    from benchmark.drivers.pipeline_vision import build_model

    cfg = dict(TINY_MB, input_size=32, width_multiplier=0.35,
               num_classes=1001, first_channels=32, last_channels=1280,
               dtype="float32",
               inverted_residual_setting=[[1, 16, 1, 1], [6, 24, 2, 2],
                                          [6, 32, 3, 2], [6, 64, 4, 2],
                                          [6, 96, 3, 1], [6, 160, 3, 2],
                                          [6, 320, 1, 1]])
    g = torch.Generator().manual_seed(3)
    P = {}
    for name, shape, kind in mobilenet_v2.param_shapes(cfg):
        t = torch.randn(*shape, generator=g) * 0.2
        P[name] = t.abs() + 0.5 if kind in ("scale", "var") else t
    model = build_model(cfg, {k: v.clone() for k, v in P.items()}).params
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    want = model((frames.float() - 127.5) / 127.5)
    got = mobilenet_v2.forward(P, frames, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_rounding():
    x = torch.tensor([[1.0, 0.3, -448.0 / 3]])
    y = fp8(x, (-1,))
    assert y[0, 2].item() == pytest.approx(-448.0 / 3)
    assert 0 < abs(y[0, 1].item() - 0.3) < 0.3 * 2 ** -3


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(BENCH, "reference", "*.py"))
    + glob.glob(os.path.join(BENCH, "cost", "*.py"))))
def test_yardstick_imports_nothing_of_the_program(path):
    """References and cost code import neither jax, nor the JAX package,
    nor anything of the port (top-level names compared whole)."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "nnstreamer_tpu",
                        "nnstreamer_tpu_torch"}, names
