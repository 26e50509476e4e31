"""Int8-native execution of quantized TFLite graphs (the JAX package's
modelio/tflite_quant.py in torch).

The dequantize → float lowering in `tflite.py` runs a quantized graph in
a float dtype. This module lowers a *fully quantized* graph (the
reference's `mobilenet_v2_1.0_224_quant.tflite` shape: per-tensor
uint8/int8, int32 bias) to integer arithmetic end to end, with the JAX
package's load-time constants and integer semantics:

- activations flow between ops as **int8** (uint8 tensors are shifted by
  -128 once at the graph input; every zero point is shifted with them,
  which changes no real value),
- zero points are handled by the accumulator decomposition

      Σ (x−zx)(w−zw) = conv(x,w) − zw·Σ_window(x) − zx·Σw + N·zx·zw

  with the runtime term `Σ_window(x)` computed **inside the same
  product** by appending one all-ones output channel to the weights;
  `Σw` per output channel and `N·zx·zw` fold into the bias at load time.
  SAME padding becomes an explicit pad with the input zero point so
  every window is full and `N` is uniform,
- each op requantizes its int32 accumulator as the JAX lowering does:
  the accumulator as f32, times the f32 multiplier `sx·sw/so`, rounded
  half to even (`torch.round`) plus the output zero point, saturated to
  the output tensor's quantized activation range (TFLite's
  `CalculateActivationRangeQuantized`, so fused RELU/RELU6 are honoured
  in the integer domain).

Where the JAX package runs s8×s8→s32 convs through
``lax.conv_general_dilated(..., preferred_element_type=int32)``, torch
has no integer conv on CUDA, and an f32 conv is not exact either
(|acc| reaches K·128·255, past 2²⁴ at K ≥ 514). So:

- **Dense convs and FULLY_CONNECTED** run as ``torch._int_mm`` (int8 ×
  int8 → int32, exact) on an im2col of the int8 input made by padding
  and slicing (a 1×1 stride-1 conv needs only a reshape). `_int_mm`'s
  CUDA shape rules — M > 16, K and N multiples of 8, the weight
  column-major — are met on every device: K is padded with zero columns
  (zero weight rows), N with zero weight columns, M with zero rows, the
  pads are sliced off, and the weight is stored (N, K) and passed as its
  transposed view. The
  classifier conv on a 1×1 map has M = 1, MobileNetV2's first conv
  K = 27, and the all-ones channel makes N odd.
- **Depthwise convs** are an int32 sum over the taps: the kh·kw slices
  of the padded int8 input stacked, widened to int32, times the
  zero-point-folded weights (w−zw ∈ [−255, 255], int32), summed over the
  taps. Integer arithmetic is exact on any device and for any
  summation order; a grouped f32 conv would be exact too (9 taps · 128 ·
  255 < 2²⁴) but only if no conv algorithm rounds (Winograd and FFT
  convs do).

Reference contract being re-done: the TFLite filter subplugin
delegating to interpreter kernels
(`ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc:154`);
the kernels' integer semantics follow tensorflow/lite/kernels/internal
(quantized conv/add/pool). Bit-exactness with TFLite's fixed-point
multiplier is not a goal (ties differ in the last bit); with the JAX
package's lowering it is.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.tflite import (
    OP, TensorDef, TFLiteGraph, LoweredModel, _static_input_indices,
    _ACT_NONE, _ACT_RELU, _ACT_RELU_N1_1, _ACT_RELU6, _PAD_SAME,
    _dev_const, batch_shaper, torch_dtype,
)

_QOPS = {OP[k] for k in (
    "CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "ADD", "MUL",
    "AVERAGE_POOL_2D", "MAX_POOL_2D", "MEAN", "RESHAPE", "SQUEEZE",
    "SOFTMAX", "LOGISTIC", "CONCATENATION", "PAD", "RELU", "RELU6",
    "DEQUANTIZE", "QUANTIZE",
)}

#: torch._int_mm's CUDA shape rules: M > INT_MM_MIN_M, K and N multiples
#: of INT_MM_ALIGN
INT_MM_MIN_M, INT_MM_ALIGN = 16, 8


def quantized_graph_supported(graph: TFLiteGraph) -> bool:
    """True when every op is in the integer vocabulary and every
    activation tensor carries per-tensor quantization (a float interior
    — e.g. a DEQUANTIZE→float-conv→QUANTIZE wrapper graph — falls back
    to the float lowering)."""
    if len(graph.subgraphs) > 1:     # control-flow models → float path
        return False
    static = _static_input_indices(graph)
    for op in graph.ops:
        if op.code not in _QOPS:
            return False
        if op.code in (OP["DEQUANTIZE"], OP["QUANTIZE"]):
            continue              # the explicit float↔int boundary ops
        for idx in list(op.inputs) + list(op.outputs):
            if idx < 0 or idx in static:
                continue
            t = graph.tensors[idx]
            if t.buffer is not None and t.dtype in (np.int32, np.int64):
                continue          # int32 bias / shape constants
            if not t.quantized or t.dtype not in (np.uint8, np.int8):
                return False
    for idx in graph.inputs + graph.outputs:
        t = graph.tensors[idx]
        if not t.quantized or t.dtype not in (np.uint8, np.int8):
            return False
    return True


def _shift(t: TensorDef) -> int:
    """Stored-domain → int8-domain shift (uint8 tensors move by -128)."""
    return -128 if t.dtype == np.uint8 else 0


def _qparams(t: TensorDef) -> Tuple[np.ndarray, np.ndarray]:
    """(scale, zero_point in the shifted int8 domain) for a tensor."""
    if t.scale is None or t.scale.size == 0:
        raise BackendError(
            f"tensor {t.index} ({t.name!r}) is not quantized; int8-native "
            f"lowering needs a fully quantized graph")
    zp = (t.zero_point if t.zero_point is not None
          else np.zeros_like(t.scale, np.int64))
    return t.scale.astype(np.float64), zp.astype(np.int64) + _shift(t)


def _act_qbounds(act: int, scale: float, zp: int) -> Tuple[int, int]:
    """Fused-activation clamp bounds in the (shifted) int8 domain —
    TFLite's CalculateActivationRangeQuantized."""
    lo, hi = -128, 127

    def q(v: float) -> int:
        return int(round(v / scale)) + zp

    if act == _ACT_RELU:
        lo = max(lo, q(0.0))
    elif act == _ACT_RELU6:
        lo, hi = max(lo, q(0.0)), min(hi, q(6.0))
    elif act == _ACT_RELU_N1_1:
        lo, hi = max(lo, q(-1.0)), min(hi, q(1.0))
    elif act != _ACT_NONE:
        raise BackendError(f"unsupported fused activation {act}")
    return lo, hi


def _same_pads(in_hw, k_hw, stride, dil) -> List[Tuple[int, int]]:
    """TF SAME padding amounts per spatial dim."""
    pads = []
    for n, k, s, d in zip(in_hw, k_hw, stride, dil):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_weight(w_ko: np.ndarray) -> np.ndarray:
    """An int8 (K, N) weight matrix stored transposed, (Np, Kp) row-major,
    with K and N zero-padded up to multiples of 8 (zero columns meet the
    zero columns `int_mm` pads the input with; zero rows give outputs
    that are sliced off). `int_mm` multiplies by its transposed view:
    cuBLASLt's int8 kernels take the second operand column-major only
    (the "TN" layout)."""
    k, n = w_ko.shape
    out = np.zeros((_round_up(n, INT_MM_ALIGN), _round_up(k, INT_MM_ALIGN)),
                   np.int8)
    out[:n, :k] = w_ko.T
    return out


def int_mm(cols: torch.Tensor, w_nk: torch.Tensor, n: int) -> torch.Tensor:
    """Exact int8 (M, K) × int8 (K, N) → int32 (M, n) through
    ``torch._int_mm``, the weight given as `int_mm_weight` stores it
    ((Np, Kp)): K is padded with zero columns up to Kp (a multiple of 8)
    and M with zero rows up to at least 17, then both pads and the
    columns past `n` are sliced off."""
    m, k = cols.shape
    kp = w_nk.shape[1]
    mp = max(m, INT_MM_MIN_M + 1)
    if kp != k or mp != m:
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    return torch._int_mm(cols.contiguous(), w_nk.t())[:m, :n]


def _windows(x: torch.Tensor, k_hw, stride, dil) -> List[torch.Tensor]:
    """The kh·kw strided (B, OH, OW, C) views of a padded NHWC tensor, one
    per tap, in (kh, kw) order."""
    _, hp, wp, _ = x.shape
    (kh, kw), (sh, sw), (dh, dw) = k_hw, stride, dil
    oh = (hp - ((kh - 1) * dh + 1)) // sh + 1
    ow = (wp - ((kw - 1) * dw + 1)) // sw + 1
    return [x[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
              j * dw:j * dw + (ow - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]


def lower_tflite_quant(graph: TFLiteGraph,
                       batch: Optional[int] = None) -> LoweredModel:
    """Lower a fully-quantized graph to int8-native torch."""
    tensors = graph.tensors
    r = graph.reader
    bshape, _ = batch_shaper(graph, batch)

    # -- load-time constants: shifted int8 weights, int32 biases, Σw ----
    params: Dict[str, Any] = {}
    static_consts: Dict[int, np.ndarray] = {}
    meta: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}   # idx → (s, zp')

    consumed_static = _static_input_indices(graph)

    def shifted_const(t: TensorDef) -> np.ndarray:
        if t.dtype == np.uint8:
            return (t.buffer.astype(np.int16) - 128).astype(np.int8)
        return np.asarray(t.buffer)

    weight_of: Dict[int, int] = {}       # weight tensor idx → op position
    for k, op in enumerate(graph.ops):
        if op.code in (OP["CONV_2D"], OP["DEPTHWISE_CONV_2D"],
                       OP["FULLY_CONNECTED"]) and len(op.inputs) > 1:
            weight_of[op.inputs[1]] = k
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                weight_of[op.inputs[2]] = k   # bias folds into op{k}_b

    for t in tensors:
        if t.buffer is None:
            continue
        if t.index in consumed_static:
            static_consts[t.index] = np.asarray(t.buffer)
            continue
        if t.index in weight_of:
            continue                      # packed per-op below
        params[f"t{t.index}"] = torch.from_numpy(np.array(shifted_const(t)))

    def qmeta(idx) -> Tuple[np.ndarray, np.ndarray]:
        if idx not in meta:
            meta[idx] = _qparams(tensors[idx])
        return meta[idx]

    def mult_of(k: int, mult: np.ndarray):
        """A per-channel multiplier is a param tensor; a per-tensor one a
        Python float holding the f32 value."""
        if mult.size > 1:
            params[f"op{k}_m"] = torch.from_numpy(mult)
            return None
        return float(mult[0])

    # -- per-conv packed weights + fused bias -------------------------------
    # opmeta[k] = dict of static config consumed by fn's conv branch
    opmeta: Dict[int, Dict[str, Any]] = {}

    for k, op in enumerate(graph.ops):
        o = op.opts

        def opt(fid, fmt, default, _o=o):
            # None-safe: ops may omit their options table entirely
            return r.field_scalar(_o, fid, fmt, default) \
                if _o is not None else default
        if op.code in (OP["CONV_2D"], OP["DEPTHWISE_CONV_2D"]):
            depthwise = op.code == OP["DEPTHWISE_CONV_2D"]
            xi, wi = op.inputs[0], op.inputs[1]
            (sx,), (zx,) = _qparams(tensors[xi])
            sw, zw = _qparams(tensors[wi])
            (so,), (zo,) = _qparams(tensors[op.outputs[0]])
            wnp = shifted_const(tensors[wi]).astype(np.int64)
            zw0 = int(zw[0]) if zw.size == 1 else 0
            if zw.size > 1 and np.any(zw != 0):
                raise BackendError(
                    f"per-channel nonzero weight zero points in op {k} "
                    f"are not supported by the int8-native lowering")
            kh, kw = wnp.shape[1], wnp.shape[2]
            if depthwise:
                n_taps = kh * kw
                s_w = (wnp - zw0).sum(axis=(0, 1, 2))    # per out channel
                # exact fold: int32 (w−zw), one row a tap: (kh·kw, C·m)
                w_dev = (wnp - zw0).reshape(n_taps, -1).astype(np.int32)
                stride = (opt(2, "<i", 1), opt(1, "<i", 1))
                dil = (opt(6, "<i", 1), opt(5, "<i", 1))
                act = opt(4, "<b", 0)
                augment = False
            else:
                n_taps = kh * kw * wnp.shape[3]
                s_w = wnp.sum(axis=(1, 2, 3))
                # OHWI → (K = kh·kw·I, O): the im2col columns' order
                w_ko = wnp.astype(np.int8).reshape(wnp.shape[0], -1).T
                augment = zw0 != 0
                if augment:   # ones out-channel → Σ_window(x) in the product
                    w_ko = np.concatenate(
                        [w_ko, np.ones((w_ko.shape[0], 1), np.int8)], axis=1)
                w_dev = int_mm_weight(w_ko)
                stride = (opt(2, "<i", 1), opt(1, "<i", 1))
                dil = (opt(5, "<i", 1), opt(4, "<i", 1))
                act = opt(3, "<b", 0)
            bias = np.zeros(s_w.shape, np.int64)
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                bias = tensors[op.inputs[2]].buffer.astype(np.int64)
            if depthwise:
                # acc already uses exact (w−zw); only −zx·Σ(w−zw) remains
                fused_b = bias - int(zx) * s_w
            else:
                fused_b = (bias - int(zx) * s_w
                           + n_taps * int(zx) * zw0)
            params[f"op{k}_w"] = torch.from_numpy(np.ascontiguousarray(w_dev))
            params[f"op{k}_b"] = torch.from_numpy(fused_b.astype(np.int32))
            mult = (sx * sw / so).astype(np.float32)
            lo, hi = _act_qbounds(act, float(so), int(zo))
            opmeta[k] = dict(
                depthwise=depthwise, stride=stride, dil=dil,
                k_hw=(kh, kw), zx=int(zx), zw=zw0, augment=augment,
                pad_same=opt(0, "<b", 0) == _PAD_SAME,
                n_out=int(s_w.shape[0]), mult=mult_of(k, mult),
                zo=int(zo), lo=lo, hi=hi)
        elif op.code == OP["FULLY_CONNECTED"]:
            xi, wi = op.inputs[0], op.inputs[1]
            (sx,), (zx,) = _qparams(tensors[xi])
            sw, zw = _qparams(tensors[wi])
            (so,), (zo,) = _qparams(tensors[op.outputs[0]])
            wnp = shifted_const(tensors[wi]).astype(np.int64)   # [O, I]
            zw0 = int(zw[0]) if zw.size == 1 else 0
            if zw.size > 1 and np.any(zw != 0):
                raise BackendError(
                    f"per-channel nonzero weight zero points in op {k} "
                    f"are not supported by the int8-native lowering")
            w_io = wnp.astype(np.int8).T                        # [I, O]
            augment = zw0 != 0
            if augment:
                w_io = np.concatenate(
                    [w_io, np.ones((w_io.shape[0], 1), np.int8)], axis=1)
            bias = np.zeros((wnp.shape[0],), np.int64)
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                bias = tensors[op.inputs[2]].buffer.astype(np.int64)
            fused_b = (bias - int(zx) * wnp.sum(axis=1)
                       + wnp.shape[1] * int(zx) * zw0)
            params[f"op{k}_w"] = torch.from_numpy(int_mm_weight(w_io))
            params[f"op{k}_b"] = torch.from_numpy(fused_b.astype(np.int32))
            mult = (sx * sw / so).astype(np.float32)
            lo, hi = _act_qbounds(
                opt(0, "<b", 0), float(so), int(zo))
            opmeta[k] = dict(
                zx=int(zx), zw=zw0, augment=augment,
                n_out=int(wnp.shape[0]), in_features=int(wnp.shape[1]),
                mult=mult_of(k, mult), zo=int(zo), lo=lo, hi=hi)

    def requant(acc_i32, mult, oz: int, lo: int, hi: int):
        """int32 accumulator → int8 output via f32 multiplier."""
        y = torch.round(acc_i32.to(torch.float32) * mult) + oz
        return torch.clamp(y, lo, hi).to(torch.int8)

    def opt_i(o, fid, default=0):
        return r.field_scalar(o, fid, "<i", default) if o is not None \
            else default

    def opt_b(o, fid, default=0):
        return r.field_scalar(o, fid, "<b", default) if o is not None \
            else default

    def opt_f(o, fid, default=0.0):
        return r.field_scalar(o, fid, "<f", default) if o is not None \
            else default

    def static(i) -> np.ndarray:
        return np.asarray(static_consts.get(i, tensors[i].buffer))

    cache: Dict[tuple, torch.Tensor] = {}

    def div(y: torch.Tensor, v: float) -> torch.Tensor:
        """y / f32(v), a true division on every device: CUDA divides by
        a host scalar as a product with its reciprocal, which can move
        the last bit (and so a rounding tie); a one-element device tensor
        is divided by."""
        return y / _dev_const(cache, ("div", v), y.device,
                              lambda: np.full(1, v, np.float32))

    def fn(p, *inputs):
        if len(inputs) != len(graph.inputs):
            raise BackendError(
                f"model {graph.path!r} expects {len(graph.inputs)} inputs, "
                f"got {len(inputs)}")
        vals: Dict[int, Any] = {}
        for idx, x in zip(graph.inputs, inputs):
            t = tensors[idx]
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            if t.dtype == np.uint8:
                x = (x.to(torch.int16) - 128).to(torch.int8)
            vals[idx] = x

        def get(i):
            if i in vals:
                return vals[i]
            key = f"t{i}"
            if key in p:
                return p[key]
            raise BackendError(
                f"op input tensor {i} ({tensors[i].name!r}) has no value")

        for k, op in enumerate(graph.ops):
            code, o = op.code, op.opts

            if code in (OP["CONV_2D"], OP["DEPTHWISE_CONV_2D"]):
                m = opmeta[k]
                x = get(op.inputs[0])
                if m["pad_same"]:
                    (pt, pb), (pl, pr) = _same_pads(
                        x.shape[1:3], m["k_hw"], m["stride"], m["dil"])
                    if pt or pb or pl or pr:
                        x = F.pad(x, (0, 0, pl, pr, pt, pb), value=m["zx"])
                w = p[f"op{k}_w"]
                n = m["n_out"]
                if m["depthwise"]:
                    taps = torch.stack(
                        _windows(x, m["k_hw"], m["stride"], m["dil"]), dim=3)
                    taps = taps.to(torch.int32)          # (B, OH, OW, T, C)
                    if n != taps.shape[-1]:              # depth multiplier
                        taps = taps.repeat_interleave(
                            n // taps.shape[-1], dim=-1)
                    acc = (taps * w).sum(dim=3, dtype=torch.int32)
                else:
                    if m["k_hw"] == (1, 1) and m["stride"] == (1, 1):
                        b_, oh, ow, c = x.shape
                        cols = x.reshape(b_ * oh * ow, c)
                    else:
                        win = _windows(x, m["k_hw"], m["stride"], m["dil"])
                        b_, oh, ow = win[0].shape[:3]
                        cols = torch.cat(win, dim=-1).reshape(b_ * oh * ow,
                                                              -1)
                    acc = int_mm(cols, w, n + int(m["augment"]))
                    if m["augment"]:
                        acc = acc[:, :n] - m["zw"] * acc[:, n:]
                    acc = acc.reshape(b_, oh, ow, n)
                acc = acc + p[f"op{k}_b"]
                mult = m["mult"] if m["mult"] is not None else p[f"op{k}_m"]
                vals[op.outputs[0]] = requant(
                    acc, mult, m["zo"], m["lo"], m["hi"])
                continue

            if code == OP["FULLY_CONNECTED"]:
                m = opmeta[k]
                x = get(op.inputs[0])
                if x.dim() != 2:
                    x = x.reshape((-1, m["in_features"]))
                n = m["n_out"]
                acc = int_mm(x, p[f"op{k}_w"], n + int(m["augment"]))
                if m["augment"]:
                    acc = acc[:, :n] - m["zw"] * acc[:, n:]
                acc = acc + p[f"op{k}_b"]
                mult = m["mult"] if m["mult"] is not None else p[f"op{k}_m"]
                vals[op.outputs[0]] = requant(
                    acc, mult, m["zo"], m["lo"], m["hi"])
                continue

            if code in (OP["ADD"], OP["MUL"]):
                ai, bi = op.inputs[0], op.inputs[1]
                a, b = get(ai), get(bi)
                (sa,), (za,) = qmeta(ai)
                (sb,), (zb,) = qmeta(bi)
                oi = op.outputs[0]
                (so,), (zo,) = qmeta(oi)
                lo, hi = _act_qbounds(opt_b(o, 0), float(so), int(zo))
                af = (a.to(torch.float32) - int(za)) * float(np.float32(sa))
                bf = (b.to(torch.float32) - int(zb)) * float(np.float32(sb))
                y = af + bf if code == OP["ADD"] else af * bf
                y = torch.round(div(y, float(so))) + int(zo)
                vals[oi] = torch.clamp(y, lo, hi).to(torch.int8)
                continue

            if code in (OP["AVERAGE_POOL_2D"], OP["MAX_POOL_2D"]):
                xi = op.inputs[0]
                x = get(xi)
                oi = op.outputs[0]
                stride = (opt_i(o, 2, 1), opt_i(o, 1, 1))
                window = (opt_i(o, 4, 1), opt_i(o, 3, 1))
                pad_same = opt_b(o, 0) == _PAD_SAME
                (so,), (zo,) = qmeta(oi)
                lo, hi = _act_qbounds(opt_b(o, 5), float(so), int(zo))
                h, w_ = x.shape[1], x.shape[2]
                (pt, pb), (pl, pr) = (_same_pads((h, w_), window, stride,
                                                 (1, 1)) if pad_same
                                      else ((0, 0), (0, 0)))
                # int8 values are exact in f32, and so are their window
                # sums (< 2^24)
                xc = x.permute(0, 3, 1, 2).to(torch.float32)
                if code == OP["MAX_POOL_2D"]:
                    y = F.max_pool2d(F.pad(xc, (pl, pr, pt, pb),
                                           value=-128.0), window, stride)
                else:
                    # TFLite avg-pool shares scale/zp across in/out
                    s = F.avg_pool2d(F.pad(xc, (pl, pr, pt, pb)), window,
                                     stride, divisor_override=1)

                    def count():
                        ones = np.pad(np.ones((h, w_), np.float32),
                                      ((pt, pb), (pl, pr)))
                        oh = (h + pt + pb - window[0]) // stride[0] + 1
                        ow = (w_ + pl + pr - window[1]) // stride[1] + 1
                        return np.asarray(
                            [[ones[i * stride[0]:i * stride[0] + window[0],
                                   j * stride[1]:j * stride[1] + window[1]]
                              .sum() for j in range(ow)] for i in range(oh)],
                            np.float32)

                    y = torch.round(s / _dev_const(
                        cache, ("avgcnt", h, w_, window, stride, pt, pb, pl,
                                pr), x.device, count))
                vals[oi] = torch.clamp(y, lo, hi).to(torch.int8) \
                    .permute(0, 2, 3, 1)
                continue

            if code == OP["MEAN"]:
                xi = op.inputs[0]
                x = get(xi)
                oi = op.outputs[0]
                axes = tuple(sorted({int(a) % x.dim()
                                     for a in static(op.inputs[1]).ravel()}))
                keep = bool(opt_b(o, 0))
                (si,), (zi,) = qmeta(xi)
                (so,), (zo,) = qmeta(oi)
                m = x.to(torch.float32).mean(dim=axes, keepdim=keep)
                y = torch.round((m - int(zi)) * float(np.float32(si / so))) \
                    + int(zo)
                vals[oi] = torch.clamp(y, -128, 127).to(torch.int8)
                continue

            if code in (OP["RESHAPE"], OP["SQUEEZE"]):
                # the output tensor's shape at the lowered batch
                vals[op.outputs[0]] = get(op.inputs[0]).reshape(
                    bshape(tensors[op.outputs[0]].shape))
                continue

            if code == OP["CONCATENATION"]:
                oi = op.outputs[0]
                (so,), (zo,) = qmeta(oi)
                axis = opt_i(o, 0, 0)
                parts = []
                for i in op.inputs:
                    (si,), (zi,) = qmeta(i)
                    xi_v = get(i)
                    if abs(si - so) < 1e-12 and zi == zo:
                        parts.append(xi_v)
                    else:
                        y = torch.round((xi_v.to(torch.float32) - int(zi))
                                        * float(np.float32(si / so))) \
                            + int(zo)
                        parts.append(torch.clamp(y, -128, 127)
                                     .to(torch.int8))
                vals[oi] = torch.cat(parts, dim=axis)
                continue

            if code == OP["PAD"]:
                xi = op.inputs[0]
                x = get(xi)
                (_,), (zi,) = qmeta(xi)
                pads = static(op.inputs[1]).reshape(-1, 2)
                flat = [int(v) for a, b in pads[::-1] for v in (a, b)]
                vals[op.outputs[0]] = F.pad(x, flat, value=int(zi))
                continue

            if code in (OP["RELU"], OP["RELU6"]):
                xi = op.inputs[0]
                x = get(xi)
                oi = op.outputs[0]
                (so,), (zo,) = qmeta(oi)
                act = _ACT_RELU if code == OP["RELU"] else _ACT_RELU6
                lo, hi = _act_qbounds(act, float(so), int(zo))
                vals[oi] = torch.clamp(x, lo, hi)
                continue

            if code in (OP["SOFTMAX"], OP["LOGISTIC"]):
                xi = op.inputs[0]
                x = get(xi)
                oi = op.outputs[0]
                (si,), (zi,) = qmeta(xi)
                (so,), (zo,) = qmeta(oi)
                xf = (x.to(torch.float32) - int(zi)) * float(np.float32(si))
                if code == OP["SOFTMAX"]:
                    beta = opt_f(o, 0, 1.0)
                    yf = torch.softmax(xf * beta, dim=-1)
                else:
                    yf = torch.sigmoid(xf)
                y = torch.round(div(yf, float(so))) + int(zo)
                vals[oi] = torch.clamp(y, -128, 127).to(torch.int8)
                continue

            if code in (OP["DEQUANTIZE"], OP["QUANTIZE"]):
                xi = op.inputs[0]
                x = get(xi)
                oi = op.outputs[0]
                ti, to = tensors[xi], tensors[oi]
                if to.quantized and ti.quantized:
                    (si,), (zi,) = qmeta(xi)
                    (so,), (zo,) = qmeta(oi)
                    y = torch.round((x.to(torch.float32) - int(zi))
                                    * float(np.float32(si / so))) + int(zo)
                    vals[oi] = torch.clamp(y, -128, 127).to(torch.int8)
                elif to.quantized:                 # float → int8 domain
                    (so,), (zo,) = qmeta(oi)
                    y = torch.round(div(x, float(so))) + int(zo)
                    vals[oi] = torch.clamp(y, -128, 127).to(torch.int8)
                else:                              # int8 domain → float
                    (si,), (zi,) = qmeta(xi)
                    vals[oi] = (x.to(torch.float32) - int(zi)) \
                        * float(np.float32(si))
                continue

            raise BackendError(
                f"TFLite op {op.name} is outside the int8-native "
                f"vocabulary; use compute_dtype='bfloat16' for "
                f"{graph.path!r}")

        results = []
        for idx in graph.outputs:
            t = tensors[idx]
            y = vals[idx]
            if t.dtype == np.uint8:
                y = (y.to(torch.int16) + 128).to(torch.uint8)
            results.append(y.to(torch_dtype(t.dtype)))
        return tuple(results)

    return LoweredModel(
        fn=fn, params=params,
        in_shapes=[bshape(tensors[i].shape) for i in graph.inputs],
        in_dtypes=[tensors[i].dtype for i in graph.inputs],
        out_shapes=[bshape(tensors[i].shape) for i in graph.outputs],
        out_dtypes=[tensors[i].dtype for i in graph.outputs],
        name=f"{graph.path.rsplit('/', 1)[-1]}[int8]")
