"""Caffe ``.caffemodel`` ingestion — NetParameter wire reader → torch.

The port of the JAX package's modelio/caffe.py. The reference runs Caffe
models through the armnn filter's CaffeParser
(``ext/nnstreamer/tensor_filter/tensor_filter_armnn.cc``; golden:
``tests/nnstreamer_filter_armnn/unittest_filter_armnn.cc:580`` runs
``lenet_iter_9000.caffemodel`` on ``9.raw`` and expects argmax 9). The
NetParameter protobuf is decoded with the dependency-free ``protowire``
reader (the parser is a copy): the ``.caffemodel`` snapshot carries both
the layer graph and the learned blobs, so no sidecar ``.prototxt`` is
needed. The lowering runs the layers in file order as plain PyTorch
calls.

Layer set: the inference closure of classic Caffe classifiers —
Input, Convolution, Pooling (MAX/AVE, Caffe's CEIL output rule),
InnerProduct, ReLU/TanH/Sigmoid, Softmax, LRN, Dropout (inference
no-op), Concat, Eltwise, Flatten, Split. Unknown layers raise with the
layer type (never silently wrong), at load: the output probe runs the
net on the ``meta`` device.

Data layout is Caffe-native NCHW with OIHW conv blobs and (out, in)
InnerProduct blobs — torch's own layouts, so the blobs are used as
stored.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import protowire as pw
from nnstreamer_tpu_torch.modelio.tflite import LoweredModel, probe_outputs

# NetParameter
_NP_NAME, _NP_LAYER_V2 = 1, 100
# LayerParameter
_L_NAME, _L_TYPE, _L_BOTTOM, _L_TOP, _L_PHASE, _L_BLOBS = 1, 2, 3, 4, 10, 7
_L_CONV, _L_IP, _L_POOL, _L_INPUT, _L_LRN = 106, 117, 121, 143, 118
_L_DROPOUT, _L_CONCAT, _L_ELTWISE = 108, 104, 110
# BlobProto
_B_NUM, _B_CH, _B_H, _B_W, _B_DATA, _B_SHAPE = 1, 2, 3, 4, 5, 7
# ConvolutionParameter
_C_NUM_OUT, _C_BIAS, _C_PAD, _C_KERNEL, _C_GROUP, _C_STRIDE = 1, 2, 3, 4, 5, 6
_C_PAD_H, _C_PAD_W, _C_KERNEL_H, _C_KERNEL_W = 9, 10, 11, 12
_C_STRIDE_H, _C_STRIDE_W, _C_DILATION = 13, 14, 18
# PoolingParameter
_P_POOL, _P_KERNEL, _P_STRIDE, _P_PAD = 1, 2, 3, 4
_P_KERNEL_H, _P_KERNEL_W, _P_STRIDE_H, _P_STRIDE_W = 5, 6, 7, 8
_P_PAD_H, _P_PAD_W, _P_GLOBAL = 9, 10, 12
# InnerProductParameter
_IP_NUM_OUT, _IP_BIAS, _IP_AXIS, _IP_TRANSPOSE = 1, 2, 5, 6
# LRNParameter
_LRN_SIZE, _LRN_ALPHA, _LRN_BETA, _LRN_K = 1, 2, 3, 5


@dataclass
class CaffeLayer:
    name: str
    type: str
    bottoms: List[str]
    tops: List[str]
    blobs: List[np.ndarray]
    params: Dict[int, Any]


@dataclass
class CaffeNet:
    name: str
    layers: List[CaffeLayer]


def _decode_blob(buf: bytes) -> np.ndarray:
    d = pw.fields_dict(buf)
    vals = d.get(_B_DATA, [])
    if len(vals) == 1 and isinstance(vals[0], bytes):    # packed floats
        data = np.frombuffer(vals[0], "<f4")
    else:   # proto2 unpacked: one fixed32 per element
        data = np.asarray(vals, np.uint32).view(np.float32)
    shape_msg = pw.first(d, _B_SHAPE)
    if shape_msg is not None:
        dims = _shape_dims(shape_msg)
    else:   # legacy num/channels/height/width
        dims = [int(pw.first(d, f, 1) or 1)
                for f in (_B_NUM, _B_CH, _B_H, _B_W)]
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
    return data.reshape([int(x) for x in dims])


def _shape_dims(shape_msg: bytes) -> List[int]:
    vals = pw.fields_dict(shape_msg).get(1, [])
    if len(vals) == 1 and isinstance(vals[0], bytes):
        return [int(x) for x in pw.packed_varints(vals[0])]
    return [int(x) for x in vals]


def parse_caffemodel(path: str) -> CaffeNet:
    with open(path, "rb") as f:
        raw = f.read()
    with pw.wire_context(f"caffemodel {path!r}", BackendError):
        return _parse_caffemodel(raw, path)


def _parse_caffemodel(raw: bytes, path: str) -> CaffeNet:
    d = pw.fields_dict(raw)
    if _NP_LAYER_V2 not in d:
        raise BackendError(
            f"{path!r}: no LayerParameter entries — V0/V1 (pre-2014) "
            f"caffemodel snapshots are not supported; re-export with a "
            f"modern Caffe")
    layers: List[CaffeLayer] = []
    for lb in d[_NP_LAYER_V2]:
        ld = pw.fields_dict(lb)
        layers.append(CaffeLayer(
            name=pw.first(ld, _L_NAME, b"").decode(),
            type=pw.first(ld, _L_TYPE, b"").decode(),
            bottoms=[b.decode() for b in ld.get(_L_BOTTOM, [])],
            tops=[t.decode() for t in ld.get(_L_TOP, [])],
            blobs=[_decode_blob(b) for b in ld.get(_L_BLOBS, [])],
            params={f: ld[f] for f in (_L_CONV, _L_IP, _L_POOL,
                                       _L_INPUT, _L_LRN, _L_DROPOUT,
                                       _L_CONCAT, _L_ELTWISE)
                    if f in ld}))
    return CaffeNet(name=pw.first(d, _NP_NAME, b"").decode()
                    or os.path.basename(path), layers=layers)


def _rep_int(d, field, default) -> int:
    v = pw.first(d, field)
    return int(v) if v is not None else default


def _hw(d, f_single, f_h, f_w, default) -> Tuple[int, int]:
    h = pw.first(d, f_h)
    w = pw.first(d, f_w)
    if h is not None or w is not None:
        return int(h or default), int(w or default)
    s = _rep_int(d, f_single, default)
    return s, s


def _pool2d(x: torch.Tensor, kind: str, k, s, p) -> torch.Tensor:
    """Caffe pooling on NCHW: output size uses CEIL, then the clip rule —
    the last window must start inside the image + left pad
    (pooling_layer.cpp: decrement when (out-1)*stride >= size+pad).
    Padding-high is derived from the exact output count, and both pads
    are filled with the identity (the lowest float for MAX, 0 for AVE),
    so the overhang never wins. AVE divides by the whole kernel area,
    padding included — an explicit pad, then F.avg_pool2d's k·k divisor
    (ceil_mode and count_include_pad cannot give that divisor on the
    overhang)."""
    pads = []
    for i in range(2):
        size = x.shape[2 + i]
        out = -(-(size + 2 * p[i] - k[i]) // s[i]) + 1   # ceil
        if p[i] and (out - 1) * s[i] >= size + p[i]:
            out -= 1
        hi = max((out - 1) * s[i] + k[i] - size - p[i], 0)
        pads.append((p[i], hi))
    flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    if kind == "max":
        lo = (torch.finfo(x.dtype).min if x.is_floating_point()
              else torch.iinfo(x.dtype).min)
        if any(flat):
            x = F.pad(x, flat, value=lo)
        return F.max_pool2d(x, tuple(k), tuple(s))
    if any(flat):
        x = F.pad(x, flat)
    return F.avg_pool2d(x, tuple(k), tuple(s))


_DEPLOY_SKIP = ("Data", "HDF5Data", "ImageData", "Accuracy",
                "SoftmaxWithLoss", "EuclideanLoss", "Silence")


def lower_caffe(net: CaffeNet, batch: Optional[int] = None,
                in_shape: Optional[Tuple[int, ...]] = None) -> LoweredModel:
    """CaffeNet → LoweredModel, fn(params, x) -> outputs.

    The whole net (TEST phase): train-only layers (Data/loss/accuracy)
    are skipped, in-place activations resolve through the blob dict
    exactly like Caffe's top/bottom aliasing."""
    params: Dict[str, List[torch.Tensor]] = {}
    input_name = None
    input_shape = in_shape
    deploy: List[CaffeLayer] = []
    for layer in net.layers:
        if layer.type in _DEPLOY_SKIP:
            continue
        if layer.type == "Input":
            input_name = layer.tops[0]
            ip = layer.params.get(_L_INPUT)
            if ip and input_shape is None:
                shp = pw.first(pw.fields_dict(ip[0]), 1)
                if shp is not None:
                    input_shape = tuple(_shape_dims(shp))
            continue
        if layer.blobs:
            params[layer.name] = [torch.from_numpy(np.array(b, np.float32))
                                  for b in layer.blobs]
        deploy.append(layer)
    if input_name is None:
        if not deploy:
            raise BackendError("caffemodel has no computable layers")
        input_name = deploy[0].bottoms[0]
    if input_shape is None:
        raise BackendError(
            "caffemodel declares no Input layer shape (train-phase "
            "snapshot?); re-export merged with the deploy prototxt so "
            "the Input layer carries input_param { shape }, or call "
            "lower_caffe(net, in_shape=...) directly")
    if batch:
        input_shape = (batch,) + tuple(input_shape[1:])

    steps = [_layer_step(layer) for layer in deploy]
    # outputs: tops never consumed as a bottom downstream
    consumed = {b for lyr in deploy for b in lyr.bottoms}
    out_tops = [lyr.tops[0] for lyr in deploy
                if lyr.tops and lyr.tops[0] not in consumed]

    def fn(p, x):
        blobs: Dict[str, Any] = {input_name: x.to(torch.float32)}

        def get(name):
            if name not in blobs:
                raise BackendError(
                    f"caffe: blob {name!r} undefined (net is not "
                    f"topologically ordered?)")
            return blobs[name]

        out = None
        for layer, step in zip(deploy, steps):
            out = step(get, p.get(layer.name, []))
            for top in (layer.tops if layer.type == "Split"
                        else layer.tops[:1]):
                blobs[top] = out
        outs = [blobs[t] for t in out_tops if t in blobs]
        return tuple(outs) if outs else (out,)

    out_shapes, out_dtypes = probe_outputs(
        fn, params, [tuple(input_shape)], [np.dtype(np.float32)])
    return LoweredModel(
        fn=fn, params=params,
        in_shapes=[tuple(int(s) for s in input_shape)],
        in_dtypes=[np.dtype(np.float32)],
        out_shapes=out_shapes, out_dtypes=out_dtypes,
        name=net.name or "caffe")


def _layer_step(layer: CaffeLayer):
    """step(get, blobs) → the layer's output, its prototxt parameters
    read here, once."""
    t = layer.type
    bottom = layer.bottoms[0] if layer.bottoms else ""
    if t == "Convolution":
        cd = pw.fields_dict(layer.params[_L_CONV][0])
        kh, kw = _hw(cd, _C_KERNEL, _C_KERNEL_H, _C_KERNEL_W, 1)
        stride = _hw(cd, _C_STRIDE, _C_STRIDE_H, _C_STRIDE_W, 1)
        pad = _hw(cd, _C_PAD, _C_PAD_H, _C_PAD_W, 0)
        group = _rep_int(cd, _C_GROUP, 1)
        dil = _rep_int(cd, _C_DILATION, 1)

        def conv(get, w):
            return F.conv2d(get(bottom), w[0], w[1] if len(w) > 1 else None,
                            stride=stride, padding=pad, dilation=dil,
                            groups=group)
        return conv
    if t == "Pooling":
        pd = pw.fields_dict(layer.params[_L_POOL][0])
        pool_enum = _rep_int(pd, _P_POOL, 0)
        if pool_enum not in (0, 1):
            raise BackendError(
                f"caffe Pooling method enum {pool_enum} ({layer.name}) "
                f"has no torch lowering (MAX/AVE only; STOCHASTIC is "
                f"train-time sampling)")
        kind = "max" if pool_enum == 0 else "ave"
        if pw.first(pd, _P_GLOBAL):
            def global_pool(get, w):
                x = get(bottom)
                return _pool2d(x, kind, tuple(x.shape[2:]), (1, 1), (0, 0))
            return global_pool
        k = _hw(pd, _P_KERNEL, _P_KERNEL_H, _P_KERNEL_W, 1)
        s = _hw(pd, _P_STRIDE, _P_STRIDE_H, _P_STRIDE_W, 1)
        pad = _hw(pd, _P_PAD, _P_PAD_H, _P_PAD_W, 0)
        return lambda get, w: _pool2d(get(bottom), kind, k, s, pad)
    if t == "InnerProduct":
        ipd = pw.fields_dict(layer.params[_L_IP][0]) \
            if _L_IP in layer.params else {}
        axis = _rep_int(ipd, _IP_AXIS, 1)
        transpose = bool(pw.first(ipd, _IP_TRANSPOSE, 0))

        def inner_product(get, w):
            x = get(bottom)
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            flat = x.reshape(lead, -1)
            b = w[1].reshape(1, -1) if len(w) > 1 else None
            if transpose:                   # the blob is (in, out)
                out = flat @ w[0]
                return out + b if b is not None else out
            return F.linear(flat, w[0], w[1] if len(w) > 1 else None)
        return inner_product
    if t == "ReLU":
        return lambda get, w: torch.clamp(get(bottom), min=0)
    if t == "TanH":
        return lambda get, w: torch.tanh(get(bottom))
    if t == "Sigmoid":
        return lambda get, w: torch.sigmoid(get(bottom))
    if t == "Softmax":
        return lambda get, w: torch.softmax(get(bottom), dim=1)
    if t in ("Dropout", "Split"):           # inference no-op / fan-out
        return lambda get, w: get(bottom)
    if t == "Flatten":
        return lambda get, w: get(bottom).reshape(get(bottom).shape[0], -1)
    if t == "Concat":
        return lambda get, w: torch.cat([get(b) for b in layer.bottoms], 1)
    if t == "Eltwise":
        op = 1     # default SUM
        coeffs = None
        ep = layer.params.get(_L_ELTWISE)
        if ep:
            ed = pw.fields_dict(ep[0])
            op = _rep_int(ed, 1, 1)
            if 2 in ed:   # coeff (repeated float, SUM only)
                coeffs = [pw.fixed32_to_float(v) for v in ed[2]]
        if coeffs is not None:
            if op != 1:
                raise BackendError(
                    f"caffe Eltwise ({layer.name}): coeff with non-SUM "
                    f"operation is invalid")
            if len(coeffs) != len(layer.bottoms):
                raise BackendError(
                    f"caffe Eltwise ({layer.name}): {len(coeffs)} coeffs "
                    f"for {len(layer.bottoms)} bottoms")

            def weighted_sum(get, w):
                xs = [get(b) for b in layer.bottoms]
                out = coeffs[0] * xs[0]
                for c, other in zip(coeffs[1:], xs[1:]):
                    out = out + c * other
                return out
            return weighted_sum
        f = {0: torch.mul, 1: torch.add}.get(op, torch.maximum)

        def eltwise(get, w):
            xs = [get(b) for b in layer.bottoms]
            out = xs[0]
            for other in xs[1:]:
                out = f(out, other)
            return out
        return eltwise
    if t == "LRN":
        ld = pw.fields_dict(layer.params[_L_LRN][0])
        if _rep_int(ld, 4, 0) != 0:    # norm_region
            raise BackendError(
                f"caffe LRN ({layer.name}): WITHIN_CHANNEL norm_region has "
                f"no torch lowering (ACROSS_CHANNELS only)")
        size = _rep_int(ld, _LRN_SIZE, 5)
        alpha = pw.fixed32_to_float(pw.first(ld, _LRN_ALPHA, 0)) or 1.0
        beta = pw.fixed32_to_float(pw.first(ld, _LRN_BETA, 0)) or 0.75
        kk = pw.first(ld, _LRN_K)
        kk = pw.fixed32_to_float(kk) if kk is not None else 1.0
        half = size // 2

        def lrn(get, w):
            x = get(bottom)
            padded = F.pad(x * x, (0, 0, 0, 0, half, half))
            c = x.shape[1]
            window = sum(padded[:, i:i + c] for i in range(size))
            return x / torch.pow(kk + alpha / size * window, beta)
        return lrn
    raise BackendError(
        f"caffe layer type {t!r} ({layer.name}) has no torch lowering")
