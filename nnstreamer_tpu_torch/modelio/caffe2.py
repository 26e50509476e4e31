"""Caffe2 NetDef ingestion (init_net + predict_net pair) → one torch fn.

The port of the JAX package's modelio/caffe2.py. The reference links the
caffe2 runtime (`ext/nnstreamer/tensor_filter/tensor_filter_caffe2.cc`)
and takes `model="init_net.pb,predict_net.pb"`. Both NetDefs are read
with the dependency-free protobuf wire reader (`parse_netdef` and
`_run_init_net` are copies): the init net's fill ops run on the host into
the parameter dict, and the predict net's operators run as plain PyTorch
calls in file order — NCHW convolutions with OIHW weights (torch's own
layouts), inference SpatialBN folded at load into one scale and one
shift (`torch.addcmul`), n-ary Sum residuals.

Covered ops: those of the reference's own test pair (a CIFAR-10 ResNet:
Conv/SpatialBN/Relu/Sum/AveragePool/FC/Softmax) plus MaxPool, Dropout
and the ConstantFill init op; a Conv with args beyond kernel/stride/pad
(group, dilation, per-side pads) and other ops fail loudly. The input's
spatial size is not in the files: ``custom=side=`` declares it (default
32, the reference pair's).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.modelio import protowire as pw
from nnstreamer_tpu_torch.modelio.tflite import (
    LoweredModel, pool_nhwc, probe_outputs)

log = get_logger("modelio.caffe2")

# NetDef fields
_ND_NAME, _ND_OP = 1, 2
_ND_EXTERNAL_INPUT, _ND_EXTERNAL_OUTPUT = 5, 6
# OperatorDef
_OP_INPUT, _OP_OUTPUT, _OP_NAME, _OP_TYPE, _OP_ARG = 1, 2, 3, 4, 5
# Argument
_A_NAME, _A_F, _A_I, _A_S, _A_FLOATS, _A_INTS = 1, 2, 3, 4, 5, 6


@dataclass
class C2Op:
    type: str
    inputs: List[str]
    outputs: List[str]
    args: Dict[str, Any]


def _decode_arg(buf: bytes):
    d = pw.fields_dict(buf)
    name = pw.first(d, _A_NAME, b"").decode()
    if _A_F in d:
        return name, pw.fixed32_to_float(d[_A_F][0])
    if _A_I in d:
        return name, pw.to_signed64(d[_A_I][0])
    if _A_S in d:
        return name, d[_A_S][0].decode(errors="replace")
    if _A_FLOATS in d:
        vals = d[_A_FLOATS]
        if len(vals) == 1 and isinstance(vals[0], bytes):   # packed
            return name, np.frombuffer(vals[0], "<f4")
        # caffe2.proto is proto2: repeated floats arrive UNPACKED (one
        # fixed32 per element) — reinterpret vectorized, not per-scalar
        return name, np.asarray(vals, np.uint32).view(np.float32)
    if _A_INTS in d:
        vals = d[_A_INTS]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            return name, np.array(
                [pw.to_signed64(v) for v in pw.packed_varints(vals[0])],
                np.int64)
        return name, np.array([pw.to_signed64(v) for v in vals], np.int64)
    return name, None


def parse_netdef(path: str) -> Tuple[List[C2Op], List[str], List[str]]:
    with open(path, "rb") as f:
        buf = f.read()
    try:
        d = pw.fields_dict(buf)
        raw_ops = d.get(_ND_OP, [])
        if not raw_ops:
            raise ValueError("no operators")
        ops = []
        for ob in raw_ops:
            od = pw.fields_dict(ob)
            args = dict(_decode_arg(ab) for ab in od.get(_OP_ARG, []))
            ops.append(C2Op(
                type=pw.first(od, _OP_TYPE, b"").decode(),
                inputs=[v.decode() for v in od.get(_OP_INPUT, [])],
                outputs=[v.decode() for v in od.get(_OP_OUTPUT, [])],
                args=args))
        ext_in = [v.decode() for v in d.get(_ND_EXTERNAL_INPUT, [])]
        ext_out = [v.decode() for v in d.get(_ND_EXTERNAL_OUTPUT, [])]
        return ops, ext_in, ext_out
    except (ValueError, IndexError, struct.error,
            UnicodeDecodeError) as e:
        raise BackendError(
            f"{path!r} is not a caffe2 NetDef: {e}") from None


def _run_init_net(ops: List[C2Op]) -> Dict[str, np.ndarray]:
    """Execute fill ops host-side → blob name → array."""
    blobs: Dict[str, np.ndarray] = {}
    for op in ops:
        shape = tuple(int(v) for v in
                      np.asarray(op.args.get("shape", [])).ravel())
        if op.type == "GivenTensorFill":
            vals = np.asarray(op.args["values"], np.float32)
        elif op.type in ("GivenTensorIntFill", "GivenTensorInt64Fill"):
            vals = np.asarray(op.args["values"], np.int64)
        elif op.type == "ConstantFill":
            vals = np.full(shape or (1,),
                           float(op.args.get("value", 0.0)), np.float32)
        elif op.type in ("XavierFill", "MSRAFill", "UniformFill",
                         "GaussianFill"):
            # frozen inference pairs should not contain random fills;
            # zeros keep loading deterministic if one slips through
            log.warning("init net %s for %r: filling zeros",
                        op.type, op.outputs)
            vals = np.zeros(shape or (1,), np.float32)
        else:
            raise BackendError(
                f"caffe2 init-net op {op.type!r} is not a supported fill")
        blobs[op.outputs[0]] = vals.reshape(shape) if shape else vals
    return blobs


_CONV_REFUSED = ("dilation", "dilations", "kernels", "strides", "pads",
                 "pad_t", "pad_l", "pad_b", "pad_r", "group")


def lower_caffe2(init_path: str, predict_path: str,
                 input_names: Optional[List[str]] = None,
                 output_names: Optional[List[str]] = None,
                 batch: Optional[int] = None,
                 side: Optional[int] = None) -> LoweredModel:
    init_ops, _, _ = parse_netdef(init_path)
    ops, ext_in, ext_out = parse_netdef(predict_path)
    blobs = _run_init_net(init_ops)

    produced = {o for op in ops for o in op.outputs}
    if input_names is None:
        cand = [i for op in ops for i in op.inputs
                if i not in produced and i not in blobs]
        input_names = list(dict.fromkeys(cand)) \
            or [i for i in ext_in if i not in blobs]
        if not input_names and ops:
            # caffe2 init nets commonly plant a DUMMY placeholder blob
            # for the data input (GivenTensorFill of one value); the
            # dataflow root — the first op's first input — is the real
            # input and the runtime value must override the dummy
            input_names = [ops[0].inputs[0]]
    for nm in input_names:
        blobs.pop(nm, None)
    if output_names is None:
        consumed = {i for op in ops for i in op.inputs}
        # only FIRST outputs count: the lowering writes op.outputs[0]
        # (secondary outputs like Dropout's mask are never produced)
        output_names = [op.outputs[0] for op in ops
                        if op.outputs and op.outputs[0] not in consumed] \
            or [o for o in ext_out if o in produced] \
            or [ops[-1].outputs[0]]

    params: Dict[str, Any] = {k: torch.from_numpy(np.array(v))
                              for k, v in blobs.items()}
    for op in ops:
        if op.type == "SpatialBN" and op.args.get("is_test", 0) \
                and all(i in blobs for i in op.inputs[1:5]):
            # folded once: y = x·scale + shift, scale = s/√(var+eps)
            s, b, rm, riv = (blobs[i].astype(np.float32)
                             for i in op.inputs[1:5])
            inv = s / np.sqrt(riv + np.float32(op.args.get("epsilon", 1e-5)))
            params[op.outputs[0] + "/bn_scale"] = torch.from_numpy(
                inv.reshape(1, -1, 1, 1))
            params[op.outputs[0] + "/bn_shift"] = torch.from_numpy(
                (b - rm * inv).reshape(1, -1, 1, 1))
    cache: Dict[tuple, torch.Tensor] = {}
    steps = [(op.outputs[0], _op_step(op, cache)) for op in ops]

    def fn(p, *inputs):
        if len(inputs) != len(input_names):
            raise BackendError(
                f"caffe2 net expects {len(input_names)} inputs "
                f"({input_names}), got {len(inputs)}")
        vals: Dict[str, Any] = dict(zip(input_names, inputs))

        def get(name: str):
            v = vals.get(name)
            if v is None:
                v = p.get(name)
            if v is None:
                raise BackendError(f"caffe2 blob {name!r} has no value")
            return v

        for out, step in steps:
            vals[out] = step(get, p)
        return tuple(get(nm) for nm in output_names)

    # shapes: probe with a NCHW input inferred from the first conv
    first_conv = next((op for op in ops if op.type == "Conv"), None)
    if first_conv is None:
        raise BackendError(
            "caffe2 predict net has no Conv; cannot infer the input "
            "shape (declare it with custom=side=<pixels>)")
    w_name = first_conv.inputs[1]
    if w_name not in blobs:
        raise BackendError(
            f"caffe2: first Conv weight blob {w_name!r} is not filled "
            f"by the init net (mismatched init/predict pair, or the "
            f"blob was claimed as an input)")
    c_in = blobs[w_name].shape[1]
    # spatial size is data-dependent: custom=side=<n> declares it,
    # defaulting to 32 (the reference's CIFAR pair)
    side = side or 32
    b = batch or 1
    in_shapes = [(b, c_in, side, side)]
    out_shapes, out_dtypes = probe_outputs(
        fn, params, in_shapes, [np.dtype(np.float32)])
    return LoweredModel(
        fn=fn, params=params,
        in_shapes=in_shapes,
        in_dtypes=[np.dtype(np.float32)],
        out_shapes=out_shapes, out_dtypes=out_dtypes,
        name=os.path.basename(predict_path))


def _op_step(op: C2Op, cache):
    """step(get, params) → the op's first output; args read here, once."""
    t = op.type
    ins, out = op.inputs, op.outputs[0]
    if op.args.get("order", "NCHW") != "NCHW":
        raise BackendError(f"caffe2 {t}: only order=NCHW supported")
    if t == "Conv":
        unsupported = [a for a in _CONV_REFUSED if a in op.args]
        if unsupported:
            raise BackendError(
                f"caffe2 Conv: args {unsupported} are not lowered (square "
                f"kernel/stride/pad only); refusing to run with "
                f"silently-wrong numerics")
        stride = int(op.args.get("stride", 1))
        pad = int(op.args.get("pad", 0))
        kernel = op.args.get("kernel")

        def conv(get, p):
            x, w = get(ins[0]), get(ins[1])
            if kernel is not None and int(kernel) != w.shape[-1]:
                raise BackendError(
                    f"caffe2 Conv: kernel arg {int(kernel)} disagrees with "
                    f"weight shape {tuple(w.shape)}")
            return F.conv2d(x, w, get(ins[2]) if len(ins) > 2 else None,
                            stride=stride, padding=pad)
        return conv
    if t == "SpatialBN":
        if not op.args.get("is_test", 0):
            raise BackendError("caffe2 SpatialBN: only inference (is_test=1)")
        eps = float(op.args.get("epsilon", 1e-5))

        def bn(get, p):
            scale = p.get(out + "/bn_scale")
            if scale is None:                        # computed statistics
                s, b = get(ins[1]), get(ins[2])
                rm, riv = get(ins[3]), get(ins[4])
                inv = (s / torch.sqrt(riv + eps)).reshape(1, -1, 1, 1)
                shift = b.reshape(1, -1, 1, 1) - rm.reshape(1, -1, 1, 1) * inv
                return torch.addcmul(shift, get(ins[0]), inv)
            return torch.addcmul(p[out + "/bn_shift"], get(ins[0]), scale)
        return bn
    if t == "Relu":
        return lambda get, p: torch.clamp(get(ins[0]), min=0)
    if t == "Sum":
        def add_all(get, p):
            acc = get(ins[0])
            for i in ins[1:]:
                acc = acc + get(i)
            return acc
        return add_all
    if t in ("AveragePool", "MaxPool"):
        k = int(op.args.get("kernel", 0))
        pad = int(op.args.get("pad", 0))
        stride = int(op.args.get("stride", 1))
        glob = bool(op.args.get("global_pooling", 0))
        is_max = t == "MaxPool"

        def pool(get, p):
            x = get(ins[0])
            if glob or (pad == 0 and k == x.shape[-1] == x.shape[-2]):
                return (torch.amax(x, dim=(2, 3), keepdim=True) if is_max
                        else x.mean(dim=(2, 3), keepdim=True))
            # NHWC views: max pads never win, averages count valid cells
            y = pool_nhwc(x.permute(0, 2, 3, 1), is_max, (k, k),
                          (stride, stride), (pad, pad, pad, pad), cache)
            return y.permute(0, 3, 1, 2).to(x.dtype)
        return pool
    if t == "FC":
        return lambda get, p: F.linear(
            get(ins[0]).reshape(get(ins[0]).shape[0], -1), get(ins[1]),
            get(ins[2]))
    if t == "Softmax":
        # caffe2 semantics: flatten to 2D around `axis` (default 1) and
        # normalize over the trailing block
        ax = int(op.args.get("axis", 1))

        def softmax(get, p):
            x = get(ins[0])
            lead = int(np.prod(x.shape[:ax])) if ax else 1
            return torch.softmax(x.reshape(lead, -1), dim=-1) \
                .reshape(x.shape)
        return softmax
    if t == "Dropout":
        return lambda get, p: get(ins[0])
    raise BackendError(
        f"caffe2 op {t!r} is not supported by the torch lowering")
