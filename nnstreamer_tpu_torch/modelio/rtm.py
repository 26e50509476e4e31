"""DeepViewRT `.rtm` ingestion.

The port of the JAX package's modelio/rtm.py. The reference runs RTM
models through the Au-Zone DeepViewRT runtime
(`ext/nnstreamer/tensor_filter/tensor_filter_deepview_rt.cc:595` loads
the container via nn_model APIs); this module reads the container
itself — no vendor runtime; the flatbuffer parser is a copy — and runs
the layers in order as plain PyTorch calls on NHWC tensors (convs and
pools on channels-last NCHW views, weights reordered once at load:
HWIO → OIHW, depthwise HWCM → (C·M)1HW with ``groups = C``).

Container layout (reversed from the reference's own checked-in
`mobilenet_v1_0.25_224.rtm`, "DeepViewRT 2.4.38 for Python"):

- A FlatBuffer with file identifier ``RTMx`` (root table at the front,
  data growing toward EOF).
- Root: fid1 = creator string, fid3 = name, fid8 = [Layer],
  fid15/fid16 = inline scalars (version words).
- Layer: fid0 = name, fid2 = type (u16: 1 = Input, 2 = Const,
  0x3c = Conv2D, 0x3d = Pool, 0x65 = Reshape, 0x2c = Softmax),
  fid3 = [i32 input layer index], fid4 = [Attr table],
  fid5 = [i32 output shape, NHWC], fid9 = dtype tag (u8, 11 = f32).
- Attr: fid0 = name, fid1 = [i32] values (strides/dilations/ksize/
  head/tail/shape/axes; for the Const layer's single ``data`` attr
  fid1 is the tensor shape), fid2 = [f32] tensor data, fid3 = [i32]
  override values (``groups`` stores its real value here — fid1 is 1
  even for depthwise layers).
- Weight layouts are TF-native: HWIO for regular convolutions,
  HWCM (kh, kw, C, mult) for depthwise (groups == C).

Activation and pooling kind are stored as strings inside a per-layer
serialized record blob whose addressing is not consistently decodable;
they are instead inferred from the converter's terminal-op layer
naming (`.../Relu6` → relu6, `.../Relu` → relu, otherwise linear;
`AvgPool`/`MaxPool` for pooling) — the TF exporter names each fused
layer after its last op, and the in-env golden pins the semantics:
orange.png → "orange", the exact expectation of
`tests/nnstreamer_filter_deepview_rt/runTest.sh:72-75`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from struct import error as struct_error
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.flatbuf import Reader
from nnstreamer_tpu_torch.modelio.tflite import (
    LoweredModel, conv_nhwc, pool_nhwc, probe_outputs)

#: Layer.type values (fid2, u16)
_T_INPUT = 0x01
_T_CONST = 0x02
_T_SOFTMAX = 0x2C
_T_CONV = 0x3C
_T_POOL = 0x3D
_T_RESHAPE = 0x65

_TYPE_NAMES = {_T_INPUT: "Input", _T_CONST: "Const", _T_CONV: "Conv2D",
               _T_POOL: "Pool", _T_RESHAPE: "Reshape",
               _T_SOFTMAX: "Softmax"}


@dataclass
class RTMLayer:
    index: int
    name: str
    type: int
    inputs: List[int]
    shape: Tuple[int, ...]
    attrs: Dict[str, List[int]] = field(default_factory=dict)
    tensor: Optional[np.ndarray] = None

    @property
    def type_name(self) -> str:
        return _TYPE_NAMES.get(self.type, f"type_{self.type:#x}")


@dataclass
class RTMGraph:
    creator: str
    layers: List[RTMLayer]


def parse_rtm(path: str) -> RTMGraph:
    """Parse a .rtm flatbuffer into a graph description (host side)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[4:8] != b"RTMx":
        raise BackendError(
            f"{path!r} is not a DeepViewRT model (missing RTMx "
            f"identifier)")
    try:
        return _parse(buf)
    except (IndexError, ValueError, UnicodeDecodeError,
            struct_error, MemoryError) as e:
        raise BackendError(f"rtm {path!r}: malformed flatbuffer: {e}")


def _parse(buf: bytes) -> RTMGraph:
    r = Reader(buf)
    root = r.root()
    layers: List[RTMLayer] = []
    for i, t in enumerate(r.field_vec_tables(root, 8)):
        typ = r.field_scalar(t, 2, "<H", 0)
        ins = r.field_vec_scalars(t, 3, np.int32)
        shape = r.field_vec_scalars(t, 5, np.int32)
        attrs: Dict[str, List[int]] = {}
        tensor = None
        for at in r.field_vec_tables(t, 4):
            aname = r.field_string(at, 0) or ""
            i1 = r.field_vec_scalars(at, 1, np.int32)
            f2 = r.field_vec_scalars(at, 2, np.float32)
            i3 = r.field_vec_scalars(at, 3, np.int32)
            if aname == "data" and f2 is not None:
                # no shape vector = a legal flat tensor
                ts = [int(x) for x in i1] if i1 is not None \
                    else [int(f2.size)]
                if f2.size != int(np.prod(ts)):
                    raise BackendError(
                        f"rtm: const layer {i} data has {f2.size} "
                        f"elements for shape {ts}")
                tensor = np.asarray(f2).reshape(ts)
            elif i3 is not None and i3.size:
                # the real value slot when present (e.g. groups)
                attrs[aname] = [int(x) for x in i3]
            elif i1 is not None:
                attrs[aname] = [int(x) for x in i1]
        layers.append(RTMLayer(
            index=i, name=r.field_string(t, 0) or f"layer{i}",
            type=typ,
            inputs=[int(x) for x in ins] if ins is not None else [],
            shape=tuple(int(x) for x in shape)
            if shape is not None else (),
            attrs=attrs, tensor=tensor))
    return RTMGraph(creator=r.field_string(root, 1) or "", layers=layers)


def _activation(name: str):
    """Terminal-op naming → activation (see module docstring)."""
    tail = name.rsplit("/", 1)[-1].lower()
    if "relu6" in tail:
        return lambda x: torch.clamp(x, 0.0, 6.0)
    if "relu" in tail:
        return lambda x: torch.clamp(x, min=0.0)
    return None


def _pad2d(attrs: Dict[str, List[int]]) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) from the NHWC head/tail attrs."""
    head = attrs.get("head", [0, 0, 0, 0])
    tail = attrs.get("tail", [0, 0, 0, 0])
    return head[1], tail[1], head[2], tail[2]


def lower_rtm(graph: RTMGraph, batch: Optional[int] = None) -> LoweredModel:
    """RTMGraph → LoweredModel: the layers in order, NHWC throughout."""
    by_index = {lay.index: lay for lay in graph.layers}
    input_layers: List[RTMLayer] = []
    compute: List[RTMLayer] = []
    for lay in graph.layers:
        if lay.type == _T_INPUT:
            input_layers.append(lay)
        elif lay.type == _T_CONST:
            if lay.tensor is None:
                raise BackendError(
                    f"rtm: Const layer {lay.name!r} has no data attr")
        else:
            compute.append(lay)
    if not input_layers:
        raise BackendError("rtm: graph declares no Input layer")
    if not compute:
        raise BackendError("rtm: graph has no computable layers")

    in_shapes = []
    for lay in input_layers:
        shape = tuple(lay.shape) or (1,)
        if batch:
            if len(shape) < 2:
                raise BackendError(
                    f"rtm: batch override needs a rank>=2 input; "
                    f"{lay.name!r} has shape {shape}")
            shape = (batch,) + shape[1:]
        in_shapes.append(shape)

    def const(i: int) -> Optional[np.ndarray]:
        lay = by_index.get(i)
        return lay.tensor if lay is not None and lay.type == _T_CONST \
            else None

    # constants as params: a conv's weights once, in the layout F.conv2d
    # reads; the rest as stored
    params: Dict[str, Any] = {}
    for lay in compute:
        for k, i in enumerate(lay.inputs):
            w = const(i)
            if w is None:
                continue
            t = torch.from_numpy(np.array(w, np.float32))
            if lay.type == _T_CONV and k == 1:
                groups = lay.attrs.get("groups", [1])[0]
                if groups > 1:
                    # HWCM depthwise layout → (C·M, 1, kh, kw), groups = C
                    kh, kw, c, m = t.shape
                    if c != groups:
                        raise BackendError(
                            f"rtm: depthwise {lay.name!r} kernel channels "
                            f"{c} != groups {groups}")
                    params[f"{i}/dw"] = t.reshape(kh, kw, c * m) \
                        .permute(2, 0, 1).unsqueeze(1).contiguous()
                else:                               # HWIO → OIHW
                    params[f"{i}/oihw"] = t.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
            else:
                params[str(i)] = t

    consumed = {i for lay in compute for i in lay.inputs}
    out_layers = [lay for lay in compute if lay.index not in consumed] \
        or [compute[-1]]
    cache: Dict[tuple, torch.Tensor] = {}
    steps = [(lay.index, _layer_step(lay, cache)) for lay in compute]

    def fn(p, *xs):
        blobs: Dict[int, Any] = {}
        for lay, x in zip(input_layers, xs):
            blobs[lay.index] = x.to(torch.float32)

        def get(i, layout: str = ""):
            v = blobs.get(i)
            if v is not None:
                if layout:
                    raise BackendError(
                        f"rtm: conv weights from layer {i} are computed at "
                        f"run time; only constant weights are supported")
                return v
            v = p.get(f"{i}/{layout}" if layout else str(i))
            if v is None:
                raise BackendError(
                    f"rtm: layer input {i} undefined (graph not "
                    f"topologically ordered?)")
            return v

        for index, step in steps:
            blobs[index] = step(get)
        return tuple(blobs[lay.index] for lay in out_layers)

    io = [np.dtype(np.float32)] * len(in_shapes)
    out_shapes, out_dtypes = probe_outputs(fn, params, in_shapes, io)
    return LoweredModel(
        fn=fn, params=params, in_shapes=in_shapes, in_dtypes=io,
        out_shapes=out_shapes, out_dtypes=out_dtypes, name="rtm")


def _layer_step(lay: RTMLayer, cache):
    """step(get) → the layer's output; attrs read here, once."""
    if lay.type == _T_CONV:
        if len(lay.inputs) not in (2, 3):
            raise BackendError(
                f"rtm: Conv2D {lay.name!r} expects (input, weights[, "
                f"bias]) — got {len(lay.inputs)} inputs")
        groups = lay.attrs.get("groups", [1])[0]
        strides = lay.attrs.get("strides", [1, 1, 1, 1])
        dil = lay.attrs.get("dilations", [1, 1, 1, 1])
        stride, dil = tuple(strides[1:3]), tuple(dil[1:3])
        pads = _pad2d(lay.attrs)
        act = _activation(lay.name)
        layout = "dw" if groups > 1 else "oihw"
        ins = lay.inputs

        def conv(get):
            b = get(ins[2]) if len(ins) == 3 else None
            y = conv_nhwc(get(ins[0]), get(ins[1], layout), b, stride, dil,
                          pads, groups)
            return act(y) if act is not None else y
        return conv
    if lay.type == _T_POOL:
        ksize = lay.attrs.get("ksize", [1, 1, 1, 1])
        strides = lay.attrs.get("strides", [1, 1, 1, 1])
        is_avg = "max" not in lay.name.rsplit("/", 1)[-1].lower()
        window, stride = (ksize[1], ksize[2]), tuple(strides[1:3])
        pads = _pad2d(lay.attrs)
        src = lay.inputs[0]

        def pool(get):
            x = get(src)
            if window == tuple(x.shape[1:3]):
                # global pool — one reduce, no window op
                return (x.mean(dim=(1, 2), keepdim=True) if is_avg
                        else torch.amax(x, dim=(1, 2), keepdim=True))
            # padded averages exclude the padding from the divisor
            return pool_nhwc(x, not is_avg, window, stride, pads, cache)
        return pool
    if lay.type == _T_RESHAPE:
        shape = lay.attrs.get("shape")
        if not shape:
            raise BackendError(
                f"rtm: Reshape {lay.name!r} has no shape attr")
        src = lay.inputs[0]

        def reshape(get):
            x = get(src)
            tgt = list(shape)
            if tgt and tgt[0] == 1 and x.shape[0] != 1:
                # the file's shape attr is batch-1; follow the input's
                # batch (batch= override)
                tgt[0] = x.shape[0]
            if int(np.prod(tgt)) != int(np.prod(x.shape)):
                raise BackendError(
                    f"rtm: Reshape {lay.name!r} target {tgt} does not "
                    f"match input shape {tuple(x.shape)}")
            return x.reshape(tgt)
        return reshape
    if lay.type == _T_SOFTMAX:
        axis = lay.attrs.get("axes", [-1])[0]
        src = lay.inputs[0]
        return lambda get: torch.softmax(get(src), dim=axis)
    raise BackendError(
        f"rtm: layer type {lay.type_name} ({lay.name!r}) has no lowering "
        f"(supported: Input, Const, Conv2D, Pool, Reshape, Softmax)")
