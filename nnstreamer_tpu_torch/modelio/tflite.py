"""TFLite model ingestion → one torch function on the card.

The port of the JAX package's modelio/tflite.py. The flatbuffer parser
(`parse_tflite`, via the self-contained reader in `flatbuf.py`, no
TFLite/TF dependency) is a copy; the lowering is rewritten in torch: the
graph's ops run as plain PyTorch calls (cuDNN convs, cuBLAS matmuls,
elementwise kernels) in the file's op order, eagerly, on whatever device
the inputs and params are on. The JAX package hands the same graph to
XLA as one fused program; these are its XLA ops, not hand-written
kernels.

Layout: TFLite tensors are NHWC and every op keeps NHWC meaning (axes of
RESHAPE, CONCATENATION, MEAN, SQUEEZE, STRIDED_SLICE, GATHER,
PACK/UNPACK are the file's). Convs and pools view the NHWC tensor as
NCHW with ``permute(0, 3, 1, 2)`` — a channels-last view, no copy, which
cuDNN takes as it is — and permute the result back. Conv weights are
reordered once at load: CONV_2D OHWI → OIHW (as a permuted view, so it
stays channels-last), DEPTHWISE_CONV_2D 1HW(C·m) → (C·m)1HW with
``groups=C``. SAME padding is TF's: total max((⌈in/s⌉−1)·s + k − in, 0),
the extra pixel at the bottom and right, through an explicit `F.pad`
when it is uneven; SAME average pools divide by the count of valid
pixels in each window (a count tensor made once per shape).

Quantization ("dequantize → float", as in the JAX package): quantized
(uint8/int8) weights are dequantized **once at load time** with their
per-tensor or per-channel scale/zero-point; activations run in a float
compute dtype (bf16 by default, f32 for parity). Each op output is
clamped to its tensor's representable quantized range — which subsumes
fused ReLU/ReLU6 activations. Graph inputs/outputs keep their stored
(possibly integer) dtype; with `quantize_output` the final output is
re-quantized, rounding half to even and saturating. Float params are
stored in the compute dtype (the JAX lowering casts them there at each
use: the same values, one launch fewer a weight).

Static inputs (reshape targets, pad widths, reduce axes, permutations,
slice bounds) stay host numpy in the params: read as a CUDA tensor with
``.tolist()`` they would sync on every frame and break graph capture.

Batch: the lowered graph runs the batch it was lowered for — the file's
(usually 1) or ``custom=batch=N`` (`bshape`), which RESHAPE targets take
up. Any other batch fails at the first RESHAPE that names the batch, so
the torch backend's batchability verdict runs such a model one invoke a
frame.

Control flow: WHILE runs its cond and body subgraphs in a Python loop;
the condition is read on the host, one sync a step. Inside a CUDA graph
capture the op raises before that read (a sync would invalidate the
capture and leave it unfinished), so a window's capture of such a model
fails cleanly — the backend remembers it and the frames run per frame —
and its batchability verdict on the ``meta`` device is "not
batchable".

Custom ops lower through `register_tflite_custom_op` (built-in:
`TFLite_Detection_PostProcess`, tflite_custom.py). Unsupported ops and
unregistered custom ops fail loudly, naming the op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.flatbuf import Reader

# -- TFLite schema constants (schema.fbs, stable public format) -----------

# Model table field ids
_MODEL_OPERATOR_CODES = 1
_MODEL_SUBGRAPHS = 2
_MODEL_BUFFERS = 4
# OperatorCode
_OPCODE_DEPRECATED_BUILTIN = 0
_OPCODE_CUSTOM = 1
_OPCODE_BUILTIN = 3
# SubGraph
_SG_TENSORS = 0
_SG_INPUTS = 1
_SG_OUTPUTS = 2
_SG_OPERATORS = 3
# Tensor
_T_SHAPE = 0
_T_TYPE = 1
_T_BUFFER = 2
_T_NAME = 3
_T_QUANT = 4
# QuantizationParameters
_Q_SCALE = 2
_Q_ZERO_POINT = 3
_Q_QUANTIZED_DIM = 6
# Operator
_OP_OPCODE_INDEX = 0
_OP_INPUTS = 1
_OP_OUTPUTS = 2
_OP_OPTIONS = 4
# Buffer
_BUF_DATA = 0

# TensorType enum → numpy dtype. RESOURCE(13)/VARIANT(14) are opaque
# handles (LSTM/RNN state variables); they carry no data and map to a
# placeholder dtype — ops that consume them handle the state explicitly.
_TENSOR_TYPES: Dict[int, np.dtype] = {
    0: np.dtype(np.float32), 1: np.dtype(np.float16), 2: np.dtype(np.int32),
    3: np.dtype(np.uint8), 4: np.dtype(np.int64), 6: np.dtype(np.bool_),
    7: np.dtype(np.int16), 9: np.dtype(np.int8), 10: np.dtype(np.float64),
    13: np.dtype(np.int32), 14: np.dtype(np.int32),
}

# BuiltinOperator enum values used below
OP = dict(
    ADD=0, AVERAGE_POOL_2D=1, CONCATENATION=2, CONV_2D=3,
    DEPTHWISE_CONV_2D=4, DEPTH_TO_SPACE=5, DEQUANTIZE=6, FLOOR=8,
    FULLY_CONNECTED=9, L2_NORMALIZATION=11, LOGISTIC=14,
    MAX_POOL_2D=17, MUL=18, RELU=19, RELU6=21, RESHAPE=22,
    RESIZE_BILINEAR=23, SOFTMAX=25, SPACE_TO_DEPTH=26, TANH=28, PAD=34,
    GATHER=36, TRANSPOSE=39,
    MEAN=40, SUB=41, DIV=42, SQUEEZE=43, STRIDED_SLICE=45, EXP=47,
    SPLIT=49, LOG_SOFTMAX=50, CAST=53, MAXIMUM=55, ARG_MAX=56,
    MINIMUM=57,
    LESS=58, NEG=59, GREATER=61, GREATER_EQUAL=62, LESS_EQUAL=63,
    SELECT=64, SLICE=65, SIN=66, TRANSPOSE_CONV=67, TILE=69,
    EXPAND_DIMS=70, EQUAL=71, LOG=73, SUM=74, SQRT=75, RSQRT=76,
    POW=78, ARG_MIN=79, REDUCE_PROD=81, REDUCE_MAX=82, PACK=83,
    LOGICAL_AND=86, UNPACK=88, REDUCE_MIN=89,
    LEAKY_RELU=98, SQUARED_DIFFERENCE=99, MIRROR_PAD=100, ABS=101,
    CEIL=104, COS=108, ELU=111,
    RESIZE_NEAREST_NEIGHBOR=97, HARD_SWISH=117, QUANTIZE=114,
    WHILE=119, SELECT_V2=123, BATCH_MATMUL=126, GELU=150,
)
_OP_NAMES = {v: k for k, v in OP.items()}

#: custom-op registry: name → fn(op, inputs_tuple, opts_dict) → tuple of
#: outputs (torch tensors). Register via `register_tflite_custom_op`.
TFLITE_CUSTOM_OPS: Dict[str, Callable] = {}


def register_tflite_custom_op(name: str):
    """Decorator registering a torch lowering for a TFLite custom op (the
    subplugin-style extension point the reference exposes through each
    NN framework's own custom-op resolver)."""
    def deco(fn):
        TFLITE_CUSTOM_OPS[name] = fn
        return fn
    return deco


def _decode_flexbuffer_map(data: bytes) -> Dict[str, Any]:
    """Custom-op options arrive as a FlexBuffers map (converter
    convention); decode to a plain dict. Undecodable options raise —
    running a custom op with default options would be silently wrong."""
    if not data:
        return {}
    try:
        from nnstreamer_tpu_torch.interop.flexbuf_read import flexbuf_loads

        root = flexbuf_loads(data)
        if not isinstance(root, dict):
            raise ValueError("custom_options root is not a map")
        # scalar/str options only (converter convention for op options)
        return {k: v for k, v in root.items()
                if isinstance(v, (bool, int, float, str))}
    except Exception as e:
        raise BackendError(
            f"undecodable TFLite custom_options ({e}); cannot run the "
            f"custom op with defaults") from None

# ActivationFunctionType
_ACT_NONE, _ACT_RELU, _ACT_RELU_N1_1, _ACT_RELU6 = 0, 1, 2, 3
# Padding enum
_PAD_SAME, _PAD_VALID = 0, 1


@dataclass
class TensorDef:
    index: int
    shape: Tuple[int, ...]
    dtype: np.dtype
    name: str
    buffer: Optional[np.ndarray]          # raw constant data or None
    scale: Optional[np.ndarray] = None    # quant scales ([] ⇒ not quantized)
    zero_point: Optional[np.ndarray] = None
    qdim: int = 0

    @property
    def quantized(self) -> bool:
        return (self.scale is not None and self.scale.size > 0
                and self.dtype.kind in "iu")


@dataclass
class OpDef:
    code: int
    name: str
    inputs: List[int]
    outputs: List[int]
    opts: Optional[int]          # options table position in the flatbuffer
    custom_name: Optional[str] = None
    custom_options: bytes = b""


@dataclass
class Subgraph:
    """One TFLite subgraph (main graph or a control-flow body)."""

    tensors: List[TensorDef]
    ops: List[OpDef]
    inputs: List[int]
    outputs: List[int]


@dataclass
class TFLiteGraph:
    reader: Reader
    tensors: List[TensorDef]     # = subgraphs[0].tensors
    ops: List[OpDef]             # = subgraphs[0].ops
    inputs: List[int]
    outputs: List[int]
    path: str = ""
    subgraphs: List[Subgraph] = field(default_factory=list)


# Operator.custom_options (schema field id 5)
_OP_CUSTOM_OPTIONS = 5


def parse_tflite(path: str) -> TFLiteGraph:
    """Parse a .tflite flatbuffer into a graph description (host-side).

    All subgraphs are parsed — control-flow ops (WHILE) reference the
    extra subgraphs as their cond/body."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[4:8] != b"TFL3":
        raise BackendError(
            f"{path!r} is not a TFLite flatbuffer (missing TFL3 identifier)")
    from nnstreamer_tpu_torch.modelio.protowire import wire_context

    with wire_context(f"tflite {path!r}", BackendError):
        return _parse_tflite_buf(buf, path)


def _parse_tflite_buf(buf: bytes, path: str) -> TFLiteGraph:
    r = Reader(buf)
    model = r.root()

    # operator codes: deprecated_builtin_code (int8) was the original field;
    # values >=127 moved to the int32 builtin_code field (schema v3a)
    codes: List[Tuple[int, Optional[str]]] = []
    for oc in r.field_vec_tables(model, _MODEL_OPERATOR_CODES):
        dep = r.field_scalar(oc, _OPCODE_DEPRECATED_BUILTIN, "<b", 0)
        full = r.field_scalar(oc, _OPCODE_BUILTIN, "<i", 0)
        codes.append((max(dep, full), r.field_string(oc, _OPCODE_CUSTOM)))

    buffers = r.field_vec_tables(model, _MODEL_BUFFERS)
    raw_subgraphs = r.field_vec_tables(model, _MODEL_SUBGRAPHS)
    if not raw_subgraphs:
        raise BackendError(f"{path!r}: no subgraphs")

    def parse_sg(sg) -> Subgraph:
        tensors: List[TensorDef] = []
        for i, tpos in enumerate(r.field_vec_tables(sg, _SG_TENSORS)):
            shape_v = r.field_vec_scalars(tpos, _T_SHAPE, np.int32)
            shape = tuple(int(d) for d in shape_v) \
                if shape_v is not None else ()
            ttype = r.field_scalar(tpos, _T_TYPE, "<b", 0)
            dtype = _TENSOR_TYPES.get(ttype)
            if dtype is None:
                raise BackendError(
                    f"{path!r}: tensor {i} has unsupported TensorType "
                    f"{ttype}")
            buf_idx = r.field_scalar(tpos, _T_BUFFER, "<I", 0)
            data = None
            if buf_idx and buf_idx < len(buffers):
                raw = r.field_vec_scalars(buffers[buf_idx], _BUF_DATA,
                                          np.uint8)
                if raw is not None and raw.size:
                    data = raw.view(dtype).reshape(
                        shape if shape else (-1,))
            scale = zp = None
            qdim = 0
            q = r.field_table(tpos, _T_QUANT)
            if q is not None:
                scale = r.field_vec_scalars(q, _Q_SCALE, np.float32)
                zp = r.field_vec_scalars(q, _Q_ZERO_POINT, np.int64)
                qdim = r.field_scalar(q, _Q_QUANTIZED_DIM, "<i", 0)
            tensors.append(TensorDef(
                index=i, shape=shape, dtype=dtype,
                name=r.field_string(tpos, _T_NAME) or f"t{i}",
                buffer=data, scale=scale, zero_point=zp, qdim=qdim))

        ops: List[OpDef] = []
        for opos in r.field_vec_tables(sg, _SG_OPERATORS):
            idx = r.field_scalar(opos, _OP_OPCODE_INDEX, "<I", 0)
            code, custom = codes[idx]
            ins = r.field_vec_scalars(opos, _OP_INPUTS, np.int32)
            outs = r.field_vec_scalars(opos, _OP_OUTPUTS, np.int32)
            copts = r.field_vec_scalars(opos, _OP_CUSTOM_OPTIONS, np.uint8)
            ops.append(OpDef(
                code=code, name=_OP_NAMES.get(code, f"builtin_{code}"),
                inputs=[int(x) for x in (ins if ins is not None else [])],
                outputs=[int(x) for x in
                         (outs if outs is not None else [])],
                opts=r.field_table(opos, _OP_OPTIONS), custom_name=custom,
                custom_options=(copts.tobytes()
                                if copts is not None else b"")))

        g_in = r.field_vec_scalars(sg, _SG_INPUTS, np.int32)
        g_out = r.field_vec_scalars(sg, _SG_OUTPUTS, np.int32)
        return Subgraph(
            tensors=tensors, ops=ops,
            inputs=[int(x) for x in (g_in if g_in is not None else [])],
            outputs=[int(x) for x in (g_out if g_out is not None else [])])

    sgs = [parse_sg(sg) for sg in raw_subgraphs]
    main = sgs[0]
    return TFLiteGraph(
        reader=r, tensors=main.tensors, ops=main.ops,
        inputs=main.inputs, outputs=main.outputs,
        path=path, subgraphs=sgs)


#: numpy dtype → torch dtype of the graph's tensors
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a graph tensor's numpy dtype."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise BackendError(f"no torch dtype for tensor type {dtype}") \
            from None


# -- load-time weight dequantization --------------------------------------

def _dequantize_const(t: TensorDef) -> np.ndarray:
    """Dequantize a constant tensor to float32 (per-tensor or per-channel)."""
    data = t.buffer.astype(np.float32)
    scale = t.scale.astype(np.float32)
    zp = t.zero_point.astype(np.float32) if t.zero_point is not None else \
        np.zeros_like(scale)
    if scale.size == 1:
        return (data - zp[0]) * scale[0]
    bshape = [1] * data.ndim
    bshape[t.qdim] = scale.size
    return (data - zp.reshape(bshape)) * scale.reshape(bshape)


def _qrange(t: TensorDef) -> Tuple[float, float]:
    """Float range representable by a quantized tensor (for saturation)."""
    info = np.iinfo(t.dtype)
    s = float(t.scale[0])
    z = float(t.zero_point[0]) if t.zero_point is not None else 0.0
    return (info.min - z) * s, (info.max - z) * s


# -- lowering ---------------------------------------------------------------

@dataclass
class LoweredModel:
    fn: Callable          # fn(params, *inputs) -> tuple of outputs
    params: Dict[str, Any]
    in_shapes: List[Tuple[int, ...]]
    in_dtypes: List[np.dtype]
    out_shapes: List[Tuple[int, ...]]
    out_dtypes: List[np.dtype]
    name: str = ""
    #: a host-side input stage run on each frame before staging (the
    #: GraphDef DecodeWav entry: bytes in, decoded samples out)
    host_pre: Optional[Callable[[tuple], tuple]] = None


def probe_outputs(fn, params, in_shapes, in_dtypes
                  ) -> Tuple[List[Tuple[int, ...]], List[np.dtype]]:
    """The output shapes and dtypes of `fn(params, *inputs)`, run once on
    the ``meta`` device (no data, no device work) — the lowerings'
    counterpart of the JAX package's eval_shape probe."""
    from nnstreamer_tpu_torch.backends.torch_backend import params_on_meta

    xs = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
          for s, d in zip(in_shapes, in_dtypes)]
    with torch.inference_mode():
        outs = fn(params_on_meta(params), *xs)
    return ([tuple(int(d) for d in o.shape) for o in outs],
            [np.dtype(str(o.dtype).replace("torch.", "")) for o in outs])


def batch_shaper(graph: TFLiteGraph, batch: Optional[int]):
    """→ (bshape, orig_batch): `bshape` maps a tensor shape whose leading
    dim is the file's batch to ``custom=batch=N`` (identity without N)."""
    orig_batch = None
    if batch is not None and graph.inputs:
        in0 = graph.tensors[graph.inputs[0]]
        orig_batch = in0.shape[0] if in0.shape else None

    def bshape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
        if batch is not None and shape and shape[0] == orig_batch:
            return (batch,) + tuple(shape[1:])
        return tuple(shape)

    return bshape, orig_batch


def lower_tflite(graph: TFLiteGraph, batch: Optional[int] = None,
                 compute_dtype: str = "bfloat16",
                 quantize_output: bool = True) -> LoweredModel:
    """Lower a parsed graph to a torch fn + params dict.

    batch: override the file's (usually 1) leading batch dimension.
    compute_dtype: activation dtype ("bfloat16" on the card, "float32"
      for parity).
    quantize_output: re-quantize integer graph outputs (spec parity with
      the file); False emits dequantized float outputs.
    """
    bshape, orig_batch = batch_shaper(graph, batch)
    try:
        cdt = getattr(torch, compute_dtype)
        if not isinstance(cdt, torch.dtype) or not cdt.is_floating_point:
            raise AttributeError
    except AttributeError:
        raise BackendError(
            f"compute dtype {compute_dtype!r} is not a float dtype; use "
            f"bfloat16, float16 or float32 (or int8/native/auto for the "
            f"int8-native lowering)") from None

    subgraphs = graph.subgraphs or [Subgraph(
        tensors=graph.tensors, ops=graph.ops,
        inputs=graph.inputs, outputs=graph.outputs)]
    # params: constants keyed by (subgraph, index). Static (shape-giving)
    # constants stay host numpy; a constant that an op reads at run time
    # is a tensor (float ones in the compute dtype), and conv weights are
    # stored once in the layout their conv reads.
    params: Dict[str, Any] = {}
    static_by_sg: List[Dict[int, np.ndarray]] = []
    for si, sg in enumerate(subgraphs):
        static_consts: Dict[int, np.ndarray] = {}
        static, runtime, conv_w, dw_w = _const_uses(sg)
        for t in sg.tensors:
            if t.buffer is None:
                continue
            key = _pkey(si, t.index)
            if t.index in static:
                static_consts[t.index] = np.asarray(t.buffer)
                if t.index not in runtime | conv_w | dw_w:
                    params[key] = np.asarray(t.buffer)
            if not (t.index in runtime or t.index in conv_w
                    or t.index in dw_w):
                continue
            arr = _dequantize_const(t) if t.quantized \
                else np.asarray(t.buffer)
            if t.shape == () and arr.size == 1:
                arr = arr.reshape(())           # a scalar, as declared
            ten = torch.from_numpy(np.array(arr))
            if ten.is_floating_point():
                ten = ten.to(cdt)
            if t.index in runtime:
                params[key] = ten
            if t.index in conv_w:           # OHWI → OIHW, channels-last
                params[key + "/oihw"] = ten.permute(0, 3, 1, 2)
            if t.index in dw_w:             # 1HW(C·m) → (C·m)1HW
                params[key + "/dw"] = ten.permute(3, 0, 1, 2).contiguous()
        static_by_sg.append(static_consts)

    tensors = graph.tensors
    cache: Dict[tuple, torch.Tensor] = {}

    def run_sg(si: int, p, in_vals: Tuple) -> Tuple:
        """Evaluate one subgraph given its input values (used for the
        main graph and recursively for WHILE cond/body graphs)."""
        sg = subgraphs[si]
        vals: Dict[int, Any] = dict(zip(sg.inputs, in_vals))

        def get(i, layout: str = ""):
            if not layout and i in vals:
                return vals[i]
            key = _pkey(si, i) + (f"/{layout}" if layout else "")
            v = p.get(key)
            if isinstance(v, torch.Tensor):
                return v
            if layout and i in vals:
                raise BackendError(
                    f"conv weight tensor {i} ({sg.tensors[i].name!r}) is "
                    f"computed at run time; only constant weights are "
                    f"supported")
            raise BackendError(
                f"op input tensor {i} ({sg.tensors[i].name!r}) has no "
                f"value (dynamic graph order not supported)")

        ctx = dict(run_sg=lambda si2, c: run_sg(si2, p, c), sg_index=si,
                   batch=batch, orig_batch=orig_batch, cache=cache)
        for op in sg.ops:
            out = _eval_op(graph, sg, op, get, static_by_sg[si], cdt, ctx)
            outs = out if isinstance(out, tuple) else (out,)
            for oi, o in zip(op.outputs, outs):
                ot = sg.tensors[oi]
                if ot.quantized and o.is_floating_point():
                    lo, hi = _qrange(ot)
                    o = torch.clamp(o, lo, hi)
                vals[oi] = o
        return tuple(vals[i] for i in sg.outputs)

    def fn(p, *inputs):
        if len(inputs) != len(graph.inputs):
            raise BackendError(
                f"model {graph.path!r} expects {len(graph.inputs)} inputs, "
                f"got {len(inputs)}")
        staged = []
        for idx, x in zip(graph.inputs, inputs):
            t = tensors[idx]
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            if t.quantized:
                s = float(t.scale[0])
                z = float(t.zero_point[0]) if t.zero_point is not None else 0.0
                x = (x.to(torch.float32) - z) * s
            elif t.dtype == np.bool_:
                x = x.to(torch.bool)        # uint8 on the wire → bool
            staged.append(x.to(cdt) if x.is_floating_point() else x)
        outs = run_sg(0, p, tuple(staged))

        results = []
        for idx, y in zip(graph.outputs, outs):
            t = tensors[idx]
            if t.quantized and quantize_output:
                s = float(t.scale[0])
                z = float(t.zero_point[0]) if t.zero_point is not None else 0.0
                info = np.iinfo(t.dtype)
                q = torch.round(y.to(torch.float32) / s) + z
                y = torch.clamp(q, info.min, info.max).to(torch_dtype(t.dtype))
            elif y.is_floating_point():
                y = y.to(torch.float32)
            elif y.dtype == torch.bool:
                y = y.to(torch.uint8)       # bool → uint8 on the wire
            results.append(y)
        return tuple(results)

    def io_dtype(t: TensorDef, is_out: bool) -> np.dtype:
        if t.quantized and (not is_out or quantize_output):
            return t.dtype
        if t.dtype == np.bool_:
            # the tensor type system (like the reference's) has no bool:
            # bool tensors ride the wire as uint8
            return np.dtype(np.uint8)
        return np.dtype(np.float32) if t.dtype.kind == "f" or t.quantized \
            else t.dtype

    return LoweredModel(
        fn=fn, params=params,
        in_shapes=[bshape(tensors[i].shape) for i in graph.inputs],
        in_dtypes=[io_dtype(tensors[i], False) for i in graph.inputs],
        out_shapes=[bshape(tensors[i].shape) for i in graph.outputs],
        out_dtypes=[io_dtype(tensors[i], True) for i in graph.outputs],
        name=os.path.basename(graph.path))


def _pkey(si: int, idx: int) -> str:
    """Params-dict key for tensor `idx` of subgraph `si` (subgraph 0
    keeps the bare key)."""
    return f"t{idx}" if si == 0 else f"s{si}t{idx}"


def _static_slots(op: OpDef) -> Tuple[int, ...]:
    """Positions of `op`'s inputs that are static shape/axis/padding
    arguments."""
    ins, code = op.inputs, op.code
    if op.custom_name:
        return ()
    if code in (OP["RESHAPE"], OP["MEAN"], OP["SUM"], OP["PAD"],
                OP["TRANSPOSE"], OP["ARG_MAX"], OP["EXPAND_DIMS"],
                OP["RESIZE_BILINEAR"], OP["RESIZE_NEAREST_NEIGHBOR"],
                OP["TILE"], OP["MIRROR_PAD"], OP["REDUCE_MAX"],
                OP["REDUCE_MIN"], OP["REDUCE_PROD"], OP["ARG_MIN"]) \
            and len(ins) > 1:
        return (1,)
    if code in (OP["SLICE"], OP["STRIDED_SLICE"]):
        return tuple(range(1, len(ins)))
    if code == OP["SPLIT"] and len(ins) > 1:
        return (0,)                     # axis
    if code == OP["TRANSPOSE_CONV"]:
        return (0,)                     # output_shape
    return ()


def _static_input_indices(graph) -> set:
    """Tensor indices consumed as static shape/axis/padding arguments
    (accepts a TFLiteGraph or a Subgraph)."""
    static = set()
    for op in graph.ops:
        static.update(op.inputs[k] for k in _static_slots(op))
    return static


def _const_uses(sg) -> Tuple[set, set, set, set]:
    """→ (static, runtime, conv weight, depthwise weight) input indices
    of a subgraph's ops: how each constant is read."""
    static, runtime, conv_w, dw_w = set(), set(), set(), set()
    for op in sg.ops:
        slots = _static_slots(op)
        for k, i in enumerate(op.inputs):
            if i < 0:
                continue
            if k in slots:
                static.add(i)
            elif k == 1 and op.code == OP["CONV_2D"] and not op.custom_name:
                conv_w.add(i)
            elif k == 1 and op.code == OP["DEPTHWISE_CONV_2D"] \
                    and not op.custom_name:
                dw_w.add(i)
            else:
                runtime.add(i)
    runtime.update(sg.outputs)          # a constant graph output
    return static, runtime, conv_w, dw_w


def _same_pads(n: int, k: int, stride: int, dil: int = 1) -> Tuple[int, int]:
    """TF SAME padding of one spatial dim → (before, after)."""
    eff = (k - 1) * dil + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + eff - n, 0)
    return total // 2, total - total // 2


def _spatial_pads(x_nchw: torch.Tensor, k_hw, stride, dil, same: bool):
    """(top, bottom, left, right) of a conv or pool over an NCHW view."""
    if not same:
        return (0, 0, 0, 0)
    pt, pb = _same_pads(x_nchw.shape[2], k_hw[0], stride[0], dil[0])
    pl, pr = _same_pads(x_nchw.shape[3], k_hw[1], stride[1], dil[1])
    return (pt, pb, pl, pr)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b, stride, dil,
               same: bool, groups: int) -> torch.Tensor:
    """NHWC conv with OIHW weights, VALID or TF SAME padding."""
    pads = _spatial_pads(x.permute(0, 3, 1, 2), w.shape[2:], stride, dil,
                         same)
    return conv_nhwc(x, w, b, stride, dil, pads, groups)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b, stride, dil, pads,
              groups: int) -> torch.Tensor:
    """NHWC conv with OIHW weights and explicit (top, bottom, left,
    right) pads: the NCHW view in, the NHWC view out; uneven pads through
    F.pad."""
    xc = x.permute(0, 3, 1, 2)
    pt, pb, pl, pr = pads
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w, b, stride=stride, padding=(pt, pl),
                     dilation=dil, groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, b, stride=stride,
                     dilation=dil, groups=groups)
    return y.permute(0, 2, 3, 1)


def pool_nhwc(x: torch.Tensor, is_max: bool, window, stride, pads,
              cache) -> torch.Tensor:
    """NHWC max or average pool with explicit (top, bottom, left, right)
    pads, in TF's meaning: padding never wins a max, and an average
    divides by the valid pixels of its window (a count tensor made once
    per shape; asymmetric under SAME, so count_include_pad cannot say
    it). Averages come back float32."""
    xc = x.permute(0, 3, 1, 2)
    pt, pb, pl, pr = pads
    if is_max:
        if any(pads):
            xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
        return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)
    xf = xc.to(torch.float32)
    if not any(pads):
        return F.avg_pool2d(xf, window, stride).permute(0, 2, 3, 1)
    s = F.avg_pool2d(F.pad(xf, (pl, pr, pt, pb)), window, stride,
                     divisor_override=1)
    h, w_ = xc.shape[2], xc.shape[3]

    def count():
        ones = np.pad(np.ones((h, w_), np.float32), ((pt, pb), (pl, pr)))
        oh = (h + pt + pb - window[0]) // stride[0] + 1
        ow = (w_ + pl + pr - window[1]) // stride[1] + 1
        c = np.zeros((oh, ow), np.float32)
        for i in range(oh):
            for j in range(ow):
                c[i, j] = ones[i * stride[0]:i * stride[0] + window[0],
                               j * stride[1]:j * stride[1] + window[1]].sum()
        return c

    cnt = _dev_const(cache, ("avgcnt", h, w_, tuple(window), tuple(stride),
                             tuple(pads)), x.device, count)
    return (s / cnt).permute(0, 2, 3, 1)


def _dev_const(cache, key, device, make: Callable[[], np.ndarray],
               dtype=None) -> torch.Tensor:
    """A constant tensor made on the host once per (key, device) and kept
    (index maps, pool counts): later calls — and CUDA graph captures,
    which follow an eager run — find it without a host copy."""
    k = key + (str(device), dtype)
    t = cache.get(k)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        if dtype is not None:
            t = t.to(dtype)
        cache[k] = t
    return t


def _resize(x, oh: int, ow: int, bilinear: bool, align_corners: bool,
            half_pixel: bool, cache):
    """TFLite-exact NHWC spatial resize via gather + lerp.

    TFLite has three coordinate maps (kernels/internal resize impls):
    align_corners: src = i*(in-1)/(out-1); half_pixel_centers:
    src = (i+0.5)*in/out - 0.5; legacy/default: src = i*in/out.
    F.interpolate's maps differ, so the coordinates are computed here,
    on the host, once per shape.
    """
    b, h, w, c = x.shape

    def coords(out_n: int, in_n: int) -> np.ndarray:
        i = np.arange(out_n, dtype=np.float64)
        if align_corners and out_n > 1:
            return i * (in_n - 1) / (out_n - 1)
        if half_pixel:
            return np.maximum((i + 0.5) * in_n / out_n - 0.5, 0.0)
        return i * in_n / out_n

    ys, xs = coords(oh, h), coords(ow, w)
    key = ("resize", h, w, oh, ow, bilinear, align_corners, half_pixel)
    dev = x.device

    def idx(name, make):
        return _dev_const(cache, key + (name,), dev, make)

    if not bilinear:
        # TFLite nearest rounds half away from zero (std::round, not
        # numpy's half-to-even) when align_corners, else floors
        yi = idx("yi", lambda: np.minimum(
            np.floor(ys + 0.5) if align_corners else np.floor(ys),
            h - 1).astype(np.int64))
        xi = idx("xi", lambda: np.minimum(
            np.floor(xs + 0.5) if align_corners else np.floor(xs),
            w - 1).astype(np.int64))
        return x.index_select(1, yi).index_select(2, xi)

    y0n = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0n = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y0 = idx("y0", lambda: y0n)
    x0 = idx("x0", lambda: x0n)
    y1 = idx("y1", lambda: np.minimum(y0n + 1, h - 1))
    x1 = idx("x1", lambda: np.minimum(x0n + 1, w - 1))
    wy = _dev_const(cache, key + ("wy",), dev,
                    lambda: (ys - y0n).reshape(1, oh, 1, 1), x.dtype)
    wx = _dev_const(cache, key + ("wx",), dev,
                    lambda: (xs - x0n).reshape(1, 1, ow, 1), x.dtype)
    top = x.index_select(1, y0)
    bot = x.index_select(1, y1)
    tl, tr = top.index_select(2, x0), top.index_select(2, x1)
    bl, br = bot.index_select(2, x0), bot.index_select(2, x1)
    t = tl * (1 - wx) + tr * wx
    bm = bl * (1 - wx) + br * wx
    return t * (1 - wy) + bm * wy


def _mirror_pad(x, pads, symmetric: bool, cache):
    """numpy-style reflect/symmetric padding on every axis (F.pad has no
    symmetric mode and pads only trailing spatial axes): one index_select
    per padded axis, its indices made once per shape."""
    for d, (a, b) in enumerate(pads):
        a, b = int(a), int(b)
        if not (a or b):
            continue
        n = x.shape[d]

        def make(n=n, a=a, b=b):
            if symmetric:
                left = list(range(a - 1, -1, -1))
                right = list(range(n - 1, n - 1 - b, -1))
            else:
                left = list(range(a, 0, -1))
                right = list(range(n - 2, n - 2 - b, -1))
            return np.asarray(left + list(range(n)) + right, np.int64)

        x = x.index_select(d, _dev_const(
            cache, ("mirror", n, a, b, symmetric), x.device, make))
    return x


def _strided_slice_dim(x, d: int, sl: slice):
    """x[..., sl, ...] on axis d, negative steps included (torch slicing
    takes positive steps only: a negative one flips the axis first)."""
    n = x.shape[d]
    start, stop, step = sl.indices(n)
    idx = [slice(None)] * x.dim()
    if step > 0:
        idx[d] = slice(start, stop, step)
        return x[tuple(idx)]
    count = len(range(start, stop, step))
    first = n - 1 - start
    idx[d] = slice(first, first + (-step) * (count - 1) + 1 if count else
                   first, -step)
    return x.flip(d)[tuple(idx)]


def _act(x, act: int):
    if act == _ACT_NONE:
        return x
    if act == _ACT_RELU:
        return torch.clamp(x, min=0)
    if act == _ACT_RELU_N1_1:
        return torch.clamp(x, -1, 1)
    if act == _ACT_RELU6:
        return torch.clamp(x, 0, 6)
    raise BackendError(f"unsupported fused activation {act}")


def _norm_axes(axes, ndim: int) -> Tuple[int, ...]:
    return tuple(sorted({a % ndim for a in axes}))


def _eval_op(graph: TFLiteGraph, sg: "Subgraph", op: OpDef, get,
             static_consts, cdt, ctx):
    r = graph.reader
    o = op.opts
    code = op.code
    tensors = sg.tensors
    cache = ctx["cache"]

    if op.custom_name:
        impl = TFLITE_CUSTOM_OPS.get(op.custom_name)
        if impl is None:
            raise BackendError(
                f"TFLite custom op {op.custom_name!r} in {graph.path!r} "
                f"has no registered lowering; register one with "
                f"modelio.tflite.register_tflite_custom_op")
        opts = _decode_flexbuffer_map(op.custom_options)
        return impl(op, tuple(get(i) for i in op.inputs if i >= 0), opts)

    def opt_i(fid, default=0):
        return r.field_scalar(o, fid, "<i", default) if o is not None \
            else default

    def opt_b(fid, default=0):
        return r.field_scalar(o, fid, "<b", default) if o is not None \
            else default

    def opt_f(fid, default=0.0):
        return r.field_scalar(o, fid, "<f", default) if o is not None \
            else default

    def static(i):
        if i in static_consts:
            return static_consts[i]
        t = tensors[i]
        if t.buffer is not None:
            return np.asarray(t.buffer)
        raise BackendError(
            f"{op.name}: input tensor {i} must be a compile-time constant")

    def bias(k):
        if len(op.inputs) > k and op.inputs[k] >= 0:
            return get(op.inputs[k])
        return None

    def out_dtype(k=0):
        return torch_dtype(tensors[op.outputs[k]].dtype)

    if code == OP["CONV_2D"]:
        x = get(op.inputs[0])
        w = get(op.inputs[1], "oihw")
        stride = (opt_i(2, 1), opt_i(1, 1))        # (h, w)
        dil = (opt_i(5, 1), opt_i(4, 1))
        y = _conv_nhwc(x, w, bias(2), stride, dil, opt_b(0) == _PAD_SAME,
                       groups=x.shape[-1] // w.shape[1])
        return _act(y.to(cdt), opt_b(3))

    if code == OP["DEPTHWISE_CONV_2D"]:
        x = get(op.inputs[0])
        w = get(op.inputs[1], "dw")                # (C*mult, 1, H, W)
        stride = (opt_i(2, 1), opt_i(1, 1))
        dil = (opt_i(6, 1), opt_i(5, 1))
        y = _conv_nhwc(x, w, bias(2), stride, dil, opt_b(0) == _PAD_SAME,
                       groups=x.shape[-1])
        return _act(y.to(cdt), opt_b(4))

    if code == OP["FULLY_CONNECTED"]:
        x = get(op.inputs[0])
        w = get(op.inputs[1])                      # [out, in]
        if x.dim() != 2:
            # TFLite batch = total_size / in_features, not the leading dim
            x = x.reshape((-1, w.shape[-1]))
        y = F.linear(x, w, bias(2))
        return _act(y.to(cdt), opt_b(0))

    if code in (OP["AVERAGE_POOL_2D"], OP["MAX_POOL_2D"]):
        x = get(op.inputs[0])
        stride = (opt_i(2, 1), opt_i(1, 1))
        window = (opt_i(4, 1), opt_i(3, 1))
        pads = _spatial_pads(x.permute(0, 3, 1, 2), window, stride, (1, 1),
                             opt_b(0) == _PAD_SAME)
        y = pool_nhwc(x, code == OP["MAX_POOL_2D"], window, stride, pads,
                      cache)
        return _act(y.to(cdt), opt_b(5))

    if code in (OP["ADD"], OP["MUL"], OP["SUB"], OP["DIV"],
                OP["MAXIMUM"], OP["MINIMUM"]):
        a, b = get(op.inputs[0]), get(op.inputs[1])
        f = {OP["ADD"]: torch.add, OP["MUL"]: torch.mul,
             OP["SUB"]: torch.sub, OP["DIV"]: torch.true_divide,
             OP["MAXIMUM"]: torch.maximum, OP["MINIMUM"]: torch.minimum}[code]
        act = opt_b(0) if code in (OP["ADD"], OP["MUL"], OP["SUB"],
                                   OP["DIV"]) else _ACT_NONE
        return _act(f(a, b), act)

    if code == OP["RESHAPE"]:
        x = get(op.inputs[0])
        if len(op.inputs) > 1:
            shape = [int(d) for d in static(op.inputs[1]).ravel()]
        else:
            v = r.field_vec_scalars(o, 0, np.int32) if o is not None \
                else None
            shape = [] if v is None else [int(d) for d in v]
        out_t = tensors[op.outputs[0]]
        batch = ctx.get("batch")
        if batch is not None and shape and out_t.shape and \
                shape[0] == out_t.shape[0] == ctx.get("orig_batch"):
            shape[0] = batch       # custom=batch=N: the lowered batch
        return x.reshape(shape)

    if code == OP["SQUEEZE"]:
        x = get(op.inputs[0])
        dims = r.field_vec_scalars(o, 0, np.int32) if o is not None else None
        if dims is None or len(dims) == 0:
            return x.squeeze()
        return x.squeeze(tuple(int(d) for d in dims))

    if code == OP["EXPAND_DIMS"]:
        x = get(op.inputs[0])
        axis = int(static(op.inputs[1]).ravel()[0])
        return x.unsqueeze(axis)

    if code == OP["SOFTMAX"]:
        x = get(op.inputs[0])
        beta = opt_f(0, 1.0)
        return torch.softmax(x.to(torch.float32) * beta, dim=-1).to(cdt)

    if code == OP["LOG_SOFTMAX"]:
        x = get(op.inputs[0])
        return torch.log_softmax(x.to(torch.float32), dim=-1).to(cdt)

    if code in (OP["MEAN"], OP["SUM"]):
        x = get(op.inputs[0])
        axes = _norm_axes((int(a) for a in static(op.inputs[1]).ravel()),
                          x.dim())
        if not axes:
            return x
        keep = bool(opt_b(0))
        if code == OP["MEAN"]:
            xf = x if x.is_floating_point() else x.to(torch.float32)
            return xf.mean(dim=axes, keepdim=keep)
        return x.sum(dim=axes, keepdim=keep, dtype=x.dtype)

    if code == OP["PAD"]:
        x = get(op.inputs[0])
        pads = static(op.inputs[1]).reshape(-1, 2)
        flat = [int(v) for a, b in pads[::-1] for v in (a, b)]
        return F.pad(x, flat)

    if code == OP["CONCATENATION"]:
        axis = opt_i(0, 0)
        return _act(torch.cat([get(i) for i in op.inputs], dim=axis),
                    opt_b(1))

    if code == OP["TRANSPOSE"]:
        x = get(op.inputs[0])
        perm = [int(p) for p in static(op.inputs[1]).ravel()]
        return x.permute(perm)

    if code in (OP["RESIZE_BILINEAR"], OP["RESIZE_NEAREST_NEIGHBOR"]):
        x = get(op.inputs[0])
        hw = static(op.inputs[1]).ravel()
        # ResizeBilinearOptions/ResizeNearestNeighborOptions:
        # align_corners(2 / 0), half_pixel_centers(3 / 1)
        if code == OP["RESIZE_BILINEAR"]:
            align, half_pixel = bool(opt_b(2)), bool(opt_b(3))
        else:
            align, half_pixel = bool(opt_b(0)), bool(opt_b(1))
        return _resize(x, int(hw[0]), int(hw[1]),
                       bilinear=code == OP["RESIZE_BILINEAR"],
                       align_corners=align, half_pixel=half_pixel,
                       cache=cache)

    if code == OP["LOGISTIC"]:
        return torch.sigmoid(get(op.inputs[0]))
    if code == OP["RELU"]:
        return torch.clamp(get(op.inputs[0]), min=0)
    if code == OP["RELU6"]:
        return torch.clamp(get(op.inputs[0]), 0, 6)
    if code == OP["TANH"]:
        return torch.tanh(get(op.inputs[0]))
    if code == OP["HARD_SWISH"]:
        x = get(op.inputs[0])
        return x * torch.clamp(x + 3.0, 0, 6) / 6.0
    if code == OP["LEAKY_RELU"]:
        x = get(op.inputs[0])
        return torch.where(x >= 0, x, x * opt_f(0, 0.01))
    if code == OP["ABS"]:
        return torch.abs(get(op.inputs[0]))

    if code in (OP["DEQUANTIZE"], OP["QUANTIZE"]):
        # activations already live in the float compute domain; quant
        # boundaries are handled at graph inputs/outputs
        return get(op.inputs[0])

    if code in (OP["ARG_MAX"], OP["ARG_MIN"]):
        x = get(op.inputs[0])
        axis = int(static(op.inputs[1]).ravel()[0])
        f = torch.argmax if code == OP["ARG_MAX"] else torch.argmin
        return f(x, dim=axis).to(out_dtype())

    if code == OP["SLICE"]:
        x = get(op.inputs[0])
        begin = [int(v) for v in static(op.inputs[1]).ravel()]
        size = [int(v) for v in static(op.inputs[2]).ravel()]
        size = [x.shape[i] - begin[i] if s == -1 else s
                for i, s in enumerate(size)]
        return x[tuple(slice(b, b + s) for b, s in zip(begin, size))]

    if code == OP["PACK"]:
        axis = opt_i(1, 0)
        return torch.stack([get(i) for i in op.inputs], dim=axis)

    if code == OP["STRIDED_SLICE"]:
        x = get(op.inputs[0])
        begin = [int(v) for v in static(op.inputs[1]).ravel()]
        end = [int(v) for v in static(op.inputs[2]).ravel()]
        strides = [int(v) for v in static(op.inputs[3]).ravel()]
        bm, em = opt_i(0, 0), opt_i(1, 0)
        ellipsis_m, new_axis_m = opt_i(2, 0), opt_i(3, 0)
        shrink_m = opt_i(4, 0)
        if ellipsis_m or new_axis_m:
            raise BackendError(
                "STRIDED_SLICE ellipsis/new-axis masks not supported")
        shrink_axes = []
        y = x
        for i in range(len(begin)):
            if shrink_m & (1 << i):
                b = begin[i]
                sl = slice(b, None if b == -1 else b + 1, 1)
                shrink_axes.append(i)
            else:
                b = None if bm & (1 << i) else begin[i]
                e = None if em & (1 << i) else end[i]
                sl = slice(b, e, strides[i])
            y = _strided_slice_dim(y, i, sl)
        if shrink_axes:
            y = y.squeeze(tuple(shrink_axes))
        return y

    if code == OP["GATHER"]:
        x = get(op.inputs[0])
        idx = get(op.inputs[1])
        axis = opt_i(0, 0) % x.dim()
        y = x.index_select(axis, idx.reshape(-1).to(torch.int64))
        return y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                         + tuple(x.shape[axis + 1:]))

    if code == OP["SPLIT"]:
        axis = int(static(op.inputs[0]).ravel()[0])
        x = get(op.inputs[1])
        n = opt_i(0, len(op.outputs)) or len(op.outputs)
        return tuple(torch.split(x, x.shape[axis] // n, dim=axis))

    if code in (OP["LESS"], OP["GREATER"], OP["GREATER_EQUAL"],
                OP["LESS_EQUAL"], OP["EQUAL"]):
        a, b = get(op.inputs[0]), get(op.inputs[1])
        f = {OP["LESS"]: torch.lt, OP["GREATER"]: torch.gt,
             OP["GREATER_EQUAL"]: torch.ge,
             OP["LESS_EQUAL"]: torch.le, OP["EQUAL"]: torch.eq}[code]
        return f(a, b)

    if code == OP["LOGICAL_AND"]:
        return torch.logical_and(get(op.inputs[0]), get(op.inputs[1]))

    if code == OP["BATCH_MATMUL"]:
        a, b = get(op.inputs[0]), get(op.inputs[1])
        if opt_b(0):                       # adj_x
            a = a.transpose(-1, -2)
        if opt_b(1):                       # adj_y
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    if code == OP["WHILE"]:
        # WhileOptions: cond_subgraph_index=0, body_subgraph_index=1.
        # The loop carry is the op's full input tuple (TFLite guarantees
        # matched shapes/dtypes between body inputs and outputs). The
        # condition is read on the host: one sync a step.
        run = ctx["run_sg"]
        cond_idx = opt_i(0, 0)
        body_idx = opt_i(1, 0)
        carry = tuple(get(i) for i in op.inputs)
        if carry and carry[0].is_cuda and \
                torch.cuda.is_current_stream_capturing():
            # refuse before the host read: a sync inside a capture would
            # invalidate it and leave the capture unfinished
            raise BackendError(
                f"WHILE in {graph.path!r} reads its condition on the host "
                f"each step; it cannot run inside a CUDA graph capture")
        while bool(run(cond_idx, carry)[0].reshape(()).item()):
            carry = tuple(run(body_idx, carry))
        return carry

    _UNARY = {
        OP["EXP"]: torch.exp, OP["LOG"]: torch.log, OP["SQRT"]: torch.sqrt,
        OP["RSQRT"]: lambda x: 1.0 / torch.sqrt(x), OP["NEG"]: torch.neg,
        OP["FLOOR"]: torch.floor, OP["CEIL"]: torch.ceil,
        OP["SIN"]: torch.sin, OP["COS"]: torch.cos, OP["ELU"]: F.elu,
    }
    if code in _UNARY:
        return _UNARY[code](get(op.inputs[0]))

    if code == OP["GELU"]:
        # GeluOptions: approximate (field 0)
        return F.gelu(get(op.inputs[0]),
                      approximate="tanh" if opt_b(0) else "none")

    if code == OP["POW"]:
        return torch.pow(get(op.inputs[0]), get(op.inputs[1]))

    if code == OP["SQUARED_DIFFERENCE"]:
        d_ = get(op.inputs[0]) - get(op.inputs[1])
        return d_ * d_

    if code == OP["CAST"]:
        return get(op.inputs[0]).to(out_dtype())

    if code in (OP["REDUCE_MAX"], OP["REDUCE_MIN"], OP["REDUCE_PROD"]):
        x = get(op.inputs[0])
        axes = _norm_axes((int(a) for a in static(op.inputs[1]).ravel()),
                          x.dim())
        if not axes:
            return x
        keep = bool(opt_b(0))
        if code == OP["REDUCE_MAX"]:
            return torch.amax(x, dim=axes, keepdim=keep)
        if code == OP["REDUCE_MIN"]:
            return torch.amin(x, dim=axes, keepdim=keep)
        for ax in sorted(axes, reverse=True):
            x = torch.prod(x, dim=ax, keepdim=keep, dtype=x.dtype)
        return x

    if code in (OP["SELECT"], OP["SELECT_V2"]):
        cond = get(op.inputs[0]).to(torch.bool)
        a, b2 = get(op.inputs[1]), get(op.inputs[2])
        # SELECT (v1): a rank-1 condition picks along the FIRST axis of
        # higher-rank operands (TFLite kernel semantics); SELECT_V2 is
        # plain numpy-style broadcasting
        if code == OP["SELECT"] and cond.dim() == 1 and a.dim() > 1:
            cond = cond.reshape((cond.shape[0],) + (1,) * (a.dim() - 1))
        return torch.where(cond, a, b2)

    if code == OP["TILE"]:
        reps = [int(v) for v in static(op.inputs[1]).ravel()]
        return torch.tile(get(op.inputs[0]), reps)

    if code == OP["UNPACK"]:
        # UnpackOptions: num (field 0), axis (field 1)
        x = get(op.inputs[0])
        axis = opt_i(1, 0)
        n = opt_i(0, 0) or x.shape[axis]
        parts = torch.split(x, x.shape[axis] // n, dim=axis)
        return tuple(pp.squeeze(axis) for pp in parts)

    if code == OP["MIRROR_PAD"]:
        x = get(op.inputs[0])
        pads = static(op.inputs[1]).reshape(-1, 2)
        return _mirror_pad(x, pads, symmetric=opt_i(0, 0) != 0, cache=cache)

    if code in (OP["DEPTH_TO_SPACE"], OP["SPACE_TO_DEPTH"]):
        x = get(op.inputs[0])
        bs = opt_i(0, 2)
        b, h, w, c = x.shape
        if code == OP["DEPTH_TO_SPACE"]:
            y = x.reshape(b, h, w, bs, bs, c // (bs * bs))
            y = y.permute(0, 1, 3, 2, 4, 5)
            return y.reshape(b, h * bs, w * bs, c // (bs * bs))
        y = x.reshape(b, h // bs, bs, w // bs, bs, c)
        y = y.permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, h // bs, w // bs, c * bs * bs)

    if code == OP["L2_NORMALIZATION"]:
        x = get(op.inputs[0]).to(torch.float32)
        denom = torch.sqrt(torch.clamp(
            torch.sum(x * x, dim=-1, keepdim=True), min=1e-12))
        return _act((x / denom).to(cdt), opt_b(0))

    if code == OP["TRANSPOSE_CONV"]:
        # inputs: output_shape (static), weights (O,H,W,I), activations.
        # TRANSPOSE_CONV is exactly the input-gradient of the forward
        # conv (output_shape → activations) that these weights define:
        # the full transposed conv, then the forward conv's SAME pads
        # cropped off (and zeros where no forward window reached).
        out_shape = [int(v) for v in static(op.inputs[0]).ravel()]
        w = get(op.inputs[1])
        x = get(op.inputs[2])
        # TransposeConvOptions: padding=0, stride_w=1, stride_h=2
        stride = (opt_i(2, 1), opt_i(1, 1))
        k = (w.shape[1], w.shape[2])
        # the forward conv's OIHW weight (O = x's channels) is the
        # transposed conv's (in, out, kh, kw) weight
        wt = w.permute(3, 0, 1, 2).to(torch.float32)
        full = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(torch.float32),
                                  wt, stride=stride)
        oh, ow = out_shape[1], out_shape[2]
        if opt_b(0) == _PAD_SAME:
            pt, pb = _same_pads(oh, k[0], stride[0])
            pl, pr = _same_pads(ow, k[1], stride[1])
        else:
            pt = pb = pl = pr = 0
        full = F.pad(full, (0, max(ow + pl + pr - full.shape[3], 0),
                            0, max(oh + pt + pb - full.shape[2], 0)))
        y = full[:, :, pt:pt + oh, pl:pl + ow].permute(0, 2, 3, 1).to(cdt)
        if len(op.inputs) > 3 and op.inputs[3] >= 0:
            y = y + get(op.inputs[3]).to(cdt)
        # TransposeConvOptions: fused_activation_function = field 3
        return _act(y, opt_b(3))

    raise BackendError(
        f"TFLite op {op.name} (builtin code {code}"
        + (f", custom {op.custom_name!r}" if op.custom_name else "")
        + f") in {graph.path!r} is not supported by the torch lowering; "
        f"supported: {sorted(OP)}")
