"""TF frozen-GraphDef ingestion → one torch function on the card.

The port of the JAX package's modelio/graphdef.py. The reference links
the TensorFlow C runtime and runs the graph in TF sessions
(`ext/nnstreamer/tensor_filter/tensor_filter_tensorflow.cc:801`, input
and output binding through `inputname=`/`outputname=`). Here the frozen
`.pb` is read with the dependency-free protobuf wire reader
(`protowire.py`); the parser (`NodeDef`, `_decode_tensor`,
`parse_graphdef`) and the numpy helpers (`decode_wav_bytes`,
`mel_filterbank`, `dct_matrix`) are copies. The lowering is rewritten in
torch: the nodes the outputs need are put in topological order once, at
load, each bound to its op's handler, and every frame runs them eagerly
as plain PyTorch calls (cuDNN convs, cuBLAS matmuls, cuFFT, elementwise
kernels) — the JAX package hands the same graph to XLA as one program.

Op vocabulary (JAX's): Const/Placeholder/Identity (StopGradient,
PreventGradient, Snapshot), MatMul, Conv2D, DepthwiseConv2dNative,
BiasAdd/Add/AddV2/Sub/Mul/RealDiv, Relu/Relu6/Softmax, MaxPool/AvgPool,
Reshape/Squeeze/ExpandDims/ConcatV2/Pad, Mean, ArgMax, Cast, DecodeWav,
AudioSpectrogram, Mfcc. Unsupported ops fail loudly, at load (the
output probe runs the graph on the ``meta`` device).

Layout: tensors keep TF's NHWC meaning. Convs and pools view NHWC as
NCHW with ``permute(0, 3, 1, 2)`` (channels-last, no copy), as the
TFLite lowering does (`tflite.conv_nhwc`, `pool_nhwc`): HWIO weights are
stored once as OIHW (channels-last), depthwise HW(C·m) as (C·m)1HW with
``groups=C``; SAME puts the odd pad pixel bottom/right (`_same_pads`);
AvgPool divides by the valid pixels of each window. A Conv2D or
depthwise conv whose only consumer is a BiasAdd (or Add) of a constant
1-D bias takes the bias into its F.conv2d call.

Static inputs (reshape targets, pad widths, reduce axes, concat axes)
are read from the graph's constants at load and stay host values.

DecodeWav runs **host-side** (`host_pre`): the RIFF header is decoded on
the host once a frame and the PCM samples enter the graph as float32;
its `sample_rate` output is the load-time constant `sample_rate` (the
Mfcc mel filterbank depends on it structurally), and `host_pre` refuses
a file of another rate. The front end follows the public TF kernels:
AudioSpectrogram (periodic Hann window, fft length the next power of two
of the window, whole windows only, `torch.fft.rfft`) and Mfcc
(triangular mel filterbank over the magnitude, floor 1e-12, natural log,
DCT-II scaled sqrt(2/N)).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import protowire as pw
from nnstreamer_tpu_torch.modelio.tflite import (
    LoweredModel, _dev_const, _same_pads, conv_nhwc, pool_nhwc,
    probe_outputs, torch_dtype)

# -- proto field numbers (public tensorflow .proto schemas) ----------------
# GraphDef
_GD_NODE = 1
# NodeDef
_ND_NAME, _ND_OP, _ND_INPUT, _ND_DEVICE, _ND_ATTR = 1, 2, 3, 4, 5
# map<string, AttrValue> entry
_MAP_KEY, _MAP_VALUE = 1, 2
# AttrValue (oneof)
_AV_LIST, _AV_S, _AV_I, _AV_F, _AV_B = 1, 2, 3, 4, 5
_AV_TYPE, _AV_SHAPE, _AV_TENSOR = 6, 7, 8
# TensorProto
_TP_DTYPE, _TP_SHAPE, _TP_CONTENT = 1, 2, 4
_TP_FLOAT, _TP_DOUBLE, _TP_INT, _TP_STRING, _TP_INT64 = 5, 6, 7, 8, 10
_TP_BOOL = 11
# TensorShapeProto / Dim
_TS_DIM, _DIM_SIZE = 2, 1

#: TF DataType enum → numpy
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.bytes_, 9: np.int64, 10: np.bool_, 14: np.uint16,
    17: np.uint16, 22: np.uint32, 23: np.uint64,
}


@dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, Dict[int, List[Any]]]   # attr name → AttrValue fields

    def attr_i(self, key: str, default: int = 0) -> int:
        a = self.attrs.get(key)
        return pw.to_signed64(pw.first(a, _AV_I, default)) if a else default

    def attr_f(self, key: str, default: float = 0.0) -> float:
        a = self.attrs.get(key)
        if not a or _AV_F not in a:
            return default
        return pw.fixed32_to_float(a[_AV_F][0])

    def attr_b(self, key: str, default: bool = False) -> bool:
        a = self.attrs.get(key)
        return bool(pw.first(a, _AV_B, default)) if a else default

    def attr_s(self, key: str, default: str = "") -> str:
        a = self.attrs.get(key)
        v = pw.first(a, _AV_S) if a else None
        return v.decode() if isinstance(v, bytes) else default

    def attr_ints(self, key: str) -> List[int]:
        a = self.attrs.get(key)
        if not a or _AV_LIST not in a:
            return []
        lst = pw.fields_dict(a[_AV_LIST][0])
        out: List[int] = []
        for v in lst.get(_AV_I, []):
            if isinstance(v, bytes):          # packed encoding
                out.extend(pw.to_signed64(x) for x in pw.packed_varints(v))
            else:
                out.append(pw.to_signed64(v))
        return out

    def attr_type(self, key: str, default: int = 0) -> int:
        a = self.attrs.get(key)
        return pw.first(a, _AV_TYPE, default) if a else default

    def attr_tensor(self, key: str) -> Optional[np.ndarray]:
        a = self.attrs.get(key)
        if not a or _AV_TENSOR not in a:
            return None
        return _decode_tensor(pw.fields_dict(a[_AV_TENSOR][0]))

    def attr_shape(self, key: str) -> Optional[Tuple[int, ...]]:
        a = self.attrs.get(key)
        if not a or _AV_SHAPE not in a:
            return None
        sh = pw.fields_dict(a[_AV_SHAPE][0])
        dims = []
        for d in sh.get(_TS_DIM, []):
            dd = pw.fields_dict(d)
            dims.append(pw.to_signed64(pw.first(dd, _DIM_SIZE, -1)))
        return tuple(dims)


def _decode_tensor(tp: Dict[int, List[Any]]) -> np.ndarray:
    """TensorProto → numpy array."""
    dt_enum = pw.first(tp, _TP_DTYPE, 1)
    dtype = _DTYPES.get(dt_enum)
    if dtype is None:
        raise BackendError(f"TensorProto dtype enum {dt_enum} unsupported")
    shape: Tuple[int, ...] = ()
    if _TP_SHAPE in tp:
        sh = pw.fields_dict(tp[_TP_SHAPE][0])
        shape = tuple(
            pw.to_signed64(pw.first(pw.fields_dict(d), _DIM_SIZE, -1))
            for d in sh.get(_TS_DIM, []))
    content = pw.first(tp, _TP_CONTENT)
    if content:
        arr = np.frombuffer(content, dtype=np.dtype(dtype))
        return arr.reshape(shape) if shape else arr
    # typed repeated fields (possibly a single splat value)
    if dt_enum == 1 and _TP_FLOAT in tp:          # packed or repeated f32
        vals = tp[_TP_FLOAT]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            arr = np.frombuffer(vals[0], np.float32)
        else:
            arr = np.array([pw.fixed32_to_float(v) if isinstance(v, int)
                            else np.frombuffer(v, np.float32)[0]
                            for v in vals], np.float32)
    elif dt_enum == 3 and _TP_INT in tp:
        vals = tp[_TP_INT]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            arr = np.array([pw.to_signed64(v)
                            for v in pw.packed_varints(vals[0])], np.int64)
        else:
            arr = np.array([pw.to_signed64(v) for v in vals], np.int64)
        arr = arr.astype(np.int32)
    elif dt_enum == 9 and _TP_INT64 in tp:
        vals = tp[_TP_INT64]
        if len(vals) == 1 and isinstance(vals[0], bytes):
            arr = np.array([pw.to_signed64(v)
                            for v in pw.packed_varints(vals[0])], np.int64)
        else:
            arr = np.array([pw.to_signed64(v) for v in vals], np.int64)
    else:
        raise BackendError(
            f"TensorProto with dtype enum {dt_enum} has no decodable "
            f"payload (fields {sorted(tp)})")
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:
        arr = np.full(shape, arr[0])              # splat-value encoding
    return arr.reshape(shape) if shape else arr


def parse_graphdef(path: str) -> List[NodeDef]:
    with open(path, "rb") as f:
        buf = f.read()
    try:
        gd = pw.fields_dict(buf)
        raw_nodes = gd.get(_GD_NODE, [])
        if not raw_nodes:
            raise ValueError("no NodeDef entries")
        nodes = []
        for nb in raw_nodes:
            nd = pw.fields_dict(nb)
            attrs: Dict[str, Dict[int, List[Any]]] = {}
            for entry in nd.get(_ND_ATTR, []):
                e = pw.fields_dict(entry)
                key = pw.first(e, _MAP_KEY, b"").decode()
                val = pw.first(e, _MAP_VALUE, b"")
                attrs[key] = pw.fields_dict(val)
            nodes.append(NodeDef(
                name=pw.first(nd, _ND_NAME, b"").decode(),
                op=pw.first(nd, _ND_OP, b"").decode(),
                inputs=[v.decode() for v in nd.get(_ND_INPUT, [])],
                attrs=attrs))
        return nodes
    except (ValueError, IndexError, struct.error,
            UnicodeDecodeError) as e:
        raise BackendError(
            f"{path!r} is not a frozen TF GraphDef: {e}") from None


# -- host-side WAV decode (DecodeWav) --------------------------------------

def decode_wav_bytes(data: bytes, desired_samples: int = -1,
                     desired_channels: int = -1
                     ) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE PCM16 → (float32 [samples, channels] in [-1,1], rate).

    Host-side twin of TF's DecodeWav kernel: walks the chunk list, reads
    `fmt ` and `data`, pads/truncates to desired_samples like the TF op.
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise BackendError("DecodeWav: input is not a RIFF/WAVE stream")
    pos = 12
    rate = None
    channels = None
    bits = None
    raw_data = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (clen,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if cid == b"fmt ":
            fmt, channels, rate = struct.unpack_from("<HHI", data, body)
            bits = struct.unpack_from("<H", data, body + 14)[0]
            if fmt != 1 or bits != 16:
                raise BackendError(
                    f"DecodeWav supports PCM16 only (fmt={fmt}, "
                    f"bits={bits})")
        elif cid == b"data":
            raw_data = data[body:body + clen]
        pos = body + clen + (clen & 1)
    # Decode only after the walk: a `data` chunk may precede `fmt `, so
    # channels/rate are validated here, not where the chunk was seen.
    if rate is None or not channels or raw_data is None:
        raise BackendError("DecodeWav: missing fmt/data chunk")
    samples = np.frombuffer(
        raw_data[:len(raw_data) - (len(raw_data) % 2)], "<i2")
    x = (samples.astype(np.float32) / 32768.0).reshape(-1, channels)
    if desired_channels > 0 and x.shape[1] != desired_channels:
        if x.shape[1] > desired_channels:
            x = x[:, :desired_channels]
        else:  # TF kernel: duplicate the last channel up to the target
            pad = np.repeat(x[:, -1:], desired_channels - x.shape[1],
                            axis=1)
            x = np.concatenate([x, pad], axis=1)
    if desired_samples > 0:
        if x.shape[0] >= desired_samples:
            x = x[:desired_samples]
        else:
            x = np.pad(x, ((0, desired_samples - x.shape[0]), (0, 0)))
    return x, int(rate)


# -- audio front end (torch twins of the TF kernels) -----------------------

def _next_pow2(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


def audio_spectrogram(audio: torch.Tensor, window_size: int, stride: int,
                      magnitude_squared: bool, cache=None) -> torch.Tensor:
    """(samples, channels) → (channels, frames, fft//2+1) — TF
    spectrogram.cc semantics (periodic Hann, next-pow-2 FFT, full
    windows only). `cache`: where the window tensor is kept per device."""
    fft_len = _next_pow2(window_size)
    x = audio.t()
    if audio.shape[0] >= window_size:
        x = x.unfold(-1, window_size, stride)      # (ch, frames, win)
    else:
        x = x.new_zeros((x.shape[0], 0, window_size))
    window = _dev_const(
        {} if cache is None else cache, ("hann", window_size), x.device,
        lambda: 0.5 - 0.5 * np.cos(
            2.0 * np.pi * np.arange(window_size) / window_size), x.dtype)
    spec = torch.fft.rfft(x * window, n=fft_len, dim=-1)
    mag2 = spec.real ** 2 + spec.imag ** 2
    return mag2 if magnitude_squared else torch.sqrt(mag2)


def mel_filterbank(n_bins: int, sample_rate: int, channels: int,
                   lower_hz: float, upper_hz: float) -> np.ndarray:
    """(n_bins, channels) weights — exact TF mfcc_mel_filterbank.cc
    scheme: band mapper per FFT bin, weight w to its band and (1−w) to
    the next, bins outside [start_index, end_index] dropped. The matrix
    is applied to sqrt(spectrogram) (the kernel's `spec_val`).
    mel(f) = 1127·ln(1+f/700)."""
    def mel(f):
        return 1127.0 * math.log1p(f / 700.0)

    hz_per_sbin = 0.5 * sample_rate / (n_bins - 1)
    start_index = int(1.5 + lower_hz / hz_per_sbin)
    end_index = int(upper_hz / hz_per_sbin)
    mel_low = mel(lower_hz)
    mel_hi = mel(upper_hz)
    spacing = (mel_hi - mel_low) / (channels + 1)
    # center_frequencies_[i] = mel_low + spacing·(i+1), i = 0..channels
    centers = mel_low + spacing * (np.arange(channels + 1) + 1.0)

    w = np.zeros((n_bins, channels), np.float64)
    for i in range(start_index, min(end_index + 1, n_bins)):
        melf = mel(i * hz_per_sbin)
        if melf < mel_low or melf > mel_hi:
            continue
        band = int(np.searchsorted(centers, melf, side="left")) - 1
        if band >= 0:
            weight = (centers[band + 1] - melf) / \
                (centers[band + 1] - centers[band])
        else:
            weight = (centers[0] - melf) / (centers[0] - mel_low)
        if band >= 0:
            w[i, band] += weight
        if band + 1 < channels:
            w[i, band + 1] += 1.0 - weight
    return w.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) DCT-II weights — TF mfcc_dct.cc scaling."""
    fnorm = math.sqrt(2.0 / n_in)
    arg = math.pi / n_in
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    return (fnorm * np.cos(k * arg * (n + 0.5))).astype(np.float32)


def mfcc(spectrogram: torch.Tensor, sample_rate: int, *, upper_hz: float,
         lower_hz: float, fb_channels: int, dct_count: int,
         cache=None) -> torch.Tensor:
    """(channels, frames, bins) → (channels, frames, dct_count)."""
    n_bins = spectrogram.shape[-1]
    cache = {} if cache is None else cache
    dev, dt = spectrogram.device, spectrogram.dtype
    fb = _dev_const(cache, ("melfb", n_bins, sample_rate, fb_channels,
                            lower_hz, upper_hz), dev,
                    lambda: mel_filterbank(n_bins, sample_rate, fb_channels,
                                           lower_hz, upper_hz), dt)
    dct = _dev_const(cache, ("dct", fb_channels, dct_count), dev,
                     lambda: dct_matrix(fb_channels, dct_count), dt)
    # TF's filterbank consumes magnitude (sqrt of the squared spec)
    energy = torch.sqrt(spectrogram) @ fb
    logfb = torch.log(torch.clamp(energy, min=1e-12))
    return logfb @ dct


# -- lowering ---------------------------------------------------------------

def _ref_name(ref: str) -> Tuple[str, int]:
    """'node:2' → ('node', 2); control deps '^node' handled by caller."""
    if ":" in ref:
        name, _, idx = ref.rpartition(":")
        return name, int(idx)
    return ref, 0


def _data_inputs(n: NodeDef) -> List[str]:
    return [i for i in n.inputs if not i.startswith("^")]


#: input slots read as compile-time constants, by op (the rest are
#: tensors); ConcatV2's axis is its last input
_STATIC_SLOTS = {"Reshape": (1,), "ExpandDims": (1,), "Pad": (1,),
                 "Mean": (1,), "ArgMax": (1,), "Mfcc": (1,)}


def _tensor_inputs(n: NodeDef) -> List[Tuple[int, str]]:
    """(slot, ref) of the inputs a node reads as tensors at run time."""
    ins = _data_inputs(n)
    static = (len(ins) - 1,) if n.op == "ConcatV2" \
        else _STATIC_SLOTS.get(n.op, ())
    return [(k, ref) for k, ref in enumerate(ins) if k not in static]
#: ops whose output is their first input (no work)
_PASS_OPS = ("Identity", "StopGradient", "PreventGradient", "Snapshot")
_CONV_OPS = ("Conv2D", "DepthwiseConv2dNative")


def lower_graphdef(nodes: Sequence[NodeDef],
                   input_names: Optional[List[str]] = None,
                   output_names: Optional[List[str]] = None,
                   batch: Optional[int] = None,
                   sample_rate: int = 16000) -> LoweredModel:
    """Lower parsed NodeDefs to a torch fn (+ host_pre for DecodeWav).

    input_names / output_names: the graph nodes bound as the model's
    inputs and outputs (default: every Placeholder; every node no other
    node reads). batch: replaces an unknown (-1) leading placeholder dim.
    """
    by_name = {n.name: n for n in nodes}
    consumed = {pn for n in nodes for pn in
                (_ref_name(i)[0] for i in _data_inputs(n))}

    placeholders = [n for n in nodes if n.op == "Placeholder"]
    if input_names is None:
        input_names = [n.name for n in placeholders]
    if output_names is None:
        output_names = [n.name for n in nodes
                        if n.name not in consumed and n.op not in
                        ("Const", "Placeholder")] or [nodes[-1].name]

    consts: Dict[str, np.ndarray] = {}
    for n in nodes:
        if n.op == "Const":
            t = n.attr_tensor("value")
            if t is None:
                raise BackendError(f"Const node {n.name!r} has no tensor")
            consts[n.name] = t

    def const_of(ref: str) -> Optional[str]:
        """The Const node behind `ref` (through Identity chains)."""
        nm = _ref_name(ref)[0]
        while nm in by_name and by_name[nm].op in _PASS_OPS:
            nm = _ref_name(_data_inputs(by_name[nm])[0])[0]
        return nm if nm in consts else None

    def static(ref: str) -> np.ndarray:
        nm = const_of(ref)
        if nm is None:
            raise BackendError(
                f"node {ref!r} must be a compile-time constant")
        return consts[nm]

    # DecodeWav host stage: the graph input becomes the decoded samples
    wav_nodes = [n for n in nodes if n.op == "DecodeWav"]
    host_pre: Optional[Callable] = None
    wav_entry: Optional[str] = None
    want_s = want_c = 0
    if wav_nodes:
        if len(wav_nodes) > 1:
            raise BackendError("multiple DecodeWav nodes unsupported")
        wn = wav_nodes[0]
        src = _ref_name(wn.inputs[0])[0]
        if input_names != [src]:
            raise BackendError(
                f"DecodeWav input {src!r} must be the graph input "
                f"(inputs: {input_names})")
        wav_entry = wn.name
        want_s = wn.attr_i("desired_samples", -1)
        want_c = wn.attr_i("desired_channels", -1)
        if want_s <= 0:
            raise BackendError(
                f"DecodeWav node {wn.name!r} has no desired_samples "
                f"attr; the lowering needs a static sample count "
                f"(re-export the graph with desired_samples set)")
        if want_c <= 0:
            want_c = 1

        def host_pre(tensors):
            from nnstreamer_tpu_torch.runtime.sync import to_host

            raw = to_host((tensors[0],))[0]
            audio, rate = decode_wav_bytes(np.asarray(raw).tobytes(),
                                           want_s, want_c)
            if rate != sample_rate:
                raise BackendError(
                    f"wav sample rate {rate} != model rate "
                    f"{sample_rate} (set custom=sample_rate=)")
            return (audio,) + tuple(tensors[1:])

    def placeholder_shape(n: NodeDef) -> Tuple[int, ...]:
        sh = n.attr_shape("shape") or ()
        sh = tuple(batch if (d == -1 and i == 0 and batch) else d
                   for i, d in enumerate(sh))
        return tuple(1 if d == -1 else d for d in sh)

    in_shapes: List[Tuple[int, ...]] = []
    in_dtypes: List[np.dtype] = []
    if wav_entry is not None:
        in_shapes.append((max(want_s, 1), want_c))
        in_dtypes.append(np.dtype(np.float32))
    else:
        for nm in input_names:
            n = by_name.get(nm)
            if n is None:
                raise BackendError(f"input node {nm!r} not in graph")
            in_shapes.append(placeholder_shape(n))
            in_dtypes.append(np.dtype(
                _DTYPES.get(n.attr_type("dtype", 1), np.float32)))

    # the nodes the outputs need, inputs first (an iterative DFS: deep
    # graphs would exhaust Python's recursion limit)
    bound = {wav_entry} if wav_entry is not None else set(input_names)
    order: List[NodeDef] = []
    state: Dict[str, int] = {}
    for out in output_names:
        stack = [(_ref_name(out)[0], False)]
        while stack:
            nm, done = stack.pop()
            if done:
                state[nm] = 2
                order.append(by_name[nm])
                continue
            if state.get(nm) or nm in bound or const_of(nm) is not None:
                continue
            node = by_name.get(nm)
            if node is None:
                raise BackendError(f"undefined graph node {nm!r}")
            state[nm] = 1
            stack.append((nm, True))
            for _, ref in _tensor_inputs(node):
                dep = _ref_name(ref)[0]
                if state.get(dep) == 1:
                    raise BackendError(f"graph cycle through node {dep!r}")
                stack.append((dep, False))

    # a conv read only by a BiasAdd/Add of a constant 1-D bias takes it
    readers: Dict[str, List[NodeDef]] = {}
    for n in order:
        for ref in _data_inputs(n):
            readers.setdefault(_ref_name(ref)[0], []).append(n)
    outs = {_ref_name(o)[0] for o in output_names}
    fused_bias: Dict[str, str] = {}       # conv node → bias const
    passthrough: Dict[str, str] = {}      # bias node → conv node
    for n in order:
        if n.op not in ("BiasAdd", "Add", "AddV2"):
            continue
        ins = _data_inputs(n)
        conv, idx = _ref_name(ins[0])
        b = const_of(ins[1]) if len(ins) == 2 else None
        cn = by_name.get(conv)
        if (cn is None or cn.op not in _CONV_OPS or idx or conv in outs
                or len(readers.get(conv, ())) != 1 or b is None
                or consts[b].ndim != 1 or conv in fused_bias
                or n.attr_s("data_format", "NHWC") != "NHWC"):
            continue
        fused_bias[conv] = b
        passthrough[n.name] = conv

    # constants read at run time are params (on the device once);
    # constant conv weights are stored once in the layout F.conv2d reads
    params: Dict[str, Any] = {}
    for n in order:
        if n.name in passthrough:
            continue
        for k, ref in _tensor_inputs(n):
            nm = const_of(ref)
            if nm is None:
                continue
            t = torch.from_numpy(np.array(consts[nm]))
            if n.op == "Conv2D" and k == 1:          # HWIO → OIHW
                params[nm + "/oihw"] = t.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            elif n.op == "DepthwiseConv2dNative" and k == 1:
                kh, kw = t.shape[:2]                 # HW(C·m) → (C·m)1HW
                params[nm + "/dw"] = t.reshape(kh, kw, 1, -1) \
                    .permute(3, 2, 0, 1).contiguous()
            else:
                params[nm] = t
        if n.name in fused_bias:
            params[fused_bias[n.name]] = torch.from_numpy(
                np.array(consts[fused_bias[n.name]]))

    cache: Dict[tuple, torch.Tensor] = {}
    steps = [(n.name, _handler(n, static, const_of, fused_bias,
                               sample_rate, cache, input_names))
             for n in order if n.name not in passthrough]
    results = [(passthrough.get(_ref_name(o)[0], _ref_name(o)[0]),
                _ref_name(o if ":" in o else o + ":0")[1])
               for o in output_names]
    rate_key = (wav_entry, 1)

    def fn(p, *inputs):
        if len(inputs) != len(input_names):
            raise BackendError(
                f"graph expects {len(input_names)} inputs "
                f"({input_names}), got {len(inputs)}")
        vals: Dict[Tuple[str, int], Any] = {}
        if wav_entry is not None:
            # host_pre replaced the wav bytes with decoded samples
            x = inputs[0]
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            vals[(wav_entry, 0)] = x.to(torch.float32)
        else:
            for nm, x in zip(input_names, inputs):
                vals[(nm, 0)] = x if isinstance(x, torch.Tensor) \
                    else torch.as_tensor(np.asarray(x))

        def get(ref: str):
            nm, idx = _ref_name(ref)
            nm = passthrough.get(nm, nm)
            v = vals.get((nm, idx))
            if v is not None:
                return v
            c = const_of(nm)
            if c is not None and c in p:
                return p[c]
            if (nm, idx) == rate_key:
                dev = next(iter(vals.values())).device
                return _dev_const(cache, ("rate", sample_rate), dev,
                                  lambda: np.asarray(sample_rate, np.int32))
            raise BackendError(f"graph node {ref!r} has no value")

        for name, step in steps:
            out = step(get, p)
            if isinstance(out, tuple):
                for i, o in enumerate(out):
                    vals[(name, i)] = o
            else:
                vals[(name, 0)] = out
        return tuple(get(f"{nm}:{idx}") for nm, idx in results)

    out_shapes, out_dtypes = probe_outputs(fn, params, in_shapes, in_dtypes)
    return LoweredModel(
        fn=fn, params=params,
        in_shapes=in_shapes, in_dtypes=in_dtypes,
        out_shapes=out_shapes, out_dtypes=out_dtypes,
        name="", host_pre=host_pre)


def _handler(n: NodeDef, static, const_of, fused_bias, sample_rate: int,
             cache, input_names) -> Callable:
    """The torch step of one node: step(get, params) → output (a tuple
    for multi-output ops). Static inputs and attrs are read here, once."""
    op = n.op
    ins = _data_inputs(n)

    def need_nhwc():
        fmt = n.attr_s("data_format", "NHWC")
        if fmt != "NHWC":
            raise BackendError(
                f"{op} ({n.name!r}): only NHWC supported, got {fmt}")

    if op in _PASS_OPS:
        return lambda get, p: get(ins[0])
    if op == "Placeholder":
        raise BackendError(
            f"Placeholder {n.name!r} is not bound as a graph input "
            f"(inputs: {input_names})")
    if op == "MatMul":
        ta, tb = n.attr_b("transpose_a"), n.attr_b("transpose_b")

        def matmul(get, p):
            a, b = get(ins[0]), get(ins[1])
            return (a.t() if ta else a) @ (b.t() if tb else b)
        return matmul
    if op in ("Add", "AddV2", "BiasAdd", "Sub", "Mul", "RealDiv"):
        if op == "BiasAdd" and n.attr_s("data_format", "NHWC") != "NHWC":
            raise BackendError(f"BiasAdd ({n.name!r}): only NHWC supported")
        f = {"Sub": torch.sub, "Mul": torch.mul,
             "RealDiv": torch.true_divide}.get(op, torch.add)
        return lambda get, p: f(get(ins[0]), get(ins[1]))
    if op == "Relu":
        return lambda get, p: torch.clamp(get(ins[0]), min=0)
    if op == "Relu6":
        return lambda get, p: torch.clamp(get(ins[0]), 0, 6)
    if op == "Softmax":
        return lambda get, p: torch.softmax(get(ins[0]), dim=-1)
    if op == "Reshape":
        shape = [int(d) for d in np.asarray(static(ins[1])).ravel()]
        return lambda get, p: get(ins[0]).reshape(shape)
    if op == "Squeeze":
        dims = tuple(n.attr_ints("squeeze_dims"))
        if dims:
            return lambda get, p: get(ins[0]).squeeze(dims)
        return lambda get, p: get(ins[0]).squeeze()
    if op == "ExpandDims":
        axis = int(np.asarray(static(ins[1])).ravel()[0])
        return lambda get, p: get(ins[0]).unsqueeze(axis)
    if op == "ConcatV2":
        axis = int(np.asarray(static(ins[-1])).ravel()[0])
        return lambda get, p: torch.cat([get(i) for i in ins[:-1]], dim=axis)
    if op == "Pad":
        pads = np.asarray(static(ins[1])).reshape(-1, 2)
        flat = [int(v) for a, b in pads[::-1] for v in (a, b)]
        return lambda get, p: F.pad(get(ins[0]), flat)
    if op == "Mean":
        axes = tuple(int(a) for a in np.asarray(static(ins[1])).ravel())
        keep = n.attr_b("keep_dims")
        return lambda get, p: get(ins[0]).mean(dim=axes, keepdim=keep)
    if op == "ArgMax":
        axis = int(np.asarray(static(ins[1])).ravel()[0])
        return lambda get, p: torch.argmax(get(ins[0]), dim=axis)
    if op == "Cast":
        dt = torch_dtype(_DTYPES[n.attr_type("DstT", 1)])
        return lambda get, p: get(ins[0]).to(dt)
    if op in _CONV_OPS:
        need_nhwc()
        st = n.attr_ints("strides") or [1, 1, 1, 1]
        dil = n.attr_ints("dilations") or [1, 1, 1, 1]
        stride, dil = tuple(st[1:3]), tuple(dil[1:3])
        same = n.attr_s("padding", "VALID") == "SAME"
        dw = op == "DepthwiseConv2dNative"
        wname = const_of(ins[1])
        bname = fused_bias.get(n.name)
        wkey = None if wname is None else wname + ("/dw" if dw else "/oihw")

        def conv(get, p):
            x = get(ins[0])
            if wkey is not None:
                w = p[wkey]
            else:                                   # a computed weight
                w = get(ins[1])
                w = (w.reshape(w.shape[0], w.shape[1], 1, -1)
                     .permute(3, 2, 0, 1) if dw else w.permute(3, 2, 0, 1))
            b = p[bname] if bname is not None else None
            k = w.shape[2:]
            pads = (0, 0, 0, 0)
            if same:
                pads = (_same_pads(x.shape[1], k[0], stride[0], dil[0])
                        + _same_pads(x.shape[2], k[1], stride[1], dil[1]))
            return conv_nhwc(x, w, b, stride, dil, pads,
                             x.shape[-1] if dw else 1)
        return conv
    if op in ("MaxPool", "AvgPool"):
        need_nhwc()
        ks = n.attr_ints("ksize") or [1, 1, 1, 1]
        st = n.attr_ints("strides") or [1, 1, 1, 1]
        window, stride = tuple(ks[1:3]), tuple(st[1:3])
        if ks[0] != 1 or ks[3] != 1 or st[0] != 1 or st[3] != 1:
            raise BackendError(
                f"{op} ({n.name!r}): windows over batch or channels "
                f"(ksize {ks}, strides {st}) are not supported")
        same = n.attr_s("padding", "VALID") == "SAME"
        is_max = op == "MaxPool"

        def pool(get, p):
            x = get(ins[0])
            pads = (0, 0, 0, 0)
            if same:
                pads = (_same_pads(x.shape[1], window[0], stride[0])
                        + _same_pads(x.shape[2], window[1], stride[1]))
            y = pool_nhwc(x, is_max, window, stride, pads, cache)
            return y.to(x.dtype)
        return pool
    if op == "AudioSpectrogram":
        win, hop = n.attr_i("window_size"), n.attr_i("stride")
        sq = n.attr_b("magnitude_squared")
        return lambda get, p: audio_spectrogram(get(ins[0]), win, hop, sq,
                                                cache)
    if op == "Mfcc":
        # the mel filterbank is structural: the rate must be static.
        # Prefer the graph's own rate constant; DecodeWav-fed graphs
        # fall back to the loader's sample_rate (host_pre verifies the
        # wav header against it).
        rate = sample_rate
        try:
            rate = int(np.asarray(static(ins[1])).ravel()[0])
        except BackendError:
            pass
        kw = dict(upper_hz=n.attr_f("upper_frequency_limit", 4000.0),
                  lower_hz=n.attr_f("lower_frequency_limit", 20.0),
                  fb_channels=n.attr_i("filterbank_channel_count", 40),
                  dct_count=n.attr_i("dct_coefficient_count", 13))
        return lambda get, p: mfcc(get(ins[0]), rate, cache=cache, **kw)
    if op == "DecodeWav":
        raise BackendError(
            "DecodeWav must be the graph entry (host-side decode)")
    raise BackendError(
        f"GraphDef op {op!r} (node {n.name!r}) is not supported by "
        f"the torch lowering")
