#!/usr/bin/env python3
"""Writes TF GraphDef, Caffe, Caffe2, UFF, DLC, RTM and TorchScript model
files and PCM16 WAV files for tests and on-card checks (fixture tooling,
not a feature of the system: nothing registers it with the pipeline and
the package does not export it).

The machine with the card has no tensorflow, caffe, TensorRT, SNPE or
DeepViewRT, and the repository holds no model file, so the loaders'
checks need files this module makes itself, from seeded numpy (or the
port's zoo model) parameters:

- a protobuf wire encoder (`_key`, `_varint`, `_len`, ...) and
  `GraphDefWriter` (NodeDef/AttrValue/TensorProto of the public
  tensorflow .proto schemas); `write_graphdef_mobilenet_v2` — config 1's
  MobileNetV2 with BN folded, from `tflite_fixture.mobilenet_v2_ops`, in
  Conv2D / DepthwiseConv2dNative / BiasAdd / Relu6 / AddV2 / Mean /
  MatMul; `write_speech_commands` — TF's speech-commands `conv` model
  (`tensorflow/examples/speech_commands/models.py`, `create_conv_model`,
  the reference's `conv_actions_frozen.pb`): DecodeWav →
  AudioSpectrogram (window 480, stride 160) → Mfcc (40) → conv 20×8 →
  ReLU → max-pool 2×2 → conv 10×4 → ReLU → FC to 12 labels → Softmax;
- `caffe_layer` / `caffe_net` (NetParameter, caffe.proto) and
  `write_caffe_lenet` — Caffe's `examples/mnist/lenet.prototxt` (the
  reference's `lenet_iter_9000.caffemodel`) with an Input layer;
- `caffe2_op` / `caffe2_net` (NetDef, caffe2.proto) and
  `write_caffe2_resnet` — a CIFAR-10 ResNet (He et al. 2016, §4.2; 6n+2
  layers, widths 16/32/64, 1×1 projection shortcuts) in the reference
  pair's op set, as an init_net / predict_net pair;
- `uff_node` / `uff_metagraph` and `write_uff_lenet` — LeNet-5 at the
  Caffe model's widths in UFF's op set (Input "in", Conv, Binary, Pool,
  Flatten, FullyConnected, Activation, MarkOutput of "out");
- `write_dlc_add2` — the reference's `add2_float.dlc` /
  `add2_uint8.dlc` (y = x + 2): a zip of NETD / NETP flatbuffers behind
  the container prefix, on `tflite_fixture.Builder`;
- `write_rtm_mobilenet_v1` — MobileNetV1 (0.25, 224², 1001 classes,
  the reference's `mobilenet_v1_0.25_224.rtm`) as an RTMx flatbuffer:
  28 convs (depthwise with groups = C and HWCM weights), average pool,
  reshape, softmax;
- `wav_bytes` — a PCM16 RIFF/WAVE file;
- TorchScript (torch's own writer for the modern archive format):
  `write_torchscript_mbv2` — the zoo's MobileNetV2 module (NHWC in, NCHW
  inside, as the reference's LeNet-5 takes NHWC frames) saved with
  `torch.jit.trace`; `write_torchscript_encoder` — an
  `nn.TransformerEncoder` (batch first) saved with `torch.jit.script`;
  `write_torchscript_nn` — the recurrent and attention archives
  (`TORCHSCRIPT_NN`: LSTM, GRU, an SDPA block, MultiheadAttention, a
  TransformerDecoder) with their seeded inputs;
  `write_legacy_lenet5` — a producerVersion-1.0 archive (`model.json`,
  `code/lenet5.py`, `tensors/N`), the layout of the reference's
  `pytorch_lenet5.pt`, which current torch no longer writes or loads:
  LeNet-5 at lenet.prototxt's widths, uint8 NHWC (1, 28, 28, 1) in, a
  uint8 softmax (1, 10) out.

    python3 nnstreamer_tpu_torch/tools/model_fixtures.py OUT_DIR \\
        [--width 1.0] [--size 224] [--filters 64] [--seed 0] \\
        [--d-model 1024] [--layers 4]

writes every model above into OUT_DIR (mbv2.pb and mbv2.pt from
``zoo://mobilenet_v2`` built with that seed and width, at that input
size; enc.pt with d_model, 8 heads, a 4·d_model FFN and that many layers)
and one second of seeded audio, speech.wav.
"""

from __future__ import annotations

import json
import struct
import sys
import zipfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# -- protobuf wire encoder ----------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # negative ints: two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _len(field: int, data) -> bytes:
    data = data.encode() if isinstance(data, str) else bytes(data)
    return _key(field, 2) + _varint(len(data)) + data


def _f32(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _packed(field: int, ints: Iterable[int]) -> bytes:
    return _len(field, b"".join(_varint(int(v)) for v in ints))


def _packed_f32(field: int, arr) -> bytes:
    return _len(field, np.ascontiguousarray(arr, "<f4").tobytes())


# -- TF GraphDef --------------------------------------------------------------

#: numpy → TF DataType enum
TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.int32): 3,
             np.dtype(np.uint8): 4, np.dtype(np.int16): 5,
             np.dtype(np.int64): 9}
DT_FLOAT, DT_INT32, DT_STRING = 1, 3, 7
#: the GraphDef producer version written (TF 1.15's)
GRAPH_DEF_VERSION = 134


def _shape_proto(dims: Sequence[int]) -> bytes:
    return b"".join(_len(2, _int(1, d)) for d in dims)


def _tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)             # (ascontiguousarray makes 0-d 1-d)
    return (_int(1, TF_DTYPES[arr.dtype]) + _len(2, _shape_proto(arr.shape))
            + _len(4, arr.astype(arr.dtype.newbyteorder("<")).tobytes()))


class Attr:
    """Typed AttrValues that a Python value cannot say by itself."""

    @staticmethod
    def type(enum: int) -> bytes:
        return _int(6, enum)

    @staticmethod
    def shape(dims: Sequence[int]) -> bytes:
        return _len(7, _shape_proto(dims))

    @staticmethod
    def ints(vals: Sequence[int]) -> bytes:
        return _len(1, _packed(3, vals))


def _attr_value(v) -> bytes:
    if isinstance(v, bytes):            # already an encoded AttrValue
        return v
    if isinstance(v, bool):
        return _int(5, v)
    if isinstance(v, int):
        return _int(3, v)
    if isinstance(v, float):
        return _f32(4, v)
    if isinstance(v, str):
        return _len(2, v)
    if isinstance(v, np.ndarray):
        return _len(8, _tensor_proto(v))
    raise TypeError(f"no AttrValue for {type(v).__name__}")


class GraphDefWriter:
    """A frozen GraphDef under construction: NodeDefs in order."""

    def __init__(self):
        self._nodes: List[bytes] = []

    def node(self, name: str, op: str, inputs: Sequence[str] = (),
             **attrs) -> str:
        body = _len(1, name) + _len(2, op)
        body += b"".join(_len(3, i) for i in inputs)
        for k in sorted(attrs):
            body += _len(5, _len(1, k) + _len(2, _attr_value(attrs[k])))
        self._nodes.append(body)
        return name

    def const(self, name: str, arr: np.ndarray) -> str:
        arr = np.asarray(arr)
        return self.node(name, "Const", value=arr,
                         dtype=Attr.type(TF_DTYPES[arr.dtype]))

    def op(self, name: str, op: str, inputs: Sequence[str] = (),
           **attrs) -> str:
        """A float op: T = DT_FLOAT beside the given attrs."""
        return self.node(name, op, inputs, T=Attr.type(DT_FLOAT), **attrs)

    def serialize(self) -> bytes:
        return (b"".join(_len(1, n) for n in self._nodes)
                + _len(4, _int(1, GRAPH_DEF_VERSION)))


def write_graphdef_mobilenet_v2(model, path, input_size: int = 224) -> None:
    """The port's MobileNetV2 (f32 params) as a frozen GraphDef, BN
    folded: "input" (1, S, S, 3) float NHWC → "logits" (1, classes).
    Convs are Conv2D / DepthwiseConv2dNative (SAME) + BiasAdd (+ Relu6),
    residuals AddV2, the pool a Mean over H and W, the classifier MatMul
    + BiasAdd."""
    from nnstreamer_tpu_torch.tools.tflite_fixture import mobilenet_v2_ops

    ops, _ = mobilenet_v2_ops(model)
    g = GraphDefWriter()
    g.node("input", "Placeholder", dtype=Attr.type(DT_FLOAT),
           shape=Attr.shape((1, input_size, input_size, 3)))
    names = {"input": "input"}
    for i, op in enumerate(ops):
        kind = op["kind"]
        # the classifier: the 1×1 conv on the pooled map, then the reshape
        classifier = kind == "conv" and i + 1 < len(ops) \
            and ops[i + 1]["kind"] == "reshape"
        if kind in ("conv", "dw") and not classifier:
            w = op["w"]                                   # OIHW
            s = op["stride"]
            if kind == "dw":                              # HW C 1
                wt = g.const(f"w{i}", np.ascontiguousarray(
                    w.transpose(2, 3, 0, 1)).astype(np.float32))
                y = g.op(f"conv{i}", "DepthwiseConv2dNative",
                         [names[op["x"]], wt], strides=Attr.ints([1, s, s, 1]),
                         padding="SAME")
            else:                                         # HWIO
                wt = g.const(f"w{i}", np.ascontiguousarray(
                    w.transpose(2, 3, 1, 0)).astype(np.float32))
                y = g.op(f"conv{i}", "Conv2D", [names[op["x"]], wt],
                         strides=Attr.ints([1, s, s, 1]), padding="SAME")
            b = g.const(f"b{i}", op["b"].astype(np.float32))
            y = g.op(f"bias{i}", "BiasAdd", [y, b])
            if op["act"]:
                y = g.op(f"relu6_{i}", "Relu6", [y])
            names[op["y"]] = y
        elif kind == "add":
            names[op["y"]] = g.op(f"add{i}", "AddV2",
                                  [names[op["a"]], names[op["b"]]])
        elif kind == "pool":
            axes = g.const(f"axes{i}", np.asarray([1, 2], np.int32))
            names[op["y"]] = g.op(f"pool{i}", "Mean", [names[op["x"]], axes],
                                  Tidx=Attr.type(DT_INT32), keep_dims=False)
        elif classifier:                      # → MatMul on (1, C)
            wfc = g.const(f"w{i}", np.ascontiguousarray(
                op["w"][:, :, 0, 0].T).astype(np.float32))
            y = g.op(f"fc{i}", "MatMul", [names[op["x"]], wfc])
            b = g.const(f"b{i}", op["b"].astype(np.float32))
            names[op["y"]] = g.op("logits", "BiasAdd", [y, b])
        # the reshape to (1, classes): the MatMul already gave that shape
    Path(path).write_bytes(g.serialize())


def _he(rng, shape, fan_in: int) -> np.ndarray:
    return rng.normal(0.0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)


def write_speech_commands(path, filters: int = 64, labels: int = 12,
                          seed: int = 0) -> None:
    """TF's speech-commands `conv` model, frozen as the reference's
    conv_actions_frozen.pb: "wav_data" (a string: the WAV file's bytes)
    → DecodeWav (16000 samples, mono) → AudioSpectrogram (window 480,
    stride 160, squared) → Mfcc (40 coefficients) → (1, 98, 40, 1) →
    conv `filters` × (20×8) SAME + bias, ReLU, max-pool 2×2 → conv
    `filters` × (10×4) SAME + bias, ReLU → MatMul to `labels` + bias →
    "labels_softmax". Weights He-normal from `seed`, biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    time_size, freq_size = 98, 40
    g = GraphDefWriter()
    g.node("wav_data", "Placeholder", dtype=Attr.type(DT_STRING),
           shape=Attr.shape(()))
    g.node("decoded_sample_data", "DecodeWav", ["wav_data"],
           desired_channels=1, desired_samples=16000)
    g.node("AudioSpectrogram", "AudioSpectrogram",
           ["decoded_sample_data"], window_size=480, stride=160,
           magnitude_squared=True)
    g.node("Mfcc", "Mfcc", ["AudioSpectrogram", "decoded_sample_data:1"],
           dct_coefficient_count=freq_size, filterbank_channel_count=40,
           lower_frequency_limit=20.0, upper_frequency_limit=4000.0)
    flat = g.const("Reshape/shape",
                   np.asarray([-1, time_size * freq_size], np.int32))
    x = g.op("Reshape", "Reshape", ["Mfcc", flat], Tshape=Attr.type(DT_INT32))
    shape4 = g.const("Reshape_1/shape",
                     np.asarray([-1, time_size, freq_size, 1], np.int32))
    x = g.op("Reshape_1", "Reshape", [x, shape4], Tshape=Attr.type(DT_INT32))
    one = Attr.ints([1, 1, 1, 1])
    w1 = g.const("Variable", _he(rng, (20, 8, 1, filters), 20 * 8))
    b1 = g.const("Variable_1", rng.normal(0, 0.01, filters).astype(np.float32))
    x = g.op("Conv2D", "Conv2D", [x, w1], strides=one, padding="SAME")
    x = g.op("add", "Add", [x, b1])
    x = g.op("Relu", "Relu", [x])
    x = g.op("MaxPool", "MaxPool", [x], ksize=Attr.ints([1, 2, 2, 1]),
             strides=Attr.ints([1, 2, 2, 1]), padding="SAME")
    w2 = g.const("Variable_2", _he(rng, (10, 4, filters, filters),
                                   10 * 4 * filters))
    b2 = g.const("Variable_3", rng.normal(0, 0.01, filters).astype(np.float32))
    x = g.op("Conv2D_1", "Conv2D", [x, w2], strides=one, padding="SAME")
    x = g.op("add_1", "Add", [x, b2])
    x = g.op("Relu_1", "Relu", [x])
    count = (time_size // 2) * (freq_size // 2) * filters
    flat2 = g.const("Reshape_2/shape", np.asarray([-1, count], np.int32))
    x = g.op("Reshape_2", "Reshape", [x, flat2], Tshape=Attr.type(DT_INT32))
    w3 = g.const("Variable_4", _he(rng, (count, labels), count))
    b3 = g.const("Variable_5", rng.normal(0, 0.01, labels).astype(np.float32))
    x = g.op("MatMul", "MatMul", [x, w3])
    x = g.op("add_2", "Add", [x, b3])
    g.op("labels_softmax", "Softmax", [x])
    Path(path).write_bytes(g.serialize())


# -- PCM16 WAV ------------------------------------------------------------------

def wav_bytes(samples: np.ndarray, rate: int = 16000) -> bytes:
    """int16 (n,) or (n, channels) samples → a RIFF/WAVE PCM16 file."""
    s = np.asarray(samples, np.int16)
    ch = 1 if s.ndim == 1 else s.shape[1]
    data = s.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * 2, ch * 2, 16)
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def seeded_speech(seed: int = 0, seconds: float = 1.0,
                  rate: int = 16000) -> bytes:
    """A seeded second of audio (a tone with a rising pitch in noise) as
    PCM16 WAV bytes."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = rng.uniform(150.0, 400.0)
    tone = 0.3 * np.sin(2 * np.pi * (f0 + 300.0 * t) * t)
    x = tone + rng.normal(0.0, 0.05, t.shape)
    return wav_bytes(np.clip(x * 32767.0, -32768, 32767).astype(np.int16),
                     rate)


# -- Caffe NetParameter ---------------------------------------------------------

def _blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    return _len(7, _packed(1, arr.shape)) + _packed_f32(5, arr.ravel())


def caffe_layer(name: str, type_: str, bottoms: Sequence[str],
                tops: Sequence[str], blobs: Sequence[np.ndarray] = (),
                params: Optional[Dict[int, bytes]] = None) -> bytes:
    """A LayerParameter: `params` maps a field number (106 convolution,
    121 pooling, 117 inner product, 143 input, 118 LRN, 110 eltwise) to
    the encoded message."""
    body = _len(1, name) + _len(2, type_)
    body += b"".join(_len(3, b) for b in bottoms)
    body += b"".join(_len(4, t) for t in tops)
    body += b"".join(_len(7, _blob(b)) for b in blobs)
    for f, msg in sorted((params or {}).items()):
        body += _len(f, msg)
    return body


def caffe_net(name: str, layers: Sequence[bytes]) -> bytes:
    return _len(1, name) + b"".join(_len(100, lyr) for lyr in layers)


def caffe_input(name: str, shape: Sequence[int]) -> bytes:
    return caffe_layer(name, "Input", [], [name],
                       params={143: _len(1, _packed(1, shape))})


def caffe_conv(name, bottom, w, b, stride=1, pad=0, group=1) -> bytes:
    """Convolution with OIHW `w`; proto2 repeated fields unpacked."""
    msg = _int(1, w.shape[0]) + _int(2, 1)
    if pad:
        msg += _int(3, pad)
    msg += _int(4, w.shape[2])
    if group != 1:
        msg += _int(5, group)
    if stride != 1:
        msg += _int(6, stride)
    return caffe_layer(name, "Convolution", [bottom], [name], [w, b],
                       {106: msg})


def caffe_pool(name, bottom, kind: int, k: int, s: int, pad: int = 0,
               global_: bool = False) -> bytes:
    """Pooling: kind 0 MAX, 1 AVE."""
    msg = _int(1, kind) + _int(2, k) + _int(3, s)
    if pad:
        msg += _int(4, pad)
    if global_:
        msg += _int(12, 1)
    return caffe_layer(name, "Pooling", [bottom], [name], params={121: msg})


def caffe_ip(name, bottom, w, b) -> bytes:
    """InnerProduct with an (out, in) weight."""
    return caffe_layer(name, "InnerProduct", [bottom], [name], [w, b],
                       {117: _int(1, w.shape[0])})


def write_caffe_lenet(path, seed: int = 0, batch: int = 1) -> None:
    """Caffe's examples/mnist/lenet.prototxt (deploy) with seeded weights:
    data (batch, 1, 28, 28) → conv1 20 (5×5) → pool1 MAX 2/2 → conv2 50
    (5×5) → pool2 → ip1 500 → relu1 (in place) → ip2 10 → prob Softmax."""
    rng = np.random.default_rng(seed)
    c1 = _he(rng, (20, 1, 5, 5), 25)
    c2 = _he(rng, (50, 20, 5, 5), 500)
    f1 = _he(rng, (500, 800), 800)
    f2 = _he(rng, (10, 500), 500)

    def bias(n):
        return rng.normal(0, 0.01, n).astype(np.float32)

    layers = [
        caffe_input("data", (batch, 1, 28, 28)),
        caffe_conv("conv1", "data", c1, bias(20)),
        caffe_pool("pool1", "conv1", 0, 2, 2),
        caffe_conv("conv2", "pool1", c2, bias(50)),
        caffe_pool("pool2", "conv2", 0, 2, 2),
        caffe_ip("ip1", "pool2", f1, bias(500)),
        caffe_layer("relu1", "ReLU", ["ip1"], ["ip1"]),
        caffe_ip("ip2", "ip1", f2, bias(10)),
        caffe_layer("prob", "Softmax", ["ip2"], ["prob"]),
    ]
    Path(path).write_bytes(caffe_net("LeNet", layers))


# -- Caffe2 NetDef --------------------------------------------------------------

def _c2_arg(name: str, v) -> bytes:
    body = _len(1, name)
    if isinstance(v, float):
        return body + _f32(2, v)
    if isinstance(v, int):
        return body + _int(3, v)
    if isinstance(v, str):
        return body + _len(4, v)
    arr = np.asarray(v)
    if arr.dtype.kind == "f":
        return body + _packed_f32(5, arr.ravel())
    return body + _packed(6, arr.ravel())


def caffe2_op(type_: str, inputs: Sequence[str], outputs: Sequence[str],
              **args) -> bytes:
    body = b"".join(_len(1, i) for i in inputs)
    body += b"".join(_len(2, o) for o in outputs)
    body += _len(4, type_)
    body += b"".join(_len(5, _c2_arg(k, v)) for k, v in args.items())
    return body


def caffe2_net(name: str, ops: Sequence[bytes], external_input=(),
               external_output=()) -> bytes:
    """A NetDef (caffe2.proto: external_input 7, external_output 8)."""
    return (_len(1, name) + b"".join(_len(2, op) for op in ops)
            + b"".join(_len(7, i) for i in external_input)
            + b"".join(_len(8, o) for o in external_output))


def write_caffe2_resnet(init_path, predict_path, widths=(16, 32, 64),
                        blocks: int = 3, classes: int = 10, seed: int = 0,
                        calib_frames: int = 8) -> None:
    """A CIFAR-10 ResNet (6·blocks+2 layers; 20 at blocks 3) as a caffe2
    pair: 3×3 conv + SpatialBN + Relu stem, three stages of `blocks`
    basic blocks at `widths` (the first block of stages 2 and 3 strided,
    with a 1×1 conv + SpatialBN projection shortcut), Sum + Relu,
    AveragePool 8 (global), FC, Softmax. Input "data" (1, 3, 32, 32).
    He-normal convs from `seed`; each SpatialBN's mean and variance are
    those of its conv's output over `calib_frames` seeded N(0, 1) frames
    (as a trained net's running statistics would be), its scale
    U(0.5, 1.5) (U(0.2, 0.5) closing a residual branch), its bias
    N(0, 0.1)."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    fills: List[bytes] = []
    ops: List[bytes] = []
    names: List[str] = []
    calib = {"data": torch.from_numpy(rng.normal(
        0, 1, (calib_frames, 3, 32, 32)).astype(np.float32))}

    def fill(name: str, arr: np.ndarray) -> str:
        arr = np.asarray(arr, np.float32)
        fills.append(caffe2_op("GivenTensorFill", [], [name],
                               shape=np.asarray(arr.shape, np.int64),
                               values=arr))
        names.append(name)
        return name

    def conv_bn(x: str, name: str, cin: int, cout: int, k: int,
                stride: int, relu: bool, closing: bool = False) -> str:
        w = _he(rng, (cout, cin, k, k), cin * k * k)
        ops.append(caffe2_op("Conv", [x, fill(f"{name}_w", w)], [name],
                             kernel=k, stride=stride, pad=k // 2,
                             order="NCHW"))
        y = F.conv2d(calib[x], torch.from_numpy(w), stride=stride,
                     padding=k // 2)
        mean = y.mean(dim=(0, 2, 3)).double().numpy()
        var = y.var(dim=(0, 2, 3), unbiased=False).double().numpy()
        scale = rng.uniform(*((0.2, 0.5) if closing else (0.5, 1.5)), cout)
        shift = rng.normal(0, 0.1, cout)
        bn = [fill(f"{name}_bn_{s}", a) for s, a in (
            ("s", scale), ("b", shift), ("rm", mean), ("riv", var))]
        ops.append(caffe2_op("SpatialBN", [name] + bn, [name + "_bn"],
                             is_test=1, epsilon=1e-5, order="NCHW"))
        inv = torch.from_numpy(scale / np.sqrt(var + 1e-5)).float()
        out = (y - torch.from_numpy(mean).float().view(1, -1, 1, 1)) \
            * inv.view(1, -1, 1, 1) + torch.from_numpy(shift).float() \
            .view(1, -1, 1, 1)
        if relu:
            ops.append(caffe2_op("Relu", [name + "_bn"], [name + "_bn"]))
            out = out.clamp(min=0)
        calib[name + "_bn"] = out
        return name + "_bn"

    x = conv_bn("data", "conv1", 3, widths[0], 3, 1, True)
    cin = widths[0]
    for si, width in enumerate(widths):
        for bi in range(blocks):
            stride = 2 if si and not bi else 1
            pre = f"s{si}b{bi}"
            y = conv_bn(x, pre + "_conv1", cin, width, 3, stride, True)
            y = conv_bn(y, pre + "_conv2", width, width, 3, 1, False, True)
            short = x
            if stride != 1 or cin != width:
                short = conv_bn(x, pre + "_proj", cin, width, 1, stride,
                                False)
            ops.append(caffe2_op("Sum", [y, short], [pre + "_sum"]))
            ops.append(caffe2_op("Relu", [pre + "_sum"], [pre + "_sum"]))
            calib[pre + "_sum"] = (calib[y] + calib[short]).clamp(min=0)
            x, cin = pre + "_sum", width
    ops.append(caffe2_op("AveragePool", [x], ["pool"], kernel=8, stride=1,
                         order="NCHW"))
    fw = fill("fc_w", _he(rng, (classes, cin), cin))
    fb = fill("fc_b", rng.normal(0, 0.01, classes))
    ops.append(caffe2_op("FC", ["pool", fw, fb], ["fc"]))
    ops.append(caffe2_op("Softmax", ["fc"], ["softmax"]))
    Path(init_path).write_bytes(caffe2_net("resnet_init", fills,
                                           external_output=names))
    Path(predict_path).write_bytes(caffe2_net(
        "resnet_predict", ops, external_input=["data"] + names,
        external_output=["softmax"]))


# -- UFF MetaGraph --------------------------------------------------------------

UFF_FLOAT32 = 131104


def _uff_data(v) -> bytes:
    """A Data message: str → string (1), list → int list (8), ("ref",
    key) → a reference into referenced_data (100), ("dtype", code) → a
    dtype (101)."""
    if isinstance(v, str):
        return _len(1, v)
    if isinstance(v, tuple) and v[0] == "ref":
        return _len(100, v[1])
    if isinstance(v, tuple) and v[0] == "dtype":
        return _int(101, v[1])
    return _len(8, _packed(1, v))


def uff_node(id_: str, op: str, inputs: Sequence[str] = (),
             **fields) -> bytes:
    body = _len(1, id_) + b"".join(_len(2, i) for i in inputs) + _len(3, op)
    for k, v in fields.items():
        body += _len(4, _len(1, k) + _len(2, _uff_data(v)))
    return body


def uff_metagraph(name: str, nodes: Sequence[bytes],
                  blobs: Dict[str, np.ndarray]) -> bytes:
    graph = _len(1, name) + b"".join(_len(2, n) for n in nodes)
    data = b"".join(
        _len(5, _len(1, k) + _len(2, _len(9, np.ascontiguousarray(
            a, "<f4").tobytes())))
        for k, a in blobs.items())
    return _int(1, 1) + _int(2, 1) + _len(4, graph) + data


def write_uff_lenet(path, seed: int = 0) -> None:
    """LeNet-5 at lenet.prototxt's widths in UFF's op set, NHWC data and
    HWIO weights: "in" (N, 28, 28, 1) → Conv 20 (5×5) + Binary add → Pool
    max 2/2 → Conv 50 + add → Pool → Flatten → FullyConnected 500 + add
    → Activation relu → FullyConnected 10 + add → "out" (logits),
    MarkOutput."""
    rng = np.random.default_rng(seed)
    blobs = {"wc1": _he(rng, (5, 5, 1, 20), 25),
             "bc1": rng.normal(0, 0.01, 20).astype(np.float32),
             "wc2": _he(rng, (5, 5, 20, 50), 500),
             "bc2": rng.normal(0, 0.01, 50).astype(np.float32),
             "wd1": _he(rng, (800, 500), 800),
             "bd1": rng.normal(0, 0.01, 500).astype(np.float32),
             "wd2": _he(rng, (500, 10), 500),
             "bd2": rng.normal(0, 0.01, 10).astype(np.float32)}
    f32 = ("dtype", UFF_FLOAT32)

    def const(k):
        return uff_node(k, "Const", values=("ref", k),
                        shape=list(blobs[k].shape), dtype=f32)

    nodes = [
        uff_node("MarkOutput_0", "MarkOutput", ["out"]),
        uff_node("out", "Binary", ["fc2", "bd2"], func="add"),
        uff_node("fc2", "FullyConnected", ["relu", "wd2"]),
        uff_node("relu", "Activation", ["add3"], func="relu"),
        uff_node("add3", "Binary", ["fc1", "bd1"], func="add"),
        uff_node("fc1", "FullyConnected", ["flat", "wd1"]),
        uff_node("flat", "Flatten", ["pool2"]),
        uff_node("pool2", "Pool", ["add2"], func="max", kernel=[2, 2],
                 strides=[2, 2], padding=[0, 0]),
        uff_node("add2", "Binary", ["conv2", "bc2"], func="add"),
        uff_node("conv2", "Conv", ["pool1", "wc2"], strides=[1, 1],
                 padding=[0, 0]),
        uff_node("pool1", "Pool", ["add1"], func="max", kernel=[2, 2],
                 strides=[2, 2], padding=[0, 0]),
        uff_node("add1", "Binary", ["conv1", "bc1"], func="add"),
        uff_node("conv1", "Conv", ["in", "wc1"], strides=[1, 1],
                 padding=[0, 0]),
        uff_node("in", "Input", dtype=f32, shape=[1, 28, 28, 1]),
    ] + [const(k) for k in blobs]
    Path(path).write_bytes(uff_metagraph("main", nodes, blobs))


# -- flatbuffer formats: DLC and RTM --------------------------------------------

DLC_PREFIX = b"\xd5\x0a\x03\x00\x00\x00\x00\x00"


def _dlc_attr(b, name: str, tag: int, value) -> int:
    """A DLC Attribute table: tag 3 i32, 7 u32 list, 11 attribute list
    (value: offsets of Attribute tables), 40 a float32 tensor."""
    fields = [(0, "off", b.string(name)), (1, "u8", tag)]
    if tag == 3:
        fields.append((4, "i32", int(value)))
    elif tag == 7:
        fields.append((8, "off", b.vector(np.asarray(value, np.uint32))))
    elif tag == 11:
        fields.append((12, "off", b.offsets(value)))
    elif tag == 40:
        data = b.vector(np.asarray(value, np.float32).ravel())
        fields.append((2, "off", b.table([(0, "u8", 9), (2, "off", data)])))
    return b.table(fields)


def write_dlc_add2(path, uint8: bool = False, addend: float = 2.0) -> None:
    """The reference's add2_float.dlc / add2_uint8.dlc: Input "X_input"
    (dims (1,); input_type 1 = image for uint8 I/O), Const
    "elementwise_sum_0_const" = [addend] in model.params, and
    ElementwiseBinaryOp "elementwise_sum_0" (op 0, add) → "ADD_TOP"."""
    from nnstreamer_tpu_torch.tools.tflite_fixture import Builder

    const = "elementwise_sum_0_const"
    b = Builder()
    layers = []
    for lid, (name, type_, ins, outs, attrs) in enumerate((
            ("X_input", "Input", [], ["X_input"],
             [("input_type", 3, 1 if uint8 else 0)]),
            (const, "Const", [], [const], []),
            ("elementwise_sum_0", "ElementwiseBinaryOp",
             ["X_input", const], ["ADD_TOP"], [("op", 3, 0)]))):
        at = [_dlc_attr(b, *a) for a in attrs]
        layers.append(b.table([
            (0, "i32", lid), (1, "off", b.string(name)),
            (2, "off", b.string(type_)),
            (3, "off", b.offsets([b.string(s) for s in ins])),
            (4, "off", b.offsets([b.string(s) for s in outs])),
            (5, "off", b.offsets(at))]))
    infos = [_dlc_attr(b, blob, 11, [_dlc_attr(b, "dims", 7, [1])])
             for blob in ("X_input", const, "ADD_TOP")]
    net_attrs = [_dlc_attr(b, "BufferInfos", 11, infos)]
    model = b.finish(b.table([(1, "off", b.offsets(layers)),
                              (4, "off", b.offsets(net_attrs))]), b"NETD")
    bp = Builder()
    value = _dlc_attr(bp, "value", 40, [addend])
    rec = bp.table([(0, "off", bp.string(const)),
                    (1, "off", bp.offsets([value]))])
    params = bp.finish(bp.table([(0, "off", bp.offsets([rec]))]), b"NETP")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("model", DLC_PREFIX + model)
        z.writestr("model.params", DLC_PREFIX + params)
        z.writestr("dlc.metadata",
                   "converter-command=model_fixtures.write_dlc_add2 "
                   f"io={'uint8' if uint8 else 'float32'}\n")


#: RTM layer type codes (u16)
RTM_INPUT, RTM_CONST, RTM_SOFTMAX = 0x01, 0x02, 0x2C
RTM_CONV, RTM_POOL, RTM_RESHAPE = 0x3C, 0x3D, 0x65


class RTMWriter:
    """An RTMx model under construction: layers in order, each input a
    layer index."""

    def __init__(self):
        self.layers: List[dict] = []

    def layer(self, name: str, type_: int, inputs=(), shape=(),
              attrs: Optional[Dict[str, Sequence[int]]] = None,
              data: Optional[np.ndarray] = None,
              override: Optional[Dict[str, Sequence[int]]] = None) -> int:
        self.layers.append(dict(name=name, type=type_, inputs=list(inputs),
                                shape=list(shape), attrs=attrs or {},
                                data=data, override=override or {}))
        return len(self.layers) - 1

    def serialize(self, creator: str, name: str) -> bytes:
        from nnstreamer_tpu_torch.tools.tflite_fixture import Builder

        b = Builder()
        offs = []
        for lay in self.layers:
            at = []
            if lay["data"] is not None:
                d = np.asarray(lay["data"], np.float32)
                at.append(b.table([
                    (0, "off", b.string("data")),
                    (1, "off", b.vector(np.asarray(d.shape, np.int32))),
                    (2, "off", b.vector(d.ravel()))]))
            for k, v in lay["attrs"].items():
                f = [(0, "off", b.string(k)),
                     (1, "off", b.vector(np.asarray(v, np.int32)))]
                if k in lay["override"]:
                    f.append((3, "off", b.vector(np.asarray(
                        lay["override"][k], np.int32))))
                at.append(b.table(f))
            offs.append(b.table([
                (0, "off", b.string(lay["name"])), (2, "u16", lay["type"]),
                (3, "off", b.vector(np.asarray(lay["inputs"], np.int32))),
                (4, "off", b.offsets(at)),
                (5, "off", b.vector(np.asarray(lay["shape"], np.int32))),
                (9, "u8", 11)]))
        root = b.table([(1, "off", b.string(creator)),
                        (3, "off", b.string(name)),
                        (8, "off", b.offsets(offs))])
        return b.finish(root, b"RTMx")


def write_rtm_mobilenet_v1(path, width: float = 0.25, input_size: int = 224,
                           classes: int = 1001, seed: int = 0,
                           calib_frames: int = 4,
                           logit_scale: float = 1.0) -> None:
    """MobileNetV1 (`width`, `input_size`², `classes`) as an RTMx model:
    a 3×3/2 conv, 13 depthwise (HWCM, groups = C) + pointwise pairs, each
    conv SAME with ReLU6 (its name ends in /Relu6), a global average
    pool, the 1×1 logits conv (BiasAdd), a reshape to (1, classes) and a
    softmax — 28 convs, 56 consts, as the reference's
    mobilenet_v1_0.25_224.rtm. The weights are He-normal from `seed`
    with BN folded in: each conv's output is scaled to zero mean and unit
    variance per channel over `calib_frames` seeded frames in [-1, 1]
    (the logits, whose frames barely differ after the pool, to a standard
    deviation of `logit_scale` over all classes and frames)."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.tools.tflite_fixture import _same

    rng = np.random.default_rng(seed)
    w = RTMWriter()
    x = w.layer("input", RTM_INPUT, shape=(1, input_size, input_size, 3))
    h = input_size
    cal = torch.from_numpy(rng.uniform(
        -1, 1, (calib_frames, 3, input_size, input_size)).astype(np.float32))

    def ch(c: int) -> int:
        return max(8, int(c * width))

    def conv(x, name, cin, cout, k, s, depthwise, act, gain=1.0,
             logits=False):
        nonlocal h, cal
        if depthwise:
            wt = rng.normal(0, np.sqrt(2.0 / (k * k)), (k, k, cin, 1))
            oihw = wt.transpose(2, 3, 0, 1)
        else:
            wt = rng.normal(0, np.sqrt(2.0 / (k * k * cin)), (k, k, cin, cout))
            oihw = wt.transpose(3, 2, 0, 1)
        top, bottom = _same(h, k, s)
        y = F.conv2d(F.pad(cal, (top, bottom, top, bottom)),
                     torch.from_numpy(np.ascontiguousarray(oihw)).float(),
                     stride=s, groups=cin if depthwise else 1)
        if logits:         # one scale over every class and frame
            mean = np.zeros(cout)
            std = np.full(cout, y.std().item() + 1e-6)  # nnlint: disable=NNL002 a CPU tensor: the fixture writer runs on the host
        else:
            mean = y.mean(dim=(0, 2, 3)).double().numpy()
            std = y.std(dim=(0, 2, 3)).double().numpy() + 1e-3
        wt = wt * (gain / std).reshape(
            (1, 1, cin, 1) if depthwise else (1, 1, 1, cout))
        bias = -mean / std * gain
        y = (y - torch.from_numpy(mean).float().view(1, -1, 1, 1)) \
            * torch.from_numpy(gain / std).float().view(1, -1, 1, 1)
        cal = y.clamp(0, 6) if act else y
        wi = w.layer(f"{name}/weights", RTM_CONST, data=wt)
        bi = w.layer(f"{name}/biases", RTM_CONST, data=bias)
        h = -(-h // s)
        groups = cin if depthwise else 1
        return w.layer(
            f"{name}/{'Relu6' if act else 'BiasAdd'}", RTM_CONV,
            [x, wi, bi], (1, h, h, cout),
            attrs={"strides": [1, s, s, 1], "dilations": [1, 1, 1, 1],
                   "groups": [1], "head": [0, top, top, 0],
                   "tail": [0, bottom, bottom, 0]},
            override={"groups": [groups]} if groups > 1 else None)

    prefix = "MobilenetV1/MobilenetV1"
    c = ch(32)
    x = conv(x, f"{prefix}/Conv2d_0", 3, c, 3, 2, False, True)
    for i, (out, s) in enumerate(((64, 1), (128, 2), (128, 1), (256, 2),
                                  (256, 1), (512, 2), (512, 1), (512, 1),
                                  (512, 1), (512, 1), (512, 1), (1024, 2),
                                  (1024, 1)), start=1):
        x = conv(x, f"{prefix}/Conv2d_{i}_depthwise", c, c, 3, s, True, True)
        x = conv(x, f"{prefix}/Conv2d_{i}_pointwise", c, ch(out), 1, 1,
                 False, True)
        c = ch(out)
    x = w.layer("MobilenetV1/Logits/AvgPool_1a/AvgPool", RTM_POOL, [x],
                (1, 1, 1, c), attrs={"ksize": [1, h, h, 1],
                                     "strides": [1, 1, 1, 1]})
    cal = cal.mean(dim=(2, 3), keepdim=True)
    h = 1
    x = conv(x, "MobilenetV1/Logits/Conv2d_1c_1x1", c, classes, 1, 1, False,
             False, gain=logit_scale, logits=True)
    x = w.layer("MobilenetV1/Logits/SpatialSqueeze", RTM_RESHAPE, [x],
                (1, classes), attrs={"shape": [1, classes]})
    w.layer("MobilenetV1/Predictions/Softmax", RTM_SOFTMAX, [x],
            (1, classes), attrs={"axes": [-1]})
    Path(path).write_bytes(w.serialize(
        "model_fixtures.write_rtm_mobilenet_v1",
        f"mobilenet_v1_{width}_{input_size}"))


# -- TorchScript --------------------------------------------------------------

def write_torchscript_mbv2(model, path, input_size: int = 224) -> None:
    """The zoo's MobileNetV2 module (`models.mobilenet_v2.MobileNetV2`, f32)
    traced on a zero NHWC frame and saved: NHWC (1, size, size, 3) f32 in,
    logits (1, classes) out. Its TF-SAME pads are traced as the numbers
    they are at this size (`layers.same_pads` on ints), as a frozen graph
    holds them: traced from the frame's shape, they would be size
    arithmetic on one-element tensors, which the JAX package's loader
    cannot turn back into the ints `pad` takes."""
    import warnings

    import torch

    from nnstreamer_tpu_torch.models import layers

    x = torch.zeros(1, input_size, input_size, 3)
    same_pads = layers.same_pads
    layers.same_pads = lambda n, k, s: same_pads(int(n), int(k), int(s))
    try:
        with torch.no_grad(), warnings.catch_warnings():
            warnings.simplefilter("ignore", torch.jit.TracerWarning)
            traced = torch.jit.trace(model.eval(), x)
    finally:
        layers.same_pads = same_pads
    torch.jit.save(traced, str(path))


def write_torchscript_encoder(path, d_model: int = 1024, nhead: int = 8,
                              dim_ff: int = 4096, layers: int = 4,
                              seed: int = 0) -> None:
    """An `nn.TransformerEncoder` of `layers` post-norm ReLU layers, batch
    first, weights from torch's default init under `seed`, scripted and
    saved: (B, S, d_model) f32 in and out."""
    import torch
    from torch import nn

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        layer = nn.TransformerEncoderLayer(d_model, nhead, dim_ff,
                                           batch_first=True)
        net = nn.TransformerEncoder(layer, layers,
                                    enable_nested_tensor=False).eval()
    torch.jit.save(torch.jit.script(net), str(path))


#: the legacy archive's LeNet-5 forward, as torch 1.0 serialized code: uint8
#: NHWC frames scaled to [0, 1], NCHW inside, a softmax scaled to uint8
LEGACY_LENET5_CODE = """op_version_set = 0
def forward(self,
    input: Tensor) -> Tensor:
  _0 = torch.permute(torch._cast_Float(input, False), [0, 3, 1, 2])
  _1 = torch.div(_0, 255.)
  _2 = torch._convolution(_1, self.conv1.weight, self.conv1.bias, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, False, False, True)
  _3 = torch.max_pool2d(_2, [2, 2], [2, 2], [0, 0], [1, 1], False)
  _4 = torch._convolution(_3, self.conv2.weight, self.conv2.bias, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, False, False, True)
  _5 = torch.max_pool2d(_4, [2, 2], [2, 2], [0, 0], [1, 1], False)
  _6 = torch.view(_5, [-1, 800])
  _7 = torch.addmm(self.fc1.bias, _6, torch.t(self.fc1.weight), beta=1, alpha=1)
  _8 = torch.relu(_7)
  _9 = torch.addmm(self.fc2.bias, _8, torch.t(self.fc2.weight), beta=1, alpha=1)
  _10 = torch.mul(torch.softmax(_9, 1), 255)
  return torch.to(_10, 0, False, False)
"""


def write_legacy_lenet5(path, seed: int = 0) -> None:
    """LeNet-5 at lenet.prototxt's widths (conv 20 5×5, max-pool 2/2, conv
    50 5×5, max-pool, fc 500, ReLU, fc 10, softmax) with seeded He
    weights, as a producerVersion-1.0 TorchScript archive: `model.json`
    (the module tree, parameters by tensor id, each tensor's dims,
    strides and storage key), `code/lenet5.py` and raw little-endian
    storages `tensors/N`."""
    rng = np.random.default_rng(seed)
    blobs = [("conv1", _he(rng, (20, 1, 5, 5), 25),
              rng.normal(0, 0.01, 20).astype(np.float32)),
             ("conv2", _he(rng, (50, 20, 5, 5), 500),
              rng.normal(0, 0.01, 50).astype(np.float32)),
             ("fc1", _he(rng, (500, 800), 800),
              rng.normal(0, 0.01, 500).astype(np.float32)),
             ("fc2", _he(rng, (10, 500), 500),
              rng.normal(0, 0.01, 10).astype(np.float32))]
    tensors, subs, records = [], [], {}
    for name, w, b in blobs:
        params = []
        for pname, arr in (("weight", w), ("bias", b)):
            tid = len(tensors)
            strides = np.cumprod((1,) + arr.shape[:0:-1])[::-1]
            tensors.append({
                "dims": [str(d) for d in arr.shape], "offset": "0",
                "strides": [str(int(s)) for s in strides],
                "requiresGrad": True, "dataType": "FLOAT",
                "data": {"key": f"tensors/{tid}"}, "device": "cpu"})
            records[f"tensors/{tid}"] = arr.astype("<f4").tobytes()
            params.append({"isBuffer": False, "tensorId": str(tid),
                           "name": pname})
        subs.append({"name": name, "parameters": params,
                     "optimize": True})
    meta = {"protoVersion": "2", "producerName": "pytorch",
            "producerVersion": "1.0",
            "mainModule": {"name": "lenet5", "submodules": subs,
                           "torchscriptArena": {"key": "code/lenet5.py"},
                           "optimize": True},
            "tensors": tensors}
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("lenet5/version", "1\n")
        zf.writestr("lenet5/model.json", json.dumps(meta))
        zf.writestr("lenet5/code/lenet5.py", LEGACY_LENET5_CODE)
        for key, data in records.items():
            zf.writestr(f"lenet5/{key}", data)


#: the recurrent and attention archives of `write_torchscript_nn`
TORCHSCRIPT_NN = ("lstm", "lstm_bidir", "gru", "attention",
                  "attention_causal", "mha", "decoder")


def _torchscript_nn_module(name: str):
    """The module of one `TORCHSCRIPT_NN` archive and its torch seed."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    if name in ("lstm", "lstm_bidir"):
        bidir = name == "lstm_bidir"

        class Lstm(nn.Module):
            def __init__(self):
                super().__init__()
                self.rnn = nn.LSTM(6, 5, num_layers=2, batch_first=True,
                                   bidirectional=bidir)
                self.fc = nn.Linear(5 * (2 if bidir else 1), 3)

            def forward(self, x):
                y, (h, c) = self.rnn(x)
                return self.fc(y[:, -1]), h, c

        return Lstm, 8
    if name == "gru":
        class Gru(nn.Module):
            def __init__(self):
                super().__init__()
                self.rnn = nn.GRU(4, 8, batch_first=True)

            def forward(self, x):
                y, h = self.rnn(x)
                return y, h

        return Gru, 9
    if name in ("attention", "attention_causal"):
        causal = name == "attention_causal"

        class Attention(nn.Module):
            def __init__(self):
                super().__init__()
                self.qkv = nn.Linear(32, 96)
                self.out = nn.Linear(32, 32)
                self.causal = causal

            def forward(self, x):
                B, S, D = x.shape[0], x.shape[1], x.shape[2]
                qkv = self.qkv(x).reshape(B, S, 3, 4, 8)
                q = qkv[:, :, 0].transpose(1, 2)
                k = qkv[:, :, 1].transpose(1, 2)
                v = qkv[:, :, 2].transpose(1, 2)
                a = F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=self.causal)
                a = a.transpose(1, 2).reshape(B, S, D)
                return self.out(a)

        return Attention, 11
    if name == "mha":
        class Mha(nn.Module):
            def __init__(self):
                super().__init__()
                self.mha = nn.MultiheadAttention(32, 4, batch_first=True)
                self.ln = nn.LayerNorm(32)

            def forward(self, x):
                y, _ = self.mha(x, x, x, need_weights=False)
                return self.ln(x + y)

        return Mha, 12
    if name == "decoder":
        def decoder():
            layer = nn.TransformerDecoderLayer(
                d_model=32, nhead=4, dim_feedforward=64, batch_first=True)
            return nn.TransformerDecoder(layer, num_layers=2)

        return decoder, 14
    raise ValueError(f"no TorchScript archive {name!r}; valid: "
                     f"{TORCHSCRIPT_NN}")


def torchscript_nn_inputs(name: str) -> List[np.ndarray]:
    """The seeded f32 inputs of one `TORCHSCRIPT_NN` archive."""
    if name in ("lstm", "lstm_bidir"):
        return [np.random.RandomState(8).randn(2, 7, 6).astype(np.float32)]
    if name == "gru":
        return [np.random.RandomState(9).randn(3, 5, 4).astype(np.float32)]
    if name in ("attention", "attention_causal"):
        return [np.random.RandomState(11).randn(2, 10, 32).astype(np.float32)]
    if name == "mha":
        return [np.random.RandomState(12).randn(2, 9, 32).astype(np.float32)]
    return [np.random.RandomState(14).randn(2, 7, 32).astype(np.float32),
            np.random.RandomState(15).randn(2, 9, 32).astype(np.float32)]


def write_torchscript_nn(path, name: str) -> List[np.ndarray]:
    """One recurrent or attention archive (`TORCHSCRIPT_NN`): nn.LSTM (two
    layers, uni- or bidirectional) with a linear head, nn.GRU, a
    self-attention block over F.scaled_dot_product_attention (full or
    causal), nn.MultiheadAttention with a residual LayerNorm, an
    nn.TransformerDecoder (two layers, self and cross attention); weights
    from torch's default init under the archive's seed, scripted and
    saved → its seeded inputs."""
    import torch

    make, seed = _torchscript_nn_module(name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = make().eval()
    torch.jit.save(torch.jit.script(net), str(path))
    return torchscript_nn_inputs(name)


def write_torchscript(out: Path, width: float = 1.0, size: int = 224,
                      d_model: int = 1024, layers: int = 4,
                      seed: int = 0) -> Dict[str, Path]:
    """The TorchScript fixtures into `out` → {"T": mbv2.pt (the zoo's
    MobileNetV2 at that width and size, traced), "TX": enc.pt (8 heads,
    FFN 4·d_model, scripted), "LT": lenet5.pt (legacy)}."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build

    out.mkdir(parents=True, exist_ok=True)
    files = {"T": out / "mbv2.pt", "TX": out / "enc.pt",
             "LT": out / "lenet5.pt"}
    model = build(width=width, input_size=size, dtype="float32",
                  seed=seed).params
    write_torchscript_mbv2(model, files["T"], input_size=size)
    write_torchscript_encoder(files["TX"], d_model=d_model,
                              dim_ff=4 * d_model, layers=layers, seed=seed)
    write_legacy_lenet5(files["LT"], seed=seed)
    return files


def write_all(out: Path, width: float = 1.0, size: int = 224,
              filters: int = 64, seed: int = 0) -> Dict[str, Path]:
    """Every fixture into `out` → {name: path}."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build

    out.mkdir(parents=True, exist_ok=True)
    files = {k: out / v for k, v in (
        ("G", "mbv2.pb"), ("S", "speech_conv.pb"), ("wav", "speech.wav"),
        ("M", "mobilenet_v1_0.25.rtm"), ("L", "lenet.caffemodel"),
        ("R_init", "resnet_init_net.pb"), ("R_predict", "resnet_predict_net.pb"),
        ("U", "lenet5.uff"), ("DLC_f", "add2_float.dlc"),
        ("DLC_u8", "add2_uint8.dlc"))}
    model = build(width=width, input_size=size, dtype="float32",
                  seed=seed).params
    write_graphdef_mobilenet_v2(model, files["G"], input_size=size)
    write_speech_commands(files["S"], filters=filters, seed=seed)
    files["wav"].write_bytes(seeded_speech(seed))
    write_rtm_mobilenet_v1(files["M"], input_size=size, seed=seed)
    write_caffe_lenet(files["L"], seed=seed)
    write_caffe2_resnet(files["R_init"], files["R_predict"], seed=seed)
    write_uff_lenet(files["U"], seed=seed)
    write_dlc_add2(files["DLC_f"])
    write_dlc_add2(files["DLC_u8"], uint8=True)
    return files


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--filters", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    files = write_all(Path(args.out_dir), args.width, args.size,
                      args.filters, args.seed)
    files.update(write_torchscript(Path(args.out_dir), args.width,
                                   args.size, args.d_model, args.layers,
                                   args.seed))
    for f in files.values():
        print(f"{f}: {f.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
