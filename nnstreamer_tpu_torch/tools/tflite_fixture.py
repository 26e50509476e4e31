#!/usr/bin/env python3
"""Writes TFLite model files for tests and on-card checks (fixture
tooling, not a feature of the system: nothing registers it with the
pipeline and the package does not export it).

The machine with the card has no tensorflow and no flatbuffers package,
and the repository holds no model file, so the TFLite loader's checks
need files this module can make itself:

- `write_mobilenet_v2(model, path, quant=...)`: the port's MobileNetV2
  (a `models.mobilenet_v2.MobileNetV2`, f32 params) with BN folded into
  the convs, in the op set of the reference's
  `mobilenet_v2_1.0_224_quant.tflite` — CONV_2D, DEPTHWISE_CONV_2D, ADD,
  AVERAGE_POOL_2D, RESHAPE (the classifier is a 1×1 CONV_2D on the
  pooled map, then RESHAPE to (1, classes)). Float32, taking normalized
  float frames, or uint8 per-tensor quantized, taking uint8 frames
  straight in (scale 1/128, zero point 128, as the reference's quant
  model): the activation ranges come from a float calibration run over
  seeded frames (RELU6 outputs get [0, 6]; AVERAGE_POOL and RESHAPE keep
  their input's quantization), weights are asymmetric uint8 per tensor,
  int32 biases use scale sx·sw.
- `write_while_counter(path)`: a WHILE loop of a few ops (LESS in the
  cond subgraph; ADD and MUL in the body) over (counter, x).

The writer is a minimal back-to-front flatbuffer builder (`Builder`).
`tf.lite.Interpreter` wants schema version 3, buffer 0 empty, both
`deprecated_builtin_code` and `builtin_code`, and the union type beside
each `builtin_options`; every vector is aligned to its element size and
buffer data to 16 bytes.

    python3 nnstreamer_tpu_torch/tools/tflite_fixture.py OUT_DIR \\
        [--width 1.0] [--size 224] [--classes 1001] [--seed 0]

writes OUT_DIR/mbv2_float.tflite, mbv2_quant.tflite (from
``zoo://mobilenet_v2`` built with that seed) and while_counter.tflite.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# schema.fbs constants
SCHEMA_VERSION = 3
TYPE_FLOAT32, TYPE_INT32, TYPE_UINT8, TYPE_BOOL = 0, 2, 3, 6
PAD_SAME, PAD_VALID = 0, 1
ACT_NONE, ACT_RELU6 = 0, 3
#: BuiltinOperator codes, and the BuiltinOptions union type of each
#: op's options table
ADD, AVERAGE_POOL_2D, CONV_2D, DEPTHWISE_CONV_2D = 0, 1, 3, 4
MUL, RESHAPE, LESS, WHILE = 18, 22, 58, 119
OPT_CONV, OPT_DW, OPT_POOL, OPT_ADD = 1, 2, 5, 11
OPT_RESHAPE, OPT_MUL, OPT_LESS, OPT_WHILE = 17, 21, 41, 93
#: input quantization of the uint8 model (the reference quant model's)
INPUT_SCALE, INPUT_ZERO = 1.0 / 128.0, 128
BN_EPS = 1e-3

_FMT = {"u8": "<B", "i8": "<b", "u16": "<H", "i32": "<i", "u32": "<I",
        "f32": "<f", "i64": "<q"}


class Builder:
    """Back-to-front flatbuffer builder: objects are prepended, so every
    reference points forward (uoffset). Positions are kept as offsets
    from the buffer's end; `finish` pads the whole to the largest
    alignment used, so an offset aligned to n is a position aligned to n.
    """

    def __init__(self):
        self._chunks: List[bytes] = []
        self.size = 0
        self.minalign = 4

    def _put(self, data: bytes) -> None:
        self._chunks.append(bytes(data))
        self.size += len(data)

    def _align(self, n_after: int, align: int) -> None:
        """Pad so that, once `n_after` more bytes are written, the size is
        a multiple of `align`."""
        self.minalign = max(self.minalign, align)
        pad = (-(self.size + n_after)) % align
        if pad:
            self._put(b"\0" * pad)

    def vector(self, arr: np.ndarray, align: int = 4) -> int:
        """A vector of scalars (little-endian numpy) → its offset."""
        data = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<"),
                                                copy=False).tobytes()
        self._align(len(data), max(align, 4, arr.dtype.itemsize))
        self._put(data)
        self._put(struct.pack("<I", arr.size))
        return self.size

    def string(self, s: str) -> int:
        data = s.encode() + b"\0"
        self._align(len(data), 4)
        self._put(data)
        self._put(struct.pack("<I", len(data) - 1))
        return self.size

    def offsets(self, offs: Sequence[int]) -> int:
        """A vector of references to objects written before."""
        n = len(offs)
        self._align(4 * n, 4)
        base = self.size + 4 * n
        data = b"".join(struct.pack("<I", base - 4 * i - c)
                        for i, c in enumerate(offs))
        self._put(data)
        self._put(struct.pack("<I", n))
        return self.size

    def table(self, fields: Sequence[Tuple[int, str, object]]) -> int:
        """A table of (field id, kind, value): kind a scalar format key of
        `_FMT`, or "off" for a reference (value: an offset). → offset."""
        size_of = {k: struct.calcsize(f) for k, f in _FMT.items()}
        size_of["off"] = 4
        order = sorted(fields, key=lambda f: -size_of[f[1]])
        layout, cur = [], 4                  # after the soffset
        for fid, kind, value in order:
            sz = size_of[kind]
            cur += (-cur) % sz
            layout.append((fid, kind, value, cur))
            cur += sz
        align = max([4] + [size_of[k] for _, k, _ in fields])
        self._align(cur, align)
        table_off = self.size + cur
        tb = bytearray(cur)
        for fid, kind, value, at in layout:
            if kind == "off":
                struct.pack_into("<I", tb, at, table_off - at - value)
            else:
                struct.pack_into(_FMT[kind], tb, at, value)
        n_fields = max([-1] + [f[0] for f in fields]) + 1
        vt = [4 + 2 * n_fields, cur] + [0] * n_fields
        for fid, _, _, at in layout:
            vt[2 + fid] = at
        vt_bytes = struct.pack(f"<{len(vt)}H", *vt)
        struct.pack_into("<i", tb, 0, len(vt_bytes))   # vtable just before
        self._put(tb)
        assert self.size == table_off
        self._put(vt_bytes)
        return table_off

    def finish(self, root: int, ident: bytes) -> bytes:
        self._align(8, self.minalign)
        total = self.size + 8
        self._put(ident)
        self._put(struct.pack("<I", total - root))
        return b"".join(reversed(self._chunks))


class Graph:
    """One subgraph under construction: tensors (with their constant
    data and quantization), operators, inputs and outputs."""

    def __init__(self, model: "Model"):
        self.model = model
        self.tensors: List[dict] = []
        self.ops: List[dict] = []
        self.inputs: List[int] = []
        self.outputs: List[int] = []

    def tensor(self, name: str, shape, ttype: int,
               data: Optional[np.ndarray] = None,
               quant: Optional[Tuple[Sequence[float], Sequence[int]]] = None
               ) -> int:
        buf = 0
        if data is not None:
            buf = len(self.model.buffers)
            self.model.buffers.append(np.ascontiguousarray(data).tobytes())
        self.tensors.append(dict(name=name, shape=tuple(int(d) for d in shape),
                                 type=ttype, buffer=buf, quant=quant))
        return len(self.tensors) - 1

    def op(self, code: int, inputs, outputs, opt_type: int = 0,
           opts: Sequence[Tuple[int, str, object]] = ()) -> None:
        self.ops.append(dict(code=code, inputs=list(inputs),
                             outputs=list(outputs), opt_type=opt_type,
                             opts=list(opts)))


class Model:
    """A TFLite model: subgraphs sharing one buffer table (buffer 0 the
    empty sentinel)."""

    def __init__(self):
        self.buffers: List[bytes] = [b""]
        self.subgraphs: List[Graph] = []

    def graph(self) -> Graph:
        g = Graph(self)
        self.subgraphs.append(g)
        return g

    def serialize(self, description: str = "") -> bytes:
        b = Builder()
        codes = sorted({op["code"] for g in self.subgraphs for op in g.ops})
        code_index = {c: i for i, c in enumerate(codes)}
        buf_offs = []
        for data in self.buffers:
            if data:
                vec = b.vector(np.frombuffer(data, np.uint8), align=16)
                buf_offs.append(b.table([(0, "off", vec)]))
            else:
                buf_offs.append(b.table([]))
        sg_offs = []
        for g in self.subgraphs:
            t_offs = []
            for t in g.tensors:
                fields = [(0, "off", b.vector(np.asarray(t["shape"],
                                                         np.int32))),
                          (1, "i8", t["type"]), (2, "u32", t["buffer"]),
                          (3, "off", b.string(t["name"]))]
                if t["quant"] is not None:
                    scale, zp = t["quant"]
                    q = b.table([
                        (2, "off", b.vector(np.asarray(scale, np.float32))),
                        (3, "off", b.vector(np.asarray(zp, np.int64))),
                        (6, "i32", 0)])
                    fields.append((4, "off", q))
                t_offs.append(b.table(fields))
            op_offs = []
            for op in g.ops:
                fields = [(0, "u32", code_index[op["code"]]),
                          (1, "off", b.vector(np.asarray(op["inputs"],
                                                         np.int32))),
                          (2, "off", b.vector(np.asarray(op["outputs"],
                                                         np.int32)))]
                if op["opt_type"]:
                    # an int vector option ("vec_i32") is written first and
                    # referenced from the options table
                    opts = [(fid, "off", b.vector(np.asarray(v, np.int32)))
                            if kind == "vec_i32" else (fid, kind, v)
                            for fid, kind, v in op["opts"]]
                    fields += [(3, "u8", op["opt_type"]),
                               (4, "off", b.table(opts))]
                op_offs.append(b.table(fields))
            sg_offs.append(b.table([
                (0, "off", b.offsets(t_offs)),
                (1, "off", b.vector(np.asarray(g.inputs, np.int32))),
                (2, "off", b.vector(np.asarray(g.outputs, np.int32))),
                (3, "off", b.offsets(op_offs))]))
        code_offs = [b.table([(0, "i8", min(c, 127)), (2, "i32", 1),
                              (3, "i32", c)]) for c in codes]
        root = b.table([
            (0, "u32", SCHEMA_VERSION),
            (1, "off", b.offsets(code_offs)),
            (2, "off", b.offsets(sg_offs)),
            (3, "off", b.string(description)),
            (4, "off", b.offsets(buf_offs))])
        return b.finish(root, b"TFL3")


# -- MobileNetV2 ----------------------------------------------------------------

def _fold(unit) -> Tuple[np.ndarray, np.ndarray]:
    """A ConvBN unit → (OIHW weight, bias) with the BN folded in, f32."""
    scale = unit.scale.detach().double()
    inv = scale / (unit.var.detach().double() + BN_EPS).sqrt()
    w = unit.weight.detach().double() * inv.view(-1, 1, 1, 1)
    b = unit.bias.detach().double() - unit.mean.detach().double() * inv
    return w.float().numpy(), b.float().numpy()


def mobilenet_v2_ops(model) -> Tuple[List[dict], Tuple[int, int]]:
    """The port's MobileNetV2 as a list of TFLite-shaped ops on tensor
    names (weights folded, f32): conv / dw (OIHW weights), add, pool,
    reshape. → (ops, (classes, channels of the head))."""
    ops: List[dict] = []
    n = [0]

    def new() -> str:
        n[0] += 1
        return f"t{n[0]}"

    def conv(x, unit, act=True):
        w, b = _fold(unit)
        y = new()
        ops.append(dict(kind="dw" if unit.groups > 1 else "conv", x=x, y=y,
                        w=w, b=b, stride=unit.stride,
                        act=ACT_RELU6 if act and unit.act else ACT_NONE))
        return y

    h = conv("input", model.stem)
    for blk in model.blocks:
        x = h
        if blk.expand is not None:
            h = conv(h, blk.expand)
        h = conv(h, blk.depthwise)
        h = conv(h, blk.project)
        if blk.residual:
            y = new()
            ops.append(dict(kind="add", a=h, b=x, y=y))
            h = y
    h = conv(h, model.head)
    pooled = new()
    ops.append(dict(kind="pool", x=h, y=pooled))
    wc = model.classifier.weight.detach().float().numpy()       # (cls, cin)
    logits4 = new()
    ops.append(dict(kind="conv", x=pooled, y=logits4,
                    w=wc[:, :, None, None].copy(),
                    b=model.classifier.bias.detach().float().numpy(),
                    stride=1, act=ACT_NONE))
    ops.append(dict(kind="reshape", x=logits4, y="logits"))
    return ops, wc.shape


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def run_ops(ops, x: np.ndarray) -> Dict[str, np.ndarray]:
    """Every tensor of `ops` on an NHWC f32 input (torch on the CPU, f32):
    the calibration run of the quantized file."""
    import torch
    import torch.nn.functional as F

    vals = {"input": torch.from_numpy(x).permute(0, 3, 1, 2)}
    with torch.inference_mode():
        for op in ops:
            if op["kind"] in ("conv", "dw"):
                v = vals[op["x"]]
                w = torch.from_numpy(op["w"])
                k, s = w.shape[2], op["stride"]
                pt, pb = _same(v.shape[2], k, s)
                pl, pr = _same(v.shape[3], k, s)
                y = F.conv2d(F.pad(v, (pl, pr, pt, pb)), w,
                             torch.from_numpy(op["b"]), stride=s,
                             groups=v.shape[1] if op["kind"] == "dw" else 1)
                vals[op["y"]] = torch.clamp(y, 0, 6) \
                    if op["act"] == ACT_RELU6 else y
            elif op["kind"] == "add":
                vals[op["y"]] = vals[op["a"]] + vals[op["b"]]
            elif op["kind"] == "pool":
                vals[op["y"]] = vals[op["x"]].mean(dim=(2, 3), keepdim=True)
            else:
                vals[op["y"]] = vals[op["x"]].reshape(x.shape[0], -1)
    return {k: (v.permute(0, 2, 3, 1) if v.dim() == 4 else v).numpy()
            for k, v in vals.items()}


def _qparams(lo: float, hi: float) -> Tuple[float, int]:
    """Asymmetric uint8 (scale, zero point) of a range holding 0."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    zp = int(np.clip(np.round(-lo / scale), 0, 255))
    return float(np.float32(scale)), zp


def _quantize(a: np.ndarray) -> Tuple[np.ndarray, float, int]:
    scale, zp = _qparams(a.min(), a.max())
    q = np.clip(np.round(a / scale) + zp, 0, 255).astype(np.uint8)
    return q, scale, zp


def write_mobilenet_v2(model, path, quant: bool = False,
                       input_size: int = 224, calib_frames: int = 8,
                       seed: int = 0) -> None:
    """Write the port's MobileNetV2 (f32 params) as a TFLite file: float32
    taking normalized float frames, or (quant) uint8 taking uint8 frames.
    The quantized file's activation ranges come from the float graph run
    on `calib_frames` seeded uint8 frames, normalized as the quant
    input's scale and zero point read them."""
    ops, (classes, _) = mobilenet_v2_ops(model)
    ranges: Dict[str, Tuple[float, float]] = {}
    if quant:
        frames = np.random.default_rng(seed).integers(
            0, 256, (calib_frames, input_size, input_size, 3), np.uint8)
        x = ((frames.astype(np.float32) - INPUT_ZERO) * INPUT_SCALE)
        for k, v in run_ops(ops, x).items():
            ranges[k] = (float(v.min()), float(v.max()))

    m = Model()
    g = m.graph()
    shapes = {"input": (1, input_size, input_size, 3)}
    qp: Dict[str, Tuple[float, int]] = {"input": (INPUT_SCALE, INPUT_ZERO)}
    ids: Dict[str, int] = {}
    ttype = TYPE_UINT8 if quant else TYPE_FLOAT32

    def act_tensor(name: str) -> int:
        q = None
        if quant:
            s, z = qp[name]
            q = ([s], [z])
        ids[name] = g.tensor(name, shapes[name], ttype, quant=q)
        return ids[name]

    g.inputs.append(act_tensor("input"))
    for i, op in enumerate(ops):
        kind = op["kind"]
        if kind in ("conv", "dw"):
            xs = shapes[op["x"]]
            w = op["w"]                                   # OIHW
            k, s = w.shape[2], op["stride"]
            shapes[op["y"]] = (1, -(-xs[1] // s), -(-xs[2] // s), w.shape[0])
            w_file = (w.transpose(1, 2, 3, 0) if kind == "dw"  # 1HW(C)
                      else w.transpose(0, 2, 3, 1))           # OHWI
            w_file = np.ascontiguousarray(w_file)
            if quant:
                qp[op["y"]] = ((6.0 / 255.0, 0) if op["act"] == ACT_RELU6
                               else _qparams(*ranges[op["y"]]))
                qw, sw, zw = _quantize(w_file)
                sx = qp[op["x"]][0]
                sb = float(np.float32(np.float64(sx) * np.float64(sw)))
                qb = np.round(op["b"].astype(np.float64) / sb) \
                    .astype(np.int32)
                wi = g.tensor(f"w{i}", w_file.shape, TYPE_UINT8, qw,
                              ([sw], [zw]))
                bi = g.tensor(f"b{i}", op["b"].shape, TYPE_INT32, qb,
                              ([sb], [0]))
            else:
                wi = g.tensor(f"w{i}", w_file.shape, TYPE_FLOAT32,
                              w_file.astype(np.float32))
                bi = g.tensor(f"b{i}", op["b"].shape, TYPE_FLOAT32,
                              op["b"].astype(np.float32))
            yi = act_tensor(op["y"])
            if kind == "dw":
                g.op(DEPTHWISE_CONV_2D, [ids[op["x"]], wi, bi], [yi], OPT_DW,
                     [(0, "i8", PAD_SAME), (1, "i32", s), (2, "i32", s),
                      (3, "i32", 1), (4, "i8", op["act"])])
            else:
                g.op(CONV_2D, [ids[op["x"]], wi, bi], [yi], OPT_CONV,
                     [(0, "i8", PAD_SAME), (1, "i32", s), (2, "i32", s),
                      (3, "i8", op["act"])])
        elif kind == "add":
            shapes[op["y"]] = shapes[op["a"]]
            if quant:
                qp[op["y"]] = _qparams(*ranges[op["y"]])
            yi = act_tensor(op["y"])
            g.op(ADD, [ids[op["a"]], ids[op["b"]]], [yi], OPT_ADD,
                 [(0, "i8", ACT_NONE)])
        elif kind == "pool":
            xs = shapes[op["x"]]
            shapes[op["y"]] = (1, 1, 1, xs[3])
            if quant:
                qp[op["y"]] = qp[op["x"]]
            yi = act_tensor(op["y"])
            g.op(AVERAGE_POOL_2D, [ids[op["x"]]], [yi], OPT_POOL,
                 [(0, "i8", PAD_VALID), (1, "i32", 1), (2, "i32", 1),
                  (3, "i32", xs[2]), (4, "i32", xs[1]),
                  (5, "i8", ACT_NONE)])
        else:
            shapes[op["y"]] = (1, classes)
            if quant:
                qp[op["y"]] = qp[op["x"]]
            shape_t = g.tensor(f"shape{i}", (2,), TYPE_INT32,
                               np.asarray([1, classes], np.int32))
            yi = act_tensor(op["y"])
            g.op(RESHAPE, [ids[op["x"]], shape_t], [yi], OPT_RESHAPE,
                 [(0, "vec_i32", [1, classes])])
    g.outputs.append(ids["logits"])
    Path(path).write_bytes(m.serialize(
        "mobilenet_v2 " + ("uint8" if quant else "float32")))


def write_while_counter(path, steps: int = 5, width: int = 8,
                        scale: float = 0.5, step: float = 1.0) -> None:
    """A WHILE model: (counter int32 from 0, x f32 (1, width)) through a
    body of ADD (counter + 1) and MUL/ADD (x · scale + step) while
    counter < steps (LESS in the cond subgraph). Input x; outputs
    (x after `steps` steps, the counter)."""
    m = Model()
    main, cond, body = m.graph(), m.graph(), m.graph()

    x = main.tensor("x", (1, width), TYPE_FLOAT32)
    c0 = main.tensor("counter0", (), TYPE_INT32, np.zeros((), np.int32))
    c_out = main.tensor("counter", (), TYPE_INT32)
    x_out = main.tensor("y", (1, width), TYPE_FLOAT32)
    main.inputs.append(x)
    main.op(WHILE, [c0, x], [c_out, x_out], OPT_WHILE,
            [(0, "i32", 1), (1, "i32", 2)])
    main.outputs += [x_out, c_out]

    cc = cond.tensor("c", (), TYPE_INT32)
    cx = cond.tensor("x", (1, width), TYPE_FLOAT32)
    lim = cond.tensor("steps", (), TYPE_INT32,
                      np.asarray(steps, np.int32))
    more = cond.tensor("more", (), TYPE_BOOL)
    cond.inputs += [cc, cx]
    cond.op(LESS, [cc, lim], [more], OPT_LESS)
    cond.outputs.append(more)

    bc = body.tensor("c", (), TYPE_INT32)
    bx = body.tensor("x", (1, width), TYPE_FLOAT32)
    one = body.tensor("one", (), TYPE_INT32, np.asarray(1, np.int32))
    k = body.tensor("scale", (), TYPE_FLOAT32,
                    np.asarray(scale, np.float32))
    inc = body.tensor("step", (), TYPE_FLOAT32, np.asarray(step, np.float32))
    bc2 = body.tensor("c_next", (), TYPE_INT32)
    bxs = body.tensor("x_scaled", (1, width), TYPE_FLOAT32)
    bx2 = body.tensor("x_next", (1, width), TYPE_FLOAT32)
    body.inputs += [bc, bx]
    body.op(ADD, [bc, one], [bc2], OPT_ADD, [(0, "i8", ACT_NONE)])
    body.op(MUL, [bx, k], [bxs], OPT_MUL, [(0, "i8", ACT_NONE)])
    body.op(ADD, [bxs, inc], [bx2], OPT_ADD, [(0, "i8", ACT_NONE)])
    body.outputs += [bc2, bx2]
    Path(path).write_bytes(m.serialize("while counter"))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1001)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build

    model = build(width=args.width, num_classes=args.classes,
                  input_size=args.size, dtype="float32",
                  seed=args.seed).params
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_mobilenet_v2(model, out / "mbv2_float.tflite",
                       input_size=args.size)
    write_mobilenet_v2(model, out / "mbv2_quant.tflite", quant=True,
                       input_size=args.size, seed=args.seed)
    write_while_counter(out / "while_counter.tflite")
    for f in sorted(out.glob("*.tflite")):
        print(f"{f}: {f.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
