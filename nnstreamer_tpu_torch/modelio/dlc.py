"""SNPE `.dlc` (Deep Learning Container) ingestion.

The port of the JAX package's modelio/dlc.py. The reference runs DLC
models through the Qualcomm SNPE SDK
(`ext/nnstreamer/tensor_filter/tensor_filter_snpe.cc:839` builds a
zdl::SNPE network from the container); this module reads the container
itself — no SDK; the zip and flatbuffer parser is a copy — and runs the
layer list as plain PyTorch calls.

Container layout (reversed from the reference's own checked-in
`add2_float.dlc` / `add2_uint8.dlc`, snpe-tflite-to-dlc 1.53):

- A ZIP archive: `model` (graph), `model.params` (weights),
  `dlc.metadata` (converter provenance, informational).
- `model` and `model.params` are FlatBuffers, each behind an 8-byte
  container prefix (`d5 0a 03 00` + 4 reserved bytes), with file
  identifiers ``NETD`` / ``NETP``.
- NETD root: fid1 = [Layer], fid4 = [Attribute] (network attributes —
  `BufferInfos` maps every blob name to `dims`/`data_size`/
  `axis_order`).
- Layer: fid0 = id (i32), fid1 = name, fid2 = type (string), fid3 =
  [input name], fid4 = [output name], fid5 = [Attribute].
- Attribute: fid0 = name, fid1 = type tag (u8), value slot = fid
  (tag+1) for scalar/list tags — tag 3 → i32 at fid4, tag 7 → u32
  list at fid8, tag 8 → i32 list at fid9, tag 11 → [Attribute] at
  fid12 — and tag 40 (tensor) → table at fid2 of
  {fid0: dtype tag (u8, 9 = float32), fid2: element vector}.
- NETP root: fid0 = [{fid0: layer name, fid1: [Attribute]}] where the
  `value` attribute (tag 40) carries the layer's weights.

Layer coverage is exactly what can be golden-verified in this
environment: `Input`, `Const`, and `ElementwiseBinaryOp` (the add2
models; reference goldens `unittest_filter_snpe.cc:167-258` — y = x+2
exact, float32 and uint8 I/O). Anything else fails loudly with the
layer type in the message.
"""

from __future__ import annotations

import io
import zipfile
from struct import error as struct_error
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.flatbuf import Reader
from nnstreamer_tpu_torch.modelio.tflite import LoweredModel, probe_outputs

_PREFIX_MAGIC = b"\xd5\x0a\x03\x00"

#: Attribute.type tag → value field id (scalar / list tags)
_TAG_I32 = 3          # value inline at fid4
_TAG_U32_LIST = 7     # vector at fid8
_TAG_I32_LIST = 8     # vector at fid9
_TAG_LIST = 11        # [Attribute] at fid12
_TAG_TENSOR = 40      # nested table at fid2

#: tensor dtype tags (NETP value tables)
_TENSOR_DTYPES = {9: np.float32}


@dataclass
class DLCLayer:
    id: int
    name: str
    type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DLCGraph:
    layers: List[DLCLayer]
    buffer_dims: Dict[str, Tuple[int, ...]]
    params: Dict[str, np.ndarray]
    metadata: str = ""


def _fb(raw: bytes, ident: bytes, what: str) -> Reader:
    if len(raw) < 16 or raw[:4] != _PREFIX_MAGIC:
        raise BackendError(
            f"dlc {what}: missing container prefix "
            f"(got {raw[:4]!r}, want {_PREFIX_MAGIC!r})")
    fb = raw[8:]
    if fb[4:8] != ident:
        raise BackendError(
            f"dlc {what}: flatbuffer identifier {fb[4:8]!r} != {ident!r}")
    return Reader(fb)


def _read_attr(r: Reader, at: int) -> Tuple[str, Any]:
    name = r.field_string(at, 0) or ""
    tag = r.field_scalar(at, 1, "<B", 0)
    if tag == _TAG_I32:
        return name, r.field_scalar(at, 4, "<i", 0)
    if tag == _TAG_U32_LIST:
        v = r.field_vec_scalars(at, 8, np.uint32)
        return name, ([] if v is None else [int(x) for x in v])
    if tag == _TAG_I32_LIST:
        v = r.field_vec_scalars(at, 9, np.int32)
        return name, ([] if v is None else [int(x) for x in v])
    if tag == _TAG_LIST:
        return name, dict(_read_attr(r, sub)
                          for sub in r.field_vec_tables(at, 12))
    if tag == _TAG_TENSOR:
        t = r.field_table(at, 2)
        if t is None:
            raise BackendError(f"dlc: tensor attribute {name!r} has no "
                               f"value table")
        dt_tag = r.field_scalar(t, 0, "<B", 0)
        dt = _TENSOR_DTYPES.get(dt_tag)
        if dt is None:
            raise BackendError(
                f"dlc: tensor attribute {name!r} has unsupported dtype "
                f"tag {dt_tag} (known: {sorted(_TENSOR_DTYPES)})")
        data = r.field_vec_scalars(t, 2, dt)
        return name, (np.zeros((0,), dt) if data is None
                      else np.asarray(data))
    raise BackendError(
        f"dlc: attribute {name!r} has unsupported type tag {tag}")


def parse_dlc(path: str) -> DLCGraph:
    """Parse a .dlc container into a graph description (host side)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
        z = zipfile.ZipFile(io.BytesIO(blob))
        names = set(z.namelist())
        if "model" not in names:
            raise BackendError(
                f"{path!r}: DLC zip has no 'model' member (members: "
                f"{sorted(names)})")
        model = z.read("model")
        params = z.read("model.params") if "model.params" in names \
            else b""
        meta = z.read("dlc.metadata").decode("utf-8", "replace") \
            if "dlc.metadata" in names else ""
    except (OSError, zipfile.BadZipFile, zipfile.LargeZipFile,
            NotImplementedError, EOFError, ValueError) as e:
        # zip-member reads surface CRC/decompress corruption as several
        # exception types; all mean the same thing here
        raise BackendError(f"{path!r} is not a DLC container (zip): {e}")
    try:
        return _parse_members(model, params, meta, path)
    except (IndexError, ValueError, UnicodeDecodeError,
            struct_error) as e:
        raise BackendError(f"dlc {path!r}: malformed flatbuffer: {e}")


def _parse_members(model: bytes, params: bytes, meta: str,
                   path: str) -> DLCGraph:
    r = _fb(model, b"NETD", path)
    root = r.root()
    layers = []
    for t in r.field_vec_tables(root, 1):
        layers.append(DLCLayer(
            id=r.field_scalar(t, 0, "<i", 0),
            name=r.field_string(t, 1) or "",
            type=r.field_string(t, 2) or "",
            inputs=r.field_vec_strings(t, 3),
            outputs=r.field_vec_strings(t, 4),
            attrs=dict(_read_attr(r, at)
                       for at in r.field_vec_tables(t, 5))))
    net_attrs = dict(_read_attr(r, at)
                     for at in r.field_vec_tables(root, 4))
    buffer_dims = {}
    for bname, info in (net_attrs.get("BufferInfos") or {}).items():
        if isinstance(info, dict) and isinstance(info.get("dims"), list):
            buffer_dims[bname] = tuple(info["dims"])

    weights: Dict[str, np.ndarray] = {}
    if params:
        rp = _fb(params, b"NETP", path)
        for rec in rp.field_vec_tables(rp.root(), 0):
            lname = rp.field_string(rec, 0) or ""
            attrs = dict(_read_attr(rp, at)
                         for at in rp.field_vec_tables(rec, 1))
            if isinstance(attrs.get("value"), np.ndarray):
                weights[lname] = attrs["value"]
    return DLCGraph(layers=layers, buffer_dims=buffer_dims,
                    params=weights, metadata=meta)


#: ElementwiseBinaryOp `op` attribute values (0 is the only one the
#: in-env goldens exercise; the rest would be guesswork)
_ELTWISE_OPS = {0: "add"}

#: Input layer `input_type` values: 0 = default (float I/O),
#: 1 = image (uint8 I/O — the reference runs add2_uint8 with
#: custom_properties "InputType:uint8,OutputType:uint8")
_INPUT_TYPE_IMAGE = 1


def lower_dlc(graph: DLCGraph, batch: Optional[int] = None) -> LoweredModel:
    """DLCGraph → LoweredModel: the layer list in order, in float32.

    Const layers resolve first from NETP weights, then from any inline
    tensor attribute. uint8-I/O models (input_type = image) cast on
    entry and round half to even, then clip to [0, 255], back to uint8 on
    exit, matching the SNPE user-buffer semantics the reference test
    drives (unittest_filter_snpe.cc:216-258: uint8 in, uint8 out, x+2
    exact).
    """
    inputs: List[Tuple[str, Tuple[int, ...]]] = []
    consts: Dict[str, np.ndarray] = {}
    compute: List[DLCLayer] = []
    u8_io = False

    def _out_dims(layer: DLCLayer) -> Optional[Tuple[int, ...]]:
        dims = graph.buffer_dims.get(layer.outputs[0])
        if dims:
            return dims
        od = layer.attrs.get("OutputDims")
        if isinstance(od, dict) and isinstance(od.get("0"), list):
            return tuple(od["0"])       # nested per-output attr list
        if isinstance(od, list) and od:
            return tuple(od)            # flat i32-list form
        return None

    for layer in graph.layers:
        if not layer.outputs:
            raise BackendError(
                f"dlc: layer {layer.name!r} ({layer.type}) declares no "
                f"outputs")
        if layer.type == "Input":
            dims = _out_dims(layer)
            if dims is None:
                raise BackendError(
                    f"dlc: Input layer {layer.name!r} has no recorded "
                    f"dims (neither BufferInfos nor OutputDims)")
            inputs.append((layer.outputs[0], tuple(dims)))
            if layer.attrs.get("input_type") == _INPUT_TYPE_IMAGE:
                u8_io = True
        elif layer.type == "Const":
            w = graph.params.get(layer.name)
            if w is None:
                w = layer.attrs.get("value")
            if not isinstance(w, np.ndarray):
                raise BackendError(
                    f"dlc: Const layer {layer.name!r} has no weights in "
                    f"model.params")
            dims = graph.buffer_dims.get(layer.outputs[0])
            consts[layer.outputs[0]] = (w.reshape(dims)
                                        if dims and w.size == int(
                                            np.prod(dims)) else w)
        else:
            compute.append(layer)
    if not inputs:
        raise BackendError("dlc: graph declares no Input layer")
    if not compute:
        raise BackendError("dlc: graph has no computable layers")

    in_shapes = []
    for name, dims in inputs:
        shape = tuple(int(d) for d in dims)
        if batch:
            if len(shape) < 2:
                raise BackendError(
                    f"dlc: batch override needs a rank>=2 input; "
                    f"{name!r} has dims {shape}")
            shape = (batch,) + shape[1:]
        in_shapes.append(shape)
    io_np = np.uint8 if u8_io else np.float32

    # resolve output blob names: every compute output nobody consumes
    consumed = {i for lay in compute for i in lay.inputs}
    out_names = [o for lay in compute for o in lay.outputs
                 if o not in consumed]
    if not out_names:
        out_names = list(compute[-1].outputs)
    for lay in compute:
        if lay.type != "ElementwiseBinaryOp":
            raise BackendError(
                f"dlc: layer type {lay.type!r} ({lay.name!r}) has no "
                f"lowering (supported: Input, Const, ElementwiseBinaryOp)")
        if _ELTWISE_OPS.get(lay.attrs.get("op", 0)) is None:
            raise BackendError(
                f"dlc: ElementwiseBinaryOp {lay.name!r} has unsupported op "
                f"{lay.attrs.get('op')} (supported: {_ELTWISE_OPS})")

    params = {name: torch.from_numpy(np.array(w, np.float32))
              for name, w in consts.items()}

    def fn(p, *xs):
        blobs: Dict[str, Any] = dict(p)
        for (name, _), x in zip(inputs, xs):
            blobs[name] = x.to(torch.float32)

        def get(name):
            if name not in blobs:
                raise BackendError(
                    f"dlc: blob {name!r} undefined (graph not "
                    f"topologically ordered?)")
            return blobs[name]

        for lay in compute:                 # ElementwiseBinaryOp add
            acc = get(lay.inputs[0])
            for other in lay.inputs[1:]:
                acc = acc + get(other)
            blobs[lay.outputs[0]] = acc
        outs = []
        for name in out_names:
            y = get(name)
            if u8_io:
                y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
            outs.append(y)
        return tuple(outs)

    io = [np.dtype(io_np)] * len(in_shapes)
    out_shapes, out_dtypes = probe_outputs(fn, params, in_shapes, io)
    return LoweredModel(
        fn=fn, params=params, in_shapes=in_shapes, in_dtypes=io,
        out_shapes=out_shapes, out_dtypes=out_dtypes, name="dlc")
