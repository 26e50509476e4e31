"""FlatBuffers tensor-stream codec — the schema'd binary interop format,
the JAX package's interop/flatbuf_codec.py on the port.

Reference parity: tensordec-flatbuf.cc + tensor_converter_flatbuf.cc over
the nnstreamer.fbs schema (ext/nnstreamer/include/nnstreamer.fbs):

    table Tensor  { name:string; type:int=NNS_END; dimension:[uint];
                    data:[ubyte]; }
    struct frame_rate { rate_n:int; rate_d:int; }
    table Tensors { num_tensor:int; fr:frame_rate; tensor:[Tensor];
                    format:int=0; }  // root_type Tensors

No `flatbuffers` package: frames are written by interop/flatbuf_build.py
and read by modelio/flatbuf.py's `Reader`. The vtable slot layout (slot
i → voffset 4+2i) *is* the schema contract, matching what flatc would
generate, so frames interop with any consumer compiled from
nnstreamer.fbs; the bytes differ from the stock builder's (it writes back
to front), the tables do not. Same dim/payload conventions as the
protobuf codec (innermost-first rank-4 1-padded dims;
GstTensorMetaInfo-prefixed FLEXIBLE payloads).
"""

from __future__ import annotations

import struct

import numpy as np

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.interop._codec_base import (
    host_arrays, register_codec_pair)
from nnstreamer_tpu_torch.interop.flatbuf_build import Builder
from nnstreamer_tpu_torch.interop.gst_meta import (
    check_wire_dtype,
    pack_gst_meta,
    payload_to_array,
    wire_dims,
)
from nnstreamer_tpu_torch.modelio.flatbuf import Reader
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat

_NNS_END = 10   # schema default for Tensor.type


def encode_flatbuf(buf: TensorBuffer, rate=None, tracer=None,
                   name=None) -> bytes:
    """TensorBuffer → flatbuffers frame (nnstreamer.fbs layout). CUDA
    tensors cross to the host in one counted forced sync."""
    non_static = buf.format != TensorFormat.STATIC
    frac = rate if isinstance(rate, tuple) else (rate or 0, 1)
    names = buf.meta.get("tensor_names", {})
    entries = []
    for i, arr in enumerate(host_arrays(buf, tracer, name)):
        dt = DType.from_np(arr.dtype)
        check_wire_dtype(dt)
        raw = arr.tobytes()
        if non_static:
            raw = pack_gst_meta(arr.shape, dt, buf.format) + raw
        entries.append((str(names.get(i, "")), dt, wire_dims(arr.shape), raw))

    b = Builder()
    # table Tensors: num_tensor=0, fr=1 (inline struct), tensor=2, format=3
    fields = [(1, "<ii", (int(frac[0]), int(frac[1]))), (2, None, None)]
    if buf.num_tensors:
        fields.append((0, "<i", buf.num_tensors))
    if int(buf.format):
        fields.append((3, "<i", int(buf.format)))
    root, refs = b.table(fields)
    vec = b.ref_vector(len(entries))
    b.point(refs[2], vec[0])
    for (tname, dt, dims, raw), elem in zip(entries, vec[1:]):
        # table Tensor: slots name=0, type=1, dimension=2, data=3
        fields = [(0, None, None), (2, None, None), (3, None, None)]
        if int(dt) != _NNS_END:
            fields.append((1, "<i", int(dt)))
        tab, trefs = b.table(fields)
        b.point(elem, tab)
        b.point(trefs[0], b.string(tname))
        b.point(trefs[2], b.vector(struct.pack(f"<{len(dims)}I", *dims),
                                   len(dims)))
        b.point(trefs[3], b.vector(raw, len(raw), align=16))
    return b.finish(root)


def decode_flatbuf(frame: bytes) -> TensorBuffer:
    """flatbuffers frame → TensorBuffer (host numpy)."""
    r = Reader(bytes(frame))
    try:
        root = r.root()
        num = r.field_scalar(root, 0, "<i", 0)
        fmt = TensorFormat(r.field_scalar(root, 3, "<i", 0))
        tables = r.field_vec_tables(root, 2)
    except (ValueError, IndexError, struct.error) as e:
        raise StreamError(f"corrupt flatbuf tensor frame: {e}") from None
    if num != len(tables):
        raise StreamError(
            f"flatbuf frame: num_tensor={num} but tensor vector has "
            f"{len(tables)} entries")
    arrays, names = [], {}
    for j, tab in enumerate(tables):
        try:
            name = r.field_string(tab, 0) or ""
            dt = DType(r.field_scalar(tab, 1, "<i", _NNS_END))
            dims = r.field_vec_scalars(tab, 2, np.uint32)
            dims = [] if dims is None else [int(d) for d in dims]
            if r.field_pos(tab, 3) is None:
                raise StreamError("tensor entry without data")
            raw = r.field_vec_scalars(tab, 3, np.uint8).tobytes()
        except StreamError:
            raise
        except (ValueError, IndexError, struct.error,
                UnicodeDecodeError) as e:
            raise StreamError(
                f"corrupt flatbuf tensor frame at tensor {j}: {e}") from None
        arr = payload_to_array(raw, dims, dt, fmt, f"flatbuf tensor {j}")
        arrays.append(arr)
        if name:
            names[j] = name
    meta = {"tensor_names": names} if names else {}
    return TensorBuffer(tensors=tuple(arrays), format=fmt, meta=meta)


FlatbufEncode, FlatbufDecode = register_codec_pair(
    "flatbuf", encode_flatbuf, decode_flatbuf)
