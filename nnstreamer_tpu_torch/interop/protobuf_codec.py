"""Protobuf tensor-stream codec — schema'd interop serialization, the
JAX package's interop/protobuf_codec.py on the port.

Reference parity: tensordec-protobuf.cc + tensor_converter_protobuf.cc
(both thin wrappers over ext/nnstreamer/extra/nnstreamer_protobuf.cc).
Unlike edge/wire.py (the private schema-free codec), this format is a
published contract: any external process holding tensors.proto —
including an unmodified nnstreamer with its protobuf subplugins — can
produce and consume these frames. The messages come from
interop/tensors_proto.py (no `google.protobuf`), and a frame is byte for
byte what the generated classes serialize for the same buffer and rate.

Pipeline usage mirrors the reference:

    ... ! tensor_decoder mode=protobuf ! <byte transport> !
    tensor_converter mode=custom:protobuf ! ...

Format semantics (from nnstreamer_protobuf.cc:60-200):
  - dimension[] is innermost-first (reverse numpy shape), padded with 1
    to rank 4. Rank is not on the wire, so decode canonicalizes by
    stripping trailing 1-dims.
  - FLEXIBLE/SPARSE: each data blob is prefixed with a GstTensorMetaInfo
    v1 header (interop/gst_meta.py), which preserves exact rank/shape;
    the padded dims are advisory.
  - float16/bfloat16 have no slot in the 10-value enum; encoding them
    raises with a typecast hint rather than shipping wrong bytes.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.interop import tensors_proto as pb
from nnstreamer_tpu_torch.interop._codec_base import (
    host_arrays, register_codec_pair)
from nnstreamer_tpu_torch.interop.gst_meta import (
    check_wire_dtype,
    pack_gst_meta,
    payload_to_array,
    wire_dims,
)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat


def buffer_to_msg(buf: TensorBuffer, rate=None, tracer=None,
                  name=None) -> pb.Tensors:
    """TensorBuffer → nnstreamer.protobuf.Tensors message. CUDA tensors
    cross to the host in one counted forced sync (traced on `tracer`
    under element `name`)."""
    msg = pb.Tensors(num_tensor=buf.num_tensors, format=int(buf.format))
    if rate is not None and rate:
        frac = rate if isinstance(rate, tuple) else (rate, 1)
        msg.fr = pb.FrameRate(int(frac[0]), int(frac[1]))
    non_static = buf.format != TensorFormat.STATIC
    names = buf.meta.get("tensor_names", {})
    for i, arr in enumerate(host_arrays(buf, tracer, name)):
        dt = DType.from_np(arr.dtype)
        check_wire_dtype(dt)
        raw = arr.tobytes()
        if non_static:
            # flexible/sparse payloads carry a GstTensorMetaInfo header
            # so exact shape survives the rank-4 dims
            # (nnstreamer_protobuf.cc:80, is_flexible branch)
            raw = pack_gst_meta(arr.shape, dt, buf.format) + raw
        msg.tensor.append(pb.Tensor(name=str(names.get(i, "")),
                                    type=int(dt),
                                    dimension=wire_dims(arr.shape),
                                    data=raw))
    return msg


def encode_protobuf(buf: TensorBuffer, rate=None, tracer=None,
                    name=None) -> bytes:
    """TensorBuffer → serialized Tensors frame."""
    return buffer_to_msg(buf, rate, tracer, name).SerializeToString()


def decode_protobuf(frame: bytes) -> TensorBuffer:
    """Serialized Tensors frame → TensorBuffer (host numpy)."""
    try:
        msg = pb.Tensors.FromString(bytes(frame))
    except (ValueError, UnicodeDecodeError) as e:
        raise StreamError(f"corrupt protobuf tensor frame: {e}") from None
    return msg_to_buffer(msg)


def msg_to_buffer(msg: pb.Tensors) -> TensorBuffer:
    """Tensors message → TensorBuffer (host numpy)."""
    try:
        fmt = TensorFormat(msg.format)
    except ValueError as e:
        raise StreamError(f"corrupt protobuf tensor frame: {e}") from None
    arrays, names = [], {}
    for i, entry in enumerate(msg.tensor):
        try:
            dt = DType(entry.type)
        except ValueError as e:
            raise StreamError(
                f"corrupt protobuf tensor frame: tensor #{i}: {e}") from None
        arr = payload_to_array(entry.data, entry.dimension, dt, fmt,
                               f"protobuf tensor #{i}")
        arrays.append(arr)
        if entry.name:
            names[i] = entry.name
    meta = {"tensor_names": names} if names else {}
    return TensorBuffer(tensors=tuple(arrays), format=fmt, meta=meta)


ProtobufEncode, ProtobufDecode = register_codec_pair(
    "protobuf", encode_protobuf, decode_protobuf)
