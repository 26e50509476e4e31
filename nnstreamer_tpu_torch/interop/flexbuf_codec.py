"""FlexBuffers tensor-stream codec — schema-less interop serialization,
the JAX package's interop/flexbuf_codec.py on the port.

Reference parity: tensordec-flexbuf.cc + tensor_converter_flexbuf.cc.
FlexBuffers is flatbuffers' schema-less sibling; the layout here is the
reference's documented map (tensordec-flexbuf.cc:26-41,:139-168):

    Map {
      "num_tensors": UInt,
      "rate_n": Int, "rate_d": Int, "format": Int,
      "tensor_#i": Vector [ name:String, type:Int,
                            dimension:TypedVector<Int> (rank-4, 1-padded),
                            data:Blob ],
    }

Any process with a flexbuffers library reads these frames without this
code or a schema file. Encode with interop/flexbuf_write.py and decode
with interop/flexbuf_read.py: no `flatbuffers` package either way.
FLEXIBLE/SPARSE data blobs are GstTensorMetaInfo-prefixed exactly like
the reference (is_flexible branch, tensordec-flexbuf.cc:147).
"""

from __future__ import annotations

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.interop import flexbuf_write as fw
from nnstreamer_tpu_torch.interop._codec_base import (
    host_arrays, register_codec_pair)
from nnstreamer_tpu_torch.interop.flexbuf_read import flexbuf_loads
from nnstreamer_tpu_torch.interop.gst_meta import (
    check_wire_dtype,
    pack_gst_meta,
    payload_to_array,
    wire_dims,
)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat


def encode_flexbuf(buf: TensorBuffer, rate=None, tracer=None,
                   name=None) -> bytes:
    """TensorBuffer → flexbuffers frame (reference map layout). CUDA
    tensors cross to the host in one counted forced sync."""
    non_static = buf.format != TensorFormat.STATIC
    frac = rate if isinstance(rate, tuple) else (rate or 0, 1)
    names = buf.meta.get("tensor_names", {})
    root = {"num_tensors": fw.Uint(buf.num_tensors),
            "rate_n": int(frac[0]), "rate_d": int(frac[1]),
            "format": int(buf.format)}
    for i, arr in enumerate(host_arrays(buf, tracer, name)):
        dt = DType.from_np(arr.dtype)
        check_wire_dtype(dt)
        raw = arr.tobytes()
        if non_static:
            raw = pack_gst_meta(arr.shape, dt, buf.format) + raw
        root[f"tensor_{i}"] = [str(names.get(i, "")), int(dt),
                               fw.Ints(wire_dims(arr.shape)), raw]
    return fw.dumps(root)


def decode_flexbuf(frame: bytes) -> TensorBuffer:
    """flexbuffers frame → TensorBuffer (host numpy)."""
    try:
        root = flexbuf_loads(bytes(frame))
        if not isinstance(root, dict):
            raise ValueError("frame root is not a map")
        num = int(root["num_tensors"])
        fmt = (TensorFormat(int(root["format"])) if "format" in root
               else TensorFormat.STATIC)  # older frames omit the key
    except Exception as e:
        raise StreamError(f"corrupt flexbuf tensor frame: {e}") from None
    arrays, names = [], {}
    for i in range(num):
        try:
            name, ty, dims, raw = root[f"tensor_{i}"]
            dt = DType(int(ty))
        except Exception as e:
            raise StreamError(
                f"corrupt flexbuf tensor frame at tensor_{i}: {e}"
            ) from None
        arr = payload_to_array(raw, dims, dt, fmt, f"flexbuf tensor_{i}")
        arrays.append(arr)
        if name:
            names[i] = name
    meta = {"tensor_names": names} if names else {}
    return TensorBuffer(tensors=tuple(arrays), format=fmt, meta=meta)


FlexbufEncode, FlexbufDecode = register_codec_pair(
    "flexbuf", encode_flexbuf, decode_flexbuf)
