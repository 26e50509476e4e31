"""Pipeline elements. Importing this package registers every built-in
element with the port's ELEMENT registry."""

from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator
from nnstreamer_tpu_torch.elements.batch import TensorBatch, TensorUnbatch
from nnstreamer_tpu_torch.elements.control import (
    TensorCrop, TensorIf, TensorRate, register_if_condition)
from nnstreamer_tpu_torch.elements.converter import (
    ConverterSubplugin, TensorConverter, register_converter)
from nnstreamer_tpu_torch.elements.debug import TensorDebug
from nnstreamer_tpu_torch.elements.decoder import TensorDecoder, register_decoder
from nnstreamer_tpu_torch.elements.fault import TensorFault
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.iio import TensorSrcIIO
from nnstreamer_tpu_torch.elements.ipc import IpcSink, IpcSrc
from nnstreamer_tpu_torch.elements.llm import TensorLLM
from nnstreamer_tpu_torch.elements.repo import REPO, TensorRepoSink, TensorRepoSrc
from nnstreamer_tpu_torch.elements.routing import (
    Join, Queue, Tee, TensorDemux, TensorMerge, TensorMux, TensorSplit)
# the python3 decoder, and the wire decoder and converter
from nnstreamer_tpu_torch.elements import script_codec, wire_codec  # noqa: F401
# tensor_query_client, tensor_query_serversrc, tensor_query_serversink;
# edgesink, edgesrc
from nnstreamer_tpu_torch.edge import pubsub as _pubsub  # noqa: F401
from nnstreamer_tpu_torch.edge import query as _query  # noqa: F401
from nnstreamer_tpu_torch.elements import mqtt  # noqa: F401  (mqttsink, mqttsrc)
# the schema'd interop codecs (decoders and converters "protobuf",
# "flatbuf", "flexbuf") and tensor_src_grpc / tensor_sink_grpc; none
# imports a package the port does not need, so they always register
from nnstreamer_tpu_torch.interop import (  # noqa: F401
    flatbuf_codec, flexbuf_codec, grpc_elements, protobuf_codec)
from nnstreamer_tpu_torch.trainer import element as _trainer  # noqa: F401
from nnstreamer_tpu_torch.elements.sinks import FakeSink, FileSink, TensorSink
from nnstreamer_tpu_torch.elements.sources import (
    AppSrc, AudioTestSrc, FileSrc, TensorSrc, VideoTestSrc)
from nnstreamer_tpu_torch.elements.sparse_elements import (
    TensorSparseDec, TensorSparseEnc)
from nnstreamer_tpu_torch.elements.transform import (
    TensorResize, TensorTransform, TransformProgram)

__all__ = [
    "AppSrc",
    "AudioTestSrc",
    "ConverterSubplugin",
    "FakeSink",
    "FileSink",
    "FileSrc",
    "IpcSink",
    "IpcSrc",
    "Join",
    "Queue",
    "REPO",
    "Tee",
    "TensorAggregator",
    "TensorBatch",
    "TensorConverter",
    "TensorCrop",
    "TensorDebug",
    "TensorDecoder",
    "TensorDemux",
    "TensorFault",
    "TensorFilter",
    "TensorIf",
    "TensorLLM",
    "TensorMerge",
    "TensorMux",
    "TensorRate",
    "TensorRepoSink",
    "TensorRepoSrc",
    "TensorResize",
    "TensorSink",
    "TensorSparseDec",
    "TensorSparseEnc",
    "TensorSplit",
    "TensorSrc",
    "TensorSrcIIO",
    "TensorTransform",
    "TensorUnbatch",
    "TransformProgram",
    "VideoTestSrc",
    "register_converter",
    "register_decoder",
    "register_if_condition",
]
