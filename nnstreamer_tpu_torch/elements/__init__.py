"""Pipeline elements. Importing this package registers every built-in
element with the port's ELEMENT registry."""

from nnstreamer_tpu_torch.elements.batch import TensorBatch, TensorUnbatch
from nnstreamer_tpu_torch.elements.control import TensorCrop
from nnstreamer_tpu_torch.elements.converter import TensorConverter
from nnstreamer_tpu_torch.elements.debug import TensorDebug
from nnstreamer_tpu_torch.elements.decoder import TensorDecoder, register_decoder
from nnstreamer_tpu_torch.elements.fault import TensorFault
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.llm import TensorLLM
from nnstreamer_tpu_torch.elements.routing import TensorDemux, TensorMux
from nnstreamer_tpu_torch.elements.sinks import FakeSink, TensorSink
from nnstreamer_tpu_torch.elements.sources import AppSrc, VideoTestSrc
from nnstreamer_tpu_torch.elements.transform import TensorTransform, TransformProgram

__all__ = [
    "AppSrc",
    "FakeSink",
    "TensorBatch",
    "TensorConverter",
    "TensorCrop",
    "TensorDebug",
    "TensorDecoder",
    "TensorDemux",
    "TensorFault",
    "TensorFilter",
    "TensorLLM",
    "TensorMux",
    "TensorSink",
    "TensorTransform",
    "TensorUnbatch",
    "TransformProgram",
    "VideoTestSrc",
    "register_decoder",
]
