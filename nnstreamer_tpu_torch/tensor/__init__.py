"""Tensor data model — dtypes, stream specs, buffers."""

from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import (
    MediaType, TensorFormat, TensorInfo, TensorsSpec)

__all__ = [
    "DType",
    "TensorInfo",
    "TensorsSpec",
    "TensorFormat",
    "MediaType",
    "TensorBuffer",
]
