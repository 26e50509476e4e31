"""nnstreamer_tpu_torch — the streaming-AI framework on PyTorch and CUDA.

The port of `nnstreamer_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100, kept beside it with the same module layout and public names. It
imports torch and numpy, never jax, and nothing of `nnstreamer_tpu`.

  tensor/    — dtypes, TensorInfo/TensorsSpec, buffers
  core/      — config, subplugin registry, logging, errors
  graph/     — pipeline graph, gst-launch-style DSL, negotiation, fusion
  runtime/   — push-model scheduler, channels, the host-sync choke point
  elements/  — sources, converter, transform and resize, filter,
               decoder, routing (mux, merge, split, tee, join, queue),
               control (tensor_if, tensor_rate, tensor_crop),
               aggregator, repo loops, sparse codec, sinks, tensor_llm
  backends/  — the torch model engine, the paged-LLM executor and the
               hand-written CUDA kernels
  models/    — MobileNetV2 and the transformer in PyTorch, the zoo, the
               JAX weights bridge
  llm/       — paged KV cache, paged reference math, serving engine
  serving/   — the versioned model store, its bucket manifest, tenancy
  traffic/   — admission control (bounded, weighted-fair, typed BUSY)
  edge/      — the wire format, TCP transport, query client/server and
               the batching query server, the edge broker
  parallel/  — meshes, ring attention, the one-card batch dispatcher
  decoders/  — image_labeling, bounding boxes, pose, segment, video,
               octet stream
  single.py  — SingleShot, one model without a pipeline

Entry points run on the CUDA device unless the caller asks for the CPU
(`accelerator=cpu` on a tensor_filter, or
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu).
"""

__version__ = "0.1.0"

from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorInfo, TensorsSpec

__all__ = [
    "DType",
    "TensorInfo",
    "TensorsSpec",
    "TensorFormat",
    "TensorBuffer",
    "Pipeline",
    "parse_launch",
    "run_pipeline",
    "PipelineRunner",
    "StreamError",
    "TensorLLM",
    "SingleShot",
    "__version__",
]

_LAZY = {
    "Pipeline": ("nnstreamer_tpu_torch.graph.pipeline", "Pipeline"),
    "parse_launch": ("nnstreamer_tpu_torch.graph.parse", "parse_launch"),
    "run_pipeline": ("nnstreamer_tpu_torch.runtime.scheduler", "run_pipeline"),
    "PipelineRunner": ("nnstreamer_tpu_torch.runtime.scheduler",
                       "PipelineRunner"),
    "StreamError": ("nnstreamer_tpu_torch.core.errors", "StreamError"),
    "TensorLLM": ("nnstreamer_tpu_torch.elements.llm", "TensorLLM"),
    "SingleShot": ("nnstreamer_tpu_torch.single", "SingleShot"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
