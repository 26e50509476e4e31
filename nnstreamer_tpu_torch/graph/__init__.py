"""Pipeline graph: elements, links, static negotiation, string DSL."""

from nnstreamer_tpu_torch.graph.media import MediaSpec, TextSpec, VideoSpec
from nnstreamer_tpu_torch.graph.parse import parse_launch
from nnstreamer_tpu_torch.graph.pipeline import (
    Element, Pipeline, SinkElement, SourceElement)

__all__ = [
    "MediaSpec",
    "VideoSpec",
    "TextSpec",
    "Element",
    "SourceElement",
    "SinkElement",
    "Pipeline",
    "parse_launch",
]
