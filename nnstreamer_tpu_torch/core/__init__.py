"""Core plumbing services — config, registry, logging, errors."""

from nnstreamer_tpu_torch.core.config import Config, get_config
from nnstreamer_tpu_torch.core.errors import (
    BackendError,
    ConfigError,
    NegotiationError,
    PipelineError,
    StreamError,
)
from nnstreamer_tpu_torch.core.registry import PluginKind, registry

__all__ = [
    "BackendError",
    "ConfigError",
    "NegotiationError",
    "PipelineError",
    "StreamError",
    "Config",
    "get_config",
    "PluginKind",
    "registry",
]
