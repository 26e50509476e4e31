"""Framework exception taxonomy.

Every raise names the element, the property and a suggested fix where
one is known (the reference's rule, tensor_filter.c:558-628).
"""

from __future__ import annotations


class NNStreamerTPUError(Exception):
    """Base class for all framework errors."""


class ConfigError(NNStreamerTPUError):
    """Bad configuration file / env var / property value."""


class NegotiationError(NNStreamerTPUError):
    """Static shape/dtype negotiation failed between two linked elements,
    raised at pipeline build time — never in the steady-state loop."""


class PipelineError(NNStreamerTPUError):
    """Malformed pipeline description or graph structure."""


class BackendError(NNStreamerTPUError):
    """A filter backend (torch / pallas kernels) failed to open, build a
    kernel, or invoke."""


class StreamError(NNStreamerTPUError):
    """Runtime dataflow failure (the GST_FLOW_ERROR analog)."""
