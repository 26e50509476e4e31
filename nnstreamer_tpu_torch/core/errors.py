"""Framework exception taxonomy.

Every raise names the element, the property and a suggested fix where
one is known (the reference's rule, tensor_filter.c:558-628).
"""

from __future__ import annotations

from dataclasses import dataclass


def _rebuild_error(cls, args, state):
    """Pickle reconstructor (see NNStreamerTPUError.__reduce__): rebuilds
    without calling the subclass __init__, then restores args and
    instance state verbatim."""
    exc = cls.__new__(cls)
    Exception.__init__(exc, *args)
    exc.__dict__.update(state)
    return exc


class NNStreamerTPUError(Exception):
    """Base class for all framework errors.

    Every framework error survives a pickle round trip (errors cross
    process boundaries once a worker pool ships them back over a pipe).
    Subclasses whose ``__init__`` takes other arguments
    (`ServerBusyError`) would break naive pickling, which calls
    ``cls(*args)`` again, so the base class reduces to a reconstructor
    that bypasses ``__init__`` and restores ``args`` and ``__dict__``
    exactly (the JAX package's contract)."""

    def __reduce__(self):
        return (_rebuild_error,
                (type(self), self.args, dict(self.__dict__)))


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


class SegmentStageError(BackendError):
    """A member stage of a composed device segment failed (composed or
    host-fallback invoke). Carries the *member element's* name so the
    owning head filter charges the failure to the element the user
    wrote, not to the surviving head."""

    def __init__(self, member: str, exc: BaseException):
        super().__init__(f"segment stage {member!r} failed: {exc}")
        self.member = member


class StreamError(NNStreamerTPUError):
    """Runtime dataflow failure (the GST_FLOW_ERROR analog)."""


class ServerBusyError(StreamError):
    """A remote query server refused a frame at admission (wire `BUSY`
    reply): its bounded queue was full, its outstanding-request bound was
    hit, or the frame's deadline had already passed. Carries the server's
    view of the overload so callers — and the element error-policy
    machinery — can back off: `retry:N:backoff` on the client re-offers
    after the backoff, `degrade` routes the frame to the fallback pad,
    `skip` sheds it locally."""

    def __init__(self, msg: str, *, queue_depth: int = 0,
                 retry_after_ms: float = 0.0, cause: str = "queue_full",
                 pts=None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_ms = retry_after_ms
        self.cause = cause
        self.pts = pts


class FaultInjected(StreamError):
    """Raised by the `tensor_fault` element's `mode=raise` injection —
    a distinct type so tests and policies can tell injected chaos from
    organic failures."""


class WatchdogStall(StreamError):
    """An element exceeded its stall budget (process() never returned)
    or a queue stayed at capacity beyond its budget, and the watchdog
    was configured to escalate (`watchdog_action="fail"`)."""


class CircuitOpenError(BackendError):
    """The filter's circuit breaker is open: the backend failed K
    consecutive invokes and is cooling down, so invokes are being
    short-circuited without touching the backend. Under
    `error-policy=degrade` the input buffer is served on the fallback
    pad instead; under `skip` it is dropped and counted."""


#: `error-policy` property grammar (per element, enforced by the
#: scheduler's worker loop):
#:   fail                  — any process() exception stops the pipeline
#:                           (the default)
#:   skip                  — drop the offending input buffer, count it
#:   retry:N[:backoff_ms]  — re-invoke process() up to N times with
#:                           exponential backoff (backoff_ms, 2x per
#:                           attempt); exhausted retries fall back to
#:                           skip semantics
#:   degrade               — route the *input* buffer to the element's
#:                           fallback src pad (added as its last src
#:                           pad; must be linked, e.g. to a cheaper
#:                           model branch or a sink)
@dataclass(frozen=True)
class ErrorPolicy:
    """Parsed per-element error policy (see grammar above)."""

    kind: str = "fail"            # fail | skip | retry | degrade
    retries: int = 0              # retry budget per buffer (kind=retry)
    backoff_ms: float = 10.0      # first retry delay, doubles per retry

    @staticmethod
    def parse(s: "str | ErrorPolicy") -> "ErrorPolicy":
        if isinstance(s, ErrorPolicy):
            return s
        text = str(s).strip().lower()
        if text in ("fail", "skip", "degrade"):
            return ErrorPolicy(kind=text)
        if text.startswith("retry"):
            parts = text.split(":")
            if len(parts) in (2, 3) and parts[0] == "retry":
                try:
                    retries = int(parts[1])
                    backoff = float(parts[2]) if len(parts) == 3 else 10.0
                except ValueError:
                    pass
                else:
                    if retries >= 1 and backoff >= 0:
                        return ErrorPolicy(kind="retry", retries=retries,
                                           backoff_ms=backoff)
        raise ValueError(
            f"bad error-policy {s!r}; expected one of fail | skip | "
            f"retry:N[:backoff_ms] | degrade (e.g. retry:3:50)")

    def __str__(self):
        if self.kind == "retry":
            return f"retry:{self.retries}:{self.backoff_ms:g}"
        return self.kind


#: shared default — the fail-fast contract every element starts with
FAIL_FAST = ErrorPolicy()
