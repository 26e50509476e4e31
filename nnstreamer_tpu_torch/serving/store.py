"""Process-wide versioned model registry + epoch-based hot swap
(counterpart of the JAX package's serving/store.py; the port keeps its
own copy).

A ``store://`` ref names a *served model*; versions are immutable once
registered, and an update is a controlled swap:

1. ``update(name, version)`` resolves and builds the incoming version
   off the hot path;
2. every attached handle pre-warms it (``prewarm_version``): the torch
   backend stages the version's params on its device and runs it once
   on every bucket shape it has served, tensor_llm's executor checks the
   cache geometry and places the params — and a version that refuses
   aborts the swap *before* anything flips;
3. the entry's ``(current, epoch)`` state flips in one atomic tuple
   assignment;
4. handles adopt at their next invoke (step) boundary (each element has
   ONE worker thread, so an invoke sees the old snapshot or the new one,
   never a torn version), installing what was staged and retiring the
   outgoing version's captured graphs.

Canary splits ride the same routing point: ``store://name@2:0.05`` sends
a deterministic, seeded 5% of invokes to version 2 while the remainder
tracks ``current``; per-version invoke/error/latency counters
(`stats_dict`) make the comparison readable from ``tensor_filter`` stats.
Zoo builtins seed as version ``@0``; the buckets each version served go
to the persistent manifest (serving/compile_cache.py) when it is on.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.runtime.tracing import percentile

log = get_logger("serving.store")

VersionSpec = Union[int, str, None]


@dataclass(frozen=True)
class StoreRef:
    """Parsed ``store://`` model reference.

    ``version`` None means *track current* (hot-swappable); an int or
    alias pins the backend to that version (immune to swaps).
    ``canary_version``/``canary_ratio`` describe a weighted split
    against the tracked current version.
    """

    name: str
    version: VersionSpec = None
    canary_version: VersionSpec = None
    canary_ratio: float = 0.0


def parse_store_ref(ref: str) -> StoreRef:
    """``store://name[@version[:ratio]]`` → :class:`StoreRef`.

    - ``store://det``            track current (swaps apply)
    - ``store://det@latest``     same as above
    - ``store://det@3``          pinned to version 3
    - ``store://det@prod``       pinned via alias
    - ``store://det@2:0.05``     canary: 5% of invokes to version 2,
      the rest track current
    """
    if not isinstance(ref, str) or not ref.startswith("store://"):
        raise BackendError(f"not a store reference: {ref!r}")
    body = ref[len("store://"):]
    name, _, vpart = body.partition("@")
    if not name:
        raise BackendError(f"store reference {ref!r} has no model name")
    if not vpart:
        return StoreRef(name=name)
    vspec, _, ratio = vpart.partition(":")
    version: VersionSpec = vspec
    if vspec.lstrip("-").isdigit():
        version = int(vspec)
    elif vspec == "latest" or vspec == "":
        version = None
    if not ratio:
        return StoreRef(name=name, version=version)
    try:
        r = float(ratio)
    except ValueError:
        raise BackendError(
            f"bad canary ratio {ratio!r} in {ref!r}; expected a float "
            f"in (0, 1) like store://{name}@2:0.05") from None
    if not (0.0 < r < 1.0):
        raise BackendError(
            f"canary ratio {r} in {ref!r} out of range; must be in "
            f"(0, 1) exclusive (1.0 would be a full swap — use "
            f"ModelStore.update instead)")
    if version is None:
        raise BackendError(
            f"canary reference {ref!r} needs an explicit version to "
            f"canary (store://{name}@<version>:{ratio})")
    return StoreRef(name=name, canary_version=version, canary_ratio=r)


class _VersionStats:
    """Per-version serving counters (invokes/errors + proctime
    reservoir → p95). Appends come from element worker threads; the
    tiny lock keeps the counts exact for canary comparisons."""

    __slots__ = ("invokes", "errors", "_times", "_lock")

    def __init__(self):
        self.invokes = 0
        self.errors = 0
        self._times: deque = deque(maxlen=512)
        self._lock = threading.Lock()

    def record(self, dt_s: float, error: bool) -> None:
        with self._lock:
            self.invokes += 1
            if error:
                self.errors += 1
            else:
                self._times.append(dt_s)

    def as_dict(self) -> dict:
        with self._lock:
            vals = sorted(self._times)
            return {
                "invokes": self.invokes,
                "errors": self.errors,
                "p95_us": round(1e6 * percentile(vals, 95), 1),
            }


@dataclass
class _Version:
    """One immutable registered version: a bundle, or a zero-arg
    builder deferred until first resolution."""

    version: int
    source: str = ""
    builder: Optional[Callable[[], Any]] = None
    _bundle: Any = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def bundle(self):
        if self._bundle is not None:
            return self._bundle
        with self._lock:
            if self._bundle is None:
                self._bundle = _as_bundle(self.builder(), self.source)
            return self._bundle


def _as_bundle(model, source: str):
    """Accept a ModelBundle directly; resolve strings and callables
    through the torch backend's model resolution (zoo://, model files,
    callables)."""
    from nnstreamer_tpu_torch.backends.torch_backend import (
        ModelBundle, TorchBackend)

    if isinstance(model, ModelBundle):
        return model
    try:
        return TorchBackend()._resolve(model)
    except BackendError as e:
        raise BackendError(
            f"model store could not resolve {source or model!r}: {e}"
        ) from e


class _Entry:
    """One served model name: its versions, aliases, the atomic
    ``(current_version, epoch)`` state, attached backend handles, and
    per-version stats/bucket records."""

    def __init__(self, name: str):
        self.name = name
        self.versions: Dict[int, _Version] = {}
        self.aliases: Dict[str, int] = {}
        #: single-tuple assignment = the atomic swap point: readers
        #: (backend invoke paths) load it once and see a consistent pair
        self._state: Tuple[Optional[int], int] = (None, 0)
        self.lock = threading.RLock()          # registration/swap serial
        self._handles: List[weakref.ref] = []
        self._stats: Dict[int, _VersionStats] = {}
        self._buckets: Dict[int, set] = {}
        self.swap_log: List[dict] = []

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> Tuple[Optional[int], int]:
        return self._state

    @property
    def current(self) -> Optional[int]:
        return self._state[0]

    @property
    def epoch(self) -> int:
        return self._state[1]

    # -- versions ----------------------------------------------------------
    def add_version(self, version: int, *, bundle=None, builder=None,
                    source: str = "") -> None:
        with self.lock:
            existing = self.versions.get(version)
            if existing is not None:
                raise BackendError(
                    f"model store already holds {self.name!r}@{version} "
                    f"(registered from {existing.source or 'a bundle'}); "
                    f"versions are immutable — register the new weights "
                    f"under a new version and ModelStore.update() to it")
            self.versions[version] = _Version(
                version=version, source=source,
                builder=builder, _bundle=bundle)
            if self._state[0] is None:
                self._state = (version, self._state[1])

    def resolve_version(self, spec: VersionSpec) -> int:
        cur, _ = self._state
        if spec is None or spec == "latest":
            if cur is None:
                raise BackendError(
                    f"model {self.name!r} has no versions registered")
            return cur
        if isinstance(spec, str) and spec.lstrip("-").isdigit():
            spec = int(spec)
        if isinstance(spec, str):
            v = self.aliases.get(spec)
            if v is None:
                raise BackendError(
                    f"model {self.name!r} has no version alias {spec!r}; "
                    f"aliases: {sorted(self.aliases) or '(none)'}, "
                    f"versions: {sorted(self.versions)}")
            return v
        if spec not in self.versions:
            raise BackendError(
                f"model {self.name!r} has no version {spec}; registered "
                f"versions: {sorted(self.versions)}")
        return int(spec)

    def bundle(self, version: int):
        return self.versions[version].bundle()

    # -- handles (attached backends) ---------------------------------------
    def attach(self, handle) -> None:
        with self.lock:
            self._handles = [r for r in self._handles if r() is not None]
            self._handles.append(weakref.ref(handle))

    def detach(self, handle) -> None:
        with self.lock:
            self._handles = [r for r in self._handles
                             if r() is not None and r() is not handle]

    def live_handles(self) -> list:
        with self.lock:
            out = [r() for r in self._handles]
        return [h for h in out if h is not None]

    # -- per-version serving stats -----------------------------------------
    def record(self, version: int, dt_s: float, error: bool = False) -> None:
        s = self._stats.get(version)
        if s is None:
            s = self._stats.setdefault(version, _VersionStats())
        s.record(dt_s, error)

    def stats_dict(self) -> Dict[int, dict]:
        return {v: s.as_dict() for v, s in sorted(self._stats.items())}

    def note_bucket(self, version: int, bucket_key: tuple) -> None:
        """Record a served bucket (first time only) so swaps can
        pre-warm it and the persistent manifest can replay it on the
        next process start."""
        s = self._buckets.setdefault(version, set())
        if bucket_key in s:
            return
        s.add(bucket_key)
        from nnstreamer_tpu_torch.serving.compile_cache import record_bucket

        record_bucket(self.name, version, bucket_key)

    def buckets(self, version: int) -> list:
        return sorted(self._buckets.get(version, ()))


class ModelStore:
    """The process-wide versioned registry ``store://`` refs resolve
    through. One instance per process (``get_store()``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, model: Any = None, *,
                 builder: Optional[Callable[[], Any]] = None,
                 version: Optional[int] = None,
                 source: str = "") -> int:
        """Register `model` (ModelBundle | str ref | callable) — or
        a lazy zero-arg `builder` — as a new immutable version of
        `name`. Auto-versions from 1 upward (version 0 is the zoo
        seed). The first registered version becomes ``current``; later
        ones serve only after an explicit :meth:`update` (zero-downtime
        contract: registration never changes what's being served)."""
        if (model is None) == (builder is None):
            raise BackendError(
                "ModelStore.register needs exactly one of model= or "
                "builder=")
        with self._lock:
            e = self._entries.setdefault(name, _Entry(name))
            with e.lock:
                if version is None:
                    version = max(e.versions, default=0) + 1
                src = source or (model if isinstance(model, str)
                                 else f"{name}@{version}")
                if builder is not None:
                    e.add_version(version, builder=builder, source=src)
                elif isinstance(model, str):
                    ref = model
                    e.add_version(version, source=src,
                                  builder=lambda: ref)
                else:
                    e.add_version(version,
                                  bundle=_as_bundle(model, src),
                                  source=src)
        log.info("registered %s@%d (%s)", name, version, src)
        return version

    def seed_zoo(self, name: str, zoo_builder: Callable) -> None:
        """Seed a zoo builtin as version ``@0`` (idempotent — reseeding
        after reset_store() is a no-op when @0 already exists)."""
        with self._lock:
            e = self._entries.setdefault(name, _Entry(name))
            with e.lock:
                if 0 in e.versions:
                    return
                e.add_version(0, builder=lambda: zoo_builder(),
                              source=f"zoo://{name}")

    def alias(self, name: str, alias: str, version: VersionSpec) -> None:
        e = self.entry(name)
        with e.lock:
            e.aliases[alias] = e.resolve_version(version)

    # -- lookup ------------------------------------------------------------
    def entry(self, name: str) -> _Entry:
        """The entry for `name`, pulling a zoo seed on miss so
        ``store://<zoo name>`` works without prior registration."""
        with self._lock:
            e = self._entries.get(name)
        if e is not None and e.versions:
            return e
        from nnstreamer_tpu_torch.models import zoo

        b = zoo.builder(name)
        if b is not None:
            self.seed_zoo(name, b)
            with self._lock:
                return self._entries[name]
        raise BackendError(
            f"model store has no model named {name!r}; registered: "
            f"{self.names() or '(none)'} (zoo builtins seed "
            f"automatically as @0)")

    def names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items() if e.versions)

    def describe(self, name: str) -> dict:
        e = self.entry(name)
        cur, epoch = e.state
        return {
            "name": name,
            "current": cur,
            "epoch": epoch,
            "versions": {
                v: {"source": ver.source,
                    "built": ver._bundle is not None,
                    "buckets": len(e.buckets(v))}
                for v, ver in sorted(e.versions.items())},
            "aliases": dict(e.aliases),
            "handles": len(e.live_handles()),
            "stats": e.stats_dict(),
            "swaps": list(e.swap_log),
        }

    # -- the swap controller ----------------------------------------------
    def update(self, name: str, version: VersionSpec = None, *,
               prewarm: bool = True,
               wait_s: Optional[float] = None) -> dict:
        """Hot-swap `name` to `version` (default: highest registered).

        Pre-warms the incoming version on every attached handle (the
        bucket shapes the outgoing version served run once on it — a
        version that rejects those shapes aborts the swap here, before
        anything flips), then flips ``(current, epoch)`` atomically.
        With `wait_s`, blocks until every tracking backend has adopted
        the new epoch (the swap barrier) or the deadline passes —
        adoption happens at invoke boundaries, so the barrier only
        completes while traffic flows.
        """
        e = self.entry(name)
        with e.lock:
            if version is None:
                target = max(e.versions)
            else:
                target = e.resolve_version(version)
            old, epoch = e.state
            bundle = e.bundle(target)        # build off the hot path
            handles = e.live_handles()
            warmed = 0
            if prewarm and target != old:
                for h in handles:
                    warmed += int(h.prewarm_version(target, bundle))
            new_epoch = epoch + 1
            e._state = (target, new_epoch)   # THE flip
            report = {
                "name": name, "from_version": old, "to_version": target,
                "epoch": new_epoch, "handles": len(handles),
                "prewarm": bool(prewarm), "prewarmed_buckets": warmed,
                "ts": time.time(),
            }
            e.swap_log.append(report)
        if wait_s:
            deadline = time.monotonic() + float(wait_s)

            def lagging():
                return [h for h in e.live_handles()
                        if getattr(h, "tracks_store_epoch", False)
                        and getattr(h, "adopted_epoch", new_epoch)
                        < new_epoch]

            while lagging() and time.monotonic() < deadline:
                time.sleep(0.002)
            report["barrier_ok"] = not lagging()
        log.info("swap %s: @%s → @%s epoch=%d prewarmed=%d handles=%d",
                 name, old, target, new_epoch, warmed, len(handles))
        return report


_store: Optional[ModelStore] = None
_store_lock = threading.Lock()


def get_store() -> ModelStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = ModelStore()
        return _store


def reset_store() -> ModelStore:
    """Replace the process store (tests). Zoo builtins re-seed lazily on
    the next ``store://`` resolution."""
    global _store
    with _store_lock:
        _store = ModelStore()
        return _store
