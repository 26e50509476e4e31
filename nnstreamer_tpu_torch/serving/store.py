"""Process-wide versioned model registry + epoch-based hot swap
(counterpart of the JAX package's serving/store.py; the port keeps its
own copy).

A ``store://`` ref names a *served model*; versions are immutable once
registered, and an update is a controlled swap:

1. ``update(name, version)`` resolves and builds the incoming version
   off the hot path;
2. every attached handle pre-warms it (``prewarm_version``) — for
   tensor_llm's executor, a geometry check and the placement of the new
   params on its device — and may refuse it *before* anything flips;
3. the entry's ``(current, epoch)`` state flips in one atomic tuple
   assignment;
4. handles adopt at their next step boundary (each element has ONE
   worker thread, so a step sees the old snapshot or the new one, never
   a torn version).

Zoo builtins seed as version ``@0``. Version aliases, canary routing,
per-version serving stats, the swap barrier and the persistent bucket
manifest (serving/compile_cache) are still to be ported: refs parse in
full, ``note_bucket`` keeps its record in memory only.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("serving.store")

VersionSpec = Union[int, str, None]


@dataclass(frozen=True)
class StoreRef:
    """Parsed ``store://`` model reference.

    ``version`` None means *track current* (hot-swappable); an int or
    alias pins the handle to that version (immune to swaps).
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
    - ``store://det@prod``       pinned via alias (aliases are not
      ported yet: resolving one raises)
    - ``store://det@2:0.05``     canary: 5% to version 2, the rest track
      current
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
    """Accept a ModelBundle directly; resolve zoo:// strings and
    callables through the torch backend's model resolution."""
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
    """One served model name: its versions, the atomic
    ``(current_version, epoch)`` state, attached handles, and the
    buckets each version has served."""

    def __init__(self, name: str):
        self.name = name
        self.versions: Dict[int, _Version] = {}
        #: single-tuple assignment = the atomic swap point: readers load
        #: it once and see a consistent (version, epoch) pair
        self._state: Tuple[Optional[int], int] = (None, 0)
        self.lock = threading.RLock()          # registration/swap serial
        self._handles: List[weakref.ref] = []
        self._buckets: Dict[int, set] = {}

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> Tuple[Optional[int], int]:
        return self._state

    @property
    def current(self) -> Optional[int]:
        return self._state[0]

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
            raise BackendError(
                f"model {self.name!r}: version alias {spec!r} — aliases "
                f"are not ported yet; pin a version number, one of "
                f"{sorted(self.versions)}")
        if spec not in self.versions:
            raise BackendError(
                f"model {self.name!r} has no version {spec}; registered "
                f"versions: {sorted(self.versions)}")
        return int(spec)

    def bundle(self, version: int):
        return self.versions[version].bundle()

    # -- handles (attached executors) --------------------------------------
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

    def note_bucket(self, version: int, bucket_key: tuple) -> None:
        """Record a served bucket (first time only) so a swap can
        pre-warm it. In memory only: the persistent manifest waits for
        the port of serving/compile_cache."""
        self._buckets.setdefault(version, set()).add(bucket_key)

    def buckets(self, version: int) -> list:
        return sorted(self._buckets.get(version, ()))


class ModelStore:
    """The process-wide versioned registry ``store://`` refs resolve
    through. One instance per process (``get_store()``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, model: Any) -> int:
        """Register `model` (ModelBundle | zoo:// ref | callable) as a new
        immutable version of `name`, numbered from 1 upward (version 0 is
        the zoo seed). The first registered version becomes ``current``;
        later ones serve only after an explicit :meth:`update`
        (registration never changes what is being served)."""
        with self._lock:
            e = self._entries.setdefault(name, _Entry(name))
            with e.lock:
                version = max(e.versions, default=0) + 1
                src = model if isinstance(model, str) else f"{name}@{version}"
                e.add_version(version, bundle=_as_bundle(model, src),
                              source=src)
        log.info("registered %s@%d (%s)", name, version, src)
        return version

    def seed_zoo(self, name: str, zoo_builder: Callable) -> None:
        """Seed a zoo builtin as version ``@0`` (idempotent)."""
        with self._lock:
            e = self._entries.setdefault(name, _Entry(name))
            with e.lock:
                if 0 in e.versions:
                    return
                e.add_version(0, builder=lambda: zoo_builder(),
                              source=f"zoo://{name}")

    # -- lookup ------------------------------------------------------------
    def entry(self, name: str) -> _Entry:
        """The entry for `name`, pulling a zoo seed on miss so
        ``store://<zoo name>`` works without prior registration."""
        with self._lock:
            e = self._entries.get(name)
        if e is not None and e.versions:
            return e
        from nnstreamer_tpu_torch.models import zoo

        builder = zoo.builder(name)
        if builder is not None:
            self.seed_zoo(name, builder)
            with self._lock:
                return self._entries[name]
        raise BackendError(
            f"model store has no model named {name!r}; registered: "
            f"{self.names() or '(none)'} (zoo builtins seed "
            f"automatically as @0)")

    def names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items() if e.versions)

    # -- the swap controller ----------------------------------------------
    def update(self, name: str, version: VersionSpec = None) -> dict:
        """Hot-swap `name` to `version` (default: highest registered).

        Pre-warms the incoming version on every attached handle (a
        handle that refuses it aborts the swap here, before anything
        flips), then flips ``(current, epoch)`` atomically. Handles adopt
        at their next step boundary."""
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
            if target != old:
                for h in handles:
                    warmed += int(h.prewarm_version(target, bundle))
            new_epoch = epoch + 1
            e._state = (target, new_epoch)   # THE flip
            report = {
                "name": name, "from_version": old, "to_version": target,
                "epoch": new_epoch, "handles": len(handles),
                "prewarmed_buckets": warmed,
            }
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
