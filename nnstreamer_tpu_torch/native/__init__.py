"""ctypes bindings for the native runtime library, the JAX package's
native/__init__.py on the port — built at first use.

The library is compiled from the repository's `native/nt_shmring.cc` and
`native/nt_wire.cc` with g++ and the flags of `native/Makefile`
(``-O2 -fPIC -std=c++17``, ``-shared -pthread -lrt``) into
``build/native/`` beside the package, named by a hash of the sources and
flags, under a file lock (backends/cuda_build.build_locked). So a
checkout needs no build step: the first ipc element to start builds it.
The JAX package loads a prebuilt `native/libnnstpu.so` and raises when
it is missing (ROADMAP N18). A missing g++ or a failed build raises
`BackendError` with the compiler's output; nothing falls back to another
transport.

Components:
- ShmRing — shared-memory SPSC frame ring (native/nt_shmring.cc): the
  zero-copy local IPC transport behind ipc_sink/ipc_src.
- wire_frame_size — native wire-frame validator (native/nt_wire.cc).
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional

from nnstreamer_tpu_torch.backends.cuda_build import build_locked, source_key
from nnstreamer_tpu_torch.core.errors import BackendError, StreamError

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "nt_shmring.cc", ROOT / "native" / "nt_wire.cc")
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17"]
LDFLAGS = ["-shared", "-pthread", "-lrt"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    return ROOT / "build" / "native" / (
        f"libnnstpu-{source_key(list(SOURCES), CXXFLAGS + LDFLAGS)}.so")


def build() -> Path:
    """Compile the library unless the hashed file exists → its path."""
    missing = [str(s) for s in SOURCES if not s.is_file()]
    if missing:
        raise BackendError(
            f"cannot build the native library: sources {missing} are "
            f"missing (run from a checkout of the repository)")
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise BackendError(
            "cannot build the native library (ipc_sink/ipc_src): g++ not "
            "found on PATH")
    return build_locked(
        out, lambda tmp: [cxx, *CXXFLAGS, *map(str, SOURCES), "-o",
                          str(tmp), *LDFLAGS], "libnnstpu")


def _declare(lib: ctypes.CDLL) -> None:
    lib.nt_ring_create.restype = ctypes.c_void_p
    lib.nt_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.nt_ring_open.restype = ctypes.c_void_p
    lib.nt_ring_open.argtypes = [ctypes.c_char_p]
    lib.nt_ring_write.restype = ctypes.c_int
    lib.nt_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.nt_ring_next_len.restype = ctypes.c_int64
    lib.nt_ring_next_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nt_ring_read.restype = ctypes.c_int64
    lib.nt_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64]
    lib.nt_ring_mark_closed.argtypes = [ctypes.c_void_p]
    lib.nt_ring_close.argtypes = [ctypes.c_void_p]
    lib.nt_ring_unlink.argtypes = [ctypes.c_char_p]
    lib.nt_ring_capacity.restype = ctypes.c_uint64
    lib.nt_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.nt_ring_used.restype = ctypes.c_uint64
    lib.nt_ring_used.argtypes = [ctypes.c_void_p]
    lib.nt_wire_frame_size.restype = ctypes.c_int64
    lib.nt_wire_frame_size.argtypes = [ctypes.c_char_p, ctypes.c_uint64]


def require() -> ctypes.CDLL:
    """The loaded library, built first if need be (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def wire_frame_size(data: bytes) -> int:
    """→ total frame bytes, 0 = incomplete, -1 = corrupt (native path)."""
    return int(require().nt_wire_frame_size(data, len(data)))


class ShmRing:
    """SPSC frame ring in shared memory (producer OR consumer side)."""

    def __init__(self, name: str, *, create: bool, capacity: int = 1 << 22):
        self._lib = require()
        self.name = name
        self._creator = create
        if create:
            self._h = self._lib.nt_ring_create(name.encode(), capacity)
        else:
            self._h = self._lib.nt_ring_open(name.encode())
        if not self._h:
            verb = "create" if create else "open"
            raise StreamError(
                f"cannot {verb} shared-memory ring {name!r}"
                + ("" if create else " — is the producer pipeline running?"))

    def write(self, frame: bytes, timeout_ms: int = 10_000) -> None:
        rc = self._lib.nt_ring_write(self._h, frame, len(frame), timeout_ms)
        if rc == -2:
            raise StreamError(
                f"frame of {len(frame)} bytes exceeds ring capacity "
                f"{self.capacity} (raise ipc_sink capacity=)")
        if rc == -4:
            raise StreamError(
                f"ring {self.name!r} full for {timeout_ms}ms — consumer "
                f"stalled or gone")
        if rc != 0:
            raise StreamError(f"ring {self.name!r} closed or broken ({rc})")

    def read(self, timeout_ms: int = 100) -> Optional[bytes]:
        """→ one frame, None on timeout; raises EOFError at EOS."""
        n = self._lib.nt_ring_next_len(self._h, timeout_ms)
        if n == 0:
            return None
        if n < 0:
            raise EOFError(f"ring {self.name!r} closed")
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.nt_ring_read(self._h, buf, int(n))
        if got < 0:
            if got == -1:
                raise EOFError(f"ring {self.name!r} closed")
            raise StreamError(f"ring {self.name!r} read error ({got})")
        return buf.raw[:got]

    @property
    def capacity(self) -> int:
        return int(self._lib.nt_ring_capacity(self._h))

    @property
    def used(self) -> int:
        return int(self._lib.nt_ring_used(self._h))

    def close_write(self) -> None:
        """Producer EOS: wake readers, they drain then see EOF."""
        self._lib.nt_ring_mark_closed(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.nt_ring_close(self._h)
            self._h = None
            if self._creator:
                self._lib.nt_ring_unlink(self.name.encode())
