"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``backends/csrc/`` exports a plain C interface
and is compiled on first use with ``nvcc`` straight into a shared
library, loaded with ctypes. PyTorch's own extension builder is not used:
it needs ninja and compiles PyTorch's headers, which takes minutes where
a plain-C source takes seconds.

- The library lands in the kernel directory ([build] kernel_dir, by
  default ``build/torch_kernels`` beside the package), named by a hash of
  the source and the flags, so an edited source or flag rebuilds.
- A file lock serialises processes that build the same library at once;
  the finished file is renamed into place, so a reader never sees half
  (`build_locked`, which the native library's g++ build shares).
- A missing ``nvcc`` or a failed build raises `BackendError`. Nothing
  falls back to the plain version.

Every wrapper launches through a `Launcher`: the C launcher resolved once,
then per call only the device check, one C call for the current stream,
the ctypes call and the test of its return (`Launcher.__call__`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

import torch

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("cuda_build")

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
#: sm_90a: Hopper with its architecture-specific instructions
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
#: source → the exported functions whose signatures are declared
_declared: Dict[str, set] = {}
_lock = threading.Lock()


def kernel_dir() -> Path:
    d = get_config().get("build", "kernel_dir")
    if d:
        return Path(d).expanduser()
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BackendError(
            "cannot build the CUDA kernels: nvcc not found (looked in "
            "$CUDA_HOME/bin, /usr/local/cuda/bin and PATH). Install the CUDA "
            "toolkit on this machine; the port does not fall back to its "
            "plain torch kernels on a CUDA device")
    return found


def source_key(sources: List[Path], flags: List[str]) -> str:
    """Hash of the sources' bytes and the flags: the library's name."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(source: str, flags: List[str] = NVCC_FLAGS) -> Path:
    key = source_key([CSRC / source], flags)
    return kernel_dir() / f"{Path(source).stem}-{key}.so"


def build_locked(out: Path, command: Callable[[Path], List[str]],
                 what: str) -> Path:
    """Run the compiler `command(tmp)` unless `out` exists, under a file
    lock beside it, then rename its output into place → `out`. The
    compiler's output is kept beside the library, same name with the
    suffix ``.log``; a failed build raises `BackendError` with it."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = command(tmp)
            log.info("building %s: %s", what, " ".join(cmd))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise BackendError(
                    f"{Path(cmd[0]).name} failed ({proc.returncode}) "
                    f"building {what}:\n{proc.stderr[-4000:]}")
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build(source: str, flags: List[str] = NVCC_FLAGS) -> Path:
    """Compile `csrc/<source>` unless the hashed library exists → path.
    The compiler's resource report (-Xptxas -v) is kept beside it, same
    name with the suffix ``.log``."""
    out = library_path(source, flags)
    if out.exists():
        return out
    nvcc = find_nvcc()
    return build_locked(
        out, lambda tmp: [nvcc, *flags, "-o", str(tmp), str(CSRC / source)],
        source)


def load(source: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<source>`, once
    per process. `signatures` maps each exported function to its
    (argtypes, restype), declared the first time the function is asked
    for (one source may export several launchers); pointers must be
    c_void_p, or ctypes cuts them to 32 bits."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            signatures = {"nns_error_string": ([ctypes.c_int],
                                               ctypes.c_char_p), **signatures}
            _loaded[source] = lib
        declared = _declared.setdefault(source, set())
        for name, (argtypes, restype) in signatures.items():
            if name not in declared:
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
                declared.add(name)
        return lib


#: torch's C hooks, bound at the first launch (torch built for the CPU
#: has none of them): the calling thread's current device, and a device's
#: current stream as an int — the call PyTorch's own generated launchers
#: make; the public ``current_stream`` builds a Stream object
_thread_device = None
_raw_stream = None


def _bind_torch() -> None:
    global _thread_device, _raw_stream
    c = torch._C
    _thread_device = getattr(c, "_cuda_getDevice", None) or \
        torch.cuda.current_device
    _raw_stream = getattr(c, "_cuda_getCurrentRawStream", None) or \
        (lambda index: torch.cuda.current_stream(index).cuda_stream)


def raw_stream(index: int) -> int:
    """Device `index`'s current CUDA stream (a cudaStream_t, as an int)."""
    if _raw_stream is None:
        _bind_torch()
    return _raw_stream(index)


class Launcher:
    """One exported C launcher of `csrc/<source>`, bound once.

    ``launcher(device_index, *args)`` calls ``symbol(*args, stream)`` on
    the device's current stream and raises `BackendError`, naming `what`,
    if it returns a CUDA error (cudaGetLastError after the launch: a
    refused launch never runs, and no later synchronize would report it).
    The library is built, loaded and the signature declared at the first
    call; after that a call costs the device check, one C call for the
    stream, the ctypes call and the test of its return. The thread's
    device is switched, and restored, only when it is not `device_index`
    (shards on cuda:1..3 from one thread). `argtypes` leaves out the
    trailing stream (``stream=False``: an export that takes none, called
    through `function()`); pointers must be c_void_p, or ctypes cuts them
    to 32 bits. Every export returns an int."""

    __slots__ = ("source", "symbol", "argtypes", "what", "fn",
                 "error_string")

    def __init__(self, source: str, symbol: str, argtypes, what: str,
                 stream: bool = True):
        self.source, self.symbol, self.what = source, symbol, what
        self.argtypes = [*argtypes, ctypes.c_void_p] if stream else \
            list(argtypes)
        self.fn = self.error_string = None

    def function(self):
        """The bound C function (built, loaded and declared once)."""
        if self.fn is None:
            lib = load(self.source, {self.symbol: (self.argtypes,
                                                   ctypes.c_int)})
            if _raw_stream is None:
                _bind_torch()
            self.error_string = lib.nns_error_string
            self.fn = getattr(lib, self.symbol)
        return self.fn

    def __call__(self, index: int, *args, stream=None) -> None:
        fn = self.fn or self.function()
        if stream is None:
            stream = _raw_stream(index)
        if _thread_device() == index:
            err = fn(*args, stream)
        else:
            prev = torch.cuda._exchange_device(index)
            try:
                err = fn(*args, stream)
            finally:
                torch.cuda._maybe_exchange_device(prev)
        if err:
            raise BackendError(
                f"{self.what}: CUDA error {err} "
                f"({self.error_string(err).decode()})")
