"""Hand-written kernels for streaming hot ops (counterpart of the JAX
package's backends/pallas_ops.py).

- ``normalize_u8`` — integer (or f32) frame → ``(x - mean) * (1/std)`` in
  f32 or bf16; the converter+transform ingest path in one pass. CUDA C++
  in ``csrc/normalize.cu``.

Each kernel has three parts here: the wrapper, which launches the CUDA
kernel for a CUDA tensor and counts the launch; its plain torch version,
which repeats the kernel's arithmetic; and the dispatch between them,
which takes the plain version only for a tensor on the CPU — the device
the caller chose. A CUDA tensor goes to the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from nnstreamer_tpu_torch.core.errors import BackendError

# -- normalize: (x - mean) * (1/std) ---------------------------------------

#: input dtypes the CUDA kernel takes, by the launcher's type code
_NORM_IN = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
            torch.float32: 4}
_NORM_OUT = {torch.float32: 0, torch.bfloat16: 1}
_NARROW_INTS = (torch.uint8, torch.int8, torch.uint16, torch.int16)


def normalize_u8_plain(x: torch.Tensor, mean: float = 127.5,
                       std: float = 127.5,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of the normalize kernel: narrow ints widen to
    int32, then f32; ``(x - mean) * inv_std`` in f32; cast to out_dtype."""
    inv_std = 1.0 / float(std)
    if x.dtype in _NARROW_INTS:
        x = x.to(torch.int32)
    x = x.to(torch.float32)
    return ((x - float(mean)) * inv_std).to(out_dtype)


def _normalize_u8_cuda(x: torch.Tensor, mean: float, std: float,
                       out_dtype: torch.dtype) -> torch.Tensor:
    from nnstreamer_tpu_torch.backends import cuda_build

    if x.dtype not in _NORM_IN:
        raise BackendError(
            f"normalize_u8 kernel takes {sorted(str(d) for d in _NORM_IN)} "
            f"input, got {x.dtype}")
    if out_dtype not in _NORM_OUT:
        raise BackendError(
            f"normalize_u8 kernel writes float32 or bfloat16, not {out_dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = cuda_build.load("normalize.cu", {"nns_normalize": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int)})
    with torch.cuda.device(x.device):
        err = lib.nns_normalize(
            x.data_ptr(), _NORM_IN[x.dtype], y.data_ptr(),
            _NORM_OUT[out_dtype], x.numel(), float(mean), 1.0 / float(std),
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "normalize_u8")
    normalize_u8.launches += 1
    return y


def normalize_u8(x: torch.Tensor, mean: float = 127.5, std: float = 127.5,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (or int8/int16/uint16/f32) frame → normalized f32/bf16, same
    shape. A CUDA tensor runs the hand-written kernel; a CPU tensor runs
    the plain version."""
    if x.is_cuda:
        return _normalize_u8_cuda(x, mean, std, out_dtype)
    if x.device.type != "cpu":
        raise BackendError(
            f"normalize_u8 runs on cuda or cpu tensors, got {x.device}")
    return normalize_u8_plain(x, mean, std, out_dtype)


#: kernel launches made by this process (the wrapper counts each one)
normalize_u8.launches = 0
