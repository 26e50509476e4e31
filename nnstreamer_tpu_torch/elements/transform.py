"""tensor_transform — the transform op engine (reference
gsttensor_transform.c modes :181-199, op-chain parser :117-122) — and
tensor_resize, the spatial resize.

A transform compiles its option string once into a chain of steps that
run on numpy arrays (host, standalone element) or on torch tensors (fused
into the adjacent tensor_filter and run on its device). Both follow the
JAX package's host (numpy) semantics, which the reference shares:

- an op promotes an integer input to float32 when it is ``div`` or its
  operand is not integral; otherwise the result keeps the input's dtype,
  and integer overflow wraps (uint8 250 + 10 → 4);
- float inputs keep their dtype.

Option syntax:
  mode=typecast    option=float32
  mode=arithmetic  option=typecast:float32,add:-127.5,div:127.5
                   (per-channel operands ':'-separated: add:1:2:3)
  mode=transpose   option=1:0:2:3   (reference innermost-first indices)
  mode=dimchg      option=0:2       (move reference dim 0 to position 2)
  mode=clamp       option=min:max
  mode=stand       option=default|dc-average[:per-channel]

``transpose`` and ``dimchg`` give views (numpy's and torch's alike), on
the host or fused into a filter and run on its device.

``clamp`` runs the clamp_scale kernel (backends/kernels.py) on a CUDA
tensor and its plain version on a CPU tensor or a host array, so host
and device give the same values. It computes what the JAX mode's clip
computes on floats; an integer input keeps its dtype, as the negotiated
spec says, clamped to the bounds rounded inward. ``stand`` is plain
numpy on the host (the JAX mode's own code) and torch on a tensor: f32
mean, population std (``correction=0``), ``(x - mean) / (std + 1e-10)``.
numpy's mean sums pairwise, torch's (and XLA's) in other orders, so the
tensor path agrees with the host path to f32 rounding of the mean and
std: within 1e-5 on O(1) outputs (tests/test_torch_clamp.py).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.runtime.sync import to_numpy
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorInfo, TensorsSpec

#: one compiled step: (fn(array) -> array, out_info_fn(TensorInfo) -> TensorInfo)
Step = Tuple[Callable, Callable]

MODES = ("typecast", "arithmetic", "transpose", "dimchg", "clamp", "stand")
_ARITH_OPS = ("add", "sub", "mul", "div", "typecast")


def _ref_perm_to_row_major(perm_ref: Sequence[int], rank: int) -> Tuple[int, ...]:
    """Reference transpose indices (innermost-first) → row-major axes perm."""
    return tuple(rank - 1 - perm_ref[rank - 1 - k] for k in range(rank))


def _is_float(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(dtype, np.floating) or str(dtype) == "bfloat16"


class TransformProgram:
    """A compiled option string: a function over one array (numpy or
    torch), plus the static shape/dtype transfer used at negotiation."""

    def __init__(self, mode: str, option: str):
        if mode not in MODES:
            raise PipelineError(
                f"unknown tensor_transform mode {mode!r}; valid: {MODES}")
        self.mode = mode
        self.option = option or ""
        compile_mode = {"typecast": lambda o: [self._step_typecast(o)],
                        "arithmetic": self._compile_arith_chain,
                        "transpose": lambda o: [self._step_transpose(o)],
                        "dimchg": lambda o: [self._step_dimchg(o)],
                        "clamp": lambda o: [self._step_clamp(o)],
                        "stand": lambda o: [self._step_stand(o)]}[mode]
        self._steps: List[Step] = compile_mode(self.option)

    def apply(self, arr):
        """Run on one array: numpy in → numpy out, tensor in → tensor out
        (on the tensor's device)."""
        for fn, _ in self._steps:
            arr = fn(arr)
        return arr

    def out_info(self, info: TensorInfo) -> TensorInfo:
        for _, transfer in self._steps:
            info = transfer(info)
        return info

    def _parse_dtype(self, s: str) -> DType:
        try:
            return DType.from_name(s)
        except ValueError as e:
            raise PipelineError(f"tensor_transform: {e}") from None

    def _step_typecast(self, option: str) -> Step:
        dt = self._parse_dtype(option)

        def fn(a):
            if isinstance(a, torch.Tensor):
                return a.to(dt.torch_dtype)
            return a.astype(dt.np_dtype)

        return fn, lambda info: replace(info, dtype=dt)

    @staticmethod
    def _step_transpose(option: str) -> Step:
        try:
            perm_ref = [int(v) for v in option.split(":")]
        except ValueError:
            raise PipelineError(
                f"tensor_transform mode=transpose needs option=i:j:k:… "
                f"(reference innermost-first indices), got {option!r}"
            ) from None

        def fn(a):
            perm = _ref_perm_to_row_major(perm_ref, a.ndim)
            if isinstance(a, torch.Tensor):
                return a.permute(perm)
            return np.transpose(a, perm)

        def transfer(info: TensorInfo) -> TensorInfo:
            rank = len(info.shape)
            if sorted(perm_ref) != list(range(rank)):
                raise PipelineError(
                    f"transpose option {option!r} is not a permutation of "
                    f"0..{rank - 1} for input shape {info.shape}")
            perm = _ref_perm_to_row_major(perm_ref, rank)
            return replace(info, shape=tuple(info.shape[p] for p in perm))

        return fn, transfer

    @staticmethod
    def _step_dimchg(option: str) -> Step:
        try:
            frm, to = (int(v) for v in option.split(":"))
        except ValueError:
            raise PipelineError(
                f"tensor_transform mode=dimchg needs option=from:to "
                f"(reference dim indices), got {option!r}") from None

        def fn(a):
            rank = a.ndim
            if isinstance(a, torch.Tensor):
                return torch.movedim(a, rank - 1 - frm, rank - 1 - to)
            return np.moveaxis(a, rank - 1 - frm, rank - 1 - to)

        def transfer(info: TensorInfo) -> TensorInfo:
            rank = len(info.shape)
            if not (0 <= frm < rank and 0 <= to < rank):
                raise PipelineError(
                    f"dimchg option {option!r} out of range for shape "
                    f"{info.shape}")
            shape = list(info.shape)
            v = shape.pop(rank - 1 - frm)
            shape.insert(rank - 1 - to, v)
            return replace(info, shape=tuple(shape))

        return fn, transfer

    @staticmethod
    def _step_clamp(option: str) -> Step:
        try:
            lo, hi = (float(v) for v in option.split(":"))
        except ValueError:
            raise PipelineError(
                f"tensor_transform mode=clamp needs option=min:max, got "
                f"{option!r}") from None
        if not lo <= hi:
            raise PipelineError(f"clamp min {lo} > max {hi}")

        def fn(a):
            if isinstance(a, torch.Tensor):
                return kernels.clamp_scale(a, lo, hi)
            return to_numpy(kernels.clamp_scale(host_tensor(a), lo, hi))

        return fn, lambda info: info

    @staticmethod
    def _step_stand(option: str) -> Step:
        parts = (option or "default").split(":")
        kind = parts[0] or "default"
        per_channel = len(parts) > 1 and parts[1] == "per-channel"
        if kind not in ("default", "dc-average"):
            raise PipelineError(
                f"tensor_transform mode=stand supports "
                f"default|dc-average[:per-channel], got {option!r}")

        def fn_np(a):
            f = a.astype(np.float32)
            axes = tuple(range(f.ndim - 1)) if per_channel else None
            mean = f.mean(axis=axes, keepdims=per_channel)
            if kind == "dc-average":
                return f - mean
            std = f.std(axis=axes, keepdims=per_channel)
            return (f - mean) / (std + 1e-10)

        def fn_torch(a):
            f = a.to(torch.float32)
            dims = tuple(range(f.dim() - 1)) if per_channel else None
            # rank 1 per channel: every element is its own channel. torch
            # reads dim=() as "every dim", numpy's axis=() reduces none:
            # the mean is the input and the std 0, as on the host
            none = dims == ()
            mean = f if none else f.mean(dim=dims, keepdim=per_channel)
            if kind == "dc-average":
                return f - mean
            std = torch.zeros_like(f) if none else \
                f.std(dim=dims, correction=0, keepdim=per_channel)
            return (f - mean) / (std + 1e-10)

        def fn(a):
            return fn_torch(a) if isinstance(a, torch.Tensor) else fn_np(a)

        return fn, lambda info: replace(info, dtype=DType.FLOAT32)

    def _compile_arith_chain(self, option: str) -> List[Step]:
        if not option:
            raise PipelineError(
                "tensor_transform mode=arithmetic requires option="
                "<op:value[,op:value...]>, e.g. "
                "option=typecast:float32,add:-127.5,div:127.5")
        steps: List[Step] = []
        for chunk in option.split(","):
            op, _, valstr = chunk.strip().partition(":")
            if op not in _ARITH_OPS:
                raise PipelineError(
                    f"unknown arithmetic op {op!r} in option {option!r}; "
                    f"valid ops: {_ARITH_OPS}")
            if op == "typecast":
                steps.append(self._step_typecast(valstr))
                continue
            try:
                vals = [float(v) for v in valstr.split(":")]
            except ValueError:
                raise PipelineError(
                    f"bad operand {valstr!r} for arithmetic op {op!r}") from None
            steps.append(self._arith_step(op, vals))
        return steps

    @staticmethod
    def _arith_step(op: str, vals: List[float]) -> Step:
        vec = np.asarray(vals, np.float32)
        promotes = op == "div" or any(not float(v).is_integer() for v in vals)
        scalar = vals[0] if len(vals) == 1 else None

        def combine(a, b):
            if op == "add":
                return a + b
            if op == "sub":
                return a - b
            if op == "mul":
                return a * b
            return a / b

        def fn_np(a):
            if promotes and not _is_float(a.dtype):
                a = a.astype(np.float32)
            b = scalar if scalar is not None else vec.astype(a.dtype)
            return combine(a, b).astype(a.dtype)

        # per-channel operands, made once per (device, dtype) at the
        # chain's first call there: no host-to-device copy per frame,
        # which a CUDA-graph capture of the chain would also refuse
        operands = {}

        def operand(device, dtype):
            b = operands.get((device, dtype))
            if b is None:
                host = vec.astype(np.int64) if dtype == torch.int64 else vec
                b = operands[(device, dtype)] = torch.from_numpy(host).to(
                    device, dtype)
            return b

        def fn_torch(a):
            if _is_float(a.dtype):
                # the scalar rounded to a's dtype first, as numpy and jnp
                # round a weak-typed Python float (torch would compute a
                # half or bf16 op with the scalar in f32)
                if scalar is not None:
                    b = torch.tensor(scalar, dtype=a.dtype)
                else:
                    b = operand(a.device, a.dtype)
                return combine(a, b)
            if promotes:
                a = a.to(torch.float32)
                b = scalar if scalar is not None else operand(
                    a.device, torch.float32)
                return combine(a, b)
            # integer op on an integer tensor: exact in int64, then the
            # cast back wraps like numpy's (a float → int cast saturates
            # on CUDA, so the result is never taken through a float)
            b = int(scalar) if scalar is not None else operand(
                a.device, torch.int64)
            return combine(a.to(torch.int64), b).to(a.dtype)

        def fn(a):
            return fn_torch(a) if isinstance(a, torch.Tensor) else fn_np(a)

        def transfer(info):
            if promotes and not info.dtype.is_float:
                return replace(info, dtype=DType.FLOAT32)
            return info

        return fn, transfer


@register_element("tensor_transform")
class TensorTransform(Element):
    ELEMENT_NAME = "tensor_transform"
    PROPS = {
        "mode": PropDef(str, None, "transform mode: " + "|".join(MODES)),
        "option": PropDef(str, "", "mode-specific option string"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["mode"]:
            raise PipelineError(
                f"tensor_transform ({self.name}) requires mode=<"
                + "|".join(MODES) + ">")
        self.program = TransformProgram(self.props["mode"], self.props["option"])

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        try:
            infos = tuple(self.program.out_info(t) for t in spec.tensors)
        except PipelineError as e:
            self.fail_negotiation(str(e))
        return [replace(spec, tensors=infos)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [(0, buf.with_tensors(
            tuple(self.program.apply(t) for t in buf.tensors)))]

    def as_elementwise(self):
        """The program as one function over a frame's tensors (the
        fusion hook's form: tensors in, tensors out, where they are)."""
        program = self.program

        def apply_all(tensors):
            return tuple(program.apply(t) for t in tensors)

        return apply_all


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """jax.image.resize's bilinear weights, (in_size, out_size) float32:
    its `compute_weight_mat` with the triangle kernel, antialiasing on
    (the kernel widens by in/out when downsampling) and no translation,
    computed in float32 as JAX does with x64 off."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The JAX element's nearest-neighbour source index per output row
    (float64 arithmetic, truncated, clipped)."""
    return np.clip(((np.arange(out_size) + 0.5) * in_size / out_size)
                   .astype(int), 0, in_size - 1)


@register_element("tensor_resize")
class TensorResize(Element):
    """Spatial resize — the flexible→static bridge.

    A FLEXIBLE stream (e.g. tensor_crop regions, per-buffer shapes) maps
    onto one static shape by resizing every region to one fixed (H, W):
    `tensor_crop ! tensor_resize size=224:224 channels=3 !
    tensor_filter ...` runs data-driven ROI inference on one model
    signature.

    STATIC input: per-tensor resize, same tensor count. FLEXIBLE input
    (requires channels=): each region becomes its own STATIC (H, W, C)
    buffer downstream (meta["region_index"]/["num_regions"] record the
    grouping).

    It runs where its input is: a host array gives a host array, a
    torch tensor a tensor on the same device (the JAX element always
    returns a host array). ``nearest`` takes the JAX element's index
    vectors (numpy float64, made once per size and moved to the device
    once). ``bilinear`` is jax.image.resize's: its float32 triangle
    weights (`bilinear_weights`), one product per resized axis, in
    float64 (so no TF32 rounding on the card), the result rounded to
    float32 and cast back to the input dtype, truncating for integers as
    numpy's ``astype`` does. JAX sums its products in float32: the two
    agree within float32 rounding (1e-5·max|.|, and 1 LSB for integer
    frames, tests/test_torch_resize.py).
    """

    ELEMENT_NAME = "tensor_resize"
    PROPS = {
        "size": PropDef(str, None, "output H:W"),
        "method": PropDef(str, "nearest", "nearest|bilinear"),
        "channels": PropDef(int, 0, "required for FLEXIBLE input"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["size"]:
            raise PipelineError(
                f"tensor_resize ({self.name}) requires size=H:W")
        try:
            self._h, self._w = (int(v) for v in self.props["size"].split(":"))
        except ValueError:
            raise PipelineError(
                f"tensor_resize size must be H:W, got "
                f"{self.props['size']!r}") from None
        if self.props["method"] not in ("nearest", "bilinear"):
            raise PipelineError(
                f"tensor_resize method must be nearest|bilinear, got "
                f"{self.props['method']!r}")
        self._flexible_in = False
        # (kind, in size, out size, device) → index or weight tensor
        self._consts = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if spec.format == TensorFormat.FLEXIBLE:
            c = self.props["channels"]
            if not c:
                self.fail_negotiation(
                    "FLEXIBLE input needs channels=<C> to declare the "
                    "static output type (each region becomes one "
                    "(H, W, C) buffer)")
            self._flexible_in = True
            return [TensorsSpec.of(
                TensorInfo((self._h, self._w, c), DType.UINT8
                           if not spec.tensors else spec.tensors[0].dtype),
                rate=spec.rate)]
        infos = []
        for t in spec.tensors:
            if len(t.shape) < 2:
                self.fail_negotiation(
                    f"cannot resize rank-{len(t.shape)} tensor {t}; need "
                    f"spatial (…, H, W, C) or (H, W) layout")
            shape = list(t.shape)
            h_ax = len(shape) - 3 if len(shape) >= 3 else 0
            shape[h_ax], shape[h_ax + 1] = self._h, self._w
            infos.append(replace(t, shape=tuple(shape)))
        return [replace(spec, tensors=tuple(infos))]

    def _const(self, kind: str, n_in: int, n_out: int, device):
        key = (kind, n_in, n_out, device)
        c = self._consts.get(key)
        if c is None:
            if kind == "nearest":
                c = torch.from_numpy(nearest_indices(n_in, n_out)).to(device)
            else:
                c = torch.from_numpy(bilinear_weights(n_in, n_out)).to(
                    device, torch.float64)
            self._consts[key] = c
        return c

    def _resize(self, arr):
        h_ax = arr.ndim - 3 if arr.ndim >= 3 else 0
        in_h, in_w = arr.shape[h_ax], arr.shape[h_ax + 1]
        if (in_h, in_w) == (self._h, self._w):
            return arr
        host = not isinstance(arr, torch.Tensor)
        if self.props["method"] == "nearest" and host:
            return np.take(np.take(arr, nearest_indices(in_h, self._h),
                                   axis=h_ax),
                           nearest_indices(in_w, self._w), axis=h_ax + 1)
        t = host_tensor(arr) if host else arr
        if self.props["method"] == "nearest":
            out = t.index_select(
                h_ax, self._const("nearest", in_h, self._h, t.device))
            out = out.index_select(
                h_ax + 1, self._const("nearest", in_w, self._w, t.device))
        else:
            out = t.to(torch.float64)
            for ax, n_in, n_out in ((h_ax, in_h, self._h),
                                    (h_ax + 1, in_w, self._w)):
                if n_in == n_out:   # jax.image skips an unscaled axis
                    continue
                w = self._const("bilinear", n_in, n_out, t.device)
                out = torch.movedim(
                    torch.tensordot(out, w, dims=([ax], [0])), -1, ax)
            out = out.to(torch.float32).to(t.dtype)
        return to_numpy(out) if host else out

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        if not self._flexible_in:
            return [(0, buf.with_tensors(
                tuple(self._resize(t) for t in buf.tensors)))]
        out: List[Emission] = []
        c = self.props["channels"]
        n = buf.num_tensors
        for i, t in enumerate(buf.tensors):
            a = t[..., None] if t.ndim == 2 else t
            if a.ndim != 3 or a.shape[-1] != c:
                raise PipelineError(
                    f"tensor_resize {self.name}: region {i} has shape "
                    f"{tuple(t.shape)}, expected (h, w, {c})")
            out.append((0, TensorBuffer(
                tensors=(self._resize(a),), pts=buf.pts,
                format=TensorFormat.STATIC,
                meta={**buf.meta, "region_index": i, "num_regions": n})))
        return out
