"""tensor_transform — elementwise op engine, typecast and arithmetic modes
(reference gsttensor_transform.c :181-199, op-chain parser :117-122).

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
  mode=clamp       option=min:max
  mode=stand       option=default|dc-average[:per-channel]

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
from nnstreamer_tpu_torch.tensor.info import TensorInfo

#: one compiled step: (fn(array) -> array, out_info_fn(TensorInfo) -> TensorInfo)
Step = Tuple[Callable, Callable]

MODES = ("typecast", "arithmetic", "clamp", "stand")
_ARITH_OPS = ("add", "sub", "mul", "div", "typecast")


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
            mean = f.mean(dim=dims, keepdim=per_channel)
            if kind == "dc-average":
                return f - mean
            std = f.std(dim=dims, correction=0, keepdim=per_channel)
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
