"""tensor_trainer element — streaming training steps (the JAX package's
trainer/element.py on the port).

Sink pad 0 carries (x, label) multi-tensor frames (use tensor_mux to
pair a data stream with a label stream). Each process() call runs one
train step (parallel/train.py); the src pad emits a float32 (1,) loss
per step on the host, so a tensor_sink can chart/stop on it.

Properties:
- model:      zoo reference ("zoo://mobilenet_v2?width=0.35&...") whose
              module exposes loss_fn(params, x, y) and init_params
- optimizer:  "sgd:<lr>" | "adam:<lr>" | "adamw:<lr>" (torch.optim with
              optax's algebra and defaults, parallel/train.py)
- mesh:       "dp=4,tp=2" — shard the step over a mesh of the logical
              devices (parallel/train.py: global-batch BN, each tp-split
              leaf kept as its slices); the state lives on the mesh and
              x and the labels are staged on its first device
- checkpoint_dir + checkpoint_every: the full train state (params,
              optimizer moments, step) every N steps, one `torch.save`
              file `step_<n>/state.pt`, whole leaves also under a mesh
              (it resumes with a mesh or without); resume_from restores
              it (a params-only file restores the params with fresh
              moments) and places it on the mesh again
- accelerator: the device the state lives on, as a filter's ("cuda",
              "cuda:<i>", "cpu"; empty = [filter] accelerator). x and the
              labels are staged there; the loss crosses back in one
              counted forced sync a step, traced under the trainer's name.
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path
from typing import List, Sequence

import torch

from nnstreamer_tpu_torch.core.errors import BackendError, PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.parallel import train as T
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

log = get_logger("trainer")

#: the one file of a checkpoint directory
CHECKPOINT_FILE = "state.pt"
_FULL_KEYS = {"params", "opt_state", "step"}


def _parse_optimizer(s: str) -> T.Optimizer:
    kind, _, lr = s.partition(":")
    lr_f = float(lr or 1e-3)
    if kind == "sgd":
        return T.sgd(lr_f)
    if kind == "adam":
        return T.adam(lr_f)
    if kind == "adamw":
        return T.adamw(lr_f)
    raise PipelineError(
        f"unknown optimizer {s!r}; use sgd:<lr> | adam:<lr> | adamw:<lr>")


def _parse_mesh(s: str):
    if not s:
        return None
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    kw = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        kw[k.strip()] = int(v)
    return make_mesh(MeshSpec(**kw))


def _to_device(params, device: torch.device):
    """A module or tensor tree on `device` (a module moves in place)."""
    if isinstance(params, torch.nn.Module):
        return params.to(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return type(params)(_to_device(v, device) for v in params)


def _params_state(params):
    """What a checkpoint keeps of the params: a module's state dict (its
    BN mean and var included), or the tensor tree itself."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return params


@register_element("tensor_trainer")
class TensorTrainer(Element):
    ELEMENT_NAME = "tensor_trainer"
    PROPS = {
        "model": PropDef(lambda s: s, None, "zoo:// model with loss_fn"),
        "optimizer": PropDef(str, "sgd:0.01"),
        "mesh": PropDef(str, "", "e.g. 'dp=4,tp=2'; empty = single device"),
        "checkpoint_dir": PropDef(str, ""),
        "checkpoint_every": PropDef(int, 100),
        "resume_from": PropDef(str, "", "checkpoint path to restore at "
                                        "start (full train state)"),
        "accelerator": PropDef(str, "", "cuda | cuda:<i> | cpu; empty = "
                                        "[filter] accelerator"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._step_fn = None
        self._state = None
        self._loss_fn = None
        self._device = None
        self._mesh = None
        self.steps = 0

    def _resolve_loss(self):
        model = self.props["model"]
        if callable(model):  # loss_fn(params, x, y) given directly
            return model, None
        if not isinstance(model, str) or not model.startswith("zoo://"):
            raise PipelineError(
                f"tensor_trainer {self.name}: model= must be a zoo:// "
                f"reference or a callable loss_fn; got {model!r}")
        from urllib.parse import parse_qsl

        name, _, query = model[len("zoo://"):].partition("?")
        kwargs = {k.replace("-", "_"): v for k, v in parse_qsl(query)}
        try:
            mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
        except ImportError as e:
            raise PipelineError(
                f"tensor_trainer {self.name}: no trainable model "
                f"{name!r}: {e}") from e
        if not hasattr(mod, "loss_fn") or not hasattr(mod, "init_params"):
            raise PipelineError(
                f"model {name!r} is not trainable (needs loss_fn + "
                f"init_params)")
        width = float(kwargs.get("width", 1.0))
        num_classes = int(kwargs.get("num_classes", 1001))
        params = mod.init_params(width=width, num_classes=num_classes)

        def loss(p, x, y):
            return mod.loss_fn(p, x, y, width=width, dtype=torch.float32)

        return loss, params

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        from nnstreamer_tpu_torch.backends.base import pick_device

        spec = self.expect_tensors(in_specs[0])
        if spec.num_tensors != 2:
            self.fail_negotiation(
                f"tensor_trainer takes (x, label) 2-tensor frames (pair "
                f"them with tensor_mux); got {spec.num_tensors} tensors")
        self._loss_fn, params = self._resolve_loss()
        if params is None:
            self.fail_negotiation(
                "callable loss models must be passed with explicit params "
                "— use the zoo:// form instead")
        opt = _parse_optimizer(self.props["optimizer"])
        mesh = self._mesh = _parse_mesh(self.props["mesh"])
        self._device = pick_device(self.props["accelerator"]) \
            if mesh is None else mesh.devices.flat[0]
        params = _to_device(params, self._device)
        self._state = T.init_state(params, opt)
        if mesh is not None:
            self._state = T.shard_state(self._state, mesh)
        # batch_spec defaults to dp-split leading dims inside
        # make_train_step: spec construction stays in parallel/
        self._step_fn = T.make_train_step(self._loss_fn, opt, mesh=mesh)
        if self.props["resume_from"]:
            self.restore_checkpoint(self.props["resume_from"])
        return [TensorsSpec.of(TensorInfo((1,), DType.FLOAT32),
                               rate=spec.rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        from nnstreamer_tpu_torch.backends.torch_backend import stage
        from nnstreamer_tpu_torch.runtime.sync import to_host

        (x, y), _ = stage(buf.tensors[:2], self._device)
        y = y.reshape(-1).long()      # JAX casts to int32; gather wants int64
        try:
            self._state, loss = self._step_fn(self._state, x, y)
        except Exception as e:
            raise BackendError(
                f"tensor_trainer {self.name}: train step failed at step "
                f"{self.steps}: {e}") from e
        self.steps += 1
        every = self.props["checkpoint_every"]
        if self.props["checkpoint_dir"] and every > 0 and \
                self.steps % every == 0:
            self.save_checkpoint()
        host, = to_host((loss.float().reshape(1),), self._tracer, self.name)
        return [(0, buf.with_tensors((host,)))]

    # -- checkpoint / resume ---------------------------------------------
    def save_checkpoint(self) -> None:
        """FULL train state (params + optimizer moments + step), so a
        resumed run continues the optimizer trajectory instead of
        restarting Adam statistics from zero. Written to a temporary
        file and renamed into place."""
        path = Path(self.props["checkpoint_dir"]) / f"step_{self.steps}"
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (CHECKPOINT_FILE + ".tmp")
        # under a mesh: whole leaves, the moments of each concatenated
        state = T.unshard_state(self._state, torch.device("cpu"))
        torch.save({"params": _params_state(state.params),
                    "opt_state": state.opt_state.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, path / CHECKPOINT_FILE)
        log.info("trainer %s: checkpoint at step %d → %s",
                 self.name, self.steps, path)

    def restore_checkpoint(self, path: str) -> None:
        """Restore a checkpoint directory into the live state, in place
        (under a mesh: into the whole leaves, then placed on the mesh
        again, as JAX re-places a restored state). A file that holds only
        params (a module's state dict or the tensor tree) restores them
        with fresh moments and the current step."""
        if not os.path.isdir(path):
            raise PipelineError(
                f"trainer {self.name}: resume checkpoint {path!r} does "
                f"not exist")
        # onto the host: load_state_dict moves each tensor to its leaf's
        # device (an optimizer's step counters stay on the host)
        blob = torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu",
                          weights_only=True)
        full = isinstance(blob, dict) and set(blob) == _FULL_KEYS
        params = blob["params"] if full else blob
        self._state = T.unshard_state(self._state, self._device)
        live = self._state.params
        with torch.no_grad():
            if isinstance(live, torch.nn.Module):
                live.load_state_dict(params, strict=True)
            else:
                dst, src = T.leaves(live), T.leaves(params)
                if len(dst) != len(src):
                    raise PipelineError(
                        f"trainer {self.name}: checkpoint {path!r} holds "
                        f"{len(src)} tensors, the model {len(dst)}")
                for d, s in zip(dst, src):
                    d.copy_(s)
        if full:
            self._state.opt_state.load_state_dict(blob["opt_state"])
            self._state.step = int(blob["step"])
        else:
            self._state.step = self.steps
            log.warning(
                "trainer %s: %s is a legacy params-only checkpoint; "
                "optimizer state restarts fresh", self.name, path)
        if self._mesh is not None:
            self._state = T.shard_state(self._state, self._mesh)
        self.steps = self._state.step
        log.info("trainer %s: resumed from %s at step %d",
                 self.name, path, self.steps)

    @property
    def params(self):
        return self._state.params if self._state is not None else None
