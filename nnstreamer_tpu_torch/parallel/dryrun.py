"""One step of every sharded path on n logical devices (the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

    from nnstreamer_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu")

JAX re-runs itself in a subprocess under n virtual CPU devices when
fewer are visible; the port maps n logical devices round-robin onto the
physical ones instead (serving/placement.py's logical devices), so the
same call runs on the CPU, on one card or on several. It runs, on those
devices:

- a dp × tp MobileNetV2 train step (parallel/train.py: tp 2 when n is
  even), whose loss must be finite;
- ring attention over sp = n (parallel/ring_attention.py), held to the
  single-device attention within 1e-5·max|ref| + 1e-6;
- the GPipe pipeline over pp = n, held to the serial fold bit for bit;
- the MoE layer over ep = n, finite;
- the composed dp × tp × sp forward (batch over dp, sequence ring-
  attended over sp, the MLP's weights split over tp), held to the same
  math on one device within 5e-4, as JAX's gate holds its own.

`block` is the ring's local block (JAX's: 8); at a multiple of 128 on
CUDA tensors the ring steps run the `flash_block_update` kernel. Every
check runs in f32 with TF32 off.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import PipelineError

#: the composed forward against one device (JAX's gate)
COMPOSED_TOL = 5e-4
#: ring attention against one device: REL·max|ref| + ABS (f32)
RING_REL, RING_ABS = 1e-5, 1e-6


def logical_devices(n: int, device: Optional[str] = None
                    ) -> List[torch.device]:
    """n logical devices: the visible ones when there are that many,
    else n round-robin over the physical devices (`device`: "cpu",
    "cuda" or "cuda:<i>" in their place)."""
    from nnstreamer_tpu_torch.backends.base import pick_device
    from nnstreamer_tpu_torch.serving.placement import (
        physical_devices, visible_devices)

    if device is None:
        vis = visible_devices()
        if len(vis) >= n:
            return vis[:n]
        phys = physical_devices()
    elif device == "cuda":
        phys = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] or \
            [pick_device("cuda")]
    else:
        phys = [pick_device(device)]
    return [phys[i % len(phys)] for i in range(n)]


class _NoTf32:
    """f32 products in full f32 for the checks, restored after."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PipelineError(f"dryrun_multichip: {msg}")


def train_step(devices, n: int) -> dict:
    """The dp × tp MobileNetV2 step (JAX's: width 0.35, 16 classes,
    adam 1e-3, batch 2·dp of ones at 32²)."""
    from nnstreamer_tpu_torch.models import mobilenet_v2 as m
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.train import (
        adam, init_state, make_train_step, shard_state)

    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh(MeshSpec(dp=dp, tp=tp, sp=1), devices)
    width = 0.35
    params = m.init_params(width=width, num_classes=16).to(devices[0])
    state = shard_state(init_state(params, adam(1e-3)), mesh)
    step = make_train_step(
        lambda p, x, y: m.loss_fn(p, x, y, width=width, dtype=torch.float32),
        adam(1e-3), mesh=mesh, batch_spec=(("dp",), ("dp",)))
    batch = dp * 2
    x = torch.ones((batch, 32, 32, 3), device=devices[0])
    y = torch.arange(batch, device=devices[0]) % 16
    state, loss = step(state, x, y)
    loss = float(loss)
    _check(state.step == 1 and np.isfinite(loss), f"train step loss {loss}")
    return {"dp": dp, "tp": tp, "loss": loss, "moves": step.moves.count}


def ring(devices, n: int, block: int) -> dict:
    """Causal ring attention over sp = n against one device."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    mesh = make_mesh(MeshSpec(dp=1, tp=1, sp=n), devices)
    b, s, h, d = 1, block * n, 2, 8
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(devices[0])
               for _ in range(3))
    out = ring_attention(q, k, v, mesh=mesh, causal=True)
    ref = reference_attention(q, k, v, causal=True)
    err = float((out - ref).abs().max())
    limit = RING_REL * float(ref.abs().max()) + RING_ABS
    _check(tuple(out.shape) == (b, s, h, d) and err <= limit,
           f"ring attention off by {err} (limit {limit})")
    return {"shape": list(out.shape), "max_abs_err": err, "limit": limit}


def pipeline(devices, n: int) -> dict:
    """The GPipe schedule over pp = n, 2n microbatches of (2, 8), against
    the serial fold."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.pipeline import (
        pipeline_apply, reference_pipeline, stack_stage_params)

    mesh = make_mesh(MeshSpec(dp=1, pp=n), devices)
    d = 8
    gen = torch.Generator().manual_seed(1)
    stages = [{"w": (torch.randn(d, d, generator=gen) * 0.1)
               .to(devices[0])} for _ in range(n)]

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"])

    xs = torch.ones((2 * n, 2, d), device=devices[0])
    out = pipeline_apply(stage_fn, stack_stage_params(stages), xs, mesh=mesh)
    same = torch.equal(out, reference_pipeline(stage_fn, stages, xs))
    _check(out.shape == xs.shape and same,
           "the pipeline differs from the serial fold")
    return {"shape": list(out.shape), "bit_for_bit": same}


def moe(devices, n: int) -> dict:
    """The MoE layer over ep = n (d 8, hidden 16, n experts, 8n tokens)."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.moe import init_moe_params, moe_apply

    mesh = make_mesh(MeshSpec(dp=1, ep=n), devices)
    d = 8
    params = init_moe_params(torch.Generator().manual_seed(2), d, 2 * d, n,
                             device=devices[0])
    toks = torch.randn(8 * n, d, generator=torch.Generator().manual_seed(3)
                       ).to(devices[0])
    out = moe_apply(params, toks, mesh=mesh)
    _check(out.shape == toks.shape and bool(torch.isfinite(out).all()),
           "the MoE layer gave no finite output")
    return {"shape": list(out.shape)}


def composed_shape(n: int) -> dict:
    """The composed mesh JAX's gate picks for n devices."""
    if n % 4 == 0 and n >= 8:
        return dict(dp=2, tp=2, sp=n // 4)
    if n % 4 == 0:
        return dict(dp=2, tp=1, sp=2)
    return dict(dp=1, tp=1, sp=n)


def composed_weights(sp: int, block: int):
    """(x, wq, wk, wv, w1, w2) as numpy, drawn as JAX's gate draws them
    (B 4, S block·sp, 2 heads of 8, MLP 32)."""
    b, s, h, dh, f = 4, block * sp, 2, 8, 32
    d = h * dh
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    wq, wk, wv = (rng.normal(0, d ** -0.5, (d, d)).astype(np.float32)
                  for _ in range(3))
    w1 = rng.normal(0, d ** -0.5, (d, f)).astype(np.float32)
    w2 = rng.normal(0, f ** -0.5, (f, d)).astype(np.float32)
    return x, wq, wk, wv, w1, w2


def composed(devices, n: int, block: int = 8) -> dict:
    """One forward under a dp × tp × sp mesh — the batch over dp, the
    sequence ring-attended over sp, the MLP's w1 split by columns and w2
    by rows over tp (each tp device's partial product summed on the
    first) — against the same math on one device (JAX's
    `_composed_dp_tp_sp`). → {"max_abs_err", "shape", "out"}."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, Moves, make_mesh
    from nnstreamer_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    shape = composed_shape(n)
    mesh = make_mesh(MeshSpec(**shape), devices)
    home = devices[0]
    x, wq, wk, wv, w1, w2 = (torch.from_numpy(a).to(home)
                             for a in composed_weights(shape["sp"], block))
    h, dh = 2, 8

    def fwd(attn, mlp):
        b, s, d = x.shape
        q, k, v = ((x @ w).reshape(b, s, h, dh) for w in (wq, wk, wv))
        a = attn(q, k, v).reshape(b, s, d)
        return mlp(a) + x

    ref = fwd(lambda q, k, v: reference_attention(q, k, v, causal=True),
              lambda a: F.relu(a @ w1) @ w2)
    tp_devs, tp_ords = mesh.along("tp"), mesh.ordinals_along("tp")
    moves = Moves()

    def tp_mlp(a):
        cols = torch.chunk(torch.arange(w1.shape[1]), len(tp_devs))
        out = None
        for dev, o, c in zip(tp_devs, tp_ords, cols):
            part = F.relu(moves.to(a, dev, tp_ords[0], o)
                          @ w1[:, c].to(dev)) @ w2[c].to(dev)
            part = moves.to(part, home, o, tp_ords[0])
            out = part if out is None else out + part
        return out

    got = fwd(lambda q, k, v: ring_attention(
        q, k, v, mesh=mesh, axis="sp", batch_axis="dp", causal=True), tp_mlp)
    err = float((got - ref).abs().max())
    _check(err < COMPOSED_TOL, f"composed dp x tp x sp mismatch: {err}")
    return {"max_abs_err": err, "shape": shape, "out": got}


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     block: int = 8) -> dict:
    """Run one step of each sharded path on `n_devices` logical devices
    (module docstring) and print the summary; → the results by path."""
    devices = logical_devices(n_devices, device)
    with _NoTf32():
        res = {"train": train_step(devices, n_devices),
               "ring": ring(devices, n_devices, block),
               "pipeline": pipeline(devices, n_devices),
               "moe": moe(devices, n_devices),
               "composed": composed(devices, n_devices, block)}
    c = res["composed"]["shape"]
    print(f"dryrun_multichip ok on {n_devices} devices "
          f"({', '.join(sorted({str(d) for d in devices}))}): "
          f"dp={res['train']['dp']} tp={res['train']['tp']} train step + "
          f"sp={n_devices} ring attention + pp={n_devices} pipeline + "
          f"ep={n_devices} moe + composed dp{c['dp']}xtp{c['tp']}xsp{c['sp']} "
          f"forward (max_abs_err={res['composed']['max_abs_err']:.2e} vs "
          f"single-device)")
    return res
