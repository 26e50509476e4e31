#!/usr/bin/env python3
"""One process of the two-process multi-host check of
parallel/multihost.py (the JAX package's tests/test_multihost.py case).

    python3 nnstreamer_tpu_torch/tools/multihost_check.py PID HOST:PORT \
        [--backend gloo] [--devices 4]

Run it twice, PID 0 and 1, against one free HOST:PORT. Each process
joins the process group, maps `--devices` logical devices onto its
accelerator (``[filter] accelerator``; env
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu on the CPU) and builds the
global dp mesh over both processes' devices. Then:

1. a cross-process sum: each process feeds `--devices` rows of its
   (pid + 1) as its part of a global batch; the gathered sum must be
   exactly devices · 3;
2. one `make_train_step` over the mesh on a linear regression (w0 =
   arange(4)/10, 16 rows of a seeded numpy batch, each process its
   half, sgd 0.1): the step's parameters against the serial numpy step
   on the whole batch, within 1e-5.

It prints one JSON line: pid, the sum, the loss, the parameters' error,
the copies between logical devices, whether the process stayed free of
jax and the JAX package, the backend and the devices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("coordinator")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: [parallel] "
                         "backend)")
    ap.add_argument("--devices", type=int, default=4,
                    help="logical devices of this process")
    args = ap.parse_args(argv)
    os.environ["NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES"] = \
        str(args.devices)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.parallel import multihost
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec
    from nnstreamer_tpu_torch.parallel.train import (
        init_state, make_train_step, sgd, shard_state)

    torch.set_num_threads(2)
    joined = multihost.initialize(coordinator_address=args.coordinator,
                                  num_processes=2, process_id=args.pid,
                                  backend=args.backend)
    assert joined and multihost.process_count() == 2
    n = args.devices
    mesh = multihost.global_mesh(MeshSpec(dp=2 * n))
    assert mesh.size == 2 * n and list(mesh.processes.flat) == \
        [0] * n + [1] * n
    home = mesh.along("dp")[args.pid * n]

    # 1. the cross-process sum
    x = multihost.host_local_batch(
        mesh, torch.full((n, 1), float(args.pid + 1), device=home))
    total = float(multihost.fetch_replicated(x).sum())
    assert total == 3.0 * n, f"global sum {total}"

    # 2. one train step across the processes
    w0 = np.arange(4, dtype=np.float32).reshape(4, 1) / 10.0

    def loss_fn(params, xb, yb):
        return ((xb @ params["w"] - yb) ** 2).mean()

    state = shard_state(init_state({"w": torch.from_numpy(w0).to(home)},
                                   sgd(0.1)), mesh)
    step = make_train_step(loss_fn, sgd(0.1), mesh=mesh,
                           batch_spec=[("dp",), ("dp",)])
    rng = np.random.RandomState(0)               # the same batch in both
    xb_all = rng.randn(16, 4).astype(np.float32)
    yb_all = rng.randn(16, 1).astype(np.float32)
    half = slice(args.pid * 8, (args.pid + 1) * 8)
    xb, yb = multihost.host_local_batch(
        mesh, torch.from_numpy(xb_all[half]).to(home),
        torch.from_numpy(yb_all[half]).to(home))
    state, loss = step(state, xb, yb)
    w1 = state.params.unsharded(torch.device("cpu"))["w"].numpy()
    grad = 2.0 * xb_all.T @ (xb_all @ w0 - yb_all) / len(xb_all)
    err = float(np.abs(w1 - (w0 - 0.1 * grad)).max())
    assert err < 1e-5, f"train step mismatch {err}"
    jax_free = not [m for m in sys.modules if m in ("jax", "nnstreamer_tpu")
                    or m.startswith(("jax.", "nnstreamer_tpu."))]
    print(json.dumps({"pid": args.pid, "sum": total, "loss": float(loss),
                      "err": err, "transfers": step.moves.count,
                      "jax_free": jax_free,
                      "backend": torch.distributed.get_backend(),
                      "devices": [str(d) for d in mesh.devices.flat]}))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
