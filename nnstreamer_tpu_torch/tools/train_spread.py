#!/usr/bin/env python3
"""How far float32 rounding alone moves `chip_smoke.py` phase 55's
card-against-CPU training comparison, and how far a wrong backward does.

    python3 nnstreamer_tpu_torch/tools/train_spread.py [--width 1.0]
        [--device cpu]

It takes the phase's batch-2 `sgd:0.01` arm (MobileNetV2 at `--width`,
1001 classes, the zoo's seeded init, the first two images and labels of
the phase's seeded batch normalized by `normalize_u8`) and takes two
steps on one device in float64, the reference. Then, from each step's
float64 start (teacher-forced, as the phase does), one step in float32,
and one in float32 with train-mode BN's batch statistics detached from
the graph (a control: the backward without the mean and var). For each
it prints what the phase holds: the losses' relative difference, and
per leaf |float32 − float64| over the leaf's movement in the reference
step (the floor of the movement 1e-2 of the largest leaf's), the median
over the leaves that moved more and the largest over all. It prints the
same of two free-running float32 steps, too. The phase's limits sit
above float32's own spread and below the control's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from nnstreamer_tpu_torch.backends import kernels  # noqa: E402
from nnstreamer_tpu_torch.models import layers as L  # noqa: E402
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm  # noqa: E402
from nnstreamer_tpu_torch.parallel import train as tt  # noqa: E402

LR, CLASSES = 0.01, 1001


def detached_bn(x, scale, bias, eps=L.BN_EPS):
    """Train-mode BN whose batch statistics carry no gradient."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3)).detach()
    var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3)).detach()
    return L.batch_norm(x, scale, bias, mean, var, eps)


def sgd_step(state: dict, width: float, dtype, x, y, device) -> tuple:
    """One sgd step from a state dict → (loss, the state dict after)."""
    model = tm.init_params(width=width, num_classes=CLASSES)
    model.load_state_dict(state)
    model = model.to(device=device, dtype=dtype)
    st = tt.init_state(model, tt.sgd(LR))
    step = tt.make_train_step(
        lambda p, a, b: tm.loss_fn(p, a, b, dtype=dtype), tt.sgd(LR))
    _, loss = step(st, x.to(dtype), y)
    return float(loss), {k: v.detach().double().cpu()  # nnlint: disable=NNL002 the tool compares the trained weights on the host, once
                         for k, v in model.state_dict().items()}


def agreement(got: dict, want: dict, prev: dict) -> tuple:
    """(median over the leaves that moved, largest over all) of
    |got − want| over the leaf's movement from `prev` to `want`."""
    moved = {k: float((want[k] - prev[k]).abs().max()) for k in want}
    floor = 1e-2 * max(moved.values())
    ratio = {k: float((got[k] - want[k]).abs().max()) / max(moved[k], floor)
             for k in want}
    return (float(np.median([ratio[k] for k in want if moved[k] > floor])),
            max(ratio.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    # the phase compares with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(550)          # phase 55's batch
    x8 = rng.integers(0, 256, (8, 224, 224, 3), np.uint8)
    y8 = rng.integers(0, CLASSES, (8,)).astype(np.int32)
    x = kernels.normalize_u8(torch.from_numpy(x8[:2]).to(args.device))
    y = torch.from_numpy(y8[:2]).long().to(args.device)
    ref = [{k: v.double() for k, v in tm.init_params(
        width=args.width, num_classes=CLASSES).state_dict().items()}]
    ref_loss = []
    for _ in range(2):
        loss, after = sgd_step(ref[-1], args.width, torch.float64, x, y,
                               args.device)
        ref_loss.append(loss)
        ref.append(after)
    free = ref[0]
    for k in range(2):
        loss, got = sgd_step(ref[k], args.width, torch.float32, x, y,
                             args.device)
        bn = L.batch_norm_train
        L.batch_norm_train = detached_bn
        try:
            _, bad = sgd_step(ref[k], args.width, torch.float32, x, y,
                              args.device)
        finally:
            L.batch_norm_train = bn
        print(f"step {k + 1}: float32 loss rel "
              f"{abs(loss - ref_loss[k]) / abs(ref_loss[k]):.3e}")
        for label, p in (("float32", got), ("control", bad)):
            med, top = agreement(p, ref[k + 1], ref[k])
            print(f"step {k + 1} {label}: params over movement: median "
                  f"{med:.3e}, largest {top:.3e}")
        free_loss, free = sgd_step(free, args.width, torch.float32, x, y,
                                   args.device)
    med, top = agreement(free, ref[2], ref[1])
    print(f"free-running float32: step 2 loss rel "
          f"{abs(free_loss - ref_loss[1]) / abs(ref_loss[1]):.3e}, params "
          f"after step 2 over step 2's movement: median {med:.3e}, largest "
          f"{top:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
