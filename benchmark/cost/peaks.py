"""Published peaks per card (NVIDIA data sheets, dense, without
sparsity), copied from the port's `runtime/devprof.py` so that the
yardstick does not move with the program. A card's name is matched by
the longest known prefix of ``torch.cuda.get_device_name()``."""

from __future__ import annotations

from typing import Optional, Tuple

#: dense bf16 peak, TFLOP/s
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,      # H100 SXM
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA H200": 989.0,
    "NVIDIA A100-SXM4-80GB": 312.0,
    "NVIDIA A100-SXM4-40GB": 312.0,
    "NVIDIA A100 80GB PCIe": 312.0,
}

#: memory bandwidth, GB/s
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
    "NVIDIA A100-SXM4-80GB": 2039.0,
    "NVIDIA A100-SXM4-40GB": 1555.0,
    "NVIDIA A100 80GB PCIe": 1935.0,
}


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    """(FLOP/s, bytes/s) of the card named `kind`, or None where the
    card is not in the table (no denominator: no share is reported)."""
    k = str(kind or "").strip().lower()
    best = ""
    for known in PEAK_TFLOPS:
        if k.startswith(known.lower()) and len(known) > len(best):
            best = known
    if not best:
        return None
    return PEAK_TFLOPS[best] * 1e12, PEAK_HBM_GBPS[best] * 1e9


def least_time(flops: float, nbytes: float, kind: str) -> Optional[float]:
    """The least time the card could take for `flops` and `nbytes`: the
    larger of the two bounds (None on an unknown card)."""
    p = peaks(kind)
    if p is None:
        return None
    return max(flops / p[0], nbytes / p[1])
