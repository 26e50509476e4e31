"""Device placement (counterpart of the JAX package's serving/placement.py,
as far as sharded serving needs it).

- `visible_devices` is the one place that enumerates devices: every
  shard group and ring picks its devices by ordinal from this list.
- `ChipLeaseTable` is the ownership ledger: which owner holds which
  device ordinals (free, leased or fenced).

Logical devices: the JAX package tests its mesh code on 8 virtual CPU
devices (``--xla_force_host_platform_device_count``). The port's
counterpart is the config key ``[parallel] virtual_devices`` (env
``NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES``): N > 0 maps N logical
devices round-robin onto the physical devices of the configured
accelerator. On one card a 4-way group then runs all four shards on
``cuda:0`` with the kernel launches four cards would make; on four cards
the same code puts one shard on each. 0 (the default) means the physical
devices themselves. A logical device is its physical ``torch.device``;
its ordinal is its place in the list.

`ReplicaSet`, `SegmentPlan` and the segment planners are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.backends.base import pick_device
from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import BackendError, ConfigError

#: what to set when a group wants more devices than are visible
VIRTUAL_DEVICES_HINT = (
    "set [parallel] virtual_devices (env NNSTREAMER_TPU_TORCH_PARALLEL_"
    "VIRTUAL_DEVICES=N) to map N logical devices onto the physical ones")


def physical_devices() -> List[torch.device]:
    """The devices of the configured accelerator ([filter] accelerator):
    every CUDA card for ``cuda``, that card for ``cuda:<i>``, one CPU for
    ``cpu``. Raises as `pick_device` does when no card is visible and the
    CPU was not asked for."""
    accel = (get_config().get("filter", "accelerator") or "cuda").strip()
    dev = pick_device(accel)
    if dev.type == "cpu" or ":" in accel:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def visible_devices() -> List[torch.device]:
    """Every logical device, in ordinal order: the physical devices, or
    ``[parallel] virtual_devices`` of them round-robin."""
    n = get_config().get_int("parallel", "virtual_devices", 0)
    if n < 0:
        raise ConfigError(f"[parallel] virtual_devices must be >= 0, got {n}")
    phys = physical_devices()
    if n == 0:
        return phys
    return [phys[i % len(phys)] for i in range(n)]


def device_of(index: int) -> torch.device:
    """The logical device with ordinal `index`; typed error past the
    end."""
    devs = visible_devices()
    if not 0 <= index < len(devs):
        raise BackendError(
            f"device index {index} out of range: {len(devs)} device(s) "
            f"visible; {VIRTUAL_DEVICES_HINT}")
    return devs[index]


class ChipLeaseTable:
    """Which owner holds which device ordinals — the fencing ledger.

    States per device: ``free`` (unowned), ``leased`` (owned by a live
    owner), ``fenced`` (its owner died; out of service until the owner's
    replacement re-leases it). `lease()` prefers the owner's own fenced
    devices, so a restarted owner gets its devices back."""

    def __init__(self, chips: Sequence[int]):
        self._lock = threading.Lock()
        self._chips: Dict[int, dict] = {
            int(c): {"owner": None, "state": "free"} for c in chips}
        self.fences_total = 0
        self.releases_total = 0

    def lease(self, owner, want: Optional[int] = None) -> Tuple[int, ...]:
        """Lease `want` devices to `owner` (None = all of its fenced
        devices, i.e. a re-lease after a restart). Own fenced devices come
        back first; free ones top up the rest. A typed error when the
        table cannot satisfy the request: an under-lease is never
        silent."""
        with self._lock:
            got: List[int] = [c for c, row in sorted(self._chips.items())
                              if row["state"] == "fenced"
                              and row["owner"] == owner]
            if want is None:
                want = len(got)
            for c, row in sorted(self._chips.items()):
                if len(got) >= want:
                    break
                if row["state"] == "free":
                    got.append(c)
            if len(got) < want:
                raise BackendError(
                    f"chip lease for {owner!r}: wanted {want}, only "
                    f"{len(got)} available ({self._counts_locked()})")
            got = got[:want]
            for c in got:
                self._chips[c] = {"owner": owner, "state": "leased"}
            return tuple(sorted(got))

    def fence(self, owner) -> Tuple[int, ...]:
        """The owner died: its leased devices go out of service, still
        associated with the owner so its restart re-leases them."""
        with self._lock:
            fenced = []
            for c, row in self._chips.items():
                if row["owner"] == owner and row["state"] == "leased":
                    row["state"] = "fenced"
                    fenced.append(c)
            self.fences_total += len(fenced)
            return tuple(sorted(fenced))

    def release(self, owner) -> Tuple[int, ...]:
        """Give the owner's devices (leased or fenced) back to the free
        pool."""
        with self._lock:
            freed = []
            for c, row in self._chips.items():
                if row["owner"] == owner:
                    self._chips[c] = {"owner": None, "state": "free"}
                    freed.append(c)
            self.releases_total += len(freed)
            return tuple(sorted(freed))

    def chips_of(self, owner) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(c for c, row in self._chips.items()
                                if row["owner"] == owner))

    def _counts_locked(self) -> dict:
        counts = {"free": 0, "leased": 0, "fenced": 0}
        for row in self._chips.values():
            counts[row["state"]] += 1
        return counts

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "chips": {c: dict(row)
                          for c, row in sorted(self._chips.items())},
                "counts": self._counts_locked(),
                "fences_total": self.fences_total,
                "releases_total": self.releases_total,
            }
