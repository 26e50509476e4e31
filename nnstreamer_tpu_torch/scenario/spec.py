"""Declarative seeded scenario specs — the adversarial world as data.

A `ScenarioSpec` is the whole drill written down: a topology (one
bounded pool or a multi-host mesh, optionally with a weighted-fair
tenant table), a set of arrival programs (what load arrives when, per
tenant), and a set of fault programs (what breaks when). Everything
random — arrival traces, kill victim choice, ChaosProxy fault
placement — derives from the spec's ONE root seed through
`derive_seed`, a stable hash over (root, label path), so:

- the whole world replays bit-exact from the spec alone;
- shrinking (scenario/shrink.py) can delete programs without moving
  any surviving program's randomness, because sub-seeds key off each
  program's stable ``label``, not its list position.

Validation is eager and typed, the `SLOSpec`/`TenantTable` discipline:
`from_dict` refuses unknown program kinds, unknown keys, negative
rates/counts, and malformed tenant names at load — a spec that
constructs is a spec the executor can run. JSON round-trips exactly
(``from_json(spec.to_json())`` reproduces the spec, labels included),
and a spec the JAX package wrote loads here unchanged.

Program catalog: the docstrings of `ArrivalProgram` and `FaultProgram`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from nnstreamer_tpu_torch.traffic.admission import SHED_POLICIES

#: arrival program kinds (traffic/loadgen.py arrival processes)
ARRIVAL_KINDS = ("constant", "poisson", "bursty", "diurnal",
                 "flash_crowd")
#: fault program kinds the executor can compile
FAULT_KINDS = ("worker_kill", "blackhole", "slow_close", "swap_storm",
               "tenant_flood")
TOPOLOGY_KINDS = ("pool", "mesh")

#: net faults need a ChaosProxy in front of a host — mesh-only
_NET_FAULTS = ("blackhole", "slow_close")

_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_.-]{0,63}$")


def derive_seed(root: int, *labels) -> int:
    """Stable 63-bit sub-seed from one root seed and a label path.
    hashlib, not `hash()` — PYTHONHASHSEED must not be able to change
    where a scenario's faults land between processes."""
    key = ":".join([str(int(root))] + [str(x) for x in labels])
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def _check_name(what: str, name) -> str:
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"{what} must match {_NAME_RE.pattern!r}, got {name!r}")
    return name


def _check_pos(what: str, v, *, zero_ok: bool = False) -> float:
    if not isinstance(v, (int, float)) or isinstance(v, bool) \
            or (v < 0 if zero_ok else v <= 0):
        bound = ">= 0" if zero_ok else "> 0"
        raise ValueError(f"{what} must be a number {bound}, got {v!r}")
    return float(v)


def _from_dict(cls, d: dict, what: str):
    """Typed, closed-world dataclass construction: unknown keys refuse
    (a typo'd knob must not silently become a default)."""
    if not isinstance(d, dict):
        raise ValueError(f"{what} must be an object, got {type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{what}: unknown key(s) {sorted(unknown)}; "
                         f"expected a subset of {sorted(names)}")
    return cls(**d)


@dataclass(frozen=True)
class ArrivalProgram:
    """One load segment: `n` requests whose peak rate is ``rate_x`` ×
    the topology's aggregate capacity, starting at ``start_s`` on the
    scenario clock, attributed to ``tenant`` (None = untagged). Shape
    knobs by kind:

    - ``constant``     — evenly spaced at the peak rate.
    - ``poisson``      — memoryless at the peak rate.
    - ``bursty``       — Markov on/off between rate_x and
                         rate_x*low_x, exponential ``mean_dwell_s``.
    - ``diurnal``      — sinusoid between rate_x*low_x and rate_x,
                         period ``period_s``.
    - ``flash_crowd``  — rate_x*low_x until ``ramp_at_s``, then a
                         linear ramp to rate_x over ``ramp_s``.

    ``label`` is the stable sub-seed key (auto-assigned ``a<i>`` by
    `ScenarioSpec` when empty) — it, not list position, decides where
    this program's randomness comes from."""

    kind: str
    n: int
    rate_x: float
    start_s: float = 0.0
    tenant: Optional[str] = None
    label: str = ""
    low_x: float = 0.25
    mean_dwell_s: float = 0.25
    period_s: float = 2.0
    ramp_at_s: float = 0.5
    ramp_s: float = 0.5

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; "
                             f"expected one of {ARRIVAL_KINDS}")
        if not isinstance(self.n, int) or isinstance(self.n, bool) \
                or self.n < 1:
            raise ValueError(f"arrival n must be an int >= 1, "
                             f"got {self.n!r}")
        _check_pos("arrival rate_x", self.rate_x)
        _check_pos("arrival start_s", self.start_s, zero_ok=True)
        if not (isinstance(self.low_x, (int, float))
                and 0 < self.low_x <= 1):
            raise ValueError(f"arrival low_x must be in (0, 1], "
                             f"got {self.low_x!r}")
        _check_pos("arrival mean_dwell_s", self.mean_dwell_s)
        _check_pos("arrival period_s", self.period_s)
        _check_pos("arrival ramp_at_s", self.ramp_at_s, zero_ok=True)
        _check_pos("arrival ramp_s", self.ramp_s)
        if self.tenant is not None:
            _check_name("arrival tenant", self.tenant)
        if self.label:
            _check_name("arrival label", self.label)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalProgram":
        return _from_dict(cls, d, "arrival program")


@dataclass(frozen=True)
class FaultProgram:
    """One scheduled fault at ``at_s`` on the scenario clock:

    - ``worker_kill``  — SIGKILL ``kills`` rng-chosen workers (on mesh,
                         in ``host``'s pool), staggered 0.25s apart.
    - ``blackhole``    — silently partition ``host`` (mesh only; a
                         seeded ChaosProxy program), healing after
                         ``heal_after_s`` when set.
    - ``slow_close``   — freeze ``host``'s link without closing for
                         ``linger_s`` (mesh only).
    - ``swap_storm``   — ``swaps`` back-to-back two-phase model-swap
                         broadcasts, ``interval_s`` apart.
    - ``tenant_flood`` — ``n`` extra Poisson requests at ``rate_x`` ×
                         capacity from ``tenant``, starting at at_s
                         (compiled into the arrival timeline).

    ``label`` is the stable sub-seed key (auto-assigned ``f<i>``)."""

    kind: str
    at_s: float
    label: str = ""
    host: int = 0
    kills: int = 1
    heal_after_s: Optional[float] = None
    linger_s: float = 0.5
    swaps: int = 4
    interval_s: float = 0.1
    tenant: Optional[str] = None
    rate_x: float = 3.0
    n: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        _check_pos("fault at_s", self.at_s, zero_ok=True)
        if not isinstance(self.host, int) or isinstance(self.host, bool) \
                or self.host < 0:
            raise ValueError(f"fault host must be an int >= 0, "
                             f"got {self.host!r}")
        if self.kind == "worker_kill" and self.kills < 1:
            raise ValueError(f"worker_kill kills must be >= 1, "
                             f"got {self.kills!r}")
        if self.heal_after_s is not None:
            _check_pos("fault heal_after_s", self.heal_after_s)
        _check_pos("fault linger_s", self.linger_s)
        if self.kind == "swap_storm":
            if self.swaps < 1:
                raise ValueError(f"swap_storm swaps must be >= 1, "
                                 f"got {self.swaps!r}")
            _check_pos("swap_storm interval_s", self.interval_s)
        if self.kind == "tenant_flood":
            if self.tenant is None:
                raise ValueError("tenant_flood requires a tenant name")
            if not isinstance(self.n, int) or self.n < 1:
                raise ValueError(f"tenant_flood n must be an int >= 1, "
                                 f"got {self.n!r}")
            _check_pos("tenant_flood rate_x", self.rate_x)
        if self.tenant is not None:
            _check_name("fault tenant", self.tenant)
        if self.label:
            _check_name("fault label", self.label)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultProgram":
        return _from_dict(cls, d, "fault program")


@dataclass(frozen=True)
class Topology:
    """The world the drill runs against: ``pool`` is one bounded
    subprocess worker pool (serving/pool.py); ``mesh`` is ``hosts``
    pool hosts behind a MeshRouter (serving/mesh.py), ``workers`` per
    host. ``tenants`` (name → TenantClass kwargs) installs the
    weighted-fair admission front on whichever door the load enters."""

    kind: str = "pool"
    workers: int = 2
    hosts: int = 1
    service_ms: float = 5.0
    max_pending: int = 32
    shed_policy: str = "reject-oldest"
    lease_s: float = 1.0
    max_redeliver: int = 2
    tenants: Dict[str, dict] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in TOPOLOGY_KINDS:
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             f"expected one of {TOPOLOGY_KINDS}")
        if not isinstance(self.workers, int) or self.workers < 1:
            raise ValueError(f"workers must be an int >= 1, "
                             f"got {self.workers!r}")
        if not isinstance(self.hosts, int) or self.hosts < 1:
            raise ValueError(f"hosts must be an int >= 1, "
                             f"got {self.hosts!r}")
        if self.kind == "pool" and self.hosts != 1:
            raise ValueError("pool topology has exactly 1 host; use "
                             "kind='mesh' for multi-host worlds")
        _check_pos("service_ms", self.service_ms)
        if not isinstance(self.max_pending, int) or self.max_pending < 1:
            raise ValueError(f"max_pending must be an int >= 1, "
                             f"got {self.max_pending!r}")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy "
                             f"{self.shed_policy!r}; expected one of "
                             f"{tuple(SHED_POLICIES)}")
        _check_pos("lease_s", self.lease_s)
        if not isinstance(self.max_redeliver, int) \
                or self.max_redeliver < 0:
            raise ValueError(f"max_redeliver must be an int >= 0, "
                             f"got {self.max_redeliver!r}")
        if not isinstance(self.tenants, dict):
            raise ValueError("tenants must map name -> class kwargs")
        for name, kw in self.tenants.items():
            _check_name("tenant name", name)
            if not isinstance(kw, dict):
                raise ValueError(f"tenant {name!r} config must be an "
                                 f"object, got {type(kw).__name__}")

    @property
    def capacity_rps(self) -> float:
        return self.hosts * self.workers * 1e3 / self.service_ms

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        return _from_dict(cls, d, "topology")


@dataclass(frozen=True)
class ScenarioSLO:
    """Per-scenario assertions layered on the four standing invariants:
    zero lost is on by default (the repo-wide contract); the p99 gate
    is opt-in (``enforce_p99``) because wall-clock latency on a loaded
    CI host is not deterministic the way the books are."""

    p99_budget_ms: float = 250.0
    require_zero_lost: bool = True
    require_recovered: bool = False
    enforce_p99: bool = False
    max_shed_rate: Optional[float] = None

    def __post_init__(self):
        _check_pos("slo p99_budget_ms", self.p99_budget_ms)
        if self.max_shed_rate is not None and not (
                isinstance(self.max_shed_rate, (int, float))
                and 0 <= self.max_shed_rate <= 1):
            raise ValueError(f"max_shed_rate must be in [0, 1], "
                             f"got {self.max_shed_rate!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSLO":
        return _from_dict(cls, d, "slo")


@dataclass(frozen=True)
class ScenarioSpec:
    """One replayable adversarial world (module docstring)."""

    name: str
    seed: int
    topology: Topology
    arrivals: Tuple[ArrivalProgram, ...]
    faults: Tuple[FaultProgram, ...] = ()
    slo: ScenarioSLO = field(default_factory=ScenarioSLO)

    def __post_init__(self):
        _check_name("scenario name", self.name)
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if not isinstance(self.topology, Topology):
            raise ValueError("topology must be a Topology")
        arrivals = tuple(self.arrivals)
        faults = tuple(self.faults)
        if not arrivals or not all(isinstance(a, ArrivalProgram)
                                   for a in arrivals):
            raise ValueError("arrivals must be a non-empty list of "
                             "arrival programs")
        if not all(isinstance(f, FaultProgram) for f in faults):
            raise ValueError("faults must be fault programs")
        if not isinstance(self.slo, ScenarioSLO):
            raise ValueError("slo must be a ScenarioSLO")
        # auto-assign stable labels by ORIGINAL position; a shrink that
        # deletes programs keeps every survivor's label (and therefore
        # its derived randomness) unchanged
        arrivals = tuple(
            dataclasses.replace(a, label=a.label or f"a{i}")
            for i, a in enumerate(arrivals))
        faults = tuple(
            dataclasses.replace(f, label=f.label or f"f{i}")
            for i, f in enumerate(faults))
        for what, progs in (("arrival", arrivals), ("fault", faults)):
            labels = [p.label for p in progs]
            if len(set(labels)) != len(labels):
                raise ValueError(f"duplicate {what} labels: {labels}")
        object.__setattr__(self, "arrivals", arrivals)
        object.__setattr__(self, "faults", faults)
        # cross-checks the executor relies on
        for f in faults:
            if f.kind in _NET_FAULTS and self.topology.kind != "mesh":
                raise ValueError(
                    f"{f.kind} fault ({f.label}) needs a mesh topology "
                    f"(a ChaosProxy in front of a host)")
            if f.kind in _NET_FAULTS + ("worker_kill",) \
                    and f.host >= self.topology.hosts:
                raise ValueError(
                    f"fault {f.label} targets host {f.host} but the "
                    f"topology has {self.topology.hosts} host(s)")
        if self.topology.tenants:
            known = set(self.topology.tenants)
            for a in arrivals:
                if a.tenant is not None and a.tenant not in known:
                    raise ValueError(
                        f"arrival {a.label} names unknown tenant "
                        f"{a.tenant!r}; declared: {sorted(known)}")
            for f in faults:
                if f.kind == "tenant_flood" and f.tenant not in known:
                    raise ValueError(
                        f"tenant_flood {f.label} names unknown tenant "
                        f"{f.tenant!r}; declared: {sorted(known)}")

    # -- seeds -------------------------------------------------------------
    def sub_seed(self, *labels) -> int:
        """The sub-seed for one labelled consumer of this scenario's
        randomness (an arrival program, a fault, a proxy)."""
        return derive_seed(self.seed, *labels)

    # -- size (the shrinker's strictly-smaller metric) ---------------------
    def size(self) -> int:
        return (len(self.faults) + len(self.arrivals)
                + sum(a.n for a in self.arrivals)
                + sum(f.n for f in self.faults
                      if f.kind == "tenant_flood"))

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "topology": self.topology.to_dict(),
            "arrivals": [a.to_dict() for a in self.arrivals],
            "faults": [f.to_dict() for f in self.faults],
            "slo": self.slo.to_dict(),
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        if not isinstance(d, dict):
            raise ValueError(f"scenario spec must be an object, "
                             f"got {type(d).__name__}")
        unknown = set(d) - {"name", "seed", "topology", "arrivals",
                            "faults", "slo"}
        if unknown:
            raise ValueError(
                f"scenario spec: unknown key(s) {sorted(unknown)}")
        if "name" not in d or "seed" not in d:
            raise ValueError("scenario spec needs 'name' and 'seed'")
        arrivals = d.get("arrivals")
        if not isinstance(arrivals, list):
            raise ValueError("scenario spec needs an 'arrivals' list")
        return cls(
            name=d["name"],
            seed=d["seed"],
            topology=Topology.from_dict(d.get("topology") or {}),
            arrivals=tuple(ArrivalProgram.from_dict(a)
                           for a in arrivals),
            faults=tuple(FaultProgram.from_dict(f)
                         for f in (d.get("faults") or [])),
            slo=ScenarioSLO.from_dict(d.get("slo") or {}),
        )

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        try:
            d = json.loads(text)
        except ValueError as e:
            raise ValueError(f"scenario spec is not valid JSON: {e}")
        return cls.from_dict(d)
