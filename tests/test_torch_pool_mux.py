"""The port's worker pool serving models, on the CPU, against the JAX
package's pool: pipeline mode with the normalize kernel in a child, and
multiplex mode over the probe models (JAX `tests/test_tenancy.py`'s
multiplex pool cases).

- Pipeline mode: `tensor_filter framework=pallas model=normalize_u8` in
  each child (its plain version on CPU tensors) against JAX's pool on the
  same u8 frames, within 1e-6; the child picks its device through
  `pick_device` (``cpu`` here, from the inherited environment), and a
  child with no CUDA device and no CPU request fails its handshake with
  the BackendError that names the fix — it never serves on the CPU. A
  preload recipe the store refuses fails the handshake the same way.
- Multiplex mode (three probe models, one per tenant class; a value
  names its model and version): the wire round trip equal to JAX's pool
  on the same frames, per-class conservation; a rebind, two-phase,
  refused for an unknown model; the tenancy `ScalingController` bound to
  the live pool's `rebind`; a hot swap of one model to a preloaded
  version leaving the others untouched; a swap to a version no worker
  has aborts everywhere.

No assertion reads a wall clock (a wait for the refused slot's circuit
is bounded, not timed).
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge import protocol as JP
from nnstreamer_tpu.edge import wire as jwire
from nnstreamer_tpu.edge.query import QueryServer as JQueryServer
from nnstreamer_tpu.serving.pool import PooledQueryServer as JPooled
from nnstreamer_tpu.serving.tenancy import TenantTable as JTable
from nnstreamer_tpu.serving.worker import WorkerSpec as JSpec
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic.loadgen import _tenant_conservation_ok
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.edge import protocol as TP
from nnstreamer_tpu_torch.edge import wire as twire
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.serving.pool import PooledQueryServer, proc_alive
from nnstreamer_tpu_torch.serving.tenancy import (
    TENANT_META, ScalingController, TenantTable)
from nnstreamer_tpu_torch.serving.worker import WorkerSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

pytestmark = pytest.mark.tenant

_sid = itertools.count(19500)

_MUX_TENANTS = {
    "default": "team-a",
    "tenants": [
        {"name": "team-a", "weight": 2.0, "model": "probe_scale"},
        {"name": "team-b", "model": "probe_negate"},
        {"name": "team-c", "model": "probe_offset"},
    ]}

_X = np.arange(8, dtype=np.float32).reshape(8, 1)

#: tenant -> expected output for input _X (probe model arithmetic)
_EXPECT = {"team-a": _X * 2.0, "team-b": -_X, "team-c": _X + 10.0}


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    # spawned children inherit the environment: the CPU, one BLAS
    # thread each
    mp = pytest.MonkeyPatch()
    mp.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    mp.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield mp
    QueryServer.reset_all()
    JQueryServer.reset_all()
    torch.set_num_threads(threads)
    mp.undo()


class _Client:
    """Minimal query-wire client of either package that keeps decoded
    RESULT buffers by pts."""

    def __init__(self, port, dims="8:1", types="float32", pkg="port"):
        self.P, self.wire = {"port": (TP, twire),
                             "jax": (JP, jwire)}[pkg]
        self.results = {}
        self.busy = {}
        self._evt = threading.Event()
        self._hello = threading.Event()
        self._want = 0
        self._lock = threading.Lock()
        self.c = self.P.MsgClient("127.0.0.1", port, on_message=self._on)
        self.c.send(self.P.T_HELLO,
                    json.dumps({"dims": dims, "types": types}).encode())
        assert self._hello.wait(10)

    def _on(self, mtype, payload):
        P = self.P
        if mtype in (P.T_HELLO_ACK, P.T_HELLO_NAK):
            self._hello.set()
            return
        with self._lock:
            if mtype == P.T_RESULT:
                buf, _ = self.wire.decode_buffer(payload)
                self.results[int(buf.pts)] = buf
            elif mtype == P.T_BUSY:
                info = json.loads(payload.decode())
                if info.get("pts") is not None:
                    self.busy[int(info["pts"])] = info
            if len(self.results) + len(self.busy) >= self._want:
                self._evt.set()

    def ask(self, frames):
        with self._lock:
            self._want = len(self.results) + len(self.busy) + len(frames)
            self._evt.clear()
        for b in frames:
            self.c.send(self.P.T_DATA, self.wire.encode_buffer(b))
        assert self._evt.wait(60), "pool did not answer in time"

    def close(self):
        self.c.close()


def _tenant_frame(i, tenant, Buffer=TensorBuffer):
    return Buffer.of(_X, pts=i).with_meta(**{TENANT_META: tenant})


# -- pipeline mode: the normalize kernel in a child ---------------------------

_NORM = "tensor_filter framework=pallas model=normalize_u8"


def _u8_frames(n):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8)
            for _ in range(n)]


def test_pipeline_pool_normalize_matches_jax_pool():
    frames = _u8_frames(6)
    out = {}
    for pkg, Pooled, Spec, Buffer in (
            ("port", PooledQueryServer, WorkerSpec, TensorBuffer),
            ("jax", JPooled, JSpec, JBuffer)):
        pqs = Pooled(Spec(kind="pipeline", pipeline=_NORM,
                          dims="3:16:16:1", types="uint8"),
                     workers=2 if pkg == "port" else 1, sid=next(_sid),
                     ready_timeout_s=60.0)
        try:
            if pkg == "port":
                st = pqs.stats()
                assert {w["device"] for w in st["workers"]} == {"cpu"}
                assert pqs.pool.spec.workers == 2
            cli = _Client(pqs.port, dims="3:16:16:1", types="uint8",
                          pkg=pkg)
            try:
                cli.ask([Buffer.of(f, pts=i)
                         for i, f in enumerate(frames)])
                assert not cli.busy
                out[pkg] = [np.asarray(cli.results[i].tensors[0])
                            for i in range(len(frames))]
            finally:
                cli.close()
            assert _tenant_conservation_ok(pqs.admission_counters())
        finally:
            pids = pqs.pool.all_pids_ever()
            pqs.close()
        assert not any(proc_alive(p) for p in pids)
    for a, b in zip(out["port"], out["jax"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_pipeline_child_without_cuda_or_cpu_request_refuses(_cpu_port):
    """No device and no CPU request: the child's handshake fails with
    pick_device's BackendError (naming accelerator=cpu); the slot never
    becomes ready, so nothing is served on the CPU behind the caller's
    back."""
    _cpu_port.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR")
    try:
        pqs = PooledQueryServer(
            WorkerSpec(kind="pipeline", pipeline=_NORM,
                       dims="3:16:16:1", types="uint8"),
            workers=1, sid=next(_sid), ready_timeout_s=0,
            restart_budget=0)
        try:
            deadline = time.monotonic() + 30
            while pqs.pool.degraded < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert pqs.pool.degraded == 1     # the slot never served
            err = pqs.pool.last_worker_error
            assert isinstance(err, BackendError), err
            assert "accelerator=cpu" in str(err)
            assert pqs.pool.ready_workers() == 0
        finally:
            pids = pqs.pool.all_pids_ever()
            pqs.close()
        assert not any(proc_alive(p) for p in pids)
    finally:
        _cpu_port.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")


def test_preloads_idempotent_and_a_bad_recipe_fails_the_handshake(
        _cpu_port):
    """`_register_preloads` leaves a version already held as it is (a
    restart, a double preload) and raises on any other error; in a child
    that error fails the handshake with the store's own message, instead
    of showing up later as a swap the worker cannot prepare."""
    from nnstreamer_tpu_torch.serving.store import get_store, reset_store
    from nnstreamer_tpu_torch.serving.worker import _register_preloads

    reset_store()
    try:
        recipe = (("probe_scale", 1, "zoo://probe_scale?scale=3.0"),)
        _register_preloads(recipe)
        _register_preloads(recipe)
        assert sorted(get_store().entry("probe_scale").versions) == [0, 1]
        with pytest.raises(ValueError):
            _register_preloads((("probe_scale", 2),))
        with pytest.raises(BackendError, match="probe_scale@3"):
            _register_preloads((("probe_scale", 3, 42),))
    finally:
        reset_store()
    pqs = PooledQueryServer(
        WorkerSpec(kind="echo", preload=(("probe_scale", 3, 42),)),
        workers=1, sid=next(_sid), ready_timeout_s=0, restart_budget=0)
    try:
        deadline = time.monotonic() + 30
        while pqs.pool.degraded < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pqs.pool.degraded == 1 and pqs.pool.ready_workers() == 0
        err = pqs.pool.last_worker_error
        assert isinstance(err, BackendError), err
        assert "probe_scale@3" in str(err)
    finally:
        pids = pqs.pool.all_pids_ever()
        pqs.close()
    assert not any(proc_alive(p) for p in pids)


# -- multiplex mode -----------------------------------------------------------

@pytest.fixture(scope="module")
def mux_pool(_cpu_port):
    """One 2-worker multiplex pool over the probe models, with a
    preloaded probe_scale@1 (scale 3) for the swap case; the cases below
    run in file order against it."""
    table = TenantTable.from_dict(_MUX_TENANTS)
    spec = WorkerSpec(
        kind="multiplex", dims="8:1", types="float32",
        tenants=table.to_dict(),
        preload=(("probe_scale", 1, "zoo://probe_scale?scale=3.0"),))
    pqs = PooledQueryServer(spec, workers=2, sid=next(_sid),
                            tenants=table, ready_timeout_s=60.0)
    yield pqs
    pids = pqs.pool.all_pids_ever()
    pqs.close()
    assert not any(proc_alive(p) for p in pids)


def _mixed_frames(Buffer):
    frames, want = [], {}
    i = 0
    for _ in range(3):
        for tenant, exp in _EXPECT.items():
            frames.append(_tenant_frame(i, tenant, Buffer))
            want[i] = exp
            i += 1
    return frames, want


def test_multiplex_round_trip_equals_jax_pool(mux_pool):
    frames, want = _mixed_frames(TensorBuffer)
    cli = _Client(mux_pool.port)
    try:
        cli.ask(frames)
        assert not cli.busy
        got = {p: np.asarray(b.tensors[0]) for p, b in cli.results.items()}
    finally:
        cli.close()
    c = mux_pool.admission_counters()
    for t in ("team-a", "team-b", "team-c"):
        assert c["classes"][t]["replied"] == 3
    assert _tenant_conservation_ok(c)
    for pts, exp in want.items():
        np.testing.assert_array_equal(got[pts], exp)
    # JAX's pool on the same frames: the same answers, bit for bit
    jtable = JTable.from_dict(_MUX_TENANTS)
    jpqs = JPooled(JSpec(kind="multiplex", dims="8:1", types="float32",
                         tenants=jtable.to_dict()),
                   workers=1, sid=next(_sid), tenants=jtable,
                   ready_timeout_s=60.0)
    try:
        jframes, _ = _mixed_frames(JBuffer)
        jcli = _Client(jpqs.port, pkg="jax")
        try:
            jcli.ask(jframes)
            jgot = {p: np.asarray(b.tensors[0])
                    for p, b in jcli.results.items()}
        finally:
            jcli.close()
        jc = jpqs.admission_counters()
    finally:
        jpqs.close()
    assert sorted(jgot) == sorted(got)
    for pts in got:
        np.testing.assert_array_equal(got[pts], jgot[pts])
    assert {t: jc["classes"][t]["replied"] for t in jc["classes"]} == \
        {t: 3 for t in ("team-a", "team-b", "team-c")}


def test_multiplex_rebind_two_phase_epoch_and_bindings(mux_pool):
    epoch = mux_pool.pool.epoch
    rep = mux_pool.rebind({0: "probe_scale", 1: "probe_negate"})
    assert rep["ok"], rep
    assert mux_pool.pool.epoch == epoch + 1
    assert mux_pool.pool.bindings() == {0: "probe_scale",
                                        1: "probe_negate"}
    # unknown model: every worker aborts, nothing changes
    rep = mux_pool.rebind({0: "nope"})
    assert not rep["ok"]
    assert mux_pool.pool.epoch == epoch + 1
    assert mux_pool.pool.bindings() == {0: "probe_scale",
                                        1: "probe_negate"}
    cli = _Client(mux_pool.port)
    try:
        cli.ask([_tenant_frame(i, t) for i, t in
                 ((100, "team-a"), (101, "team-b"), (102, "team-c"))])
        np.testing.assert_array_equal(cli.results[100].tensors[0], _X * 2)
        np.testing.assert_array_equal(cli.results[101].tensors[0], -_X)
        np.testing.assert_array_equal(cli.results[102].tensors[0],
                                      _X + 10)
    finally:
        cli.close()


class _Rates:
    def __init__(self, rates):
        self.rates = rates

    def tenant_summary(self):
        return {t: {"count": 10, "rate_hz": r, "p50_ms": 1.0,
                    "p99_ms": 2.0} for t, r in self.rates.items()}


def test_scaling_controller_drives_the_live_pool(mux_pool):
    """The tenancy scaler's plan reaches the workers through the pool's
    two-phase rebind: demand for team-c's model takes slot 1 from
    probe_negate, in one epoch; a steady plan rebinds nothing."""
    table = TenantTable.from_dict({"tenants": [
        {"name": "team-a", "model": "probe_scale"},
        {"name": "team-c", "model": "probe_offset"}]})
    mux_pool.rebind({0: "probe_scale", 1: "probe_negate"})
    epoch = mux_pool.pool.epoch
    ctrl = ScalingController(mux_pool.pool, table,
                             _Rates({"team-a": 30.0, "team-c": 10.0}),
                             interval_s=999.0)
    assert ctrl.tick()
    assert mux_pool.pool.bindings() == {0: "probe_scale",
                                        1: "probe_offset"}
    assert mux_pool.pool.epoch == epoch + 1
    st = ctrl.stats()
    assert st["rebinds"] == 1 and st["rebind_failures"] == 0
    ctrl.tick()                       # same rates: plan == binding
    assert ctrl.stats()["rebinds"] == 1
    assert mux_pool.pool.epoch == epoch + 1


def test_multiplex_hot_swap_one_model_leaves_others(mux_pool):
    cli = _Client(mux_pool.port)
    try:
        cli.ask([_tenant_frame(200, "team-a")])
        np.testing.assert_array_equal(cli.results[200].tensors[0], _X * 2)
        epoch = mux_pool.pool.epoch
        rep = mux_pool.swap("probe_scale", 1)
        assert rep["ok"], rep
        assert mux_pool.pool.epoch == epoch + 1     # all-or-none bump
        assert all(w["prepare_ok"] and w["commit_ok"]
                   for w in rep["workers"].values())
        cli.ask([_tenant_frame(i, t) for i, t in
                 ((201, "team-a"), (202, "team-b"), (203, "team-c"))])
        # the swapped tenant sees @1; the other models are untouched
        np.testing.assert_array_equal(cli.results[201].tensors[0], _X * 3)
        np.testing.assert_array_equal(cli.results[202].tensors[0], -_X)
        np.testing.assert_array_equal(cli.results[203].tensors[0],
                                      _X + 10)
    finally:
        cli.close()


def test_multiplex_swap_unknown_version_aborts_all(mux_pool):
    epoch = mux_pool.pool.epoch
    rep = mux_pool.swap("probe_scale", 7)    # no such version
    assert not rep["ok"]
    assert mux_pool.pool.epoch == epoch       # epoch did not move
    assert all("no version @7" in (w["error"] or "")
               for w in rep["workers"].values())
