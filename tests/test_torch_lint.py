"""nnlint on the port (nnstreamer_tpu_torch/analysis/) against the JAX
package's (nnstreamer_tpu/analysis/, tests/test_lint.py).

The gates:

- the core is the JAX package's: on the same sources, both packages'
  `project_from_sources` + `run_rules` give the same findings
  (rule, path, line, col, message, suppressed) and fingerprints for every
  rule that keeps its form (NNL001, NNL003, NNL006-NNL008, NNL011,
  NNL013), on JAX's fixtures at JAX's paths and re-rooted at the port's;
  suppressions behave alike; a baseline one package writes, the other
  loads;
- each rule that takes a torch form (NNL002 forced-sync, NNL004
  jit-purity over CUDA-graph captures, NNL005 spawn-safety, NNL009
  placement, NNL010 device accounting, NNL012 shard safety; ROADMAP N42)
  fires on a bad fixture built from JAX's and stays silent on a good one;
- `element_contract` equals JAX's for every element both registries hold;
- the tree gate: `nnstreamer_tpu_torch/` lints clean against the port's
  own empty baseline;
- the `lint` subcommand: exit codes and the schema-1 `--json` report.

Fixtures are in-memory sources: the linter is pure AST, nothing here is
imported or executed.
"""

import json
from pathlib import Path

import pytest
import torch

from nnstreamer_tpu import analysis as jlint
from nnstreamer_tpu.analysis import rules as jrules
from nnstreamer_tpu_torch import analysis as tlint
from nnstreamer_tpu_torch.analysis import rules as trules

ROOT = Path(__file__).resolve().parents[1]
PORT_BASELINE = ROOT / "nnstreamer_tpu_torch" / "analysis" / \
    "nnlint_baseline.json"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run(pkg, rule_id, sources, baseline=None):
    return pkg.run_rules(pkg.project_from_sources(sources),
                         pkg.iter_rules([rule_id]), baseline)


def _rows(report):
    return [(f.rule, f.path, f.line, f.col, f.message, f.suppressed,
             f.fingerprint) for f in report.findings + report.suppressed]


def assert_fires(rule_id, sources, n_min=1):
    report = _run(tlint, rule_id, sources)
    assert len(report.findings) >= n_min, \
        f"{rule_id} should fire on the bad fixture: {_rows(report)}"
    assert all(f.rule == rule_id for f in report.findings)
    return report.findings


def assert_silent(rule_id, sources):
    report = _run(tlint, rule_id, sources)
    assert report.clean, \
        f"{rule_id} false positives: {[str(f) for f in report.findings]}"


# -- the rules that keep their form: JAX's fixtures through both packages ------

BAD_ELEMENT = '''
from nnstreamer_tpu.graph.pipeline import DYNAMIC, Element, SinkElement

class HalfTimer(Element):
    NUM_SINK_PADS = DYNAMIC
    def next_deadline(self):
        return None

class FusedTimer(Element):
    CHAIN_FUSABLE = True
    def next_deadline(self):
        return None
    def on_timer(self, now):
        pass

class ResidentSink(SinkElement):
    DEVICE_RESIDENT = True

class Mutator(Element):
    def __init__(self):
        self.CHAIN_FUSABLE = False
'''

GOOD_ELEMENT = '''
from nnstreamer_tpu.graph.pipeline import DYNAMIC, Element, SinkElement

class Batchy(Element):
    NUM_SINK_PADS = DYNAMIC
    CHAIN_FUSABLE = False
    def next_deadline(self):
        return None
    def on_timer(self, now):
        pass

class PlainSink(SinkElement):
    pass

class CallThrough(Element):
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = 1
'''

BAD_LOCK = '''
import time

class C:
    def f(self):
        with self._lock:
            time.sleep(0.1)

    def g(self, q):
        with self._state_lock:
            return q.get(timeout=1.0)

    def h(self, t):
        with self._lock:
            t.join()
'''

GOOD_LOCK = '''
import time

class C:
    def f(self):
        with self._lock:
            snapshot = dict(self._state)
        time.sleep(0.1)                     # blocking OUTSIDE the lock
        return snapshot

    def g(self):
        with self._lock:
            v = self._cache.get("key")      # dict.get, not a queue
        return v

    def h(self, data):
        with self.send_lock:
            self.sock.sendall(data)         # write-serialization lock

    def i(self, cv):
        with self._lock:
            def cb():
                time.sleep(1)               # nested def: not run here
            return cb
'''

BAD_ERRORS = '''
class NakedError(Exception):
    def __init__(self, what, code):
        super().__init__(f"{what} [{code}]")
'''

GOOD_ERRORS = '''
def _rebuild(cls, args):
    return cls.__new__(cls)

class BaseError(Exception):
    def __reduce__(self):
        return (_rebuild, (type(self), self.args))

class ChildError(BaseError):
    def __init__(self, what, code):
        super().__init__(f"{what} [{code}]")

class _PrivateScratch(Exception):
    pass

class NotAnError:
    pass
'''

BAD_THREAD = '''
import threading

def fire_and_forget(fn):
    threading.Thread(target=fn).start()
    threading.Timer(5.0, fn).start()
'''

GOOD_THREAD = '''
import threading

class Owner:
    def start(self, fn):
        self._t = threading.Thread(target=fn, daemon=True)
        self._t.start()
        self._timer = threading.Timer(5.0, fn)
        self._timer.daemon = True
        self._timer.start()
        self._j = threading.Thread(target=fn)
        self._j.start()

    def close(self):
        self._timer.cancel()
        self._j.join()

class Looper(threading.Thread):
    def __init__(self):
        super().__init__(daemon=True)
'''

BAD_SOCKET = '''
import socket

def dial(host, port):
    return socket.create_connection((host, port))   # unbounded dial

class Poller:
    def __init__(self):
        self._sock = socket.socket()                # no deadline, no owner

    def poll(self):
        return self._sock.recv(4)
'''

GOOD_SOCKET = '''
import socket
import threading

def dial(host, port):
    return socket.create_connection((host, port), 5.0)

def dial_kw(host, port):
    return socket.create_connection((host, port), timeout=5.0)

class Poller:
    def __init__(self):
        self._sock = socket.socket()
        self._sock.settimeout(2.0)                  # bounded

class Server:
    def __init__(self):
        self._srv = socket.socket()                 # accept-thread-owned
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while True:
            self._srv.accept()
'''

BAD_CHAOS_RNG = '''
import random
import numpy as np

def schedule_faults():
    jitter = random.Random()                 # OS-entropy: no replay
    rng = np.random.default_rng()            # ditto
    return jitter.random(), rng.random()
'''

GOOD_CHAOS_RNG = '''
import random
import numpy as np

def schedule_faults(seed):
    jitter = random.Random(seed)
    rng = np.random.default_rng(seed + 1)
    kw = np.random.default_rng(seed=seed)
    return jitter.random(), rng.random(), kw.random()
'''

BAD_SHM = '''
import mmap
import pickle
from multiprocessing import shared_memory

def open_segment(name, frames):
    seg = shared_memory.SharedMemory(name=name, create=True, size=4096)
    ring = mmap.mmap(-1, 4096)                     # second lifetime story
    for f in frames:
        blob = pickle.dumps(f)                     # per-frame re-serialize
        seg.buf[:len(blob)] = blob
    return seg, ring
'''

GOOD_SHM = '''
import pickle
from nnstreamer_tpu.serving.shm import ShmRing, ring_name

def open_rings(pool, wid, spawn, frames):
    ring = ShmRing.create(ring_name("rq", pool, wid, spawn))
    blob = pickle.dumps(frames)          # hoisted: once per batch
    for _ in frames:
        ring.try_write(blob)
    return ring
'''

#: (rule, JAX-rooted path (the port's: "nnstreamer_tpu" → its name), bad
#: source, minimum bad findings, good source)
SAME_FORM = [
    ("NNL001", "nnstreamer_tpu/elements/fix.py", BAD_ELEMENT, 4,
     GOOD_ELEMENT),
    ("NNL003", "nnstreamer_tpu/runtime/fix.py", BAD_LOCK, 3, GOOD_LOCK),
    ("NNL006", "nnstreamer_tpu/core/errors.py", BAD_ERRORS, 1, GOOD_ERRORS),
    ("NNL007", "nnstreamer_tpu/runtime/fix.py", BAD_THREAD, 2, GOOD_THREAD),
    ("NNL008", "nnstreamer_tpu/edge/fix.py", BAD_SOCKET, 2, GOOD_SOCKET),
    ("NNL011", "nnstreamer_tpu/traffic/fix.py", BAD_CHAOS_RNG, 2,
     GOOD_CHAOS_RNG),
    ("NNL011", "nnstreamer_tpu/serving/worker.py", BAD_CHAOS_RNG, 2,
     GOOD_CHAOS_RNG),
    ("NNL013", "nnstreamer_tpu/serving/fix.py", BAD_SHM, 4, GOOD_SHM),
    ("NNL013", "nnstreamer_tpu/runtime/fix.py", BAD_SHM, 3, GOOD_SHM),
]


def _root(path, port):
    return path.replace("nnstreamer_tpu/", "nnstreamer_tpu_torch/", 1) \
        if port else path


@pytest.mark.parametrize("port_root", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("case", SAME_FORM,
                         ids=[f"{c[0]}-{c[1].split('/', 1)[1]}"
                              for c in SAME_FORM])
def test_same_form_rule_findings_equal_jax(case, port_root):
    rid, path, bad, n_min, good = case
    path = _root(path, port_root)
    for src, fires in ((bad, True), (good, False)):
        ours = _run(tlint, rid, {path: src})
        theirs = _run(jlint, rid, {path: src})
        assert _rows(ours) == _rows(theirs)
        assert len(ours.findings) >= n_min if fires else ours.clean


@pytest.mark.parametrize("rid", ["NNL001", "NNL003", "NNL006", "NNL007",
                                 "NNL008", "NNL011", "NNL013"])
def test_same_form_rules_keep_the_catalog_entry(rid):
    ours = next(r for r in trules.ALL_RULES if r.rule_id == rid)
    theirs = next(r for r in jrules.ALL_RULES if r.rule_id == rid)
    assert (ours.title, ours.rationale) == (theirs.title, theirs.rationale)


# -- NNL002 forced-sync, torch form -------------------------------------------------

BACKEND = "nnstreamer_tpu_torch/backends/fix.py"
ELEM = "nnstreamer_tpu_torch/elements/fix.py"

BAD_SYNC = '''
import numpy as np
import torch

def f(x, ev, stream):
    torch.cuda.synchronize()
    ev.synchronize()
    stream.synchronize()
    n = x.item()
    rows = x.tolist()
    host = x.cpu()
    return np.asarray(x), n, rows, host
'''

GOOD_SYNC = '''
import numpy as np
from nnstreamer_tpu_torch.runtime.sync import device_sync, to_host

def f(x, tracer):
    out = np.asarray(device_sync(x, tracer=tracer, name="f"))
    host, = to_host((x,), tracer, "f")
    table = np.asarray([1, 2], np.int32)   # 2-arg dtype conversion
    cuts = np.cumsum([1, 2, 3])[:-1].tolist()   # a numpy value
    return out, host, table, cuts
'''


def test_nnl002_fires_on_direct_syncs_and_readbacks():
    found = assert_fires("NNL002", {BACKEND: BAD_SYNC}, n_min=7)
    msgs = " ".join(f.message for f in found)
    for what in ("torch.cuda.synchronize()", "ev.synchronize()",
                 "stream.synchronize()", ".item()", ".tolist()", ".cpu()",
                 "np.asarray"):
        assert what in msgs


def test_nnl002_silent_on_device_sync_idiom():
    assert_silent("NNL002", {BACKEND: GOOD_SYNC})


def test_nnl002_asarray_scoped_to_device_layers():
    assert_silent("NNL002", {
        ELEM: "import numpy as np\ndef f(x):\n    return np.asarray(x)\n"})
    # runtime/sync.py itself is the one place the primitives live
    assert_silent("NNL002", {
        "nnstreamer_tpu_torch/runtime/sync.py":
            "import torch\n"
            "def device_sync(t):\n"
            "    torch.cuda.current_stream().synchronize()\n"
            "    return t.cpu()\n"})


# -- NNL004 jit-purity over CUDA-graph captures -----------------------------------

RUNTIME = "nnstreamer_tpu_torch/runtime/fix.py"

BAD_CAPTURE = '''
import time
from nnstreamer_tpu_torch.backends import cuda_graphs

def impure(x):
    return x * time.time()

def windows(cache, key, inputs):
    def body(x):
        import random
        x.item()
        return x + random.random()
    cache.capture(key, body, inputs, what="window")
    return cuda_graphs.capture(impure, inputs, what="step")
'''

BAD_CAPTURE_CROSS_MAIN = '''
from nnstreamer_tpu_torch.backends.cuda_graphs import capture
from nnstreamer_tpu_torch.chelp import helper

g = capture(helper, [], what="helper")
'''

BAD_CAPTURE_CROSS_HELPER = '''
import time

def helper(x):
    return x * time.perf_counter()
'''

GOOD_CAPTURE = '''
import time
import torch
from nnstreamer_tpu_torch.backends import cuda_graphs

def pure(x):
    return torch.tanh(x) * 2.0

def windows(cache, key, inputs):
    def body(x):
        return pure(x) + 1.0
    t0 = time.perf_counter()          # outside the captured bodies
    cache.capture(key, body, inputs, what="window")
    g = cuda_graphs.capture(pure, inputs, what="step")
    return g, time.perf_counter() - t0
'''


def test_nnl004_fires_on_impure_captured_bodies():
    found = assert_fires("NNL004", {RUNTIME: BAD_CAPTURE}, n_min=3)
    msgs = " ".join(f.message for f in found)
    assert "time.time" in msgs and "random.random" in msgs \
        and "x.item" in msgs


def test_nnl004_follows_cross_module_imports():
    assert_fires("NNL004", {
        RUNTIME: BAD_CAPTURE_CROSS_MAIN,
        "nnstreamer_tpu_torch/chelp.py": BAD_CAPTURE_CROSS_HELPER})


def test_nnl004_silent_on_pure_captures():
    assert_silent("NNL004", {RUNTIME: GOOD_CAPTURE})


# -- NNL005 spawn-safety, torch form ------------------------------------------

WORKER = "nnstreamer_tpu_torch/serving/worker.py"
HELPER = "nnstreamer_tpu_torch/serving/spawn_helper.py"

BAD_SPAWN = {
    WORKER: "from nnstreamer_tpu_torch.serving import spawn_helper\n",
    HELPER: "import torch\n"
            "WARM = torch.zeros(4, device='cuda')\n"
            "DEV = torch.cuda.current_device()\n"
            "BUF = torch.ones(2).cuda()\n"
            "ON = torch.empty(2, device=torch.device('cuda', 0))\n",
}

GOOD_SPAWN = {
    WORKER: "from nnstreamer_tpu_torch.serving import spawn_helper\n",
    HELPER: "import torch\n"            # importing torch touches no device
            "HOST = torch.zeros(4)\n"
            "def warm(x):\n"            # lazy: runs on first call
            "    return torch.zeros(4, device='cuda') + x.cuda()\n",
}


def test_nnl005_fires_on_module_scope_cuda_work_in_worker_closure():
    found = assert_fires("NNL005", BAD_SPAWN, n_min=4)
    assert {f.path for f in found} == {HELPER}


def test_nnl005_silent_on_lazy_device_work():
    assert_silent("NNL005", GOOD_SPAWN)


def test_nnl005_ignores_modules_outside_the_closure():
    assert_silent("NNL005", {
        WORKER: "import os\n",
        "nnstreamer_tpu_torch/elements/heavy.py":
            "import torch\nX = torch.zeros(1, device='cuda')\n"})


# -- NNL009 placement, torch form ---------------------------------------------

BAD_PLACEMENT = '''
import torch

def pin(x, m):
    d = torch.device("cuda", 0)          # explicit ordinal picks
    e = torch.device("cuda:1")
    torch.cuda.set_device(2)
    y = x.to("cuda:3")
    return m.cuda(1), d, e, y
'''

GOOD_PLACEMENT = '''
import torch

def enumerate_all(x, ordinal):
    n = torch.cuda.device_count()        # counting is fine
    here = torch.device("cuda")          # the current device, no pick
    mine = torch.device("cuda", ordinal) # the caller's ordinal
    return x.to(here), x.cuda(), n, mine
'''


def test_nnl009_fires_on_explicit_device_pick():
    found = assert_fires("NNL009", {BACKEND: BAD_PLACEMENT}, n_min=5)
    assert all("placement" in f.message for f in found)


def test_nnl009_silent_on_enumeration_and_given_devices():
    assert_silent("NNL009", {BACKEND: GOOD_PLACEMENT})


def test_nnl009_blessed_in_placement_and_parallel():
    assert_silent("NNL009", {
        "nnstreamer_tpu_torch/serving/placement.py": BAD_PLACEMENT,
        "nnstreamer_tpu_torch/parallel/mesh.py": BAD_PLACEMENT,
    })


# -- NNL010 device accounting, torch form -------------------------------------

BAD_ACCOUNTING = '''
import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_TFLOPS = 989.0                 # second peak table: drift bait

def probe(fn, x):
    with FlopCounterMode(display=False) as c:
        fn(x)
    used = torch.cuda.memory_allocated(0)
    stats = torch.cuda.memory_stats(0)
    free, total = torch.cuda.mem_get_info(0)
    return c.get_total_flops(), used, stats, free
'''

GOOD_ACCOUNTING = '''
from nnstreamer_tpu_torch.runtime import devprof

def probe(fn, x):
    prof = devprof.get()
    prof.capture_cost("f", "static", lambda: fn(x), inputs=(x,))
    return prof.stats()
'''


def test_nnl010_fires_on_accounting_outside_devprof():
    found = assert_fires("NNL010", {BACKEND: BAD_ACCOUNTING}, n_min=5)
    msgs = " ".join(f.message for f in found)
    for what in ("FlopCounterMode", "memory_allocated", "memory_stats",
                 "mem_get_info", "PEAK_BF16_TFLOPS"):
        assert what in msgs


def test_nnl010_silent_on_profiler_reporting():
    assert_silent("NNL010", {BACKEND: GOOD_ACCOUNTING})


def test_nnl010_blessed_in_devprof():
    assert_silent("NNL010", {
        "nnstreamer_tpu_torch/runtime/devprof.py": BAD_ACCOUNTING})


# -- NNL012 shard safety, torch form ------------------------------------------

BAD_SHARDING = '''
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import distribute_tensor

def place(t):
    dist.init_process_group("gloo")
    mesh = init_device_mesh("cuda", (2,))
    placed = distribute_tensor(t, mesh)
    dist.all_reduce(t)
    torch.distributed.broadcast(t, 0)
    return DeviceMesh("cuda", [0, 1]), placed
'''

GOOD_SHARDING = '''
import torch.distributed as dist
from nnstreamer_tpu_torch.serving import sharding

def place(params, devs, n_heads):
    placed = sharding.shard_llm_params(params, devs, n_heads=n_heads)
    return placed, sharding.kv_pool_placer(devs), dist.is_initialized()
'''


def test_nnl012_fires_on_mesh_program_outside_subsystem():
    found = assert_fires("NNL012", {BACKEND: BAD_SHARDING}, n_min=9)
    msgs = " ".join(f.message for f in found)
    assert "from torch.distributed.device_mesh import" in msgs
    for what in ("init_process_group", "all_reduce", "broadcast",
                 "DeviceMesh", "distribute_tensor", "init_device_mesh"):
        assert what in msgs


def test_nnl012_silent_on_consuming_the_subsystem():
    assert_silent("NNL012", {BACKEND: GOOD_SHARDING})


def test_nnl012_blessed_in_parallel_and_sharding():
    assert_silent("NNL012", {
        "nnstreamer_tpu_torch/serving/sharding.py": BAD_SHARDING,
        "nnstreamer_tpu_torch/parallel/multihost.py": BAD_SHARDING,
    })


# -- suppressions, baselines, the report ---------------------------------------

def test_inline_suppression_equal_jax():
    src = BAD_LOCK.replace(
        "time.sleep(0.1)",
        "time.sleep(0.1)  # nnlint: disable=NNL003 wedge drill")
    for pkg in (tlint, jlint):
        report = _run(pkg, "NNL003", {RUNTIME: src})
        assert len(report.suppressed) == 1 and len(report.findings) == 2
    assert _rows(_run(tlint, "NNL003", {RUNTIME: src})) == \
        _rows(_run(jlint, "NNL003", {RUNTIME: src}))


def test_disable_all_and_unrelated_rule():
    src = ("import time\n"
           "class C:\n"
           "    def f(self):\n"
           "        with self._lock:\n"
           "            time.sleep(1)  # nnlint: disable=all wedge drill\n")
    assert_silent("NNL003", {RUNTIME: src})
    src_wrong = src.replace("disable=all", "disable=NNL001")
    assert len(_run(tlint, "NNL003", {RUNTIME: src_wrong}).findings) == 1
    # the torch-form rules honour the same grammar
    src = BAD_SYNC.replace("torch.cuda.synchronize()",
                           "torch.cuda.synchronize()  # nnlint: disable=all")
    assert len(_run(tlint, "NNL002", {BACKEND: src}).suppressed) == 1


@pytest.mark.parametrize("writer,reader", [(jlint, tlint), (tlint, jlint)],
                         ids=["jax-writes", "port-writes"])
def test_baseline_crosses_packages(tmp_path, writer, reader):
    sources = {RUNTIME: BAD_LOCK}
    report = _run(writer, "NNL003", sources)
    assert not report.clean
    bl = tmp_path / "baseline.json"
    writer.write_baseline(bl, report.findings)
    shifted = {RUNTIME: "# one\n# two\n" + BAD_LOCK}
    report2 = _run(reader, "NNL003", shifted, reader.load_baseline(bl))
    assert report2.clean and report2.baselined == len(report.findings)


def test_json_report_schema():
    report = _run(tlint, "NNL002", {BACKEND: BAD_SYNC})
    d = json.loads(json.dumps(report.to_json()))
    assert d["version"] == tlint.SCHEMA_VERSION == jlint.SCHEMA_VERSION == 1
    assert set(d) == {"version", "clean", "files", "rules", "counts",
                      "baselined", "suppressed", "findings"}
    assert d["clean"] is False
    assert d["counts"] == {"NNL002": len(d["findings"])}
    for f in d["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message",
                          "fingerprint", "suppressed"}
        assert f["line"] > 0 and len(f["fingerprint"]) == 16


def test_rule_catalog_matches_jax():
    ids = [r.rule_id for r in trules.ALL_RULES]
    assert ids == [r.rule_id for r in jrules.ALL_RULES] == \
        [f"NNL{i:03d}" for i in range(1, 14)]
    assert [r.title for r in trules.ALL_RULES] == \
        [r.title for r in jrules.ALL_RULES]
    for r in trules.ALL_RULES:
        assert r.title and r.rationale
    with pytest.raises(ValueError):
        tlint.iter_rules(["NNL999"])


def test_syntax_error_becomes_nnl000(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    p = tlint.build_project([str(bad)], root=tmp_path)
    r = tlint.run_rules(p, tlint.iter_rules(None))
    assert [f.rule for f in r.findings] == ["NNL000"]


# -- contract introspection -----------------------------------------------------

def test_element_contract_equal_jax_for_every_shared_element():
    import nnstreamer_tpu.elements  # noqa: F401
    import nnstreamer_tpu_torch.elements  # noqa: F401
    from nnstreamer_tpu.core.registry import PluginKind as JK
    from nnstreamer_tpu.core.registry import registry as jreg
    from nnstreamer_tpu_torch.analysis.contract import contract_badges
    from nnstreamer_tpu_torch.core.registry import PluginKind, registry

    names = set(registry.names(PluginKind.ELEMENT)) & set(
        jreg.names(JK.ELEMENT))
    assert len(names) > 40
    for n in sorted(names):
        ours = registry.get(PluginKind.ELEMENT, n)
        theirs = jreg.get(JK.ELEMENT, n)
        assert tlint.element_contract(ours) == \
            jlint.element_contract(theirs), n
        assert contract_badges(ours).startswith(
            "fusable" if tlint.element_contract(ours)["chain_fusable"]
            else ("device" if tlint.element_contract(ours)["device_resident"]
                  else ("timer" if tlint.element_contract(ours)["timer"]
                        else "pads")))


# -- the tier-1 gate and the subcommand ------------------------------------------

def test_port_tree_is_lint_clean():
    """The whole port lints clean against its committed (empty) baseline:
    new findings are fixed or inline-justified, never accumulated."""
    report = tlint.lint_report(["nnstreamer_tpu_torch"], root=ROOT,
                               baseline_path=PORT_BASELINE)
    assert report.files > 100
    assert report.clean, "unbaselined findings:\n" + "\n".join(
        str(f) for f in report.findings)
    assert report.baselined == 0
    assert json.loads(PORT_BASELINE.read_text()) == {"version": 1,
                                                     "findings": []}


def _lint(capsys, *args):
    from nnstreamer_tpu_torch.__main__ import main

    rc = main(["lint", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_lint_subcommand_exit_codes_and_json(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc, _, err = _lint(capsys)
    assert rc == 0 and "0 finding(s)" in err
    rc, out, _ = _lint(capsys, "nnstreamer_tpu_torch/analysis", "--json")
    d = json.loads(out)
    assert rc == 0 and d["version"] == 1 and d["clean"] is True
    assert d["files"] == 5 and d["findings"] == []
    rc, out, _ = _lint(capsys, "--list-rules")
    assert rc == 0 and all(f"NNL{i:03d}" in out for i in range(1, 14))
    rc, _, err = _lint(capsys, "--rules", "NNL999")
    assert rc == 2 and "unknown rule" in err
    # a tree with findings: exit 1, then baselined to exit 0
    bad = tmp_path / "pkg" / "backends" / "fix.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(BAD_SYNC)
    rc, out, _ = _lint(capsys, str(bad), "--rules", "NNL002", "--json")
    d = json.loads(out)
    assert rc == 1 and d["counts"] == {"NNL002": 7}
    bl = tmp_path / "bl.json"
    rc, out, _ = _lint(capsys, str(bad), "--baseline", str(bl),
                       "--write-baseline")
    assert rc == 0 and "wrote 7" in out
    rc, _, _ = _lint(capsys, str(bad), "--baseline", str(bl))
    assert rc == 0
    rc, _, err = _lint(capsys, str(tmp_path / "nothing"))
    assert rc == 2 and "no python files" in err
