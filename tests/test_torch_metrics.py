"""The metrics plane on the port (nnstreamer_tpu_torch/serving/metrics.py)
against the JAX package's, on the CPU: JAX `tests/test_metrics.py`'s
exposition, server, mesh/shard exposition and top cases, each run on
both packages, and the port's `render_prometheus` text equal to JAX's
for the same snapshot inputs (admission, pool, mesh, replicas, segments,
autotune, llm, tracer fed the same records, extra gauges).

The mesh and shard cases feed stats dicts built here, so both packages
render the same input; the exposition is the same function of those
dicts. A live port router's `stats()` rendered by both packages is held
equal in tests/test_torch_mesh.py.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu.runtime import tracing as jtr
from nnstreamer_tpu.serving import metrics as jm
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu_torch.runtime import tracing as ttr
from nnstreamer_tpu_torch.serving import metrics as tm
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

PKGS = {"port": (tm, ttr, TensorBuffer), "jax": (jm, jtr, JBuffer)}


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PKGS[request.param]


def _admission(offered=10, admitted=8, replied=7, depth=1, inflight=0):
    return {"offered": offered, "admitted": admitted, "replied": replied,
            "rejected": {"queue_full": offered - admitted},
            "shed": {"expired": admitted - replied - depth - inflight},
            "depth": depth, "inflight": inflight, "depth_peak": 4,
            "max_pending": 8, "max_inflight": 0,
            "shed_policy": "reject-newest"}


def _pool(replied=(4, 3)):
    return {"pool": {"workers": len(replied), "live": len(replied),
                     "ready": len(replied), "degraded": 0, "restarts": 1,
                     "kills": 0, "reoffered": 2, "pending": 0,
                     "epoch": 0},
            "workers": [{"wid": i, "pid": 100 + i, "state": "ready",
                         "inflight": 0, "hb_age_ms": 1.0, "restarts": i,
                         "kills": 0, "replied": r}
                        for i, r in enumerate(replied)]}


def _mesh(replied=(9, 31)):
    return {
        "mesh": {"hosts": len(replied), "ready": len(replied) - 1,
                 "fenced": 1, "epoch": 2, "reoffered": 3,
                 "busy_reroutes": 1, "stale_results": 0, "pending": 0,
                 "lease_s": 1.0},
        "hosts": [
            {"host": f"host{i}", "state": "READY" if i else "FENCED",
             "zone": "", "capacity_rps": 100.0, "outstanding": i,
             "replied": r, "busies": i, "lease_age_ms": 12.5,
             "fence_cause": None if i else "lease_expired",
             "versions": {},
             "remote": {"offered": r + 1, "admitted": r,
                        "replied": r - 1}}
            for i, r in enumerate(replied)],
        "admission": _admission(offered=41, admitted=40,
                                replied=sum(replied), depth=0,
                                inflight=0),
    }


def _sharded_replicas(invokes=(6, 4), fenced=None):
    rows = []
    for g, inv in enumerate(invokes):
        state = "fenced" if g == fenced else "ready"
        rows.append({"device": g * 2, "platform": "cpu",
                     "invokes": inv, "batches": inv, "errors": 0,
                     "queue_depth": 0, "up": state == "ready",
                     "state": state, "compile_count": 1,
                     "adopted_epoch": 1,
                     "group": g, "devices": [g * 2, g * 2 + 1],
                     "shards": 2})
    return {"replicas": rows, "devices": len(invokes),
            "live": sum(1 for r in rows if r["up"]),
            "routed": sum(invokes), "reoffers": 0, "rejected": 0,
            "fences": 1 if fenced is not None else 0,
            "group_size": 2,
            "leases": {"free": 8 - 2 * len(invokes),
                       "leased": 2 * len(invokes), "fenced": 0}}


def _feed(tr, Buffer, n=5, name="echo"):
    """The same records into a tracer of either package (fixed
    timestamps: two tracers fed alike render alike)."""
    buf = Buffer.of(np.ones((2,), np.float32))
    for i in range(n):
        tr.record_process(name, buf, 1.0, 1.0 + 1e-4 * (i + 1))
    return tr


def _traced(pkg, n=5, name="echo"):
    _, tr_mod, Buffer = pkg
    return _feed(tr_mod.Tracer(), Buffer, n, name)


# -- exposition ---------------------------------------------------------------

class TestExposition:
    def test_type_and_help_line_per_family(self, pkg):
        m = pkg[0]
        text = m.render_prometheus(m.metrics_snapshot(
            tracer=_traced(pkg), admission=_admission(), pool=_pool()))
        parsed = m.parse_prometheus(text)
        for fam in ("nns_admission_offered_total",
                    "nns_admission_rejected_total",
                    "nns_admission_depth",
                    "nns_pool_restarts_total",
                    "nns_worker_replied_total",
                    "nns_element_proctime_seconds",
                    "nns_trace_events_total"):
            assert fam in parsed, f"family {fam} missing"
            assert parsed[fam].get("type")
            assert parsed[fam].get("help")
        assert parsed["nns_admission_offered_total"]["type"] == "counter"
        assert parsed["nns_admission_depth"]["type"] == "gauge"
        assert parsed["nns_element_proctime_seconds"]["type"] \
            == "histogram"
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            assert re.match(
                r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$', line), \
                f"malformed exposition line: {line!r}"

    def test_label_escaping_round_trips(self, pkg):
        m = pkg[0]
        assert m.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
        tr = _traced(pkg, 2, name='we"ird\\el\nem')
        text = m.render_prometheus(m.metrics_snapshot(tracer=tr))
        for line in text.splitlines():
            assert "\r" not in line
        assert '\\"ird' in text and "\\\\el" in text and "\\nem" in text

    def test_histogram_buckets_cumulative_with_inf(self, pkg):
        m = pkg[0]
        text = m.render_prometheus(m.metrics_snapshot(
            tracer=_traced(pkg, 4)))
        fam = m.parse_prometheus(text)["nns_element_proctime_seconds"]
        buckets = sorted(
            (float("inf") if 'le="+Inf"' in k else
             float(re.search(r'le="([^"]+)"', k).group(1)), v)
            for k, v in fam["samples"].items() if "_bucket{" in k)
        vals = [v for _, v in buckets]
        assert vals == sorted(vals)          # cumulative ⇒ monotone
        assert buckets[-1][0] == float("inf")
        assert vals[-1] == 4                 # +Inf bucket == _count
        count = [v for k, v in fam["samples"].items()
                 if k.endswith("_count}") or "_count{" in k]
        assert count == [4]

    def test_counter_families_never_negative(self, pkg):
        m = pkg[0]
        for s in m.metrics_snapshot(admission=_admission(), pool=_pool()):
            if s["type"] == "counter":
                for _, v in s["samples"]:
                    assert v >= 0, s["name"]

    def test_parse_handles_bucket_sum_count_suffixes(self, pkg):
        m = pkg[0]
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(tracer=_traced(pkg, 3))))
        fam = parsed["nns_element_proctime_seconds"]
        assert "nns_element_proctime_seconds_bucket" not in parsed
        assert any("_sum{" in k or k.endswith("_sum}")
                   for k in fam["samples"])


def _snapshots(tr_mod, Buffer):
    """Snapshot inputs covering every family the port can be handed
    (devprof's: tests/test_torch_devprof.py)."""
    tr = _feed(tr_mod.Tracer(), Buffer, 6, "f")
    tr.record_compiled_window("f", 4, 1.0, 1.001)
    tr.record_loop_bail("f", "eos", 1.0)
    tr.record_forced_sync("sink", 1.0)
    tr.record_shed("query_server_0", "queue_full", 1.0)
    tr.enqueue("q", 3, 1.0)
    tr.record_request("query_server_0", "abcd", [
        {"hop": "admit", "t": 1.0}, {"hop": "reply", "t": 1.004}], 1.004,
        tenant="acme")
    adm = _admission()
    adm["classes"] = {"acme": {
        "offered": 3, "admitted": 3, "replied": 2,
        "rejected": {}, "shed": {"expired": 1}, "depth": 0,
        "inflight": 0, "weight": 2.0}}
    pool = _pool()
    pool["pool"].update(shm_frames=80, shm_bytes=5_242_880,
                        shm_fallbacks=2)
    autotune = {"decisions": {"max_pending": {"applied": 2,
                                              "hysteresis": 5}},
                "applied_total": 2, "audit_dropped": 0,
                "knobs": {"max_pending": 16.0}, "dry_run": False,
                "slo": {"p99_budget_ms": 90.0, "goodput_floor_rps": 0.0}}
    llm = {"llm0": {"tokens_out": 12, "finished": 2, "prefilling": 0,
                    "executor": {"kernel_invokes": {"pallas": 7},
                                 "kernel_fallback": 0,
                                 "paged_kernel": "pallas",
                                 "chunk_prefills": 3}}}
    segments = {"p": {"stages": [{"stage": 0, "device": 0,
                                  "time_s": 0.002}],
                      "bubble_fraction": 0.25}}
    return [
        {"admission": adm, "pool": pool},
        {"tracer": tr},
        {"mesh": _mesh(), "admission": _mesh()["admission"]},
        {"replicas": {"f": _sharded_replicas()}, "segments": segments},
        {"autotune": autotune, "llm": llm,
         "extra": {"build_info": 1, "not_a_number": "x"}},
    ]


def test_render_equals_jax_for_the_same_inputs():
    """Every snapshot input renders to the same text — HELP and TYPE
    lines, label order, number formats — on both packages."""
    port = _snapshots(ttr, TensorBuffer)
    jax = _snapshots(jtr, JBuffer)
    for kw, jkw in zip(port, jax):
        t = tm.render_prometheus(tm.metrics_snapshot(**kw))
        j = jm.render_prometheus(jm.metrics_snapshot(**jkw))
        assert t == j, sorted(kw)
        assert tm.parse_prometheus(t) == jm.parse_prometheus(j)


# -- the HTTP endpoint --------------------------------------------------------

class TestMetricsServer:
    def test_scrapes_are_monotone_under_load(self, pkg):
        m, _, Buffer = pkg
        tr = _traced(pkg, 2)
        state = {"offered": 10}

        def collect():
            return m.metrics_snapshot(
                tracer=tr, admission=_admission(state["offered"]),
                pool=_pool())

        srv = m.MetricsServer(collect)
        try:
            url = f"http://127.0.0.1:{srv.port}/metrics"
            p1 = m.parse_prometheus(m.scrape(url))
            state["offered"] += 7
            buf = Buffer.of(np.ones((2,), np.float32))
            t0 = time.perf_counter()
            for _ in range(3):
                tr.record_process("echo", buf, t0, t0 + 2e-4)
            p2 = m.parse_prometheus(m.scrape(url))
            for fam, info in p1.items():
                if info.get("type") not in ("counter", "histogram"):
                    continue
                for k, v in info["samples"].items():
                    v2 = p2[fam]["samples"].get(k)
                    assert v2 is not None and v2 >= v, (fam, k, v, v2)
            assert p2["nns_admission_offered_total"]["samples"][
                "nns_admission_offered_total"] == 17.0
            assert srv.scrapes == 2
        finally:
            srv.close()

    def test_healthz_and_unknown_path(self, pkg):
        m = pkg[0]
        srv = m.MetricsServer(lambda: [], health=lambda: {"workers": 2})
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(f"{base}/healthz",
                                        timeout=5) as r:
                info = json.loads(r.read().decode())
            assert info["ok"] and info["workers"] == 2
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/nope", timeout=5)
            assert ei.value.code == 404
        finally:
            srv.close()

    def test_collect_failure_yields_503_not_crash(self, pkg):
        m = pkg[0]
        calls = {"n": 0}

        def collect():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            return m.metrics_snapshot(admission=_admission())

        srv = m.MetricsServer(collect)
        try:
            url = f"http://127.0.0.1:{srv.port}/metrics"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(url, timeout=5)
            assert ei.value.code == 503
            assert "nns_admission_offered_total" in m.scrape(url)
        finally:
            srv.close()

    def test_content_type_is_exposition_format(self, pkg):
        m = pkg[0]
        srv = m.MetricsServer(lambda: m.metrics_snapshot(
            admission=_admission()))
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=5) as r:
                ctype = r.headers["Content-Type"]
            assert ctype.startswith("text/plain")
            assert "version=0.0.4" in ctype
        finally:
            srv.close()


def test_port_scrape_of_a_jax_endpoint_and_back():
    """Each package's scrape/parse reads the other's endpoint: the same
    families and samples."""
    snap = dict(admission=_admission(), pool=_pool())
    for serve_m, read_m in ((jm, tm), (tm, jm)):
        srv = serve_m.MetricsServer(
            lambda: serve_m.metrics_snapshot(**snap))
        try:
            url = f"http://127.0.0.1:{srv.port}/metrics"
            got = read_m.parse_prometheus(read_m.scrape(url))
        finally:
            srv.close()
        want = serve_m.parse_prometheus(serve_m.render_prometheus(
            serve_m.metrics_snapshot(**snap)))
        assert got == want


# -- mesh and shard exposition (stats dicts) ----------------------------------

class TestMeshExposition:
    def test_host_labels_round_trip(self, pkg):
        m = pkg[0]
        snap = _mesh(replied=(9, 31))
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(admission=snap["admission"], mesh=snap)))
        rep = parsed["nns_host_replied_total"]["samples"]
        by_host = {re.search(r'host="([^"]+)"', k).group(1): v
                   for k, v in rep.items()}
        assert by_host == {"host0": 9.0, "host1": 31.0}
        adm = parsed["nns_admission_replied_total"]["samples"][
            "nns_admission_replied_total"]
        assert sum(by_host.values()) == adm == 40.0
        assert parsed["nns_mesh_reoffered_total"]["samples"][
            "nns_mesh_reoffered_total"] == 3.0
        up = parsed["nns_host_up"]["samples"]
        fenced = [k for k, v in up.items() if v == 0.0]
        assert len(fenced) == 1
        assert 'host="host0"' in fenced[0]
        assert 'state="FENCED"' in fenced[0]

    def test_lease_carried_remote_counters_exported(self, pkg):
        m = pkg[0]
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(mesh=_mesh(replied=(9, 31)))))
        for key in ("offered", "admitted", "replied"):
            fam = parsed[f"nns_host_local_{key}_total"]
            assert fam["type"] == "counter"
            assert len(fam["samples"]) == 2
        local = parsed["nns_host_local_replied_total"]["samples"]
        assert sum(local.values()) == (9 - 1) + (31 - 1)


class TestLoopAndShmExposition:
    def test_shm_transport_counters_round_trip(self, pkg):
        m = pkg[0]
        pool = _pool()
        pool["pool"].update(shm_frames=80, shm_bytes=5_242_880,
                            shm_fallbacks=2)
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(pool=pool)))
        for fam, want in (("nns_shm_frames_total", 80.0),
                          ("nns_shm_bytes_total", 5242880.0),
                          ("nns_shm_fallbacks_total", 2.0)):
            assert parsed[fam]["type"] == "counter"
            assert parsed[fam]["samples"][fam] == want

    def test_pipe_only_pool_still_exports_zeroed_lane(self, pkg):
        m = pkg[0]
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(pool=_pool())))
        assert parsed["nns_shm_frames_total"]["samples"][
            "nns_shm_frames_total"] == 0.0

    def test_compiled_loop_counters_round_trip(self, pkg):
        m = pkg[0]
        tr = _traced(pkg, 6, name="f")
        t0 = time.perf_counter()
        tr.record_compiled_window("f", 4, t0, t0 + 1e-3)
        tr.record_compiled_window("f", 2, t0, t0 + 2e-3)
        tr.record_loop_bail("f", "eos", t0)
        tr.record_loop_bail("f", "shape", t0)
        tr.record_loop_bail("f", "shape", t0)
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(tracer=tr)))
        assert parsed["nns_loop_entries_total"]["samples"][
            'nns_loop_entries_total{element="f"}'] == 2.0
        assert parsed["nns_compiled_steps_total"]["samples"][
            'nns_compiled_steps_total{element="f"}'] == 6.0
        by_cause = {re.search(r'cause="([^"]+)"', k).group(1): v
                    for k, v in parsed["nns_loop_bails_total"]
                    ["samples"].items()}
        assert by_cause == {"eos": 1.0, "shape": 2.0}


class TestShardExposition:
    def test_shard_family_round_trips_and_conserves(self, pkg):
        m = pkg[0]
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(replicas={"f": _sharded_replicas()})))
        fam = parsed["nns_shard_group_invokes_total"]
        assert fam["type"] == "counter"
        by_group = {re.search(r'group="([^"]+)"', k).group(1): v
                    for k, v in fam["samples"].items()}
        assert by_group == {"0": 6.0, "1": 4.0}
        rep = parsed["nns_replica_invokes_total"]["samples"]
        assert sum(by_group.values()) == sum(rep.values()) == 10.0
        assert any('devices="0,1"' in k for k in fam["samples"])
        assert parsed["nns_shard_group_size"]["samples"][
            'nns_shard_group_size{filter="f"}'] == 2.0
        epochs = set(parsed["nns_shard_group_adopted_epoch"]
                     ["samples"].values())
        assert epochs == {1.0}

    def test_member_fence_shows_as_group_down(self, pkg):
        m = pkg[0]
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(replicas={"f": _sharded_replicas(
                fenced=1)})))
        down = [k for k, v in parsed["nns_shard_group_up"]
                ["samples"].items() if v == 0.0]
        assert len(down) == 1
        assert 'group="1"' in down[0] and 'state="fenced"' in down[0]

    def test_unsharded_stats_emit_no_shard_family(self, pkg):
        m = pkg[0]
        st = _sharded_replicas(invokes=(3,))
        for r in st["replicas"]:
            for k in ("group", "devices", "shards"):
                r.pop(k)
        st.pop("group_size")
        st.pop("leases")
        parsed = m.parse_prometheus(m.render_prometheus(
            m.metrics_snapshot(replicas={"f": st})))
        assert "nns_replica_invokes_total" in parsed
        assert not any(f.startswith("nns_shard_") for f in parsed)


# -- the top view -------------------------------------------------------------

class TestTopView:
    def test_counter_rates_and_gauges(self, pkg):
        m = pkg[0]
        p1 = m.parse_prometheus(m.render_prometheus(m.metrics_snapshot(
            admission=_admission(offered=100))))
        p2 = m.parse_prometheus(m.render_prometheus(m.metrics_snapshot(
            admission=_admission(offered=150))))
        lines = "\n".join(m.top_table(p1, p2, dt_s=2.0))
        assert re.search(r"nns_admission_offered_total\s+150\s+25\.0",
                         lines), lines
        assert "nns_admission_depth" in lines

    def test_histogram_families_stay_out_of_table(self, pkg):
        m = pkg[0]
        cur = m.parse_prometheus(m.render_prometheus(m.metrics_snapshot(
            tracer=_traced(pkg))))
        lines = "\n".join(m.top_table({}, cur, 1.0))
        assert "proctime_seconds_bucket" not in lines

    def test_shard_rows_appear_in_top_table(self, pkg):
        m = pkg[0]
        cur = m.parse_prometheus(m.render_prometheus(m.metrics_snapshot(
            replicas={"f": _sharded_replicas()})))
        lines = "\n".join(m.top_table({}, cur, 1.0))
        assert "nns_shard_group_invokes_total" in lines
        assert "nns_shard_group_up" in lines

    def test_top_table_equals_jax(self):
        snap = dict(admission=_admission(offered=150), pool=_pool())
        cur = tm.parse_prometheus(tm.render_prometheus(
            tm.metrics_snapshot(**snap)))
        prev = tm.parse_prometheus(tm.render_prometheus(
            tm.metrics_snapshot(admission=_admission(offered=100),
                                pool=_pool())))
        assert tm.top_table(prev, cur, 2.0) == jm.top_table(prev, cur, 2.0)

    def test_top_view_one_frame(self, pkg):
        import io

        m = pkg[0]
        srv = m.MetricsServer(lambda: m.metrics_snapshot(
            admission=_admission()))
        out = io.StringIO()
        try:
            m.top_view(f"http://127.0.0.1:{srv.port}/metrics",
                       interval_s=0.01, iterations=1, out=out)
        finally:
            srv.close()
        text = out.getvalue()
        assert "top —" in text and "nns_admission_offered_total" in text
