"""The query edge on the port (nnstreamer_tpu_torch: edge/protocol.py,
edge/broker.py, edge/query.py, parallel/dispatch.py) against the JAX
package's, on the CPU.

- protocol and broker: framing, discovery, a registration that dies
  with its owner, the clock offset, pub/sub fan-out, malformed payloads;
  a JAX BrokerClient against the port's broker (its MQTT listener is
  tested in test_torch_mqtt.py).
- tensor_query_*: a round trip, caps rejection, two clients routed
  apart, pipelined in-flight order, typed BUSY with every frame
  accounted for (answered + BUSY = sent, in pts order), hybrid
  discovery, and the registry probe (the query, pub/sub and MQTT
  element names registered, three JAX-only names left).
- Across the packages: a port client against a JAX server and a JAX
  client against a port server, both serving MobileNetV2 (width 0.35,
  input 32, f32, JAX's parameters through models/bridge.py): logits
  within 1e-5 of max |logit| of each other and of the serving package's
  own run; the HELLO handshake both ways.
- BatchCore's conservation contract and the one-card Dispatcher;
  BatchedQueryServer with 4 clients x 8 frames against JAX's, the
  normalize step as `pre`: each client's rows within 1e-5 of JAX's,
  routed to the right client, in pts order; close() answers or sheds
  every frame.

Every server, broker and dispatcher binds port 0 and is closed in a
teardown. No assertion reads a wall clock.
"""

import concurrent.futures as cf
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import XLABackend
from nnstreamer_tpu.edge import BatchedQueryServer as JBatched
from nnstreamer_tpu.edge import QueryServer as JQueryServer
from nnstreamer_tpu.edge.broker import BrokerClient as JBrokerClient
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.backends.custom import register_custom_easy
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import (
    NegotiationError, PipelineError, ServerBusyError, StreamError)
from nnstreamer_tpu_torch.edge import BatchedQueryServer, QueryServer
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.broker import (
    BrokerClient, EdgeBroker, pack_publish, unpack_publish)
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.parallel.dispatch import BatchCore, Dispatcher
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

#: served logits across the packages, relative to max |logit|
LOGIT_REL = 1e-5
MBV2 = "zoo://mobilenet_v2?width=0.35&input_size=32&dtype=float32"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    JQueryServer.reset_all()
    torch.set_num_threads(threads)


@pytest.fixture()
def broker():
    b = EdgeBroker("127.0.0.1", 0)
    yield b
    b.close()


# -- protocol -----------------------------------------------------------------

def test_protocol_roundtrip_and_client_ids():
    srv = P.MsgServer("127.0.0.1", 0,
                      on_message=lambda c, t, p: c.send(t + 1, p[::-1]))
    replies = []
    cli = P.MsgClient("127.0.0.1", srv.port,
                      on_message=lambda t, p: replies.append((t, p)))
    try:
        cli.send(P.T_DATA, b"abc")
        t0 = time.monotonic()
        while not replies and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert replies == [(P.T_DATA + 1, b"cba")]
        assert cli.alive
    finally:
        cli.close()
        srv.close()
    assert P.T_BUSY == __import__(
        "nnstreamer_tpu.edge.protocol", fromlist=["x"]).T_BUSY


# -- broker -------------------------------------------------------------------

def test_publish_frame_codec():
    assert unpack_publish(pack_publish("cam/0", 12345, b"xyz")) == \
        ("cam/0", 12345, b"xyz")
    with pytest.raises(StreamError, match="truncated"):
        unpack_publish(b"\xff\xff hi")


def test_register_lookup_roundtrip(broker):
    srv = BrokerClient("127.0.0.1", broker.port)
    cli = BrokerClient("127.0.0.1", broker.port)
    try:
        srv.register("infer/mobilenet", "10.0.0.7", 5001)
        assert cli.lookup("infer/mobilenet") == ("10.0.0.7", 5001)
        with pytest.raises(StreamError, match="no service registered"):
            cli.lookup("nope")
        assert broker.services() == {"infer/mobilenet": ("10.0.0.7", 5001)}
    finally:
        srv.close()
        cli.close()


def test_jax_client_on_port_broker(broker):
    """The broker speaks the JAX package's message types: a JAX client
    registers and looks up against the port's broker."""
    j = JBrokerClient("127.0.0.1", broker.port)
    t = BrokerClient("127.0.0.1", broker.port)
    try:
        j.register("svc/j", "127.0.0.1", 7001)
        assert t.lookup("svc/j") == ("127.0.0.1", 7001)
        t.register("svc/t", "127.0.0.1", 7002)
        assert j.lookup("svc/t") == ("127.0.0.1", 7002)
    finally:
        j.close()
        t.close()


def _gone(cli, name):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        try:
            cli.lookup(name)
            time.sleep(0.05)
        except StreamError:
            return True
    return False


def test_registration_dies_with_owner_and_unregister(broker):
    srv = BrokerClient("127.0.0.1", broker.port)
    srv.register("ephemeral", "127.0.0.1", 9)
    srv.close()
    cli = BrokerClient("127.0.0.1", broker.port)
    try:
        assert _gone(cli, "ephemeral"), "stale registration survived"
        cli.register("svc", "127.0.0.1", 1)
        cli.unregister("svc")
        assert _gone(cli, "svc"), "unregistered service still resolvable"
    finally:
        cli.close()


def test_name_collision_refused(broker):
    a = BrokerClient("127.0.0.1", broker.port)
    b = BrokerClient("127.0.0.1", broker.port)
    try:
        a.register("svc", "127.0.0.1", 1)
        with pytest.raises(StreamError, match="already registered"):
            b.register("svc", "127.0.0.1", 2)
        a.register("svc", "127.0.0.1", 3)
        assert b.lookup("svc") == ("127.0.0.1", 3)
    finally:
        a.close()
        b.close()


def test_clock_offset_near_zero_same_host(broker):
    cli = BrokerClient("127.0.0.1", broker.port)
    try:
        # same host clock: the offset is a round trip, far below a second
        assert abs(cli.clock_offset_ns()) < 1_000_000_000
    finally:
        cli.close()


def test_pubsub_fanout_no_self_echo(broker):
    got_a, got_b, got_pub = [], [], []
    a = BrokerClient("127.0.0.1", broker.port)
    b = BrokerClient("127.0.0.1", broker.port)
    pub = BrokerClient("127.0.0.1", broker.port)
    try:
        a.subscribe("t", lambda ts, f: got_a.append(f))
        b.subscribe("t", lambda ts, f: got_b.append(f))
        pub.subscribe("t", lambda ts, f: got_pub.append(f))
        # a subscription is in place once a lookup behind it answers
        for c in (a, b, pub):
            with pytest.raises(StreamError):
                c.lookup("sync")
        frame = encode_buffer(TensorBuffer.of(np.arange(3, dtype=np.float32)))
        pub.publish("t", frame)
        deadline = time.monotonic() + 10
        while (not got_a or not got_b) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got_a) == 1 and len(got_b) == 1 and got_pub == []
        out, _ = decode_buffer(got_a[0])
        np.testing.assert_array_equal(out.tensors[0],
                                      np.arange(3, dtype=np.float32))
    finally:
        for c in (a, b, pub):
            c.close()


def test_broker_survives_malformed_payloads(broker):
    import nnstreamer_tpu_torch.edge.broker as B

    evil = P.MsgClient("127.0.0.1", broker.port,
                       on_message=lambda t, p: None)
    ok = BrokerClient("127.0.0.1", broker.port)
    try:
        for mtype, payload in ((B.T_LOOKUP, b"\xff\xfe not json"),
                               (B.T_LOOKUP, b"[]"),
                               (B.T_SUBSCRIBE, b"\xff\xfe"),
                               (B.T_UNREGISTER, b"{"),
                               (B.T_PUBLISH, b"\xff\xff")):
            evil.send(mtype, payload)
        ok.register("still/alive", "127.0.0.1", 1)
        assert ok.lookup("still/alive") == ("127.0.0.1", 1)
    finally:
        evil.close()
        ok.close()


# -- tensor_query_* -----------------------------------------------------------

def _server(sid, model_props, dims="1:8", types="float32", extra=""):
    pipe = tnns.parse_launch(
        f"tensor_query_serversrc name=ssrc id={sid} dims={dims} "
        f"types={types} port=0 {extra} ! tensor_filter {model_props} ! "
        f"tensor_query_serversink id={sid}")
    return pipe, tnns.PipelineRunner(pipe).start()


def _client(port, n, *, value=lambda i: float(i), extra="", dims="1:8",
            push=True):
    pipe = tnns.parse_launch(
        f"appsrc name=src dims={dims} types=float32 ! tensor_query_client "
        f"name=qc port={port} timeout=30 {extra} ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe).start()
    if push:
        for i in range(n):
            pipe.get("src").push(TensorBuffer.of(
                np.full((8, 1), value(i), np.float32), pts=i))
        pipe.get("src").end()
    return pipe, runner


def test_query_roundtrip_strips_client_id():
    spipe, srun = _server(41, "model=zoo://probe_scale")
    try:
        cpipe, crun = _client(spipe.get("ssrc").port, 3)
        crun.wait(30)
        crun.stop()
        res = cpipe.get("out").results
        assert [r.pts for r in res] == [0, 1, 2]
        for i, r in enumerate(res):
            np.testing.assert_array_equal(
                r.tensors[0], np.full((8, 1), 2.0 * i, np.float32))
            assert "client_id" not in r.meta
        st = srun.stats()["ssrc"]
        assert (st["admitted"], st["replied"]) == (3, 3)
    finally:
        srun.stop()


def test_query_client_caps_rejection():
    spipe, srun = _server(42, "model=zoo://probe_scale")
    try:
        with pytest.raises(NegotiationError, match="incompatible|rejected"):
            _client(spipe.get("ssrc").port, 0, dims="7", push=False)
    finally:
        srun.stop()


def test_query_two_clients_routed_separately():
    spipe, srun = _server(43, "model=zoo://probe_scale")
    port = spipe.get("ssrc").port
    try:
        def run(value):
            pipe, rn = _client(port, 4, value=lambda i: value)
            rn.wait(30)
            rn.stop()
            return [float(r.tensors[0][0, 0]) for r in pipe.get("out").results]

        with cf.ThreadPoolExecutor(2) as ex:
            a, b = ex.map(run, (10.0, 100.0))
        assert a == [20.0] * 4 and b == [200.0] * 4
    finally:
        srun.stop()


def test_query_client_pipelined_in_flight_preserves_order():
    spipe, srun = _server(44, "model=zoo://probe_offset")
    try:
        n = 11
        cpipe, crun = _client(spipe.get("ssrc").port, n,
                              extra="max_in_flight=4")
        crun.wait(60)
        crun.stop()
        res = cpipe.get("out").results
        assert [r.pts for r in res] == list(range(n))
        for i, r in enumerate(res):
            np.testing.assert_array_equal(
                r.tensors[0], np.full((8, 1), i + 10.0, np.float32))
    finally:
        srun.stop()


def _slow_echo(ts):
    time.sleep(0.03)
    return (ts[0] + 1.0,)


class TestBusy:
    """A bounded server answers every frame or refuses it with a typed
    BUSY; nothing is lost, nothing reorders."""

    def _slow_server(self, sid, **adm):
        register_custom_easy("query_slow_echo", _slow_echo)
        extra = " ".join(f"{k}={v}" for k, v in adm.items())
        return _server(sid, "framework=custom model=query_slow_echo",
                       extra=extra)

    def test_skip_accounts_for_every_frame(self):
        spipe, srun = self._slow_server(45, max_pending=2, max_inflight=1)
        try:
            n = 24
            cpipe, crun = _client(spipe.get("ssrc").port, n,
                                  extra="max_in_flight=4 error_policy=skip")
            crun.wait(60)
            st = crun.stats()["qc"]
            crun.stop()
            res = cpipe.get("out").results
            pts = [r.pts for r in res]
            assert pts == sorted(pts)
            assert st["query_busy"] >= 1
            # every frame sent is answered or BUSY (a BUSY raised under
            # skip may drop the next frame before it is sent)
            assert st["query_replied"] + st["query_busy"] == \
                st["query_sent"]
            assert st["query_replied"] == len(res)
            adm = srun.stats()["ssrc"]
            assert adm["admitted"] == adm["replied"]
            assert adm["rejected_total"] + adm["shed_total"] == \
                st["query_busy"]
        finally:
            srun.stop()

    def test_burst_is_answered_or_busy_frame_by_frame(self):
        """A raw client sends a burst at once: each frame comes back as
        a RESULT or a typed BUSY naming its pts, results in pts order."""
        spipe, srun = self._slow_server(50, max_pending=2)
        results, busy, done = [], [], threading.Event()
        n = 24

        def on_msg(mtype, payload):
            if mtype == P.T_RESULT:
                results.append(decode_buffer(payload)[0].pts)
            elif mtype == P.T_BUSY:
                info = __import__("json").loads(payload.decode())
                assert info["cause"] == "queue_full"
                assert info["retry_after_ms"] > 0
                busy.append(info["pts"])
            if len(results) + len(busy) >= n:
                done.set()

        hello = threading.Event()
        cli = P.MsgClient("127.0.0.1", spipe.get("ssrc").port,
                          on_message=lambda t, p: hello.set()
                          if t == P.T_HELLO_ACK else on_msg(t, p))
        try:
            cli.send(P.T_HELLO, b'{"dims": "1:8", "types": "float32"}')
            assert hello.wait(10)
            for i in range(n):
                cli.send(P.T_DATA, encode_buffer(
                    TensorBuffer.of(ONES8, pts=i)))
            assert done.wait(30), (results, busy)
            assert sorted(results + busy) == list(range(n))
            assert results == sorted(results) and busy
            adm = srun.stats()["ssrc"]
            assert adm["rejected_queue_full"] == len(busy)
        finally:
            cli.close()
            srun.stop()

    def test_fail_fast_surfaces_typed_busy(self):
        spipe, srun = self._slow_server(46, max_pending=16, max_inflight=1)
        try:
            cpipe, crun = _client(spipe.get("ssrc").port, 4,
                                  extra="max_in_flight=2")
            with pytest.raises(StreamError, match="rejected frame"):
                crun.wait(30)
            assert isinstance(crun._error, ServerBusyError)
            assert crun._error.cause == "inflight_full"
            assert crun._error.retry_after_ms > 0
            crun.stop()
        finally:
            srun.stop()

    def test_retry_throttles_and_never_reorders(self):
        """Under retry with two frames in flight a BUSY may concern the
        older frame, which is then shed (JAX's documented contract): the
        emitted sequence may have gaps, never a reorder, and every frame
        sent is answered or BUSY."""
        spipe, srun = self._slow_server(47, max_pending=16, max_inflight=1)
        try:
            cpipe, crun = _client(
                spipe.get("ssrc").port, 6,
                extra="max_in_flight=2 error_policy=retry:10:30")
            crun.wait(60)
            st = crun.stats()["qc"]
            crun.stop()
            pts = [r.pts for r in cpipe.get("out").results]
            assert pts == sorted(set(pts)) and set(pts) <= set(range(6))
            assert st["query_busy"] >= 1 and st["retries"] >= 1
            assert st["query_replied"] == len(pts)
            assert st["query_replied"] + st["query_busy"] == \
                st["query_sent"]
        finally:
            srun.stop()


def test_query_hybrid_discovery_end_to_end(broker):
    spipe = tnns.parse_launch(
        f"tensor_query_serversrc name=ssrc id=48 dims=1:8 types=float32 "
        f"port=0 broker_port={broker.port} topic=infer/scale ! "
        f"tensor_filter model=zoo://probe_scale ! "
        f"tensor_query_serversink id=48")
    srun = tnns.PipelineRunner(spipe).start()
    try:
        cpipe = tnns.parse_launch(
            f"appsrc name=src dims=1:8 types=float32 ! tensor_query_client "
            f"connect_type=hybrid port={broker.port} topic=infer/scale ! "
            f"tensor_sink name=out")
        crun = tnns.PipelineRunner(cpipe).start()
        cpipe.get("src").push(np.arange(8, dtype=np.float32).reshape(8, 1))
        cpipe.get("src").end()
        crun.wait(30)
        crun.stop()
        res = cpipe.get("out").results
        assert len(res) == 1
        np.testing.assert_array_equal(
            res[0].tensors[0], np.arange(8, dtype=np.float32).reshape(8, 1)
            * 2)
        with pytest.raises(NegotiationError, match="hybrid discovery"):
            tnns.PipelineRunner(tnns.parse_launch(
                f"appsrc dims=1:8 types=float32 ! tensor_query_client "
                f"connect_type=hybrid port={broker.port} topic=ghost "
                f"timeout=2 ! fakesink")).start()
    finally:
        srun.stop()


def test_serversrc_refuses_wildcard_advertise(broker):
    pipe = tnns.parse_launch(
        f"tensor_query_serversrc name=s id=49 dims=2 types=float32 "
        f"host=0.0.0.0 port=0 broker_port={broker.port} topic=w ! fakesink")
    with pytest.raises(PipelineError, match="advertise_host"):
        tnns.PipelineRunner(pipe).start()


def test_registry_probe():
    """Every element, decoder and converter of the JAX package is the
    port's now (the gRPC elements, the interop codecs and tensor_trainer
    came last), both have the trainer plugin kind, and the filter has
    every property of JAX's (canary_seed, devices and shards among
    them)."""
    import nnstreamer_tpu.decoders  # noqa: F401
    import nnstreamer_tpu.elements  # noqa: F401  (registers built-ins)
    import nnstreamer_tpu_torch.decoders  # noqa: F401
    import nnstreamer_tpu_torch.elements  # noqa: F401
    from nnstreamer_tpu.core.registry import PluginKind as JKind
    from nnstreamer_tpu.core.registry import registry as jreg
    from nnstreamer_tpu_torch.core.registry import PluginKind, registry

    def builtins(reg, kind, pkg):
        return {n for n in reg.names(kind)
                if getattr(reg.find(kind, n), "__module__", "")
                .startswith(pkg + ".")}

    ours = builtins(registry, PluginKind.ELEMENT, "nnstreamer_tpu_torch")
    theirs = builtins(jreg, JKind.ELEMENT, "nnstreamer_tpu")
    assert {"tensor_query_client", "tensor_query_serversrc",
            "tensor_query_serversink", "edgesink", "edgesrc", "mqttsink",
            "mqttsrc", "tensor_sink_grpc", "tensor_src_grpc",
            "tensor_trainer"} <= ours
    assert theirs - ours == set()
    assert ours - theirs == set()
    for kind in ("DECODER", "CONVERTER"):
        ours_k = builtins(registry, PluginKind[kind], "nnstreamer_tpu_torch")
        theirs_k = builtins(jreg, JKind[kind], "nnstreamer_tpu")
        assert {"protobuf", "flatbuf", "flexbuf"} <= ours_k
        assert theirs_k - ours_k == set(), kind
    assert PluginKind.TRAINER.value == JKind.TRAINER.value == "trainer"
    assert {k.value for k in JKind} == {k.value for k in PluginKind}
    from nnstreamer_tpu.elements import TensorFilter as JFilter
    from nnstreamer_tpu_torch.elements import TensorFilter as TFilter

    assert set(JFilter.PROPS) - set(TFilter.PROPS) == set()
    assert {"devices", "shards", "canary_seed"} <= set(TFilter.PROPS)


# -- across the packages ------------------------------------------------------

@pytest.fixture(scope="module")
def mbv2():
    """(JAX bundle, port bundle) of one MobileNetV2 (width 0.35, input 32,
    f32): JAX's zoo parameters, carried to the port by the bridge."""
    jb = XLABackend()._resolve(MBV2)
    np_params = jax.tree_util.tree_map(np.asarray, jb.params)
    model = bridge.load_mobilenet_v2(
        tm.MobileNetV2(0.35, dtype=torch.float32).eval(), np_params)
    spec = TensorsSpec.of(TensorInfo((1, 32, 32, 3), DType.FLOAT32))
    tb = ModelBundle(fn=lambda m, x: m(x), params=model, in_spec=spec,
                     out_spec=TensorsSpec.of(
                         TensorInfo((1, 1001), DType.FLOAT32)),
                     name="mobilenet_v2_0.35")
    return jb, tb


FRAMES = [np.random.default_rng(i).uniform(-1, 1, (1, 32, 32, 3))
          .astype(np.float32) for i in range(3)]


def _serve(nns, Buffer, model, sid, port_of):
    """A server pipeline of package `nns` serving `model` → (pipe,
    runner, port)."""
    pipe = nns.parse_launch(
        f"tensor_query_serversrc name=ssrc id={sid} dims=3:32:32:1 "
        f"types=float32 port=0 ! tensor_filter name=f ! "
        f"tensor_query_serversink id={sid}")
    pipe.get("f").set_props(model=model)
    runner = nns.PipelineRunner(pipe).start()
    return pipe, runner, pipe.get("ssrc").port


def _ask(nns, Buffer, port):
    pipe = nns.parse_launch(
        f"appsrc name=src dims=3:32:32:1 types=float32 ! "
        f"tensor_query_client port={port} timeout=60 ! tensor_sink name=out")
    runner = nns.PipelineRunner(pipe).start()
    for i, x in enumerate(FRAMES):
        pipe.get("src").push(Buffer.of(x, pts=i))
    pipe.get("src").end()
    runner.wait(60)
    runner.stop()
    res = pipe.get("out").results
    assert [r.pts for r in res] == list(range(len(FRAMES)))
    # the handshake told the client the server's output spec
    assert pipe.get("out").results[0].tensors[0].shape == (1, 1001)
    return np.stack([np.asarray(r.tensors[0]) for r in res])


_JITTED = {}


def _jrun(jb, x) -> np.ndarray:
    """The JAX bundle on one frame, outside any server (jitted once)."""
    fn = _JITTED.get(id(jb))
    if fn is None:
        fn = _JITTED[id(jb)] = jax.jit(jb.fn)
    out = fn(jb.params, jnp.asarray(x))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def test_port_client_jax_server_and_reverse(mbv2):
    jb, tb = mbv2
    jpipe, jrun, jport = _serve(jnns, JBuffer, jb, 51, None)
    tpipe, trun, tport = _serve(tnns, TensorBuffer, tb, 52, None)
    try:
        via_jax = _ask(tnns, TensorBuffer, jport)     # port → JAX server
        via_port = _ask(jnns, JBuffer, tport)         # JAX → port server
    finally:
        jrun.stop()
        trun.stop()
    scale = float(np.abs(via_jax).max())
    np.testing.assert_allclose(via_port, via_jax, rtol=0,
                               atol=LOGIT_REL * scale)
    with torch.inference_mode():
        direct = np.stack([tb.params(torch.from_numpy(x)).numpy()
                           for x in FRAMES])
    np.testing.assert_array_equal(via_port, direct)
    jdirect = np.stack([_jrun(jb, x) for x in FRAMES])
    np.testing.assert_allclose(via_jax, jdirect, rtol=0,
                               atol=LOGIT_REL * scale)


# -- batch dispatch -----------------------------------------------------------

def test_batchcore_conservation_and_buckets():
    runs = []

    def run(batch, n):
        runs.append((tuple(batch.shape), n))
        return (batch * 2.0,)

    core = BatchCore(run, [1, 4], 0.02, device=torch.device("cpu"))
    try:
        futs = [core.submit(np.full((1, 3), i, np.float32))
                for i in range(6)]
        res = [f.result(10) for f in futs]
        for i, (row,) in enumerate(res):
            np.testing.assert_array_equal(row, np.full(3, 2.0 * i))
        st = core.stats()
        assert st["frames"] == 6 and st["errors"] == 0
        assert st["outstanding"] == 0
        assert {shape[0] for shape, _ in runs} <= {1, 4}
        assert sum(n for _, n in runs) == 6
    finally:
        core.shutdown()
    with pytest.raises(StreamError, match="shut down"):
        core.submit(np.zeros(3, np.float32))


def test_batchcore_failure_is_typed_and_counted():
    """A failed run resolves every future of its batch with a typed
    StreamError, counted before the futures resolve."""
    def run(batch, n):
        raise ValueError("boom")

    core = BatchCore(run, [2], 0.0, device=torch.device("cpu"))
    try:
        futs = [core.submit(np.zeros(2, np.float32)) for _ in range(2)]
        for f in futs:
            with pytest.raises(StreamError, match="boom"):
                f.result(10)
        st = core.stats()
        assert st["errors"] == 2 and st["outstanding"] == 0
        assert st["frames"] == 0
    finally:
        core.shutdown()


def test_dispatcher_matches_the_unbatched_fn():
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    d = Dispatcher(lambda p, x: (x @ p,), w, device="cpu", bucket=4,
                   max_delay_ms=5.0)
    try:
        assert d.buckets == [1, 4]
        xs = [np.random.default_rng(i).normal(size=(1, 4)).astype(np.float32)
              for i in range(9)]
        futs = [d.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(10)[0], (x @ w.numpy())[0],
                                       rtol=1e-6)
        assert d.frames == 9 and d.batches <= 9
    finally:
        d.shutdown()


def test_batched_server_shards_over_a_mesh(monkeypatch):
    """``mesh=`` (dp 4 of 4 logical CPU devices, bucket 8): 12 frames from
    one client answered in order with the known answer (`pre` doubles,
    probe_scale doubles again); every batch ran on the 4 shards, `pre`
    once a shard batch."""
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "4")
    pre_rows = []

    def pre(x):
        pre_rows.append(x.shape[0])
        return x * 2.0

    srv = BatchedQueryServer("zoo://probe_scale", sid=56, port=0, bucket=8,
                             max_delay_ms=5.0, pre=pre,
                             mesh=make_mesh(MeshSpec(dp=4)))
    xs = [np.full((8, 1), i, np.float32) for i in range(12)]
    try:
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=1:8 types=float32 ! tensor_query_client "
            f"port={srv.port} timeout=60 max_in_flight=4 ! "
            f"tensor_sink name=out")
        rn = tnns.PipelineRunner(pipe).start()
        for i, x in enumerate(xs):
            pipe.get("src").push(TensorBuffer.of(x, pts=i))
        pipe.get("src").end()
        rn.wait(60)
        rn.stop()
        res = pipe.get("out").results
        assert [r.pts for r in res] == list(range(12))
        for r, x in zip(res, xs):
            np.testing.assert_array_equal(np.asarray(r.tensors[0]), 4 * x)
        st = srv.stats()
        assert st["frames"] == 12 and srv.dispatcher.buckets == [4, 8]
        assert st["shard_batches"] == [st["batches"]] * 4
        assert len(pre_rows) >= 4 * st["batches"]
    finally:
        srv.close()


def _batched_clients(port, frames_of, n_clients=4, nns=tnns,
                     Buffer=TensorBuffer):
    """n clients of package `nns` at once → {client: results}."""
    def run(cid):
        pipe = nns.parse_launch(
            f"appsrc name=src dims=3:32:32:1 types=uint8 ! "
            f"tensor_query_client port={port} timeout=60 max_in_flight=4 ! "
            f"tensor_sink name=out")
        rn = nns.PipelineRunner(pipe).start()
        for i, x in enumerate(frames_of(cid)):
            pipe.get("src").push(Buffer.of(x, pts=i))
        pipe.get("src").end()
        rn.wait(60)
        rn.stop()
        return cid, pipe.get("out").results

    with cf.ThreadPoolExecutor(n_clients) as ex:
        return dict(ex.map(run, range(n_clients)))


def test_batched_server_four_clients_match_jax(mbv2):
    jb, tb = mbv2
    u8 = TensorsSpec.of(TensorInfo((1, 32, 32, 3), DType.UINT8))

    def frames_of(cid):
        rng = np.random.default_rng(100 + cid)
        return [rng.integers(0, 256, (1, 32, 32, 3), np.uint8)
                for _ in range(8)]

    from nnstreamer_tpu.tensor.dtypes import DType as JDType
    from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
    from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec

    jsrv = JBatched(jb, sid=53, port=0, bucket=8, max_delay_ms=5.0,
                    pre=lambda x: (x.astype(jnp.float32) - 127.5) / 127.5,
                    in_spec=JSpec.of(JInfo((1, 32, 32, 3), JDType.UINT8)))
    tsrv = BatchedQueryServer(
        tb, sid=54, port=0, bucket=8, max_delay_ms=5.0,
        pre=kernels.normalize_u8, in_spec=u8, accelerator="cpu")
    try:
        ours = _batched_clients(tsrv.port, frames_of)
        jax_rows = {}
        for cid in range(4):
            rows = []
            for x in frames_of(cid):
                xs = (x.astype(np.float32) - 127.5) / 127.5
                rows.append(_jrun(jb, xs))
            jax_rows[cid] = rows
        for cid, res in ours.items():
            assert [r.pts for r in res] == list(range(8))
            for r, want in zip(res, jax_rows[cid]):
                got = np.asarray(r.tensors[0])
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=LOGIT_REL * scale)
        # JAX's batched server, JAX's clients, the same frames
        theirs = _batched_clients(jsrv.port, frames_of, nns=jnns,
                                  Buffer=JBuffer)
        for cid, res in theirs.items():
            assert [r.pts for r in res] == list(range(8))
            rows = [np.asarray(r.tensors[0]) for r in res]
            for r, want in zip(ours[cid], rows):
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(np.asarray(r.tensors[0]), want,
                                           rtol=0, atol=LOGIT_REL * scale)
        st = tsrv.stats()
        assert st["frames"] == 32 and st["batches"] < 32
        assert st["admitted"] == st["replied"] == 32
    finally:
        tsrv.close()
        jsrv.close()


def test_batched_close_answers_or_sheds_every_frame():
    srv = BatchedQueryServer("zoo://probe_scale", sid=55, port=0, bucket=4,
                             max_delay_ms=50.0, accelerator="cpu")
    done = threading.Event()
    got = {"result": 0, "busy": 0}
    n_sent = 12

    def on_msg(mtype, payload):
        if mtype == P.T_RESULT:
            got["result"] += 1
        elif mtype == P.T_BUSY:
            got["busy"] += 1
        if got["result"] + got["busy"] >= n_sent:
            done.set()

    hello = threading.Event()
    cli = P.MsgClient("127.0.0.1", srv.port,
                      on_message=lambda t, p: hello.set()
                      if t == P.T_HELLO_ACK else on_msg(t, p))
    try:
        cli.send(P.T_HELLO, b'{"dims": "1:8", "types": "float32"}')
        assert hello.wait(10)
        for i in range(n_sent):
            cli.send(P.T_DATA, encode_buffer(TensorBuffer.of(ONES8, pts=i)))
        srv.close()
        assert done.wait(20), f"lost frames: {got} of {n_sent} answered"
        assert got["result"] + got["busy"] == n_sent
        st = srv.stats()
        assert st["admitted"] == st["replied"] + st["shed"]
        srv.close()                              # idempotent
        assert srv.stats() == st
    finally:
        cli.close()


ONES8 = np.ones((8, 1), np.float32)
