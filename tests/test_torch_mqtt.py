"""MQTT on the port (nnstreamer_tpu_torch/edge/mqtt_wire.py, the broker's
MQTT listener, edge/pubsub.py and elements/mqtt.py) against the JAX
package's, on the CPU.

The codec's bytes for the same packets are JAX's; the splitter and topic
filters behave as JAX's; a JAX `MqttClient` and a port one carry frames
through either package's listener in both directions; the pipelines of
JAX `tests/test_mqtt_wire.py`, `tests/test_broker.py` (the mqtt elements)
and `tests/test_edge.py::test_edge_pubsub_stream_bridging` run on the
port; a JAX mqttsink reaches a port mqttsrc with equal frames. The
listener's lifecycle: `close()` leaves no thread behind, including with
clients connected and a subscriber that never reads. Every wait is a
deadline loop; no assertion reads the wall clock.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.edge import mqtt_wire as JM
from nnstreamer_tpu.edge.broker import EdgeBroker as JEdgeBroker
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.edge import EdgeSink, EdgeSrc
from nnstreamer_tpu_torch.edge import mqtt_wire as M
from nnstreamer_tpu_torch.edge.broker import BrokerClient, EdgeBroker
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.elements import AppSrc, TensorSink
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def broker():
    b = EdgeBroker("127.0.0.1", 0)
    yield b
    b.close()


def _until(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _mqtt_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("mqtt-", "mqtt_"))]


def _subscribed(b, topic, n=1):
    """`n` subscribers of `topic` at least on the port broker `b`."""
    with b._lock:
        subs = len(b._subs.get(topic, ()))
    with b._mqtt._lock:
        subs += sum(any(M.topic_matches(f, topic) for f in c.filters)
                    for c in b._mqtt._conns.values())
    return subs >= n


# -- the codec ----------------------------------------------------------------

PACKETS = {
    "connect": lambda m: m.encode_connect("cid", keepalive=60),
    "connect_auth": lambda m: m.encode_connect(
        "c2", keepalive=5, clean_session=False, username="u",
        password=b"pw"),
    "connack": lambda m: m.encode_connack(True, 0),
    "publish_qos0": lambda m: m.encode_publish("a/b", b"payload"),
    "publish_qos1_retain_dup": lambda m: m.encode_publish(
        "t", b"x" * 300, qos=1, packet_id=7, retain=True, dup=True),
    "publish_big": lambda m: m.encode_publish("big", b"\x01" * 20000),
    "puback": lambda m: m.encode_puback(65535),
    "subscribe": lambda m: m.encode_subscribe(
        5, [("sensors/+/temp", 1), ("all/#", 0)]),
    "suback": lambda m: m.encode_suback(5, [1, 0]),
    "unsubscribe": lambda m: m.encode_unsubscribe(6, ["a", "b/c"]),
    "unsuback": lambda m: m.encode_unsuback(6),
    "pingreq": lambda m: m.encode_pingreq(),
    "pingresp": lambda m: m.encode_pingresp(),
    "disconnect": lambda m: m.encode_disconnect(),
}


@pytest.mark.parametrize("name", sorted(PACKETS))
def test_packet_bytes_equal_jax(name):
    ours, theirs = PACKETS[name](M), PACKETS[name](JM)
    assert ours == theirs
    (p,) = M.PacketSplitter().feed(ours)
    (q,) = JM.PacketSplitter().feed(theirs)
    assert (p.ptype, p.flags, p.body) == (q.ptype, q.flags, q.body)


def test_remaining_length_vectors_equal_jax():
    for n in (0, 1, 127, 128, 16383, 16384, 2_097_151, 268_435_455):
        enc = M._encode_remaining(n)
        assert enc == JM._encode_remaining(n)
        assert M.decode_remaining(b"\x00" + enc, 1) == (n, len(enc))
    assert M._encode_remaining(16384) == b"\x80\x80\x01"
    with pytest.raises(StreamError):
        M._encode_remaining(268_435_456)
    with pytest.raises(StreamError):
        M.decode_remaining(b"\x80\x80\x80\x80\x01", 0)
    assert M.decode_remaining(b"\x80", 0) is None


def test_parsers_agree_with_jax():
    pkt = M.encode_connect("cid", keepalive=60, clean_session=True)
    (p,) = M.PacketSplitter().feed(pkt)
    assert M.parse_connect(p) == ("cid", 60, True)
    (jp,) = JM.PacketSplitter().feed(pkt)
    assert JM.parse_connect(jp) == M.parse_connect(p)
    pkt = M.encode_publish("t/1", b"data", qos=1, packet_id=9)
    (p,) = M.PacketSplitter().feed(pkt)
    M.parse_publish(p)
    assert (p.topic, p.payload, p.qos, p.packet_id) == ("t/1", b"data",
                                                         1, 9)
    pkt = M.encode_subscribe(5, [("x/+", 1), ("y/#", 0)])
    (p,) = M.PacketSplitter().feed(pkt)
    (jp,) = JM.PacketSplitter().feed(pkt)
    assert M.parse_subscribe(p) == JM.parse_subscribe(jp) == \
        (5, [("x/+", 1), ("y/#", 0)])
    pkt = M.encode_unsubscribe(4, ["a", "b"])
    (p,) = M.PacketSplitter().feed(pkt)
    assert M.parse_unsubscribe(p) == (4, ["a", "b"])
    # QoS 2 and a foreign protocol are refused as JAX refuses them
    q2 = M.Packet(ptype=M.PUBLISH, flags=0x04, body=b"\x00\x01t")
    with pytest.raises(StreamError, match="QoS 2"):
        M.parse_publish(q2)
    bad = M.Packet(ptype=M.CONNECT, flags=0,
                   body=b"\x00\x04HTTP\x04\x02\x00\x3c\x00\x00")
    with pytest.raises(StreamError, match="not an MQTT CONNECT"):
        M.parse_connect(bad)


def test_splitter_handles_fragmentation_and_coalescing():
    frames = (M.encode_publish("t", b"A" * 1000) + M.encode_pingreq()
              + M.encode_publish("u", b"B"))
    for step in (1, 7, 1000, len(frames)):
        split, jsplit = M.PacketSplitter(), JM.PacketSplitter()
        got, jgot = [], []
        for i in range(0, len(frames), step):
            got.extend(split.feed(frames[i:i + step]))
            jgot.extend(jsplit.feed(frames[i:i + step]))
        assert [p.ptype for p in got] == [M.PUBLISH, M.PINGREQ, M.PUBLISH]
        assert [(p.ptype, p.body) for p in got] == \
            [(p.ptype, p.body) for p in jgot]
        assert M.parse_publish(got[0]).payload == b"A" * 1000
    with pytest.raises(StreamError, match="exceeds cap"):
        M.PacketSplitter(max_packet=10).feed(M.encode_publish("t", b"x" * 64))


@pytest.mark.parametrize("pattern,topic", [
    ("a/b", "a/b"), ("a/b", "a/c"), ("a/+", "a/b"), ("a/+", "a/b/c"),
    ("a/#", "a/b/c"), ("#", "anything/at/all"), ("a/b/#", "a"),
    ("+/+", "a/b"), ("+", "a/b"), ("a/+/c", "a/x/c"), ("a", "a/b")])
def test_topic_matches_as_jax(pattern, topic):
    assert M.topic_matches(pattern, topic) == \
        JM.topic_matches(pattern, topic)


# -- raw clients against the port's listener ----------------------------------

class _RawMqtt:
    """Stands in for an unmodified external client (paho analog)."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=5)
        self.split = M.PacketSplitter()
        self.inbox = []

    def send(self, data):
        self.sock.sendall(data)

    def expect(self, ptype, timeout=5.0):
        deadline = time.monotonic() + timeout
        while True:
            for i, p in enumerate(self.inbox):
                if p.ptype == ptype:
                    return self.inbox.pop(i)
            self.sock.settimeout(max(deadline - time.monotonic(), 0.01))
            data = self.sock.recv(1 << 16)
            if not data:
                raise AssertionError("connection closed")
            self.inbox.extend(self.split.feed(data))

    def close(self):
        self.sock.close()


def test_external_mqtt_client_roundtrip(broker):
    """CONNECT → SUBSCRIBE → (second client) PUBLISH qos 1 → receive."""
    assert broker.mqtt_port and broker.mqtt_port != broker.port
    sub = _RawMqtt(broker.mqtt_port)
    pub = _RawMqtt(broker.mqtt_port)
    try:
        sub.send(M.encode_connect("ext-sub"))
        assert sub.expect(M.CONNACK).body[1] == M.CONNACK_ACCEPTED
        sub.send(M.encode_subscribe(1, [("demo/frames", 0)]))
        assert sub.expect(M.SUBACK).body == b"\x00\x01\x00"
        pub.send(M.encode_connect("ext-pub"))
        pub.expect(M.CONNACK)
        pub.send(M.encode_publish("demo/frames", b"hello tensor", qos=1,
                                  packet_id=9))
        assert pub.expect(M.PUBACK).body == b"\x00\x09"
        got = M.parse_publish(sub.expect(M.PUBLISH))
        assert (got.topic, got.payload) == ("demo/frames", b"hello tensor")
        sub.send(M.encode_pingreq())
        sub.expect(M.PINGRESP)
        sub.send(M.encode_unsubscribe(2, ["demo/frames"]))
        assert sub.expect(M.UNSUBACK).body == b"\x00\x02"
    finally:
        sub.close()
        pub.close()


def test_wildcard_subscription_and_packet_before_connect(broker):
    sub, pub = _RawMqtt(broker.mqtt_port), _RawMqtt(broker.mqtt_port)
    bad = _RawMqtt(broker.mqtt_port)
    try:
        sub.send(M.encode_connect("w"))
        sub.expect(M.CONNACK)
        sub.send(M.encode_subscribe(2, [("sensors/#", 0)]))
        sub.expect(M.SUBACK)
        pub.send(M.encode_connect("p"))
        pub.expect(M.CONNACK)
        pub.send(M.encode_publish("sensors/cam0/frames", b"F"))
        assert M.parse_publish(sub.expect(M.PUBLISH)).topic == \
            "sensors/cam0/frames"
        bad.send(M.encode_publish("t", b"x"))     # no CONNECT first
        bad.sock.settimeout(5)
        assert bad.sock.recv(100) == b""          # the listener drops it
    finally:
        for c in (sub, pub, bad):
            c.close()


def test_mqtt_bridges_to_edge_protocol(broker):
    """A stock-MQTT publish reaches edge-protocol subscribers and vice
    versa (one topic space across both domains)."""
    got, evt = [], threading.Event()
    bc = BrokerClient("127.0.0.1", broker.port)
    pub = _RawMqtt(broker.mqtt_port)
    sub = _RawMqtt(broker.mqtt_port)
    try:
        bc.subscribe("bridge/t", lambda ns, frame: (got.append(frame),
                                                    evt.set()))
        assert _until(lambda: _subscribed(broker, "bridge/t"))
        pub.send(M.encode_connect("b"))
        pub.expect(M.CONNACK)
        pub.send(M.encode_publish("bridge/t", b"from-mqtt"))
        assert evt.wait(5) and got == [b"from-mqtt"]
        sub.send(M.encode_connect("s"))
        sub.expect(M.CONNACK)
        sub.send(M.encode_subscribe(3, [("bridge/u", 0)]))
        sub.expect(M.SUBACK)
        bc.publish("bridge/u", b"from-edge")
        assert M.parse_publish(sub.expect(M.PUBLISH)).payload == \
            b"from-edge"
    finally:
        bc.close()
        pub.close()
        sub.close()


# -- the clients across the packages -----------------------------------------

@pytest.mark.parametrize("broker_pkg,pub_pkg,sub_pkg", [
    ("port", "jax", "port"), ("port", "port", "jax"),
    ("jax", "port", "port")])
def test_clients_carry_frames_across_packages(broker_pkg, pub_pkg, sub_pkg):
    b = (EdgeBroker("127.0.0.1", 0) if broker_pkg == "port"
         else JEdgeBroker("127.0.0.1", 0, mqtt_port=0))
    client = {"port": M.MqttClient, "jax": JM.MqttClient}
    got = []
    sub = pub = None
    try:
        sub = client[sub_pkg]("127.0.0.1", b.mqtt_port, client_id="s")
        sub.subscribe("x/+/frames", lambda t, p: got.append((t, p)),
                      qos=1)
        pub = client[pub_pkg]("127.0.0.1", b.mqtt_port, client_id="p")
        frames = [encode_buffer(TensorBuffer.of(
            np.full((2, 3), i, np.float32), pts=i)) for i in range(5)]
        for i, f in enumerate(frames):
            pub.publish(f"x/{i % 2}/frames", f, qos=i % 2)
        assert _until(lambda: len(got) == 5)
        assert [p for _, p in got] == frames
        assert [t for t, _ in got] == [f"x/{i % 2}/frames"
                                       for i in range(5)]
        for i, (_, p) in enumerate(got):
            buf, _ = decode_buffer(p)
            assert buf.pts == i
            np.testing.assert_array_equal(np.asarray(buf.tensors[0]),
                                          np.full((2, 3), i, np.float32))
    finally:
        for c in (pub, sub):
            if c is not None:
                c.close()
        b.close()


def test_client_refused_and_lost_connection(broker):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def refuse():
        conn, _ = srv.accept()
        conn.recv(1024)
        conn.sendall(M.encode_connack(False, 5))   # not authorized
        conn.close()

    t = threading.Thread(target=refuse, daemon=True)
    t.start()
    with pytest.raises(StreamError, match="rc=5"):
        M.MqttClient("127.0.0.1", port, connect_timeout=5)
    t.join(5)
    srv.close()
    c = M.MqttClient("127.0.0.1", broker.mqtt_port)
    broker.close()                     # the broker goes away under it
    assert _until(lambda: not c.alive)
    with pytest.raises(StreamError, match="connection lost"):
        c.publish("t", b"x", qos=1, timeout=5)
    c.close()


def test_client_close_joins_its_threads(broker):
    before = set(_mqtt_threads())
    c = M.MqttClient("127.0.0.1", broker.mqtt_port, keepalive=2)
    c.subscribe("k", lambda t, p: None)
    assert {t.name for t in _mqtt_threads()} >= {"mqtt-client-reader",
                                                 "mqtt-client-ping"}
    c.close()
    c.close()                          # idempotent
    assert not c.alive
    left = [t for t in _mqtt_threads() if t not in before
            and t.name.startswith("mqtt-client")]
    assert left == []


# -- the listener's lifecycle -------------------------------------------------

def test_listener_close_leaves_no_thread_behind():
    """Clients connected, one subscriber that never reads while frames
    are fanned out to it, one half-open socket: close() joins the accept
    loop and every connection's reader and writer."""
    before = set(threading.enumerate())
    b = EdgeBroker("127.0.0.1", 0)
    stalled = _RawMqtt(b.mqtt_port)
    idle = socket.create_connection(("127.0.0.1", b.mqtt_port))
    client = None
    try:
        stalled.send(M.encode_connect("stalled"))
        stalled.expect(M.CONNACK)
        stalled.send(M.encode_subscribe(1, [("flood", 0)]))
        stalled.expect(M.SUBACK)
        client = M.MqttClient("127.0.0.1", b.mqtt_port)
        big = b"\x00" * 65536
        for _ in range(400):           # the stalled subscriber's queue
            client.publish("flood", big)   # fills; the publisher never
        client.publish("flood", b"x", qos=1)   # blocks on it
        assert _until(lambda: len(b._mqtt._conns) == 3)
        threads = [t for t in threading.enumerate() if t not in before
                   and t.name.startswith(("mqtt-accept", "mqtt-conn",
                                          "mqtt-send"))]
        assert len(threads) == 1 + 2 * 3
        b.close()
        # read at once: every thread close() started it has joined
        assert [t for t in threads if t.is_alive()] == []
    finally:
        b.close()
        if client is not None:
            client.close()
        stalled.close()
        idle.close()


def test_listener_refuses_connections_once_closing():
    b = EdgeBroker("127.0.0.1", 0)
    port = b.mqtt_port
    b._mqtt._closing = True            # the close() flag, set first
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.settimeout(5)
        s.sendall(M.encode_connect("late"))
        assert s.recv(100) == b""      # dropped, never served
        s.close()
        assert b._mqtt._conns == {}
    finally:
        b.close()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)


def test_broker_without_mqtt_and_listener_port_in_use():
    b = EdgeBroker("127.0.0.1", 0, mqtt_port=None)
    try:
        assert b.mqtt_port is None
        bc = BrokerClient("127.0.0.1", b.port)
        bc.publish("t", b"no mqtt side")     # the bridge is simply off
        bc.close()
    finally:
        b.close()
    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    try:
        with pytest.raises(OSError):
            EdgeBroker("127.0.0.1", 0,
                       mqtt_port=held.getsockname()[1])
    finally:
        held.close()


# -- the elements -------------------------------------------------------------

def _send_frames(desc, frames, pts):
    send = tnns.parse_launch(desc)
    rs = tnns.PipelineRunner(send).start()
    for f, p in zip(frames, pts):
        send.get("in").push(TensorBuffer.of(f, pts=p))
    send.get("in").end()
    rs.wait(30)
    rs.stop()


def _receive(recv, rr, n):
    sink = recv.get("out")
    assert _until(lambda: len(sink.results) >= n, 15)
    recv.get("src").interrupt()
    rr.stop()
    return sink.results


@pytest.mark.parametrize("protocol", ["mqtt", "edge"])
def test_mqttsink_to_mqttsrc(broker, protocol):
    port = broker.mqtt_port if protocol == "mqtt" else broker.port
    recv = tnns.parse_launch(
        f"mqttsrc name=src protocol={protocol} port={port} topic=pipe/t "
        f"dims=4:1 types=float32 ! tensor_sink name=out")
    rr = tnns.PipelineRunner(recv).start()
    assert _until(lambda: _subscribed(broker, "pipe/t"))
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    _send_frames(f"appsrc name=in dims=4:1 types=float32 ! mqttsink "
                 f"protocol={protocol} qos=1 port={port} topic=pipe/t",
                 [x + i for i in range(3)], [i * 1000 for i in range(3)])
    res = _receive(recv, rr, 3)
    assert len(res) == 3
    for i, r in enumerate(res):
        np.testing.assert_array_equal(np.asarray(r.tensors[0]), x + i)
        assert r.pts == i * 1000       # sync=none keeps the sender's pts
    if protocol == "edge":
        assert "pub_broker_ns" in res[1].meta   # the broker stamp rides


def test_mqtt_sync_broker_rebases_pts(broker):
    recv = tnns.parse_launch(
        f"mqttsrc name=src port={broker.port} topic=s dims=1 types=uint8 "
        f"sync=broker ! tensor_sink name=out")
    rr = tnns.PipelineRunner(recv).start()
    assert _until(lambda: _subscribed(broker, "s"))
    pub = BrokerClient("127.0.0.1", broker.port)
    try:
        for i in range(3):
            pub.publish("s", encode_buffer(TensorBuffer.of(
                np.array([i], np.uint8), pts=999_999)),
                pub_broker_ns=5_000_000_000 + i * 40_000_000)
    finally:
        pub.close()
    res = _receive(recv, rr, 3)
    # pts rebased onto the broker timeline: the first 0, the rest the
    # publish stamps' gaps; the publisher's own pts discarded
    assert [r.pts for r in res] == [0, 40_000_000, 80_000_000]
    assert [int(np.asarray(r.tensors[0])[0]) for r in res] == [0, 1, 2]


@pytest.mark.parametrize("protocol", ["mqtt", "edge"])
def test_mqttsrc_sniffs_spec(broker, protocol):
    port = broker.mqtt_port if protocol == "mqtt" else broker.port
    stop = threading.Event()
    pub = (BrokerClient("127.0.0.1", port) if protocol == "edge"
           else M.MqttClient("127.0.0.1", port))

    def feed():
        frame = encode_buffer(TensorBuffer.of(np.zeros((2, 3), np.int16)))
        while not stop.wait(0.05):
            try:
                pub.publish("sniff", frame)
            except StreamError:
                return

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        recv = tnns.parse_launch(
            f"mqttsrc name=src protocol={protocol} port={port} "
            f"topic=sniff ! tensor_sink name=out")
        rr = tnns.PipelineRunner(recv).start()
        res = _receive(recv, rr, 1)
    finally:
        stop.set()
        t.join(5)
        pub.close()
    assert res[0].tensors[0].shape == (2, 3)
    assert np.asarray(res[0].tensors[0]).dtype == np.int16


def test_mqtt_elements_refuse_bad_properties():
    with pytest.raises(PipelineError, match="sync=broker"):
        tnns.parse_launch("mqttsrc protocol=mqtt sync=broker port=1 "
                          "topic=t dims=1 types=uint8 ! tensor_sink")
    with pytest.raises(PipelineError, match="protocol="):
        tnns.parse_launch("appsrc dims=1 types=uint8 ! mqttsink "
                          "protocol=amqp port=1 topic=t")
    with pytest.raises(PipelineError, match="qos="):
        tnns.parse_launch("appsrc dims=1 types=uint8 ! mqttsink qos=2 "
                          "port=1 topic=t")
    with pytest.raises(PipelineError, match="required"):
        tnns.parse_launch("mqttsrc port=1 ! tensor_sink")
    with pytest.raises(PipelineError, match="sync="):
        tnns.parse_launch("mqttsrc port=1 topic=t sync=ntp dims=1 "
                          "types=uint8 ! tensor_sink")
    # the JAX package refuses the same strings
    from nnstreamer_tpu.core.errors import PipelineError as JPipelineError

    with pytest.raises(JPipelineError, match="sync=broker"):
        jnns.parse_launch("mqttsrc protocol=mqtt sync=broker port=1 "
                          "topic=t dims=1 types=uint8 ! tensor_sink")


def test_element_properties_are_jax():
    import nnstreamer_tpu.edge.pubsub as jps
    import nnstreamer_tpu.elements.mqtt as jmq
    from nnstreamer_tpu_torch.edge import pubsub as tps
    from nnstreamer_tpu_torch.elements import mqtt as tmq

    for j, t in ((jmq.MqttSink, tmq.MqttSink), (jmq.MqttSrc, tmq.MqttSrc),
                 (jps.EdgeSink, tps.EdgeSink), (jps.EdgeSrc, tps.EdgeSrc)):
        assert set(j.PROPS) == set(t.PROPS)
        assert {k: v.default for k, v in j.PROPS.items()} == \
            {k: v.default for k, v in t.PROPS.items()}
    assert tmq.MqttSink.WANTS_HOST and tps.EdgeSink.WANTS_HOST


def test_jax_mqttsink_reaches_port_mqttsrc(broker):
    recv = tnns.parse_launch(
        f"mqttsrc name=src protocol=mqtt port={broker.mqtt_port} "
        f"topic=x/jax dims=3:2:1 types=float32 ! tensor_sink name=out")
    rr = tnns.PipelineRunner(recv).start()
    assert _until(lambda: _subscribed(broker, "x/jax"))
    send = jnns.parse_launch(
        f"appsrc name=in dims=3:2:1 types=float32 ! mqttsink "
        f"protocol=mqtt qos=1 port={broker.mqtt_port} topic=x/jax")
    rs = jnns.PipelineRunner(send).start()
    frames = [np.random.default_rng(i).standard_normal((1, 2, 3))
              .astype(np.float32) for i in range(4)]
    for i, f in enumerate(frames):
        send.get("in").push(JBuf.of(f, pts=10 + i))
    send.get("in").end()
    rs.wait(30)
    rs.stop()
    res = _receive(recv, rr, 4)
    assert [r.pts for r in res] == [10, 11, 12, 13]
    for r, f in zip(res, frames):
        np.testing.assert_array_equal(np.asarray(r.tensors[0]), f)


def test_port_mqttsink_reaches_jax_mqttsrc_over_edge(broker):
    recv = jnns.parse_launch(
        f"mqttsrc name=src port={broker.port} topic=x/port dims=4 "
        f"types=int32 ! tensor_sink name=out")
    rr = jnns.PipelineRunner(recv).start()
    assert _until(lambda: _subscribed(broker, "x/port"))
    frames = [np.arange(4, dtype=np.int32) * i for i in range(3)]
    _send_frames(f"appsrc name=in dims=4 types=int32 ! mqttsink "
                 f"port={broker.port} topic=x/port", frames, [0, 1, 2])
    sink = recv.get("out")
    assert _until(lambda: len(sink.results) >= 3, 15)
    recv.get("src").interrupt()
    rr.stop()
    for r, f in zip(sink.results, frames):
        np.testing.assert_array_equal(np.asarray(r.tensors[0]), f)
    assert [r.pts for r in sink.results] == [0, 1, 2]


def test_edge_pubsub_stream_bridging():
    spec = TensorsSpec.of(TensorInfo((2, 2), DType.FLOAT32))
    psrc = AppSrc(spec=spec, name="psrc")
    esink = EdgeSink(name="pub", port=0)
    ppipe = tnns.Pipeline("pub")
    ppipe.add(psrc)
    ppipe.add(esink)
    ppipe.link(psrc, esink)
    prunner = tnns.PipelineRunner(ppipe).start()
    esrc = EdgeSrc(name="sub", port=esink.port, timeout=15)
    sink = TensorSink(name="s")
    spipe = tnns.Pipeline("sub")
    spipe.add(esrc)
    spipe.add(sink)
    spipe.link(esrc, sink)
    srunner = tnns.PipelineRunner(spipe).start()
    try:
        assert esrc.out_specs[0].tensors[0].shape == (2, 2)
        assert _until(lambda: len(esink._server.connections()) == 1)
        for i in range(5):
            psrc.push(TensorBuffer.of(np.full((2, 2), i, np.float32),
                                      pts=i))
        psrc.end()
        prunner.wait(30)
        prunner.stop()                 # closes the publisher socket…
        srunner.wait(30)               # …which is the subscriber's EOS
    finally:
        prunner.stop()
        srunner.stop()
    assert [float(r.tensors[0][0, 0]) for r in sink.results] == \
        [0.0, 1.0, 2.0, 3.0, 4.0]
    assert [r.pts for r in sink.results] == [0, 1, 2, 3, 4]


def test_edgesrc_reads_a_jax_edgesink_and_refuses_a_missing_port():
    from nnstreamer_tpu.edge.pubsub import EdgeSink as JEdgeSink
    from nnstreamer_tpu.elements import AppSrc as JAppSrc
    from nnstreamer_tpu.tensor.dtypes import DType as JDType
    from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
    from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec

    psrc = JAppSrc(spec=JSpec.of(JInfo((3,), JDType.UINT8)), name="psrc")
    esink = JEdgeSink(name="pub", port=0)
    ppipe = jnns.Pipeline("pub")
    ppipe.add(psrc)
    ppipe.add(esink)
    ppipe.link(psrc, esink)
    prunner = jnns.PipelineRunner(ppipe).start()
    recv = tnns.parse_launch(f"edgesrc name=src port={esink.port} "
                             f"timeout=15 ! tensor_sink name=out")
    srunner = tnns.PipelineRunner(recv).start()
    try:
        assert _until(lambda: len(esink._server.connections()) == 1)
        for i in range(3):
            psrc.push(JBuf.of(np.array([i, i, i], np.uint8), pts=i))
        psrc.end()
        prunner.wait(30)
        prunner.stop()
        srunner.wait(30)
    finally:
        prunner.stop()
        srunner.stop()
    res = recv.get("out").results
    assert [np.asarray(r.tensors[0]).tolist() for r in res] == \
        [[0, 0, 0], [1, 1, 1], [2, 2, 2]]
    with pytest.raises(PipelineError, match="port="):
        tnns.PipelineRunner(tnns.parse_launch(
            "edgesrc ! tensor_sink")).start()
