"""EdgeBroker — one well-known endpoint for discovery, brokered pub/sub,
and cross-host clock alignment (the JAX package's edge/broker.py on the
port; the same message types, so a port peer and a JAX peer share one
broker).

Reference parity, three subsystems collapsed into one small service:

- **HYBRID discovery** (tensor_query_common.c:35-39: MQTT-for-discovery +
  TCP-for-data): services REGISTER name→host:port here; clients LOOKUP by
  name and then speak the normal direct TCP data protocol. Registrations
  are liveness-scoped — they vanish when the owning connection drops, so
  a crashed server never leaves a stale address behind.
- **MQTT-style brokered pub/sub** (gst/mqtt/, 3.4k LoC): PUBLISH fans a
  topic frame out to every SUBSCRIBE'd connection. Payloads are standard
  wire frames (edge/wire.py) so caps travel with every message.
- **NTP-style clock alignment** (ntputil.c:140, Documentation/
  synchronization-in-mqtt-elements.md): a TIME exchange returns the
  broker's clock; clients estimate their offset SNTP-style (t1 - (t0+t2)/2)
  and publishers stamp frames in *broker time*, giving all hosts one
  timeline without running an NTP daemon.

Wire framing rides edge/protocol.py (length-prefixed TCP messages).
A second listener speaks real MQTT 3.1.1 (edge/mqtt_wire.py) and bridges
its topics both ways into the same topic space.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import queue as _queue
import socket
from typing import Callable, Dict, List, Optional, Set, Tuple

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.edge import mqtt_wire as M
from nnstreamer_tpu_torch.edge import protocol as P

log = get_logger("edge.broker")

# broker message types (continuing edge/protocol.py's space)
T_REGISTER = 16      # json {name, host, port}
T_REGISTER_ACK = 17
T_REGISTER_NAK = 18  # utf8 reason
T_LOOKUP = 19        # json {name}
T_LOOKUP_ACK = 20    # json {name, host, port}
T_LOOKUP_NAK = 21    # utf8 reason
T_SUBSCRIBE = 22     # utf8 topic
T_PUBLISH = 23       # u16 topic_len | topic | u64 pub_broker_ns | frame
T_TIME = 24          # 8 opaque client bytes
T_TIME_ACK = 25      # those 8 bytes | u64 broker time_ns
T_UNREGISTER = 26    # json {name}

_PUB_HEAD = struct.Struct("<H")
_PUB_TS = struct.Struct("<Q")
_TIME_ACK = struct.Struct("<8sQ")


def pack_publish(topic: str, pub_broker_ns: int, frame: bytes) -> bytes:
    t = topic.encode()
    if len(t) > 0xFFFF:
        raise StreamError(f"topic too long ({len(t)} bytes)")
    return _PUB_HEAD.pack(len(t)) + t + _PUB_TS.pack(pub_broker_ns) + frame


def unpack_publish(payload: bytes) -> Tuple[str, int, bytes]:
    if len(payload) < _PUB_HEAD.size:
        raise StreamError("truncated publish frame")
    (tlen,) = _PUB_HEAD.unpack_from(payload, 0)
    off = _PUB_HEAD.size + tlen
    if len(payload) < off + _PUB_TS.size:
        raise StreamError("truncated publish frame")
    topic = payload[_PUB_HEAD.size:off].decode()
    (ts,) = _PUB_TS.unpack_from(payload, off)
    return topic, ts, payload[off + _PUB_TS.size:]


class EdgeBroker:
    """The broker service. Threading: MsgServer owns the sockets; all
    state mutations run on reader threads under one lock.

    With `mqtt_port` set (0 = auto-pick), a second listener speaks real
    MQTT 3.1.1 (edge/mqtt_wire.py): stock clients (paho, mosquitto_sub)
    CONNECT/SUBSCRIBE/PUBLISH against it, and topics bridge both ways
    between the MQTT domain and the edge-protocol pub/sub domain —
    reference parity with gst/mqtt's any-broker interop
    (`mqttcommon.h:43-63`) without requiring an external daemon.
    ``mqtt_port=None`` opens no second port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mqtt_port: Optional[int] = 0):
        self._lock = threading.Lock()
        self._registry: Dict[str, dict] = {}          # name → {host,port,owner}
        self._subs: Dict[str, Set[P.Connection]] = {}  # topic → conns
        self._mqtt: Optional[_MqttListener] = None
        self._server = P.MsgServer(
            host, port, on_message=self._on_message,
            on_disconnect=self._on_disconnect)
        if mqtt_port is not None:
            try:
                self._mqtt = _MqttListener(self, host, mqtt_port)
            except Exception:
                self._server.close()
                raise
        log.info("edge broker on %s:%d (mqtt: %s)", host,
                 self._server.port,
                 self._mqtt.port if self._mqtt else "off")

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def mqtt_port(self) -> Optional[int]:
        return self._mqtt.port if self._mqtt else None

    # -- dispatch ----------------------------------------------------------
    def _on_message(self, conn: P.Connection, mtype: int,
                    payload: bytes) -> None:
        # a standalone broker accepts arbitrary network clients: malformed
        # payloads must NAK/log, never kill the reader thread
        try:
            self._dispatch(conn, mtype, payload)
        except StreamError as e:
            log.warning("broker: bad %d message from conn %d: %s",
                        mtype, conn.client_id, e)
        except (ValueError, KeyError, TypeError, AttributeError,
                UnicodeDecodeError) as e:
            log.warning("broker: malformed %d payload from conn %d: %s",
                        mtype, conn.client_id, e)

    def _dispatch(self, conn: P.Connection, mtype: int,
                  payload: bytes) -> None:
        if mtype == T_TIME:
            conn.send(T_TIME_ACK,
                      _TIME_ACK.pack(payload[:8].ljust(8, b"\0"),
                                     time.time_ns()))
        elif mtype == T_REGISTER:
            self._register(conn, payload)
        elif mtype == T_UNREGISTER:
            name = json.loads(payload.decode()).get("name", "")
            with self._lock:
                ent = self._registry.get(name)
                if ent and ent["owner"] == conn.client_id:
                    del self._registry[name]
        elif mtype == T_LOOKUP:
            name = json.loads(payload.decode()).get("name", "")
            with self._lock:
                ent = self._registry.get(name)
            if ent is None:
                conn.send(T_LOOKUP_NAK,
                          f"no service registered as {name!r}".encode())
            else:
                conn.send(T_LOOKUP_ACK, json.dumps(
                    {"name": name, "host": ent["host"],
                     "port": ent["port"]}).encode())
        elif mtype == T_SUBSCRIBE:
            topic = payload.decode()
            with self._lock:
                self._subs.setdefault(topic, set()).add(conn)
        elif mtype == T_PUBLISH:
            topic, _, frame = unpack_publish(payload)
            with self._lock:
                targets = list(self._subs.get(topic, ()))
            for sub in targets:
                if sub.client_id == conn.client_id:
                    continue   # no self-echo
                try:
                    sub.send(T_PUBLISH, payload)
                except OSError:
                    pass   # reader thread will reap it
            # bridge into the MQTT domain (payload = the bare frame)
            if self._mqtt is not None:
                self._mqtt.fanout(topic, frame)
        else:
            log.warning("broker: unknown message type %d", mtype)

    def _register(self, conn: P.Connection, payload: bytes) -> None:
        try:
            ent = json.loads(payload.decode())
            name, host, port = ent["name"], ent["host"], int(ent["port"])
        except (ValueError, KeyError, TypeError) as e:
            # TypeError covers non-dict JSON / non-castable port: the
            # client must get an immediate NAK, not a 10s RPC timeout
            conn.send(T_REGISTER_NAK, f"bad registration: {e}".encode())
            return
        with self._lock:
            cur = self._registry.get(name)
            if cur is not None and cur["owner"] != conn.client_id:
                conn.send(T_REGISTER_NAK,
                          f"{name!r} already registered by another "
                          f"connection".encode())
                return
            self._registry[name] = dict(host=host, port=port,
                                        owner=conn.client_id)
        conn.send(T_REGISTER_ACK)

    def _on_disconnect(self, conn: P.Connection) -> None:
        with self._lock:
            dead = [n for n, e in self._registry.items()
                    if e["owner"] == conn.client_id]
            for n in dead:
                del self._registry[n]
            for subs in self._subs.values():
                subs.discard(conn)
        if dead:
            log.info("broker: dropped registrations %s (owner left)", dead)

    def services(self) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            return {n: (e["host"], e["port"])
                    for n, e in self._registry.items()}

    def _publish_from_mqtt(self, topic: str, frame: bytes) -> None:
        """Bridge an MQTT-side PUBLISH into edge-protocol subscribers."""
        payload = pack_publish(topic, time.time_ns(), frame)
        with self._lock:
            targets = list(self._subs.get(topic, ()))
        for sub in targets:
            try:
                sub.send(T_PUBLISH, payload)
            except OSError:
                pass

    def close(self) -> None:
        if self._mqtt is not None:
            self._mqtt.close()
        self._server.close()


class _MqttConn:
    """One MQTT connection of the listener: its socket, topic filters,
    bounded send queue and the reader/writer threads serving it."""

    def __init__(self, cid: int, sock: socket.socket):
        self.cid = cid
        self.sock = sock
        self.filters: List[str] = []
        self.client_id = ""
        # outbound frames go through a bounded queue + writer thread so a
        # stalled subscriber can NEVER block the publishing thread (which
        # may be an edge-protocol reader via the topic bridge); overflow
        # drops frames — QoS 0 delivery semantics
        self.outq: _queue.Queue = _queue.Queue(maxsize=256)
        self.reader: Optional[threading.Thread] = None
        self.writer: Optional[threading.Thread] = None

    def put(self, data: Optional[bytes]) -> bool:
        try:
            self.outq.put_nowait(data)
            return True
        except _queue.Full:
            return False

    def shut(self) -> None:
        """Stop the writer and wake the reader (shutdown() before close():
        close() alone does not wake a thread blocked in recv() on Linux)."""
        if not self.put(None):
            # a full queue: make room for the writer's stop sentinel
            try:
                self.outq.get_nowait()
            except _queue.Empty:
                pass
            self.put(None)
        for op in (lambda: self.sock.shutdown(socket.SHUT_RDWR),
                   self.sock.close):
            try:
                op()
            except OSError:
                pass

    def threads(self) -> List[threading.Thread]:
        return [t for t in (self.reader, self.writer) if t is not None]


class _MqttListener:
    """Minimal MQTT 3.1.1 broker listener bridged to the EdgeBroker's
    topic space. QoS 0/1 (QoS 1 acks immediately: at-most-once delivery
    to subscribers, like the reference's default sink QoS), wildcard
    filters (+/#), keepalive via PINGREQ/PINGRESP.

    Lifecycle: a connection's reader and writer start before it is
    published in ``_conns`` (what `close()` joins), under the lock that
    `close()` takes to set ``_closing``, so no connection is accepted
    once closing; `close()` joins the accept loop before the
    connections, and joins every thread it started."""

    def __init__(self, broker: "EdgeBroker", host: str, port: int):
        self._broker = broker
        self._lock = threading.Lock()
        self._conns: Dict[int, _MqttConn] = {}
        #: connections whose reader ended: their threads are joined by
        #: close() (and pruned here once both have exited)
        self._ended: List[_MqttConn] = []
        self._next_id = 0
        self._closing = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(32)
        except OSError:
            self._srv.close()
            raise
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mqtt-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            with self._lock:
                if self._closing:
                    _MqttConn(-1, sock).shut()
                    return
                cid = self._next_id
                self._next_id += 1
                conn = _MqttConn(cid, sock)
                conn.reader = threading.Thread(
                    target=self._reader, args=(conn,),
                    name=f"mqtt-conn-{cid}", daemon=True)
                conn.writer = threading.Thread(
                    target=self._writer, args=(conn,),
                    name=f"mqtt-send-{cid}", daemon=True)
                conn.reader.start()
                conn.writer.start()
                # published only once started: close() joins what it sees
                self._conns[cid] = conn
                self._ended = [c for c in self._ended
                               if any(t.is_alive() for t in c.threads())]

    def _writer(self, conn: _MqttConn) -> None:
        try:
            while True:
                data = conn.outq.get()
                if data is None:
                    return
                conn.sock.sendall(data)
        except OSError:
            pass

    def _send(self, conn: _MqttConn, data: bytes) -> None:
        if not conn.put(data):
            log.warning("mqtt conn %d: send queue full, dropping frame",
                        conn.cid)

    def _reader(self, conn: _MqttConn) -> None:
        split = M.PacketSplitter()
        connected = False
        try:
            while True:
                data = conn.sock.recv(1 << 16)
                if not data:
                    return
                for p in split.feed(data):
                    if p.ptype == M.CONNECT:
                        conn.client_id, _ka, _clean = M.parse_connect(p)
                        self._send(conn, M.encode_connack(
                            False, M.CONNACK_ACCEPTED))
                        connected = True
                    elif not connected:
                        log.warning("mqtt: packet %d before CONNECT",
                                    p.ptype)
                        return
                    elif p.ptype == M.SUBSCRIBE:
                        pid, topics = M.parse_subscribe(p)
                        with self._lock:
                            conn.filters.extend(t for t, _q in topics)
                        self._send(conn, M.encode_suback(
                            pid, [min(q, 1) for _t, q in topics]))
                    elif p.ptype == M.UNSUBSCRIBE:
                        pid, topics = M.parse_unsubscribe(p)
                        with self._lock:
                            conn.filters = [f for f in conn.filters
                                            if f not in topics]
                        self._send(conn, M.encode_unsuback(pid))
                    elif p.ptype == M.PUBLISH:
                        M.parse_publish(p)
                        if p.qos == 1:
                            self._send(conn, M.encode_puback(p.packet_id))
                        # MQTT 3.1.1 has no no-local option: a client
                        # subscribed to its own publish topic gets the
                        # echo, exactly like a stock broker
                        self.fanout(p.topic, p.payload)
                        self._broker._publish_from_mqtt(p.topic, p.payload)
                    elif p.ptype == M.PINGREQ:
                        self._send(conn, M.encode_pingresp())
                    elif p.ptype == M.PUBACK:
                        pass                      # QoS1 publisher ack
                    elif p.ptype == M.DISCONNECT:
                        return
                    else:
                        log.warning("mqtt: unsupported packet type %d",
                                    p.ptype)
        except (StreamError, OSError, UnicodeDecodeError, struct.error,
                IndexError, ValueError) as e:
            # truncated/garbage packets from an open network port must
            # log one line, never kill the thread with a traceback
            if not self._closing:
                log.warning("mqtt conn %d: %s: %s", conn.cid,
                            type(e).__name__, e)
        finally:
            with self._lock:
                if self._conns.pop(conn.cid, None) is not None:
                    self._ended.append(conn)
            conn.shut()

    def fanout(self, topic: str, payload: bytes) -> None:
        with self._lock:
            targets = [c for c in self._conns.values()
                       if any(M.topic_matches(f, topic)
                              for f in c.filters)]
        if not targets:
            return
        pkt = M.encode_publish(topic, payload, qos=0)
        for conn in targets:
            self._send(conn, pkt)

    def close(self) -> None:
        with self._lock:
            self._closing = True
        for op in (lambda: self._srv.shutdown(socket.SHUT_RDWR),
                   self._srv.close):
            try:
                op()
            except OSError:
                pass
        # once the accept loop has returned, no connection can appear
        # behind the snapshot below
        self._accept_thread.join(timeout=5)
        with self._lock:
            conns = list(self._conns.values()) + self._ended
            self._conns.clear()
            self._ended = []
        for c in conns:
            c.shut()
        for c in conns:
            for t in c.threads():
                t.join(timeout=5)


class BrokerClient:
    """Client handle: register/lookup services, pub/sub topics, and an
    SNTP-style clock-offset estimate against the broker."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 10.0):
        self._replies: Dict[int, bytes] = {}
        self._reply_lock = threading.Lock()
        self._reply_evt = threading.Condition(self._reply_lock)
        self._sub_cb: Dict[str, Callable[[int, bytes], None]] = {}
        self._client = P.MsgClient(host, port, on_message=self._on_message,
                                   connect_timeout=connect_timeout)
        self._offset_ns: Optional[int] = None

    # -- plumbing ----------------------------------------------------------
    def _on_message(self, mtype: int, payload: bytes) -> None:
        if mtype == T_PUBLISH:
            try:
                topic, pub_ns, frame = unpack_publish(payload)
            except StreamError as e:
                log.error("broker client: %s", e)
                return
            cb = self._sub_cb.get(topic)
            if cb is not None:
                cb(pub_ns, frame)
            return
        with self._reply_evt:
            self._replies[mtype] = payload
            self._reply_evt.notify_all()

    def _rpc(self, send_type: int, payload: bytes, ok: int, nak: int,
             timeout: float, what: str) -> bytes:
        with self._reply_evt:
            self._replies.pop(ok, None)
            self._replies.pop(nak, None)
        self._client.send(send_type, payload)
        deadline = time.monotonic() + timeout
        with self._reply_evt:
            while ok not in self._replies and nak not in self._replies:
                remain = deadline - time.monotonic()
                if remain <= 0 or not self._reply_evt.wait(remain):
                    raise StreamError(
                        f"broker {what} timed out after {timeout}s")
            if nak in self._replies:
                raise StreamError(
                    f"broker {what} refused: "
                    f"{self._replies.pop(nak).decode()}")
            return self._replies.pop(ok)

    # -- discovery ---------------------------------------------------------
    def register(self, name: str, host: str, port: int,
                 timeout: float = 10.0) -> None:
        self._rpc(T_REGISTER,
                  json.dumps({"name": name, "host": host,
                              "port": port}).encode(),
                  T_REGISTER_ACK, T_REGISTER_NAK, timeout,
                  f"registration of {name!r}")

    def unregister(self, name: str) -> None:
        self._client.send(T_UNREGISTER, json.dumps({"name": name}).encode())

    def lookup(self, name: str, timeout: float = 10.0) -> Tuple[str, int]:
        got = self._rpc(T_LOOKUP, json.dumps({"name": name}).encode(),
                        T_LOOKUP_ACK, T_LOOKUP_NAK, timeout,
                        f"lookup of {name!r}")
        ent = json.loads(got.decode())
        return ent["host"], int(ent["port"])

    # -- clock (NTP analog) ------------------------------------------------
    def clock_offset_ns(self, samples: int = 5,
                        timeout: float = 5.0) -> int:
        """Estimate broker_clock - local_clock in ns (SNTP midpoint:
        offset ≈ t1 - (t0+t2)/2 per sample, median over samples).
        Cached; publishers use it to stamp frames in broker time."""
        offs = []
        for i in range(samples):
            tag = struct.pack("<Q", i)
            t0 = time.time_ns()
            got = self._rpc(T_TIME, tag, T_TIME_ACK, -1, timeout,
                            "time exchange")
            t2 = time.time_ns()
            _, t1 = _TIME_ACK.unpack(got)
            offs.append(t1 - (t0 + t2) // 2)
        offs.sort()
        self._offset_ns = offs[len(offs) // 2]
        return self._offset_ns

    def broker_now_ns(self) -> int:
        if self._offset_ns is None:
            self.clock_offset_ns()
        return time.time_ns() + self._offset_ns

    # -- pub/sub -----------------------------------------------------------
    def subscribe(self, topic: str,
                  callback: Callable[[int, bytes], None]) -> None:
        """callback(pub_broker_ns, wire_frame) runs on the reader thread."""
        self._sub_cb[topic] = callback
        self._client.send(T_SUBSCRIBE, topic.encode())

    def publish(self, topic: str, frame: bytes,
                pub_broker_ns: Optional[int] = None) -> None:
        ts = self.broker_now_ns() if pub_broker_ns is None else pub_broker_ns
        self._client.send(T_PUBLISH, pack_publish(topic, ts, frame))

    @property
    def alive(self) -> bool:
        return self._client.alive

    def close(self) -> None:
        self._client.close()
