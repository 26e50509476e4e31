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

Not ported yet: the real-MQTT listener (the JAX package's
`_MqttListener`, which needs edge/mqtt_wire.py). The port's
`EdgeBroker` defaults to ``mqtt_port=None`` and refuses any other value
with a StreamError, where the JAX package's default ``mqtt_port=0``
starts the listener.
"""

from __future__ import annotations

import json
import struct
import threading
import time
from typing import Callable, Dict, Optional, Set, Tuple

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
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

    `mqtt_port` must stay None: the real-MQTT listener (a second port
    speaking MQTT 3.1.1, bridged into the topic space) waits for the
    port of edge/mqtt_wire.py, and asking for it raises."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mqtt_port: Optional[int] = None):
        if mqtt_port is not None:
            raise StreamError(
                f"EdgeBroker(mqtt_port={mqtt_port!r}): the MQTT listener "
                f"is not ported yet (it needs edge/mqtt_wire.py, ROADMAP "
                f"Queue 1 item 5); leave mqtt_port=None — discovery, "
                f"edge-protocol pub/sub and the clock exchange work "
                f"without it")
        self._lock = threading.Lock()
        self._registry: Dict[str, dict] = {}          # name → {host,port,owner}
        self._subs: Dict[str, Set[P.Connection]] = {}  # topic → conns
        self._server = P.MsgServer(
            host, port, on_message=self._on_message,
            on_disconnect=self._on_disconnect)
        log.info("edge broker on %s:%d (mqtt: off)", host,
                 self._server.port)

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def mqtt_port(self) -> Optional[int]:
        return None

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
            topic, _, _ = unpack_publish(payload)
            with self._lock:
                targets = list(self._subs.get(topic, ()))
            for sub in targets:
                if sub.client_id == conn.client_id:
                    continue   # no self-echo
                try:
                    sub.send(T_PUBLISH, payload)
                except OSError:
                    pass   # reader thread will reap it
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

    def close(self) -> None:
        self._server.close()


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
