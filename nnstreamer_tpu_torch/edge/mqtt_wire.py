"""MQTT 3.1.1 wire framing (encode/decode + incremental splitter) and a
small client — the JAX package's edge/mqtt_wire.py on the port, the same
bytes for the same packets.

Reference parity: gst/mqtt speaks real MQTT through the paho client
(`mqttcommon.h`, `mqttsink.c`, `mqttsrc.c`), so any stock broker —
mosquitto, EMQX, a cloud endpoint — can carry its tensor streams. This
module implements the MQTT 3.1.1 control packets the tensor path needs (CONNECT/CONNACK, PUBLISH with QoS 0/1 +
PUBACK, SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP,
DISCONNECT) from the OASIS spec — no external MQTT library.

The payloads carried over PUBLISH are this framework's standard wire
frames (edge/wire.py), so caps/meta/PTS travel exactly as on every
other transport.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("edge.mqtt")

# control packet types (high nibble of the fixed-header byte)
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14

#: CONNACK return codes (3.1.1 §3.2.2.3)
CONNACK_ACCEPTED = 0

_U16 = struct.Struct(">H")


def _encode_remaining(n: int) -> bytes:
    """Remaining-length varint (§2.2.3): 7 bits per byte, MSB=continue."""
    if n < 0 or n > 268_435_455:
        raise StreamError(f"MQTT remaining length {n} out of range")
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_remaining(buf: bytes, pos: int) -> Optional[Tuple[int, int]]:
    """→ (value, bytes_consumed) or None if more bytes are needed."""
    mult, value = 1, 0
    for i in range(4):
        if pos + i >= len(buf):
            return None
        b = buf[pos + i]
        value += (b & 0x7F) * mult
        if not b & 0x80:
            return value, i + 1
        mult *= 128
    raise StreamError("malformed MQTT remaining length (>4 bytes)")


def _mqtt_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise StreamError(f"MQTT string too long ({len(b)} bytes)")
    return _U16.pack(len(b)) + b


def _read_str(payload: bytes, pos: int) -> Tuple[str, int]:
    if pos + 2 > len(payload):
        raise StreamError("truncated MQTT string")
    (n,) = _U16.unpack_from(payload, pos)
    end = pos + 2 + n
    if end > len(payload):
        raise StreamError("truncated MQTT string")
    return payload[pos + 2:end].decode("utf-8"), end


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_remaining(len(body)) \
        + body


# -- encoders ---------------------------------------------------------------

def encode_connect(client_id: str, keepalive: int = 60,
                   clean_session: bool = True,
                   username: Optional[str] = None,
                   password: Optional[bytes] = None) -> bytes:
    flags = (0x02 if clean_session else 0)
    if username is not None:
        flags |= 0x80
    if password is not None:
        flags |= 0x40
    body = (_mqtt_str("MQTT") + bytes([4])      # protocol level 4 = 3.1.1
            + bytes([flags]) + _U16.pack(keepalive)
            + _mqtt_str(client_id))
    if username is not None:
        body += _mqtt_str(username)
    if password is not None:
        body += _U16.pack(len(password)) + password
    return _packet(CONNECT, 0, body)


def encode_connack(session_present: bool = False, rc: int = 0) -> bytes:
    return _packet(CONNACK, 0, bytes([1 if session_present else 0, rc]))


def encode_publish(topic: str, payload: bytes, qos: int = 0,
                   packet_id: int = 0, retain: bool = False,
                   dup: bool = False) -> bytes:
    if qos not in (0, 1):
        raise StreamError(f"QoS {qos} not supported (0/1 only)")
    flags = (0x08 if dup else 0) | (qos << 1) | (0x01 if retain else 0)
    body = _mqtt_str(topic)
    if qos:
        body += _U16.pack(packet_id)
    return _packet(PUBLISH, flags, body + payload)


def encode_puback(packet_id: int) -> bytes:
    return _packet(PUBACK, 0, _U16.pack(packet_id))


def encode_subscribe(packet_id: int,
                     topics: List[Tuple[str, int]]) -> bytes:
    body = _U16.pack(packet_id)
    for topic, qos in topics:
        body += _mqtt_str(topic) + bytes([qos])
    return _packet(SUBSCRIBE, 0x02, body)       # §3.8.1 reserved flags


def encode_suback(packet_id: int, rcs: List[int]) -> bytes:
    return _packet(SUBACK, 0, _U16.pack(packet_id) + bytes(rcs))


def encode_unsubscribe(packet_id: int, topics: List[str]) -> bytes:
    body = _U16.pack(packet_id)
    for t in topics:
        body += _mqtt_str(t)
    return _packet(UNSUBSCRIBE, 0x02, body)


def encode_unsuback(packet_id: int) -> bytes:
    return _packet(UNSUBACK, 0, _U16.pack(packet_id))


def encode_pingreq() -> bytes:
    return _packet(PINGREQ, 0, b"")


def encode_pingresp() -> bytes:
    return _packet(PINGRESP, 0, b"")


def encode_disconnect() -> bytes:
    return _packet(DISCONNECT, 0, b"")


# -- decoded packet views ---------------------------------------------------

@dataclass
class Packet:
    ptype: int
    flags: int
    body: bytes

    # PUBLISH fields (filled by parse_publish)
    topic: str = ""
    payload: bytes = b""
    qos: int = 0
    packet_id: int = 0


def parse_connect(p: Packet) -> Tuple[str, int, bool]:
    """→ (client_id, keepalive, clean_session); validates magic/level."""
    proto, pos = _read_str(p.body, 0)
    if proto not in ("MQTT", "MQIsdp"):
        raise StreamError(f"not an MQTT CONNECT (protocol {proto!r})")
    level = p.body[pos]
    flags = p.body[pos + 1]
    (keepalive,) = _U16.unpack_from(p.body, pos + 2)
    client_id, _ = _read_str(p.body, pos + 4)
    if level not in (3, 4):
        raise StreamError(f"unsupported MQTT protocol level {level}")
    return client_id, keepalive, bool(flags & 0x02)


def parse_publish(p: Packet) -> Packet:
    p.qos = (p.flags >> 1) & 0x03
    if p.qos > 1:
        raise StreamError("QoS 2 PUBLISH not supported")
    topic, pos = _read_str(p.body, 0)
    if p.qos:
        (p.packet_id,) = _U16.unpack_from(p.body, pos)
        pos += 2
    p.topic = topic
    p.payload = p.body[pos:]
    return p


def parse_subscribe(p: Packet) -> Tuple[int, List[Tuple[str, int]]]:
    (pid,) = _U16.unpack_from(p.body, 0)
    pos = 2
    topics: List[Tuple[str, int]] = []
    while pos < len(p.body):
        t, pos = _read_str(p.body, pos)
        topics.append((t, p.body[pos]))
        pos += 1
    if not topics:
        raise StreamError("SUBSCRIBE with no topics")
    return pid, topics


def parse_unsubscribe(p: Packet) -> Tuple[int, List[str]]:
    (pid,) = _U16.unpack_from(p.body, 0)
    pos = 2
    topics: List[str] = []
    while pos < len(p.body):
        t, pos = _read_str(p.body, pos)
        topics.append(t)
    return pid, topics


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT topic filter match (§4.7): '+' one level, '#' trailing rest."""
    pp = pattern.split("/")
    tt = topic.split("/")
    for i, seg in enumerate(pp):
        if seg == "#":
            return True
        if i >= len(tt):
            return False
        if seg != "+" and seg != tt[i]:
            return False
    return len(pp) == len(tt)


class PacketSplitter:
    """Incremental byte-stream → packet splitter (reader-thread use)."""

    def __init__(self, max_packet: int = 1 << 28):
        self._buf = bytearray()
        self._max = max_packet

    def feed(self, data: bytes) -> List[Packet]:
        self._buf.extend(data)
        out: List[Packet] = []
        while True:
            if len(self._buf) < 2:
                return out
            head = self._buf[0]
            rem = decode_remaining(self._buf, 1)
            if rem is None:
                return out
            length, nlen = rem
            if length > self._max:
                raise StreamError(
                    f"MQTT packet of {length} bytes exceeds cap")
            total = 1 + nlen + length
            if len(self._buf) < total:
                return out
            body = bytes(self._buf[1 + nlen:total])
            del self._buf[:total]
            out.append(Packet(ptype=head >> 4, flags=head & 0x0F,
                              body=body))


class MqttClient:
    """Small MQTT 3.1.1 client (CONNECT, SUBSCRIBE, PUBLISH QoS 0/1,
    keepalive pings) over one TCP socket — what mqttsink/mqttsrc use in
    protocol=mqtt mode against any stock broker.

    Two threads: a reader (started before CONNECT, so the CONNACK is
    heard) and a pinger (started once the broker accepted). `close()`
    stops and joins both, from any thread but those two."""

    def __init__(self, host: str, port: int, client_id: str = "",
                 keepalive: int = 30, connect_timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._evt = threading.Condition()
        self._stop = threading.Event()
        self._connack: Optional[int] = None
        self._sub_acks: set = set()
        self._pub_acks: set = set()
        self._subs: List[Tuple[str, object]] = []   # (filter, callback)
        self._next_pid = 1
        self._alive = True
        self._keepalive = keepalive
        self._pinger: Optional[threading.Thread] = None
        cid = client_id or f"nns-torch-{os.getpid()}-{id(self) & 0xFFFF}"
        self._reader = threading.Thread(
            target=self._read_loop, name="mqtt-client-reader", daemon=True)
        self._reader.start()
        self._send(encode_connect(cid, keepalive=keepalive))
        deadline = _now() + connect_timeout
        with self._evt:
            while self._connack is None and self._alive:
                left = deadline - _now()
                if left <= 0:
                    break
                self._evt.wait(left)
        if self._connack != CONNACK_ACCEPTED:
            self.close()
            raise StreamError(
                f"MQTT broker {host}:{port} refused connection "
                f"(CONNACK rc={self._connack})")
        self._pinger = threading.Thread(
            target=self._ping_loop, name="mqtt-client-ping", daemon=True)
        self._pinger.start()

    @property
    def alive(self) -> bool:
        return self._alive

    def _read_loop(self) -> None:
        split = PacketSplitter()
        try:
            while True:
                data = self._sock.recv(1 << 16)
                if not data:
                    break
                for p in split.feed(data):
                    self._handle(p)
        except (OSError, StreamError, UnicodeDecodeError, struct.error,
                IndexError, ValueError) as e:
            # one corrupt broker frame must not tear down the process
            # with a thread traceback; the connection dies cleanly
            if not self._stop.is_set():
                log.warning("mqtt client reader: %s: %s",
                            type(e).__name__, e)
        finally:
            self._alive = False
            with self._evt:
                self._evt.notify_all()

    def _handle(self, p: Packet) -> None:
        if p.ptype == CONNACK:
            with self._evt:
                self._connack = p.body[1] if len(p.body) > 1 else 0xFF
                self._evt.notify_all()
        elif p.ptype == SUBACK:
            (pid,) = _U16.unpack_from(p.body, 0)
            with self._evt:
                self._sub_acks.add(pid)
                self._evt.notify_all()
        elif p.ptype == PUBACK:
            (pid,) = _U16.unpack_from(p.body, 0)
            with self._evt:
                self._pub_acks.add(pid)
                self._evt.notify_all()
        elif p.ptype == PUBLISH:
            parse_publish(p)
            if p.qos == 1:
                self._send(encode_puback(p.packet_id))
            for filt, cb in list(self._subs):
                if topic_matches(filt, p.topic):
                    cb(p.topic, p.payload)
        elif p.ptype in (PINGRESP, UNSUBACK):
            pass

    def _send(self, data: bytes) -> None:
        try:
            with self._wlock:
                self._sock.sendall(data)
        except OSError:
            self._alive = False

    def _ping_loop(self) -> None:
        interval = max(self._keepalive / 2.0, 1.0)
        while not self._stop.wait(interval):
            if not self._alive:
                return
            self._send(encode_pingreq())

    def _pid(self) -> int:
        with self._evt:
            pid = self._next_pid
            self._next_pid = pid % 0xFFFF + 1
            return pid

    def _wait(self, acks: set, pid: int, timeout: float, what: str):
        deadline = _now() + timeout
        with self._evt:
            while pid not in acks:
                if not self._alive:
                    raise StreamError(f"MQTT connection lost during {what}")
                remain = deadline - _now()
                if remain <= 0 or not self._evt.wait(remain):
                    raise StreamError(f"MQTT {what} timed out")
            acks.discard(pid)

    def subscribe(self, topic_filter: str, callback,
                  qos: int = 0, timeout: float = 10.0) -> None:
        """callback(topic, payload) runs on the reader thread."""
        self._subs.append((topic_filter, callback))
        pid = self._pid()
        self._send(encode_subscribe(pid, [(topic_filter, qos)]))
        self._wait(self._sub_acks, pid, timeout, "SUBSCRIBE")

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                timeout: float = 10.0) -> None:
        if qos == 0:
            self._send(encode_publish(topic, payload, qos=0))
            if not self._alive:
                raise StreamError("MQTT connection lost during PUBLISH")
            return
        pid = self._pid()
        self._send(encode_publish(topic, payload, qos=1, packet_id=pid))
        self._wait(self._pub_acks, pid, timeout, "PUBLISH(qos1)")

    def close(self) -> None:
        if self._stop.is_set():
            return
        if self._alive:
            self._send(encode_disconnect())
        self._alive = False
        self._stop.set()
        # shutdown() before close(): close() alone does not wake the
        # reader blocked in recv() on Linux
        for op in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                   self._sock.close):
            try:
                op()
            except OSError:
                pass
        me = threading.current_thread()
        for t in (self._reader, self._pinger):
            if t is not None and t is not me and t.is_alive():
                t.join(5.0)


def _now() -> float:
    return time.monotonic()
