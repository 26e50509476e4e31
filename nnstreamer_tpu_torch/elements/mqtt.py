"""mqttsink / mqttsrc — brokered pub/sub with cross-host time alignment
(the JAX package's elements/mqtt.py on the port; the same properties and
the same frames on the wire, so a port element and a JAX element share
one topic).

Reference parity: gst/mqtt/ (3437 LoC, paho-based) — publish any tensor
stream to a topic on a broker, subscribe from any number of pipelines on
any host, and keep timestamps comparable across machines via NTP
(mqttsrc.c:26, GstMQTTMessageHdr mqttcommon.h:43-63, ntputil.c:140).

The broker is the repository's own EdgeBroker (edge/broker.py) — no
external MQTT daemon dependency — and the NTP daemon collapses into the
broker's TIME exchange: mqttsink stamps every frame with *broker time*
(local clock + measured offset), and mqttsrc exposes that stamp plus its
own offset so receivers on a different host can rebase PTS into the
shared broker timeline (`sync=broker` rewrites PTS; `sync=none` leaves
sender PTS). Payloads are standard wire frames, so caps, meta and PTS all
travel. A frame of CUDA tensors crosses to the host in one counted step
(edge/wire.encode_buffer) before it is published.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, Optional

from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.edge.broker import BrokerClient
from nnstreamer_tpu_torch.edge.mqtt_wire import MqttClient
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SinkElement, SourceElement, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("elements.mqtt")


def _broker_props():
    return {
        "host": PropDef(str, "127.0.0.1", "broker host"),
        "port": PropDef(int, None, "broker port (required)"),
        "topic": PropDef(str, None, "topic (required)"),
        # protocol=mqtt speaks real MQTT 3.1.1 (edge/mqtt_wire.py) so a
        # STOCK broker (mosquitto, EMQX, EdgeBroker's MQTT listener)
        # carries the stream — full wire parity with the reference's
        # paho-based gst/mqtt. protocol=edge uses the EdgeBroker native
        # protocol, which adds the broker-time PTS rebase (sync=broker).
        "protocol": PropDef(str, "edge", "edge|mqtt wire protocol"),
        "qos": PropDef(int, 0, "MQTT QoS for publishes (0|1)"),
    }


def _check_protocol(name, props):
    if props["protocol"] not in ("edge", "mqtt"):
        raise PipelineError(
            f"{name}: protocol= must be edge|mqtt, got "
            f"{props['protocol']!r}")
    if props["qos"] not in (0, 1):
        raise PipelineError(
            f"{name}: qos= must be 0|1, got {props['qos']!r}")


@register_element("mqttsink")
class MqttSink(SinkElement):
    """Publish the stream to a broker topic, stamped in broker time."""

    ELEMENT_NAME = "mqttsink"
    WANTS_HOST = True
    PROPS = {**_broker_props()}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["port"] is None or not self.props["topic"]:
            raise PipelineError(
                f"{self.name}: port= (broker) and topic= are required")
        _check_protocol(self.name, self.props)
        self._bc: Optional[BrokerClient] = None
        self._mc = None                      # MqttClient (protocol=mqtt)

    def start(self) -> None:
        if self.props["protocol"] == "mqtt":
            self._mc = MqttClient(self.props["host"], self.props["port"],
                                  client_id=f"nns-{self.name}")
            return
        self._bc = BrokerClient(self.props["host"], self.props["port"])
        # one clock sync up front; frames stamp broker_now from it
        off = self._bc.clock_offset_ns()
        log.info("%s: broker clock offset %+d us", self.name, off // 1000)

    def render(self, buf: TensorBuffer) -> None:
        if self._mc is not None:
            if not self._mc.alive:
                raise StreamError(
                    f"{self.name}: MQTT connection lost (topic "
                    f"{self.props['topic']!r})")
            self._mc.publish(self.props["topic"], encode_buffer(buf),
                             qos=self.props["qos"])
            return
        if not self._bc.alive:
            raise StreamError(
                f"{self.name}: broker connection lost (topic "
                f"{self.props['topic']!r})")
        self._bc.publish(self.props["topic"], encode_buffer(buf))

    def stop(self) -> None:
        if self._bc is not None:
            self._bc.close()
            self._bc = None
        if self._mc is not None:
            self._mc.close()
            self._mc = None


@register_element("mqttsrc")
class MqttSrc(SourceElement):
    """Subscribe to a broker topic and emit its frames.

    sync=none: keep the publisher's PTS. sync=broker: rewrite PTS to the
    publish timestamp on the shared broker timeline, rebased so the first
    frame is 0 — streams from different hosts become directly
    mux/merge-able (the reference's NTP-sync use case).
    dims/types declare the spec, or it is sniffed from frame 1.
    """

    ELEMENT_NAME = "mqttsrc"
    PROPS = {
        **_broker_props(),
        "dims": PropDef(str, "", "expected dims (else sniffed)"),
        "types": PropDef(str, "float32"),
        "sync": PropDef(str, "none", "none|broker PTS handling"),
        "sniff_timeout": PropDef(float, 10.0),
        "queue_size": PropDef(int, 64, "pending frames before dropping old"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["port"] is None or not self.props["topic"]:
            raise PipelineError(
                f"{self.name}: port= (broker) and topic= are required")
        if self.props["sync"] not in ("none", "broker"):
            raise PipelineError(
                f"{self.name}: sync= must be none|broker, got "
                f"{self.props['sync']!r}")
        _check_protocol(self.name, self.props)
        if self.props["protocol"] == "mqtt" and \
                self.props["sync"] == "broker":
            raise PipelineError(
                f"{self.name}: sync=broker needs the broker-time stamps "
                f"of protocol=edge (stock MQTT has no shared clock; the "
                f"reference runs an external NTP daemon for this)")
        self._mc = None                      # MqttClient (protocol=mqtt)
        self._bc: Optional[BrokerClient] = None
        self._q: _queue.Queue = _queue.Queue(maxsize=self.props["queue_size"])
        self._stop = threading.Event()
        self._sniffed = None
        self._base_pub_ns: Optional[int] = None

    def _on_frame(self, pub_broker_ns: int, frame: bytes) -> None:
        try:
            buf, _ = decode_buffer(frame)
        except (ValueError, StreamError) as e:
            log.error("%s: dropping corrupt frame on %r: %s",
                      self.name, self.props["topic"], e)
            return
        buf.meta["pub_broker_ns"] = pub_broker_ns
        if self.props["sync"] == "broker":
            if self._base_pub_ns is None:
                self._base_pub_ns = pub_broker_ns
            buf = buf.with_tensors(buf.tensors,
                                   pts=pub_broker_ns - self._base_pub_ns)
        try:
            self._q.put_nowait(buf)
        except _queue.Full:
            try:   # drop the OLDEST so a stalled pipeline sees fresh data
                self._q.get_nowait()
                self._q.put_nowait(buf)
            except (_queue.Empty, _queue.Full):
                pass

    def _on_mqtt_frame(self, _topic: str, payload: bytes) -> None:
        # stock-MQTT path: no publish-time stamp on the wire; frames
        # keep the sender's PTS from the wire frame itself
        self._on_frame(0, payload)

    def _ensure_connected(self) -> None:
        if self.props["protocol"] == "mqtt":
            if self._mc is None:
                self._mc = MqttClient(
                    self.props["host"], self.props["port"],
                    client_id=f"nns-{self.name}")
                self._mc.subscribe(self.props["topic"],
                                   self._on_mqtt_frame,
                                   qos=self.props["qos"])
            return
        if self._bc is None:
            self._bc = BrokerClient(self.props["host"], self.props["port"])
            # no clock exchange here: PTS rebasing reads the *publish*
            # stamps (already broker time, stamped by mqttsink), so the
            # subscriber needs no own offset
            self._bc.subscribe(self.props["topic"], self._on_frame)

    def output_spec(self) -> StreamSpec:
        if self.props["dims"]:
            return TensorsSpec.from_strings(self.props["dims"],
                                            self.props["types"])
        self._ensure_connected()
        try:
            self._sniffed = self._q.get(timeout=self.props["sniff_timeout"])
        except _queue.Empty:
            raise PipelineError(
                f"{self.name}: nothing published on "
                f"{self.props['topic']!r} within "
                f"{self.props['sniff_timeout']}s; declare dims=/types= to "
                f"negotiate without sniffing") from None
        return self._sniffed.spec()

    def generate(self) -> Iterator[TensorBuffer]:
        self._ensure_connected()
        if self._sniffed is not None:
            yield self._sniffed
            self._sniffed = None
        while not self._stop.is_set():
            try:
                buf = self._q.get(timeout=0.1)
            except _queue.Empty:
                if self._bc is not None and not self._bc.alive:
                    raise StreamError(
                        f"{self.name}: broker connection lost (topic "
                        f"{self.props['topic']!r})")
                if self._mc is not None and not self._mc.alive:
                    raise StreamError(
                        f"{self.name}: MQTT connection lost (topic "
                        f"{self.props['topic']!r})")
                continue
            yield buf

    def interrupt(self) -> None:
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._bc is not None:
            self._bc.close()
            self._bc = None
        if self._mc is not None:
            self._mc.close()
            self._mc = None
