"""edgesink / edgesrc — pub/sub stream bridging (the JAX package's
edge/pubsub.py on the port; a port subscriber reads a JAX publisher and
the reverse).

Reference parity: gst/edge/ (edge_sink.c:261-331, edge_src.c:305-338) —
publish a stream to any number of subscribers; caps carried as a string
in the connect handshake. The reference's MQTT-broker variant collapses
into the same direct TCP transport (edgesink is the broker). A frame of
CUDA tensors crosses to the host once (edge/wire.encode_buffer), however
many subscribers it goes to.
"""

from __future__ import annotations

import json
import queue as _queue
import threading

from typing import Iterator, Optional, Sequence

from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SinkElement, SourceElement, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("edge.pubsub")


@register_element("edgesink")
class EdgeSink(SinkElement):
    """Publisher: every connected subscriber receives every buffer.

    port=0 picks a free port (`.port` after start). Slow subscribers do
    not block the stream: sends are best-effort per connection.
    """

    WANTS_HOST = True

    ELEMENT_NAME = "edgesink"
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, 0),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._server: Optional[P.MsgServer] = None
        self._spec: Optional[TensorsSpec] = None

    def negotiate(self, in_specs: Sequence[StreamSpec]):
        spec = in_specs[0]
        if isinstance(spec, TensorsSpec):
            self._spec = spec
        return []

    def start(self) -> None:
        self._server = P.MsgServer(
            self.props["host"], self.props["port"],
            on_message=self._on_message)

    def _on_message(self, conn: P.Connection, mtype: int, payload: bytes):
        if mtype == P.T_HELLO:
            dims, types, _ = (self._spec.to_strings()
                              if self._spec else ("", "", ""))
            conn.send(P.T_HELLO_ACK,
                      json.dumps({"dims": dims, "types": types}).encode())

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.port

    def render(self, buf: TensorBuffer) -> None:
        frame = encode_buffer(buf)
        for conn in self._server.connections():
            try:
                conn.send(P.T_DATA, frame)
            except OSError:
                log.info("edgesink %s: subscriber %d dropped",
                         self.name, conn.client_id)

    def stop(self) -> None:
        if self._server is not None:
            self._server.close()


@register_element("edgesrc")
class EdgeSrc(SourceElement):
    """Subscriber: connects to an edgesink and emits its stream.

    The output spec comes from the publisher's handshake (caps-in-
    handshake, edge_sink.c), so no dims= needed — but the publisher must
    be running when this pipeline negotiates.
    """

    ELEMENT_NAME = "edgesrc"
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, None, "publisher port (required)"),
        "timeout": PropDef(float, 10.0, "handshake timeout, s"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[P.MsgClient] = None
        self._frames: _queue.Queue = _queue.Queue(maxsize=64)
        self._hello: _queue.Queue = _queue.Queue()
        self._stop = threading.Event()

    def output_spec(self) -> StreamSpec:
        if not self.props["port"]:
            raise PipelineError(
                f"edgesrc {self.name}: port= of the publisher is required")
        try:
            self._client = P.MsgClient(self.props["host"],
                                       int(self.props["port"]),
                                       on_message=self._on_message,
                                       on_close=self.interrupt)
        except StreamError as e:
            raise PipelineError(
                f"edgesrc {self.name}: cannot reach publisher: {e}") from e
        self._client.send(P.T_HELLO, b"{}")
        try:
            payload = self._hello.get(timeout=self.props["timeout"])
        except _queue.Empty:
            raise PipelineError(
                f"edgesrc {self.name}: publisher did not answer the "
                f"handshake within {self.props['timeout']}s") from None
        caps = json.loads(payload.decode())
        if not caps.get("dims"):
            raise PipelineError(
                f"edgesrc {self.name}: publisher declared no caps; is its "
                f"pipeline carrying tensors?")
        return TensorsSpec.from_strings(caps["dims"], caps["types"])

    def _on_message(self, mtype: int, payload: bytes) -> None:
        if mtype == P.T_HELLO_ACK:
            self._hello.put(payload)
        elif mtype == P.T_DATA:
            try:
                buf, _ = decode_buffer(payload)
            except ValueError as e:
                log.error("edgesrc: dropping corrupt frame: %s", e)
                return
            try:
                self._frames.put(buf, timeout=1)
            except _queue.Full:
                log.warning("edgesrc %s: frame queue full, dropping",
                            self.name)

    def interrupt(self) -> None:
        self._stop.set()
        try:
            self._frames.put_nowait(None)
        except _queue.Full:
            pass

    def generate(self) -> Iterator[TensorBuffer]:
        # ends when the publisher disconnects (on_close → interrupt) or
        # the pipeline tears down; queued frames drain first
        while True:
            if self._stop.is_set() and self._frames.empty():
                return
            item = self._frames.get()
            if item is None:
                if self._stop.is_set() and self._frames.empty():
                    return
                continue
            yield item

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
        self.interrupt()
