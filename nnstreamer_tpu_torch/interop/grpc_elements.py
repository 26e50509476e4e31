"""tensor_src_grpc / tensor_sink_grpc — streaming tensors over real gRPC,
the JAX package's interop/grpc_elements.py on the port.

Reference parity: ext/nnstreamer/tensor_source/tensor_src_grpc.c +
tensor_sink/tensor_sink_grpc.c over the shared engine
ext/nnstreamer/extra/nnstreamer_grpc_common.cc. Same contract:

- service nnstreamer.protobuf.TensorService (tensors.proto),
  SendTensors (client-streaming) / RecvTensors (server-streaming);
- every element can run as gRPC *server* or *client* (`server` prop,
  tensor_src_grpc.c:148-160), so all four pairings work:
    sink(server) ← src(client) pull, sink(client) → src(server) push;
- frames are self-describing Tensors messages, so an external process
  with any gRPC stack + the schema can feed or tap a pipeline.

No generated stubs and no `google.protobuf`: handlers and multicallables
are registered by path (grpc's generic-handler API) and carry bytes;
interop/tensors_proto.py serializes the messages, and
`google.protobuf.Empty` is the empty byte string. `grpc` itself is
imported at first use: where it is missing, starting the element raises
a PipelineError naming the package; there is no other transport. PTS is
not part of the interop schema; buffers arrive without timestamps.

Lifecycle (as the port's other transports, ROADMAP N30/N32): every
thread and call is started before it is published on the element, a
closing element accepts no new client stream, and `stop()` ends and
joins what the element started: the server (its handlers included), the
RPC in flight and the puller thread.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Iterator, Optional

from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SinkElement, SourceElement, StreamSpec, prop_bool)
from nnstreamer_tpu_torch.interop import tensors_proto as pb
from nnstreamer_tpu_torch.interop.protobuf_codec import (
    buffer_to_msg, decode_protobuf)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("interop.grpc")

_SEND = f"/{pb.SERVICE}/SendTensors"
_RECV = f"/{pb.SERVICE}/RecvTensors"
_EOS = object()
#: how long stop() waits for a server's handlers or a call to end
_JOIN_S = 5.0
#: poll period of every blocking wait that must observe a stop
_TICK_S = 0.1


def _raw(b: bytes) -> bytes:
    return b


def _grpc(element: str):
    """The grpc module, imported at first use; PipelineError naming the
    package and the element where it is not installed."""
    try:
        import grpc
    except ImportError as e:
        raise PipelineError(
            f"{element}: gRPC needs the grpcio package, which is not "
            f"installed ({e}); install grpcio or use another transport "
            f"element") from None
    return grpc


def _start_server(grpc, element: str, host: str, port: int, rpcs: dict):
    """→ (server, bound_port, executor). port=0 picks a free port."""
    from concurrent import futures

    handler = grpc.method_handlers_generic_handler(pb.SERVICE, rpcs)
    executor = futures.ThreadPoolExecutor(
        max_workers=8, thread_name_prefix=f"{element}-grpc")
    # no SO_REUSEPORT: a port collision must fail loudly, not silently
    # split traffic between two servers
    server = grpc.server(executor, options=(("grpc.so_reuseport", 0),))
    server.add_generic_rpc_handlers((handler,))
    try:
        bound = server.add_insecure_port(f"{host}:{port}")
    except RuntimeError:
        bound = 0
    if bound == 0:
        executor.shutdown(wait=False)
        raise PipelineError(f"{element}: cannot bind gRPC server on "
                            f"{host}:{port}")
    server.start()
    return server, bound, executor


def _stop_server(name: str, server, executor) -> None:
    """Stop a server, wait for its termination and join its handlers."""
    if not server.stop(grace=0.5).wait(_JOIN_S):
        log.warning("%s: gRPC server did not terminate within %.0f s",
                    name, _JOIN_S)
    executor.shutdown(wait=True)


def _put_eos(q: _queue.Queue) -> None:
    """Non-blocking EOS: on a full queue (stalled client), drop one frame
    to make room — never hang teardown on a slow reader."""
    try:
        q.put_nowait(_EOS)
    except _queue.Full:
        try:
            q.get_nowait()
            q.put_nowait(_EOS)
        except (_queue.Empty, _queue.Full):
            pass


@register_element("tensor_sink_grpc")
class TensorSinkGrpc(SinkElement):
    """Pipeline egress over gRPC.

    server=true: host RecvTensors; every connected external client gets
    the stream (fan-out, per-client bounded queue — a slow client drops
    its own frames, never stalls the pipeline).
    server=false: connect out and SendTensors the stream.
    """

    ELEMENT_NAME = "tensor_sink_grpc"
    WANTS_HOST = True
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, None, "listen/connect port (0 = pick free)"),
        "server": PropDef(prop_bool, True, "host the service vs connect out"),
        "queue_size": PropDef(int, 64, "per-client buffer before dropping"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["port"] is None:
            raise PipelineError(f"{self.name}: port= is required")
        self._server = None
        self._executor = None
        self._clients: set = set()
        self._lock = threading.Lock()
        self._closing = False
        self._sendq: Optional[_queue.Queue] = None
        self._chan = None
        self._call = None
        self.bound_port: Optional[int] = None
        self._rate = None

    def negotiate(self, in_specs):
        self._rate = getattr(in_specs[0], "rate", None)
        return super().negotiate(in_specs)

    @property
    def client_count(self) -> int:
        """Clients subscribed to RecvTensors (server mode)."""
        with self._lock:
            return len(self._clients)

    # -- server mode -------------------------------------------------------
    def _recv_tensors(self, request, context):
        q: _queue.Queue = _queue.Queue(maxsize=self.props["queue_size"])
        with self._lock:
            if self._closing:
                return
            self._clients.add(q)
        try:
            while context.is_active():
                try:
                    item = q.get(timeout=_TICK_S)
                except _queue.Empty:
                    continue
                if item is _EOS:
                    return
                yield item
        finally:
            with self._lock:
                self._clients.discard(q)

    # -- client mode -------------------------------------------------------
    def _frames(self) -> Iterator[bytes]:
        while True:
            try:
                item = self._sendq.get(timeout=_TICK_S)
            except _queue.Empty:
                if self._closing:
                    return
                continue
            if item is _EOS:
                return
            yield item

    # -- element lifecycle ---------------------------------------------------
    def start(self) -> None:
        grpc = _grpc(self.ELEMENT_NAME)
        if self.props["server"]:
            server, port, executor = _start_server(
                grpc, self.name, self.props["host"], self.props["port"],
                {"RecvTensors": grpc.unary_stream_rpc_method_handler(
                    self._recv_tensors, request_deserializer=_raw,
                    response_serializer=_raw)})
            self._server, self._executor = server, executor
            self.bound_port = port
            log.info("%s: serving RecvTensors on :%d", self.name, port)
            return
        self._sendq = _queue.Queue(maxsize=self.props["queue_size"])
        chan = grpc.insecure_channel(
            f"{self.props['host']}:{self.props['port']}")
        send = chan.stream_unary(_SEND, request_serializer=_raw,
                                 response_deserializer=_raw)
        # wait_for_ready: don't fail fast if the peer pipeline is still
        # binding its server (startup ordering is unsynchronized)
        call = send.future(self._frames(), wait_for_ready=True)
        self._chan, self._call = chan, call

    def render(self, buf: TensorBuffer) -> None:
        frame = buffer_to_msg(buf, rate=self._rate, tracer=self._tracer,
                              name=self.name).SerializeToString()
        if self.props["server"]:
            with self._lock:
                clients = list(self._clients)
            for q in clients:
                try:
                    q.put_nowait(frame)
                except _queue.Full:
                    pass  # that client lags; drop its frame, not the stream
            return
        while True:
            if self._call.done():
                err = self._call.exception() if not \
                    self._call.cancelled() else "cancelled"
                raise StreamError(
                    f"{self.name}: gRPC send stream failed: {err}")
            try:
                self._sendq.put(frame, timeout=_TICK_S)
                return
            except _queue.Full:
                continue

    def stop(self) -> None:
        with self._lock:
            self._closing = True
            clients = list(self._clients)
        for q in clients:
            _put_eos(q)
        if self._server is not None:
            _stop_server(self.name, self._server, self._executor)
            self._server = self._executor = None
        if self._call is not None:
            # after the frames still queued; drop one only if the peer
            # stalls for the whole join window
            deadline = time.monotonic() + _JOIN_S
            while not self._call.done() and time.monotonic() < deadline:
                try:
                    self._sendq.put(_EOS, timeout=_TICK_S)
                    break
                except _queue.Full:
                    continue
            else:
                _put_eos(self._sendq)
            try:
                self._call.result(timeout=_JOIN_S)
            except Exception as e:       # a failed or unreachable peer
                if not self._call.done():
                    self._call.cancel()
                log.info("%s: send stream ended: %s", self.name, e)
            self._chan.close()
            self._call = self._chan = None


@register_element("tensor_src_grpc")
class TensorSrcGrpc(SourceElement):
    """Pipeline ingress over gRPC.

    server=true: host SendTensors; external clients stream frames in.
    server=false: connect out and pull via RecvTensors.
    Output spec comes from dims=/types= or is sniffed from frame 1
    (ipc_src convention).
    """

    ELEMENT_NAME = "tensor_src_grpc"
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, None, "listen/connect port (0 = pick free)"),
        "server": PropDef(prop_bool, True),
        "dims": PropDef(str, "", "expected dims (else sniffed from frame 1)"),
        "types": PropDef(str, "float32"),
        "sniff_timeout": PropDef(float, 10.0, "first-frame wait, s"),
        "queue_size": PropDef(int, 64),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["port"] is None:
            raise PipelineError(f"{self.name}: port= is required")
        self._q: _queue.Queue = _queue.Queue(maxsize=self.props["queue_size"])
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._server = None
        self._executor = None
        self._chan = None
        self._call = None
        self._puller: Optional[threading.Thread] = None
        self._pull_err: Optional[BaseException] = None
        self._sniffed: Optional[TensorBuffer] = None
        self.bound_port: Optional[int] = None

    # -- server mode ---------------------------------------------------------
    def _enqueue(self, frame) -> bool:
        """Bounded put that keeps observing the stop: a stopped pipeline
        no longer drains the queue, and a blocking put would park a gRPC
        handler thread forever."""
        while not self._stop.is_set():
            try:
                self._q.put(frame, timeout=_TICK_S)
                return True
            except _queue.Full:
                continue
        return False

    def _send_tensors(self, request_iterator, context):
        for frame in request_iterator:
            if not self._enqueue(frame):
                break
        return pb.EMPTY

    # -- client mode ---------------------------------------------------------
    def _pull_loop(self, call):
        try:
            for frame in call:
                if not self._enqueue(frame):
                    break
        except BaseException as e:
            if not self._stop.is_set():
                self._pull_err = e
        finally:
            # clean end-of-stream with a live consumer: deliver every
            # queued frame (stop-aware bounded put); only if the pipeline
            # already stopped fall back to the frame-dropping variant
            if not self._enqueue(_EOS):
                _put_eos(self._q)

    def _ensure_running(self):
        with self._lock:
            if self._stop.is_set() or self._server is not None \
                    or self._puller is not None:
                return
            grpc = _grpc(self.ELEMENT_NAME)
            if self.props["server"]:
                server, port, executor = _start_server(
                    grpc, self.name, self.props["host"], self.props["port"],
                    {"SendTensors": grpc.stream_unary_rpc_method_handler(
                        self._send_tensors, request_deserializer=_raw,
                        response_serializer=_raw)})
                self._server, self._executor = server, executor
                self.bound_port = port
                log.info("%s: serving SendTensors on :%d", self.name, port)
                return
            chan = grpc.insecure_channel(
                f"{self.props['host']}:{self.props['port']}")
            recv = chan.unary_stream(_RECV, request_serializer=_raw,
                                     response_deserializer=_raw)
            call = recv(pb.EMPTY, wait_for_ready=True)
            puller = threading.Thread(target=self._pull_loop, args=(call,),
                                      name=f"{self.name}-pull", daemon=True)
            puller.start()
            self._chan, self._call, self._puller = chan, call, puller

    def _next(self, timeout: float):
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def start(self) -> None:
        self._ensure_running()

    def output_spec(self) -> StreamSpec:
        if self.props["dims"]:
            return TensorsSpec.from_strings(self.props["dims"],
                                            self.props["types"])
        self._ensure_running()
        frame = self._next(self.props["sniff_timeout"])
        if frame is None or frame is _EOS:
            raise PipelineError(
                f"{self.name}: no frame arrived within "
                f"{self.props['sniff_timeout']}s to sniff the stream type; "
                f"declare dims=/types= to negotiate without sniffing")
        self._sniffed = decode_protobuf(frame)
        return self._sniffed.spec()

    def generate(self) -> Iterator[TensorBuffer]:
        self._ensure_running()
        if self._sniffed is not None:
            yield self._sniffed
            self._sniffed = None
        while not self._stop.is_set():
            frame = self._next(_TICK_S)
            if frame is _EOS:
                if self._pull_err is not None:
                    raise StreamError(
                        f"{self.name}: gRPC receive stream failed: "
                        f"{self._pull_err}")
                return
            if frame is None:
                continue
            yield decode_protobuf(frame)

    def interrupt(self) -> None:
        self._stop.set()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        if self._server is not None:
            _stop_server(self.name, self._server, self._executor)
            self._server = self._executor = None
        if self._puller is not None:
            self._call.cancel()
            self._puller.join(_JOIN_S)
            if self._puller.is_alive():
                log.warning("%s: puller thread still alive %.0f s after "
                            "its call was cancelled", self.name, _JOIN_S)
            self._chan.close()
            self._puller = self._call = self._chan = None
