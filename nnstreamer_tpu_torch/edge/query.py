"""tensor_query elements — remote inference offload (request/reply), the
JAX package's edge/query.py on the port: the same wire, handshake and
BUSY replies, so a port client talks to a JAX server and back.

Reference parity (SURVEY.md §3.4): `tensor_query_client` wraps each frame,
sends it to a server pipeline, and blocks on an async queue for the
result; `tensor_query_serversrc`/`serversink` bracket the server pipeline
and share per-id state, routing answers back by the client_id that rides
the buffer meta (GstMetaQuery analog). Caps compatibility is verified at
connect (HELLO/ACK handshake carrying spec strings).

On the card the server pipeline's result is a buffer of CUDA tensors;
the server sink's reply brings it to the host in one counted forced
sync (edge/wire.encode_buffer), the only D2H a frame. `BatchedQueryServer`
coalesces frames from every client into batches on one card
(parallel/dispatch.py) instead of one pass a frame.

`QueryServer.get(sid)` is a class-level registry of this package's own
(a JAX server in the same process is a different object); tests call
`QueryServer.reset_all()` in their teardown.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from collections import deque

from typing import Dict, Iterator, List, Optional, Sequence

from nnstreamer_tpu_torch.core.errors import (
    PipelineError, ServerBusyError, StreamError)
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.graph.pipeline import (
    Element, Emission, PropDef, SinkElement, SourceElement, StreamSpec)
from nnstreamer_tpu_torch.runtime.tracing import (
    NULL_TRACER, ensure_trace_ctx, get_trace_ctx, percentile, stamp_hop)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec
from nnstreamer_tpu_torch.traffic.admission import AdmissionQueue

log = get_logger("edge.query")

_STOPPED = object()   # sentinel unblocking _take_reply at teardown

#: retry-after hint on shutdown/dispatch-failure BUSYs, where the
#: admission queue's drain-rate estimate is meaningless
_DEFAULT_SHUTDOWN_RETRY_MS = 250.0


class QueryServer:
    """Shared state of one query server id: the transport + the in/out
    specs + the frame queue serversrc drains (GstTensorQueryServer
    analog, tensor_query_server.c)."""

    _by_id: Dict[int, "QueryServer"] = {}
    _lock = threading.Lock()

    def __init__(self, sid: int):
        self.sid = sid
        self.server: Optional[P.MsgServer] = None
        self.in_spec: Optional[TensorsSpec] = None
        self.out_spec: Optional[TensorsSpec] = None
        # bounded admission (traffic/admission.py): a full queue refuses
        # the frame with a typed wire BUSY instead of the seed's silent
        # drop-after-5s-block, which collapsed goodput under overload.
        # serversrc re-knobs this from its properties at start().
        self.frames: AdmissionQueue = AdmissionQueue(max_pending=64)
        self.tracer = NULL_TRACER
        # set by serving/pool.py when a WorkerPool services this id;
        # serversrc extra_stats folds the pool's per-worker view in
        self.pool = None

    @classmethod
    def get(cls, sid: int) -> "QueryServer":
        with cls._lock:
            if sid not in cls._by_id:
                cls._by_id[sid] = cls(sid)
            return cls._by_id[sid]

    @classmethod
    def reset_all(cls) -> None:
        with cls._lock:
            for s in cls._by_id.values():
                if s.server is not None:
                    s.server.close()
            cls._by_id.clear()

    # -- transport lifecycle (owned by serversrc) --------------------------
    def start(self, host: str, port: int) -> None:
        if self.server is not None:
            return
        self.server = P.MsgServer(
            host, port,
            on_message=self._on_message,
            on_connect=self._on_connect,
        )

    def _on_connect(self, conn: P.Connection) -> bool:
        return True  # handshake happens via HELLO message

    def _on_message(self, conn: P.Connection, mtype: int, payload: bytes):
        if mtype == P.T_HELLO:
            try:
                want = json.loads(payload.decode())
                client_in = TensorsSpec.from_strings(
                    want["dims"], want["types"])
            except (ValueError, KeyError) as e:
                conn.send(P.T_HELLO_NAK, f"bad hello: {e}".encode())
                return
            if self.in_spec is not None and \
                    not self.in_spec.is_compatible(client_in):
                conn.send(P.T_HELLO_NAK, (
                    f"incompatible caps: server expects "
                    f"{self.in_spec.to_strings()[:2]}, client sends "
                    f"{want['dims']},{want['types']}").encode())
                return
            dims, types, _ = (self.out_spec.to_strings()
                              if self.out_spec else ("", "", ""))
            conn.send(P.T_HELLO_ACK,
                      json.dumps({"dims": dims, "types": types}).encode())
        elif mtype == P.T_DATA:
            try:
                buf, _ = decode_buffer(payload)
            except ValueError as e:
                log.error("server %d: dropping corrupt frame: %s",
                          self.sid, e)
                return
            buf = buf.with_meta(client_id=conn.client_id)
            dec = self.frames.offer(buf)
            # reject-oldest / deadline-drop sheds previously-ADMITTED
            # frames: each victim's client still gets a typed BUSY —
            # the conservation contract is that no request ever ends
            # neither-replied-nor-rejected
            for v in dec.victims:
                if v is not None:
                    self._send_busy(
                        v.meta.get("client_id"), v.pts,
                        dec.victim_cause or "shed",
                        dec.queue_depth, dec.retry_after_ms)
            if not dec.admitted:
                self._send_busy(conn.client_id, buf.pts, dec.cause,
                                dec.queue_depth, dec.retry_after_ms,
                                conn=conn)

    def _send_busy(self, client_id, pts, cause: str, depth: int,
                   retry_after_ms: float,
                   conn: Optional[P.Connection] = None) -> None:
        """Typed admission rejection: BUSY carrying the server's queue
        depth and a retry-after suggestion (the client surfaces it as
        ServerBusyError through its error policy)."""
        if self.tracer.active:
            self.tracer.record_shed(f"query_server_{self.sid}", cause,
                                    time.perf_counter(), pts=pts,
                                    depth=depth)
        if conn is None and self.server is not None and \
                client_id is not None:
            conn = self.server.connection(int(client_id))
        if conn is None:
            log.warning("server %d: client %s gone, BUSY (%s) for pts=%s "
                        "undeliverable", self.sid, client_id, cause, pts)
            return
        payload = json.dumps({
            "pts": pts, "cause": cause, "queue_depth": depth,
            "retry_after_ms": round(retry_after_ms, 1)}).encode()
        try:
            conn.send(P.T_BUSY, payload, timeout=5.0)
        except OSError as e:
            log.warning("server %d: BUSY to %s failed (%s); closing the "
                        "connection", self.sid, client_id, e)
            try:
                conn.close()
            except OSError:
                pass

    def send_busy(self, client_id, pts, cause: str) -> None:
        """BUSY a previously-admitted frame that will never be answered
        (dispatch failure, shutdown drain)."""
        c = self.frames.counters()
        self._send_busy(client_id, pts, cause, c["depth"],
                        _DEFAULT_SHUTDOWN_RETRY_MS)

    def reply(self, client_id: int, buf: TensorBuffer) -> None:
        # a request is "served" once its result reaches the reply path,
        # even if the client has meanwhile vanished — completion
        # accounting must balance admission accounting. The tenant
        # class stamped at admission rides the buffer meta end-to-end,
        # so per-class counters settle on the same class the offer was
        # counted under.
        cls = buf.meta.get("_tenant_class") \
            if isinstance(buf.meta, dict) else None
        self.frames.note_replied(cls=cls)
        stamp_hop(buf.meta, "reply")
        if self.tracer.active:
            ctx = get_trace_ctx(buf.meta)
            if ctx is not None:
                # server-side end of this request's timeline: the full
                # hop list (admission→worker→reply) as it leaves us
                extra = {"tenant": cls} if cls is not None else {}
                self.tracer.record_request(
                    f"query_server_{self.sid}", ctx["id"], ctx["hops"],
                    time.perf_counter(), pts=buf.pts, **extra)
        conn = self.server.connection(client_id) if self.server else None
        if conn is None:
            log.warning("server %d: client %d gone, dropping result",
                        self.sid, client_id)
            return
        try:
            # bounded send: a stalled client (full kernel buffer) must
            # not wedge the replying thread — which may be shared with
            # other clients (BatchedQueryServer's completion path)
            # a buffer of CUDA tensors comes to the host here: one
            # counted forced sync, traced under this server
            conn.send(P.T_RESULT,
                      encode_buffer(buf, client_id, self.tracer,
                                    f"query_server_{self.sid}"),
                      timeout=10.0)
        except OSError as e:
            log.warning("server %d: reply to %d failed (%s); closing "
                        "the connection — a timed-out send may have "
                        "left a partial frame, the stream is "
                        "unrecoverable", self.sid, client_id, e)
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        # admitted-but-unprocessed frames are shed with a typed BUSY
        # before the transport drops: no client is left to time out
        # blind on a request the server silently discarded
        for v in self.frames.shed_remaining("shutdown"):
            if v is not None:
                self.send_busy(v.meta.get("client_id"), v.pts, "shutdown")
        if self.server is not None:
            self.server.close()
            self.server = None
        with QueryServer._lock:
            QueryServer._by_id.pop(self.sid, None)


@register_element("tensor_query_serversrc")
class TensorQueryServerSrc(SourceElement):
    """Server entry pad: emits frames received from clients.

    dims/types declare the accepted input (HELLO compat check). port=0
    picks a free port (read it from `.port` — loopback tests do this).
    """

    ELEMENT_NAME = "tensor_query_serversrc"
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, 0),
        "id": PropDef(int, 0, "server pair id"),
        "dims": PropDef(str, None, "accepted input dims"),
        "types": PropDef(str, "float32"),
        # admission control (traffic/admission.py, docs/traffic.md):
        # a full server answers BUSY instead of buffering unboundedly
        "max_pending": PropDef(
            int, 64, "admission queue bound; a full queue sheds per "
                     "shed_policy with a typed BUSY reply"),
        "max_inflight": PropDef(
            int, 0, "bound on outstanding requests (queued + "
                    "processing); 0 = unlimited"),
        "shed_policy": PropDef(
            str, "reject-newest",
            "reject-newest | reject-oldest | deadline-drop (sheds "
            "requests whose meta deadline_ms budget has passed)"),
        # HYBRID connect type (tensor_query_common.c:35-39): advertise
        # this server under topic= at an EdgeBroker so clients find it by
        # name instead of host:port
        "broker_host": PropDef(str, "127.0.0.1"),
        "broker_port": PropDef(int, 0, "EdgeBroker port (0 = no broker)"),
        "topic": PropDef(str, "", "service name to register at the broker"),
        "advertise_host": PropDef(
            str, "", "address clients should dial (required when binding "
                     "a wildcard like 0.0.0.0)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._srv: Optional[QueryServer] = None
        self._stop = threading.Event()
        self._broker = None

    def output_spec(self) -> StreamSpec:
        if not self.props["dims"]:
            raise PipelineError(
                f"tensor_query_serversrc {self.name}: dims= is required "
                f"(declares the accepted client input)")
        return TensorsSpec.from_strings(self.props["dims"],
                                        self.props["types"])

    def start(self) -> None:
        self._srv = QueryServer.get(self.props["id"])
        self._srv.in_spec = self.out_specs[0]
        try:
            victims = self._srv.frames.configure(
                max_pending=self.props["max_pending"],
                max_inflight=self.props["max_inflight"],
                shed_policy=self.props["shed_policy"])
        except ValueError as e:
            raise PipelineError(f"{self.name}: {e}") from None
        # a policy change to deadline-drop purges already-expired
        # queued entries (admission.configure contract): each victim
        # is owed a BUSY, exactly as if an offer() had purged it
        for v in victims or ():
            if v is not None:
                self._srv.send_busy(v.meta.get("client_id"), v.pts,
                                    "deadline")
        # the runner hands the tracer down before start(): shed events
        # land on the pipeline's trace alongside everything else
        self._srv.tracer = self._tracer
        self._srv.start(self.props["host"], self.props["port"])
        if self.props["broker_port"]:
            if not self.props["topic"]:
                raise PipelineError(
                    f"{self.name}: broker registration needs topic=<name>")
            from nnstreamer_tpu_torch.edge.broker import BrokerClient

            advertise = self.props["advertise_host"] or self.props["host"]
            if advertise in ("0.0.0.0", "::"):
                raise PipelineError(
                    f"{self.name}: binding {advertise} but registering at "
                    f"a broker — clients cannot dial a wildcard address; "
                    f"set advertise_host=<reachable address>")
            # the registration lives as long as this connection: broker
            # drops it if we crash (no stale addresses)
            self._broker = BrokerClient(self.props["broker_host"],
                                        self.props["broker_port"])
            self._broker.register(self.props["topic"], advertise, self.port)

    @property
    def port(self) -> int:
        assert self._srv is not None and self._srv.server is not None
        return self._srv.server.port

    def interrupt(self) -> None:
        self._stop.set()
        if self._srv is not None:
            # sentinels bypass admission and cannot be lost to a full
            # queue (AdmissionQueue.put_nowait is unbounded for them)
            self._srv.frames.put_nowait(None)

    def stop(self) -> None:
        if self._broker is not None:
            self._broker.close()
            self._broker = None
        if self._srv is not None:
            self._srv.stop()

    def generate(self) -> Iterator[TensorBuffer]:
        while not self._stop.is_set():
            item = self._srv.frames.get()
            if item is None:
                return
            yield item

    def admission_counters(self) -> Dict:
        """Consistent admission/shed snapshot (traffic harness reads
        this for the conservation check)."""
        srv = self._srv or QueryServer.get(self.props["id"])
        return srv.frames.counters()

    def extra_stats(self) -> Dict:
        c = self.admission_counters()
        out = {
            "admitted": c["admitted"],
            "replied": c["replied"],
            "rejected_total": sum(c["rejected"].values()),
            "shed_total": sum(c["shed"].values()),
            "admission_depth": c["depth"],
            "admission_depth_peak": c["depth_peak"],
            "admission_inflight": c["inflight"],
        }
        for cause, v in c["rejected"].items():
            out[f"rejected_{cause}"] = v
        for cause, v in c["shed"].items():
            out[f"shed_{cause}"] = v
        srv = self._srv or QueryServer.get(self.props["id"])
        if srv.pool is not None:
            out.update(srv.pool.extra_stats())
        return out


@register_element("tensor_query_serversink")
class TensorQueryServerSink(SinkElement):
    """Server exit pad: routes each result back to its client by the
    client_id riding buffer meta."""

    WANTS_HOST = True

    ELEMENT_NAME = "tensor_query_serversink"
    PROPS = {
        "id": PropDef(int, 0, "server pair id"),
    }

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        srv = QueryServer.get(self.props["id"])
        spec = in_specs[0]
        if isinstance(spec, TensorsSpec):
            srv.out_spec = spec
        return []

    def render(self, buf: TensorBuffer) -> None:
        client_id = buf.meta.get("client_id")
        if client_id is None:
            raise StreamError(
                f"tensor_query_serversink {self.name}: buffer has no "
                f"client_id meta — it must originate from "
                f"tensor_query_serversrc (same id) for reply routing")
        QueryServer.get(self.props["id"]).reply(int(client_id), buf)


@register_element("tensor_query_client")
class TensorQueryClient(Element):
    """Sync RPC offload: push frame to server, block (with timeout) for
    the result, emit it downstream (tensor_query_client.c:657-699).

    Backpressure: a server-side admission rejection (wire BUSY) surfaces
    as `ServerBusyError` carrying the server's queue depth and
    retry-after hint, so the element error-policy machinery finally sees
    remote overload: `error_policy=retry:N:backoff` re-offers the frame
    after the backoff, `degrade` routes it to the fallback pad, `skip`
    sheds it client-side, and the default `fail` stops the pipeline.
    With `max_in_flight=1` (the default) retry semantics are exact — the
    rejected frame IS the retried frame. With a pipelined window >1 a
    rejection may concern an *older* in-flight frame whose bytes are
    gone; that frame counts as shed and the policy's retry/backoff acts
    as send throttling (the overload response that matters), so under
    overload the emitted sequence can have gaps but never reorders.
    """

    WANTS_HOST = True

    ELEMENT_NAME = "tensor_query_client"
    PROPS = {
        "host": PropDef(str, "127.0.0.1"),
        "port": PropDef(int, None, "server port (tcp) / broker port (hybrid)"),
        "timeout": PropDef(float, 10.0, "per-frame reply timeout, s"),
        # connect_type=hybrid: host/port point at an EdgeBroker; the
        # server address is discovered by topic= (MQTT-discovery + TCP-
        # data pattern, tensor_query_common.c:39)
        "connect_type": PropDef(str, "tcp", "tcp | hybrid"),
        "topic": PropDef(str, "", "service name (hybrid)"),
        # >1 pipelines the offload: up to N frames in flight before
        # blocking, overlapping network+server latency across frames
        # (the reference blocks per frame, tensor_query_client.c:699 —
        # exactly the per-frame sync the TPU design avoids). Ordering is
        # preserved: one TCP connection, FIFO server pipeline.
        "max_in_flight": PropDef(int, 1, "1 = reference per-frame sync"),
        # Bounds the TCP dial itself (SYN + handshake), distinct from
        # timeout= which bounds per-frame replies on an established
        # connection. 0 falls back to protocol.DEFAULT_CONNECT_TIMEOUT_S;
        # without a bound a dial into a dead/filtered address would sit
        # in the OS connect retry cycle (~minutes) wedging negotiate().
        "connect_timeout": PropDef(
            float, 0.0, "TCP connect timeout, s (0 = default)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["max_in_flight"] < 1:
            raise PipelineError(
                f"{self.name}: max_in_flight must be >= 1")
        self._client: Optional[P.MsgClient] = None
        self._replies: _queue.Queue = _queue.Queue()
        self._hello: _queue.Queue = _queue.Queue()
        # (pts, t_send) of sent-but-unanswered frames, server FIFO order
        self._pending: "deque" = deque()
        # BUSY rejections consumed off the wire but not yet raised (the
        # raise is deferred to a point where no collected emissions can
        # be lost with it)
        self._busy_stash: "deque" = deque()
        # client-side goodput/rejection stats (extra_stats)
        self._sent = 0
        self._replied = 0
        self._busy = 0
        self._rtt: "deque" = deque(maxlen=2048)   # reply RTTs, seconds
        self._last_busy: Optional[dict] = None

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if not self.props["port"]:
            self.fail_negotiation("port= of the query server is required")
        host, port = self.props["host"], int(self.props["port"])
        if self.props["connect_type"] == "hybrid":
            if not self.props["topic"]:
                self.fail_negotiation(
                    "connect_type=hybrid needs topic=<service name> "
                    "(host/port address the broker)")
            from nnstreamer_tpu_torch.edge.broker import BrokerClient

            bc = None
            try:
                bc = BrokerClient(host, port)
                host, port = bc.lookup(self.props["topic"],
                                       timeout=self.props["timeout"])
            except StreamError as e:
                self.fail_negotiation(
                    f"hybrid discovery of {self.props['topic']!r} via "
                    f"broker {self.props['host']}:{self.props['port']} "
                    f"failed: {e}")
            finally:
                if bc is not None:   # no socket/thread leak on failure
                    bc.close()
        elif self.props["connect_type"] != "tcp":
            self.fail_negotiation(
                f"connect_type must be tcp|hybrid, got "
                f"{self.props['connect_type']!r}")
        try:
            self._client = P.MsgClient(
                host, port, on_message=self._on_message,
                connect_timeout=self.props["connect_timeout"] or None)
        except StreamError as e:
            self.fail_negotiation(str(e))
        dims, types, _ = spec.to_strings()
        self._client.send(P.T_HELLO,
                          json.dumps({"dims": dims, "types": types}).encode())
        try:
            kind, payload = self._hello.get(timeout=self.props["timeout"])
        except _queue.Empty:
            self.fail_negotiation(
                f"query server {self.props['host']}:{self.props['port']} "
                f"did not answer the caps handshake within "
                f"{self.props['timeout']}s")
        if kind == P.T_HELLO_NAK:
            self.fail_negotiation(
                f"query server rejected our caps: {payload.decode()}")
        reply = json.loads(payload.decode())
        if not reply.get("dims"):
            self.fail_negotiation(
                "query server did not declare an output spec; start the "
                "server pipeline (serversrc+serversink) first")
        return [TensorsSpec.from_strings(reply["dims"], reply["types"],
                                         rate=spec.rate)]

    def _on_message(self, mtype: int, payload: bytes) -> None:
        if mtype in (P.T_HELLO_ACK, P.T_HELLO_NAK):
            self._hello.put((mtype, payload))
        elif mtype == P.T_RESULT:
            self._replies.put(("r", payload))
        elif mtype == P.T_BUSY:
            self._replies.put(("b", payload))

    def _note_busy(self, payload: bytes) -> None:
        """Consume one BUSY: the rejected frame leaves the in-flight
        window (it may not be the oldest — rejections are answered at
        admission, results only after service) and the rejection is
        stashed for the next deferred raise."""
        try:
            info = json.loads(payload.decode())
        except ValueError:
            info = {}
        pts = info.get("pts")
        removed = False
        if pts is not None:
            for i, (p, _) in enumerate(self._pending):
                if p == pts:
                    del self._pending[i]
                    removed = True
                    break
        if not removed and self._pending:
            self._pending.popleft()
        self._busy += 1
        self._last_busy = info
        self._busy_stash.append(info)

    def _raise_stashed(self) -> None:
        if not self._busy_stash:
            return
        info = self._busy_stash.popleft()
        cause = info.get("cause", "queue_full")
        depth = int(info.get("queue_depth", 0))
        retry_ms = float(info.get("retry_after_ms", 0.0))
        raise ServerBusyError(
            f"tensor_query_client {self.name}: server rejected frame "
            f"pts={info.get('pts')} at admission ({cause}; queue depth "
            f"{depth}, suggested retry after ~{retry_ms:.0f}ms). Set "
            f"error_policy=retry:N:backoff_ms | degrade | skip on this "
            f"element to absorb overload instead of failing",
            queue_depth=depth, retry_after_ms=retry_ms, cause=cause,
            pts=info.get("pts"))

    def _take_reply(self) -> Optional[Emission]:
        """Pop the oldest in-flight frame's reply (blocking, timeout).
        Returns None when the message was a BUSY rejection — the window
        shrank but nothing is emitted."""
        try:
            item = self._replies.get(timeout=self.props["timeout"])
        except _queue.Empty:
            raise StreamError(
                f"tensor_query_client {self.name}: no reply for frame "
                f"pts={self._pending[0][0]} within "
                f"{self.props['timeout']}s (server overloaded or "
                f"connection lost)") from None
        if item is _STOPPED:
            raise StreamError(
                f"tensor_query_client {self.name}: stopped with "
                f"{len(self._pending)} frame(s) still in flight")
        kind, payload = item
        if kind == "b":
            self._note_busy(payload)
            return None
        pts, t_send = self._pending.popleft()
        out, _ = decode_buffer(payload)
        out.meta.pop("client_id", None)
        stamp_hop(out.meta, "client_recv")
        if self._tracer.active:
            ctx = get_trace_ctx(out.meta)
            if ctx is not None:
                # client-side end of the timeline: includes the wire
                # round trip the server-side record cannot see
                self._tracer.record_request(
                    self.name, ctx["id"], ctx["hops"],
                    time.perf_counter(), pts=pts)
        # integrity check for the pipelined window: the reply echoes the
        # request's pts on the wire, so a server-side frame drop cannot
        # silently shift every later reply onto the wrong frame
        if out.pts is not None and pts is not None and out.pts != pts:
            raise StreamError(
                f"tensor_query_client {self.name}: reply stream out of "
                f"sync — expected pts={pts}, server answered pts="
                f"{out.pts}. A frame was dropped server-side; lower "
                f"max_in_flight or fix the server pipeline")
        self._replied += 1
        self._rtt.append(time.perf_counter() - t_send)
        return (0, out.with_tensors(out.tensors, pts=pts))

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        # a rejection consumed on a previous call raises BEFORE this
        # frame is sent: under retry the re-invoked process() sends it
        # exactly once, so no frame is ever duplicated on the wire
        self._raise_stashed()
        if self._tracer.active:
            # get-or-create: a BUSY retry re-invokes process() with the
            # SAME buffer, so the existing context (and its id) is kept
            # and this send appends a second client_send hop — the
            # retry-reuses-id invariant the regression tests pin
            ensure_trace_ctx(buf.meta)
        stamp_hop(buf.meta, "client_send", pts=buf.pts)
        self._client.send(P.T_DATA,
                          encode_buffer(buf, 0, self._tracer, self.name))
        self._pending.append((buf.pts, time.perf_counter()))
        self._sent += 1
        emissions: List[Emission] = []
        # opportunistically drain replies that already arrived, then
        # block only when the in-flight window is full (a consumed BUSY
        # shrinks the window without emitting)
        while self._pending:
            if not self._replies.empty():
                em = self._take_reply()
            elif len(self._pending) >= self.props["max_in_flight"]:
                em = self._take_reply()
            else:
                break
            if em is not None:
                emissions.append(em)
        if self._busy_stash and not emissions:
            # nothing collected, safe to raise now: with max_in_flight=1
            # this is the just-sent frame's own rejection, and the retry
            # policy re-offers it with backoff — exact retry semantics
            self._raise_stashed()
        return emissions

    def flush(self) -> List[Emission]:
        """EOS: drain every in-flight frame so nothing is dropped.
        Rejections during the drain are counted, not raised — EOS must
        deliver what CAN be delivered."""
        emissions: List[Emission] = []
        while self._pending:
            em = self._take_reply()
            if em is not None:
                emissions.append(em)
        self._busy_stash.clear()
        return emissions

    def extra_stats(self) -> Dict:
        """Client-side goodput/rejection view of the offload."""
        out = {
            "query_sent": self._sent,
            "query_replied": self._replied,
            "query_busy": self._busy,
            "query_goodput": round(self._replied / self._sent, 4)
            if self._sent else 1.0,
        }
        if self._rtt:
            vals = sorted(v * 1e3 for v in self._rtt)
            out["query_rtt_p50_ms"] = round(percentile(vals, 50), 3)
            out["query_rtt_p95_ms"] = round(percentile(vals, 95), 3)
        if self._last_busy is not None:
            out["query_retry_after_ms"] = float(
                self._last_busy.get("retry_after_ms", 0.0))
        return out

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
        # unblock a thread parked in _take_reply: teardown must not wait
        # out the full reply timeout for frames that will never answer
        self._replies.put(_STOPPED)


class BatchedQueryServer:
    """Offload serving with batch coalescing — `MeshDispatcher`
    (parallel/dispatch.py) wired into the query transport.

    The element pipeline form (serversrc ! filter ! serversink) processes
    one frame per pass; this server instead feeds every arriving client
    frame straight into the dispatcher, which packs frames from ALL
    connected clients into dp-sharded batches (padded to a bucket of
    ``{dp, bucket}``) and resolves each client's reply from its row of
    the batch. Wire format, HELLO caps handshake and per-client result
    routing are those of the pipeline form, so unmodified
    tensor_query_client pipelines work against it.

    model: a ModelBundle, "zoo://name" or a model file path, resolved
    through the torch backend. pre: an optional per-batch step on the
    batch before the model — e.g. the normalize_u8 kernel
    (backends/kernels.normalize_u8) on uint8 frames: it runs on each
    shard's rows on that shard's device, one launch a shard batch (JAX
    traces it into the sharded program; there is no XLA program here).
    mesh: a parallel.mesh.Mesh whose ``dp`` axis shards the batch; by
    default, as JAX's, dp is the number of logical devices
    (`serving/placement.visible_devices`, or the one device an explicit
    `accelerator` names) if it divides `bucket`, else 1 — on one card
    with no logical devices, one shard on the card.

    One drain thread feeds the dispatcher so each client's frames enter
    batches in arrival order — the client contract is ordered replies
    (TensorQueryClient enforces the pts sequence). A frame whose
    dispatch fails is answered with a typed BUSY(dispatch_error) — never
    silence — and the failure is kept on `.error` for supervisors.
    Admission knobs (max_pending / max_inflight / shed_policy) mirror
    tensor_query_serversrc's.
    """

    def __init__(self, model, *, sid: int = 0, host: str = "127.0.0.1",
                 port: int = 0, mesh=None, bucket: int = 8,
                 max_delay_ms: float = 2.0, pre=None,
                 in_spec: Optional[TensorsSpec] = None,
                 max_pending: int = 64, max_inflight: int = 0,
                 shed_policy: str = "reject-newest",
                 accelerator: str = ""):
        from nnstreamer_tpu_torch.backends.base import pick_device
        from nnstreamer_tpu_torch.backends.torch_backend import (
            TorchBackend, to_tuple)
        from nnstreamer_tpu_torch.parallel.dispatch import MeshDispatcher
        from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from nnstreamer_tpu_torch.serving.placement import visible_devices

        bundle = TorchBackend()._resolve(model)
        if mesh is None:
            devs = [pick_device(accelerator)] if accelerator \
                else visible_devices()
            dp = len(devs) if bucket % len(devs) == 0 else 1
            mesh = make_mesh(MeshSpec(dp=dp), devs[:dp])
        model_fn = bundle.fn

        def fn(p, x):
            if pre is not None:
                x = pre(x)
            return to_tuple(model_fn(p, x))

        self.dispatcher = MeshDispatcher(fn, bundle.params, mesh,
                                         bucket=bucket,
                                         max_delay_ms=max_delay_ms)
        # the dispatcher hands back per-frame rows (batch dim stripped);
        # the wire contract is the model's out_spec — restore a leading
        # batch=1 dim where the spec declares one
        self._lead1 = [t.shape and t.shape[0] == 1
                       for t in bundle.out_spec.tensors] \
            if bundle.out_spec else []
        self.qs = QueryServer.get(sid)
        # in_spec override: when `pre` changes the wire dtype (uint8
        # camera frames normalized on the card), the HELLO contract is
        # the PRE-transform spec, not the model's
        self.qs.in_spec = in_spec if in_spec is not None \
            else bundle.in_spec
        self.qs.out_spec = bundle.out_spec
        self.qs.frames.configure(max_pending=max_pending,
                                 max_inflight=max_inflight,
                                 shed_policy=shed_policy)
        self.qs.start(host, port)
        self._stop = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self.error: Optional[Exception] = None
        # exactly ONE drainer: a second thread could swap the order of a
        # client's consecutive frames between queue-get and submit,
        # desyncing its ordered reply stream
        self._drainers = [
            threading.Thread(target=self._drain, name="batched-query",
                             daemon=True)
        ]
        for t in self._drainers:
            t.start()

    @property
    def port(self) -> int:
        return self.qs.server.port

    def _drain(self) -> None:
        while not self._stop.is_set():
            try:
                buf = self.qs.frames.get(timeout=0.1)
            except _queue.Empty:
                continue
            cid = buf.meta.get("client_id", 0)
            pts = buf.pts
            try:
                fut = self.dispatcher.submit(buf.tensors[0])
            except StreamError as e:
                log.warning("batched query: submit failed: %s", e)
                # the frame was admitted but will never be answered:
                # account it as shed and tell the client now, instead
                # of letting its per-frame timeout expire blind
                self.qs.frames.note_failed("dispatch_error")
                self.qs.send_busy(cid, pts, "dispatch_error")
                continue

            def done(f, cid=cid, pts=pts):
                try:
                    outs = f.result()
                except Exception as e:
                    log.warning("batched query: dispatch failed for "
                                "client %d: %s", cid, e)
                    self.error = e
                    self.qs.frames.note_failed("dispatch_error")
                    self.qs.send_busy(cid, pts, "dispatch_error")
                    return
                outs = tuple(
                    o[None] if i < len(self._lead1) and self._lead1[i]
                    else o
                    for i, o in enumerate(outs))
                self.qs.reply(cid, TensorBuffer.of(*outs, pts=pts))

            fut.add_done_callback(done)

    def stats(self) -> Dict[str, int]:
        """Consistent snapshot: dispatcher counters are read under the
        dispatcher's lock (they are mutated from its completion thread)
        and admission counters under the admission queue's — callers
        never see a torn frames/batches pair mid-increment."""
        out = dict(self.dispatcher.stats())
        adm = self.qs.frames.counters()
        out.update({
            "admitted": adm["admitted"],
            "replied": adm["replied"],
            "rejected": sum(adm["rejected"].values()),
            "shed": sum(adm["shed"].values()),
            "admission_depth_peak": adm["depth_peak"],
        })
        return out

    def close(self) -> None:
        """Orderly teardown, strongest guarantee first: no request that
        a client is still waiting on may end up silently dropped.

        1. stop + JOIN the drain thread (a frame dequeued concurrently
           is still submitted — the dispatcher is not down yet);
        2. shed everything still queued with a typed BUSY(shutdown);
        3. shut the dispatcher down — it drains submitted batches (the
           done callbacks still reply: the transport is up) and fails
           any never-dispatched future with a typed StreamError;
        4. drop the transport.

        Idempotent: a supervisor drain racing a user close() is a
        no-op, not a double-join/double-shed.
        """
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        for t in self._drainers:
            t.join(timeout=5)
            if t.is_alive():
                log.warning(
                    "query server: drainer thread %s still alive after "
                    "5s join at close — wedged consumer leaked", t.name)
        for v in self.qs.frames.shed_remaining("shutdown"):
            if v is not None:
                self.qs.send_busy(v.meta.get("client_id"), v.pts,
                                  "shutdown")
        self.dispatcher.shutdown()
        self.qs.stop()
