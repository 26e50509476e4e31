"""Length-prefixed TCP message transport (the JAX package's
edge/protocol.py; the port keeps its own copy, so a port peer and a JAX
peer speak one protocol).

Reference parity: the nnstreamer-edge connection layer (SURVEY.md §5.8) —
connection handle + event callback, caps-compat handshake at connect,
clean reconnect/close semantics. One transport (TCP) replaces the
reference's TCP/HYBRID/AITT/MQTT zoo; the message framing is:

  u32 type | u32 length | length bytes payload

Types: HELLO (caps string), HELLO_ACK (caps string or error), DATA
(wire frame, edge/wire.py), RESULT (wire frame), BYE, PING/PONG,
BUSY (admission rejection, JSON).

Threading model: a `MsgServer` runs an accept loop + one reader thread
per connection, dispatching to a callback; `MsgClient` owns one socket
with a reader thread. All sends are serialized per connection (lock) so
frames never interleave.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("edge.protocol")

_FRAME = struct.Struct("<II")

T_HELLO = 1
T_HELLO_ACK = 2
T_HELLO_NAK = 3
T_DATA = 4
T_RESULT = 5
T_BYE = 6
T_PING = 7
T_PONG = 8
# admission rejection: the server refused a DATA frame (bounded queue
# full / outstanding bound hit / deadline passed). Payload is JSON
# {"pts", "cause", "queue_depth", "retry_after_ms"} — enough for the
# client to back off instead of timing out blind (traffic/admission.py)
T_BUSY = 9
# mesh control plane (serving/mesh.py). REGISTER: a worker host joins
# the router, JSON ad {"name", "capacity_rps", "dims", "types",
# "out_dims", "out_types", "versions", "zone", "lease_s"}. LEASE:
# heartbeat renewal, JSON {"name", "counters"} — the router fences a
# host whose lease expires (silent-host detection, not just conn EOF).
# SWAP/SWAP_ACK: two-phase version swap broadcast, JSON
# {"phase": "prepare"|"commit"|"abort", "model", "version", "epoch"}.
T_REGISTER = 10
T_REGISTER_ACK = 11
T_LEASE = 12
T_SWAP = 13
T_SWAP_ACK = 14

#: hard cap on a single message (matches wire.MAX_FRAME_BYTES intent)
MAX_MSG = 1 << 31

#: default outbound connect timeout. The OS default (no timeout on the
#: connect() syscall) is ~2 minutes of SYN retries — a blackholed peer
#: would wedge the dialing thread for that long. A few seconds fails
#: fast into the caller's retry path instead (docs/robustness.md).
DEFAULT_CONNECT_TIMEOUT_S = 5.0


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            b = sock.recv(min(n, 1 << 20))
        except OSError:
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def read_msg(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    head = _recv_exact(sock, _FRAME.size)
    if head is None:
        return None
    mtype, length = _FRAME.unpack(head)
    if length > MAX_MSG:
        raise StreamError(f"edge message of {length} bytes exceeds limit")
    payload = _recv_exact(sock, length) if length else b""
    if payload is None:
        return None
    return mtype, payload


def write_msg(sock: socket.socket, mtype: int, payload: bytes = b"",
              lock: Optional[threading.Lock] = None) -> None:
    data = _FRAME.pack(mtype, len(payload)) + payload
    if lock:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


class Connection:
    """One accepted server-side connection."""

    _next_id = 1
    _id_lock = threading.Lock()

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        # Nagle holds every small write after the first until the peer
        # ACKs — with delayed ACKs that serializes a pipelined client's
        # window to one frame per reply, defeating max_in_flight>1
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.send_lock = threading.Lock()
        with Connection._id_lock:
            self.client_id = Connection._next_id
            Connection._next_id += 1

    def send(self, mtype: int, payload: bytes = b"",
             timeout: Optional[float] = None) -> None:
        """With `timeout`, a stalled peer (full kernel send buffer)
        raises OSError instead of blocking the caller forever — servers
        replying from shared worker threads must bound their sends.

        The bound uses select-for-writability + partial send()s rather
        than socket timeouts: settimeout() would mutate state shared
        with this connection's reader thread. NOTE: a timeout may leave
        a PARTIAL frame on the wire — the stream is unrecoverable and
        the caller must close the connection.
        """
        if timeout is None:
            write_msg(self.sock, mtype, payload, self.send_lock)
            return
        import select

        data = memoryview(_FRAME.pack(mtype, len(payload)) + payload)
        deadline = time.monotonic() + timeout
        with self.send_lock:
            while data:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise OSError(f"send timed out after {timeout}s "
                                  f"({len(data)} bytes unsent)")
                try:
                    _, writable, _ = select.select([], [self.sock], [],
                                                   remain)
                except ValueError as e:
                    # fd == -1: the socket was closed concurrently —
                    # callers handle OSError, keep that contract
                    raise OSError(f"socket closed during send: {e}") \
                        from None
                if not writable:
                    continue
                # writable ⇒ send() accepts ≥1 byte and returns without
                # waiting for the full buffer
                data = data[self.sock.send(data):]

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class MsgServer:
    """Accept loop + per-connection reader threads.

    on_message(conn, mtype, payload); on_connect(conn) -> bool (False
    rejects); on_disconnect(conn).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 on_message: Callable,
                 on_connect: Optional[Callable] = None,
                 on_disconnect: Optional[Callable] = None):
        self._on_message = on_message
        self._on_connect = on_connect
        self._on_disconnect = on_disconnect
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self.host = host
        self._conns: Dict[int, Connection] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"edge-accept:{self.port}",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            conn = Connection(sock, addr)
            if self._on_connect is not None and not self._on_connect(conn):
                conn.close()
                continue
            with self._lock:
                self._conns[conn.client_id] = conn
            threading.Thread(target=self._read_loop, args=(conn,),
                             name=f"edge-read:{conn.client_id}",
                             daemon=True).start()

    def _read_loop(self, conn: Connection) -> None:
        try:
            while not self._stopping.is_set():
                msg = read_msg(conn.sock)
                if msg is None or msg[0] == T_BYE:
                    break
                if msg[0] == T_PING:
                    conn.send(T_PONG)
                    continue
                self._on_message(conn, msg[0], msg[1])
        except StreamError as e:
            log.error("connection %d protocol error: %s", conn.client_id, e)
        finally:
            with self._lock:
                self._conns.pop(conn.client_id, None)
            if self._on_disconnect is not None:
                self._on_disconnect(conn)
            conn.close()

    def connection(self, client_id: int) -> Optional[Connection]:
        with self._lock:
            return self._conns.get(client_id)

    def connections(self):
        with self._lock:
            return list(self._conns.values())

    def close(self) -> None:
        self._stopping.set()
        # shutdown() first: close() alone does not wake a thread
        # blocked in accept() on Linux.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for c in self.connections():
            c.close()


class MsgClient:
    """Client connection with a reader thread + reconnect.

    on_message(mtype, payload) runs on the reader thread.
    """

    def __init__(self, host: str, port: int, *, on_message: Callable,
                 on_close: Optional[Callable] = None,
                 connect_timeout: Optional[float] = None, retries: int = 3):
        if connect_timeout is None:
            connect_timeout = DEFAULT_CONNECT_TIMEOUT_S
        self.host, self.port = host, port
        self._on_message = on_message
        self._on_close = on_close
        self.send_lock = threading.Lock()
        self._stopping = threading.Event()
        self.sock: Optional[socket.socket] = None
        last = None
        for attempt in range(retries):
            try:
                self.sock = socket.create_connection(
                    (host, port), timeout=connect_timeout)
                break
            except OSError as e:
                last = e
                time.sleep(0.2 * (attempt + 1))
        if self.sock is None:
            raise StreamError(
                f"cannot connect to edge peer {host}:{port} after "
                f"{retries} attempts: {last}")
        self.sock.settimeout(None)
        # see Connection.__init__: Nagle + delayed ACK would serialize
        # a pipelined offload window to one frame per reply
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"edge-client:{port}",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while not self._stopping.is_set():
                msg = read_msg(self.sock)
                if msg is None or msg[0] == T_BYE:
                    break
                if msg[0] == T_PING:
                    self.send(T_PONG)
                    continue
                self._on_message(msg[0], msg[1])
        except StreamError as e:
            log.error("client protocol error: %s", e)
        finally:
            self._stopping.set()
            if self._on_close is not None:
                self._on_close()

    @property
    def alive(self) -> bool:
        return not self._stopping.is_set()

    def send(self, mtype: int, payload: bytes = b"") -> None:
        if self._stopping.is_set():
            raise StreamError(
                f"edge connection to {self.host}:{self.port} is closed")
        try:
            write_msg(self.sock, mtype, payload, self.send_lock)
        except OSError as e:
            self._stopping.set()
            raise StreamError(
                f"edge send to {self.host}:{self.port} failed: {e}") from e

    def close(self) -> None:
        if not self._stopping.is_set():
            try:
                self.send(T_BYE)
            except StreamError:
                pass
        self._stopping.set()
        try:
            self.sock.close()
        except OSError:
            pass
