"""The port's network chaos proxy (nnstreamer_tpu_torch/traffic/netchaos.py)
against the JAX package's, on the CPU: JAX `tests/test_mesh.py`'s
`TestNetChaos` cases on the port's proxy, and the fault schedule of one
seed predicted from its RNG streams — the port's proxy and JAX's, in front
of the same port echo server, drop, duplicate and count the same messages
for the same seed and message sequence.

Every wait is a deadline loop on a counter or an event, never a sleep
followed by an assert; no assertion reads the wall clock.
"""

import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.traffic.netchaos import ChaosProxy as JaxProxy
from nnstreamer_tpu_torch.edge import QueryServer
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.wire import encode_buffer, peek_pts
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.traffic import ChaosProxy, EchoServer

HELLO = b'{"dims": "8:1", "types": "float32"}'


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    QueryServer.reset_all()


def _until(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _schedule(seed, n, drop_p=0.0, dup_p=0.0):
    """The proxy's decisions for one client that sends HELLO then n DATA
    frames to an in-order echo, drawn from its (seed, connection 0,
    direction) streams: → (replied pts, expected stats)."""
    def stream(dirn, count):
        rng = random.Random(f"{seed}:0:{dirn}")
        out = []
        for k in range(count):
            r_drop, r_dup, _ = rng.random(), rng.random(), rng.random()
            spared = k == 0               # HELLO / HELLO_ACK
            drop = not spared and r_drop < drop_p
            out.append((drop, not spared and not drop and r_dup < dup_p))
        return out

    up = stream("c2u", 1 + n)
    sent = [i for i in range(n) for _ in range(1 + up[1 + i][1])
            if not up[1 + i][0]]          # what reaches the echo, in order
    down = stream("u2c", 1 + len(sent))
    got = {pts for pts, (drop, _) in zip(sent, down[1:]) if not drop}
    both = up + down
    stats = {"forwarded": sum(not d for d, _ in both),
             "dropped": sum(d for d, _ in both),
             "duplicated": sum(u for _, u in both),
             "delayed": 0, "discarded": 0, "conns": 1, "blackholed": 0}
    return got, stats


def _proxy_echo_run(proxy_cls, n=30, **faults):
    """Send n frames through proxy → echo; wait (deadline loop) until the
    proxy has settled every message the schedule predicts; return (proxy
    stats, replied pts set, predicted (pts set, stats))."""
    import queue as _q

    want_got, want = _schedule(faults.get("seed", 0), n,
                               faults.get("drop_p", 0.0),
                               faults.get("dup_p", 0.0))
    if faults.get("delay_ms"):
        want["delayed"] = want["forwarded"] + want["dropped"]
    echo = EchoServer(service_ms=1.0, max_pending=64)
    proxy = proxy_cls("127.0.0.1", echo.port, **faults)
    got = set()
    hello = _q.Queue()

    def on_msg(mtype, payload):
        if mtype == P.T_RESULT:
            got.add(peek_pts(payload))
        elif mtype == P.T_HELLO_ACK:
            hello.put(True)

    cli = P.MsgClient("127.0.0.1", proxy.port, on_message=on_msg)
    try:
        cli.send(P.T_HELLO, HELLO)
        hello.get(timeout=10)
        x = np.zeros((8, 1), np.float32)
        for i in range(n):
            cli.send(P.T_DATA, encode_buffer(TensorBuffer.of(x, pts=i)))
        settled = want["forwarded"] + want["dropped"]
        _until(lambda: proxy.stats()["forwarded"]
               + proxy.stats()["dropped"] >= settled
               and len(got) >= len(want_got))
        return proxy.stats(), set(got), (want_got, want)
    finally:
        cli.close()
        proxy.close()
        echo.stop()


class TestNetChaos:
    def test_same_seed_same_fault_schedule(self):
        s1, got1, (want_got, want) = _proxy_echo_run(ChaosProxy, seed=11,
                                                     drop_p=0.3)
        s2, got2, _ = _proxy_echo_run(ChaosProxy, seed=11, drop_p=0.3)
        assert s1 == s2 == want and want["dropped"] > 0
        assert got1 == got2 == want_got, \
            "per-frame outcomes must reproduce"
        s3, got3, (want_got3, want3) = _proxy_echo_run(
            ChaosProxy, seed=12, drop_p=0.3)
        assert (s3, got3) == (want3, want_got3)
        assert (want3, want_got3) != (want, want_got)

    @pytest.mark.parametrize("faults", [
        dict(seed=11, drop_p=0.3), dict(seed=5, dup_p=0.4),
        dict(seed=2, drop_p=0.2, dup_p=0.3)])
    def test_port_and_jax_proxies_give_one_schedule(self, faults):
        s_port, got_port, (want_got, want) = _proxy_echo_run(
            ChaosProxy, n=24, **faults)
        s_jax, got_jax, _ = _proxy_echo_run(JaxProxy, n=24, **faults)
        assert s_port == s_jax == want
        assert got_port == got_jax == want_got

    def test_duplicates_are_injected_not_corrupted(self):
        # dup_p=1: every unspared message is sent twice. The echo
        # server answers each copy — message-level duplication must
        # never corrupt framing, so ALL replies decode.
        s, got, (_, want) = _proxy_echo_run(ChaosProxy, n=10, seed=0,
                                            dup_p=1.0)
        assert s == want and s["duplicated"] == 30
        assert got == set(range(10))

    def test_delay_shifts_latency_not_outcomes(self):
        s, got, (_, want) = _proxy_echo_run(ChaosProxy, n=8, seed=0,
                                            delay_ms=30.0)
        assert got == set(range(8))
        assert s == want and s["delayed"] == 18   # both ways, HELLO too

    def test_blackhole_discards_and_withholds_fin(self):
        echo = EchoServer(service_ms=1.0)
        proxy = ChaosProxy("127.0.0.1", echo.port, seed=0)
        closed, acked = threading.Event(), threading.Event()
        cli = P.MsgClient(
            "127.0.0.1", proxy.port,
            on_message=lambda t, p: acked.set() if t == P.T_HELLO_ACK
            else None, on_close=closed.set)
        try:
            cli.send(P.T_HELLO, HELLO)
            assert acked.wait(10)
            proxy.blackhole()
            assert proxy.stats()["blackholed"] == 1
            cli.send(P.T_HELLO, b"{}")
            assert _until(lambda: proxy.stats()["discarded"] >= 1)
            # a partition is silence, not a clean close: the peer must
            # NOT learn anything (that is what the lease is for)
            assert not closed.is_set()
            proxy.heal()
            assert closed.wait(5), "heal must close severed routes"
            assert proxy.stats()["blackholed"] == 0
        finally:
            cli.close()
            proxy.close()
            echo.stop()

    def test_slow_close_wedges_then_closes(self):
        echo = EchoServer(service_ms=1.0)
        proxy = ChaosProxy("127.0.0.1", echo.port, seed=0)
        closed, acked = threading.Event(), threading.Event()
        cli = P.MsgClient(
            "127.0.0.1", proxy.port,
            on_message=lambda t, p: acked.set() if t == P.T_HELLO_ACK
            else None, on_close=closed.set)
        try:
            cli.send(P.T_HELLO, HELLO)
            assert acked.wait(10)
            proxy.slow_close(linger_s=0.3)
            assert proxy._frozen.is_set()       # draining stopped
            assert closed.wait(10), "slow_close never closed"
            assert _until(lambda: not proxy._frozen.is_set())
        finally:
            cli.close()
            proxy.close()
            echo.stop()


class TestProgram:
    def test_program_applies_switches_in_order(self):
        echo = EchoServer(service_ms=1.0)
        proxy = ChaosProxy("127.0.0.1", echo.port, seed=0)
        try:
            proxy.program([(0.05, "heal"), (0.0, "blackhole")])
            assert proxy.wait_program(10)
            assert [r["op"] for r in proxy.program_log] == \
                ["blackhole", "heal"]
            assert proxy.applied("blackhole") <= proxy.applied("heal")
            assert proxy.applied("slow_close") is None
            assert not proxy.blackholed
        finally:
            proxy.close()
            echo.stop()

    def test_cancel_keeps_applied_switches_only(self):
        echo = EchoServer(service_ms=1.0)
        proxy = ChaosProxy("127.0.0.1", echo.port, seed=0)
        try:
            proxy.program([(0.0, "blackhole"), (600.0, "heal")])
            assert _until(lambda: proxy.applied("blackhole") is not None)
            proxy.cancel_program()
            assert proxy.wait_program(0.0)
            assert [r["op"] for r in proxy.program_log] == ["blackhole"]
            assert proxy.blackholed
        finally:
            proxy.close()
            echo.stop()

    @pytest.mark.parametrize("events", [
        [(0.0, "explode")], [(-1.0, "heal")], [(0.0,)]])
    def test_bad_program_refused(self, events):
        proxy = ChaosProxy("127.0.0.1", 1, seed=0)
        try:
            with pytest.raises(ValueError):
                proxy.program(events)
        finally:
            proxy.close()


def test_close_while_peers_dial_joins_every_route():
    """N30, the proxy's half: a route's pump threads are started before
    the route is published, and no route opens once close() began — a
    peer dialing during close() never leaves a thread close() cannot
    join (the reference raised "cannot join thread before it is
    started" here)."""
    echo = EchoServer(service_ms=1.0)
    try:
        for _ in range(5):
            proxy = ChaosProxy("127.0.0.1", echo.port, seed=0)
            stop = threading.Event()

            def dial(port=proxy.port):
                while not stop.is_set():
                    try:
                        socket.create_connection(("127.0.0.1", port),
                                                 timeout=0.2).close()
                    except OSError:
                        return

            dialers = [threading.Thread(target=dial) for _ in range(4)]
            for t in dialers:
                t.start()
            assert _until(lambda: proxy.stats()["conns"] >= 8)
            proxy.close()
            stop.set()
            for t in dialers:
                t.join(10)
            conns = proxy.stats()["conns"]
            assert not any(t.is_alive() for r in proxy._routes
                           for t in r.threads)
            assert proxy.stats()["conns"] == conns
    finally:
        echo.stop()
