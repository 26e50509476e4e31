"""Condition-variable MPSC channel — the link between element threads.

``put`` wakes the consumer the instant a buffer lands, ``get`` wakes a
blocked producer the instant a slot frees, and ``close()`` wakes every
waiter on both sides, so teardown cannot lose a wakeup. ``get`` can be
bounded by a deadline, so a timer element's worker sleeps until its next
deadline or the next buffer, whichever comes first.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Tuple


class _Sentinel:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self):
        return self._name


#: ``get()`` result when the channel was closed (teardown) and empty
CLOSED = _Sentinel("CLOSED")
#: ``get(deadline)`` result when the deadline passed with no item
TIMED_OUT = _Sentinel("TIMED_OUT")


class Channel:
    """Bounded multi-producer / single-consumer channel.

    - ``put(item)`` blocks while full; returns the post-append depth, or
      ``None`` when the channel closed first (item not delivered).
    - ``get(deadline=None)`` blocks until an item is available →
      ``(item, depth)``; ``(CLOSED, 0)`` once the channel is closed and
      drained; ``(TIMED_OUT, 0)`` when the ``time.perf_counter()``
      deadline passes first.
    - ``get_nowait()`` never blocks (the compiled loop's sweep).
    """

    __slots__ = ("_buf", "_cap", "_closed", "_lock", "_not_empty",
                 "_not_full")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"channel capacity must be >= 1, got {capacity}")
        self._buf: deque = deque()
        self._cap = capacity
        self._closed = False
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def put(self, item: Any) -> Optional[int]:
        with self._not_full:
            while len(self._buf) >= self._cap and not self._closed:
                self._not_full.wait()
            if self._closed:
                return None
            self._buf.append(item)
            self._not_empty.notify()
            return len(self._buf)

    def get(self, deadline: Optional[float] = None) -> Tuple[Any, int]:
        with self._not_empty:
            while not self._buf:
                if self._closed:
                    return CLOSED, 0
                if deadline is None:
                    self._not_empty.wait()
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0.0:
                    return TIMED_OUT, 0
                self._not_empty.wait(remaining)
            item = self._buf.popleft()
            self._not_full.notify()
            return item, len(self._buf)

    def get_nowait(self) -> Tuple[Any, int]:
        """Non-blocking get for a compiled window's sweep: ``(item,
        depth)`` when an item is buffered, ``(CLOSED, 0)`` when closed and
        drained, ``(TIMED_OUT, 0)`` when merely empty. Never sleeps, so a
        slow producer never stalls the window boundary."""
        with self._not_empty:
            if not self._buf:
                return (CLOSED, 0) if self._closed else (TIMED_OUT, 0)
            item = self._buf.popleft()
            self._not_full.notify()
            return item, len(self._buf)

    def full(self) -> bool:
        """At capacity right now (the watchdog's queue-stall probe)."""
        with self._lock:
            return len(self._buf) >= self._cap

    def close(self) -> None:
        """Refuse further puts and wake every waiter."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
