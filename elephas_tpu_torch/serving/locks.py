"""The engine's hand-off lock.

One :class:`HandoffLock` serializes everything that touches one engine's
serving state: its ``step()``, ``score()`` and ``load_weights()``, and the
callers above it (a gateway's handlers, a fleet replica's submit, probe and
a drain's export). A plain lock would let a driver that takes it again
right after each step keep those callers waiting until the queue drains;
this one lets every waiting caller in before the driver's next step.
"""

from __future__ import annotations

import threading

__all__ = ["HandoffLock"]


class HandoffLock:
    """A reentrant lock handed to waiting threads between a driver's steps.

    Callers and the driver enter it as a context manager; the driver calls
    :meth:`yield_to_waiters` before each step. Reentrant, so a caller that
    holds it may call an engine method that takes it again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: int | None = None
        self._depth = 0
        self._waiting = 0
        self._changed = threading.Condition(threading.Lock())

    def __enter__(self):
        me = threading.get_ident()
        if self._owner == me:
            self._depth += 1
            return self
        with self._changed:
            self._waiting += 1
        self._lock.acquire()
        self._owner, self._depth = me, 1
        with self._changed:
            self._waiting -= 1
            self._changed.notify_all()
        return self

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            self._lock.release()
        return False

    def yield_to_waiters(self, timeout: float = 1.0) -> None:
        """Wait (at most ``timeout`` seconds) until every thread waiting
        for the lock has taken it. A no-op in the thread that holds it:
        no waiter can get in before it lets go."""
        if self._owner == threading.get_ident():
            return
        with self._changed:
            if self._waiting:
                self._changed.wait_for(lambda: self._waiting == 0, timeout)
