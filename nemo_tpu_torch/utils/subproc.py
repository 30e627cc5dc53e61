"""Subprocess-service plumbing: a free-port probe and the listen gate.

A copy of the JAX package's ``utils/subproc.py``.  A harness that boots a
sidecar process needs a port and must see the listening socket BEFORE it
creates a channel: a grpc channel whose first connect races the server's
bind can spin UNAVAILABLE against a healthy server.  ``free_port`` never
repeats a port it issued recently in this process, and
:class:`PortReservation` binds and holds a batch of ports, releasing each
just before the server that will own it boots, so that concurrent boots
are never handed the same port.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque

#: Ports handed out recently by THIS process (free_port and
#: PortReservation both record here) — bounded, oldest forgotten first.
_ISSUED_MAX = 256
_issued: deque[int] = deque()
_issued_set: set[int] = set()
_issued_lock = threading.Lock()


def _remember_locked(port: int) -> None:
    _issued.append(port)
    _issued_set.add(port)
    while len(_issued) > _ISSUED_MAX:
        _issued_set.discard(_issued.popleft())


def free_port() -> int:
    """An OS-assigned currently-free TCP port (the usual bind-to-0 probe),
    guaranteed distinct from any port this process was handed recently —
    the multi-sidecar boot race fix: two concurrent boots each probing
    can no longer receive the same port from this process.  The residual
    TOCTOU window against OTHER processes' binds is accepted (use
    :class:`PortReservation` to shrink it for batch boots)."""
    port = 0
    for _ in range(128):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with _issued_lock:
            if port not in _issued_set:
                _remember_locked(port)
                return port
    # The OS kept re-issuing recently-seen ports (tiny ephemeral range);
    # hand out the last probe rather than spinning forever.
    return port


class PortReservation:
    """Bind-and-hold N distinct ports for a fleet boot.

    Every port stays BOUND (so no other bind-to-0 probe — in this process
    or any other — can be handed it) until :meth:`release` frees it
    immediately before the server that will own it executes.  Use as a
    context manager so an aborted boot never leaks the held sockets::

        with PortReservation(3) as ports:
            for i, port in enumerate(ports.ports):
                ports.release(i)
                boot_server(port)
    """

    def __init__(self, n: int) -> None:
        self._socks: list[socket.socket | None] = []
        try:
            for _ in range(n):
                s = socket.socket()
                # TIME_WAIT tolerance for the holder itself; the eventual
                # server's own bind happens after release() closes this.
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", 0))
                self._socks.append(s)
        except OSError:
            self.close()
            raise
        self.ports = [s.getsockname()[1] for s in self._socks]
        with _issued_lock:
            for p in self.ports:
                _remember_locked(p)

    def release(self, i: int) -> int:
        """Free reservation ``i``'s socket and return its port — call this
        immediately before booting the server that binds it."""
        s = self._socks[i]
        if s is not None:
            self._socks[i] = None
            s.close()
        return self.ports[i]

    def close(self) -> None:
        for i, s in enumerate(self._socks):
            if s is not None:
                self._socks[i] = None
                s.close()

    def __enter__(self) -> "PortReservation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def wait_listening(
    port: int,
    deadline_s: float = 120.0,
    proc=None,
    host: str = "127.0.0.1",
    poll_s: float = 0.5,
) -> None:
    """Block until (host, port) accepts a TCP connection.

    Raises RuntimeError when the deadline passes or ``proc`` (a Popen,
    optional) exits first — with the exit code, so a crashed server is
    distinguishable from a slow one."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            socket.create_connection((host, port), 2.0).close()
            return
        except OSError:
            rc = proc.poll() if proc is not None else None
            if time.monotonic() > deadline or rc is not None:
                raise RuntimeError(
                    f"server never listened on {host}:{port} "
                    f"(rc={rc}, waited {deadline_s:.0f}s)"
                ) from None
            time.sleep(poll_s)
