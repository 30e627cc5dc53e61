"""Single-flight request coalescing keyed on content addresses.

A copy of the JAX package's ``serve/coalesce.py``.

Concurrent ``AnalyzeDir`` requests whose corpora have the same content
address — store segment fingerprints + statics + wire/ABI versions, the
exact tier-3 key ``analysis/delta.py:blob_cache_key`` mints for the result
cache — are the SAME computation, so only one should run: the first
arrival becomes the flight's **leader** and executes; every concurrent
duplicate attaches as a **subscriber** and receives the leader's
byte-identical serialized response.  This is what makes a thundering herd
of identical sessions (a dashboard refresh fan-out, a CI matrix over one
corpus) cost one ANALYSIS instead of N.  Scope: the dedup covers the
device dispatch + response serialization — each request still ingests its
directory first (the content key IS the store's segment fingerprints),
which on a warm corpus store is a milliseconds mmap; a fully cold herd
pays N parses (only the store populate is serialized, at its writer lock)
before the first key exists to coalesce on.

By default only IN-FLIGHT work coalesces: the moment a flight completes it
leaves the table, and a later identical request belongs to the result
cache (store/rcache.py), the durable dedup tier — keeping the two tiers'
counters and trailing-metadata statuses disjoint (a repeat is an
``rcache: hit``, never a phantom ``coalesce: hit``).
``NEMO_SERVE_COALESCE_LINGER_S`` (default 0) keeps completed flights
joinable for a window so near-concurrent stragglers — admitted a beat
after the leader finished, e.g. queued behind the in-flight cap with the
result cache off — still coalesce.  A lingering payload can never be
stale: the key is a pure content address, so the bytes are what a fresh
execution would produce.

The caller (service/server.py) counts ``serve.coalesce.leader`` /
``serve.coalesce.hit`` and releases its admission slot before waiting as a
subscriber — a subscriber consumes no execution capacity, only patience.
"""

from __future__ import annotations

import threading
import time

from nemo_tpu_torch import obs
from nemo_tpu_torch.serve.admission import _env_float

_log = obs.log.get_logger("nemo.serve")


def linger_seconds() -> float:
    return _env_float("NEMO_SERVE_COALESCE_LINGER_S", 0.0)


class Flight:
    """One in-flight (or lingering) keyed execution."""

    __slots__ = ("key", "event", "payload", "meta", "error", "done_at", "subscribers")

    def __init__(self, key: str) -> None:
        self.key = key
        self.event = threading.Event()
        self.payload: bytes | None = None
        self.meta: dict = {}
        self.error: BaseException | None = None
        self.done_at: float | None = None
        self.subscribers = 0

    #: Bound on one subscriber's wait for its leader (matches the client's
    #: default RPC deadline — a subscriber parked past the point every
    #: waiting client has given up is a leaked pool thread, not a service).
    WAIT_TIMEOUT_S = 300.0

    def wait_result(
        self, timeout: float | None = None, is_alive=None
    ) -> tuple[bytes, dict]:
        """Wait for the leader's payload.  ``is_alive`` (optional callable,
        e.g. a gRPC context's ``is_active``) is polled so a subscriber
        whose client disconnected frees its handler thread instead of
        parking it for the full window."""
        deadline = time.monotonic() + (self.WAIT_TIMEOUT_S if timeout is None else timeout)
        while not self.event.wait(0.5):
            if is_alive is not None and not is_alive():
                raise TimeoutError(
                    f"client went away waiting on coalesced flight {self.key[:12]}"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"coalesced flight {self.key[:12]} did not complete in time"
                )
        if self.error is not None:
            # Leader failures propagate to every subscriber: N identical
            # requests fail identically rather than N-1 retrying a
            # computation that just proved itself broken.
            raise self.error
        assert self.payload is not None
        return self.payload, dict(self.meta)


class SingleFlight:
    """Keyed single-flight table with a linger window for stragglers.

    Memory contract for the long-lived sidecar: completed flights hold a
    full serialized response, so the table is swept of expired entries on
    every join/complete AND hard-capped at :data:`MAX_LINGERING` completed
    flights (oldest-done evicted first; in-flight leaders are never
    evicted) — a burst of N distinct corpora followed by silence cannot
    pin N payloads forever."""

    #: Hard bound on COMPLETED flights retained for the linger window.
    MAX_LINGERING = 256

    def __init__(self, linger_s: float | None = None) -> None:
        self.linger_s = linger_seconds() if linger_s is None else float(linger_s)
        self._lock = threading.Lock()
        self._flights: dict[str, Flight] = {}

    def _sweep_locked(self, now: float) -> None:
        """Drop expired completed flights; cap the rest (caller holds the
        lock).  Subscribers already attached keep their Flight reference —
        eviction only forgets the key."""
        dead = [
            k
            for k, f in self._flights.items()
            if f.done_at is not None
            and (f.error is not None or now - f.done_at > self.linger_s)
        ]
        for k in dead:
            del self._flights[k]
        done = [f for f in self._flights.values() if f.done_at is not None]
        if len(done) > self.MAX_LINGERING:
            done.sort(key=lambda f: f.done_at)
            for f in done[: len(done) - self.MAX_LINGERING]:
                if self._flights.get(f.key) is f:
                    del self._flights[f.key]

    def join(self, key: str) -> tuple[str, Flight]:
        """("leader", fresh flight) for the first arrival, ("hit", flight)
        for a duplicate of an in-flight or lingering one.  A leader MUST
        call :meth:`complete` or :meth:`fail` exactly once."""
        now = time.monotonic()
        with self._lock:
            self._sweep_locked(now)
            f = self._flights.get(key)
            if f is not None:
                f.subscribers += 1
                return "hit", f
            f = Flight(key)
            self._flights[key] = f
            return "leader", f

    def complete(self, flight: Flight, payload: bytes, meta: dict) -> None:
        with self._lock:
            flight.payload = payload
            flight.meta = dict(meta)
            flight.done_at = time.monotonic()
            self._sweep_locked(flight.done_at)
        flight.event.set()
        if self.linger_s == 0:
            self._evict(flight)

    def fail(self, flight: Flight, error: BaseException) -> None:
        """Failed flights never linger: the next identical request should
        retry the computation, not inherit a transient failure forever."""
        with self._lock:
            flight.error = error
            flight.done_at = time.monotonic()
        flight.event.set()
        self._evict(flight)

    def _evict(self, flight: Flight) -> None:
        with self._lock:
            if self._flights.get(flight.key) is flight:
                del self._flights[flight.key]

    def clear(self) -> None:
        """Forget every flight (tests; in-flight leaders still complete
        their own Flight objects — subscribers already attached keep their
        reference)."""
        with self._lock:
            self._flights.clear()


# --------------------------------------------------------------- singleton

_flights: SingleFlight | None = None
_flights_lock = threading.Lock()


def flights() -> SingleFlight:
    """The process-wide flight table: in-process servers share it (same
    content address -> same bytes, whoever's handler runs the flight)."""
    global _flights
    with _flights_lock:
        if _flights is None:
            _flights = SingleFlight()
        return _flights


def reset_flights() -> None:
    global _flights
    with _flights_lock:
        _flights = None
