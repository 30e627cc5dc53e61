"""Admission control for the multi-tenant serving tier.

A copy of the JAX package's ``serve/admission.py``.

The sidecar serves many concurrent sessions over one accelerator, so the
first thing between a request and the device is a policy, not a mutex:

  * **bounded concurrency** — at most ``max_inflight`` requests execute at
    once (``--max-inflight`` / ``NEMO_SERVE_INFLIGHT``); the device
    serializes dispatches anyway, and everything past a small in-flight
    window only adds memory pressure and tail latency;
  * **bounded queueing** — at most ``max_queue`` requests wait
    (``--max-queue`` / ``NEMO_SERVE_QUEUE``).  Past that the request is
    REJECTED with a retry-after estimate instead of queued into a timeout:
    load shedding at admission is the difference between a slow server and
    a wedged one;
  * **per-tenant fairness** — queued tickets are granted round-robin
    ACROSS tenants (the ``nemo-tenant`` request metadata), so a greedy
    tenant's burst of N requests cannot starve another tenant's single
    one: the burst waits its turns, the singleton rides the next rotation;
  * **graceful drain** — ``begin_drain()`` refuses new admissions (the
    sidecar's SIGTERM handler flips ``/healthz`` to NOT_SERVING through
    this flag) while granted requests finish, bounded by
    ``NEMO_SERVE_DRAIN_S``.

Everything is observable on the Prometheus surface:
``serve.queue_depth`` / ``serve.inflight`` gauges, ``serve.admitted`` /
``serve.rejected.<reason>`` counters plus per-tenant
``serve.tenant.<t>.requests|rejected|coalesced`` (bounded by the registry's
``NEMO_METRICS_MAX_SERIES`` cardinality cap — an adversarial tenant string
cannot mint unbounded series), and the queued-vs-executing latency split as
two histograms: ``serve.queued_s`` (admission wait) and ``serve.exec_s``
(slot-held execution).

Per-tenant SLO accounting rides the same tier, because admission
is the ONE chokepoint every request crosses in both directions: end-to-end
latency (enqueue -> release, i.e. queued + executed — what the client felt)
lands in ``serve.slo.<t>.latency_s``, a ms-ladder histogram registered via
``set_buckets`` so SLO math gets finer bins than the default decade ladder;
sheds are charged against an error budget — the fraction of a tenant's
requests that may be rejected (``NEMO_SLO_SHED_BUDGET``, default 1%) —
surfaced as the ``serve.slo.<t>.budget_remaining`` gauge (1.0 = untouched,
0.0 = exhausted) with ``serve.slo.<t>.breaches`` counting each exhaustion
transition.  ``slo_snapshot()`` renders the whole table (per-tenant
request/shed totals, budget state, latency mean/max and p50/p95/p99 read
back off the histogram buckets) for telemetry.json and the Health surface.
Every shed also feeds the flight recorder's burst detector
(``obs.flight.note_shed``) so a shed *burst* dumps a postmortem bundle.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

from nemo_tpu_torch import obs

_log = obs.log.get_logger("nemo.serve")

#: Tenant strings ride metric names; anything outside this set becomes '_'
#: and the name is truncated so one tenant = one bounded family of series.
_TENANT_SAFE = re.compile(r"[^A-Za-z0-9_.-]")

DEFAULT_TENANT = "anon"


def sanitize_tenant(tenant: str | None) -> str:
    if not tenant:
        return DEFAULT_TENANT
    return _TENANT_SAFE.sub("_", str(tenant))[:32] or DEFAULT_TENANT


# Serving knobs follow the warn-and-default policy (the NEMO_PACK_XFER
# precedent): a typo'd env on a long-lived sidecar must degrade to the
# measured default, never crash-loop every admission.  The parsers now
# live in nemo_tpu_torch/utils/env.py — ONE home for the
# loud-vs-quiet policy; these aliases keep the serve-layer call sites.
from nemo_tpu_torch.utils.env import env_float as _env_float  # noqa: E402
from nemo_tpu_torch.utils.env import env_int as _env_int  # noqa: E402


def max_inflight_default() -> int:
    return _env_int("NEMO_SERVE_INFLIGHT", 4) or 1


def max_queue_default() -> int:
    return _env_int("NEMO_SERVE_QUEUE", 64)


def drain_seconds() -> float:
    """How long a SIGTERM'd sidecar waits for in-flight work
    (``NEMO_SERVE_DRAIN_S``, default 30 s)."""
    return _env_float("NEMO_SERVE_DRAIN_S", 30.0)


def stream_workers_default() -> int:
    """Per-AnalyzeDirStream-request concurrency (``NEMO_SERVE_STREAM_WORKERS``,
    default 2): how many of one stream's directories may hold admission
    tickets at once."""
    return max(1, _env_int("NEMO_SERVE_STREAM_WORKERS", 2))


def queue_timeout_seconds() -> float:
    """Upper bound on one ticket's admission wait (``NEMO_SERVE_QUEUE_S``,
    default 120 s): a queue that cannot drain within this is overload the
    client should hear about as a reject, not a hung RPC."""
    return _env_float("NEMO_SERVE_QUEUE_S", 120.0)


def slo_shed_budget() -> float:
    """Fraction of a tenant's requests that may be shed before its error
    budget reads exhausted (``NEMO_SLO_SHED_BUDGET``, default 0.01 = 1%)."""
    return _env_float("NEMO_SLO_SHED_BUDGET", 0.01)


#: Bucket ladder for ``serve.slo.<t>.latency_s`` — finer than the default
#: registry ladder at the ms..s range where serving SLOs live, coarser past
#: a minute (anything up there is already an outage, not a distribution).
SLO_LATENCY_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


class AdmissionRejected(Exception):
    """Raised by :meth:`AdmissionController.enqueue` when the request
    cannot even wait.  ``reason`` is ``queue_full`` or ``draining``;
    ``retry_after_s`` is the controller's load-derived backoff estimate."""

    def __init__(self, reason: str, retry_after_s: float) -> None:
        super().__init__(
            f"admission rejected ({reason}); retry after ~{retry_after_s:.1f}s"
        )
        self.reason = reason
        self.retry_after_s = retry_after_s


class Ticket:
    """One request's admission state.  ``wait()`` until granted, then
    ``release()`` exactly once when the work (or the hand-off to a
    coalesced flight) is done; ``cancel()`` abandons a still-queued ticket
    (client disconnect, queue timeout)."""

    __slots__ = ("tenant", "_ctl", "_granted", "enqueued_at", "granted_at", "_done")

    def __init__(self, ctl: "AdmissionController", tenant: str) -> None:
        self.tenant = tenant
        self._ctl = ctl
        self._granted = threading.Event()
        self.enqueued_at = time.monotonic()
        self.granted_at: float | None = None
        self._done = False

    def wait(self, timeout: float | None = None) -> bool:
        """True once the ticket holds an execution slot."""
        return self._granted.wait(timeout)

    def position(self) -> int:
        """0 when granted, else 1-based position in the grant order (the
        round-robin projection — what a queued streaming client is told)."""
        return self._ctl._position(self)

    def release(self) -> None:
        self._ctl._release(self)

    def cancel(self) -> None:
        self._ctl._cancel(self)


class AdmissionController:
    """Bounded, tenant-fair admission queue in front of the execution path.

    Grants are round-robin across tenants with waiting tickets; within one
    tenant, FIFO.  All state changes happen under one lock; grant events
    wake the winning ticket's waiter.  The controller never runs work —
    handlers hold a granted ticket for the duration of their execution and
    release it in a ``finally``.
    """

    def __init__(
        self, max_inflight: int | None = None, max_queue: int | None = None
    ) -> None:
        self.max_inflight = max_inflight if max_inflight is not None else max_inflight_default()
        self.max_queue = max_queue if max_queue is not None else max_queue_default()
        self._lock = threading.Lock()
        self._queues: dict[str, deque[Ticket]] = {}
        self._rr: deque[str] = deque()  # tenant rotation (head = next up)
        self._queued = 0
        self._inflight = 0
        self._streams = 0
        self._draining = False
        #: EWMA of executed-slot seconds — the retry-after estimator's view
        #: of how fast one slot turns over.
        self._exec_ewma = 0.5
        #: tenant -> [requests, sheds, budget_breached] — the SLO ledger.
        #: Bounded by the same force that bounds per-tenant metric series:
        #: tenants are sanitized 32-char strings and the registry cap stops
        #: minting anyway, so a dict here cannot outgrow the metric space.
        self._slo: dict[str, list] = {}
        #: tenants whose latency ladder is already registered (set_buckets
        #: is idempotent but takes the registry lock; skip after first).
        self._slo_ladders: set[str] = set()

    # ------------------------------------------------------------- state

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return self._queued

    @property
    def streams(self) -> int:
        return self._streams

    # ------------------------------------------------------ stream presence

    def begin_stream(self) -> None:
        """Register one live server-streaming RPC (AnalyzeDirStream).  The
        stream handler holds no admission ticket itself — its per-directory
        workers do — so without this presence a SIGTERM drain could see
        inflight==0 between a worker's release and the handler's terminal
        ``done`` event and stop the server mid-stream, severing the stream
        instead of finishing it.  Streams are admitted
        even while draining ONLY in the sense that an already-started one
        finishes; new per-directory tickets still reject."""
        with self._lock:
            self._streams += 1
        obs.metrics.gauge("serve.streams", self._streams)

    def end_stream(self) -> None:
        with self._lock:
            self._streams = max(0, self._streams - 1)
        obs.metrics.gauge("serve.streams", self._streams)

    def retry_after_s(self) -> float:
        """Load-derived backoff hint: the queue's worth of slot turnovers
        ahead of a would-be new arrival, clamped to a sane window."""
        with self._lock:
            pending = self._queued + self._inflight
            est = (pending + 1) / max(self.max_inflight, 1) * max(self._exec_ewma, 0.1)
        return min(max(est, 0.5), 60.0)

    # ----------------------------------------------------------- enqueue

    def enqueue(self, tenant: str | None = None) -> Ticket:
        """Admit-or-reject.  Returns a ticket (possibly already granted);
        raises :class:`AdmissionRejected` when draining or the queue is
        full."""
        tenant = sanitize_tenant(tenant)
        obs.metrics.inc("serve.requests")
        obs.metrics.inc(f"serve.tenant.{tenant}.requests")
        with self._lock:
            self._slo.setdefault(tenant, [0, 0, False])[0] += 1
            if self._draining:
                reason = "draining"
            elif self._queued >= self.max_queue and self._inflight >= self.max_inflight:
                reason = "queue_full"
            else:
                t = Ticket(self, tenant)
                q = self._queues.get(tenant)
                if q is None:
                    q = self._queues[tenant] = deque()
                    self._rr.append(tenant)
                q.append(t)
                self._queued += 1
                self._grant_locked()
                self._gauges_locked()
                return t
        obs.metrics.inc("serve.rejected")
        obs.metrics.inc(f"serve.rejected.{reason}")
        obs.metrics.inc(f"serve.tenant.{tenant}.rejected")
        self.record_shed(tenant, reason)
        retry = self.retry_after_s() if reason == "queue_full" else 1.0
        _log.warning(
            "serve.rejected", tenant=tenant, reason=reason,
            retry_after_s=round(retry, 2),
        )
        raise AdmissionRejected(reason, retry)

    # ----------------------------------------------------- SLO accounting

    def record_shed(self, tenant: str, reason: str) -> None:
        """Charge one shed against `tenant`'s error budget and feed the
        flight recorder's burst detector.  Called from the enqueue reject
        path AND from the server's queue-timeout reject (a timeout is a shed
        the queue took too long to admit — the client experienced the same
        refusal), so the budget sees every refused request regardless of
        which tier refused it."""
        tenant = sanitize_tenant(tenant)
        budget = slo_shed_budget()
        with self._lock:
            rec = self._slo.setdefault(tenant, [0, 0, False])
            rec[1] += 1
            requests, sheds, breached = max(rec[0], 1), rec[1], rec[2]
            remaining = max(0.0, 1.0 - (sheds / requests) / budget) if budget > 0 else 0.0
            now_breached = remaining <= 0.0
            rec[2] = now_breached
        obs.metrics.gauge(f"serve.slo.{tenant}.budget_remaining", remaining)
        if now_breached and not breached:
            obs.metrics.inc(f"serve.slo.{tenant}.breaches")
            _log.warning(
                "serve.slo_breach", tenant=tenant, requests=requests,
                sheds=sheds, shed_budget=budget,
            )
        obs.flight.note_shed(reason, tenant)

    def _slo_observe_locked(self, ticket: Ticket, now: float) -> None:
        """End-to-end latency (enqueue -> release: queued + executed — the
        wall the client saw) into the tenant's ms-ladder SLO histogram.
        Caller holds the lock (the registry has its own and never re-enters
        admission, so the nesting is one-directional and safe)."""
        tenant = ticket.tenant
        name = f"serve.slo.{tenant}.latency_s"
        if tenant not in self._slo_ladders:
            obs.metrics.set_buckets(name, SLO_LATENCY_BUCKETS)  # metrics-doc: serve.slo.<tenant>.latency_s
            self._slo_ladders.add(tenant)
        obs.metrics.observe(name, now - ticket.enqueued_at)  # metrics-doc: serve.slo.<tenant>.latency_s

    # ------------------------------------------------------- grant logic

    def _grant_locked(self) -> None:
        """Hand free slots to queued tickets, one tenant per rotation
        step.  Caller holds the lock."""
        while self._inflight < self.max_inflight and self._queued > 0:
            # Rotate to the next tenant with a waiter; drop empty queues
            # from the rotation as they surface.
            for _ in range(len(self._rr)):
                tenant = self._rr[0]
                q = self._queues.get(tenant)
                if q:
                    break
                self._rr.popleft()
                self._queues.pop(tenant, None)
            else:
                return  # rotation empty (stale counters cannot happen: _queued > 0 implies a waiter)
            self._rr.rotate(-1)
            t = q.popleft()
            self._queued -= 1
            self._inflight += 1
            t.granted_at = time.monotonic()
            obs.metrics.inc("serve.admitted")
            obs.metrics.observe("serve.queued_s", t.granted_at - t.enqueued_at)
            t._granted.set()

    def _gauges_locked(self) -> None:
        obs.metrics.gauge("serve.queue_depth", self._queued)
        obs.metrics.gauge("serve.inflight", self._inflight)

    def _position(self, ticket: Ticket) -> int:
        with self._lock:
            if ticket._granted.is_set():
                return 0
            # Project the round-robin grant order: tenants are served one
            # ticket per rotation, so ticket k (0-based) of its tenant's
            # queue goes out in rotation k.
            q = self._queues.get(ticket.tenant)
            if q is None or ticket not in q:
                return 0
            k = list(q).index(ticket)
            ahead = k  # own tenant's earlier tickets
            for tenant, other in self._queues.items():
                if tenant != ticket.tenant:
                    ahead += min(len(other), k + 1)
            return ahead + 1

    def _release(self, ticket: Ticket) -> None:
        with self._lock:
            if ticket._done:
                return
            ticket._done = True
            if not ticket._granted.is_set():
                # Released while still queued (cancel path alias).
                self._remove_queued_locked(ticket)
                self._gauges_locked()
                return
            self._inflight -= 1
            if ticket.granted_at is not None:
                now = time.monotonic()
                held = now - ticket.granted_at
                obs.metrics.observe("serve.exec_s", held)
                self._exec_ewma = 0.7 * self._exec_ewma + 0.3 * held
                self._slo_observe_locked(ticket, now)
            self._grant_locked()
            self._gauges_locked()

    def _cancel(self, ticket: Ticket) -> None:
        self._release(ticket)

    def _remove_queued_locked(self, ticket: Ticket) -> None:
        q = self._queues.get(ticket.tenant)
        if q is not None:
            try:
                q.remove(ticket)
                self._queued -= 1
            except ValueError:
                pass

    # -------------------------------------------------------------- drain

    def begin_drain(self) -> None:
        """Refuse all new admissions from now on (idempotent).  In-flight
        and already-queued work still completes — drain is about new
        arrivals, not abandoning accepted ones."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        obs.metrics.inc("serve.drain_begun")
        _log.info("serve.draining", inflight=self._inflight, queued=self._queued)

    def drain_wait(self, timeout_s: float) -> bool:
        """Wait until nothing is in flight, queued, OR mid-stream; True
        when drained.  Streams count: an AnalyzeDirStream must
        emit its terminal ``done`` event before the server stops — a
        drained-by-tickets-only wait could sever it between its last
        worker's release and that final yield."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if self._inflight == 0 and self._queued == 0 and self._streams == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)


# --------------------------------------------------------------- singleton

_controller: AdmissionController | None = None
_controller_lock = threading.Lock()


def controller() -> AdmissionController:
    """The process-wide admission controller (created on first use from the
    env knobs — the sidecar's ``main()`` writes its CLI flags into the env
    before the first access, the corpus-cache precedent)."""
    global _controller
    with _controller_lock:
        if _controller is None:
            _controller = AdmissionController()
        return _controller


def reset_controller() -> None:
    """Drop the singleton so the next access re-reads the env (tests)."""
    global _controller
    with _controller_lock:
        _controller = None


# ------------------------------------------------------------- SLO table


def _hist_quantile(hist: dict, q: float) -> float:
    """Quantile estimate off a snapshot histogram: the smallest bucket
    upper bound covering q of the observations (standard Prometheus
    histogram_quantile coarseness — exact would need raw samples).
    Observations past the ladder's top land in +Inf; report the lifetime
    max for those rather than infinity."""
    count = hist.get("count", 0)
    if not count:
        return 0.0
    need = q * count
    for le, cum in hist.get("buckets", []):
        if cum >= need:
            return float(le)
    return float(hist.get("max", 0.0))


def slo_snapshot() -> dict:
    """The per-tenant SLO table: request/shed totals, error-budget state,
    and latency stats (mean/max plus p50/p95/p99 read back off the SLO
    histogram's buckets).  Empty dict when no serving traffic has run —
    telemetry.json and the report hide the section then.  Reads the live
    singleton WITHOUT creating it: a CLI run that never served must not
    boot an admission controller just to report that it didn't."""
    with _controller_lock:
        ctl = _controller
    if ctl is None:
        return {}
    with ctl._lock:
        ledger = {t: list(rec) for t, rec in ctl._slo.items()}
    if not ledger:
        return {}
    budget = slo_shed_budget()
    hists = obs.metrics.snapshot()["histograms"]
    table: dict = {}
    for tenant in sorted(ledger):
        requests, sheds, breached = ledger[tenant]
        ratio = sheds / max(requests, 1)
        row = {
            "requests": int(requests),
            "sheds": int(sheds),
            "shed_ratio": round(ratio, 6),
            "shed_budget": budget,
            "budget_remaining": round(
                max(0.0, 1.0 - ratio / budget) if budget > 0 else 0.0, 6
            ),
            "breached": bool(breached),
        }
        h = hists.get(f"serve.slo.{tenant}.latency_s")
        if h:
            row["latency"] = {
                "count": h["count"],
                "mean_s": round(h["mean"], 6),
                "max_s": round(h["max"], 6),
                "p50_s": _hist_quantile(h, 0.50),
                "p95_s": _hist_quantile(h, 0.95),
                "p99_s": _hist_quantile(h, 0.99),
            }
        table[tenant] = row
    return table
