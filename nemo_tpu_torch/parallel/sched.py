"""The cost-model scheduler: jobs drained on three lanes, with EWMA
feedback, work stealing, a dispatch deadline and a circuit breaker.

A port of the JAX package's ``parallel/sched.py``.  A list of jobs (the
fused buckets and giant runs of a report, its synth buckets, a query's
buckets) runs on one worker thread per lane:

  * **device**: the dense fused dispatch (``TorchExecutor`` on the card);
  * **sparse_device**: the sparse-CSR device step (``sparse_fused``,
    ``synth_ext``, the query's device waves);
  * **host**: the numpy engine (ops/sparse_host.py).

The lanes compute equal results, so a job's lane changes when it runs,
never what it produces; results land by job index.  A job's lane is its
pin (a forced route, a watermark, a giant's lane) or the lane of the least
predicted wall: ``fixed + unit x work`` per lane, seeded so that an
unmeasured scheduler crosses at the analysis budget, then a per-(verb, V,
E) EWMA of the walls this process measured.  An idle lane steals an
unpinned job from another lane's tail.

A device-side failure that is the lane's, not the program's
(``is_lane_failure``: out of memory, a dispatch past
``NEMO_DISPATCH_TIMEOUT_S``) counts ``analysis.sched.lane_failure.device``
and a failure of the device's circuit breaker; ``NEMO_BREAKER_FAILURES``
consecutive failures open it (``sched.breaker.*``, a ``breaker_trip``
flight bundle) until a half-open probe after ``NEMO_BREAKER_COOLDOWN_S``
succeeds.  On the card the failure then propagates, and a run that plans
a job to a device-side lane while the breaker is open raises
``BreakerOpen`` before any job runs: work that was on the card is never
recomputed on the host.  On the CPU the reference's recovery stands: the
job runs again on the host lane after a jittered backoff, recorded (a
route record with reason ``failover``, ``analysis.sched.failover``, the
decision table's ``failed_over``), and an open breaker plans rerouteable
jobs to the host (reason ``breaker``).  A kernel's own error, a sticky
CUDA error, a build failure and every programming error propagate
everywhere; a forced pin never fails over.  A dispatch abandoned past its
deadline publishes nothing (``claim_dispatch``); an error it raises later
is logged, counted (``analysis.sched.abandoned_error``) and raised by the
device's next ``run``.

Departures from the reference:

  * the lane models' seeds come from the device's platform profile
    (platform/profile.py: argument > measured > seeded); no
    ``NEMO_SCHED_*`` env var is read, and no FLOPs hint prices the device
    lane (the port's cost table records no FLOPs);
  * the lane models, the breaker and the decision table are kept per
    device (``device_key``), so that a cpu drain never steers or trips
    the card's;
  * failures are classified by torch's types (``is_lane_failure``);
  * on the card a lane failure or an open breaker raises instead of
    moving the job to the host (above);
  * ``NEMO_SCHED`` defaults to ``off`` (utils/env.py:sched_env);
  * the failover backoff's base is ``NEMO_FAILOVER_BACKOFF_S``.

Every decision is recorded: ``analysis.sched.*`` metrics, one record per
job in the device's decision table (telemetry.json's ``sched``), the
``analysis:sched`` span around a threaded drain and a ``sched:<lane>``
span around each job.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.kernels.build import BuildError, KernelError
from nemo_tpu_torch.obs import log as _obs_log
from nemo_tpu_torch.utils.backoff import FAILOVER_POLICY, BackoffPolicy
from nemo_tpu_torch.utils.env import (  # noqa: F401 (sched_env: the reference's name here)
    breaker_cooldown_s,
    breaker_failures,
    dispatch_timeout_s,
    failover_backoff_s,
    sched_env,
)

_log = _obs_log.get_logger("nemo.sched")

#: Every lane, in tie-break order.
LANES = ("device", "sparse_device", "host")

#: The route records' name of each lane.
ROUTE_OF_LANE = {"device": "dense", "host": "sparse", "sparse_device": "sparse_device"}
LANE_OF_ROUTE = {route: lane for lane, route in ROUTE_OF_LANE.items()}

#: The lanes on the card: one health domain for the breaker, the deadline
#: and the failover.
DEVICE_SIDE_LANES = frozenset({"device", "sparse_device"})


@dataclass
class Job:
    """One schedulable bucket: the cost model's identity (verb, rows, V, E,
    work = rows x (V + E)) and ``execute(lane, reason, stolen)``, which
    runs it on the named lane, records its route and returns its result.
    ``pinned`` names the only lane that may run it; ``reason`` is the route
    reason recorded when it runs on its planned lane; ``lanes`` are the
    lanes its execute implements.  ``execute`` sets ``wall_tainted`` when
    the wall includes a one-off cost (a kernel library built or loaded, a
    verb's first dispatch on the device), which must not feed the EWMA."""

    index: int
    verb: str
    rows: int
    v: int
    e: int
    work: int
    execute: Callable[[str, str, bool], object]
    pinned: str | None = None
    reason: str = "sched"
    #: who submitted it: "pipeline" (a report's drain) or "query"
    source: str = "pipeline"
    wall_tainted: bool = False
    lanes: tuple = ("device", "host")


class LaneModel:
    """One lane's wall predictor: ``fixed + unit x work``, until the lane
    has run the job's (verb, V, E) class; then ``fixed + per_row x rows``
    from an EWMA of the per-row walls measured."""

    def __init__(self, fixed_s: float, unit_s: float, alpha: float = 0.5) -> None:
        self.fixed_s = float(fixed_s)
        self.unit_s = float(unit_s)
        self.alpha = float(alpha)
        #: (verb, v, e) -> EWMA seconds a row, measured by this process
        self.per_row: dict[tuple[str, int, int], float] = {}

    def predict(self, job: Job) -> float:
        per_row = self.per_row.get((job.verb, job.v, job.e))
        if per_row is not None:
            return self.fixed_s + per_row * job.rows
        return self.fixed_s + self.unit_s * job.work

    def observe(self, job: Job, wall_s: float) -> None:
        """Feed one measured wall back into the model."""
        variable = max(wall_s - self.fixed_s, 1e-9)
        per_row = variable / max(job.rows, 1)
        key = (job.verb, job.v, job.e)
        old = self.per_row.get(key)
        self.per_row[key] = per_row if old is None else (1 - self.alpha) * old + self.alpha * per_row
        unit = variable / max(job.work, 1)
        self.unit_s = (1 - self.alpha) * self.unit_s + self.alpha * unit


def default_models(device=None, host_work_budget: int | None = None) -> dict[str, LaneModel]:
    """Lane models whose predictions cross at the analysis budget: the
    host costs ``sched_host_unit`` a work unit, the device a fixed cost of
    the budget's worth of the host-device unit spread (or its measured
    intercept) plus ``sched_device_unit`` a unit, sparse_device the same
    fixed cost plus ``sched_sparse_device_unit``.  Each constant is
    ``device``'s, argument > measured > seeded (``host_work_budget`` is the
    argument for ``analysis_host_work``)."""
    from nemo_tpu_torch.platform.profile import constant_sources

    args = {} if host_work_budget is None else {"analysis_host_work": host_work_budget}
    c = {row["name"]: row["value"] for row in constant_sources(device, args)}
    host_unit, device_unit = float(c["sched_host_unit"]), float(c["sched_device_unit"])
    device_fixed = c["sched_device_fixed"]
    if device_fixed is None:
        device_fixed = int(c["analysis_host_work"]) * max(host_unit - device_unit, 1e-12)
    return {
        "device": LaneModel(device_fixed, device_unit),
        "sparse_device": LaneModel(device_fixed, float(c["sched_sparse_device_unit"])),
        "host": LaneModel(0.0, host_unit),
    }


# ---------------------------------------------------------------------------
# lane failures and the circuit breaker
# ---------------------------------------------------------------------------


class DispatchTimeout(TimeoutError):
    """A device-lane job ran past NEMO_DISPATCH_TIMEOUT_S and was abandoned
    (its thread is left to finish, its result discarded)."""


class BreakerOpen(RuntimeError):
    """A run on the card planned a job to a device-side lane while the
    device's breaker was open: raised before any job runs."""


def is_lane_failure(ex: BaseException) -> bool:
    """Whether ``ex`` is the device lane's failure, which the job may
    recover from on the host lane: ``torch.cuda.OutOfMemoryError``,
    ``MemoryError``, ``DispatchTimeout``, or a RuntimeError that says "out
    of memory".  A kernel wrapper's error (KernelError, even when CUDA's
    string for it is "out of memory"), a build failure (BuildError), a
    sticky CUDA error (``torch.AcceleratorError`` or "CUDA error" in the
    text) and everything else are not: they propagate."""
    if isinstance(ex, (KernelError, BuildError)):
        return False
    if isinstance(ex, (torch.cuda.OutOfMemoryError, MemoryError, DispatchTimeout)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(ex, accel):
        return False
    if isinstance(ex, RuntimeError):
        msg = str(ex)
        return "CUDA error" not in msg and "out of memory" in msg.lower()
    return False


class CircuitBreaker:
    """Closed / open / half-open breaker over one device's lanes.

    ``record_failure`` past ``failures`` consecutive failures opens it:
    ``allow()`` answers False (off the card planning sends rerouteable
    jobs to the host; on the card a drain is refused) until ``cooldown_s`` has passed, when one caller is let through as the
    half-open probe; its success closes the breaker, its failure opens it
    for another cooldown.  Transitions are metrics (``sched.breaker.*``,
    the state a gauge: 0 closed, 1 open, 2 half-open) and log records."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures: int | None = None, cooldown_s: float | None = None) -> None:
        self.failures = failures if failures is not None else breaker_failures()
        self.cooldown_s = cooldown_s if cooldown_s is not None else breaker_cooldown_s()
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_at = 0.0

    def _gauge(self) -> None:
        obs.metrics.gauge("sched.breaker.state", {self.CLOSED: 0, self.OPEN: 1, self.HALF_OPEN: 2}[self.state])

    def allow(self) -> bool:
        """May the device take another job now?  Consumes the half-open
        probe when one is due (``peek`` only looks)."""
        with self._lock:
            now = time.monotonic()
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if now - self._opened_at >= self.cooldown_s:
                    self.state = self.HALF_OPEN
                    self._probe_at = now
                    self._gauge()
                    obs.metrics.inc("sched.breaker.probe")
                    _log.info("sched.breaker_probe", cooldown_s=self.cooldown_s)
                    return True
                obs.metrics.inc("sched.breaker.short_circuit")
                return False
            # Half-open: one probe is out.  A probe can be lost (stolen by
            # the host, or its worker found nothing to run): re-arm after
            # another cooldown, so that the breaker never stays half-open.
            if now - self._probe_at >= self.cooldown_s:
                self._probe_at = now
                obs.metrics.inc("sched.breaker.probe")
                _log.info("sched.breaker_probe_rearmed", cooldown_s=self.cooldown_s)
                return True
            obs.metrics.inc("sched.breaker.short_circuit")
            return False

    def peek(self) -> bool:
        """Whether ``allow`` would grant now: no transition, no metric."""
        with self._lock:
            now = time.monotonic()
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return now - self._opened_at >= self.cooldown_s
            return now - self._probe_at >= self.cooldown_s

    def record_failure(self) -> None:
        tripped = 0
        with self._lock:
            self._consecutive += 1
            obs.metrics.inc("sched.breaker.failures")
            if self.state == self.HALF_OPEN or (self.state == self.CLOSED and self._consecutive >= self.failures):
                self.state = self.OPEN
                self._opened_at = time.monotonic()
                self._gauge()
                obs.metrics.inc("sched.breaker.trip")
                _log.error("sched.breaker_open", consecutive_failures=self._consecutive, cooldown_s=self.cooldown_s,
                           detail="device lanes degraded until a half-open probe succeeds")
                tripped = self._consecutive
        if tripped:
            # The bundle is written outside the lock: its IO must not hold
            # up allow() and peek() on the dispatch path.
            obs.flight.trigger("breaker_trip", consecutive_failures=tripped, cooldown_s=self.cooldown_s)

    def record_success(self) -> None:
        with self._lock:
            closed = self.state != self.CLOSED
            self.state = self.CLOSED
            self._consecutive = 0
            if closed:
                self._gauge()
                obs.metrics.inc("sched.breaker.close")
                _log.info("sched.breaker_closed")


#: Pin reasons whose execute implements the host lane too, so that the
#: breaker may plan the job to the host and a device failure may run it
#: there: a watermark ("mem") or a giant's lane ("giant_impl"); the port
#: has no CPU pin, the reference's "platform".  Not "forced": an explicit
#: route is the caller's decision, and its failure must surface.
_DUAL_LANE_PIN_REASONS = frozenset({"giant_impl", "mem"})


def _may_reroute(job: Job) -> bool:
    """May the breaker or a failover run ``job`` on the host lane?"""
    return job.pinned is None or job.reason in _DUAL_LANE_PIN_REASONS


# ---------------------------------------------------------------------------
# per-device state: lane models, breaker, decision table
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
#: device key -> the session's lane models (learned walls persist across
#: corpora in one process)
_SESSION_MODELS: dict[str, dict[str, LaneModel]] = {}
#: device key -> its breaker (device health outlives one corpus)
_BREAKERS: dict[str, CircuitBreaker] = {}
#: device key -> its decision table, newest last, bounded
_RECORDS: dict[str, deque] = {}
_RECORDS_MAX = 512


#: device key -> errors raised by dispatches abandoned past their
#: deadline, raised by the device's next run
_ABANDONED: dict[str, list[BaseException]] = {}
#: the deadline thread's dispatch state (``claim_dispatch``)
_DISPATCH = threading.local()


def claim_dispatch() -> bool:
    """Whether the calling thread's dispatch may publish its result (record
    its route): False once the scheduler abandoned it past its deadline,
    and no abandonment can follow a True.  Always True outside a deadline
    thread."""
    d = getattr(_DISPATCH, "state", None)
    if d is None:
        return True
    with d["lock"]:
        if not d["abandoned"]:
            d["claimed"] = True
        return not d["abandoned"]


#: (verb, device key) pairs this process has dispatched
_DISPATCHED: set[tuple[str, str]] = set()


def first_dispatch(verb: str, device) -> bool:
    """True the first time a process dispatches ``verb`` on ``device``:
    that wall pays CUDA's lazy init and the allocator's growth, so the
    job's execute marks it ``wall_tainted``."""
    pair = (verb, device_key(device))
    with _STATE_LOCK:
        if pair in _DISPATCHED:
            return False
        _DISPATCHED.add(pair)
        return True


def device_key(device=None) -> str:
    """The key of ``device``'s scheduler state: ``cpu``, or ``cuda:<n>``
    (None and ``cuda`` name the current card).  Needs no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device() if torch.cuda.is_available() else 0}"
    return str(dev)


def session_models(device=None, host_work_budget: int | None = None) -> dict[str, LaneModel]:
    """``device``'s lane models for this process: made by
    ``default_models`` on first use (``host_work_budget`` counts then
    only) and warm-started from the device's platform profile."""
    key = device_key(device)
    with _STATE_LOCK:
        models = _SESSION_MODELS.get(key)
        if models is None:
            from nemo_tpu_torch.platform import profile

            models = _SESSION_MODELS[key] = default_models(device, host_work_budget)
            profile.warm_start(models, device)
        return models


def device_breaker(device=None) -> CircuitBreaker:
    """``device``'s circuit breaker for this process."""
    key = device_key(device)
    with _STATE_LOCK:
        br = _BREAKERS.get(key)
        if br is None:
            br = _BREAKERS[key] = CircuitBreaker()
        return br


def reset_session_models(device=None) -> None:
    """Forget the learned walls and the decision table of ``device``, or
    of every device (None)."""
    with _STATE_LOCK:
        for table in (_SESSION_MODELS, _RECORDS):
            if device is None:
                table.clear()
            else:
                table.pop(device_key(device), None)


def reset_device_breaker(device=None) -> None:
    """Forget the breaker and the abandoned dispatches' errors of
    ``device``, or of every device (None)."""
    with _STATE_LOCK:
        for table in (_BREAKERS, _ABANDONED):
            if device is None:
                table.clear()
            else:
                table.pop(device_key(device), None)


def _record(key: str, rec: dict) -> None:
    with _STATE_LOCK:
        table = _RECORDS.get(key)
        if table is None:
            table = _RECORDS[key] = deque(maxlen=_RECORDS_MAX)
        table.append(rec)


def sched_snapshot(device=None) -> list[dict]:
    """The decision table of ``device`` (None: every device's, by key), as
    JSON-able records, newest last: telemetry.json's ``sched`` section."""
    with _STATE_LOCK:
        keys = sorted(_RECORDS) if device is None else [device_key(device)]
        return [dict(r) for k in keys for r in _RECORDS.get(k, ())]


class HeterogeneousScheduler:
    """A work-stealing executor over a job list on ``device``'s lanes.

    ``run(jobs)`` drains the jobs on one worker thread per modelled lane
    and returns their results in job-index order.  Planned lanes come from
    the cost model or the job's pin; an idle lane steals the next unpinned
    job it implements from another lane's tail.  The first worker
    exception stops every lane and is raised in the caller."""

    def __init__(self, models: dict[str, LaneModel] | None = None, device=None) -> None:
        self.key = device_key(device)
        #: the device-side lanes run on a card: no job leaves them for the host
        self.on_card = self.key.startswith("cuda")
        self.models = models or session_models(device)
        self.lanes = tuple(lane for lane in LANES if lane in self.models) or tuple(self.models)
        self.steals = {lane: 0 for lane in self.lanes}
        self.dispatched = {lane: 0 for lane in self.lanes}
        self.failovers = 0
        self.breaker = device_breaker(device)
        p = FAILOVER_POLICY
        self._backoff = BackoffPolicy(failover_backoff_s(), p.multiplier, p.max_delay_s, p.jitter,
                                      p.budget_s).session()

    def plan(self, job: Job) -> tuple[str, str, dict]:
        """(lane, reason, predictions) of one job.  Off the card, an open
        breaker plans a rerouteable device-side job to the host
        ("breaker"); a forced pin keeps its lane.  On the card the breaker
        is ``run``'s, once for the whole run."""
        candidates = [lane for lane in self.lanes if lane in job.lanes] or list(self.lanes)
        preds = {lane: self.models[lane].predict(job) for lane in candidates}
        if job.pinned:
            lane, reason = job.pinned, job.reason
        else:
            lane = min(candidates, key=lambda ln: (preds[ln], candidates.index(ln)))
            reason = "sched"
        if (not self.on_card and lane in DEVICE_SIDE_LANES and _may_reroute(job)
                and not self.breaker.allow()):
            return "host", "breaker", preds
        return lane, reason, preds

    def _execute_deadline(self, job: Job, lane: str, reason: str, stolen: bool):
        """Run one job under a ``sched:<lane>`` span; a device-side job
        under the ``NEMO_DISPATCH_TIMEOUT_S`` deadline (0: none) on a
        thread of its own, abandoned past it with DispatchTimeout (a launch
        cannot be cancelled).  An abandoned dispatch publishes nothing
        (``claim_dispatch``); an error it raises later is logged, counted
        and kept for the device's next ``run``.  The thread launches on its
        default stream, as the worker does."""
        timeout = dispatch_timeout_s()
        with obs.span(f"sched:{lane}", verb=job.verb, index=job.index, reason=reason):
            if lane not in DEVICE_SIDE_LANES or not timeout:
                return job.execute(lane, reason, stolen)
            box: dict = {}
            done = threading.Event()
            state = {"lock": threading.Lock(), "abandoned": False, "claimed": False}

            def target() -> None:
                _DISPATCH.state = state
                try:
                    box["res"] = job.execute(lane, reason, stolen)
                except BaseException as ex:  # handed to the waiting thread, or kept for the next run
                    box["ex"] = ex
                with state["lock"]:
                    done.set()
                    orphaned = state["abandoned"]
                if orphaned and "ex" in box:
                    ex = box["ex"]
                    obs.metrics.inc("analysis.sched.abandoned_error")
                    _log.error("sched.abandoned_dispatch_failed", verb=job.verb, index=job.index,
                               error=f"{type(ex).__name__}: {ex}", detail="raised by the device's next run")
                    with _STATE_LOCK:
                        _ABANDONED.setdefault(self.key, []).append(ex)

            threading.Thread(target=target, daemon=True, name=f"nemo-sched-dispatch-{job.index}").start()
            if not done.wait(timeout):
                with state["lock"]:
                    # A dispatch that claimed its result has finished its
                    # work: it is waited for, not abandoned.
                    state["abandoned"] = not (done.is_set() or state["claimed"])
                if state["abandoned"]:
                    obs.metrics.inc("watchdog.dispatch_timeout")
                    _log.error("sched.dispatch_timeout", verb=job.verb, index=job.index, timeout_s=timeout,
                               detail="abandoning the wedged dispatch thread")
                    obs.flight.trigger("dispatch_watchdog", verb=job.verb, index=job.index, timeout_s=timeout)
                    raise DispatchTimeout(
                        f"device dispatch of job {job.index} ({job.verb}) exceeded NEMO_DISPATCH_TIMEOUT_S={timeout}")
                done.wait()
            if "ex" in box:
                raise box["ex"]
            return box["res"]

    def run(self, jobs: list[Job], serial: bool = False) -> list:
        with _STATE_LOCK:
            pending = _ABANDONED.pop(self.key, [])
        if pending:
            raise pending[0]
        results: list = [None] * len(jobs)
        done = [False] * len(jobs)
        queues: dict[str, deque[Job]] = {lane: deque() for lane in self.lanes}
        plans: dict[int, tuple[str, str, dict]] = {}
        for job in jobs:
            lane, reason, preds = self.plan(job)
            if lane not in queues:
                raise ValueError(f"job {job.index} planned for lane {lane!r} but the scheduler models only "
                                 f"{self.lanes}")
            plans[job.index] = (lane, reason, preds)
            queues[lane].append(job)
        if self.on_card and any(queues[lane] for lane in DEVICE_SIDE_LANES if lane in queues) \
                and not self.breaker.allow():
            raise BreakerOpen(f"{self.key}'s circuit breaker is open: {sum(len(q) for q in queues.values())} "
                              f"jobs refused (cooldown {self.breaker.cooldown_s} s)")
        obs.metrics.inc("analysis.sched.jobs", len(jobs))

        lock = threading.Lock()
        errors: list[BaseException] = []

        def run_one(job: Job, lane: str, stolen: bool) -> None:
            planned_lane, reason, preds = plans[job.index]
            if stolen:
                reason = "steal"
            t0 = time.perf_counter()
            failed_over = False
            try:
                res = self._execute_deadline(job, lane, reason, stolen)
                if lane in DEVICE_SIDE_LANES:
                    self.breaker.record_success()
            except BaseException as ex:
                # A device-side lane failure counts for the breaker, even
                # where the job cannot reroute: the lane is sick either way.
                # Off the card a rerouteable job then runs on the host lane,
                # recorded; on the card the failure propagates, as do, on
                # any device, a forced pin's, the host lane's, the
                # program's and a kernel's own errors.
                lane_failure = lane in DEVICE_SIDE_LANES and is_lane_failure(ex)
                if lane_failure:
                    self.breaker.record_failure()
                    obs.metrics.inc("analysis.sched.lane_failure.device")
                    if self.on_card:
                        _log.error("sched.lane_failure", index=job.index, verb=job.verb, lane=lane,
                                   error=f"{type(ex).__name__}: {ex}", detail="raised; the card's work stays on it")
                if not lane_failure or self.on_card or not _may_reroute(job):
                    raise
                with lock:
                    wait = self._backoff.delay()
                _log.warning("sched.failover", index=job.index, verb=job.verb, error=f"{type(ex).__name__}: {ex}",
                             backoff_s=round(wait, 3) if wait else 0.0, detail="re-running on the host lane")
                if wait:
                    time.sleep(wait)
                obs.metrics.inc("analysis.sched.failover")
                failed_over = True
                lane, reason = "host", "failover"
                res = job.execute("host", "failover", stolen)
            wall = time.perf_counter() - t0
            with lock:
                # A failed-over wall (failure, backoff, host run) describes
                # neither lane: it stays out of the models.
                if not job.wall_tainted and not failed_over:
                    self.models[lane].observe(job, wall)
                self.dispatched[lane] += 1
                if stolen:
                    self.steals[lane] += 1
                if failed_over:
                    self.failovers += 1
                results[job.index] = res
                done[job.index] = True
            obs.metrics.inc(f"analysis.sched.dispatch.{lane}")
            if stolen:
                obs.metrics.inc(f"analysis.sched.steal.{lane}")
            obs.metrics.observe(f"analysis.sched.wall_s.{lane}", wall)
            _record(self.key, {
                "index": job.index,
                "verb": job.verb,
                "rows": job.rows,
                "v": job.v,
                "e": job.e,
                "work": job.work,
                "lane": lane,
                "planned": planned_lane,
                "reason": reason,
                "source": job.source,
                "stolen": stolen,
                "pinned": job.pinned is not None,
                "tainted": job.wall_tainted,
                "failed_over": failed_over,
                "predicted_s": {k: round(v, 6) for k, v in preds.items()},
                "wall_s": round(wall, 6),
            })

        def take(lane: str):
            """(job, stolen) for ``lane``: its own queue's head, else an
            unpinned job it implements stolen from another lane's tail.  A
            device-side lane consults the breaker before stealing: while it
            is open the worker gets "breaker_wait" (it parks and retries,
            so that a steal after the cooldown is the half-open probe).
            None: no work left for this lane."""
            with lock:
                if queues[lane]:
                    return queues[lane].popleft(), False
                for other in self.lanes:
                    if other == lane:
                        continue
                    for i in range(len(queues[other]) - 1, -1, -1):
                        job = queues[other][i]
                        if job.pinned is None and lane in job.lanes:
                            # peek first: the wait loop must neither take the
                            # probe nor count its polls as short circuits.
                            if lane in DEVICE_SIDE_LANES and (not self.breaker.peek() or not self.breaker.allow()):
                                return "breaker_wait"
                            del queues[other][i]
                            return job, True
            return None

        # Jobs all pinned to one lane have nothing to overlap: drain them
        # on the caller's thread, as the serial loop does.
        pinned_lanes = {job.pinned for job in jobs}
        if None not in pinned_lanes and len(pinned_lanes) == 1:
            serial = True
        if serial:
            for job in jobs:
                run_one(job, plans[job.index][0], False)
            return results

        def worker(lane: str) -> None:
            while not errors:
                nxt = take(lane)
                if nxt is None:
                    return
                if nxt == "breaker_wait":
                    time.sleep(0.01)
                    continue
                job, stolen = nxt
                try:
                    run_one(job, lane, stolen)
                except BaseException as ex:  # raised in the caller after the join
                    with lock:
                        errors.append(ex)
                    return

        with obs.span("analysis:sched", jobs=len(jobs)):
            threads = [threading.Thread(target=worker, args=(lane,), name=f"nemo-sched-{lane}")
                       for lane in self.lanes]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        missing = [j.index for j in jobs if not done[j.index]]
        if missing:
            raise RuntimeError(f"scheduler dropped jobs {missing}")
        return results
