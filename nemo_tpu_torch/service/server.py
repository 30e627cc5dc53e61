"""The sidecar: the process that owns the card, serving the analysis RPCs.

A port of the JAX package's ``service/server.py``.  A client packs
provenance on its own host and sends arrays, or names a corpus directory
the sidecar reads; the sidecar runs the fused step and the executor's
verbs on its device and sends the results back.  One sidecar is a
replica; several sharing one result-cache tier (``--shared-cache``) are a
fleet, behind the consistent-hash router (``--router``,
nemo_tpu_torch/serve/router.py).

The RPCs, on ``/nemo.NemoAnalysis/<name>`` (proto/nemo_service.proto):
``Health``; ``Analyze`` and the bidirectional ``AnalyzeStream`` (one fused
step with its diff tail per request); ``AnalyzeDir`` (a JSON request
naming a directory on the sidecar's host, ingested through the sidecar's
corpus store, answered from its result cache when the stored corpus is
unchanged); ``AnalyzeDirStream`` (several directories, or a live watch,
as a stream of JSON events); ``Query`` (one ad-hoc query, JSON both
ways); ``Kernel`` (one verb of ``TorchExecutor.VERBS`` on named arrays).

Every work RPC passes the admission controller (nemo_tpu_torch/serve)
first: a bounded queue, per-tenant round-robin (``nemo-tenant`` request
metadata), an in-flight cap, and RESOURCE_EXHAUSTED with a
``nemo-retry-after-s`` hint when the queue is full.  Concurrent identical
AnalyzeDir or Query requests (one content address) coalesce into one
execution with byte-identical responses; Kernel dispatches of the
row-independent verbs from different requests merge into one padded
launch.  A traced client's spans come back in ``nemo-spans-bin`` trailing
metadata.  SIGTERM drains: new admissions are refused, in-flight work
finishes within ``--drain-s``, then the process exits.

In a fleet, a cold AnalyzeDir takes a leader lease on its content address
in the shared tier (``_fleet_single_flight``): of a herd that hits every
replica, one replica runs the analysis and the others relay its published
bytes (``nemo-fleet`` trailing metadata: leader, follower, lease_error,
timeout); a replica that steals a dead leader's lease runs it instead.

The method table ``METHODS`` (name -> kind, request decoder, handler,
response encoder) is the one place the RPCs are defined.  ``make_server``
wraps it in grpc's generic handlers; :class:`Loopback` calls the same
table in this process, bytes in and bytes out, with a context that
records the metadata and raises :class:`RpcError` on abort.  Only the
transport imports ``grpc``: this module imports without it, and so the
card's machine, which has no grpc, drives the real handlers through the
loopback.

One ``TorchExecutor`` serves every Kernel RPC of the device (its counts and
thread-local coldness are per executor).  ``--device`` is ``cuda`` unless
``cpu`` is asked for; without a card ``cuda`` raises (no fall back to the
CPU).  Queries run one at a time (``query.engine.QUERY_LOCK``), as the
report server's ``POST /query`` does.

Run:  python -m nemo_tpu_torch.service.server --port 50051 --metrics-port 9464
      [--shared-cache DIR]
      python -m nemo_tpu_torch.service.server --router --backends host:p1,host:p2
"""

from __future__ import annotations

import argparse
import contextlib
import enum
import json
import os
import threading
import time

from nemo_tpu_torch import obs, serve
from nemo_tpu_torch.obs import log as obs_log
from nemo_tpu_torch.obs import trace as obs_trace
from nemo_tpu_torch.service import codec
from nemo_tpu_torch.service import wire as pb

SERVICE = "nemo.NemoAnalysis"
VERSION = "1"

log = obs_log.get_logger("nemo.sidecar")


def _replica_id() -> str:
    """This replica's fleet identity (lease owner, log attribution)."""
    import socket

    return f"{socket.gethostname()}-{os.getpid()}"


class StatusCode(enum.Enum):
    """The gRPC status codes the service uses, by grpc's names (the
    transport maps them onto ``grpc.StatusCode`` by name)."""

    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    INTERNAL = 13
    UNAVAILABLE = 14


class RpcError(Exception):
    """A failed call: its status code, details and trailing metadata.  The
    loopback raises it, and the client raises it for a failed gRPC call
    too, so that callers handle one exception type."""

    def __init__(self, code: StatusCode, details: str = "", trailing: tuple = ()) -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details
        self._trailing = tuple(trailing)

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing


def _device_health(impl: "_Impl") -> tuple[str, int]:
    """(platform, device count) of the sidecar's device: ``gpu`` and the
    card count on a card, ``cpu`` and 1 otherwise."""
    import torch

    if impl.device.type == "cuda":
        return "gpu", torch.cuda.device_count()
    return "cpu", 1


def _health_state(impl: "_Impl") -> dict:
    """The ``/healthz`` document: the Health response's fields plus the
    admission state; NOT_SERVING while draining (a 503, which takes a
    draining replica out of a load balancer's rotation)."""
    ctl = impl.admission
    platform, count = _device_health(impl)
    return {
        "status": "NOT_SERVING" if ctl.draining else "SERVING",
        "platform": platform,
        "device_count": count,
        "version": VERSION,
        "inflight": ctl.inflight,
        "queue_depth": ctl.queued,
        "replica": _replica_id(),
    }


def _tenant_of(context) -> str:
    """The caller's tenant from ``nemo-tenant`` request metadata (sanitized;
    absent: the shared ``anon`` tenant)."""
    md = dict(context.invocation_metadata() or ())
    return serve.admission.sanitize_tenant(md.get("nemo-tenant"))


def _rpc_observed(name: str, t0: float, trace_id: str | None) -> None:
    """Per-RPC accounting shared by every handler: the latency histogram,
    a trace-correlated debug record and the slow-RPC watchdog."""
    dt = time.perf_counter() - t0
    obs.metrics.observe(f"serve.rpc_latency_s.{name}", dt)
    log.debug("serve.rpc", rpc=name, seconds=round(dt, 6), trace_id=trace_id)
    slow_ms = obs_log.slow_dispatch_ms()
    if slow_ms and dt * 1000.0 > slow_ms:
        obs.metrics.inc("watchdog.slow_rpc")
        log.warning("serve.slow_rpc", rpc=name, wall_ms=round(dt * 1000.0, 1), threshold_ms=slow_ms,
                    trace_id=trace_id)


#: Traced requests sharing the pathless collector tracer; at zero it is
#: torn down, so a sidecar serving untraced traffic records no spans.
_collector_lock = threading.Lock()
_collector_refs = [0]


class _SpanCollection:
    """One request's span collection.  A tracing client sends its trace id
    in ``nemo-trace-id``; the handler's spans go back in
    ``nemo-spans-bin`` trailing metadata, which the client adopts into its
    own trace.  With no tracer configured a pathless collector is started
    for the request and torn down by the last ``release()``; an operator's
    file tracer is only copied from.  Best-effort with several concurrent
    traced clients (spans may ride home on another's response); metrics
    are exact regardless."""

    #: One response's span payload cap (the newest spans are kept).
    MAX_BYTES = 1 << 20

    def __init__(self, context) -> None:
        md = dict(context.invocation_metadata() or ())
        self.tid = md.get("nemo-trace-id")
        self._owned = False
        self._tracer = None
        self._mark = 0
        if self.tid is None:
            return
        with _collector_lock:
            t = obs.tracer()
            if t is None:
                t = obs_trace.start_trace(None)
            if not t.path:
                _collector_refs[0] += 1
                self._owned = True
            self._tracer = t
            self._mark = t.mark()

    def trailing(self) -> tuple:
        t = self._tracer
        if t is None:
            return ()
        spans = t.spans_since(self._mark) if t.path else t.drain_spans()
        payload = b""
        while spans:
            payload = json.dumps(spans).encode("utf-8")
            if len(payload) <= self.MAX_BYTES:
                break
            spans = spans[max(1, len(spans) // 4):]
        if not spans or len(payload) > self.MAX_BYTES:
            return ()
        return (("nemo-spans-bin", payload),)

    def release(self) -> None:
        if not self._owned:
            return
        self._owned = False
        with _collector_lock:
            _collector_refs[0] -= 1
            t = obs.tracer()
            if _collector_refs[0] == 0 and t is not None and not t.path:
                obs_trace.finish()


class _QueryRpcError(Exception):
    """A query-layer error (an unknown name, a bad run filter) raised
    through the Query RPC's single flight: INVALID_ARGUMENT at the handler,
    for the leader and its subscribers alike."""


class _Impl:
    """The handlers, over one device and one executor of it.  Every work
    handler holds an admission ticket while it runs; Health is not gated,
    so readiness probes always answer."""

    def __init__(self, device="cuda") -> None:
        from nemo_tpu_torch.backend.torch_backend import TorchExecutor

        self.executor = TorchExecutor(device, shard="off")
        self.device = self.executor.device
        self.admission = serve.controller()
        self.flights = serve.flights()
        self.batcher = serve.batcher()
        #: one cold parse-and-populate of the corpus store at a time
        self._populate_lock = threading.Lock()

    def _admit(self, context, rpc: str) -> serve.Ticket:
        """Enqueue or reject, then wait for a slot: RESOURCE_EXHAUSTED with
        a ``nemo-retry-after-s`` hint when the queue is full (or the wait
        passes the admission timeout), UNAVAILABLE while draining,
        CANCELLED when the client went away while queued."""
        tenant = _tenant_of(context)
        t0_us = time.perf_counter_ns() // 1000
        try:
            ticket = self.admission.enqueue(tenant)
        except serve.AdmissionRejected as ex:
            context.set_trailing_metadata((("nemo-retry-after-s", f"{ex.retry_after_s:.3f}"),))
            context.abort(
                StatusCode.UNAVAILABLE if ex.reason == "draining" else StatusCode.RESOURCE_EXHAUSTED,
                f"{rpc} not admitted: {ex.reason}; retry after ~{ex.retry_after_s:.1f}s",
            )
        deadline = time.monotonic() + serve.admission.queue_timeout_seconds()
        while not ticket.wait(0.2):
            if not context.is_active():
                ticket.cancel()
                context.abort(StatusCode.CANCELLED, "client went away while queued")
            if time.monotonic() > deadline:
                ticket.cancel()
                obs.metrics.inc("serve.rejected")
                obs.metrics.inc("serve.rejected.queue_timeout")
                self.admission.record_shed(tenant, "queue_timeout")
                context.set_trailing_metadata((("nemo-retry-after-s", f"{self.admission.retry_after_s():.3f}"),))
                context.abort(StatusCode.RESOURCE_EXHAUSTED, f"{rpc} queued past the admission timeout")
        obs.add_span("serve:admission", t0_us, time.perf_counter_ns() // 1000 - t0_us, {"tenant": tenant, "rpc": rpc})
        return ticket

    def _admit_traced(self, context, rpc: str) -> tuple:
        """(ticket, span collection): the collection first, so the
        admission wait's span is collected; released if admission aborts."""
        col = _SpanCollection(context)
        try:
            return self._admit(context, rpc), col
        except BaseException:
            col.release()
            raise

    def health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        col = _SpanCollection(context)
        t0 = time.perf_counter()
        try:
            with obs.span("serve:Health", trace_id=col.tid):
                platform, count = _device_health(self)
                resp = pb.HealthResponse(platform=platform, device_count=count, version=VERSION)
            # The metrics snapshot rides every Health response: any client's
            # health() shows the sidecar's counters.
            context.set_trailing_metadata(
                (("nemo-metrics-bin", json.dumps(obs.metrics.snapshot()).encode("utf-8")),) + col.trailing())
            return resp
        finally:
            _rpc_observed("Health", t0, col.tid)
            col.release()

    def _run_step(self, pre, post, static: dict, chunk: int, trace_id: str | None) -> pb.AnalyzeResponse:
        """One fused step with its diff tail on the device -> a wire
        response (Analyze, AnalyzeStream, AnalyzeDir).  On a card the bool
        summary comes back as one bit-packed copy, unpacked here."""
        import torch

        from nemo_tpu_torch.models.pipeline_model import analysis_step, unpack_summary
        from nemo_tpu_torch.utils import chaos

        # The sidecar's dispatch of the fused step: the chaos harness's
        # dispatch point, as TorchExecutor.run's top is.
        chaos.on_device_dispatch("fused")
        b = int(pre.is_goal.shape[0])
        pack_out = self.device.type == "cuda"
        t0 = time.perf_counter()
        with obs.span("serve:analysis_step", chunk=chunk, rows=b, trace_id=trace_id):
            out = analysis_step(pre, post, **static, pack_out=pack_out)
            if pack_out:
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        obs.metrics.inc("serve.analyze_chunks")
        obs.metrics.observe("serve.step_s", dt)
        obs.metrics.observe("serve.batch_rows", b)
        if "packed_summary" in out:
            out = dict(out)
            out.update(unpack_summary(out.pop("packed_summary").cpu().numpy(), b=b, v=int(static["v"]),
                                      t=int(static["num_tables"]), with_diff=True))
        return codec.outputs_to_pb(out, chunk=chunk, step_seconds=dt)

    def _analyze_one(self, request: pb.AnalyzeRequest, trace_id: str | None = None) -> pb.AnalyzeResponse:
        pre = codec.batch_arrays_from_pb(request.pre or pb.CondBatch(), self.device)
        post = codec.batch_arrays_from_pb(request.post or pb.CondBatch(), self.device)
        static = codec.static_from_pb(request.static or pb.StaticParams())
        return self._run_step(pre, post, static, int(request.chunk), trace_id)

    def analyze(self, request: pb.AnalyzeRequest, context) -> pb.AnalyzeResponse:
        t0 = time.perf_counter()
        ticket, col = self._admit_traced(context, "Analyze")
        try:
            resp = self._analyze_one(request, trace_id=col.tid)
            md = col.trailing()
            if md:
                context.set_trailing_metadata(md)
            return resp
        finally:
            _rpc_observed("Analyze", t0, col.tid)
            col.release()
            ticket.release()

    def analyze_stream(self, request_iterator, context):
        # One ticket for the whole stream (one continuous occupancy of the
        # device); chunks run in arrival order.
        t0 = time.perf_counter()
        ticket, col = self._admit_traced(context, "AnalyzeStream")
        try:
            for request in request_iterator:
                yield self._analyze_one(request, trace_id=col.tid)
            md = col.trailing()
            if md:
                context.set_trailing_metadata(md)
        finally:
            _rpc_observed("AnalyzeStream", t0, col.tid)
            col.release()
            ticket.release()

    def analyze_dir(self, request: dict, context) -> bytes:
        """Server-side corpus analysis: ``{"dir": ..., optional
        "corpus_cache", optional "result_cache"}`` names a directory on the
        sidecar's host; the answer is a serialized AnalyzeResponse, passed
        to the wire as it is (a cached, coalesced or fleet follower's payload
        verbatim).  The caches are the operator's (``--corpus-cache``,
        ``--result-cache``, ``--shared-cache``); a request can only opt out
        (``"off"``).  Trailing metadata: ``nemo-rcache`` (hit, miss, off),
        ``nemo-coalesce`` (leader, hit, off) and, in a fleet, ``nemo-fleet``
        (leader, follower, lease_error, timeout)."""
        t0 = time.perf_counter()
        if not isinstance(request, dict):
            context.abort(StatusCode.INVALID_ARGUMENT, "AnalyzeDir request must be a JSON object")
        d = request.get("dir", "")
        if not d or not os.path.isdir(d):
            context.abort(StatusCode.INVALID_ARGUMENT, f"not a directory on the sidecar host: {d!r}")
        ticket, col = self._admit_traced(context, "AnalyzeDir")
        try:
            payload, meta = self._dir_payload(request, d, col.tid, ticket, context)
            md = col.trailing() + (("nemo-rcache", meta["rcache"]), ("nemo-coalesce", meta["coalesce"]))
            if "fleet" in meta:
                md += (("nemo-fleet", meta["fleet"]),)
            context.set_trailing_metadata(md)
            return payload
        finally:
            _rpc_observed("AnalyzeDir", t0, col.tid)
            col.release()
            ticket.release()

    def _ingest_dir(self, request: dict, d: str):
        """A directory request -> (pre, post, static, segment meta) on the
        device, through the operator's corpus store unless the request opts
        out: a warm hit maps the stored arrays, a miss parses and
        populates, so that the corpus is content-addressed.  Cold misses
        populate one at a time, each looking in the store again first: of
        concurrent requests for one cold corpus, one parses and the others
        map its store."""
        from nemo_tpu_torch.analysis.pipeline import _ingest, _populate
        from nemo_tpu_torch.ingest.native import corpus_step_static
        from nemo_tpu_torch.models.pipeline_model import BatchArrays, pack_molly_for_step
        from nemo_tpu_torch.store import corpus_cache_dir, resolve_store

        req_cache = request.get("corpus_cache")
        client_opt_out = req_cache is not None and corpus_cache_dir(req_cache) is None
        store = None if client_opt_out else resolve_store()
        nc = store.load_corpus(d) if store is not None else None
        if nc is None:
            with self._populate_lock if store is not None else contextlib.nullcontext():
                nc = store.load_corpus(d) if store is not None else None
                if nc is None:
                    molly, _kind, snap = _ingest(d, True, store)
                    if snap is not None:
                        _populate(store, d, molly, snap)
                    nc = getattr(molly, "native_corpus", None)
        if nc is not None:
            pre = BatchArrays.from_packed(nc.pre, self.device)
            post = BatchArrays.from_packed(nc.post, self.device)
            static = corpus_step_static(nc)
            seg_meta = getattr(nc, "store_segments", None)
        else:  # a layout the engine does not parse (trace-JSON)
            pre, post, static = pack_molly_for_step(molly, self.device)
            seg_meta = getattr(molly, "store_segments", None)
        obs.metrics.inc("serve.analyze_dir")
        return pre, post, static, seg_meta

    def _single_flight(self, key: str | None, execute, ticket: serve.Ticket | None, context,
                       on_hit=None) -> tuple[bytes, dict]:
        """``execute()`` -> (payload, meta) once per content address among
        concurrent requests: the first arrival leads, the others wait for
        its bytes (freeing their admission slot first) and get them
        verbatim.  ``key`` None (no store, so no address): run alone,
        ``coalesce`` off.  A subscriber does not inherit the leader's
        ``fleet`` role: one fleet analysis reports one fleet leader."""
        if key is None:
            payload, meta = execute()
            obs.metrics.inc("serve.coalesce.off")
            return payload, dict(meta, coalesce="off")
        role, flight = self.flights.join(key)
        if role == "leader":
            try:
                payload, meta = execute()
            except BaseException as ex:
                self.flights.fail(flight, ex)
                raise
            self.flights.complete(flight, payload, meta)
            obs.metrics.inc("serve.coalesce.leader")
            return payload, dict(meta, coalesce="leader")
        if ticket is not None:
            ticket.release()
        obs.metrics.inc("serve.coalesce.hit")
        if on_hit is not None:
            on_hit()
        payload, meta = flight.wait_result(is_alive=context.is_active if context is not None else None)
        meta = dict(meta, coalesce="hit")
        meta.pop("fleet", None)
        return payload, meta

    def _dir_payload(self, request: dict, d: str, trace_id: str | None, ticket: serve.Ticket,
                     context=None) -> tuple[bytes, dict]:
        """One directory request -> (serialized AnalyzeResponse, meta with
        ``rcache`` and ``coalesce``), for AnalyzeDir and AnalyzeDirStream.
        The content address is the result cache's (segment fingerprints,
        statics, wire version, analysis ABI): it keys the response cache,
        the single flight and, with a shared tier, the fleet's leader
        lease (``_fleet_single_flight``).  A cached response's step wall
        reads 0 (it dispatched nothing); a fleet follower relays the
        leader's bytes as they are."""
        from nemo_tpu_torch.analysis.delta import blob_cache_key
        from nemo_tpu_torch.store.rcache import resolve_result_cache, result_cache_dir

        with obs.span("serve:AnalyzeDir", dir=os.path.basename(d), trace_id=trace_id):
            pre, post, static, seg_meta = self._ingest_dir(request, d)
            req_rc = request.get("result_cache")
            rc_opt_out = req_rc is not None and result_cache_dir(req_rc) is None
            rc = None if rc_opt_out else resolve_result_cache()
            content_key = blob_cache_key(
                "analyze_dir", seg_meta, {"static": {k: int(v) for k, v in static.items()}, "wire": VERSION})

            def _run_and_publish() -> bytes:
                payload = self._run_step(pre, post, static, 0, trace_id).SerializeToString()
                rc.put_blob("analyze_dir", content_key, payload)
                return payload

            def _execute() -> tuple[bytes, dict]:
                if rc is None or content_key is None:
                    return self._run_step(pre, post, static, 0, trace_id).SerializeToString(), {"rcache": "off"}
                cached = rc.load_blob("analyze_dir", content_key)
                if cached is not None:
                    resp = pb.AnalyzeResponse.FromString(cached)
                    resp.step_seconds = 0.0
                    obs.metrics.inc("serve.analyze_dir_cached")
                    return resp.SerializeToString(), {"rcache": "hit"}
                if rc.lease_root is not None:
                    payload, fleet = self._fleet_single_flight(rc, content_key, _run_and_publish, context)
                    return payload, {"rcache": "miss", "fleet": fleet}
                return _run_and_publish(), {"rcache": "miss"}

            def _hit() -> None:
                obs.metrics.inc(f"serve.tenant.{ticket.tenant}.coalesced")
                log.debug("serve.coalesced", dir=d, key=content_key[:12], trace_id=trace_id)

            return self._single_flight(content_key, _execute, ticket, context, _hit)

    def _fleet_single_flight(self, rc, content_key: str, run, context) -> tuple[bytes, str]:
        """One analysis of ``content_key`` fleet-wide, by a leader lease in
        the shared tier (``<rc.lease_root>/lease/analyze_dir/``).

        The replica whose ``O_EXCL`` create wins leads: ``run()`` (which
        publishes the blob to the local and shared tiers) under a heartbeat
        thread that refreshes the lease every TTL/3.  Every other replica
        follows: it polls for the published blob (an existence probe, then
        one verified read) and for the lease's death; a leader that dies
        stops its heartbeat, and past ``NEMO_LEASE_TTL_S`` the first
        follower steals the lease and leads.  A follower past the wait
        bound (``serve.coalesce.Flight.WAIT_TIMEOUT_S``) runs itself
        (``timeout``, counted ``serve.fleet.wait_timeout``: a duplicate of
        a content address, never a conflict); one whose client went away
        raises.  An unusable shared tier runs at once (``lease_error``).

        Returns (payload, role).  A follower's payload is the leader's
        serialized bytes, relayed as they are, so a herd's responses are
        byte-identical."""
        from nemo_tpu_torch.store.rcache import Lease

        lease = Lease(rc.lease_root, "analyze_dir", content_key, owner=_replica_id())
        deadline = time.monotonic() + serve.coalesce.Flight.WAIT_TIMEOUT_S
        followed = False
        flight_id = content_key[:16]
        t0_us = time.perf_counter_ns() // 1000
        # The leader's identity, read while it holds the lease (it releases
        # right after its publish).
        leader_owner: str | None = None
        while True:
            # The blob before the lease: a leader publishes, then releases,
            # so a waiter waking between the two serves the bytes.
            if rc.blob_present("analyze_dir", content_key):
                cached = rc.load_blob("analyze_dir", content_key)
                if cached is not None:
                    if not followed:
                        obs.metrics.inc("serve.fleet.follower")
                    obs.add_span("serve:fleet_follower", t0_us, time.perf_counter_ns() // 1000 - t0_us,
                                 {"flight": flight_id, "span_link": f"flight:{flight_id}",
                                  "leader": leader_owner or lease.read_owner()})
                    return cached, "follower"
            acquired = lease.try_acquire()
            if not acquired and lease.broken:
                obs.metrics.inc("serve.fleet.lease_error")
                log.warning("serve.fleet_lease_error", key=content_key[:12],
                            detail="shared lease tier unusable; executing locally")
                return run(), "lease_error"
            if acquired:
                obs.metrics.inc("serve.fleet.leader")
                log.debug("serve.fleet_leader", key=content_key[:12], owner=lease.owner)
                stop = threading.Event()

                def _beat() -> None:
                    while not stop.wait(lease.ttl_s / 3.0):
                        lease.heartbeat()

                threading.Thread(target=_beat, daemon=True, name="nemo-lease-heartbeat").start()
                try:
                    with obs.span("serve:fleet_leader", flight=flight_id, owner=lease.owner):
                        return run(), "leader"
                finally:
                    stop.set()
                    lease.release()
            if not followed:
                followed = True
                obs.metrics.inc("serve.fleet.follower")
                leader_owner = lease.read_owner()
                log.debug("serve.fleet_follower", key=content_key[:12],
                          detail="another replica leads this content address; waiting on the shared tier")
            if context is not None and not context.is_active():
                obs.metrics.inc("serve.fleet.client_gone")
                raise TimeoutError(f"client went away waiting on fleet flight {content_key[:12]}")
            if time.monotonic() > deadline:
                obs.metrics.inc("serve.fleet.wait_timeout")
                log.warning("serve.fleet_wait_timeout", key=content_key[:12],
                            detail="leader neither published nor expired inside the wait bound; executing locally "
                                   "(duplicate, not stale)")
                return run(), "timeout"
            time.sleep(min(0.25, max(0.02, lease.ttl_s / 10.0)))

    def analyze_dir_stream(self, request: dict, context):
        """Server-streaming AnalyzeDir: ``{"dirs": [...]}`` (or the unary
        ``{"dir": ...}``), answered by JSON events as the work goes:
        ``queued`` (with the admission position), ``admitted``, ``phase``,
        ``result`` (``rcache``, ``coalesce`` and the serialized response
        base64 in ``response_b64``), ``error`` (one directory's, the stream
        goes on) and a terminal ``done``.  The directories run on a small
        pool (``NEMO_SERVE_STREAM_WORKERS``), each under its own ticket, so
        results arrive in completion order.  With ``"watch"`` the stream
        follows a live sweep instead (``_watch_stream``)."""
        import base64
        import queue as _queue

        t0 = time.perf_counter()
        if not isinstance(request, dict):
            context.abort(StatusCode.INVALID_ARGUMENT, "AnalyzeDirStream request must be a JSON object")
        dirs = request.get("dirs")
        if dirs is None:
            dirs = [request["dir"]] if request.get("dir") else []
        if not isinstance(dirs, list) or not dirs:
            context.abort(StatusCode.INVALID_ARGUMENT, "AnalyzeDirStream request needs a non-empty 'dirs' list")
        for d in dirs:
            if not isinstance(d, str) or not os.path.isdir(d):
                context.abort(StatusCode.INVALID_ARGUMENT, f"not a directory on the sidecar host: {d!r}")
        if request.get("watch") is not None:
            yield from self._watch_stream(request, dirs, context, t0)
            return
        tenant = _tenant_of(context)
        col = _SpanCollection(context)
        events: _queue.Queue = _queue.Queue()
        n_workers = min(len(dirs), serve.admission.stream_workers_default())
        work: _queue.Queue = _queue.Queue()
        for i, d in enumerate(dirs):
            work.put((i, d))

        def worker() -> None:
            while True:
                try:
                    i, d = work.get_nowait()
                except _queue.Empty:
                    return
                ticket = None
                try:
                    ticket = self.admission.enqueue(tenant)
                    last_pos = None
                    deadline = time.monotonic() + serve.admission.queue_timeout_seconds()
                    while not ticket.wait(0.2):
                        if not context.is_active() or time.monotonic() > deadline:
                            ticket.cancel()
                            raise serve.AdmissionRejected("queue_timeout", self.admission.retry_after_s())
                        pos = ticket.position()
                        if pos != last_pos:
                            last_pos = pos
                            events.put({"event": "queued", "dir": d, "position": pos})
                    events.put({"event": "admitted", "dir": d})
                    events.put({"event": "phase", "dir": d, "phase": "analyze"})
                    payload, meta = self._dir_payload({**request, "dir": d}, d, col.tid, ticket, context)
                    obs.metrics.inc("serve.stream.results")
                    ev = {"event": "result", "dir": d, "ordinal": i, "rcache": meta.get("rcache", "off"),
                          "coalesce": meta.get("coalesce", "off"),
                          "response_b64": base64.b64encode(payload).decode("ascii")}
                    if "fleet" in meta:
                        ev["fleet"] = meta["fleet"]
                    events.put(ev)
                except serve.AdmissionRejected as ex:
                    events.put({"event": "error", "dir": d, "ordinal": i, "status": "RESOURCE_EXHAUSTED",
                                "detail": ex.reason, "retry_after_s": round(ex.retry_after_s, 3)})
                except Exception as ex:  # one directory's failure, reported as its event; the stream goes on
                    events.put({"event": "error", "dir": d, "ordinal": i, "status": "INTERNAL",
                                "detail": f"{type(ex).__name__}: {ex}"})
                finally:
                    if ticket is not None:
                        ticket.release()

        threads = [threading.Thread(target=worker, daemon=True, name=f"nemo-serve-stream-{k}")
                   for k in range(n_workers)]
        # The handler holds no ticket itself (its workers do): its presence
        # keeps a drain open until the terminal event is out.
        self.admission.begin_stream()
        try:
            for t in threads:
                t.start()
            done = errors = 0
            while done + errors < len(dirs):
                ev = events.get()
                if ev["event"] == "result":
                    done += 1
                elif ev["event"] == "error":
                    errors += 1
                obs.metrics.inc("serve.stream.events")
                yield ev
            yield {"event": "done", "results": done, "errors": errors}
        finally:
            for t in threads:
                t.join(timeout=5.0)
            self.admission.end_stream()
            _rpc_observed("AnalyzeDirStream", t0, col.tid)
            col.release()

    def _watch_stream(self, request: dict, dirs: list, context, t0: float):
        """AnalyzeDirStream's live mode: ``{"dirs": [one sweep], "watch":
        {"results_root": <sidecar path>, "max_updates", "poll_s",
        "debounce_s", "figures", "injector", "initial_wait_s"}}`` attaches the
        stream to a Watcher (watch/watcher.py) on this device: a
        ``watching`` event, a ``report_update`` per published update,
        ``watch_error`` for a failed cycle, and a terminal ``done``.  One
        ticket and the stream presence for the whole session."""
        import queue as _queue

        wopts = request.get("watch")
        if wopts is True:
            wopts = {}
        if not isinstance(wopts, dict):
            context.abort(StatusCode.INVALID_ARGUMENT, "watch must be a JSON object of watch options")
        if len(dirs) != 1:
            context.abort(StatusCode.INVALID_ARGUMENT, "watch mode takes exactly one directory")
        results_root = wopts.get("results_root")
        if not results_root or not isinstance(results_root, str):
            context.abort(StatusCode.INVALID_ARGUMENT, "watch mode needs a 'results_root' (sidecar-host path the "
                                                       "live report publishes under)")
        d = dirs[0]
        ticket, col = self._admit_traced(context, "AnalyzeDirStream")
        self.admission.begin_stream()
        watcher = None
        th = None
        try:
            from nemo_tpu_torch.backend.torch_backend import TorchBackend
            from nemo_tpu_torch.watch import WatchConfig, Watcher

            cfg_kw = {k: wopts[k] for k in ("poll_s", "debounce_s", "figures", "injector", "initial_wait_s")
                      if wopts.get(k) is not None}
            cfg = WatchConfig(max_updates=int(wopts.get("max_updates", 0) or 0), **cfg_kw)
            device = self.device
            watcher = Watcher(d, results_root, lambda: TorchBackend(device=device), cfg)
            q = watcher.subscribe()
            crash: list[BaseException] = []

            def _run_watcher() -> None:
                try:
                    watcher.run()
                except BaseException as ex:  # reported to the client below
                    crash.append(ex)

            th = threading.Thread(target=_run_watcher, daemon=True, name="nemo-serve-watch")
            th.start()
            obs.metrics.inc("serve.watch.sessions")
            yield {"event": "watching", "dir": d, "results_root": results_root, "poll_s": cfg.poll_s,
                   "debounce_s": cfg.debounce_s, "max_updates": cfg.max_updates}
            updates = 0
            while context.is_active():
                try:
                    ev = q.get(timeout=0.2)
                except _queue.Empty:
                    if not th.is_alive() and q.empty():
                        break
                    continue
                if ev is None:
                    continue
                if ev.get("event") == "report_update":
                    updates += 1
                obs.metrics.inc("serve.stream.events")
                yield ev
            if context.is_active():
                if crash:
                    ex = crash[0]
                    obs.metrics.inc("serve.watch.failed")
                    yield {"event": "watch_error", "dir": d, "detail": f"{type(ex).__name__}: {ex}", "fatal": True}
                yield {"event": "done", "dir": d, "updates": updates, "errors": 1 if crash else 0}
        finally:
            if watcher is not None:
                watcher.stop()
            if th is not None:
                th.join(timeout=5.0)
            ticket.release()
            self.admission.end_stream()
            _rpc_observed("AnalyzeDirStream", t0, col.tid)
            col.release()

    def query(self, request: dict, context) -> bytes:
        """One ad-hoc query: ``{"dir", "query", optional "corpus_cache",
        optional "result_cache"}`` -> the result document as JSON bytes
        (sorted keys).  Admission, tracing, caching and the single flight
        as AnalyzeDir, on the query's content address (segment fingerprints
        and the plan key).  A malformed query is INVALID_ARGUMENT with the
        parser's message."""
        t0 = time.perf_counter()
        if not isinstance(request, dict):
            context.abort(StatusCode.INVALID_ARGUMENT, "Query request must be a JSON object")
        d = request.get("dir", "")
        if not d or not os.path.isdir(d):
            context.abort(StatusCode.INVALID_ARGUMENT, f"not a directory on the sidecar host: {d!r}")
        text = request.get("query", "")
        if not text or not isinstance(text, str):
            context.abort(StatusCode.INVALID_ARGUMENT, "Query request needs a non-empty 'query' string")
        from nemo_tpu_torch.query import QueryError, parse_query, plan_query

        try:
            q = parse_query(text)
            plan = plan_query(q)
        except QueryError as ex:
            context.abort(StatusCode.INVALID_ARGUMENT, f"query error: {ex}")
        ticket, col = self._admit_traced(context, "Query")
        try:
            try:
                payload, meta = self._query_payload(request, d, q, plan, col.tid)
            except _QueryRpcError as ex:
                context.abort(StatusCode.INVALID_ARGUMENT, f"query error: {ex}")
            context.set_trailing_metadata(
                col.trailing() + (("nemo-rcache", meta["rcache"]), ("nemo-coalesce", meta["coalesce"])))
            return payload
        finally:
            _rpc_observed("Query", t0, col.tid)
            col.release()
            ticket.release()

    def _query_payload(self, request: dict, d: str, q, plan, trace_id: str | None) -> tuple[bytes, dict]:
        from nemo_tpu_torch.analysis.delta import blob_cache_key
        from nemo_tpu_torch.query import QueryError
        from nemo_tpu_torch.query.engine import QUERY_LOCK, execute_query, ingest_corpus
        from nemo_tpu_torch.store import corpus_cache_dir
        from nemo_tpu_torch.store.rcache import result_cache_dir

        with obs.span("serve:Query", dir=os.path.basename(d), trace_id=trace_id):
            req_cache = request.get("corpus_cache")
            client_opt_out = req_cache is not None and corpus_cache_dir(req_cache) is None
            molly = ingest_corpus(d, "off" if client_opt_out else None)
            req_rc = request.get("result_cache")
            rc_opt_out = req_rc is not None and result_cache_dir(req_rc) is None
            seg_meta = getattr(molly, "store_segments", None)
            content_key = None if rc_opt_out else blob_cache_key("query", seg_meta, {"plan": plan.key})
            obs.metrics.inc("serve.query")

            def _execute() -> tuple[bytes, dict]:
                try:
                    with QUERY_LOCK:
                        doc = execute_query(q, molly, device=self.device, use_cache=not rc_opt_out)
                except QueryError as ex:
                    raise _QueryRpcError(str(ex)) from ex
                return json.dumps(doc, sort_keys=True).encode("utf-8"), {"rcache": doc.get("stats", {}).get(
                    "cache", "off")}

            return self._single_flight(content_key, _execute, None, None)

    def kernel(self, request: pb.KernelRequest, context) -> pb.KernelResponse:
        """One verb of ``TorchExecutor.VERBS`` on the device, through the
        continuous batcher (serve/batch.py): the row-independent verbs of
        different in-flight requests merge into one padded launch.  Outputs
        the executor keeps on the device are copied to the host for the
        wire."""
        from nemo_tpu_torch.backend.torch_backend import TorchExecutor

        t_rpc = time.perf_counter()
        ticket, col = self._admit_traced(context, "Kernel")
        try:
            verb, arrays, params = codec.kernel_request_from_pb(request)
            if verb not in TorchExecutor.VERBS:
                context.abort(StatusCode.INVALID_ARGUMENT, f"unknown kernel verb {verb!r}")
            t0 = time.perf_counter()
            try:
                with obs.span("serve:Kernel", verb=verb, trace_id=col.tid):
                    out = self.batcher.run(self.executor, verb, arrays, params)
                    resp = codec.kernel_response_to_pb(out, step_seconds=time.perf_counter() - t0)
            except KeyError as ex:
                context.abort(StatusCode.INVALID_ARGUMENT, f"missing kernel input: {ex}")
            obs.metrics.inc("serve.kernel_calls")
            md = col.trailing()
            if md:
                context.set_trailing_metadata(md)
            return resp
        finally:
            _rpc_observed("Kernel", t_rpc, col.tid)
            col.release()
            ticket.release()


def _json_request(b: bytes):
    return json.loads(bytes(b).decode("utf-8"))


def _passthrough(m) -> bytes:
    """A handler's payload as it is (already serialized), else serialized."""
    return m if isinstance(m, bytes) else m.SerializeToString()


#: The RPCs: name -> (kind, request decoder, handler method, response
#: encoder).  AnalyzeDir, AnalyzeDirStream and Query carry JSON requests
#: (documented in the proto's header, no message of their own); AnalyzeDir
#: and Query hand back bytes the encoder passes through.
METHODS = {
    "Health": ("unary_unary", pb.HealthRequest.FromString, "health", pb.HealthResponse.SerializeToString),
    "Analyze": ("unary_unary", pb.AnalyzeRequest.FromString, "analyze", pb.AnalyzeResponse.SerializeToString),
    "AnalyzeStream": ("stream_stream", pb.AnalyzeRequest.FromString, "analyze_stream",
                      pb.AnalyzeResponse.SerializeToString),
    "AnalyzeDir": ("unary_unary", _json_request, "analyze_dir", _passthrough),
    "AnalyzeDirStream": ("unary_stream", _json_request, "analyze_dir_stream",
                         lambda d: json.dumps(d).encode("utf-8")),
    "Query": ("unary_unary", _json_request, "query", _passthrough),
    "Kernel": ("unary_unary", pb.KernelRequest.FromString, "kernel", pb.KernelResponse.SerializeToString),
}


class LoopbackContext:
    """A handler's context for an in-process call: the request's metadata,
    the trailing metadata the handler sets, and ``abort`` raising
    :class:`RpcError` with them."""

    def __init__(self, metadata=None) -> None:
        self._invocation = tuple(metadata or ())
        self._trailing: tuple = ()
        self.active = True

    def invocation_metadata(self) -> tuple:
        return self._invocation

    def set_trailing_metadata(self, md) -> None:
        self._trailing = tuple(md)

    def trailing_metadata(self) -> tuple:
        return self._trailing

    def is_active(self) -> bool:
        return self.active

    def time_remaining(self) -> float | None:
        """An in-process call has no deadline."""
        return None

    def abort(self, code: StatusCode, details: str):
        raise RpcError(code, details, self._trailing)


class Loopback:
    """The method table called in this process: request bytes in, response
    bytes out, through each method's decoder, handler and encoder, as the
    gRPC transport runs them.  ``call`` returns (response bytes, the
    context); ``stream`` returns a generator of response bytes and the
    context, whose trailing metadata is complete once the generator is.

    ``name`` is the replica's name where a ``host:port`` would be one: the
    router's ring hashes it, the federated page labels the replica's
    series with it, the logs show it.  Two loopbacks behind one router
    need two names."""

    def __init__(self, device="cuda", impl: _Impl | None = None, name: str = "loopback") -> None:
        self.impl = impl if impl is not None else _Impl(device)
        self.name = name

    def _method(self, name: str) -> tuple:
        """(kind, request decoder, handler, response encoder) of ``name``."""
        kind, decode, attr, encode = METHODS[name]
        return kind, decode, getattr(self.impl, attr), encode

    def call(self, name: str, request: bytes, metadata=None) -> tuple[bytes, LoopbackContext]:
        kind, decode, handler, encode = self._method(name)
        if kind != "unary_unary":
            raise ValueError(f"{name} is a {kind} method, not unary_unary")
        ctx = LoopbackContext(metadata)
        return encode(handler(decode(request), ctx)), ctx

    def stream(self, name: str, request, metadata=None):
        """A unary_stream method (``request``: bytes) or a stream_stream one
        (``request``: an iterable of bytes)."""
        kind, decode, handler, encode = self._method(name)
        ctx = LoopbackContext(metadata)
        if kind == "unary_stream":
            arg = decode(request)
        elif kind == "stream_stream":
            arg = (decode(r) for r in request)
        else:
            raise ValueError(f"{name} is a {kind} method, not a stream")

        def gen():
            try:
                for m in handler(arg, ctx):
                    yield encode(m)
            finally:
                ctx.active = False

        return gen(), ctx


class _GrpcContext:
    """A grpc ServicerContext seen through the handlers' interface: our
    status codes mapped onto grpc's by name."""

    def __init__(self, grpc_mod, ctx) -> None:
        self._grpc = grpc_mod
        self._ctx = ctx

    def invocation_metadata(self):
        return self._ctx.invocation_metadata()

    def set_trailing_metadata(self, md) -> None:
        self._ctx.set_trailing_metadata(md)

    def is_active(self) -> bool:
        return self._ctx.is_active()

    def time_remaining(self) -> float | None:
        return self._ctx.time_remaining()

    def abort(self, code: StatusCode, details: str):
        self._ctx.abort(getattr(self._grpc.StatusCode, code.name), details)


def make_server(port: int = 0, max_workers: int | None = None, device="cuda", impl: _Impl | None = None):
    """Build (but don't start) the gRPC server over ``METHODS`` on
    127.0.0.1; returns (server, bound port).  ``max_workers`` is the
    handler pool, by default the admission capacity (in flight + queue +
    8, at most 256), so that every request the admission tier counts,
    queues or sheds reaches a handler.  Imports grpc: it raises where grpc
    is missing."""
    from concurrent import futures

    import grpc

    impl = impl if impl is not None else _Impl(device)
    if max_workers is None:
        ctl = impl.admission
        max_workers = min(ctl.max_inflight + ctl.max_queue + 8, 256)
    makers = {
        "unary_unary": grpc.unary_unary_rpc_method_handler,
        "unary_stream": grpc.unary_stream_rpc_method_handler,
        "stream_stream": grpc.stream_stream_rpc_method_handler,
    }
    handlers = {}
    for name, (kind, decode, attr, encode) in METHODS.items():
        method = getattr(impl, attr)

        def bound(request, ctx, method=method):
            return method(request, _GrpcContext(grpc, ctx))

        handlers[name] = makers[kind](bound, request_deserializer=decode, response_serializer=encode)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_receive_message_length", 1 << 30),
            ("grpc.max_send_message_length", 1 << 30),
            # Span trailing metadata can reach _SpanCollection.MAX_BYTES.
            ("grpc.max_metadata_size", 2 << 20),
        ],
    )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
    bound_port = server.add_insecure_port(f"127.0.0.1:{port}")
    return server, bound_port


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nemo_tpu_torch.service.server",
                                     description="The sidecar: serves the analysis RPCs on one device.")
    parser.add_argument("--port", type=int, default=50051)
    parser.add_argument("--router", action="store_true",
                        help="serve the fleet router instead of a replica: AnalyzeDir affinity on a consistent-hash "
                             "ring over --backends, spill under load, failover on UNAVAILABLE "
                             "(nemo_tpu_torch/serve/router.py); owns no device")
    parser.add_argument("--backends", default=None, metavar="HOST:PORT,...",
                        help="the router's replicas (default $NEMO_FLEET_REPLICAS)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the device the sidecar owns (default cuda, which raises without a card)")
    parser.add_argument("--max-workers", type=int, default=None,
                        help="gRPC handler pool size (default: the admission capacity, max-inflight + max-queue "
                             "+ 8, at most 256)")
    parser.add_argument("--max-inflight", type=int, default=None, metavar="N",
                        help="at most N work RPCs execute at once (default $NEMO_SERVE_INFLIGHT or 4)")
    parser.add_argument("--max-queue", type=int, default=None, metavar="N",
                        help="admission queue bound across tenants (default $NEMO_SERVE_QUEUE or 64); past it "
                             "RESOURCE_EXHAUSTED with a retry-after hint")
    parser.add_argument("--drain-s", type=float, default=None, metavar="S",
                        help="on SIGTERM refuse new work and let in-flight requests finish for up to S seconds "
                             "(default $NEMO_SERVE_DRAIN_S or 30)")
    parser.add_argument("--corpus-cache", default=None, metavar="DIR|off",
                        help="the corpus store AnalyzeDir and Query ingest through (default $NEMO_CORPUS_CACHE "
                             "or ~/.cache/nemo_tpu_torch/corpus)")
    parser.add_argument("--result-cache", default=None, metavar="DIR|off",
                        help="the result cache AnalyzeDir and Query answer from (default $NEMO_RESULT_CACHE or "
                             "~/.cache/nemo_tpu_torch/results)")
    parser.add_argument("--shared-cache", default=None, metavar="DIR|off",
                        help="the fleet's shared result-cache tier, a directory every replica reaches (default "
                             "$NEMO_RCACHE_SHARED or off): publishes replicate there, reads fall back there, and the "
                             "leader lease that makes a cold herd one analysis fleet-wide lives there")
    parser.add_argument("--prewarm", default=None, metavar="off|chunk|full",
                        help="at boot, on a background thread, build the kernels and dispatch each family's "
                             "fused step once: 'chunk' at 16 runs, 'full' at the 2048-run stress bucket "
                             "(default $NEMO_SERVE_PREWARM or off)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve Prometheus metrics on http://127.0.0.1:PORT/metrics and /healthz (default "
                             "$NEMO_METRICS_PORT or 0: off); a router serves the fleet's federated page and "
                             "/autoscale")
    parser.add_argument("--profiler-port", type=int, default=0,
                        help="serve on-demand torch.profiler captures on http://127.0.0.1:PORT/capture?ms=N: the "
                             "Chrome-trace JSON of this replica's work over the next N ms (0: off)")
    args = parser.parse_args(argv)
    if args.router:
        # The router owns no device and runs no analysis.
        return _router_main(args)
    # The caches and the admission knobs travel as their env vars: the
    # handlers and the admission controller read them on first use.
    for flag, env in ((args.corpus_cache, "NEMO_CORPUS_CACHE"), (args.result_cache, "NEMO_RESULT_CACHE"),
                      (args.shared_cache, "NEMO_RCACHE_SHARED"),
                      (args.prewarm, "NEMO_SERVE_PREWARM"), (args.max_inflight, "NEMO_SERVE_INFLIGHT"),
                      (args.max_queue, "NEMO_SERVE_QUEUE"), (args.drain_s, "NEMO_SERVE_DRAIN_S")):
        if flag is not None:
            os.environ[env] = str(flag)
    from nemo_tpu_torch.utils.env import env_choice, env_int

    prewarm_mode = env_choice("NEMO_SERVE_PREWARM", "off", ("off", "chunk", "full"))
    metrics_port = args.metrics_port if args.metrics_port is not None else env_int("NEMO_METRICS_PORT", 0)
    impl = _Impl(args.device)
    log.info("device.resolved", device=str(impl.device))
    if obs_trace.configure_from_env() is not None:
        log.info("trace.enabled", path=obs.tracer().path)
    if obs.flight.configure_from_env() is not None:
        log.info("flight.armed", dir=obs.flight.recorder().out_dir)
    metrics_httpd = None
    if metrics_port:
        from nemo_tpu_torch.obs import promexp

        metrics_httpd, mport = promexp.start_http_server(metrics_port, health=lambda: _health_state(impl))
        log.info("metrics.listening", port=mport, paths=["/metrics", "/healthz"])
    profiler_httpd = None
    if args.profiler_port:
        profiler_httpd, pport = start_profiler_server(args.profiler_port, impl.device)
        log.info("profiler.listening", port=pport, path="/capture?ms=N")
    server, port = make_server(args.port, args.max_workers, impl=impl)
    server.start()
    _prewarm_async(impl, prewarm_mode)
    ctl = impl.admission
    obs.metrics.gauge("serve.capacity", float(ctl.max_inflight))
    log.info("sidecar.listening", port=port, replica=_replica_id(), max_inflight=ctl.max_inflight,
             max_queue=ctl.max_queue, shared_cache=os.environ.get("NEMO_RCACHE_SHARED") or None)
    import signal

    term = threading.Event()
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
    try:
        while not term.wait(0.5):
            pass
        drain_s = serve.admission.drain_seconds()
        log.info("sidecar.drain_begin", drain_s=drain_s, inflight=ctl.inflight, queued=ctl.queued)
        ctl.begin_drain()
        # Wait for the admission tier (tickets, queued waiters, live
        # streams) before stopping grpc, so that a stream's terminal event
        # goes out.
        drained = ctl.drain_wait(drain_s)
        server.stop(grace=5.0).wait(timeout=5.0)
        obs.metrics.inc("serve.drained" if drained else "serve.drain_timeout")
        log.info("sidecar.drained", clean=drained, inflight=ctl.inflight)
        return 0 if drained else 1
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        for httpd in (metrics_httpd, profiler_httpd):
            if httpd is not None:
                httpd.shutdown()


def _router_main(args) -> int:
    """``--router``: serve the fleet router (serve/router.py) over the
    ``--backends`` replicas, with the flight recorder armed and, on
    ``--metrics-port``, the fleet's federated page (obs/federation.py),
    ``/healthz`` and ``/autoscale``.  No device, no analysis.  SIGTERM
    stops it after in-flight forwards finish (each bounded by its client's
    deadline)."""
    import signal

    from nemo_tpu_torch.utils.env import env_int

    backends = [b.strip() for b in (args.backends or os.environ.get("NEMO_FLEET_REPLICAS", "")).split(",")
                if b.strip()]
    if not backends:
        log.error("router.no_backends", detail="--router needs --backends host:port,... or NEMO_FLEET_REPLICAS")
        return 2
    from nemo_tpu_torch.serve.router import make_router_server

    # A failover storm or a spill loop seen from the routing tier deserves
    # a postmortem as a replica's incident does.
    if obs.flight.configure_from_env() is not None:
        log.info("flight.armed", dir=obs.flight.recorder().out_dir)
    server, port, router = make_router_server(args.port, backends)
    server.start()
    metrics_port = args.metrics_port if args.metrics_port is not None else env_int("NEMO_METRICS_PORT", 0)
    metrics_httpd = None
    if metrics_port:
        from nemo_tpu_torch.obs import federation, promexp

        def _router_health() -> dict:
            states = router.backend_states()
            up = sum(1 for s in states.values() if s["up"])
            return {"status": "SERVING" if up else "NOT_SERVING", "role": "router", "replicas": len(states),
                    "replicas_up": up, "backends": states}

        def _fleet_metrics() -> str:
            return federation.federate(*router.fleet_snapshots())

        metrics_httpd, mport = promexp.start_http_server(metrics_port, health=_router_health, render=_fleet_metrics,
                                                         routes={"/autoscale": router.autoscaler.doc})
        log.info("metrics.listening", port=mport, paths=["/metrics", "/healthz", "/autoscale"])
    log.info("router.listening", port=port, backends=backends)
    term = threading.Event()
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
    try:
        while not term.wait(0.5):
            pass
        drain_s = serve.admission.drain_seconds()
        server.stop(grace=drain_s).wait(timeout=drain_s + 5.0)
        router.stop()
        log.info("router.drained")
        return 0
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if metrics_httpd is not None:
            metrics_httpd.shutdown()


def _capture_trace(ms: float, device) -> bytes:
    """The Chrome-trace JSON of a ``torch.profiler`` capture of this process
    over the next ``ms`` milliseconds: the host operators of every thread
    (the handlers run on the server's pool), and the card's kernels and
    copies on a cuda device."""
    import tempfile

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    config = _ExperimentalConfig(profile_all_threads=True)
    with tempfile.TemporaryDirectory(prefix="nemo-capture-") as d:
        with profile(activities=activities, experimental_config=config) as prof:
            time.sleep(ms / 1000.0)
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as fh:
            return fh.read()


def start_profiler_server(port: int, device):
    """``--profiler-port``: on-demand profiler captures over HTTP, the
    port's stand-in for ``jax.profiler.start_server`` (which serves
    TensorBoard's capture protocol; PyTorch has none).  ``GET
    /capture?ms=N`` (0 < N <= 600000, default 1000) answers with the
    Chrome-trace JSON of this replica's work over the next N ms; one
    capture at a time (409 while one runs).  Returns (the
    ThreadingHTTPServer on a daemon thread, its bound port); the caller
    owns ``shutdown()``."""
    import http.server
    import urllib.parse

    busy = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            url = urllib.parse.urlsplit(self.path)
            if url.path != "/capture":
                self.send_error(404)
                return
            try:
                ms = float(dict(urllib.parse.parse_qsl(url.query)).get("ms", "1000"))
            except ValueError:
                ms = -1.0
            if not 0 < ms <= 600_000:
                self.send_error(400, "ms must be a number in (0, 600000]")
                return
            if not busy.acquire(blocking=False):
                self.send_error(409, "a capture is running")
                return
            try:
                body = _capture_trace(ms, device)
            finally:
                busy.release()
            log.info("profiler.captured", ms=ms, bytes=len(body))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # stdlib's stderr lines -> obs log
            log.debug("profiler.http", detail=fmt % args)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True, name="nemo-profiler-http").start()
    return httpd, httpd.server_address[1]


def _prewarm_async(impl: _Impl, mode: str) -> None:
    """``--prewarm chunk|full``: on a background thread, build the kernel
    libraries and dispatch each family's fused step once
    (utils/prewarm.py), at 16 runs or at the 2048-run stress bucket, so the
    first requests find everything loaded; serving is never blocked."""
    if mode == "off":
        return

    def _run() -> None:
        t0 = time.perf_counter()
        try:
            from nemo_tpu_torch.models.case_studies import CASE_STUDIES
            from nemo_tpu_torch.utils.prewarm import build_all, prewarm_family

            build_all(impl.device)
            for name in sorted(CASE_STUDIES):
                prewarm_family(name, 16, 2048 if mode == "full" else 16, impl.device)
            dt = time.perf_counter() - t0
            obs.metrics.gauge("serve.prewarm_s", dt)
            log.info("serve.prewarm_done", seconds=round(dt, 2), mode=mode)
        except Exception as ex:  # a failed prewarm is logged and counted; serving goes on
            obs.metrics.inc("serve.prewarm_failed")
            log.warning("serve.prewarm_failed", error=f"{type(ex).__name__}: {ex}")

    threading.Thread(target=_run, daemon=True, name="nemo-prewarm").start()


if __name__ == "__main__":
    raise SystemExit(main())
