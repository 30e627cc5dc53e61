"""The fleet router: content affinity over N sidecar replicas.

A copy of the JAX package's ``serve/router.py``, forwarding through the
port's own transports (service/client.py's channels) instead of grpc's:

  * **Affinity.**  ``AnalyzeDir`` and ``AnalyzeDirStream`` requests hash on
    the corpus's store identity (:func:`route_key`, the realpath the corpus
    store keys its directory by) onto a consistent-hash ring with virtual
    nodes, so one corpus's coalesce leader and batcher stay on one
    replica; adding or removing one of N replicas moves about K/N keys.
  * **Spill.**  A home replica that sheds (RESOURCE_EXHAUSTED with the
    ``nemo-retry-after-s`` hint), or whose last polled queue depth reaches
    ``NEMO_ROUTER_SPILL_DEPTH``, sends the request to the least-loaded live
    replica (``router.spill``, ``router.spill_planned``); the shared result
    cache tier lets any replica serve any warm corpus.
  * **Failover.**  UNAVAILABLE (a replica down or draining) marks the
    replica down and tries the next on the ring after a jittered pause
    (utils/backoff.py:FAILOVER_POLICY), counted ``router.failover``; a
    background Health poll (``NEMO_ROUTER_HEALTH_S``) reads each replica's
    depth and metrics snapshot and brings recovered replicas back.
  * **Bytes through.**  Requests and responses travel as the bytes they
    are (AnalyzeDir's JSON is read only for its routing key); trailing
    metadata comes back untouched, but for the router's forward span
    stitched into a traced client's ``nemo-spans-bin`` and, on Health, the
    whole fleet's metrics snapshot.

RPCs with no content identity (Analyze, AnalyzeStream, Kernel, Health) go
to the least-loaded live replica.

A backend is a ``host:port`` (gRPC, imported only then) or an in-process
:class:`~nemo_tpu_torch.service.server.Loopback`; the ring, the federated
page's ``replica=`` label and the logs name it by its ``host:port`` or the
loopback's ``name``, so two backends need two names.  The router itself is
served by :func:`make_router_server` (gRPC) or called in process through
:class:`RouterLoopback`, which a client's channel takes as it takes a
``Loopback``.  Run it with the sidecar's CLI:
``python -m nemo_tpu_torch.service.server --router --backends host:p1,host:p2``
(or ``NEMO_FLEET_REPLICAS``).
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time

from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import log as obs_log
from nemo_tpu_torch.serve.autoscale import Autoscaler
from nemo_tpu_torch.service.server import SERVICE, Loopback, RpcError, StatusCode
from nemo_tpu_torch.utils.backoff import FAILOVER_POLICY
from nemo_tpu_torch.utils.env import env_float

_log = obs_log.get_logger("nemo.router")

#: The replica's span relay cap (service/server.py): a stitched payload past
#: it rides without the router's spans.
_SPANS_MAX_BYTES = 1 << 20

__all__ = ["HashRing", "Router", "RouterLoopback", "make_router_server", "ring_hash", "route_key",
           "spill_depth_default", "SERVICE"]


def _raw(b):
    """The identity (de)serializer: the router forwards bytes."""
    return b


def ring_hash(s: str) -> int:
    """A stable 64-bit ring position: a sha256 prefix (never Python's salted
    ``hash()``, which would move every key each process)."""
    return int.from_bytes(hashlib.sha256(s.encode("utf-8")).digest()[:8], "big")


def route_key(molly_dir: str) -> str:
    """A corpus's routing identity: its realpath, what the corpus store keys
    its directory by.  It stays as the corpus grows, so a grown corpus
    keeps its replica; the segment fingerprints handle freshness."""
    return os.path.realpath(molly_dir)


class HashRing:
    """A consistent-hash ring with virtual nodes: each backend owns
    ``vnodes`` points, and a key routes to the first point at or after its
    hash (wrapping).  A new backend among N claims about 1/(N+1) of each
    other's keys; a removed one hands its keys to its ring successors and
    nobody else moves."""

    def __init__(self, backends: list[str], vnodes: int = 64) -> None:
        self.backends = list(dict.fromkeys(backends))
        self.vnodes = int(vnodes)
        ring = sorted((ring_hash(f"{b}#{i}"), b) for b in self.backends for i in range(self.vnodes))
        self._ring = ring
        self._points = [p for p, _ in ring]

    def preference(self, key: str) -> list[str]:
        """Every backend in the ring walk's order from ``key``'s point: [0]
        is the affinity home, the rest the failover order."""
        if not self._ring:
            return []
        i = bisect.bisect(self._points, ring_hash(key)) % len(self._ring)
        seen: set[str] = set()
        out: list[str] = []
        for k in range(len(self._ring)):
            b = self._ring[(i + k) % len(self._ring)][1]
            if b not in seen:
                seen.add(b)
                out.append(b)
                if len(out) == len(self.backends):
                    break
        return out

    def route(self, key: str) -> str:
        return self.preference(key)[0]


def spill_depth_default() -> float:
    """Load (queued + in flight, from the replica's own gauges) at which
    the router spills an affinity-routed request to the least-loaded
    replica (``NEMO_ROUTER_SPILL_DEPTH``, default 8)."""
    return env_float("NEMO_ROUTER_SPILL_DEPTH", 8.0)


def _name_of(backend) -> str:
    return backend if isinstance(backend, str) else backend.name


class Router:
    """Routing state and the forwarding behind the router's handlers.

    ``plan`` is pure state -> order; the ``call_*`` methods do the wire
    work.  Load is the router's own in-flight count per backend and the
    last Health poll's queued + in-flight gauges (load from other routers
    and direct clients)."""

    def __init__(self, backends: list, vnodes: int = 64) -> None:
        if not backends:
            raise ValueError("router needs at least one backend replica")
        if any(isinstance(b, str) for b in backends):
            import grpc  # noqa: F401  (a host:port backend needs it: raises here, never read as a replica down)
        targets: dict[str, object] = {}
        for b in backends:
            name = _name_of(b)
            if name in targets and targets[name] is not b:
                raise ValueError(f"two backends named {name!r}: give each in-process replica its own name")
            targets[name] = b
        self._targets = targets
        self.ring = HashRing(list(targets), vnodes)
        self.backends = self.ring.backends
        self._lock = threading.Lock()
        self._channels: dict[str, object] = {}
        self._inflight = {b: 0 for b in self.backends}
        self._depth = {b: 0.0 for b in self.backends}
        self._up = {b: True for b in self.backends}
        # Each replica's metrics snapshot from the last Health round: what
        # the federated page and the autoscaler read ({} until it answers).
        self._snaps: dict[str, dict] = {b: {} for b in self.backends}
        self.autoscaler = Autoscaler()
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None

    # ------------------------------------------------------------- state

    def start(self) -> None:
        """Start the background Health poll (once)."""
        if self._health_thread is not None:
            return
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True, name="nemo-router-health")
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        # The poll thread first, so that no pass makes a channel after the
        # map is cleared.
        t = self._health_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            ch.close()

    def _health_loop(self) -> None:
        period = max(0.2, env_float("NEMO_ROUTER_HEALTH_S", 2.0))
        while not self._stop.wait(period):
            self.poll_health()

    def poll_health(self) -> None:
        """One Health round over the fleet: each replica up or down, its
        queued + in-flight depth and its metrics snapshot (from the
        ``nemo-metrics-bin`` trailing metadata), then one autoscaler
        update."""
        from nemo_tpu_torch.service import wire

        req = wire.HealthRequest().SerializeToString()
        for b in self.backends:
            depth = 0.0
            snap: dict = {}
            try:
                _, call = self._channel(b).unary("Health", _raw, _raw).with_call(req, timeout=5.0)
                raw = dict(call.trailing_metadata() or ()).get("nemo-metrics-bin")
                if raw:
                    snap = json.loads(raw.decode("utf-8") if isinstance(raw, bytes) else raw)
                    gauges = snap.get("gauges", {})
                    depth = float(gauges.get("serve.queue_depth", 0.0)) + float(gauges.get("serve.inflight", 0.0))
                up = True
            except (RpcError, OSError, ValueError):  # no answer, or no readable one: down until a round answers
                up = False
            with self._lock:
                was_up = self._up[b]
                self._up[b] = up
                self._depth[b] = depth if up else 0.0
                if up:
                    # A down replica keeps its last snapshot: stale series
                    # beat vanishing ones mid-incident.
                    self._snaps[b] = snap
            if up != was_up:
                obs.metrics.inc("router.backend_up" if up else "router.backend_down")
                _log.warning("router.backend_state", backend=b, up=up)
            obs.metrics.gauge(f"router.backend.{self.backends.index(b)}.up", 1.0 if up else 0.0)
        snaps, up_map = self.fleet_snapshots()
        obs.metrics.gauge("fleet.autoscale.recommendation", self.autoscaler.update(snaps, up_map))

    def fleet_snapshots(self) -> tuple[dict, dict]:
        """(name -> last Health snapshot, name -> up): what the federated
        page and the autoscaler read."""
        with self._lock:
            return {b: self._snaps.get(b) or {} for b in self.backends}, dict(self._up)

    def fleet_health_trailing(self, tm, backend: str):
        """The Health handler's trailing hook: the answering replica's
        ``nemo-metrics-bin`` replaced by the fleet's, ``{"replicas": {name:
        snapshot}, "up": {name: bool}}``, the answering replica's snapshot
        fresh from this answer and the rest from the last poll."""
        snaps, up = self.fleet_snapshots()
        out = []
        for k, v in tm or ():
            if k == "nemo-metrics-bin":
                try:
                    snaps[backend] = json.loads(v.decode("utf-8") if isinstance(v, bytes) else v)
                    up[backend] = True
                except ValueError:
                    pass  # the poll's snapshot stands in
                continue
            out.append((k, v))
        out.append(("nemo-metrics-bin", json.dumps({"replicas": snaps, "up": up}).encode("utf-8")))
        return tuple(out)

    def _channel(self, b: str):
        with self._lock:
            ch = self._channels.get(b)
        if ch is not None:
            return ch
        from nemo_tpu_torch.service.client import _channel

        target = self._targets[b]
        if isinstance(target, str):
            # One connect probe: a channel made before its server listens
            # wedges (utils/subproc.py), and a closed port refuses at once.
            import socket

            host, _, port = target.rpartition(":")
            socket.create_connection((host or "127.0.0.1", int(port)), 2.0).close()
        ch = _channel(target)
        with self._lock:
            if b in self._channels:
                ch.close()
                return self._channels[b]
            self._channels[b] = ch
        return ch

    def _begin(self, b: str) -> None:
        with self._lock:
            self._inflight[b] += 1
            n = sum(self._inflight.values())
        obs.metrics.gauge("router.inflight", n)

    def _end(self, b: str) -> None:
        with self._lock:
            self._inflight[b] = max(0, self._inflight[b] - 1)
            n = sum(self._inflight.values())
        obs.metrics.gauge("router.inflight", n)

    def _mark_down(self, b: str) -> None:
        with self._lock:
            was = self._up[b]
            self._up[b] = False
        if was:
            obs.metrics.inc("router.backend_down")
            _log.warning("router.backend_state", backend=b, up=False)

    def backend_states(self) -> dict:
        with self._lock:
            return {b: {"up": self._up[b], "inflight": self._inflight[b], "depth": self._depth[b]}
                    for b in self.backends}

    # ------------------------------------------------------------ routing

    def plan(self, key: str | None) -> list[str]:
        """The backends to try for one request, in order.  No key: live
        replicas first, least loaded first.  A key: the ring's order with
        down replicas last (still tried: the poll may be stale); and when
        the live home's load reaches the spill depth and a live replica
        carries strictly less, that replica first
        (``router.spill_planned``)."""
        with self._lock:
            up = dict(self._up)
            # max, not sum: the replica's polled in-flight gauge already
            # holds what this router forwarded.
            load = {b: max(self._inflight[b], self._depth[b]) for b in self.backends}
        if key is None:
            return sorted(self.backends, key=lambda b: (not up[b], load[b]))
        pref = self.ring.preference(key)
        alive = [b for b in pref if up[b]]
        order = alive + [b for b in pref if not up[b]]
        if alive:
            home = alive[0]
            if load[home] >= spill_depth_default():
                spill = min((b for b in alive if b != home), key=lambda b: load[b], default=None)
                if spill is not None and load[spill] < load[home]:
                    obs.metrics.inc("router.spill_planned")
                    order = [spill] + [b for b in order if b != spill]
        return order

    # --------------------------------------------------------- forwarding

    @staticmethod
    def _retry_hint(ex: RpcError):
        """The ``nemo-retry-after-s`` of an admission rejection, else None:
        a replica shedding load (spill) against a RESOURCE_EXHAUSTED that
        would fail anywhere (propagated)."""
        for k, v in ex.trailing_metadata() or ():
            if k == "nemo-retry-after-s":
                return v
        return None

    @staticmethod
    def _fwd_metadata(context) -> tuple:
        """The client's metadata (tenant, trace id), forwarded as it is."""
        return tuple(context.invocation_metadata() or ()) if context is not None else ()

    @staticmethod
    def _timeout_of(context) -> float | None:
        """The client's remaining time, or None when it set no deadline: the
        router imposes no bound of its own."""
        if context is not None:
            t = context.time_remaining()
            if t is not None and t > 0:
                return t
        return None

    @staticmethod
    def _abort_like(context, ex: RpcError, rpc: str):
        """A replica's terminal status, trailing metadata included (a
        retry-after hint survives the hop)."""
        tm = ex.trailing_metadata()
        if tm:
            context.set_trailing_metadata(tuple(tm))
        obs.metrics.inc(f"router.errors.{rpc}")
        context.abort(ex.code(), ex.details() or f"{rpc} failed on every replica")

    # ----------------------------------------------------- trace stitching

    @staticmethod
    def _trace_id_of(md: tuple) -> str | None:
        for k, v in md:
            if k == "nemo-trace-id":
                return v if isinstance(v, str) else v.decode("utf-8", "replace")
        return None

    @staticmethod
    def _stitch_trailing(tm, spans: list[dict]):
        """The router's forward spans merged into the replica's
        ``nemo-spans-bin`` payload (``Tracer.drain_spans`` dicts), so the
        tracing client adopts one stitched set; a payload past the cap
        rides without them."""
        if not spans:
            return tm
        out = []
        payload: list = []
        for k, v in tm or ():
            if k == "nemo-spans-bin":
                try:
                    payload = json.loads(v.decode("utf-8") if isinstance(v, bytes) else v)
                except ValueError:
                    payload = []
                continue
            out.append((k, v))
        blob = json.dumps(list(payload) + spans).encode("utf-8")
        if len(blob) <= _SPANS_MAX_BYTES:
            out.append(("nemo-spans-bin", blob))
        return tuple(out)

    def _forward_span(self, rpc: str, backend: str, start_us: int, dur_us: int, attempt: int) -> dict:
        """One router hop as a span, in the wire shape ``adopt`` reads; it
        also lands in the flight recorder's ring and any active tracer."""
        args = {"backend": backend, "attempt": attempt}
        obs.add_span(f"router:{rpc}", start_us, dur_us, args)
        return {"name": f"router:{rpc}", "ts": start_us, "dur": dur_us, "pid": os.getpid(),
                "tid": threading.get_ident(), "thread_name": threading.current_thread().name, "args": args}

    def call_unary(self, rpc: str, request: bytes, context, key: str | None = None, trailing_hook=None) -> bytes:
        """Forward one unary RPC: the plan, a spill off a shedding home, a
        jittered failover on UNAVAILABLE.  ``trailing_hook(tm, backend)``
        rewrites the trailing metadata before the relay (Health's fleet
        snapshot)."""
        obs.metrics.inc(f"router.requests.{rpc}")
        md = self._fwd_metadata(context)
        client_tid = self._trace_id_of(md)
        timeout = self._timeout_of(context)
        backoff = FAILOVER_POLICY.session()
        candidates = self.plan(key)
        last: RpcError | None = None
        for i, b in enumerate(candidates):
            try:
                ch = self._channel(b)
            except OSError:  # an unreachable replica: down, and the next is tried
                self._mark_down(b)
                obs.metrics.inc("router.failover")
                continue
            method = ch.unary(rpc, _raw, _raw)
            self._begin(b)
            try:
                start_us = time.perf_counter_ns() // 1000
                resp, call = method.with_call(request, timeout=timeout, metadata=md or None)
                dur_us = time.perf_counter_ns() // 1000 - start_us
                tm = tuple(call.trailing_metadata() or ())
                span = self._forward_span(rpc, b, start_us, dur_us, i)
                if client_tid is not None:
                    tm = self._stitch_trailing(tm, [span])
                if trailing_hook is not None:
                    tm = trailing_hook(tm, b)
                if tm and context is not None:
                    context.set_trailing_metadata(tuple(tm))
                obs.metrics.inc(f"router.routed.{rpc}")
                if i > 0:
                    obs.metrics.inc("router.rerouted")
                return resp
            except RpcError as ex:
                code = ex.code()
                if code == StatusCode.UNAVAILABLE and i + 1 < len(candidates):
                    self._mark_down(b)
                    obs.metrics.inc("router.failover")
                    last = ex
                    wait = backoff.delay()
                    if wait is None:
                        break
                    time.sleep(wait)
                    continue
                if code == StatusCode.RESOURCE_EXHAUSTED and self._retry_hint(ex) is not None and (
                        i + 1 < len(candidates)):
                    # The home is shedding: the next candidate, not a bounce.
                    obs.metrics.inc("router.spill")
                    last = ex
                    continue
                self._abort_like(context, ex, rpc)
            finally:
                self._end(b)
        if last is not None:
            self._abort_like(context, last, rpc)
        obs.metrics.inc(f"router.errors.{rpc}")
        context.abort(StatusCode.UNAVAILABLE, f"no replica reachable for {rpc}")

    def call_server_stream(self, rpc: str, request: bytes, context, key: str | None = None):
        """Forward a server stream; failover only before its first message
        (after one, a replay would repeat it)."""
        obs.metrics.inc(f"router.requests.{rpc}")
        md = self._fwd_metadata(context)
        client_tid = self._trace_id_of(md)
        timeout = self._timeout_of(context)
        backoff = FAILOVER_POLICY.session()
        candidates = self.plan(key)
        last: RpcError | None = None
        for b in candidates:
            try:
                ch = self._channel(b)
            except OSError:  # an unreachable replica: down, and the next is tried
                self._mark_down(b)
                obs.metrics.inc("router.failover")
                continue
            method = ch.stream(rpc, "unary_stream", _raw, _raw)
            self._begin(b)
            got_any = False
            try:
                start_us = time.perf_counter_ns() // 1000
                stream = method(request, timeout=timeout, metadata=md or None)
                for item in stream:
                    got_any = True
                    yield item
                dur_us = time.perf_counter_ns() // 1000 - start_us
                tm = tuple(stream.trailing_metadata() or ())
                span = self._forward_span(rpc, b, start_us, dur_us, 0)
                if client_tid is not None:
                    tm = self._stitch_trailing(tm, [span])
                if tm and context is not None:
                    context.set_trailing_metadata(tuple(tm))
                obs.metrics.inc(f"router.routed.{rpc}")
                return
            except RpcError as ex:
                if not got_any and ex.code() == StatusCode.UNAVAILABLE:
                    self._mark_down(b)
                    obs.metrics.inc("router.failover")
                    last = ex
                    wait = backoff.delay()
                    if wait is None:
                        break
                    time.sleep(wait)
                    continue
                self._abort_like(context, ex, rpc)
            finally:
                self._end(b)
        if last is not None:
            self._abort_like(context, last, rpc)
        obs.metrics.inc(f"router.errors.{rpc}")
        context.abort(StatusCode.UNAVAILABLE, f"no replica reachable for {rpc}")

    def call_stream_stream(self, rpc: str, request_iterator, context):
        """Forward a bidirectional stream to the least-loaded live replica,
        with no failover: the requests are consumed as they go, so a replay
        would dispatch twice; the client's own replay-safe retry covers the
        cold window."""
        obs.metrics.inc(f"router.requests.{rpc}")
        md = self._fwd_metadata(context)
        timeout = self._timeout_of(context)
        for b in self.plan(None):
            try:
                ch = self._channel(b)
            except OSError:  # an unreachable replica: down, and the next is tried
                self._mark_down(b)
                obs.metrics.inc("router.failover")
                continue
            method = ch.stream(rpc, "stream_stream", _raw, _raw)
            self._begin(b)
            try:
                stream = method(request_iterator, timeout=timeout, metadata=md or None)
                yield from stream
                tm = stream.trailing_metadata()
                if tm and context is not None:
                    context.set_trailing_metadata(tuple(tm))
                obs.metrics.inc(f"router.routed.{rpc}")
                return
            except RpcError as ex:
                self._abort_like(context, ex, rpc)
            finally:
                self._end(b)
        obs.metrics.inc(f"router.errors.{rpc}")
        context.abort(StatusCode.UNAVAILABLE, f"no replica reachable for {rpc}")


def _dir_key_of(request: bytes) -> str | None:
    """The routing key of an AnalyzeDir or AnalyzeDirStream JSON request
    (the one look the router takes inside a request).  An unreadable one
    routes by load, and the replica answers INVALID_ARGUMENT."""
    try:
        doc = json.loads(bytes(request).decode("utf-8"))
    except ValueError:  # not JSON (UnicodeDecodeError is one)
        return None
    if not isinstance(doc, dict):
        return None
    d = doc.get("dir")
    if not d:
        dirs = doc.get("dirs")
        d = dirs[0] if isinstance(dirs, list) and dirs else None
    return route_key(d) if isinstance(d, str) and d else None


def router_methods(router: Router) -> dict:
    """The router's method table: name -> (kind, handler(request, context)),
    the NemoAnalysis surface a replica serves, over raw bytes."""

    def unary(rpc: str, keyed: bool = False, trailing_hook=None):
        def handler(request: bytes, context):
            key = _dir_key_of(request) if keyed else None
            return router.call_unary(rpc, request, context, key=key, trailing_hook=trailing_hook)

        return "unary_unary", handler

    def server_stream(rpc: str):
        def handler(request: bytes, context):
            yield from router.call_server_stream(rpc, request, context, key=_dir_key_of(request))

        return "unary_stream", handler

    return {
        "Health": unary("Health", trailing_hook=router.fleet_health_trailing),
        "Analyze": unary("Analyze"),
        "Kernel": unary("Kernel"),
        "AnalyzeDir": unary("AnalyzeDir", keyed=True),
        "AnalyzeDirStream": server_stream("AnalyzeDirStream"),
        "AnalyzeStream": ("stream_stream", lambda it, ctx: router.call_stream_stream("AnalyzeStream", it, ctx)),
    }


class RouterLoopback(Loopback):
    """The router called in this process, as ``server.Loopback`` calls a
    replica (``call``, ``stream``), its requests and responses as the bytes
    they are.  A client's channel takes it as a target; ``name`` names it
    to a router above it and to the logs."""

    def __init__(self, router: Router, name: str = "router") -> None:
        self.router = router
        self.name = name
        self._methods = router_methods(router)

    def _method(self, name: str) -> tuple:
        kind, handler = self._methods[name]
        return kind, bytes, handler, _raw


def make_router_server(port: int, backends: list, max_workers: int = 64, vnodes: int = 64):
    """Build (not start) the router's gRPC server on 127.0.0.1, the
    NemoAnalysis surface with no (de)serializers, so every handler sees
    and forwards raw bytes; the router's Health poll is started.  Returns
    (server, bound port, router).  Imports grpc."""
    from concurrent import futures

    import grpc

    from nemo_tpu_torch.service.server import _GrpcContext

    router = Router(backends, vnodes=vnodes)
    router.start()
    makers = {
        "unary_unary": grpc.unary_unary_rpc_method_handler,
        "unary_stream": grpc.unary_stream_rpc_method_handler,
        "stream_stream": grpc.stream_stream_rpc_method_handler,
    }
    handlers = {}
    for name, (kind, handler) in router_methods(router).items():
        def bound(request, ctx, handler=handler):
            return handler(request, _GrpcContext(grpc, ctx))

        handlers[name] = makers[kind](bound)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_receive_message_length", 1 << 30),
            ("grpc.max_send_message_length", 1 << 30),
            ("grpc.max_metadata_size", 2 << 20),
        ],
    )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
    bound_port = server.add_insecure_port(f"127.0.0.1:{port}")
    return server, bound_port, router
