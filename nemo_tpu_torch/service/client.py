"""The sidecar's client: packs on this host, analyzes on the sidecar's card.

A port of the JAX package's ``service/client.py``.  A target is a
``host:port`` string, which means gRPC (``grpc`` is imported then, and its
absence raises), or an in-process one: a
:class:`~nemo_tpu_torch.service.server.Loopback`, which calls the server's
method table through the same request and response bytes, or a router's
(:class:`~nemo_tpu_torch.serve.router.RouterLoopback`).  Nothing turns one
into the other.  A replica's name is its ``host:port`` or its loopback's
``name``.

Failure handling: a health-gated connect with a deadline, bounded retries
with jittered exponential backoff on UNAVAILABLE and on the server's
admission throttle (``nemo-retry-after-s``), under one total budget
(utils/backoff.py:RPC_POLICY), and chunk ordinals checked on receipt.
Every failed call raises :class:`~nemo_tpu_torch.service.server.RpcError`
(code, details, trailing metadata), whichever the transport.

The uploads travel in the packed dtypes as they are: unlike the JAX
client, this one does not narrow int32 planes to int8 or int16.
"""

from __future__ import annotations

import json as _json
import os
import time
from dataclasses import dataclass

import numpy as np

from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import log as obs_log
from nemo_tpu_torch.service import codec
from nemo_tpu_torch.service import wire as pb
from nemo_tpu_torch.service.server import SERVICE, RpcError, StatusCode
from nemo_tpu_torch.utils.backoff import RPC_POLICY

_log = obs_log.get_logger("nemo.client")

#: The cross-run reductions of the fused step, recomputed when chunks merge.
CORPUS_REDUCTIONS = {"proto_inter": "and", "proto_union": "or"}


class SidecarError(RuntimeError):
    pass


def _trace_metadata() -> tuple | None:
    """Outgoing metadata carrying this process's trace id, or None when
    tracing is off; the sidecar answers with its spans (``_adopt_remote``)."""
    tid = obs.trace_id()
    if tid is None:
        return None
    return (("nemo-trace-id", tid),)


def _metadata_value(md, key: str):
    for k, v in md or ():
        if k == key:
            return v
    return None


def _adopt_remote(call) -> None:
    """Merge the sidecar's spans (trailing metadata) into the local trace."""
    t = obs.tracer()
    if t is None:
        return
    raw = _metadata_value(call.trailing_metadata(), "nemo-spans-bin")
    if not raw:
        return
    try:
        spans = _json.loads(raw.decode("utf-8") if isinstance(raw, bytes) else raw)
    except (ValueError, UnicodeDecodeError):
        return
    t.adopt(spans, process_name="nemo-sidecar")


# ------------------------------------------------------------- transports


def _status(grpc_mod, ex) -> RpcError:
    """A grpc.RpcError as the port's RpcError (codes mapped by name)."""
    code = getattr(StatusCode, ex.code().name, StatusCode.UNKNOWN)
    try:
        trailing = tuple(ex.trailing_metadata() or ())
    except Exception:  # lint: allow-silent-except — a call that failed before the server answered has none
        trailing = ()
    return RpcError(code, ex.details() or "", trailing)


class _Stream:
    """A response stream: decoded messages, failures as RpcError, and the
    trailing metadata once it is drained."""

    def __init__(self, it, trailing, convert) -> None:
        self._it = it
        self._trailing = trailing
        self._convert = convert

    def __iter__(self):
        try:
            yield from self._it
        except RpcError:
            raise
        except Exception as ex:
            err = self._convert(ex)
            if err is None:
                raise
            raise err from ex

    def trailing_metadata(self) -> tuple:
        return tuple(self._trailing() or ())


class _GrpcChannel:
    """The gRPC transport of a ``host:port`` target."""

    def __init__(self, target: str) -> None:
        import grpc

        self._grpc = grpc
        self._ch = grpc.insecure_channel(
            target,
            options=[
                ("grpc.max_receive_message_length", 1 << 30),
                ("grpc.max_send_message_length", 1 << 30),
                # The sidecar's span trailing metadata can reach ~1 MB.
                ("grpc.max_metadata_size", 2 << 20),
            ],
        )

    def _convert(self, ex):
        return _status(self._grpc, ex) if isinstance(ex, self._grpc.RpcError) else None

    def unary(self, name: str, ser, deser):
        m = self._ch.unary_unary(f"/{SERVICE}/{name}", request_serializer=ser, response_deserializer=deser)
        channel = self

        class Unary:
            def with_call(self, request, timeout=None, metadata=None):
                try:
                    return m.with_call(request, timeout=timeout, metadata=metadata)
                except channel._grpc.RpcError as ex:
                    raise _status(channel._grpc, ex) from ex

            def __call__(self, request, timeout=None, metadata=None):
                return self.with_call(request, timeout, metadata)[0]

        return Unary()

    def stream(self, name: str, kind: str, ser, deser):
        make = self._ch.unary_stream if kind == "unary_stream" else self._ch.stream_stream
        m = make(f"/{SERVICE}/{name}", request_serializer=ser, response_deserializer=deser)

        def call(request, timeout=None, metadata=None):
            try:
                it = m(request, timeout=timeout, metadata=metadata)
            except self._grpc.RpcError as ex:
                raise _status(self._grpc, ex) from ex
            return _Stream(it, it.trailing_metadata, self._convert)

        return call

    def close(self) -> None:
        self._ch.close()


class _LoopbackChannel:
    """The in-process transport: the server's method table through
    :class:`~nemo_tpu_torch.service.server.Loopback`, bytes both ways.  A
    handler's failure other than an abort is UNKNOWN, as gRPC reports
    it."""

    def __init__(self, loopback) -> None:
        self._lb = loopback

    @staticmethod
    def _convert(ex):
        if isinstance(ex, RpcError):
            return None
        return RpcError(StatusCode.UNKNOWN, f"Exception calling application: {type(ex).__name__}: {ex}")

    def unary(self, name: str, ser, deser):
        lb, convert = self._lb, self._convert

        class Unary:
            def with_call(self, request, timeout=None, metadata=None):
                try:
                    raw, ctx = lb.call(name, ser(request), metadata)
                except RpcError:
                    raise
                except Exception as ex:
                    raise convert(ex) from ex
                return deser(raw), ctx

            def __call__(self, request, timeout=None, metadata=None):
                return self.with_call(request, timeout, metadata)[0]

        return Unary()

    def stream(self, name: str, kind: str, ser, deser):
        def call(request, timeout=None, metadata=None):
            payload = ser(request) if kind == "unary_stream" else (ser(r) for r in request)
            gen, ctx = self._lb.stream(name, payload, metadata)
            return _Stream((deser(b) for b in gen), ctx.trailing_metadata, self._convert)

        return call

    def close(self) -> None:
        pass


def _channel(target):
    if isinstance(target, str):
        return _GrpcChannel(target)
    return _LoopbackChannel(target)


def _target_name(target) -> str:
    return target if isinstance(target, str) else target.name


def _json_bytes(d) -> bytes:
    return _json.dumps(d).encode("utf-8")


def _json_obj(b: bytes):
    return _json.loads(bytes(b).decode("utf-8"))


@dataclass
class RemoteAnalyzer:
    """A retrying client of the NemoAnalysis service.  ``tenant`` names
    this client to the sidecar's admission controller (``nemo-tenant``
    metadata); default ``$NEMO_TENANT`` or the shared anonymous tenant."""

    target: object = "127.0.0.1:50051"
    timeout: float = 300.0
    retries: int = 3
    tenant: str | None = None

    def __post_init__(self):
        if self.tenant is None:
            self.tenant = os.environ.get("NEMO_TENANT") or None
        self._channel = _channel(self.target)
        ch = self._channel
        self._health = ch.unary("Health", pb.HealthRequest.SerializeToString, pb.HealthResponse.FromString)
        self._analyze = ch.unary("Analyze", pb.AnalyzeRequest.SerializeToString, pb.AnalyzeResponse.FromString)
        self._analyze_stream = ch.stream("AnalyzeStream", "stream_stream", pb.AnalyzeRequest.SerializeToString,
                                         pb.AnalyzeResponse.FromString)
        self._kernel = ch.unary("Kernel", pb.KernelRequest.SerializeToString, pb.KernelResponse.FromString)
        self._analyze_dir = ch.unary("AnalyzeDir", _json_bytes, pb.AnalyzeResponse.FromString)
        self._query = ch.unary("Query", _json_bytes, _json_obj)
        self._analyze_dir_stream = ch.stream("AnalyzeDirStream", "unary_stream", _json_bytes, _json_obj)

    @property
    def target_name(self) -> str:
        return _target_name(self.target)

    def close(self) -> None:
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- health

    def health(self, timeout: float = 10.0) -> dict:
        resp, call = self._call(self._health, pb.HealthRequest(), timeout, name="Health")
        out = {"platform": resp.platform, "device_count": resp.device_count, "version": resp.version}
        # The sidecar's metrics snapshot rides the trailing metadata.
        raw = _metadata_value(call.trailing_metadata(), "nemo-metrics-bin")
        if raw:
            out["metrics"] = _json.loads(raw.decode("utf-8") if isinstance(raw, bytes) else raw)
        return out

    def wait_ready(self, deadline: float = 30.0) -> dict:
        """Poll Health until the sidecar answers (the startup gate): one
        attempt per poll, the loop is the retry policy."""
        end = time.monotonic() + deadline
        last: Exception | None = None
        while time.monotonic() < end:
            try:
                resp = self._health(pb.HealthRequest(), timeout=2.0)
                return {"platform": resp.platform, "device_count": resp.device_count, "version": resp.version}
            except RpcError as ex:
                last = ex
                time.sleep(0.2)
        raise SidecarError(f"sidecar not ready after {deadline}s: {last}")

    def _request_metadata(self) -> tuple | None:
        md = _trace_metadata() or ()
        if self.tenant:
            md = md + (("nemo-tenant", self.tenant),)
        return md or None

    def _call(self, method, request, timeout: float | None = None, name: str = "rpc"):
        """One unary RPC with bounded retries; returns (response, call).
        UNAVAILABLE and the admission throttle (RESOURCE_EXHAUSTED with a
        ``nemo-retry-after-s`` hint, counted ``rpc.throttled``) retry under
        RPC_POLICY, the hint replacing the exponential term; past the
        budget the last error raises.  RESOURCE_EXHAUSTED without the hint
        (a message over the channel cap) raises at once."""
        backoff = RPC_POLICY.session()
        md = self._request_metadata()
        for attempt in range(self.retries):
            try:
                t0 = time.perf_counter()
                with obs.span(f"rpc:{name}", target=self.target_name, attempt=attempt, trace_id=obs.trace_id()):
                    resp, call = method.with_call(request, timeout=timeout or self.timeout, metadata=md)
                dt = time.perf_counter() - t0
                obs.metrics.inc(f"rpc.calls.{name}")
                obs.metrics.observe(f"rpc.latency_s.{name}", dt)
                slow_ms = obs_log.slow_dispatch_ms()
                if slow_ms and dt * 1000.0 > slow_ms:
                    obs.metrics.inc("watchdog.slow_rpc")
                    _log.warning("rpc.slow", rpc=name, target=self.target_name, wall_ms=round(dt * 1000.0, 1),
                                 threshold_ms=slow_ms,
                                 request_bytes=request.ByteSize() if hasattr(request, "ByteSize")
                                 else len(_json_bytes(request)), attempt=attempt)
                _adopt_remote(call)
                return resp, call
            except RpcError as ex:
                code = ex.code()
                retry_after = None
                if code == StatusCode.RESOURCE_EXHAUSTED:
                    raw = _metadata_value(ex.trailing_metadata(), "nemo-retry-after-s")
                    try:
                        retry_after = float(raw) if raw else None
                    except ValueError:
                        retry_after = None
                throttled = retry_after is not None
                if (code != StatusCode.UNAVAILABLE and not throttled) or attempt == self.retries - 1:
                    obs.metrics.inc("rpc.errors")
                    raise
                wait = backoff.delay(hint_s=retry_after if throttled else None)
                if wait is None:
                    obs.metrics.inc("rpc.errors")
                    obs.metrics.inc("rpc.retry_budget_exhausted")
                    _log.warning("rpc.retry_budget_exhausted", rpc=name, target=self.target_name,
                                 spent_s=round(backoff.spent_s, 1))
                    raise
                if throttled:
                    obs.metrics.inc("rpc.throttled")
                    _log.info("rpc.throttled", rpc=name, target=self.target_name, retry_after_s=round(wait, 2),
                              attempt=attempt)
                else:
                    obs.metrics.inc("rpc.retries")
                obs.metrics.inc("rpc.backoff_s", wait)
                time.sleep(wait)
        raise SidecarError("unreachable")

    # ------------------------------------------------------------- kernel

    def kernel(self, verb: str, arrays: dict, params: dict) -> dict[str, np.ndarray]:
        """One named verb on the sidecar (the ServiceBackend's path)."""
        req = codec.kernel_request_to_pb(verb, arrays, params)
        obs.metrics.inc("rpc.bytes_sent", req.ByteSize())
        resp, _ = self._call(self._kernel, req, name="Kernel")
        obs.metrics.inc("rpc.bytes_received", resp.ByteSize())
        return codec.kernel_response_from_pb(resp)

    # ------------------------------------------------------------ analyze

    @staticmethod
    def _analyze_request(pre, post, static: dict, chunk: int = 0) -> pb.AnalyzeRequest:
        return pb.AnalyzeRequest(pre=codec.batch_arrays_to_pb(pre), post=codec.batch_arrays_to_pb(post),
                                 static=codec.static_to_pb(static), chunk=chunk)

    def analyze(self, pre, post, static: dict) -> dict[str, np.ndarray]:
        """One fused step, with its diff tail, on the sidecar's device."""
        req = self._analyze_request(pre, post, static)
        obs.metrics.inc("rpc.bytes_sent", req.ByteSize())
        resp, _ = self._call(self._analyze, req, name="Analyze")
        obs.metrics.inc("rpc.bytes_received", resp.ByteSize())
        return codec.outputs_from_pb(resp)

    def analyze_dir_remote(self, molly_dir: str, corpus_cache: str | None = None,
                           result_cache: str | None = None) -> dict[str, np.ndarray]:
        """Server-side corpus analysis: only the directory's path travels;
        the sidecar ingests it through its own corpus store, or answers
        from its result cache (no dispatch) when the stored corpus is
        unchanged.  ``corpus_cache``/``result_cache`` can only opt out
        (``"off"``) for this request."""
        req: dict = {"dir": os.path.abspath(molly_dir)}
        if corpus_cache is not None:
            req["corpus_cache"] = corpus_cache
        if result_cache is not None:
            req["result_cache"] = result_cache
        obs.metrics.inc("rpc.bytes_sent", len(_json_bytes(req)))
        resp, call = self._call(self._analyze_dir, req, name="AnalyzeDir")
        obs.metrics.inc("rpc.bytes_received", resp.ByteSize())
        trailing = dict(call.trailing_metadata() or ())
        status = trailing.get("nemo-rcache")
        if status:
            obs.metrics.inc(f"rpc.analyze_dir_rcache.{status}")
            if status == "hit":
                _log.info("rpc.analyze_dir_cached", dir=molly_dir, target=self.target_name)
        coalesce = trailing.get("nemo-coalesce")
        if coalesce:
            obs.metrics.inc(f"rpc.analyze_dir_coalesce.{coalesce}")
        fleet = trailing.get("nemo-fleet")
        if fleet:
            # The cross-replica single flight: "leader" ran the fleet's one
            # analysis, "follower" relayed another replica's.
            obs.metrics.inc(f"rpc.analyze_dir_fleet.{fleet}")
        return codec.outputs_from_pb(resp)

    def query_remote(self, molly_dir: str, query: str, corpus_cache: str | None = None,
                     result_cache: str | None = None) -> dict:
        """One ad-hoc query run on the sidecar: the directory's path and the
        query text travel, the result document comes back.  A malformed
        query raises INVALID_ARGUMENT with the parser's message."""
        req: dict = {"dir": os.path.abspath(molly_dir), "query": query}
        if corpus_cache is not None:
            req["corpus_cache"] = corpus_cache
        if result_cache is not None:
            req["result_cache"] = result_cache
        obs.metrics.inc("rpc.bytes_sent", len(_json_bytes(req)))
        doc, call = self._call(self._query, req, name="Query")
        obs.metrics.inc("rpc.bytes_received", len(_json_bytes(doc)))
        trailing = dict(call.trailing_metadata() or ())
        status = trailing.get("nemo-rcache")
        if status:
            obs.metrics.inc(f"rpc.query_rcache.{status}")
        coalesce = trailing.get("nemo-coalesce")
        if coalesce:
            obs.metrics.inc(f"rpc.query_coalesce.{coalesce}")
        return doc

    def analyze_dir_stream(self, molly_dirs, corpus_cache=None, result_cache=None, watch=None):
        """The server-streaming corpus analysis: yields the sidecar's JSON
        events in arrival order (server.py:analyze_dir_stream), ``result``
        events with the decoded ``outputs`` in place of the raw payload.
        ``watch`` (a dict of watch options) follows a live sweep instead.
        A stream that fails with UNAVAILABLE before its first event is
        restarted under RPC_POLICY; later failures raise."""
        import base64

        if isinstance(molly_dirs, str):
            molly_dirs = [molly_dirs]
        req: dict = {"dirs": [os.path.abspath(d) for d in molly_dirs]}
        if corpus_cache is not None:
            req["corpus_cache"] = corpus_cache
        if result_cache is not None:
            req["result_cache"] = result_cache
        if watch is not None:
            req["watch"] = watch
        obs.metrics.inc("rpc.bytes_sent", len(_json_bytes(req)))
        md = self._request_metadata()
        backoff = RPC_POLICY.session()
        while True:
            got_any = False
            try:
                with obs.span("rpc:AnalyzeDirStream", target=self.target_name, dirs=len(req["dirs"])):
                    stream = self._analyze_dir_stream(req, timeout=self.timeout, metadata=md)
                    for ev in stream:
                        got_any = True
                        obs.metrics.inc("rpc.stream_events")
                        if ev.get("event") == "result":
                            payload = base64.b64decode(ev.pop("response_b64"))
                            obs.metrics.inc("rpc.bytes_received", len(payload))
                            ev["outputs"] = codec.outputs_from_pb(pb.AnalyzeResponse.FromString(payload))
                        yield ev
                    _adopt_remote(stream)
                return
            except RpcError as ex:
                wait = backoff.delay()
                if got_any or ex.code() != StatusCode.UNAVAILABLE or wait is None:
                    obs.metrics.inc("rpc.errors")
                    raise
                obs.metrics.inc("rpc.retries")
                obs.metrics.inc("rpc.backoff_s", wait)
                time.sleep(wait)

    def _drive_stream(self, requests_iter, out: list) -> None:
        """One AnalyzeStream call: one ``rpc:AnalyzeStream`` span, trace and
        tenant metadata, each response's chunk ordinal checked into
        ``out``, the sidecar's spans adopted at the end."""
        n = len(out)
        with obs.span("rpc:AnalyzeStream", target=self.target_name, chunks=n):
            stream = self._analyze_stream(requests_iter, timeout=self.timeout, metadata=self._request_metadata())
            for resp in stream:
                if not 0 <= resp.chunk < n:
                    raise SidecarError(f"bad chunk ordinal {resp.chunk}")
                out[resp.chunk] = codec.outputs_from_pb(resp)
            _adopt_remote(stream)

    def analyze_chunks(self, chunks: list[tuple[object, object, dict]]) -> list[dict[str, np.ndarray]]:
        """Chunks through the bidirectional stream; per-chunk outputs in
        submission order.  A stream that fails with UNAVAILABLE before any
        chunk landed is replayed under RPC_POLICY (after one, replaying
        would dispatch twice)."""

        def requests():
            for i, (pre, post, static) in enumerate(chunks):
                yield self._analyze_request(pre, post, static, chunk=i)

        backoff = RPC_POLICY.session()
        while True:
            out: list = [None] * len(chunks)
            try:
                self._drive_stream(requests(), out)
                break
            except RpcError as ex:
                wait = backoff.delay()
                if ex.code() != StatusCode.UNAVAILABLE or any(o is not None for o in out) or wait is None:
                    obs.metrics.inc("rpc.errors")
                    raise
                obs.metrics.inc("rpc.retries")
                obs.metrics.inc("rpc.backoff_s", wait)
                time.sleep(wait)
        missing = [i for i, o in enumerate(out) if o is None]
        if missing:
            raise SidecarError(f"missing responses for chunks {missing}")
        return out


class RemoteExecutor:
    """``TorchExecutor``'s surface over the sidecar's Kernel RPC: the same
    (verb, arrays, params) contract, the same counts (``dispatches``,
    ``wall_s``, ``host_runs``, ``count_host``) and attributes (``device``,
    ``shard``, ``last_dispatch_cold``).  The outputs land on this host:
    ``device`` is the CPU, and the verb's ``ON_DEVICE`` outputs come back
    as CPU tensors, the rest as numpy, as TorchExecutor returns them.  The
    sidecar's device is ``remote_platform`` (Health's).  Owns its
    RemoteAnalyzer; ``close()`` releases the channel."""

    #: The wire's cap on one message (both channels' max message length).
    MAX_MESSAGE_BYTES = 1 << 30

    def __init__(self, target="127.0.0.1:50051", ready_deadline: float = 30.0) -> None:
        import threading

        import torch

        self.target = target
        self._client = RemoteAnalyzer(target=target)
        try:
            health = self._client.wait_ready(ready_deadline)
        except BaseException:
            self._client.close()
            raise
        self.remote_platform = health["platform"]
        self.device = torch.device("cpu")
        self.shard = "off"
        self.dispatches: dict[str, int] = {}
        self.wall_s: dict[str, float] = {}
        self.host_runs: dict[str, int] = {}
        self._lock = threading.Lock()

    #: The sidecar's coldness is not carried by the wire.
    last_dispatch_cold = False

    def count_host(self, verb: str) -> None:
        """One host-lane run on this host, counted as TorchExecutor counts it."""
        with self._lock:
            self.host_runs[verb] = self.host_runs.get(verb, 0) + 1
        obs.metrics.inc(f"kernel.dispatches.{verb}")

    def _check_size(self, verb: str, arrays: dict, params: dict) -> None:
        """Refuse before encoding a call whose request or response would
        pass the wire's cap, with the remedy (the diff's dense [F,V,V]
        edge_keep and the fused steps' [B,V,V] planes dominate)."""

        def packed_bytes(a) -> int:
            a = np.asarray(a)
            return a.size // 8 if a.dtype == np.bool_ else a.nbytes

        est_req = sum(packed_bytes(v) for v in arrays.values() if v is not None)
        est_resp = 0
        if verb == "diff":
            f, v = int(np.shape(arrays["fail_bits"])[0]), int(params["v"])
            est_resp = (f * v * v + 3 * f * v) // 8
        elif verb in ("fused", "giant"):
            b, v = np.shape(arrays["pre_is_goal"])
            est_resp = 2 * b * v * v // 8 + 8 * b * v
        elif verb == "sparse_fused":
            b, v = np.shape(arrays["pre_is_goal"])
            e = int(np.shape(arrays["pre_edge_src"])[1])
            est_resp = 2 * b * (8 * e + e // 8) + 8 * b * v
        elif verb == "sparse_diff":
            f, v = int(np.shape(arrays["fail_bits"])[0]), int(params["v"])
            e = int(np.shape(arrays["edge_src"])[0])
            est_resp = f * (3 * v + e) // 8
        elif verb == "synth_ext":
            est_resp = int(np.shape(arrays["is_goal"])[0]) * int(params["num_tables"]) // 8
        est = max(est_req, est_resp)
        if est > self.MAX_MESSAGE_BYTES:
            raise SidecarError(
                f"kernel {verb!r} would move ~{est >> 20} MiB in one message (request ~{est_req >> 20}, response "
                f"~{est_resp >> 20}), above the {self.MAX_MESSAGE_BYTES >> 20} MiB cap; split the corpus "
                "(max_batch) or stream it (service.client.analyze_dir_pipelined)")

    def run(self, verb: str, arrays: dict, params: dict, rows: int | None = None) -> dict:
        """``rows`` is the caller's real-run count, a cost hint the wire
        does not carry (the sidecar counts the dispatched width)."""
        import torch

        from nemo_tpu_torch.backend.torch_backend import TorchExecutor

        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in arrays.items() if v is not None}
        self._check_size(verb, host, params)
        t0 = time.perf_counter()
        try:
            out = self._client.kernel(verb, host, params)
        finally:
            with self._lock:
                self.dispatches[verb] = self.dispatches.get(verb, 0) + 1
                self.wall_s[verb] = self.wall_s.get(verb, 0.0) + time.perf_counter() - t0
        keep = TorchExecutor.ON_DEVICE.get(verb, frozenset())
        return {k: (torch.from_numpy(np.array(a)) if k in keep else a) for k, a in out.items()}

    def close(self) -> None:
        self._client.close()


# ------------------------------------------------------- chunked analysis


def _stream_pipelined(target, n_chunks: int, chunk_iter, timings: dict, queue_depth: int = 2,
                      ready_deadline: float = 30.0, threaded: bool = True) -> list[dict[str, np.ndarray]]:
    """The producer/consumer core of the pipelined paths.  ``chunk_iter``
    yields (i, pre, post, static) packed on demand.  Threaded, a daemon
    producer fills a bounded queue (``queue_depth``: the host-memory bound)
    so chunk k+1 packs while chunk k runs on the sidecar; unthreaded (one
    core), the stream pulls each chunk from the iterator itself.  A stream
    that dies mid-flight sets the abort flag and drains the queue, so the
    producer never blocks forever; a producer failure raises chained, also
    when it comes after the last chunk was answered."""
    import queue
    import threading

    prod_exc: list[BaseException] = []
    results: list = [None] * n_chunks

    def _request_of(item):
        i, pre, post, static = item
        return RemoteAnalyzer._analyze_request(pre, post, static, chunk=i)

    def _finish() -> list[dict[str, np.ndarray]]:
        if prod_exc:
            raise SidecarError(f"producer failed after streaming completed: {prod_exc[0]!r}") from prod_exc[0]
        missing = [i for i, o in enumerate(results) if o is None]
        if missing:
            raise SidecarError(f"missing responses for chunks {missing}")
        return results

    def _drive(requests_iter) -> None:
        with RemoteAnalyzer(target=target) as client:
            client.wait_ready(ready_deadline)
            t0 = time.perf_counter()
            client._drive_stream(requests_iter, results)
            timings["stream_s"] = time.perf_counter() - t0

    if not threaded:
        def requests_inline():
            try:
                for item in chunk_iter:
                    yield _request_of(item)
            except Exception as ex:  # surfaced after the stream ends
                prod_exc.append(ex)

        try:
            _drive(requests_inline())
        except Exception:
            if prod_exc:
                raise SidecarError(f"producer failed while streaming: {prod_exc[0]!r}") from prod_exc[0]
            raise
        return _finish()

    q: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
    abort = threading.Event()
    end = object()

    def emit(item) -> bool:
        while not abort.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in chunk_iter:
                if not emit(item):
                    return
        except Exception as ex:  # surfaced in the consumer
            prod_exc.append(ex)
            emit(ex)
        finally:
            emit(end)

    thread = threading.Thread(target=producer, daemon=True, name="nemo-pack")
    thread.start()

    def requests():
        while True:
            item = q.get()
            if item is end or abort.is_set():
                return
            if isinstance(item, BaseException):
                raise item
            yield _request_of(item)

    try:
        _drive(requests())
    except Exception:
        if prod_exc:
            raise SidecarError(f"producer failed while streaming: {prod_exc[0]!r}") from prod_exc[0]
        raise
    finally:
        abort.set()
        # Unblock a producer stuck in put, then make sure the end marker is
        # in the queue for a consumer blocked in get.
        while True:
            try:
                q.put_nowait(end)
                break
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    continue
        thread.join(timeout=5.0)
    if thread.is_alive():
        raise SidecarError("producer thread still running after streaming completed (join timed out); result "
                           "discarded as unverifiable")
    return _finish()


def _pack_steps(corpus_dir: str):
    """(pre, post, static) of a corpus as host planes: a Molly directory
    by the engine, or mapped from a warm corpus store
    (ingest/native.py:pack_molly_dir_host); another layout through its
    injector's loader and the Python pack, on the CPU."""
    from nemo_tpu_torch.ingest.adapters import resolve_injector
    from nemo_tpu_torch.ingest.native import pack_molly_dir_host, packed_host_available
    from nemo_tpu_torch.models.pipeline_model import pack_molly_for_step

    injector = resolve_injector(corpus_dir)
    if type(injector).native_capable and packed_host_available(corpus_dir):
        corpus, static = pack_molly_dir_host(corpus_dir)
        return corpus.pre, corpus.post, static
    return pack_molly_for_step(injector.load(corpus_dir), device="cpu")


def analyze_dirs(target, molly_dirs: list[str], queue_depth: int = 2
                 ) -> tuple[list[dict[str, np.ndarray]], dict[str, float]]:
    """Several corpora through one stream, each packed by a producer thread
    (through its injector) while the one before it runs on the sidecar.
    Returns (outputs per directory, timings: pack_s, stream_s, wall_s and
    whether the packing overlapped; on one core it packs inline)."""
    t_wall0 = time.perf_counter()
    overlap = (os.cpu_count() or 1) > 1
    timings = {"pack_s": 0.0, "stream_s": 0.0, "wall_s": 0.0, "overlap": overlap}

    def chunks():
        for i, d in enumerate(molly_dirs):
            t0 = time.perf_counter()
            with obs.span("pack:dir", ordinal=i):
                pre, post, static = _pack_steps(d)
            timings["pack_s"] += time.perf_counter() - t0
            yield (i, pre, post, static)

    results = _stream_pipelined(target, len(molly_dirs), chunks(), timings, queue_depth, threaded=overlap)
    timings["wall_s"] = time.perf_counter() - t_wall0
    return results, timings


def _uniform_spans(n: int, chunk_runs: int) -> tuple[list[tuple[int, int]], int]:
    """(spans, pad_to): row spans such that every chunk's dispatch has
    pad_to rows: chunk 0 is rows [0, chunk_runs) (row 0 is the corpus
    baseline), later chunks the baseline plus chunk_runs-1 new rows, a short
    tail padded with baseline copies.  pad_to 0: no padding (one span, or
    chunk_runs 1, which has no room for the baseline)."""
    if n <= chunk_runs:
        return [(0, n)], 0
    if chunk_runs <= 1:
        return [(s, s + 1) for s in range(n)], 0
    spans = [(0, chunk_runs)]
    s = chunk_runs
    while s < n:
        spans.append((s, min(s + chunk_runs - 1, n)))
        s = spans[-1][1]
    return spans, chunk_runs


def _chunk_rows(batch_like, s: int, e: int, with_baseline: bool, pad_to: int = 0):
    """Rows [s, e) of a batch (anything with the 8 packed fields) as host
    numpy planes, optionally with the baseline row 0 prepended and padded
    to pad_to rows with baseline copies (dropped by _merge_chunk_outputs)."""
    from types import SimpleNamespace

    from nemo_tpu_torch.models.pipeline_model import BatchArrays

    def cut(x):
        x = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
        out = np.concatenate([x[:1], x[s:e]]) if with_baseline else x[s:e]
        if pad_to and out.shape[0] < pad_to:
            out = np.concatenate([out, np.repeat(x[:1], pad_to - out.shape[0], axis=0)])
        return out

    return SimpleNamespace(**{f: cut(getattr(batch_like, f)) for f in BatchArrays.FIELDS})


def _merge_chunk_outputs(spans: list[tuple[int, int]], results: list[dict[str, np.ndarray]],
                         pad_to: int = 0) -> dict[str, np.ndarray]:
    """Per-chunk fused-step outputs -> the unchunked outputs.  Per-run rows
    pad their trailing dims to the widest chunk's (an append-only vocab:
    absent columns pad False/0, proto_min_depth DEPTH_INF), shed the tail
    pad rows and the prepended baseline of chunks after the first, and
    concatenate.  The cross-run reductions are recomputed from the merged
    proto_bits and achieved_pre (ops/proto.py:reduce_protos), not combined
    from the chunks' own."""
    from nemo_tpu_torch.ops.proto import DEPTH_INF

    unmerged = set(CORPUS_REDUCTIONS) & set(results[0]) - {"proto_inter", "proto_union"}
    if unmerged:
        raise SidecarError(f"no chunk-merge rule for reduction outputs {sorted(unmerged)}")
    pad_value = {"proto_min_depth": DEPTH_INF}
    merged: dict[str, np.ndarray] = {}
    for key in results[0]:
        if key in CORPUS_REDUCTIONS:
            continue
        arrs = [r[key] for r in results]
        trailing = tuple(max(a.shape[d] for a in arrs) for d in range(1, arrs[0].ndim))
        padded = []
        for a in arrs:
            if a.shape[1:] != trailing:
                wide = np.full((a.shape[0],) + trailing, pad_value.get(key, 0), dtype=a.dtype)
                wide[tuple(slice(0, s) for s in a.shape)] = a
                a = wide
            padded.append(a)
        rows = []
        for (s, e), r in zip(spans, padded):
            real = (e - s) + (1 if s > 0 else 0)
            expected = pad_to if pad_to else real
            if r.shape[0] != expected:
                raise SidecarError(f"output {key!r} is not per-run shaped (got leading dim {r.shape[0]}, batch "
                                   f"{expected}); register it in CORPUS_REDUCTIONS")
            rows.append(r[1:real] if s > 0 else r[:real])
        merged[key] = np.concatenate(rows, axis=0)
    bits = merged["proto_bits"].astype(bool)
    ach = merged["achieved_pre"].astype(bool)
    masked = bits & ach[:, None]
    merged["proto_inter"] = np.all(masked | ~ach[:, None], axis=0) & ach.any()
    merged["proto_union"] = np.any(masked, axis=0)
    return merged


def analyze_dir(target, molly_dir: str, chunk_runs: int = 0) -> dict[str, np.ndarray]:
    """Pack a sweep directory through its injector and analyze it on the
    sidecar, in one call or, with ``chunk_runs``, streamed in chunks
    merged back to the unchunked outputs (every chunk after the first
    carries the baseline row 0, which the fused step diffs against)."""
    pre, post, static = _pack_steps(molly_dir)
    b = int(np.shape(pre.is_goal)[0])
    with RemoteAnalyzer(target=target) as client:
        client.wait_ready()
        if not chunk_runs or chunk_runs >= b:
            return client.analyze(pre, post, static)
        spans, pad_to = _uniform_spans(b, chunk_runs)
        chunks = [(_chunk_rows(pre, s, e, s > 0, pad_to), _chunk_rows(post, s, e, s > 0, pad_to), static)
                  for s, e in spans]
        results = client.analyze_chunks(chunks)
    return _merge_chunk_outputs(spans, results, pad_to=pad_to)


def analyze_dir_pipelined(target, molly_dir: str, chunk_runs: int = 512, queue_depth: int = 2
                          ) -> tuple[dict[str, np.ndarray], dict[str, float]]:
    """One directory in chunks of ``chunk_runs`` runs, packed by a producer
    while earlier chunks run on the sidecar, merged as ``analyze_dir``'s
    chunked path.  A Molly directory is packed once by the engine (or
    mapped from a warm corpus store: ingest/native.py:pack_molly_dir_host)
    and chunked as host row slices; another layout is packed once through
    its injector.  Returns (merged outputs, timings as analyze_dirs')."""
    from nemo_tpu_torch.ingest.adapters import resolve_injector

    t_wall0 = time.perf_counter()
    overlap = (os.cpu_count() or 1) > 1
    timings = {"pack_s": 0.0, "stream_s": 0.0, "wall_s": 0.0, "overlap": overlap}
    injector = resolve_injector(molly_dir)
    n = injector.count_runs(molly_dir)
    if n == 0:
        raise SidecarError(f"no runs in {molly_dir} (empty {type(injector).index_file})")
    spans, pad_to = _uniform_spans(n, max(1, chunk_runs))

    def chunks():
        t0 = time.perf_counter()
        with obs.span("pack:corpus"):
            pre_b, post_b, static = _pack_steps(molly_dir)
        if int(np.shape(pre_b.is_goal)[0]) != n:
            raise SidecarError(f"the packed corpus has {np.shape(pre_b.is_goal)[0]} runs but the index has {n}")
        timings["pack_s"] += time.perf_counter() - t0
        for ci, (s, e) in enumerate(spans):
            t0 = time.perf_counter()
            with obs.span("pack:chunk", chunk=ci):
                chunk = (ci, _chunk_rows(pre_b, s, e, ci > 0, pad_to), _chunk_rows(post_b, s, e, ci > 0, pad_to),
                         static)
            timings["pack_s"] += time.perf_counter() - t0
            yield chunk

    results = _stream_pipelined(target, len(spans), chunks(), timings, queue_depth, threaded=overlap)
    merged = _merge_chunk_outputs(spans, results, pad_to=pad_to)
    timings["wall_s"] = time.perf_counter() - t_wall0
    return merged, timings
