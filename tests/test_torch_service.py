"""The port's sidecar (nemo_tpu_torch/service/) against the JAX package's,
on the CPU, over gRPC on 127.0.0.1 and over the loopback.

* every verb of the Kernel RPC on the port's server equals the JAX
  package's LocalExecutor on the same recorded inputs;
* cross-wire: the JAX client against the port's server and the port's
  client against the JAX sidecar (tests/conftest.py) give the outputs of
  the same-package pair: Kernel, Analyze, AnalyzeDir, AnalyzeDirStream,
  Query, Health;
* ServiceBackend's report trees equal the JAX ServiceBackend's and the
  port's TorchBackend's, byte for byte, over gRPC and over the loopback,
  reused after close_db;
* the chunked and pipelined client paths equal the unchunked step;
* the loopback hands back the bytes gRPC does, and both raise RpcError
  with the status codes the handlers abort with;
* the sidecar's process: ``--device cuda`` raises without a card, and
  SIGTERM drains and exits 0, its metrics endpoint serving meanwhile;
* the obs pieces the sidecar needs: span adoption and export against the
  JAX tracer, the shed-burst trigger, the metrics endpoint;
  the subprocess plumbing and RPC_POLICY against the JAX package's.

Every gRPC call carries a deadline and every server is stopped.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree  # noqa: E402
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug  # noqa: E402
from nemo_tpu.backend.jax_backend import LocalExecutor  # noqa: E402
from nemo_tpu.backend.service_backend import ServiceBackend as JaxServiceBackend  # noqa: E402
from nemo_tpu.service.client import RemoteAnalyzer as JaxRemoteAnalyzer  # noqa: E402
from nemo_tpu.service.client import RemoteExecutor as JaxRemoteExecutor  # noqa: E402
from nemo_tpu_torch import obs  # noqa: E402
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug  # noqa: E402
from nemo_tpu_torch.backend.service_backend import ServiceBackend  # noqa: E402
from nemo_tpu_torch.backend.torch_backend import TorchBackend, TorchExecutor  # noqa: E402
from nemo_tpu_torch.ops.sparse_device import CsrAdjRows  # noqa: E402
from nemo_tpu_torch.service import codec, wire  # noqa: E402
from nemo_tpu_torch.service.client import (  # noqa: E402
    RemoteAnalyzer,
    RemoteExecutor,
    SidecarError,
    _merge_chunk_outputs,
    _uniform_spans,
    analyze_dir,
    analyze_dir_pipelined,
    analyze_dirs,
)
from nemo_tpu_torch.service.server import Loopback, RpcError, StatusCode, make_server  # noqa: E402

from test_torch_service_cuda import record_verbs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERBS = sorted(TorchExecutor.VERBS)
QUERY = "from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> @rule count by table"


@pytest.fixture(scope="module")
def port_server():
    server, port = make_server(port=0, device="cpu")
    server.start()
    yield f"127.0.0.1:{port}"
    server.stop(grace=None)


@pytest.fixture(scope="module")
def verbs(tmp_path_factory):
    return record_verbs(str(tmp_path_factory.mktemp("service_verbs")))


def _host(out: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}


def _edges(out: dict, cond: str) -> set:
    src, dst, mask = (np.asarray(out[f"{cond}_clean_{k}"]) for k in ("src", "dst", "mask"))
    rows = np.broadcast_to(np.arange(src.shape[0])[:, None], src.shape)
    return set(zip(rows[mask].tolist(), src[mask].tolist(), dst[mask].tolist()))


def _assert_outputs_equal(got: dict, want: dict, what: str) -> None:
    """Equal outputs; contracted edge lists compare as edge sets, and a
    port's contracted list against the JAX package's dense plane (the giant
    verb, ROADMAP Queue C mesh (g)) through CsrAdjRows."""
    got = _host(got)
    want = _host(want)
    for cond in ("pre", "post"):
        if f"{cond}_clean_src" in got and f"{cond}_adj_clean" in want:
            v = want[f"{cond}_adj_clean"].shape[-1]
            src, dst, mask = (got.pop(f"{cond}_clean_{k}") for k in ("src", "dst", "mask"))
            got[f"{cond}_adj_clean"] = CsrAdjRows(src, dst, mask, v=v)[np.arange(src.shape[0])]
        elif f"{cond}_clean_src" in want:
            assert _edges(got, cond) == _edges(want, cond), (what, cond)
    assert set(got) == set(want), what
    for k, w in want.items():
        if k.endswith(("_clean_src", "_clean_dst", "_clean_mask")):
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ kernel


@pytest.mark.parametrize("verb", VERBS)
def test_kernel_rpc_matches_jax_local_executor(port_server, verbs, verb):
    arrays, params = verbs[verb]
    with RemoteAnalyzer(target=port_server, timeout=60) as client:
        got = client.kernel(verb, arrays, params)
    _assert_outputs_equal(got, LocalExecutor().run(verb, arrays, params), verb)


@pytest.mark.parametrize("verb", VERBS)
def test_cross_wire_kernel_equals_same_package_pair(port_server, sidecar, verbs, verb):
    """The JAX client on the port's server gets what the port's client
    gets there, and the port's client on the JAX sidecar what the JAX
    client gets there."""
    arrays, params = verbs[verb]
    outs = {}
    for server in (port_server, sidecar):
        for side, make in (("jax", JaxRemoteExecutor), ("port", RemoteExecutor)):
            ex = make(target=server, ready_deadline=30.0)
            try:
                outs[(server, side)] = _host(ex.run(verb, arrays, params))
            finally:
                ex.close()
    for server in (port_server, sidecar):
        _assert_outputs_equal(outs[(server, "port")], outs[(server, "jax")], f"{verb} on {server}")


def test_kernel_rpc_errors_and_the_executor_surface(port_server, verbs):
    with RemoteAnalyzer(target=port_server, timeout=30, retries=1) as client:
        with pytest.raises(RpcError) as ei:
            client.kernel("no_such_verb", {}, {})
        assert ei.value.code() == StatusCode.INVALID_ARGUMENT
        arrays, params = verbs["condition"]
        with pytest.raises(RpcError) as ei:
            client.kernel("condition", {k: v for k, v in arrays.items() if k != "is_goal"}, params)
        assert ei.value.code() == StatusCode.INVALID_ARGUMENT and "missing kernel input" in ei.value.details()
    ex = RemoteExecutor(target=port_server)
    try:
        assert (ex.device.type, ex.shard, ex.last_dispatch_cold, ex.remote_platform) == ("cpu", "off", False, "cpu")
        out = ex.run("fused", *verbs["fused"])
        # The outputs TorchExecutor keeps on its device come back as CPU
        # tensors, the rest as numpy, as TorchExecutor hands them over.
        for k, a in out.items():
            assert isinstance(a, torch.Tensor) == (k in TorchExecutor.ON_DEVICE["fused"]), k
        assert ex.dispatches == {"fused": 1} and ex.wall_s["fused"] > 0
        ex.count_host("synth_host")
        assert ex.host_runs == {"synth_host": 1}
    finally:
        ex.close()


# ------------------------------------------------------- analyze and dirs


def _pack(corpus_dir):
    from nemo_tpu.ingest.molly import load_molly_output
    from nemo_tpu.models.pipeline_model import pack_molly_for_step

    pre, post, static = pack_molly_for_step(load_molly_output(corpus_dir))
    return pre, post, static


def test_cross_wire_analyze_and_analyze_dir(port_server, sidecar, corpus_dir):
    """Analyze and AnalyzeDir: the four (client, server) pairs give equal
    outputs, and the port's server equals the JAX sidecar."""
    pre, post, static = _pack(corpus_dir)
    outs = {}
    for server in (port_server, sidecar):
        for side, make in (("jax", JaxRemoteAnalyzer), ("port", RemoteAnalyzer)):
            with make(target=server, timeout=60) as client:
                client.wait_ready()
                outs[(server, side, "analyze")] = client.analyze(pre, post, static)
                outs[(server, side, "dir")] = client.analyze_dir_remote(corpus_dir)
    want = outs[(sidecar, "jax", "analyze")]
    for key, got in outs.items():
        _assert_outputs_equal(got, want, str(key))


def test_cross_wire_stream_and_query(port_server, sidecar, corpus_dir):
    docs, results = {}, {}
    for server in (port_server, sidecar):
        for side, make in (("jax", JaxRemoteAnalyzer), ("port", RemoteAnalyzer)):
            with make(target=server, timeout=60) as client:
                client.wait_ready()
                doc = client.query_remote(corpus_dir, QUERY)
                docs[(server, side)] = {k: v for k, v in doc.items() if k != "stats"}
                events = list(client.analyze_dir_stream([corpus_dir]))
                assert [e["event"] for e in events][-2:] == ["result", "done"]
                results[(server, side)] = events[-2]["outputs"]
                h = client.health()
                assert h["version"] == "1" and h["device_count"] >= 1 and "metrics" in h
    want_doc = docs[(sidecar, "jax")]
    assert all(d == want_doc for d in docs.values())
    for key, got in results.items():
        _assert_outputs_equal(got, results[(sidecar, "jax")], str(key))
    with RemoteAnalyzer(target=port_server, timeout=30, retries=1) as client:
        with pytest.raises(RpcError) as ei:
            client.query_remote(corpus_dir, "match wat")
        assert ei.value.code() == StatusCode.INVALID_ARGUMENT and "query error" in ei.value.details()
        with pytest.raises(RpcError) as ei:
            client.analyze_dir_remote(os.path.join(corpus_dir, "no_such_dir"))
        assert ei.value.code() == StatusCode.INVALID_ARGUMENT


def test_chunked_and_pipelined_paths_match_unchunked(port_server, corpus_dir):
    from nemo_tpu.models.pipeline_model import analysis_step

    pre, post, static = _pack(corpus_dir)
    local = {k: np.asarray(v) for k, v in analysis_step(pre, post, **static).items()}
    whole = analyze_dir(port_server, corpus_dir)
    chunked = analyze_dir(port_server, corpus_dir, chunk_runs=3)
    piped, timings = analyze_dir_pipelined(port_server, corpus_dir, chunk_runs=3)
    assert timings["pack_s"] > 0 and timings["stream_s"] > 0
    for got in (whole, chunked, piped):
        _assert_outputs_equal(got, local, "chunked")


def test_analyze_dirs_matches_per_dir_and_surfaces_producer_errors(port_server, tmp_path):
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    dirs = [write_corpus(SynthSpec(n_runs=4, seed=s, name=f"fam{s}"), str(tmp_path)) for s in (3, 4)]
    results, timings = analyze_dirs(port_server, dirs)
    assert len(results) == 2 and timings["wall_s"] > 0
    for d, got in zip(dirs, results):
        _assert_outputs_equal(got, analyze_dir(port_server, d), d)
    with pytest.raises(SidecarError) as ei:
        analyze_dirs(port_server, [str(tmp_path / "does_not_exist")])
    assert ei.value.__cause__ is not None


def test_merge_chunk_outputs_pads_widths_and_recomputes_reductions():
    """The JAX package's case: chunks of different table widths, one chunk
    with no achieving run; rows pad, the reductions are recomputed."""
    from nemo_tpu_torch.ops.proto import DEPTH_INF

    c0 = {"proto_bits": np.array([[1, 0], [0, 0]], dtype=bool), "achieved_pre": np.array([True, False]),
          "proto_inter": np.array([1, 0], dtype=bool), "proto_union": np.array([1, 0], dtype=bool),
          "proto_min_depth": np.array([[1, 9], [9, 9]], dtype=np.int32)}
    c1 = {"proto_bits": np.array([[1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 1, 0]], dtype=bool),
          "achieved_pre": np.array([True, False, True]), "proto_inter": np.array([1, 0, 0, 0], dtype=bool),
          "proto_union": np.array([1, 0, 1, 0], dtype=bool),
          "proto_min_depth": np.array([[1, 9, 9, 9], [9, 9, 9, 9], [1, 9, 2, 9]], dtype=np.int32)}
    merged = _merge_chunk_outputs([(0, 2), (2, 4)], [c0, c1])
    assert merged["proto_bits"].shape == (4, 4)
    np.testing.assert_array_equal(merged["proto_inter"], [True, False, False, False])
    np.testing.assert_array_equal(merged["proto_union"], [True, False, True, False])
    assert (merged["proto_min_depth"][:2, 2:] == DEPTH_INF).all()
    for n, chunk_runs in [(1, 1), (2, 1), (5, 1), (5, 2), (600, 256), (600, 600), (3, 7)]:
        spans, pad_to = _uniform_spans(n, chunk_runs)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(e0 == s1 and s0 < e0 for (s0, e0), (s1, _) in zip(spans, spans[1:]))


# -------------------------------------------------------------- the report


def test_service_backend_reports_equal_jax_and_torch_backend(port_server, sidecar, corpus_dir, tmp_path):
    want = report_tree_bytes(run_debug(corpus_dir, str(tmp_path / "torch"), TorchBackend(device="cpu"),
                                       figures="all").report_dir)
    jax_res = jax_run_debug(corpus_dir, str(tmp_path / "jaxsvc"), JaxServiceBackend(target=sidecar), figures="all")
    assert jax_tree(jax_res.report_dir) == want
    svc = ServiceBackend(target=port_server)
    for tag in ("svc", "svc2"):  # reusable after close_db
        res = run_debug(corpus_dir, str(tmp_path / tag), svc, figures="all")
        assert report_tree_bytes(res.report_dir) == want
    routes = {(r["verb"], r["route"], r["reason"]) for r in svc.analysis_routes}
    assert ("fused", "dense", "platform") in routes and ("synth", "sparse", "platform") in routes
    lb = Loopback("cpu")
    res = run_debug(corpus_dir, str(tmp_path / "loop"), ServiceBackend(target=lb, analysis_host_work=0,
                                                                       diff_host_work=0), figures="all")
    assert report_tree_bytes(res.report_dir) == want
    assert lb.impl.executor.dispatches.get("fused", 0) > 0 and lb.impl.executor.dispatches.get("diff", 0) == 1


def test_service_backend_giant_runs_take_the_giant_verb(port_server, tmp_path):
    """giant_impl auto resolves to the giant verb on the sidecar (the JAX
    ServiceBackend's device route), its tree equal to TorchBackend's."""
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    deep = write_corpus(SynthSpec(n_runs=3, seed=5, eot=60, name="deep"), str(tmp_path))
    want = report_tree_bytes(run_debug(deep, str(tmp_path / "torch"), TorchBackend(device="cpu", giant_v=64),
                                       figures="all", corpus_cache="off", result_cache="off").report_dir)
    be = ServiceBackend(target=port_server, giant_v=64)
    res = run_debug(deep, str(tmp_path / "svc"), be, figures="all", corpus_cache="off", result_cache="off")
    assert report_tree_bytes(res.report_dir) == want
    assert be.giant_impl_used == "device"
    assert {(r["route"], r["reason"]) for r in be.analysis_routes if r["verb"] == "giant"} == {("dense", "giant_impl")}


# ------------------------------------------------------ the two transports


def test_loopback_bytes_equal_grpc_and_errors_match(port_server, verbs):
    arrays, params = verbs["simplify"]
    req = codec.kernel_request_to_pb("simplify", arrays, params)
    lb = Loopback("cpu")
    raw, ctx = lb.call("Kernel", req.SerializeToString())
    with RemoteAnalyzer(target=port_server, timeout=30) as client:
        resp, _ = client._call(client._kernel, req, name="Kernel")
    a, b = wire.KernelResponse.FromString(raw), resp
    a.step_seconds = b.step_seconds = 0.0
    assert a.SerializeToString() == b.SerializeToString()
    for target in (lb, port_server):
        with RemoteAnalyzer(target=target, timeout=30, retries=1) as client:
            with pytest.raises(RpcError) as ei:
                client.kernel("no_such_verb", {}, {})
            assert ei.value.code() == StatusCode.INVALID_ARGUMENT
            assert client.health()["platform"] == "cpu"


def test_unavailable_target_raises():
    with RemoteAnalyzer(target="127.0.0.1:1", retries=2, timeout=2.0) as client:
        with pytest.raises((RpcError, SidecarError)):
            client.health(timeout=0.5)


# -------------------------------------------------------------- the process


def test_sidecar_device_cuda_raises_without_a_card(monkeypatch):
    from nemo_tpu_torch.service import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        server._Impl("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        server.main(["--device", "cuda", "--port", "0"])


def test_sidecar_process_serves_metrics_then_drains_on_sigterm(tmp_path):
    import urllib.request

    from nemo_tpu_torch.utils.subproc import PortReservation, wait_listening

    with PortReservation(2) as ports:
        port, mport = ports.release(0), ports.release(1)
    env = dict(os.environ, PYTHONPATH=REPO, NEMO_FLIGHT="off")
    proc = subprocess.Popen([sys.executable, "-m", "nemo_tpu_torch.service.server", "--port", str(port), "--device",
                             "cpu", "--metrics-port", str(mport), "--drain-s", "5", "--max-inflight", "2"],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        wait_listening(port, deadline_s=60, proc=proc)
        wait_listening(mport, deadline_s=30, proc=proc)
        with RemoteAnalyzer(target=f"127.0.0.1:{port}", timeout=30) as client:
            assert client.wait_ready(30)["platform"] == "cpu"
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["status"] == "SERVING" and doc["platform"] == "cpu"
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "nemo_serve_capacity 2" in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


# ---------------------------------------------------------------- obs bits


def test_span_adoption_and_export_match_the_jax_tracer(tmp_path):
    """adopt/drain_spans/mark/spans_since and the foreign-clock re-base of
    export, against the JAX package's Tracer on the same spans."""
    from nemo_tpu.obs import trace as jax_trace
    from nemo_tpu_torch.obs import trace as port_trace

    docs = []
    for mod in (port_trace, jax_trace):
        t = mod.Tracer(str(tmp_path / f"{mod.__name__}.json"), trace_id="t")
        t.add_span("local", 5_000, 10, tid=1, thread_name="main")
        mark = t.mark()
        t.add_span("after", 6_000, 20, tid=1)
        assert [s["name"] for s in t.spans_since(mark)] == ["after"]
        remote = [{"name": "far", "ts": 10**13, "dur": 3, "pid": 4242, "tid": 7, "thread_name": "w"},
                  {"name": "own", "ts": 1, "dur": 1, "pid": t.pid, "tid": 1}]
        t.adopt(remote, process_name="nemo-sidecar")
        with open(t.export(), encoding="utf-8") as f:
            doc = json.load(f)
        docs.append(sorted((e["name"], e.get("ts"), e.get("pid") == t.pid, json.dumps(e.get("args"), sort_keys=True))
                           for e in doc["traceEvents"] if e["name"] != "process_name" or e["pid"] != t.pid))
        assert [s["name"] for s in t.drain_spans()] == ["local", "after", "far"]
        assert t.drain_spans() == []
    assert docs[0] == docs[1]


def test_shed_burst_dumps_a_flight_bundle(tmp_path):
    from nemo_tpu_torch.obs import flight

    flight.arm(str(tmp_path), shed_burst=3, shed_window_s=10.0, cooldown_s=0.0)
    try:
        flight.note_shed("queue_full", "a")
        flight.note_shed("queue_full", "a")
        assert not list(tmp_path.glob("flightrec-shed_burst-*"))
        flight.note_shed("queue_full", "b")
        assert len(list(tmp_path.glob("flightrec-shed_burst-*"))) == 1
    finally:
        flight.disarm()
    flight.note_shed("queue_full", "c")  # disarmed: nothing


def test_metrics_endpoint_serves_health_and_prometheus_text():
    import urllib.error
    import urllib.request

    from nemo_tpu_torch.obs import promexp

    state = {"status": "SERVING"}
    httpd, port = promexp.start_http_server(0, health=lambda: dict(state))
    try:
        obs.metrics.inc("serve.requests")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert "nemo_serve_requests_total" in promexp.parse_prometheus_text(r.read().decode())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read())["status"] == "SERVING"
        state["status"] = "NOT_SERVING"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=10)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_subproc_and_rpc_policy_match_the_jax_package():
    import socket

    from nemo_tpu.utils import backoff as jax_backoff
    from nemo_tpu_torch.utils import backoff, subproc

    p = backoff.RPC_POLICY
    q = jax_backoff.RPC_POLICY
    assert (p.base_s, p.multiplier, p.max_delay_s, p.jitter, p.budget_s) == (
        q.base_s, q.multiplier, q.max_delay_s, q.jitter, q.budget_s)
    ports = {subproc.free_port() for _ in range(20)}
    assert len(ports) == 20
    with subproc.PortReservation(3) as res:
        assert len(set(res.ports)) == 3 and not ports & set(res.ports)
        with pytest.raises(OSError):
            socket.socket().bind(("127.0.0.1", res.ports[0]))
        res.release(0)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    with pytest.raises(RuntimeError, match="never listened"):
        subproc.wait_listening(subproc.free_port(), deadline_s=5, proc=dead, poll_s=0.05)
    start = time.monotonic()
    with pytest.raises(RuntimeError):
        subproc.wait_listening(subproc.free_port(), deadline_s=0.2, poll_s=0.05)
    assert time.monotonic() - start < 10


# ------------------------------------------------------- watch streams


def test_server_watch_stream_events(port_server, tmp_path, monkeypatch):
    """AnalyzeDirStream's live mode on the port's server: watching, one
    report_update a replayed generation, done (the JAX package's
    tests/test_watch.py case)."""
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
    from nemo_tpu_torch.watch import start_replay

    monkeypatch.setenv("NEMO_CORPUS_CACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("NEMO_RESULT_CACHE", str(tmp_path / "rc"))
    src = write_corpus(SynthSpec(n_runs=6, seed=17, name="sweep"), str(tmp_path))
    dst = str(tmp_path / "live")
    os.makedirs(dst)
    th, stop = start_replay(src, dst, generations=2, interval_s=2.0)
    try:
        with RemoteAnalyzer(target=port_server, timeout=120) as c:
            events = list(c.analyze_dir_stream([dst], watch={"results_root": str(tmp_path / "wres"),
                                                             "max_updates": 2, "poll_s": 0.1, "debounce_s": 0.1,
                                                             "figures": "none"}))
    finally:
        stop.set()
        th.join(timeout=30)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "watching" and kinds[-1] == "done"
    ups = [e for e in events if e["event"] == "report_update"]
    assert [e["runs_total"] for e in ups] == [3, 6] and events[-1]["updates"] == 2


def test_server_watch_stream_surfaces_crash_and_validates(port_server, tmp_path):
    d = str(tmp_path / "never_a_sweep")
    os.makedirs(d)
    with RemoteAnalyzer(target=port_server, timeout=60) as c:
        events = list(c.analyze_dir_stream([d], watch={"results_root": str(tmp_path / "wres"), "poll_s": 0.05,
                                                       "initial_wait_s": 0.3}))
        with pytest.raises(RpcError) as ei:
            list(c.analyze_dir_stream([d], watch={}))  # no results_root
    err = next(e for e in events if e["event"] == "watch_error")
    assert err.get("fatal") and events[-1]["event"] == "done" and events[-1]["errors"] == 1
    assert ei.value.code() == StatusCode.INVALID_ARGUMENT
