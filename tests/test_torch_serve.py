"""The port's serving tier (nemo_tpu_torch/serve/ and the sidecar's use of
it) against the JAX package's: a counterpart of every test of
tests/test_serve.py, each scenario scripted once and run on both packages,
their decisions (grant orders, status codes, roles, events) and their
``serve.*`` counter deltas held equal.

Admission (fairness, queue full, drain, idempotent release), server-level
admission (shed at the cap with retry-after, tenant metadata), single-flight
coalescing, the streaming RPC (completion order, per-family rejection), the
drain (in process, and held open by a live stream), and continuous
batching (exact demux, the rank gate, pass-through, a failed leader).
Every gRPC call carries a deadline and every server is stopped.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from nemo_tpu import obs as jax_obs  # noqa: E402
from nemo_tpu import serve as jax_serve  # noqa: E402
from nemo_tpu.backend.jax_backend import LocalExecutor  # noqa: E402
from nemo_tpu.service import client as jax_client  # noqa: E402
from nemo_tpu.service import server as jax_server  # noqa: E402
from nemo_tpu_torch import obs  # noqa: E402
from nemo_tpu_torch import serve  # noqa: E402
from nemo_tpu_torch.backend.torch_backend import TorchBackend, TorchExecutor  # noqa: E402
from nemo_tpu_torch.service import client as port_client  # noqa: E402
from nemo_tpu_torch.service import server as port_server  # noqa: E402
from nemo_tpu_torch.service.server import RpcError  # noqa: E402

PACKAGES = {
    "jax": SimpleNamespace(serve=jax_serve, obs=jax_obs, server=jax_server, client=jax_client,
                           error=grpc.RpcError, executor=LocalExecutor,
                           make_server=lambda: jax_server.make_server(port=0),
                           health_state=lambda srv: jax_server._health_state()),
    "port": SimpleNamespace(serve=serve, obs=obs, server=port_server, client=port_client, error=RpcError,
                            executor=lambda: TorchExecutor("cpu"),
                            make_server=lambda: port_server.make_server(port=0, device="cpu"),
                            health_state=None),
}


def _code(ex) -> str:
    return ex.code().name


def _serve_delta(pkg, before) -> dict:
    d = pkg.obs.Metrics.delta(pkg.obs.metrics.snapshot(), before)
    out = {k: v for k, v in d["counters"].items() if k.startswith("serve.")}
    out.update({f"{k}#count": h["count"] for k, h in d["histograms"].items() if k.startswith("serve.")})
    return out


def _both(scenario, **kw) -> dict:
    """scenario(pkg, **kw) -> its decisions, on both packages, with each
    package's serve.* delta; the two results are returned by package."""
    out = {}
    for name, pkg in PACKAGES.items():
        before = pkg.obs.metrics.snapshot()
        decisions = scenario(pkg, **kw)
        out[name] = (decisions, _serve_delta(pkg, before))
    return out


def _assert_same(res: dict, wall_free=()) -> None:
    (jd, jm), (pd, pm) = res["jax"], res["port"]
    assert pd == jd
    drop = lambda m: {k: v for k, v in m.items() if not k.startswith(tuple(wall_free))}  # noqa: E731
    assert drop(pm) == drop(jm)


@pytest.fixture
def fresh_serve_singletons():
    for pkg in PACKAGES.values():
        pkg.serve.reset_controller()
        pkg.serve.reset_flights()
        pkg.serve.reset_batcher()
    yield
    for pkg in PACKAGES.values():
        pkg.serve.reset_controller()
        pkg.serve.reset_flights()
        pkg.serve.reset_batcher()


@pytest.fixture
def started(fresh_serve_singletons):
    """start(pkg) -> target of a started server of that package; every
    server is stopped after the test."""
    servers = []

    def start(pkg):
        server, port = pkg.make_server()
        server.start()
        servers.append(server)
        return f"127.0.0.1:{port}"

    yield start
    for s in servers:
        s.stop(grace=None)


# ---------------------------------------------------------------- admission


def test_admission_tenant_fairness_round_robin():
    def scenario(pkg):
        ctl = pkg.serve.admission.AdmissionController(max_inflight=1, max_queue=10)
        t1 = ctl.enqueue("greedy")
        assert t1.wait(1.0)
        a2, a3, a4 = (ctl.enqueue("greedy") for _ in range(3))
        b1 = ctl.enqueue("blue")
        names = {id(a2): "a2", id(a3): "a3", id(a4): "a4", id(b1): "b1"}
        positions = [t.position() for t in (a2, a3, a4, b1)]
        t1.release()
        order = []
        pending = [a2, a3, a4, b1]
        while pending:
            granted = [t for t in pending if t.wait(0)]
            assert len(granted) == 1
            order.append(names[id(granted[0])])
            pending.remove(granted[0])
            granted[0].release()
        return positions, order, ctl.inflight, ctl.queued

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo."))
    assert res["port"][0][1] == ["a2", "b1", "a3", "a4"]


def test_admission_queue_full_rejects_with_metrics():
    def scenario(pkg):
        ctl = pkg.serve.admission.AdmissionController(max_inflight=1, max_queue=2)
        t1 = ctl.enqueue("a")
        assert t1.wait(1.0)
        q1, q2 = ctl.enqueue("a"), ctl.enqueue("b")
        with pytest.raises(pkg.serve.AdmissionRejected) as ei:
            ctl.enqueue("c")
        snap = pkg.obs.metrics.snapshot()["gauges"]
        out = (ei.value.reason, ei.value.retry_after_s > 0, snap["serve.queue_depth"], snap["serve.inflight"])
        for t in (t1, q1, q2):
            t.release()
            t.wait(1.0)
            t.release()
        return out

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo."))
    assert res["port"][0] == ("queue_full", True, 2.0, 1.0)
    assert res["port"][1]["serve.tenant.c.rejected"] == 1


def test_admission_drain_refuses_and_drains():
    def scenario(pkg):
        ctl = pkg.serve.admission.AdmissionController(max_inflight=2, max_queue=4)
        t1 = ctl.enqueue("a")
        assert t1.wait(1.0)
        ctl.begin_drain()
        with pytest.raises(pkg.serve.AdmissionRejected) as ei:
            ctl.enqueue("b")
        held = ctl.drain_wait(0.05)
        t1.release()
        return ei.value.reason, held, ctl.drain_wait(1.0)

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo."))
    assert res["port"][0] == ("draining", False, True)


def test_admission_release_is_idempotent_and_cancel_unqueues():
    def scenario(pkg):
        ctl = pkg.serve.admission.AdmissionController(max_inflight=1, max_queue=4)
        t1 = ctl.enqueue("a")
        q1 = ctl.enqueue("a")
        q1.cancel()
        queued = ctl.queued
        t1.release()
        t1.release()
        inflight = ctl.inflight
        t2 = ctl.enqueue("a")
        ok = t2.wait(1.0)
        t2.release()
        return queued, inflight, ok

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo."))
    assert res["port"][0] == (0, 0, True)


# --------------------------------------------------- server-level admission


def test_server_rejects_at_cap_with_retry_after(corpus_dir, monkeypatch, started):
    monkeypatch.setenv("NEMO_SERVE_INFLIGHT", "1")
    monkeypatch.setenv("NEMO_SERVE_QUEUE", "0")

    def scenario(pkg):
        pkg.serve.reset_controller()
        target = started(pkg)
        ctl = pkg.serve.controller()
        hog = ctl.enqueue("hog")
        assert hog.wait(1.0)
        with pkg.client.RemoteAnalyzer(target=target, retries=1, timeout=60) as client:
            client.wait_ready()
            with pytest.raises(pkg.error) as ei:
                client.analyze_dir_remote(corpus_dir)
            md = dict(ei.value.trailing_metadata() or ())
            hog.release()
            out = client.analyze_dir_remote(corpus_dir)
        return (ctl.max_inflight, ctl.max_queue, _code(ei.value), float(md["nemo-retry-after-s"]) > 0,
                "proto_bits" in out)

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo.", "serve.step_s",
                                 "serve.rpc_latency_s", "serve.batch_rows"))
    assert res["port"][0] == (1, 0, "RESOURCE_EXHAUSTED", True, True)


def test_server_tenant_metadata_counted(corpus_dir, started):
    def scenario(pkg):
        target = started(pkg)
        with pkg.client.RemoteAnalyzer(target=target, tenant="team-a", timeout=60) as client:
            client.wait_ready()
            client.analyze_dir_remote(corpus_dir)
        return None

    res = _both(scenario)
    _assert_same(res)
    assert res["port"][1]["serve.tenant.team-a.requests"] == 1


# -------------------------------------------------------------- coalescing


def test_coalesced_responses_byte_identical_single_analysis(tmp_path, monkeypatch, started):
    """Three concurrent identical AnalyzeDir requests: one analysis, three
    byte-identical responses, roles leader/hit/hit; a solo run after the
    flights clear equals them but for the step wall."""
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    corpus = write_corpus(SynthSpec(n_runs=5, seed=11, name="coalesce"), str(tmp_path))
    monkeypatch.setenv("NEMO_RESULT_CACHE", "off")
    monkeypatch.setenv("NEMO_SERVE_COALESCE_LINGER_S", "30")

    def scenario(pkg):
        monkeypatch.setenv("NEMO_CORPUS_CACHE", str(tmp_path / f"cc-{pkg.serve.__name__}"))
        pkg.serve.reset_flights()
        target = started(pkg)
        results = [None] * 3
        barrier = threading.Barrier(3)

        def raw(i):
            with pkg.client.RemoteAnalyzer(target=target, timeout=120) as client:
                barrier.wait()
                resp, call = client._call(client._analyze_dir, {"dir": corpus}, name="AnalyzeDir")
                results[i] = (resp.SerializeToString(), dict(call.trailing_metadata() or ()))

        with pkg.client.RemoteAnalyzer(target=target, timeout=30) as probe:
            probe.wait_ready()
        threads = [threading.Thread(target=raw, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None for r in results)
        pkg.serve.flights().clear()
        with pkg.client.RemoteAnalyzer(target=target, timeout=120) as client:
            solo, _ = client._call(client._analyze_dir, {"dir": corpus}, name="AnalyzeDir")
        first = type(solo).FromString(results[0][0])
        solo.step_seconds = first.step_seconds = 0.0
        # pb2 writes maps in a process-dependent order unless asked for
        # the deterministic one; the port's wire is always deterministic.
        kw = {"deterministic": True} if pkg.serve is jax_serve else {}
        return (len({r[0] for r in results}), sorted(r[1].get("nemo-coalesce") for r in results),
                solo.SerializeToString(**kw) == first.SerializeToString(**kw))

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo.", "serve.step_s",
                                 "serve.rpc_latency_s", "serve.batch_rows"))
    assert res["port"][0] == (1, ["hit", "hit", "leader"], True)
    assert res["port"][1]["serve.analyze_chunks"] == 2


# --------------------------------------------------------------- streaming


def test_stream_yields_families_in_completion_order(tmp_path, monkeypatch, started):
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    warm = write_corpus(SynthSpec(n_runs=4, seed=21, name="warm"), str(tmp_path))
    cold = write_corpus(SynthSpec(n_runs=9, seed=22, name="cold"), str(tmp_path))

    def scenario(pkg):
        tag = pkg.serve.__name__
        monkeypatch.setenv("NEMO_CORPUS_CACHE", str(tmp_path / f"cc-{tag}"))
        monkeypatch.setenv("NEMO_RESULT_CACHE", str(tmp_path / f"rc-{tag}"))
        target = started(pkg)
        with pkg.client.RemoteAnalyzer(target=target, timeout=120) as client:
            client.wait_ready()
            client.analyze_dir_remote(warm)
            events = list(client.analyze_dir_stream([cold, warm]))
            unary = client.analyze_dir_remote(cold)
        results = [e for e in events if e["event"] == "result"]
        by_dir = {r["dir"]: r["outputs"] for r in results}
        kinds = [e["event"] for e in events]
        return (kinds[-1], events[-1]["results"], events[-1]["errors"], [r["dir"] for r in results],
                results[0]["rcache"] == "hit" or results[0]["coalesce"] == "hit",
                any(k in ("admitted", "phase", "queued") for k in kinds[: kinds.index("result")]),
                sorted(by_dir[cold]) == sorted(unary)
                and all(np.array_equal(by_dir[cold][k], unary[k]) for k in unary))

    res = _both(scenario)
    assert res["port"][0] == res["jax"][0] == ("done", 2, 0, [warm, cold], True, True, True)


def test_stream_admission_rejection_is_per_family(corpus_dir, monkeypatch, started):
    monkeypatch.setenv("NEMO_SERVE_INFLIGHT", "1")
    monkeypatch.setenv("NEMO_SERVE_QUEUE", "0")

    def scenario(pkg):
        pkg.serve.reset_controller()
        target = started(pkg)
        hog = pkg.serve.controller().enqueue("hog")
        assert hog.wait(1.0)
        with pkg.client.RemoteAnalyzer(target=target, timeout=60) as client:
            client.wait_ready()
            events = list(client.analyze_dir_stream([corpus_dir]))
        hog.release()
        errors = [e for e in events if e["event"] == "error"]
        return len(errors), errors[0]["status"], errors[0]["retry_after_s"] > 0, events[-1]

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.queued_s", "serve.exec_s", "serve.slo.", "serve.rpc_latency_s"))
    assert res["port"][0] == (1, "RESOURCE_EXHAUSTED", True, {"event": "done", "results": 0, "errors": 1})


# ------------------------------------------------------------------- drain


def test_drain_semantics_in_process(corpus_dir, started):
    def scenario(pkg):
        target = started(pkg)
        ctl = pkg.serve.controller()
        state = (pkg.health_state(None) if pkg.health_state else None)
        with pkg.client.RemoteAnalyzer(target=target, retries=1, timeout=60) as client:
            client.wait_ready()
            ctl.begin_drain()
            with pytest.raises(pkg.error) as ei:
                client.analyze_dir_remote(corpus_dir)
            platform = client.health()["platform"]
        return state is None or state["status"] == "SERVING", _code(ei.value), bool(platform), ctl.drain_wait(2.0)

    res = _both(scenario)
    _assert_same(res, wall_free=("serve.rpc_latency_s",))
    assert res["port"][0] == (True, "UNAVAILABLE", True, True)
    impl = port_server._Impl("cpu")
    assert port_server._health_state(impl)["status"] == "NOT_SERVING"


def test_drain_waits_for_mid_flight_stream(tmp_path, monkeypatch, started):
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    monkeypatch.setenv("NEMO_CORPUS_CACHE", "off")
    monkeypatch.setenv("NEMO_RESULT_CACHE", "off")
    monkeypatch.setenv("NEMO_SERVE_INFLIGHT", "1")
    d = write_corpus(SynthSpec(n_runs=4, seed=33, name="draining"), str(tmp_path))

    def scenario(pkg):
        pkg.serve.reset_controller()
        target = started(pkg)
        ctl = pkg.serve.controller()
        hog = ctl.enqueue("hog")
        assert hog.wait(1.0)
        with pkg.client.RemoteAnalyzer(target=target, timeout=120) as client:
            client.wait_ready()
            stream = iter(client.analyze_dir_stream([d]))
            first = next(stream)
            streams = ctl.streams
            ctl.begin_drain()
            held = ctl.drain_wait(0.1)
            hog.release()
            events = [first] + list(stream)
        return (first["event"], streams, held, events[-1]["event"], events[-1]["results"], events[-1]["errors"],
                any(e["event"] == "result" for e in events), ctl.streams, ctl.drain_wait(5.0))

    res = _both(scenario)
    assert res["port"][0] == res["jax"][0] == ("queued", 1, False, "done", 1, 0, True, 0, True)


# ---------------------------------------------------- continuous batching


def _condition_request(packed, rows):
    pre, post, static = packed
    arrays = {n: np.asarray(getattr(post, n))[rows]
              for n in ("edge_src", "edge_dst", "edge_mask", "is_goal", "table_id", "node_mask")}
    return arrays, {"v": static["v"], "cond_tid": static["post_tid"], "num_tables": static["num_tables"]}


class _GateExecutor:
    """An executor whose first dispatch blocks until released, so that
    concurrent requests accumulate behind it."""

    def __init__(self, inner):
        self.inner = inner
        self.device = getattr(inner, "device", None)
        self.calls = []
        self.started = threading.Event()
        self.release = threading.Event()

    def run(self, verb, arrays, params, rows=None):
        first = not self.calls
        self.calls.append((verb, int(np.shape(next(iter(arrays.values())))[0]), rows))
        if first:
            self.started.set()
            assert self.release.wait(30)
        return self.inner.run(verb, arrays, params, rows=rows)


@pytest.fixture(scope="module")
def packed(corpus_dir):
    from nemo_tpu.ingest.molly import load_molly_output
    from nemo_tpu.models.pipeline_model import pack_molly_for_step

    return pack_molly_for_step(load_molly_output(corpus_dir))


def test_cross_request_batch_demuxes_exactly(packed):
    """Two requests behind a gated launch merge into one padded launch;
    each demuxed result equals its solo run; the same calls, rows hints
    and counters as the JAX batcher's."""
    reqs = [_condition_request(packed, s) for s in (slice(0, 3), slice(3, 5), slice(5, 8))]
    params = reqs[0][1]

    def scenario(pkg):
        gate = _GateExecutor(pkg.executor())
        batcher = pkg.serve.batch.KernelBatcher(window_s=0)
        sig = pkg.serve.batch.dispatch_signature("condition", reqs[0][0], params)
        results, errors = {}, []

        def submit(name, arrays):
            try:
                results[name] = batcher.run(gate, "condition", arrays, params)
            except Exception as ex:  # surfaced by the assert below
                errors.append(ex)

        ta = threading.Thread(target=submit, args=("a", reqs[0][0]))
        ta.start()
        assert gate.started.wait(10)
        tb = threading.Thread(target=submit, args=("b", reqs[1][0]))
        tc = threading.Thread(target=submit, args=("c", reqs[2][0]))
        tb.start()
        tc.start()
        deadline = time.monotonic() + 10
        while len(batcher._groups[sig].pending) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        gate.release.set()
        for t in (ta, tb, tc):
            t.join(timeout=60)
        assert not errors, errors
        solo = pkg.executor()
        same = all(np.array_equal(np.asarray(results[n]["holds"]), np.asarray(solo.run("condition", a, params)["holds"]))
                   for n, (a, _) in zip("abc", reqs))
        holds = {n: np.asarray(results[n]["holds"]).tolist() for n in "abc"}
        return gate.calls, same, holds

    res = _both(scenario)
    _assert_same(res, wall_free=())
    calls, same, _ = res["port"][0]
    assert same and len(calls) == 2 and calls[1][2] == 5 and calls[1][1] == 8
    m = res["port"][1]
    assert (m["serve.batch.launches"], m["serve.batch.merged_requests"], m["serve.batch.coalesced_requests"]) == (2, 3, 1)


def test_merged_launch_is_a_device_pinned_serve_job(packed):
    """The port's merged launch runs as a parallel/sched.py job pinned to
    the device lane, tagged serve, on the executor's device."""
    from nemo_tpu_torch.parallel import sched

    arrays, params = _condition_request(packed, slice(0, 3))
    before = obs.metrics.snapshot()
    serve.batch.KernelBatcher(window_s=0).run(TorchExecutor("cpu"), "condition", arrays, params)
    c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert c.get("analysis.sched.dispatch.device", 0) == 1
    rec = [r for r in sched.sched_snapshot("cpu") if r.get("source") == "serve"][-1]
    assert rec["verb"] == "condition" and rec["pinned"] is True and rec["reason"] == "serve_batch"


def test_batcher_never_merges_per_graph_dispatches():
    cases = [
        ("condition", {"is_goal": np.zeros(8, bool), "edge_src": np.zeros(8, np.int32)}),
        ("condition", {"is_goal": np.zeros((3, 8), bool), "edge_src": np.zeros((3, 5), np.int32)}),
        ("proto", {"adj": np.zeros((8, 8), bool), "is_goal": np.zeros(8, bool)}),
        ("proto", {"adj": np.zeros((2, 8, 8), bool), "is_goal": np.zeros((2, 8), bool)}),
        ("fused", {"pre_is_goal": np.zeros((2, 8))}),
        ("condition", {"is_goal": np.zeros((3, 8), bool), "edge_src": np.zeros((2, 5), np.int32)}),
        ("synth_ext", {"is_goal": np.zeros((4, 8), bool), "holds": np.zeros((4, 8), bool)}),
    ]
    mine = [serve.batch._eligible_rows(v, a) for v, a in cases]
    assert mine == [jax_serve.batch._eligible_rows(v, a) for v, a in cases] == [None, 3, None, 2, None, None, 4]
    assert serve.BATCHABLE_VERBS == jax_serve.BATCHABLE_VERBS


def test_batcher_passes_through_non_batchable_verbs():
    def scenario(pkg):
        calls = []

        class Spy:
            def run(self, verb, arrays, params, rows=None):
                calls.append(verb)
                return {"ok": np.zeros(1)}

        pkg.serve.batch.KernelBatcher(window_s=0).run(Spy(), "fused", {"pre_is_goal": np.zeros((2, 4))}, {})
        return calls

    res = _both(scenario)
    _assert_same(res)
    assert res["port"] == (["fused"], {"serve.batch.solo": 1})


def test_batch_leader_failure_propagates_and_frees_token(packed):
    arrays, params = _condition_request(packed, slice(0, 3))

    def scenario(pkg):
        class Boom:
            device = None

            def run(self, verb, arrays, params, rows=None):
                raise RuntimeError("device fell over")

        batcher = pkg.serve.batch.KernelBatcher(window_s=0)
        with pytest.raises(RuntimeError, match="device fell over"):
            batcher.run(Boom(), "condition", arrays, params)
        return sorted(batcher.run(pkg.executor(), "condition", arrays, params))

    res = _both(scenario)
    _assert_same(res)
    assert res["port"][0] == ["holds"]


def test_max_batch_is_validated_where_the_jax_env_warns():
    """The JAX package reads NEMO_MAX_BATCH and warns on junk; the port's
    knob is an argument (and the CLI's --max-batch), and junk raises."""
    assert TorchBackend(device="cpu", max_batch=8).max_batch == 8
    assert TorchBackend(device="cpu").max_batch is None
    for junk in ("banana", "8", 0, -3, 2.5, True):
        with pytest.raises(ValueError):
            TorchBackend(device="cpu", max_batch=junk)
