"""The fleet's observability on the CPU: the port's obs/federation.py,
serve/autoscale.py, the flight recorder's ``lease_steal`` trigger, the
metrics endpoint's federated page and extra routes, the router's trace
stitching and the sidecar's ``--profiler-port`` captures.

* ``federate``'s page byte-equal to the JAX package's on the same
  snapshots (labels, rollups, merged ladders, down replicas, collisions),
  and conformant: it parses;
* the ``Autoscaler``'s recommendation and document equal to the JAX
  package's over the same fed sequence, step by step, and its hysteresis;
* a stolen lease dumps one ``lease_steal`` bundle, with the context the JAX
  package's steal gives;
* ``start_http_server``'s ``render=`` and ``routes=``;
* ``Router._stitch_trailing`` against the JAX router's;
* a profiler capture holds the operators another thread ran meanwhile.

Lease TTLs are at least 0.2 s: the suite runs under several workers.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from nemo_tpu.obs import federation as jax_federation
from nemo_tpu.obs import flight as jax_flight
from nemo_tpu.serve.autoscale import Autoscaler as JaxAutoscaler
from nemo_tpu.store.rcache import Lease as JaxLease
from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import federation, flight, promexp
from nemo_tpu_torch.obs.promexp import parse_prometheus_text
from nemo_tpu_torch.serve.autoscale import Autoscaler
from nemo_tpu_torch.serve.router import _SPANS_MAX_BYTES, Router
from nemo_tpu_torch.store.rcache import Lease


def _replica_snap(requests: float, depth: float, step_s: list[float]) -> dict:
    m = obs.Metrics()
    m.inc("serve.requests", requests)
    m.gauge("serve.queue_depth", depth)
    for v in step_s:
        m.observe("serve.step_s", v)
    return m.snapshot()


def _own(rec: float | None = None) -> dict:
    m = obs.Metrics()
    if rec is not None:
        m.gauge("fleet.autoscale.recommendation", rec)
    return m.snapshot()


def _mixed_ladders() -> dict:
    a = obs.Metrics()
    for v in (0.0003, 0.02, 1.7):
        a.observe("serve.step_s", v)
    b = obs.Metrics()
    b.set_buckets("serve.step_s", (0.015, 0.15, 1.5))
    for v in (0.01, 0.1, 1.0, 9.0):
        b.observe("serve.step_s", v)
    return {"h:1": a.snapshot(), "h:2": b.snapshot()}


def _collision() -> dict:
    m = obs.Metrics()
    m.inc("serve.x", 1)
    m.inc("serve_x", 9)
    return {"h:1": m.snapshot()}


FEDERATION_CASES = {
    "labels_and_rollups": ({"h:1": _replica_snap(5, 3.0, [0.2]), "h:2": _replica_snap(8, 7.0, [0.4, 2.0])},
                           {"h:1": True, "h:2": True}, 1.0),
    "down_and_empty": ({"h:1": _replica_snap(2, 0.0, []), "h:2": {}}, {"h:1": True, "h:2": False}, None),
    "mixed_ladders": (_mixed_ladders(), None, None),
    "collision": (_collision(), None, None),
    "named_loopbacks": ({"replica-0": _replica_snap(1, 0.5, [0.001]), "replica-1": _replica_snap(3, 0.0, [9.0])},
                        {"replica-0": True, "replica-1": True}, -1.0),
}


@pytest.mark.parametrize("case", sorted(FEDERATION_CASES))
def test_federate_equals_the_jax_page(case):
    snaps, up, rec = FEDERATION_CASES[case]
    own = _own(rec)
    page = federation.federate(snaps, up=up, own_snapshot=own)
    assert page == jax_federation.federate(snaps, up=up, own_snapshot=own)
    parse_prometheus_text(page)


def test_federate_replica_labels_and_rollups():
    snaps, up, rec = FEDERATION_CASES["labels_and_rollups"]
    fams = parse_prometheus_text(federation.federate(snaps, up=up, own_snapshot=_own(rec)))
    by_replica = {lab.get("replica"): v for _, lab, v in fams["nemo_serve_requests_total"]["samples"]}
    assert by_replica == {"h:1": 5.0, "h:2": 8.0}
    assert [(lab, v) for _, lab, v in fams["nemo_fleet_serve_requests_total"]["samples"]] == [({}, 13.0)]
    assert {lab["agg"]: v for _, lab, v in fams["nemo_fleet_serve_queue_depth"]["samples"]} == {"max": 7.0, "min": 3.0}
    assert fams["nemo_fleet_autoscale_recommendation"]["samples"] == [("nemo_fleet_autoscale_recommendation", {},
                                                                       1.0)]
    assert {lab["replica"]: v for _, lab, v in fams["nemo_fleet_backend_up"]["samples"]} == {"h:1": 1.0, "h:2": 1.0}
    assert fams["nemo_fleet_backends_up"]["samples"][0][2] == 2.0
    assert fams["nemo_fleet_backends_total"]["samples"][0][2] == 2.0


def test_federate_down_backend_and_empty_snapshot():
    snaps, up, _ = FEDERATION_CASES["down_and_empty"]
    fams = parse_prometheus_text(federation.federate(snaps, up=up, own_snapshot=_own()))
    assert {lab["replica"]: v for _, lab, v in fams["nemo_fleet_backend_up"]["samples"]} == {"h:1": 1.0, "h:2": 0.0}
    assert fams["nemo_fleet_backends_up"]["samples"][0][2] == 1.0
    assert fams["nemo_fleet_serve_requests_total"]["samples"][0][2] == 2.0


def test_federate_histogram_merge_mixed_ladders_is_le_monotone():
    fams = parse_prometheus_text(federation.federate(_mixed_ladders(), own_snapshot=_own()))
    fleet = fams["nemo_fleet_serve_step_s"]
    buckets = [(lab["le"], v) for n, lab, v in fleet["samples"] if n.endswith("_bucket")]
    les = [le for le, _ in buckets]
    assert les == sorted(les, key=lambda s: float(s.replace("+Inf", "inf")))
    counts = [v for _, v in buckets]
    assert counts == sorted(counts)
    assert buckets[-1] == ("+Inf", 7.0)
    assert [v for n, _, v in fleet["samples"] if n.endswith("_count")] == [7.0]


def test_federate_sanitize_collision_keeps_first_and_stays_conformant():
    fams = parse_prometheus_text(federation.federate(_collision(), own_snapshot=_own()))
    samples = fams["nemo_serve_x_total"]["samples"]
    assert len([s for s in samples if s[1].get("replica") == "h:1"]) == 1


def test_fleet_name():
    assert federation.fleet_name("nemo_serve_x") == "nemo_fleet_serve_x"
    assert federation.fleet_name("other") == "nemo_fleet_other"


# --------------------------------------------------------------- autoscale


def _mk(depth: float, inflight: float, cap: float = 4.0, shed: float = 0.0) -> dict:
    return {"counters": {"serve.rejected": shed},
            "gauges": {"serve.queue_depth": depth, "serve.inflight": inflight, "serve.capacity": cap},
            "histograms": {}}


KNOBS = {
    "defaults": {},
    "fast": {"up_util": 0.5, "down_util": 0.1, "hold_up": 1, "hold_down": 2, "cooldown_s": 5.0},
    "slow": {"up_util": 0.9, "down_util": 0.3, "hold_up": 3, "hold_down": 4, "cooldown_s": 30.0},
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_equals_the_jax_autoscaler(knobs, seed):
    """The same fed sequence (three replicas, random depths, in-flight,
    capacities, sheds, liveness and clock steps): equal recommendation and
    document at every step."""
    rng = np.random.default_rng(seed)
    mine, theirs = Autoscaler(**KNOBS[knobs]), JaxAutoscaler(**KNOBS[knobs])
    names = ["h:1", "h:2", "replica-0"]
    sheds = dict.fromkeys(names, 0.0)
    now = 0.0
    for _ in range(120):
        now += float(rng.choice([0.5, 2.0, 10.0, 40.0]))
        snaps, up = {}, {}
        for n in names:
            up[n] = bool(rng.random() > 0.1)
            if rng.random() < 0.1:
                sheds[n] += float(rng.integers(1, 4))
            snaps[n] = {} if rng.random() < 0.05 else _mk(float(rng.integers(0, 12)), float(rng.integers(0, 5)),
                                                           float(rng.choice([2.0, 4.0, 8.0])), sheds[n])
        assert mine.update(snaps, up, now=now) == theirs.update(snaps, up, now=now)
        assert mine.doc() == theirs.doc()
        assert mine.recommendation == theirs.recommendation


def test_autoscale_up_needs_hold_up_polls():
    a = Autoscaler(up_util=0.8, down_util=0.2, hold_up=2, hold_down=5, cooldown_s=60.0)
    up = {"h:1": True}
    assert a.update({"h:1": _mk(6, 4)}, up, now=0.0) == 0
    assert a.update({"h:1": _mk(6, 4)}, up, now=1.0) == 1
    doc = a.doc()
    assert (doc["recommendation"], doc["desired_replicas"], doc["utilization"]) == (1, 2, 2.5)
    assert doc["thresholds"]["up_util"] == 0.8


def test_autoscale_shed_delta_forces_up():
    a = Autoscaler(up_util=0.8, down_util=0.2, hold_up=1, hold_down=5, cooldown_s=60.0)
    up = {"h:1": True}
    assert a.update({"h:1": _mk(0, 0, shed=10)}, up, now=0.0) in (0, -1)
    assert a.update({"h:1": _mk(0, 0, shed=12)}, up, now=1.0) == 1
    assert "shed" in a.doc()["reason"]


def test_autoscale_down_hysteresis_and_cooldown():
    a = Autoscaler(up_util=0.8, down_util=0.2, hold_up=1, hold_down=2, cooldown_s=30.0)
    up = {"h:1": True}
    assert a.update({"h:1": _mk(6, 4)}, up, now=0.0) == 1
    assert a.update({"h:1": _mk(0, 0)}, up, now=1.0) == 1
    assert a.update({"h:1": _mk(0, 0)}, up, now=2.0) == 1
    assert "cooling" in a.doc()["reason"]
    assert a.update({"h:1": _mk(0, 0)}, up, now=31.0) == -1
    assert a.doc()["desired_replicas"] == 1


def test_autoscale_no_live_replicas_scales_up():
    a = Autoscaler(hold_up=1, hold_down=5, cooldown_s=60.0)
    assert a.update({"h:1": {}}, {"h:1": False}, now=0.0) == 1
    doc = a.doc()
    assert (doc["replicas_live"], doc["reason"], doc["desired_replicas"]) == (0, "no live replicas", 1)


def test_autoscale_knobs_from_the_environment(monkeypatch):
    for name, value in (("NEMO_AUTOSCALE_UP", "0.7"), ("NEMO_AUTOSCALE_DOWN", "0.1"),
                        ("NEMO_AUTOSCALE_HOLD_UP", "3"), ("NEMO_AUTOSCALE_HOLD_DOWN", "6"),
                        ("NEMO_AUTOSCALE_COOLDOWN_S", "12")):
        monkeypatch.setenv(name, value)
    a = Autoscaler()
    assert (a.up_util, a.down_util, a.hold_up, a.hold_down, a.cooldown_s) == (0.7, 0.1, 3, 6, 12.0)
    monkeypatch.setenv("NEMO_AUTOSCALE_HOLD_UP", "many")
    assert Autoscaler().hold_up == JaxAutoscaler().hold_up == 2


# ------------------------------------------------------- the lease trigger


def _bundles(out_dir: str) -> list[str]:
    if not os.path.isdir(out_dir):
        return []
    return sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.startswith("flightrec-"))


def _steal(lease_cls, root: str) -> None:
    dead = lease_cls(root, "analyze_dir", "k", owner="dead", ttl_s=0.2)
    assert dead.try_acquire()
    time.sleep(0.4)
    assert lease_cls(root, "analyze_dir", "k", owner="h:2", ttl_s=0.2).try_acquire()


def test_lease_steal_dumps_one_bundle_as_the_jax_package(tmp_path):
    rec = flight.arm(str(tmp_path / "fr"), cooldown_s=0.0)
    jax_rec = jax_flight.arm(str(tmp_path / "jax-fr"), cooldown_s=0.0)
    try:
        before = obs.metrics.snapshot()
        _steal(Lease, str(tmp_path / "shared"))
        _steal(JaxLease, str(tmp_path / "jax-shared"))
        c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    finally:
        flight.disarm()
        jax_flight.disarm()
    ((mine,), (theirs,)) = _bundles(rec.out_dir), _bundles(jax_rec.out_dir)
    with open(mine, encoding="utf-8") as fh:
        doc = json.load(fh)
    with open(theirs, encoding="utf-8") as fh:
        jax_doc = json.load(fh)
    assert os.path.basename(mine).startswith("flightrec-lease_steal-")
    assert doc["otherData"]["reason"] == jax_doc["otherData"]["reason"] == "lease_steal"
    ctx = doc["otherData"]["context"]
    assert ctx == {"path": str(tmp_path / "shared" / "lease" / "analyze_dir" / "k.lease"), "new_owner": "h:2"}
    assert set(ctx) == set(jax_doc["otherData"]["context"])
    assert (c["rcache.lease_steal"], c["flight.dumps.lease_steal"]) == (1, 1)
    assert any(r.get("event") == "rcache.lease_stolen" for r in doc["otherData"]["logs"])


def test_lease_steal_unarmed_dumps_nothing(tmp_path):
    assert flight.recorder() is None
    before = obs.metrics.snapshot()
    _steal(Lease, str(tmp_path / "shared"))
    c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert c["rcache.lease_steal"] == 1 and "flight.dumps.lease_steal" not in c


def test_flight_trigger_matrix(tmp_path):
    rec = flight.arm(str(tmp_path / "fr"), cooldown_s=0.0)
    try:
        with obs.span("sched:device", verb="fused", index=3):
            pass
        reasons = {"breaker_trip": {"consecutive_failures": 3}, "dispatch_watchdog": {"verb": "fused"},
                   "shed_burst": {"sheds": 5}, "watch_cycle_failed": {"corpus": "/c"},
                   "lease_steal": {"path": "/l", "new_owner": "h:2"}}
        before = obs.metrics.snapshot()
        paths = {r: flight.trigger(r, **ctx) for r, ctx in reasons.items()}
        c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    finally:
        flight.disarm()
    assert len(_bundles(rec.out_dir)) == len(reasons)
    for reason, path in paths.items():
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        assert doc["otherData"]["reason"] == reason and doc["otherData"]["context"] == reasons[reason]
        assert "sched:device" in [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert c[f"flight.dumps.{reason}"] == 1


# --------------------------------------------------- the metrics endpoint


def _get(url: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as ex:
        return ex.code, b""


def test_metrics_endpoint_renders_and_routes():
    httpd, port = promexp.start_http_server(0, render=lambda: "# TYPE nemo_x gauge\nnemo_x 1\n",
                                            routes={"/autoscale": lambda: {"recommendation": 1},
                                                    "/broken": lambda: 1 / 0})
    try:
        base = f"http://127.0.0.1:{port}"
        assert _get(f"{base}/metrics") == (200, b"# TYPE nemo_x gauge\nnemo_x 1\n")
        status, body = _get(f"{base}/autoscale?x=1")
        assert status == 200 and json.loads(body) == {"recommendation": 1}
        status, body = _get(f"{base}/broken")
        assert status == 200 and "ZeroDivisionError" in json.loads(body)["error"]
        assert _get(f"{base}/healthz")[0] == 200
        assert _get(f"{base}/nope")[0] == 404
    finally:
        httpd.shutdown()


def test_metrics_endpoint_default_page_is_the_registry():
    obs.metrics.inc("obs_fleet_test.page_counter")
    httpd, port = promexp.start_http_server(0)
    try:
        status, body = _get(f"http://127.0.0.1:{port}/metrics")
    finally:
        httpd.shutdown()
    assert status == 200 and "nemo_obs_fleet_test_page_counter_total" in parse_prometheus_text(body.decode())


# ------------------------------------------------------- trace stitching


def test_router_stitch_trailing_equals_the_jax_router():
    pytest.importorskip("grpc")
    from nemo_tpu.serve.router import Router as JaxRouter

    replica_spans = [{"name": "serve:Analyze", "ts": 10, "dur": 5, "pid": 1, "tid": 1}]
    tm = (("nemo-spans-bin", json.dumps(replica_spans).encode("utf-8")), ("other", b"x"))
    router_span = {"name": "router:Analyze", "ts": 8, "dur": 9, "pid": 2, "tid": 1,
                   "args": {"backend": "h:1", "attempt": 0}}
    out = Router._stitch_trailing(tm, [router_span])
    assert out == JaxRouter._stitch_trailing(tm, [router_span])
    merged = json.loads(dict(out)["nemo-spans-bin"])
    assert [s["name"] for s in merged] == ["serve:Analyze", "router:Analyze"]
    fat = [{"name": "x" * _SPANS_MAX_BYTES, "ts": 0, "dur": 0}]
    assert "nemo-spans-bin" not in dict(Router._stitch_trailing(tm, fat))
    assert Router._stitch_trailing(tm, []) == tm


# ----------------------------------------------------- profiler captures


def test_profiler_capture_sees_other_threads():
    import torch

    from nemo_tpu_torch.service.server import start_profiler_server

    httpd, port = start_profiler_server(0, torch.device("cpu"))
    stop = threading.Event()

    def work() -> None:
        a = torch.rand(64, 64)
        while not stop.is_set():
            (a @ a).sum()

    t = threading.Thread(target=work)
    t.start()
    try:
        status, body = _get(f"http://127.0.0.1:{port}/capture?ms=150")
        bad = _get(f"http://127.0.0.1:{port}/capture?ms=0")[0], _get(f"http://127.0.0.1:{port}/other")[0]
    finally:
        stop.set()
        t.join()
        httpd.shutdown()
    assert status == 200
    names = {e.get("name") for e in json.loads(body)["traceEvents"]}
    assert "aten::mm" in names
    assert bad == (400, 404)
