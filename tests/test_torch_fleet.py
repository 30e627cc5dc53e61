"""The port's fleet (nemo_tpu_torch/serve/router.py, store/rcache.py's
shared tier and Lease, service/server.py's _fleet_single_flight) on the
CPU: every case of tests/test_fleet.py run on the port, and the port held
to the JAX package.  Every comparison is exact (bits, bytes or ints).

* the ring: placement a pure function of the backend names, the remap
  bounds, and ``ring_hash`` / ``HashRing`` equal to the JAX package's for
  the same names (a router of either package places a corpus alike);
* leases: exclusive, stolen once stale (counted), kept by a heartbeat,
  one winner among concurrent stealers;
* the shared tier: another replica's publish served, the publish race
  counted and never torn, a copy across filesystems verified by its own
  identities, ``off`` turning the tier off, eviction never sweeping a lease;
* ``_fleet_single_flight``: leader, follower, ``lease_error`` and the
  dead leader's re-election;
* the router over fake replicas (gRPC servers and in-process loopbacks):
  affinity, spill on a shedding home, failover on UNAVAILABLE, the plan and
  the health poll; over real port replicas on gRPC, the JAX client through
  the port's router; the ``--router`` process serving the federated page
  and ``/autoscale``, and exiting 0 on SIGTERM;
* across processes: two spawned replicas sharing one shared tier run one
  analysis for a cold herd, byte-identical, with outputs equal to the JAX
  sidecar's; a SIGKILLed leader's lease is stolen and counted once
  (chip_smoke.py:fleet_herd on cpu, phase 6p's legs (a) and (b)).

Lease TTLs are at least 0.2 s and deadlines generous: the suite runs under
several workers.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from nemo_tpu.serve.router import HashRing as JaxHashRing  # noqa: E402
from nemo_tpu.serve.router import ring_hash as jax_ring_hash  # noqa: E402
from nemo_tpu.service.client import RemoteAnalyzer as JaxRemoteAnalyzer  # noqa: E402
from nemo_tpu_torch import obs  # noqa: E402
from nemo_tpu_torch.serve.router import (  # noqa: E402
    HashRing,
    Router,
    RouterLoopback,
    make_router_server,
    ring_hash,
    route_key,
)
from nemo_tpu_torch.service.server import LoopbackContext, RpcError, StatusCode  # noqa: E402
from nemo_tpu_torch.store import rcache  # noqa: E402
from nemo_tpu_torch.store.rcache import Lease, ResultCache, resolve_result_cache  # noqa: E402
from nemo_tpu_torch.utils.subproc import PortReservation, free_port, wait_listening  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVICE = "nemo.NemoAnalysis"


def counters_delta(before):
    return obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]


# ------------------------------------------------------------------- ring


def test_ring_route_is_stable_across_instances():
    backends = ["h:1", "h:2", "h:3"]
    r1, r2 = HashRing(backends), HashRing(list(reversed(backends)))
    for i in range(200):
        key = f"/corpora/family_{i}"
        assert r1.route(key) == r2.route(key)


def test_ring_hash_is_not_python_hash():
    assert ring_hash("x") == ring_hash("x")
    assert ring_hash("x") != hash("x")


def test_ring_preference_covers_all_backends_distinct():
    r = HashRing(["a:1", "b:2", "c:3", "d:4"])
    pref = r.preference("/some/corpus")
    assert sorted(pref) == sorted(r.backends)
    assert len(set(pref)) == len(pref)
    assert pref[0] == r.route("/some/corpus")


def test_ring_distributes_keys_roughly():
    r = HashRing(["a:1", "b:2", "c:3"])
    owners = [r.route(f"/k/{i}") for i in range(600)]
    for b in r.backends:
        assert 0.15 < owners.count(b) / len(owners) < 0.55, b


def test_ring_add_backend_remaps_about_k_over_n():
    old = HashRing(["a:1", "b:2", "c:3"])
    new = HashRing(["a:1", "b:2", "c:3", "d:4"])
    keys = [f"/corpora/run_{i}" for i in range(1000)]
    moved = [k for k in keys if old.route(k) != new.route(k)]
    assert len(moved) / len(keys) < 0.45
    assert all(new.route(k) == "d:4" for k in moved)


def test_ring_remove_backend_only_moves_its_keys():
    full = HashRing(["a:1", "b:2", "c:3"])
    less = HashRing(["a:1", "c:3"])
    for i in range(500):
        k = f"/k/{i}"
        if full.route(k) != "b:2":
            assert less.route(k) == full.route(k)


def test_route_key_is_store_identity(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    alias = tmp_path / "alias"
    alias.symlink_to(d)
    assert route_key(str(alias)) == route_key(str(d))


@pytest.mark.parametrize("backends", [["h:1", "h:2", "h:3"], ["replica-0", "replica-1"],
                                      [f"10.0.0.{i}:50051" for i in range(7)]])
def test_ring_equals_the_jax_ring(backends):
    """Bit-equal ring positions and equal placements: a corpus lands on the
    same replica whichever package's router places it."""
    for s in backends + [f"/corpora/{i}" for i in range(50)]:
        assert ring_hash(s) == jax_ring_hash(s)
    mine, theirs = HashRing(backends), JaxHashRing(backends)
    for i in range(500):
        key = f"/corpora/family_{i}"
        assert mine.preference(key) == theirs.preference(key)


@pytest.mark.parametrize("request_bytes", [b"\xff", b"[1]", b'"x"', b'{"dirs": {"a": 1}}', b'{"dirs": []}',
                                           b'{"dir": 3}', b'{"dir": "/tmp/c"}', b'{"dirs": ["/tmp/c", "/x"]}',
                                           b'{"dir": "", "dirs": ["/tmp/d"]}'])
def test_routing_key_peek_equals_the_jax_router(request_bytes):
    """The one look the router takes inside a request: a malformed one
    routes by load (None), as the JAX router's."""
    from nemo_tpu.serve.router import _dir_key_of as jax_dir_key_of
    from nemo_tpu_torch.serve.router import _dir_key_of

    assert _dir_key_of(request_bytes) == jax_dir_key_of(request_bytes)


# ------------------------------------------------------------------ leases


@pytest.fixture
def shared_root(tmp_path):
    root = tmp_path / "shared"
    root.mkdir()
    return str(root)


def test_lease_acquire_is_exclusive(shared_root):
    a = Lease(shared_root, "analyze_dir", "k1", owner="A", ttl_s=30.0)
    b = Lease(shared_root, "analyze_dir", "k1", owner="B", ttl_s=30.0)
    assert a.try_acquire() and a.held
    assert not b.try_acquire() and not b.held
    a.release()
    assert not a.held
    assert b.try_acquire()
    b.release()


def test_lease_keys_are_independent(shared_root):
    a = Lease(shared_root, "analyze_dir", "k1", owner="A", ttl_s=30.0)
    b = Lease(shared_root, "analyze_dir", "k2", owner="B", ttl_s=30.0)
    assert a.try_acquire() and b.try_acquire()
    a.release()
    b.release()


def test_lease_stale_holder_is_stolen(shared_root):
    a = Lease(shared_root, "analyze_dir", "k1", owner="dead", ttl_s=0.5)
    assert a.try_acquire()
    b = Lease(shared_root, "analyze_dir", "k1", owner="B", ttl_s=0.5)
    assert not b.try_acquire()
    m0 = obs.metrics.snapshot()
    time.sleep(0.8)
    assert b.holder_stale()
    assert b.try_acquire()
    assert counters_delta(m0).get("rcache.lease_steal") == 1
    assert b.read_owner() == "B"
    a.release()  # stolen: the new leader's lease stays
    assert os.path.exists(b.path)
    b.release()
    assert not os.path.exists(b.path)


def test_lease_heartbeat_prevents_steal(shared_root):
    a = Lease(shared_root, "analyze_dir", "k1", owner="A", ttl_s=2.0)
    assert a.try_acquire()
    b = Lease(shared_root, "analyze_dir", "k1", owner="B", ttl_s=2.0)
    for _ in range(4):
        time.sleep(0.2)
        a.heartbeat()
        assert not b.try_acquire()
    a.release()


def test_lease_concurrent_stealers_elect_exactly_one(shared_root):
    dead = Lease(shared_root, "analyze_dir", "k1", owner="dead", ttl_s=1.0)
    assert dead.try_acquire()
    time.sleep(1.3)
    # A TTL well past the stealers' spread: the winner's fresh lease is
    # never stale to the others.
    leases = [Lease(shared_root, "analyze_dir", "k1", owner=f"s{i}", ttl_s=1.0) for i in range(6)]
    won: list[int] = []
    barrier = threading.Barrier(len(leases))

    def stealer(i: int) -> None:
        barrier.wait(timeout=10)
        if leases[i].try_acquire():
            won.append(i)

    threads = [threading.Thread(target=stealer, args=(i,)) for i in range(len(leases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(won) == 1


def test_lease_on_an_unusable_tier_is_broken(tmp_path):
    bad = tmp_path / "notadir"
    bad.write_text("a file where the shared tier should be")
    lease = Lease(str(bad), "analyze_dir", "k", owner="A", ttl_s=1.0)
    assert not lease.try_acquire() and lease.broken


# ------------------------------------------------------------ shared tier


def two_replica_caches(tmp_path, shared):
    return (ResultCache(str(tmp_path / "rc_a"), shared_root=shared),
            ResultCache(str(tmp_path / "rc_b"), shared_root=shared))


def test_shared_tier_serves_other_replicas_publish(tmp_path, shared_root):
    a, b = two_replica_caches(tmp_path, shared_root)
    assert a.put_blob("analyze_dir", "k" * 16, b"payload-bytes")
    m0 = obs.metrics.snapshot()
    assert b.load_blob("analyze_dir", "k" * 16) == b"payload-bytes"
    d = counters_delta(m0)
    assert d.get("rcache.blob_analyze_dir_shared_hit") == 1
    assert d.get("rcache.blob_analyze_dir_hit") == 1
    assert not d.get("rcache.blob_analyze_dir_miss")


def test_shared_tier_publish_race_is_counted_and_byte_identical(tmp_path, shared_root):
    a, b = two_replica_caches(tmp_path, shared_root)
    m0 = obs.metrics.snapshot()
    assert a.put_blob("analyze_dir", "race", b"same-content-bytes")
    assert b.put_blob("analyze_dir", "race", b"same-content-bytes")
    assert counters_delta(m0).get("rcache.publish_race", 0) >= 1
    assert a.load_blob("analyze_dir", "race") == b"same-content-bytes"
    assert b.load_blob("analyze_dir", "race") == b"same-content-bytes"
    with open(os.path.join(shared_root, "blob_analyze_dir", "race", "payload.bin"), "rb") as fh:
        assert fh.read() == b"same-content-bytes"


def test_shared_tier_concurrent_writers_one_entry(tmp_path, shared_root):
    caches = [ResultCache(str(tmp_path / f"rc_{i}"), shared_root=shared_root) for i in range(6)]
    barrier = threading.Barrier(len(caches))

    def publish(i: int) -> None:
        barrier.wait(timeout=10)
        caches[i].put_blob("analyze_dir", "hotkey", b"identical")

    threads = [threading.Thread(target=publish, args=(i,)) for i in range(len(caches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    kdir = os.path.join(shared_root, "blob_analyze_dir")
    assert [n for n in os.listdir(kdir) if ".tmp-" not in n] == ["hotkey"]
    assert not [n for n in os.listdir(kdir) if ".tmp-" in n]
    for c in caches:
        assert c.load_blob("analyze_dir", "hotkey") == b"identical"


def test_blob_present_probe(tmp_path, shared_root):
    a, b = two_replica_caches(tmp_path, shared_root)
    assert not b.blob_present("analyze_dir", "later")
    a.put_blob("analyze_dir", "later", b"x")
    assert b.blob_present("analyze_dir", "later")


def test_shared_copy_records_its_own_identity(tmp_path, shared_root, monkeypatch):
    """Across filesystems the replication copies: the shared entry's
    manifest must name the copies' identities (inodes), or every other
    replica's verify rejects the entry."""

    def no_hardlinks(src, dst):
        raise OSError("cross-device link")

    monkeypatch.setattr(rcache.os, "link", no_hardlinks)
    a, b = two_replica_caches(tmp_path, shared_root)
    assert a.put_blob("analyze_dir", "copied", b"copied-bytes")
    local = os.path.join(a.root, "blob_analyze_dir", "copied", "payload.bin")
    shared = os.path.join(shared_root, "blob_analyze_dir", "copied", "payload.bin")
    assert os.stat(local).st_ino != os.stat(shared).st_ino
    m0 = obs.metrics.snapshot()
    assert b.load_blob("analyze_dir", "copied") == b"copied-bytes"
    d = counters_delta(m0)
    assert d.get("rcache.blob_analyze_dir_shared_hit") == 1 and not d.get("rcache.blob_analyze_dir_stale")


def test_shared_entry_written_in_place_is_stale(tmp_path, shared_root):
    a, b = two_replica_caches(tmp_path, shared_root)
    assert a.put_blob("analyze_dir", "k", b"12345678")
    with open(os.path.join(shared_root, "blob_analyze_dir", "k", "payload.bin"), "ab") as fh:
        fh.write(b"!")
    m0 = obs.metrics.snapshot()
    assert b.load_blob("analyze_dir", "k") is None
    d = counters_delta(m0)
    assert d.get("rcache.blob_analyze_dir_stale") == 1 and not d.get("rcache.blob_analyze_dir_miss")


def test_resolve_off_kills_shared_tier_too(monkeypatch, shared_root):
    monkeypatch.setenv("NEMO_RESULT_CACHE", "off")
    monkeypatch.setenv("NEMO_RCACHE_SHARED", shared_root)
    assert resolve_result_cache() is None


def test_resolve_shared_as_primary(monkeypatch, shared_root):
    monkeypatch.setenv("NEMO_RESULT_CACHE", shared_root)
    monkeypatch.setenv("NEMO_RCACHE_SHARED", shared_root)
    rc = resolve_result_cache()
    assert rc.root == shared_root and rc.shared_root is None and rc.lease_root == shared_root


def test_resolve_no_shared_has_no_lease_root(monkeypatch, tmp_path):
    monkeypatch.setenv("NEMO_RESULT_CACHE", str(tmp_path / "rc"))
    monkeypatch.delenv("NEMO_RCACHE_SHARED", raising=False)
    rc = resolve_result_cache()
    assert rc.shared_root is None and rc.lease_root is None


def test_eviction_never_sweeps_leases(monkeypatch, shared_root):
    monkeypatch.setattr(rcache, "RESULT_CACHE_MAX_BYTES", 1)
    rc = ResultCache(shared_root)
    lease = Lease(shared_root, "analyze_dir", "held", owner="A", ttl_s=60.0)
    assert lease.try_acquire()
    for i in range(4):
        rc.put_blob("analyze_dir", f"k{i}", b"x" * 512)
    assert os.path.exists(lease.path)
    lease.release()


# ------------------------------------------------- cross-replica single flight


@pytest.fixture
def impl():
    from nemo_tpu_torch import serve
    from nemo_tpu_torch.service.server import _Impl

    serve.reset_controller()
    serve.reset_flights()
    serve.reset_batcher()
    yield _Impl("cpu")
    serve.reset_controller()
    serve.reset_flights()
    serve.reset_batcher()


def _fleet_rc(tmp_path, shared):
    return ResultCache(str(tmp_path / "rc_local"), shared_root=shared)


def test_fleet_uncontended_leader_runs_once(impl, tmp_path, shared_root, monkeypatch):
    monkeypatch.setenv("NEMO_LEASE_TTL_S", "5")
    rc = _fleet_rc(tmp_path, shared_root)
    calls = []

    def run() -> bytes:
        calls.append(1)
        rc.put_blob("analyze_dir", "ckey", b"fresh-bytes")
        return b"fresh-bytes"

    m0 = obs.metrics.snapshot()
    assert impl._fleet_single_flight(rc, "ckey", run, None) == (b"fresh-bytes", "leader")
    assert calls == [1]
    d = counters_delta(m0)
    assert d.get("serve.fleet.leader") == 1 and not d.get("serve.fleet.follower")
    assert Lease(shared_root, "analyze_dir", "ckey", ttl_s=5).try_acquire()


def test_fleet_follower_waits_for_leaders_publish(impl, tmp_path, shared_root, monkeypatch):
    monkeypatch.setenv("NEMO_LEASE_TTL_S", "10")
    rc_leader = _fleet_rc(tmp_path / "r0", shared_root)
    rc_follow = _fleet_rc(tmp_path / "r1", shared_root)
    leader_lease = Lease(shared_root, "analyze_dir", "herd", owner="r0", ttl_s=10)
    assert leader_lease.try_acquire()

    def publish_later() -> None:
        time.sleep(0.3)
        rc_leader.put_blob("analyze_dir", "herd", b"leader-bytes")
        leader_lease.release()

    t = threading.Thread(target=publish_later)
    t.start()
    ran = []
    m0 = obs.metrics.snapshot()
    payload, role = impl._fleet_single_flight(rc_follow, "herd", lambda: ran.append(1) or b"local", None)
    t.join()
    assert (payload, role) == (b"leader-bytes", "follower")
    assert not ran
    assert counters_delta(m0).get("serve.fleet.follower") == 1


def test_fleet_broken_lease_tier_executes_locally(impl, tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_LEASE_TTL_S", "5")
    bad = tmp_path / "notadir"
    bad.write_text("a file where the shared tier should be")
    rc = ResultCache(str(tmp_path / "rc_local"), shared_root=str(bad))
    ran = []
    m0 = obs.metrics.snapshot()
    t0 = time.monotonic()
    payload, role = impl._fleet_single_flight(rc, "brokenkey", lambda: ran.append(1) or b"local-bytes", None)
    assert (payload, role) == (b"local-bytes", "lease_error")
    assert ran == [1]
    assert time.monotonic() - t0 < 5.0
    d = counters_delta(m0)
    assert d.get("serve.fleet.lease_error") == 1 and not d.get("serve.fleet.follower")


def test_fleet_dead_leader_reelects(impl, tmp_path, shared_root, monkeypatch):
    monkeypatch.setenv("NEMO_LEASE_TTL_S", "1.0")
    rc = _fleet_rc(tmp_path, shared_root)
    dead = Lease(shared_root, "analyze_dir", "crashed", owner="dead", ttl_s=1.0)
    assert dead.try_acquire()
    ran = []

    def run() -> bytes:
        ran.append(1)
        rc.put_blob("analyze_dir", "crashed", b"reelected-bytes")
        return b"reelected-bytes"

    m0 = obs.metrics.snapshot()
    assert impl._fleet_single_flight(rc, "crashed", run, None) == (b"reelected-bytes", "leader")
    assert ran == [1]
    d = counters_delta(m0)
    assert d.get("rcache.lease_steal") == 1
    assert d.get("serve.fleet.follower") == 1 and d.get("serve.fleet.leader") == 1


def test_fleet_client_gone_frees_the_follower(impl, tmp_path, shared_root, monkeypatch):
    monkeypatch.setenv("NEMO_LEASE_TTL_S", "30")
    rc = _fleet_rc(tmp_path, shared_root)
    live = Lease(shared_root, "analyze_dir", "busy", owner="other", ttl_s=30)
    assert live.try_acquire()
    ctx = LoopbackContext()
    ctx.active = False
    m0 = obs.metrics.snapshot()
    with pytest.raises(TimeoutError):
        impl._fleet_single_flight(rc, "busy", lambda: b"never", ctx)
    assert counters_delta(m0).get("serve.fleet.client_gone") == 1
    live.release()


def test_health_document_names_the_replica(impl):
    from nemo_tpu_torch.service.server import _health_state, _replica_id

    doc = _health_state(impl)
    assert doc["replica"] == _replica_id() and doc["replica"].endswith(f"-{os.getpid()}")


# ------------------------------------------------------------------ router


class _FakeBackend:
    """A raw-bytes NemoAnalysis replica on gRPC: AnalyzeDir answers with an
    identifying payload (or a scripted admission rejection), Health with a
    depth gauge in its trailing metadata."""

    def __init__(self, name: str, depth: float = 0.0) -> None:
        from concurrent import futures

        self.name = name
        self.depth = depth
        self.reject_analyze_dir = False
        self.served: list[bytes] = []

        def analyze_dir(request: bytes, context):
            if self.reject_analyze_dir:
                context.set_trailing_metadata((("nemo-retry-after-s", "0.5"),))
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "queue full (scripted)")
            self.served.append(request)
            return f"{self.name}:".encode() + request

        def health(request: bytes, context):
            context.set_trailing_metadata(
                (("nemo-metrics-bin", json.dumps({"gauges": {"serve.queue_depth": self.depth}}).encode()),))
            return b"\x12\x03cpu"

        handlers = {"AnalyzeDir": grpc.unary_unary_rpc_method_handler(analyze_dir),
                    "Health": grpc.unary_unary_rpc_method_handler(health)}
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self.server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.target = f"127.0.0.1:{self.port}"
        self.server.start()

    def stop(self) -> None:
        self.server.stop(grace=None).wait(timeout=5)


class _FakeLoopback:
    """The same replica in process, as a named loopback: ``call`` as
    server.Loopback's."""

    def __init__(self, name: str, depth: float = 0.0) -> None:
        self.name = name
        self.target = self
        self.depth = depth
        self.reject_analyze_dir = False
        self.down = False
        self.served: list[bytes] = []

    def call(self, name: str, request: bytes, metadata=None):
        ctx = LoopbackContext(metadata)
        if self.down:
            raise RpcError(StatusCode.UNAVAILABLE, "replica stopped")
        if name == "Health":
            ctx.set_trailing_metadata(
                (("nemo-metrics-bin", json.dumps({"gauges": {"serve.queue_depth": self.depth}}).encode()),))
            return b"\x12\x03cpu", ctx
        if self.reject_analyze_dir:
            ctx.set_trailing_metadata((("nemo-retry-after-s", "0.5"),))
            ctx.abort(StatusCode.RESOURCE_EXHAUSTED, "queue full (scripted)")
        self.served.append(request)
        return f"{self.name}:".encode() + request, ctx

    def stop(self) -> None:
        self.down = True


class _Front:
    """The router in front of a fake fleet: over gRPC (make_router_server
    and a raw channel) or in process (RouterLoopback)."""

    def __init__(self, kind: str, fleet: list) -> None:
        self.kind = kind
        targets = [b.target for b in fleet]
        if kind == "grpc":
            self.server, port, self.router = make_router_server(0, targets)
            self.server.start()
            self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            self._call = self.channel.unary_unary(f"/{SERVICE}/AnalyzeDir")
        else:
            self.router = Router(targets)
            self.loopback = RouterLoopback(self.router)

    def analyze_dir(self, req: bytes) -> bytes:
        if self.kind == "grpc":
            return self._call(req, timeout=15)
        return self.loopback.call("AnalyzeDir", req)[0]

    def close(self) -> None:
        if self.kind == "grpc":
            self.channel.close()
            self.server.stop(grace=None)
        self.router.stop()


@pytest.fixture(params=["grpc", "loopback"])
def fake_fleet(request):
    make = _FakeBackend if request.param == "grpc" else _FakeLoopback
    backends = [make("r0"), make("r1")]
    yield request.param, backends
    for b in backends:
        b.stop()


def _name(b) -> str:
    return b.target if isinstance(b.target, str) else b.name


def _key_for(ring: HashRing, backend: str, tmp_path) -> str:
    for i in range(512):
        d = tmp_path / f"corpus_{i}"
        if ring.route(route_key(str(d))) == backend:
            d.mkdir(exist_ok=True)
            return str(d)
    raise AssertionError("no key found for the backend")


def test_router_affinity_and_proxy(fake_fleet, tmp_path):
    kind, fleet = fake_fleet
    front = _Front(kind, fleet)
    try:
        for owner in fleet:
            d = _key_for(front.router.ring, _name(owner), tmp_path)
            req = json.dumps({"dir": d}).encode()
            for _ in range(3):
                assert front.analyze_dir(req) == f"{owner.name}:".encode() + req
        assert len(fleet[0].served) == 3 and len(fleet[1].served) == 3
    finally:
        front.close()


def test_router_spill_on_admission_rejection(fake_fleet, tmp_path):
    kind, fleet = fake_fleet
    front = _Front(kind, fleet)
    try:
        d0 = _key_for(front.router.ring, _name(fleet[0]), tmp_path)
        fleet[0].reject_analyze_dir = True
        m0 = obs.metrics.snapshot()
        req = json.dumps({"dir": d0}).encode()
        assert front.analyze_dir(req) == b"r1:" + req
        assert counters_delta(m0).get("router.spill") == 1
    finally:
        front.close()


def test_router_failover_on_unavailable(fake_fleet, tmp_path):
    kind, fleet = fake_fleet
    front = _Front(kind, fleet)
    try:
        d0 = _key_for(front.router.ring, _name(fleet[0]), tmp_path)
        req = json.dumps({"dir": d0}).encode()
        assert front.analyze_dir(req) == b"r0:" + req
        fleet[0].stop()
        m0 = obs.metrics.snapshot()
        assert front.analyze_dir(req) == b"r1:" + req
        assert counters_delta(m0).get("router.failover", 0) >= 1
        assert not front.router.backend_states()[_name(fleet[0])]["up"]
    finally:
        front.close()


def test_router_plan_prefers_live_and_spills_on_depth(fake_fleet, monkeypatch):
    _kind, fleet = fake_fleet
    router = Router([b.target for b in fleet])
    try:
        key = "/any/corpus"
        home = router.ring.route(key)
        other = next(_name(b) for b in fleet if _name(b) != home)
        assert router.plan(key)[0] == home
        router._mark_down(home)
        assert router.plan(key) == [other, home]
        with router._lock:
            router._up[home] = True
        monkeypatch.setenv("NEMO_ROUTER_SPILL_DEPTH", "4")
        with router._lock:
            router._depth[home] = 9.0
            router._depth[other] = 1.0
        assert router.plan(key)[0] == other
        assert router.plan(None)[0] == other
    finally:
        router.stop()


def test_router_health_poll_reads_depth(fake_fleet):
    _kind, fleet = fake_fleet
    fleet[0].depth = 7.0
    router = Router([b.target for b in fleet])
    try:
        router.poll_health()
        states = router.backend_states()
        assert all(s["up"] for s in states.values())
        assert states[_name(fleet[0])]["depth"] == 7.0
        snaps, up = router.fleet_snapshots()
        assert snaps[_name(fleet[0])]["gauges"]["serve.queue_depth"] == 7.0 and all(up.values())
    finally:
        router.stop()


def test_router_refuses_two_backends_of_one_name():
    with pytest.raises(ValueError, match="two backends named"):
        Router([_FakeLoopback("same"), _FakeLoopback("same")])


# -------------------------------------------------- the router over real replicas


@pytest.fixture
def port_fleet(tmp_path, monkeypatch):
    """Two port replicas on gRPC (cpu), one shared tier, and the port's
    router in front of them."""
    from nemo_tpu_torch import serve
    from nemo_tpu_torch.service.server import make_server

    monkeypatch.setenv("NEMO_CORPUS_CACHE", str(tmp_path / "cc"))
    monkeypatch.setenv("NEMO_RESULT_CACHE", str(tmp_path / "rc"))
    monkeypatch.setenv("NEMO_RCACHE_SHARED", str(tmp_path / "shared"))
    for reset in (serve.reset_controller, serve.reset_flights, serve.reset_batcher):
        reset()
    servers = [make_server(port=0, device="cpu") for _ in range(2)]
    for s, _ in servers:
        s.start()
    targets = [f"127.0.0.1:{p}" for _, p in servers]
    rserver, rport, router = make_router_server(0, targets)
    rserver.start()
    yield f"127.0.0.1:{rport}", targets, router
    rserver.stop(grace=None)
    router.stop()
    for s, _ in servers:
        s.stop(grace=None)
    for reset in (serve.reset_controller, serve.reset_flights, serve.reset_batcher):
        reset()


def test_jax_client_through_the_port_router(port_fleet, corpus_dir, sidecar):
    """The JAX client through the port's router to port replicas: the
    outputs of the JAX sidecar; the repeat is a result-cache hit on the
    same replica; Health through the router describes both replicas."""
    router_target, targets, router = port_fleet
    with JaxRemoteAnalyzer(target=router_target, timeout=120) as client:
        got = client.analyze_dir_remote(corpus_dir)
        again = client.analyze_dir_remote(corpus_dir)
        health = client.health()
    with JaxRemoteAnalyzer(target=sidecar, timeout=120) as client:
        want = client.analyze_dir_remote(corpus_dir)
    for out in (got, again):
        assert set(out) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(want[k]), err_msg=k)
    assert set(health["metrics"]["replicas"]) == set(targets)
    assert all(health["metrics"]["up"].values())


def test_router_process_serves_the_fleet_page_and_drains(tmp_path):
    """``--router --backends`` in a process of its own over a port replica:
    a routed Health, the federated /metrics with the replica's label,
    /autoscale, /healthz; SIGTERM exits 0."""
    from nemo_tpu_torch.service.client import RemoteAnalyzer
    from nemo_tpu_torch.service.server import make_server

    server, port = make_server(port=0, device="cpu")
    server.start()
    with PortReservation(2) as res:
        rport, mport = res.ports
        res.release(0)
        res.release(1)
        env = dict(os.environ, PYTHONPATH=REPO, NEMO_ROUTER_HEALTH_S="0.2",
                   NEMO_FLIGHT_DIR=str(tmp_path / "flight"))
        proc = subprocess.Popen([sys.executable, "-m", "nemo_tpu_torch.service.server", "--router", "--backends",
                                 f"127.0.0.1:{port}", "--port", str(rport), "--metrics-port", str(mport)],
                                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        wait_listening(rport, 60, proc)
        wait_listening(mport, 60, proc)
        with RemoteAnalyzer(f"127.0.0.1:{rport}", timeout=30) as client:
            health = client.health()
        assert health["platform"] == "cpu" and list(health["metrics"]["replicas"]) == [f"127.0.0.1:{port}"]
        deadline = time.monotonic() + 30
        while True:
            page = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
            if f'replica="127.0.0.1:{port}"' in page or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert f'nemo_fleet_backend_up{{replica="127.0.0.1:{port}"}} 1' in page
        assert "nemo_fleet_autoscale_recommendation" in page
        doc = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/autoscale", timeout=10).read())
        assert doc["replicas_live"] == 1 and "thresholds" in doc
        hz = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10).read())
        assert hz["role"] == "router" and hz["replicas_up"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop(grace=None)


def test_router_without_backends_exits_2(monkeypatch):
    from nemo_tpu_torch.service.server import main

    monkeypatch.delenv("NEMO_FLEET_REPLICAS", raising=False)
    assert main(["--router"]) == 2


# ------------------------------------------------------- across processes


def test_fleet_herd_across_processes(tmp_path, sidecar):
    """Phase 6p's legs (a) and (b) on cpu (chip_smoke.py:fleet_herd): two
    spawned replicas sharing one shared tier serve a cold herd with one
    analysis, byte-identical; a SIGKILLed leader's lease is stolen and
    counted once; the outputs equal the JAX sidecar's."""
    from chip_smoke import fleet_herd
    from nemo_tpu_torch.models.case_studies import write_case_study
    from nemo_tpu_torch.query.engine import ingest_corpus

    # 300 runs: the leader's fused step on the CPU (~0.1 s) is the window in
    # which the other replica must find no published blob yet.
    d = write_case_study("ZK-1270-racing-sent-flag", 300, 0, str(tmp_path / "corpora"))
    cc = str(tmp_path / "corpus-cache")
    ingest_corpus(d, cc)
    out, launches = fleet_herd(str(tmp_path / "fleet"), d, cc, device="cpu")
    assert sorted(out["herd"]["roles"].values()) == ["follower", "leader"]
    assert out["dead_leader"]["lease_steal"] == 1 and len(out["dead_leader"]["bundles"]) == 1
    assert out["dead_leader"]["leader_exit"] == -9
    assert launches == {"closure": 0, "edge_wave": 0}
    with JaxRemoteAnalyzer(target=sidecar, timeout=120) as client:
        want = client.analyze_dir_remote(d)
    got = out["reference"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------------- ports


def test_free_port_never_repeats_recent():
    ports = [free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)


def test_port_reservation_holds_and_releases():
    import socket

    with PortReservation(6) as res:
        assert len(set(res.ports)) == 6
        s = socket.socket()
        with pytest.raises(OSError):
            s.bind(("127.0.0.1", res.ports[0]))
        s.close()
        p = res.release(0)
        s2 = socket.socket()
        s2.bind(("127.0.0.1", p))
        s2.close()
    s3 = socket.socket()
    s3.bind(("127.0.0.1", res.ports[1]))
    s3.close()


def test_port_reservation_distinct_from_free_port():
    with PortReservation(4) as res:
        for _ in range(32):
            assert free_port() not in set(res.ports)
