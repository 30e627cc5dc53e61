"""The port's obs counters against the JAX package's, on the CPU.

Each package records into its own registry; a test reads both registries'
deltas around the same work on the same corpus and holds them equal,
series for series:

* **the report path**: the six families and a synthetic corpus through
  both ``run_debug``s, the JAX side under ``NEMO_ANALYSIS_IMPL=crossover``
  (the routes of tests/test_torch_routes.py), then on the port's device
  lanes (every host budget 0, or dense forced) against the JAX side forced
  dense; then with the corpus store and the result cache on, cold, warm
  and grown.  Every counter series of either delta is compared but the
  ``EXCLUDED`` ones, and every histogram's observation count;
* **the query**: bench.py's query over the families, its ``query.*`` and
  ``kernel.dispatches.query`` counters, lanes forced both ways;
* **the watch loop**: the events of one replay, from both watchers, equal
  field for field but walls, paths and generation names;
* **names**: every series the port's source emits is a row of
  docs/METRICS.md (``tools/metrics_doc.py``'s ``harvest()`` over
  ``nemo_tpu_torch/``): the port adds no name;
* **the platform profile**: one report under a shared measured profile,
  its ``profile.*`` counters and every other series equal;
* **the scheduler**: a report of several buckets with both packages'
  scheduler on (``analysis.sched.jobs`` and ``sched.breaker.*``), and
  bench.py's query through both schedulers' serial drain on fresh models
  (every ``analysis.sched.*`` counter and wall count);
* **chaos**: an injected dispatch fault failed over to the host lane by
  both schedulers, ``chaos.injected.*`` and every other series compared;
* **names**: the port's only series the JAX package lacks is
  ``PORT_ONLY``'s.
"""

import importlib.util
import os
import shutil
import threading
from pathlib import Path

import pytest
import torch

from nemo_tpu import obs as jax_obs
from nemo_tpu.analysis.pipeline import _ingest as jax_ingest
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.synth import synth_impl_env
from nemo_tpu.backend import jax_backend as jax_backend_mod
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.query.engine import run_query_text as jax_run_query_text
from nemo_tpu.watch import WatchConfig as JaxWatchConfig
from nemo_tpu.watch import Watcher as JaxWatcher
from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis.pipeline import run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.adapters import MollyInjector
from nemo_tpu_torch.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, grow_corpus_dir, write_corpus
from nemo_tpu_torch.query.engine import ingest_corpus, run_query_text
from nemo_tpu_torch.watch import WatchConfig, Watcher, replay_plan

REPO = Path(__file__).resolve().parent.parent
RUNS = 12
CORPORA = sorted(CASE_STUDIES) + ["synth"]

#: Series the comparison leaves out, each with its reason (ROADMAP Queue C
#: carries the same list).  A series is left out of both sides.
EXCLUDED = {
    "kernel.compiles": "jit-cache growth; eager PyTorch has no jit",
    "kernel.cache_hits": "jit-cache growth; eager PyTorch has no jit",
    "kernel.compile_s": "the compile wall of a jit; eager PyTorch has none",
    "kernel.cost.flops": "XLA cost_analysis; the port's cost table records None",
    "kernel.cost.bytes_accessed": "XLA cost_analysis; the port's cost table records None",
    "kernel.upload_bytes": "the inputs' dtypes differ: the JAX package narrows the fused planes "
                           "(_narrow_fused_arrays), the port sends its packed dtypes",
    "render.rendered": "unique renders drawn, against the JAX package's persistent SVG cache",
    "render.render_s": "a wall, not a count",
    "render.svg_cache_misses": "the persistent SVG cache is not ported",
    "stream.prefetch_stall_s": "a wall, not a count",
    "rcache.restore_s": "a wall, not a count",
    "store.load_s": "a wall, not a count",
    "stream.stage_s": "a wall, not a count",
    "watch.update_latency_s": "a wall, not a count",
    "kernel.sharded_dispatches": "the JAX side shards the fused dispatch over the suite's 8 virtual CPU devices; "
                                 "the port has one device and no mesh",
    "analysis.shard.gather_bytes": "the mesh's gather, as kernel.sharded_dispatches",
    "analysis.shard.gather_s": "the mesh's gather, as kernel.sharded_dispatches",
}

#: Series the port emits that the JAX package has no counterpart of, each
#: with its reason (ROADMAP Queue C carries the same list).
PORT_ONLY = {
    "profile.fold_back_error": "a failed fold-back at exit is counted and raised; the JAX package swallows it",
    "analysis.sched.abandoned_error": "an error a dispatch abandoned past its deadline raises later is counted and "
                                      "raised by the device's next run; the JAX package drops it",
}

#: The port's device lanes (tests/test_torch_report.py).
DEVICE_LANES = {
    "device_auto": {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0},
    "dense": {"analysis_impl": "dense"},
}

BENCH_QUERY = (
    "from pre "
    "match goal[holds=true] -> @rule "
    "match goal[holds=false] -*-> @rule[type=async] "
    "match @goal -> rule -> goal "
    "count by table"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_device_auto(monkeypatch):
    """The JAX side's device-backend routing, serial, seeded budgets (the
    setting of tests/test_torch_routes.py)."""
    for name, value in (("NEMO_ANALYSIS_IMPL", "crossover"), ("NEMO_GIANT_IMPL", "sparse_device"),
                        ("NEMO_SCHED", "off"), ("NEMO_PROFILE", "off")):
        monkeypatch.setenv(name, value)
    for name in ("NEMO_ANALYSIS_HOST_WORK", "NEMO_DIFF_HOST_WORK", "NEMO_SYNTH_HOST_WORK", "NEMO_SYNTH_IMPL",
                 "NEMO_SPARSE_DEVICE_MEM_MB", "NEMO_GIANT_V", "NEMO_STREAM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(JaxBackend, "_resolve_synth_impl", lambda self: synth_impl_env())


@pytest.fixture(scope="module")
def corpora(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("obs_parity"))
    out = {name: write_case_study(name, RUNS, 0, root) for name in sorted(CASE_STUDIES)}
    out["synth"] = write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), root)
    return out


def _delta(obs_mod, fn):
    before = obs_mod.metrics.snapshot()
    out = fn()
    return out, obs_mod.Metrics.delta(obs_mod.metrics.snapshot(), before)


def _view(delta: dict) -> dict:
    """The compared view of one delta: every counter and every
    histogram's count, the EXCLUDED series left out."""
    out = {k: v for k, v in delta["counters"].items() if k not in EXCLUDED}
    out.update({f"{k}#count": h["count"] for k, h in delta["histograms"].items() if k not in EXCLUDED})
    return out


def _assert_same(port: dict, jax: dict) -> None:
    mine, theirs = _view(port), _view(jax)
    diff = {k: (mine.get(k), theirs.get(k)) for k in sorted(set(mine) | set(theirs)) if mine.get(k) != theirs.get(k)}
    assert diff == {}


def _reports(corpus: str, tmp_path, port_kw: dict, *, ingest="native", cc="off", rc="off", tag="") -> tuple:
    port = _delta(obs, lambda: run_debug(corpus, str(tmp_path / f"port{tag}"), TorchBackend(device="cpu", **port_kw),
                                         figures="all", ingest=ingest, corpus_cache=cc, result_cache=rc))
    jax = _delta(jax_obs, lambda: jax_run_debug(corpus, str(tmp_path / f"jax{tag}"), JaxBackend(), figures="all",
                                                ingest=ingest, corpus_cache=cc, result_cache=rc))
    return port, jax


@pytest.mark.parametrize("name", CORPORA)
def test_report_counters_match_jax_default_routes(corpora, name, tmp_path):
    (res, port), (_, jax) = _reports(corpora[name], tmp_path, {})
    _assert_same(port, jax)
    c = port["counters"]
    assert c["render.figures"] > 0 and c["delta.runs_mapped"] == len(res.molly.runs)
    assert any(k.startswith("kernel.dispatches.") for k in c)


def test_report_counters_match_jax_under_one_measured_profile(corpora, tmp_path, monkeypatch):
    """The same measured constants in each package's own profile file, both
    packages on auto: the profile's counters (profile.loaded) and every
    other series equal, the budgets routing both sides alike."""
    from nemo_tpu.platform import profile as jax_pp
    from nemo_tpu_torch.platform import profile as pp

    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path / "plat"))
    consts = {"analysis_host_work": 100.0, "synth_host_work": 100.0, "diff_host_work": 10.0,
              "sched_host_unit": 3e-7, "sched_device_fixed": 0.004}
    for mod, fp in ((pp, pp.platform_fingerprint("cpu")), (jax_pp, jax_pp.platform_fingerprint())):
        mod.reset_active_profile()
        prof = mod.PlatformProfile(fp)
        for k, v in consts.items():
            prof.set_constant(k, v)
        prof.save()
    try:
        (_, port), (_, jax) = _reports(corpora["ZK-1270-racing-sent-flag"], tmp_path, {})
    finally:
        pp.reset_active_profile()
        jax_pp.reset_active_profile()
    _assert_same(port, jax)
    c = port["counters"]
    assert c["profile.loaded"] == 1 and not c.get("profile.calibrated") and not c.get("profile.stale")
    assert c["kernel.dispatches.fused"] > 0 and c["kernel.dispatches.diff"] == 1


@pytest.mark.parametrize("lanes", sorted(DEVICE_LANES))
@pytest.mark.parametrize("name", CORPORA)
def test_report_counters_match_jax_device_lanes(corpora, name, lanes, tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    monkeypatch.setenv("NEMO_SYNTH_HOST_WORK", "0")
    (_, port), (_, jax) = _reports(corpora[name], tmp_path, DEVICE_LANES[lanes])
    _assert_same(port, jax)
    c = port["counters"]
    assert c["kernel.dispatches.fused"] > 0 and not any(
        k in c for k in ("kernel.dispatches.sparse_fused", "kernel.dispatches.sparse_diff",
                         "kernel.dispatches.synth_host"))
    assert port["histograms"]["kernel.batch_rows"]["count"] == c["kernel.dispatches.fused"]


def test_cache_counters_match_jax_cold_warm_grown(tmp_path):
    """Store, result-cache and delta counters of a cold report, a
    whole-report hit and a grown corpus, each package on its own copy of
    the corpus and its own cache roots."""
    full = write_corpus(SynthSpec(n_runs=10, seed=5), str(tmp_path / "full"))
    dirs = {side: str(tmp_path / side / "pb_synth") for side in ("port", "jax")}
    for d in dirs.values():
        grow_corpus_dir(full, d, 7)

    def step(tag: str):
        port = _delta(obs, lambda: run_debug(dirs["port"], str(tmp_path / f"P{tag}"), TorchBackend(device="cpu"),
                                             figures="failed", ingest="native",
                                             corpus_cache=str(tmp_path / "pcc"), result_cache=str(tmp_path / "prc")))
        jax = _delta(jax_obs, lambda: jax_run_debug(dirs["jax"], str(tmp_path / f"J{tag}"), JaxBackend(),
                                                    figures="failed", ingest="native",
                                                    corpus_cache=str(tmp_path / "jcc"),
                                                    result_cache=str(tmp_path / "jrc")))
        _assert_same(port[1], jax[1])
        return port[1]["counters"]

    cold = step("0")
    assert cold["store.miss"] == cold["store.populate"] == 1 and cold["rcache.report_put"] == 1
    warm = step("1")
    assert warm["store.hit"] == warm["rcache.report_hit"] == 1
    assert not any(k.startswith("kernel.dispatches.") for k in warm)
    for d in dirs.values():
        grow_corpus_dir(full, d, 10)
    grown = step("2")
    assert grown["store.append"] == 1 and grown["rcache.partial_hit"] == 1
    assert (grown["delta.runs_cached"], grown["delta.runs_mapped"]) == (7, 3)


@pytest.fixture
def jax_fresh_scheduler(monkeypatch):
    """The JAX query drain as the port's: serial (no work stealing), each
    bucket on the lane its scheduler plans with fresh cost models
    (tests/test_torch_query.py holds the port's lane rule to that plan);
    its session models would learn from earlier queries in the process."""
    from nemo_tpu.parallel import sched

    monkeypatch.setattr(sched, "session_models", sched.default_models)


def _jax_query(text, molly, **kw):
    return jax_run_query_text(text, molly, serial=True, **kw)


def _strip(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "stats"}


def test_query_counters_match_jax(corpora, jax_fresh_scheduler):
    """bench.py's query over the families on the lane rule; then each lane
    forced on the port, one lane for every bucket."""
    for name in sorted(CASE_STUDIES):
        d = corpora[name]
        molly, jmolly = ingest_corpus(d, "off"), jax_ingest(d, True, None)
        for kw in ({}, {"query_host_work": 0}, {"query_host_work": 10**15}):
            port = _delta(obs, lambda: run_query_text(BENCH_QUERY, molly, device="cpu", use_cache=False, **kw))
            if kw:
                # The JAX engine has no lane override: its scheduler's lanes
                # for these buckets are compared on the lane rule only.
                lanes = {k for k in port[1]["counters"] if k.startswith("query.route.")}
                assert len(lanes) == 1
                continue
            jax = _delta(jax_obs, lambda: _jax_query(BENCH_QUERY, jmolly, use_cache=False))
            assert _strip(port[0]) == _strip(jax[0])
            mine = {k: v for k, v in port[1]["counters"].items() if k.startswith(("query.", "kernel.dispatches."))}
            theirs = {k: v for k, v in jax[1]["counters"].items() if k.startswith(("query.", "kernel.dispatches."))}
            assert mine == theirs and mine["kernel.dispatches.query"] >= 1


def test_sched_counters_match_jax(tmp_path, monkeypatch):
    """Both packages' scheduler on, threaded, over a corpus of several
    buckets: the same jobs, no breaker series; the lanes each job took are
    the schedule's (compared as multisets in tests/test_torch_sched_e2e.py)."""
    from nemo_tpu.parallel import sched as jax_sched
    from nemo_tpu_torch.parallel import sched

    monkeypatch.setenv("NEMO_SCHED", "on")
    sched.reset_session_models("cpu")
    jax_sched.reset_session_models()
    corpus = write_corpus(SynthSpec(n_runs=60, seed=6, eot=20, name="mix"), str(tmp_path / "c"))
    (_, port), (_, jax) = _reports(corpus, tmp_path, {})

    def pick(delta):
        return {k: v for k, v in delta["counters"].items() if k == "analysis.sched.jobs" or k.startswith("sched.")}

    assert pick(port) == pick(jax) and pick(port)["analysis.sched.jobs"] >= 3


def test_chaos_failover_counters_match_jax(tmp_path, monkeypatch):
    """``fail_dispatch:4`` under both packages' scheduler (on, a breaker
    that trips at the first failure and stays open, the analysis host
    budget 1, no FLOPs hint on the JAX side, one failover pause long enough
    for the idle host lane to steal the other bucket): every series equal,
    ``chaos.injected.fail_dispatch`` among them, but one, ROADMAP Queue C
    (h): the JAX package records the failed dense dispatch's route before
    it runs, the port only a route that ran."""
    from nemo_tpu.parallel import sched as jax_sched
    from nemo_tpu.utils import chaos as jax_chaos
    from nemo_tpu.utils.backoff import BackoffPolicy as JaxBackoffPolicy
    from nemo_tpu_torch.parallel import sched
    from nemo_tpu_torch.utils import chaos

    for name, value in (("NEMO_SCHED", "on"), ("NEMO_BREAKER_FAILURES", "1"), ("NEMO_BREAKER_COOLDOWN_S", "3600"),
                        ("NEMO_ANALYSIS_HOST_WORK", "1"), ("NEMO_FAILOVER_BACKOFF_S", "0.3"),
                        ("NEMO_CHAOS", "fail_dispatch:4")):
        monkeypatch.setenv(name, value)
    # No FLOPs hint prices the JAX device lane (the port has none): it reads
    # the cost table of every earlier JAX report in the process.
    monkeypatch.setattr(jax_backend_mod, "sched_device_hint", lambda job: None)
    p = jax_sched.FAILOVER_POLICY
    monkeypatch.setattr(jax_sched, "FAILOVER_POLICY", JaxBackoffPolicy(0.3, p.multiplier, p.max_delay_s, p.jitter,
                                                                       p.budget_s))

    def forget():
        for mod in (chaos, jax_chaos):
            mod.reset()
        sched.reset_device_breaker("cpu")
        sched.reset_session_models("cpu")
        jax_sched.reset_device_breaker()
        jax_sched.reset_session_models()

    forget()
    corpus = write_corpus(SynthSpec(n_runs=8, seed=3), str(tmp_path / "c"))
    try:
        (_, port), (_, jax) = _reports(corpus, tmp_path, {"analysis_host_work": 1})
    finally:
        monkeypatch.delenv("NEMO_CHAOS")
        forget()
    mine, theirs = _view(port), _view(jax)
    assert "analysis.route.fused.dense" not in mine
    assert theirs.pop("analysis.route.fused.dense") == theirs["analysis.sched.lane_failure.device"]
    assert {k: (mine.get(k), theirs.get(k)) for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k)} == {}
    assert mine["chaos.injected.fail_dispatch"] == mine["analysis.sched.failover"] == mine["sched.breaker.trip"] == 1


def test_sched_query_counters_match_jax(corpora, monkeypatch, jax_fresh_scheduler):
    """bench.py's query through both schedulers' serial drain on fresh
    models: the same plans, so every analysis.sched.* counter and wall
    count equal."""
    from nemo_tpu_torch.parallel import sched

    monkeypatch.setenv("NEMO_SCHED", "on")
    for name in sorted(CASE_STUDIES)[:3]:
        d = corpora[name]
        molly, jmolly = ingest_corpus(d, "off"), jax_ingest(d, True, None)
        sched.reset_session_models("cpu")
        port = _delta(obs, lambda: run_query_text(BENCH_QUERY, molly, device="cpu", use_cache=False, serial=True))
        jax = _delta(jax_obs, lambda: _jax_query(BENCH_QUERY, jmolly, use_cache=False))
        assert _strip(port[0]) == _strip(jax[0])
        mine, theirs = ({k: v for k, v in _view(dl).items() if k.startswith(("analysis.sched.", "sched.", "query."))}
                        for dl in (port[1], jax[1]))
        assert mine == theirs and mine["analysis.sched.jobs"] >= 1


def test_query_cache_counters_match_jax(corpora, tmp_path, jax_fresh_scheduler):
    d = corpora["ZK-1270-racing-sent-flag"]
    sides = {"port": (obs, run_query_text, lambda: ingest_corpus(d, str(tmp_path / "pcc")), {"device": "cpu"}),
             "jax": (jax_obs, _jax_query, lambda: jax_ingest(d, True, _jax_store(tmp_path / "jcc")), {})}
    got = {}
    for side, (mod, run, ingest, kw) in sides.items():
        seq = []
        for _ in range(2):
            molly = ingest()
            _, dl = _delta(mod, lambda: run(BENCH_QUERY, molly, result_cache=str(tmp_path / f"{side}rc"), **kw))
            seq.append({k: v for k, v in dl["counters"].items() if k.startswith(("query.", "rcache.blob"))})
        got[side] = seq
    assert got["port"] == got["jax"]
    assert got["port"][1].get("query.cache.hit") == 1


def _jax_store(root):
    from nemo_tpu.store import resolve_store

    return resolve_store(str(root))


def _strip_event(ev: dict) -> dict:
    """An event without its wall, its paths and its generation names."""
    return {k: v for k, v in ev.items() if k not in ("update_latency_s", "dir", "report_dir")}


@pytest.mark.parametrize("route", ["default", "device_lanes"])
def test_watch_events_match_jax(route, tmp_path, monkeypatch):
    """One replay into copies of a sweep, both packages' watchers tailing
    them: every event equal field for field, the port's evidence read
    from its obs counters."""
    impl, backend_kw = ("crossover", {}) if route == "default" else ("dense", DEVICE_LANES["device_auto"])
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", impl)
    src = write_corpus(SynthSpec(n_runs=9, seed=11, name="sweep"), str(tmp_path / "src"))
    dst_port, dst_jax = tmp_path / "port" / "live", tmp_path / "jax" / "live"
    kw = {"corpus_cache": str(tmp_path / "pcc"), "result_cache": str(tmp_path / "prc")}
    w = Watcher(str(dst_port), str(tmp_path / "pres"), lambda: TorchBackend(device="cpu", **backend_kw),
                WatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=3, figures="failed", run_debug_kwargs=kw))
    jkw = {"corpus_cache": str(tmp_path / "jcc"), "result_cache": str(tmp_path / "jrc")}
    jw = JaxWatcher(str(dst_jax), str(tmp_path / "jres"), JaxBackend,
                    JaxWatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=3, figures="failed",
                                   run_debug_kwargs=jkw))
    q, jq = w.subscribe(), jw.subscribe()

    def next_update(queue_):
        while True:
            ev = queue_.get(timeout=120)
            if ev["event"] == "report_update":
                return ev

    threads = [threading.Thread(target=x.run, daemon=True) for x in (w, jw)]
    for th in threads:
        th.start()
    try:
        for n in replay_plan(9, 3):
            MollyInjector.materialize_prefix(src, str(dst_port), n)
            MollyInjector.materialize_prefix(src, str(dst_jax), n)
            ev, jev = next_update(q), next_update(jq)
            assert _strip_event(ev) == _strip_event(jev)
            assert ev["runs_mapped"] == 3 and ev["kernel_dispatches"] > 0
    finally:
        w.stop()
        jw.stop()
        for th in threads:
            th.join(timeout=60)


def test_watch_event_numbers_unchanged_by_obs(tmp_path):
    """The evidence from counter deltas equals what the port's watcher
    reported before it read obs: runs mapped and segments cached from the
    result cache's record, dispatches from the cycle's backend."""
    src = write_corpus(SynthSpec(n_runs=9, seed=11, name="sweep"), str(tmp_path / "src"))
    dst = tmp_path / "live" / "sweep"
    backends, results = [], []
    kw = {"corpus_cache": str(tmp_path / "cc"), "result_cache": str(tmp_path / "rc")}

    def make_backend():
        backends.append(TorchBackend(device="cpu"))
        return backends[-1]

    w = Watcher(str(dst), str(tmp_path / "res"), make_backend,
                WatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=3, figures="failed", run_debug_kwargs=kw))
    import nemo_tpu_torch.analysis.pipeline as pipeline

    real = pipeline.run_debug

    def recording(*a, **k):
        results.append(real(*a, **k))
        return results[-1]

    q = w.subscribe()
    th = threading.Thread(target=w.run, daemon=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "run_debug", recording)
        th.start()
        try:
            events = []
            for n in replay_plan(9, 3):
                MollyInjector.materialize_prefix(src, str(dst), n)
                while True:
                    ev = q.get(timeout=120)
                    if ev["event"] == "report_update":
                        events.append(ev)
                        break
        finally:
            w.stop()
            th.join(timeout=60)
    for ev, res, b in zip(events, results, backends):
        rc = res.result_cache
        old_mapped = 0 if rc.get("state") == "report_hit" else rc.get("runs_mapped", len(res.molly.runs))
        old_dispatches = sum(b.executor.dispatches.values()) + sum(b.executor.host_runs.values())
        assert (ev["runs_mapped"], ev["segments_cached"], ev["kernel_dispatches"]) == (
            old_mapped, rc.get("segments_cached", 0), old_dispatches)


def _harvest(root: Path) -> dict:
    spec = importlib.util.spec_from_file_location("metrics_doc", REPO / "tools" / "metrics_doc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    merged, problems = mod.harvest(str(root))
    assert problems == []
    return merged, mod.existing_descriptions(str(REPO / "docs" / "METRICS.md"))


def test_every_series_the_port_emits_is_documented():
    merged, documented = _harvest(REPO / "nemo_tpu_torch")
    assert set(merged) - set(documented) == set(PORT_ONLY)
    assert {"kernel.dispatches.<verb>", "analysis.route.<verb>.<route>", "watch.updates",
            "query.route.<lane>", "rcache.<kind>_hit", "flight.dumps.<reason>"} <= set(merged)


def test_excluded_series_are_jax_series():
    """Every excluded series is one the JAX package emits (a documented
    row), so the exclusion list names real departures only."""
    _, documented = _harvest(REPO / "nemo_tpu_torch")
    assert set(EXCLUDED) <= set(documented)
