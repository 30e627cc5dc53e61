"""The port's chaos harness (nemo_tpu_torch/utils/chaos.py) against the JAX
package's, on the CPU.

* **the spec**: budgets count down, ``reset`` forgets them, an unset
  ``NEMO_CHAOS`` is a no-op, a bad argument is warned about and skipped;
  the same ``NEMO_CHAOS`` strings fire the same points in the same order
  in both packages, with equal ``chaos.injected.*`` counters;
* **quarantine through the helper**: three corrupted runs, the port's
  ``quarantine.json``, ``debugging.json`` and ``ingest.quarantined`` equal
  to the JAX package's;
* **injected dispatch faults off the card**: ``fail_dispatch:4`` under
  ``NEMO_SCHED=on`` and a breaker that trips at the first failure; the
  report equals the uninjected one and the JAX package's, the failover,
  trip and injection counters equal the JAX package's, and the degraded
  next report short-circuits to the host lane; under ``NEMO_SCHED=off`` the
  fault propagates in both packages;
* **a card-keyed scheduler** (keyed to cuda; the job launches on the CPU):
  an injected fault is counted and raised and the host lane never runs, a
  wedged dispatch past the deadline ends in DispatchTimeout and records no
  route, and the next drain passes;
* **a real SIGKILL mid-sweep** (``kill_after_segments:1`` in a child, in
  memory and streamed): the resume maps only the segments with no
  checkpoint, its tree equals an uninterrupted report and the JAX
  package's resumed tree, and what the kill leaves beside the results
  directory is listed for both packages: the port's staging directory
  stays while it is young and is swept by the next run once it is older
  than the store's wreckage age;
* **the sweep of staging leftovers**: fabricated ``<report>.stage-*``
  directories beside a report, aged and young, with a ``.ckpt-`` child
  and another report's: a run removes (and logs) only its own aged ones;
* **a real SIGKILL inside the store's publish**: no header at the final
  path, the tmp wreckage beside it, a miss; the next populate and load
  succeed; aged wreckage is swept and the lock file survives;
* **a corrupted result-cache partial**: the rerun counts it stale,
  recomputes and writes the same tree.

Tolerance: none (report bytes, JSON documents, counters).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nemo_tpu import obs as jax_obs
from nemo_tpu.analysis.pipeline import _ingest as jax_ingest
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.synth import synth_impl_env
from nemo_tpu.backend import jax_backend as jax_backend_mod
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.parallel import sched as jax_sched
from nemo_tpu.store import CorpusStore as JaxStore
from nemo_tpu.utils import chaos as jax_chaos
from nemo_tpu.utils.backoff import BackoffPolicy as JaxBackoffPolicy
from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis import pipeline
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output
from nemo_tpu_torch.models.synth import SynthSpec, grow_corpus_dir, write_corpus
from nemo_tpu_torch.parallel import sched
from nemo_tpu_torch.query.engine import ingest_corpus
from nemo_tpu_torch.store import CorpusStore, resolve_store
from nemo_tpu_torch.utils import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": (chaos, obs), "jax": (jax_chaos, jax_obs)}

#: The failover pause of both packages' schedulers in the failover
#: scenario (s): long enough that the idle host lane steals the other
#: device-planned bucket while the failed one waits, in both packages.
FAILOVER_PAUSE_S = 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forget() -> None:
    for mod in (chaos, jax_chaos):
        mod.reset()
    sched.reset_device_breaker("cpu")
    sched.reset_device_breaker("cuda")
    sched.reset_session_models("cpu")
    sched.reset_session_models("cuda")
    jax_sched.reset_device_breaker()
    jax_sched.reset_session_models()


@pytest.fixture(autouse=True)
def clean_chaos(monkeypatch):
    """No chaos budget, open breaker or learned wall leaks into or out of a
    test; NEMO_CHAOS is set per test only."""
    monkeypatch.delenv("NEMO_CHAOS", raising=False)
    for name in ("NEMO_DISPATCH_TIMEOUT_S", "NEMO_BREAKER_FAILURES", "NEMO_BREAKER_COOLDOWN_S", "NEMO_MAX_BATCH",
                 "NEMO_STREAM", "NEMO_ANALYSIS_HOST_WORK"):
        monkeypatch.delenv(name, raising=False)
    _forget()
    yield
    _forget()


def _delta(obs_mod, fn):
    before = obs_mod.metrics.snapshot()
    out = fn()
    return out, obs_mod.Metrics.delta(obs_mod.metrics.snapshot(), before)["counters"]


def _chaos_series(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k.startswith("chaos.")}


def _same_tree(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


# ------------------------------------------------------------------ the spec


def test_spec_counts_down_and_resets(monkeypatch):
    monkeypatch.setenv("NEMO_CHAOS", "fail_dispatch:2")
    for _ in range(2):
        with pytest.raises(chaos.ChaosFault):
            chaos.on_device_dispatch("fused")
    chaos.on_device_dispatch("fused")  # the budget is spent
    chaos.reset()
    with pytest.raises(chaos.ChaosFault):
        chaos.on_device_dispatch("fused")


def test_spec_unset_is_a_no_op():
    _, counters = _delta(obs, lambda: (chaos.on_device_dispatch("fused"), chaos.on_segment_published(99),
                                       chaos.on_store_publish(), chaos.on_slow_io("store_load")))
    assert _chaos_series(counters) == {}


def test_spec_bad_mode_is_warned_and_skipped(monkeypatch, tmp_path):
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    monkeypatch.setenv("NEMO_CHAOS", "fail_dispatch:soon;slow_io:0")
    chaos.on_device_dispatch("fused")  # the bad mode was skipped: nothing fires
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    bad = [r for r in recs if r["event"] == "chaos.bad_mode"]
    assert len(bad) == 1 and bad[0]["mode"] == "fail_dispatch:soon" and bad[0]["level"] == "warning"
    assert bad[0]["logger"] == "nemo.chaos" and chaos._active() == {"slow_io": 0.0}


#: NEMO_CHAOS strings and the calls made under each, in order; none of
#: them reaches a kill.
SPEC_CASES = {
    "fail_two": "fail_dispatch:2",
    "fail_default_one": "fail_dispatch",
    "upper_case_and_blanks": " ; FAIL_DISPATCH:3 ; kill_after_segments:7 ;",
    "bad_arg_skipped": "fail_dispatch:x;kill_after_segments:9",
    "zero_budget": "fail_dispatch:0",
    "kill_not_reached": "kill_after_segments:4;fail_dispatch:1",
    "slow_io_zero": "slow_io:0",
}


def _fire_sequence(mod) -> list:
    """The dispatch and segment points (an armed ``on_slow_io`` raises
    TypeError in the JAX package: test_slow_io_sleeps_counts_and_logs)."""
    out = []
    calls = [("dispatch", "fused"), ("dispatch", "diff"), ("dispatch", "synth_ext"), ("segment", 1),
             ("segment", 3), ("dispatch", "sparse_fused"), ("dispatch", "fused")]
    for point, arg in calls:
        try:
            if point == "dispatch":
                mod.on_device_dispatch(arg)
            else:
                mod.on_segment_published(arg)
            out.append((point, arg, "ok"))
        except mod.ChaosFault as ex:
            out.append((point, arg, str(ex)))
    return out


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_fires_the_same_points_as_jax(case, monkeypatch):
    monkeypatch.setenv("NEMO_CHAOS", SPEC_CASES[case])
    got = {}
    for side, (mod, obs_mod) in SIDES.items():
        mod.reset()
        got[side] = _delta(obs_mod, lambda: _fire_sequence(mod))
    (seq, counters), (jseq, jcounters) = got["port"], got["jax"]
    assert seq == jseq
    assert _chaos_series(counters) == _chaos_series(jcounters)
    assert chaos._active() == jax_chaos._active()


def test_slow_io_sleeps_counts_and_logs(monkeypatch, tmp_path):
    """``slow_io:S`` (no production call site in either package) sleeps,
    counts and logs the IO point as ``where``; the JAX package's armed
    hook passes ``point`` twice and raises TypeError (ROADMAP Queue C)."""
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    monkeypatch.setenv("NEMO_CHAOS", "slow_io:0.05")
    t = time.perf_counter()
    _, counters = _delta(obs, lambda: chaos.on_slow_io("store_load"))
    assert time.perf_counter() - t >= 0.05 and _chaos_series(counters) == {"chaos.injected.slow_io": 1}
    rec = [json.loads(line) for line in log.read_text().splitlines()][-1]
    assert (rec["event"], rec["point"], rec["where"], rec["seconds"]) == ("chaos.injected", "slow_io", "store_load",
                                                                        0.05)
    with pytest.raises(TypeError, match="multiple values for argument 'point'"):
        jax_chaos.on_slow_io("store_load")


# ------------------------------------------------------ quarantine (leg a)


def test_quarantine_through_the_helper_matches_jax(tmp_path):
    d = write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), str(tmp_path / "q"))
    corrupt = {2: "truncate", 3: "garbage", 5: "truncate"}
    names = {pos: chaos.corrupt_run_file(d, pos, kind=kind) for pos, kind in corrupt.items()}
    assert names == {pos: f"run_{pos}_post_provenance.json" for pos in corrupt}
    res, counters = _delta(obs, lambda: run_debug(d, str(tmp_path / "port"), TorchBackend(device="cpu"),
                                                  corpus_cache="off", result_cache="off"))
    jres, jcounters = _delta(jax_obs, lambda: jax_run_debug(d, str(tmp_path / "jax"), JaxBackend(),
                                                            corpus_cache="off", result_cache="off"))
    tree, jtree = report_tree_bytes(res.report_dir), jax_tree(jres.report_dir)
    for name in ("quarantine.json", "debugging.json"):
        assert tree[name] == jtree[name]
    assert [q["position"] for q in json.loads(tree["quarantine.json"])] == sorted(corrupt)
    assert {r["iteration"] for r in json.loads(tree["debugging.json"])} == set(range(8)) - set(corrupt)
    assert counters["ingest.quarantined"] == jcounters["ingest.quarantined"] == len(corrupt)
    _same_tree(tree, jtree)


# ------------------------------------------- injected dispatch faults (leg b)


@pytest.fixture
def failover_env(monkeypatch):
    """Both packages' scheduler on, a breaker that trips at the first
    failure and stays open, the analysis host budget 1 (the JAX package's
    env knobs; the port's is the backend's argument), the JAX side's synth
    routed by its crossover as on a device backend and no FLOPs hint
    pricing its device lane (the port has none; the hint reads the cost
    table of every earlier JAX report in the process), the failover pause
    FAILOVER_PAUSE_S in both."""
    for name, value in (("NEMO_SCHED", "on"), ("NEMO_BREAKER_FAILURES", "1"), ("NEMO_BREAKER_COOLDOWN_S", "3600"),
                        ("NEMO_ANALYSIS_IMPL", "crossover"), ("NEMO_ANALYSIS_HOST_WORK", "1"),
                        ("NEMO_FAILOVER_BACKOFF_S", str(FAILOVER_PAUSE_S))):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(JaxBackend, "_resolve_synth_impl", lambda self: synth_impl_env())
    monkeypatch.setattr(jax_backend_mod, "sched_device_hint", lambda job: None)
    p = jax_sched.FAILOVER_POLICY
    monkeypatch.setattr(jax_sched, "FAILOVER_POLICY",
                        JaxBackoffPolicy(FAILOVER_PAUSE_S, p.multiplier, p.max_delay_s, p.jitter, p.budget_s))


def _failover_reports(d: str, tmp_path, label: str) -> dict:
    """The report of ``d`` by both packages on fresh scheduler models:
    {side: (tree, counters)}."""
    out = {}
    for side, (mod, obs_mod) in SIDES.items():
        mod.reset()
        if side == "port":
            sched.reset_session_models("cpu")
            res, counters = _delta(obs_mod, lambda: run_debug(d, str(tmp_path / f"port-{label}"),
                                                              TorchBackend(device="cpu", analysis_host_work=1),
                                                              corpus_cache="off", result_cache="off"))
            out[side] = (report_tree_bytes(res.report_dir), counters)
        else:
            jax_sched.reset_session_models()
            res, counters = _delta(obs_mod, lambda: jax_run_debug(d, str(tmp_path / f"jax-{label}"), JaxBackend(),
                                                                  corpus_cache="off", result_cache="off"))
            out[side] = (jax_tree(res.report_dir), counters)
    return out


FAILOVER_SERIES = ("chaos.injected.fail_dispatch", "analysis.sched.failover", "sched.breaker.trip",
                   "analysis.sched.lane_failure.device", "sched.breaker.short_circuit")


def test_injected_dispatch_faults_fail_over_as_jax(failover_env, tmp_path, monkeypatch):
    d = write_corpus(SynthSpec(n_runs=8, seed=3), str(tmp_path / "f"))
    ok = _failover_reports(d, tmp_path, "ok")
    _same_tree(ok["port"][0], ok["jax"][0])
    assert ok["port"][1]["analysis.sched.jobs"] == ok["jax"][1]["analysis.sched.jobs"] >= 3
    monkeypatch.setenv("NEMO_CHAOS", "fail_dispatch:4")
    inj = _failover_reports(d, tmp_path, "inj")
    monkeypatch.delenv("NEMO_CHAOS")
    for side in SIDES:
        _same_tree(inj[side][0], ok["jax"][0])
    mine, theirs = ({k: c.get(k) for k in FAILOVER_SERIES} for c in (inj["port"][1], inj["jax"][1]))
    assert mine == theirs
    assert mine["chaos.injected.fail_dispatch"] >= 1 and mine["sched.breaker.trip"] == 1
    assert mine["analysis.sched.failover"] == mine["analysis.sched.lane_failure.device"] >= 1
    # Degraded: the breaker stays open, every device plan goes to the host.
    deg = _failover_reports(d, tmp_path, "deg")
    for side in SIDES:
        _same_tree(deg[side][0], ok["jax"][0])
        c = deg[side][1]
        assert c.get("sched.breaker.short_circuit", 0) >= 1 and not c.get("analysis.route.fused.dense")
        assert not c.get("kernel.dispatches.fused") and not _chaos_series(c)
    assert deg["port"][1]["sched.breaker.short_circuit"] == deg["jax"][1]["sched.breaker.short_circuit"]


def test_injected_fault_propagates_with_the_scheduler_off(tmp_path, monkeypatch):
    """NEMO_SCHED=off (the port's default): no failover; the fault leaves
    both packages' run_debug."""
    for name, value in (("NEMO_SCHED", "off"), ("NEMO_ANALYSIS_IMPL", "crossover"), ("NEMO_ANALYSIS_HOST_WORK", "1"),
                        ("NEMO_CHAOS", "fail_dispatch:1")):
        monkeypatch.setenv(name, value)
    d = write_corpus(SynthSpec(n_runs=8, seed=3), str(tmp_path / "f"))
    raised = {}
    for side, (mod, obs_mod) in SIDES.items():
        def report():
            if side == "port":
                return run_debug(d, str(tmp_path / side), TorchBackend(device="cpu", analysis_host_work=1),
                                 corpus_cache="off", result_cache="off")
            return jax_run_debug(d, str(tmp_path / side), JaxBackend(), corpus_cache="off", result_cache="off")

        def expect():
            with pytest.raises(mod.ChaosFault) as info:
                report()
            return str(info.value)

        raised[side] = _delta(obs_mod, expect)
    (msg, counters), (jmsg, jcounters) = raised["port"], raised["jax"]
    assert msg == jmsg == "injected device dispatch failure (verb=fused)"
    assert _chaos_series(counters) == _chaos_series(jcounters) == {"chaos.injected.fail_dispatch": 1}
    for c in (counters, jcounters):
        assert not any(k.startswith(("analysis.sched.", "sched.")) for k in c)
        assert not any(k.startswith("kernel.dispatches.") for k in c)


# ------------------------------------------------ a card-keyed scheduler


def _bucket_job(backend, plan):
    """The first fused bucket of ``plan`` as a Job (unpinned, dense)."""
    pre_b, post_b = plan["batches"][0]
    jobs, routes = [], []
    backend._fused_job(jobs, routes, plan, 0, pre_b, post_b, False)
    assert routes == [("device", "crossover")] and jobs[0].pinned is None
    return jobs[0]


def _host_arrays(res: dict) -> dict:
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in res.items()}


def test_card_scheduler_raises_injected_faults(tmp_path, monkeypatch):
    """On a scheduler keyed to the card, fail_dispatch is counted for the
    breaker and raised, the host lane never running the job; wedge_dispatch
    past a 0.2 s deadline ends in DispatchTimeout with no route recorded
    (the wedged dispatch sleeps on, a daemon); the next drain passes."""
    d = write_corpus(SynthSpec(n_runs=8, seed=3), str(tmp_path / "c"))
    backend = TorchBackend(device="cpu", analysis_host_work=0)
    backend.init_graph_db("", ingest_corpus(d, "off"))
    plan = backend._plan_fused_inputs()
    want = _host_arrays(_bucket_job(backend, plan).execute("device", "sched", False)[2])

    def drain():
        s = sched.HeterogeneousScheduler(sched.default_models("cpu", 0), device="cuda")
        assert s.on_card
        return s.run([_bucket_job(backend, plan)], serial=True)[0]

    n_routes, host_runs = len(backend.analysis_routes), dict(backend.executor.host_runs)
    monkeypatch.setenv("NEMO_CHAOS", "fail_dispatch:1")
    _, counters = _delta(obs, lambda: pytest.raises(chaos.ChaosFault, drain))
    assert (counters["chaos.injected.fail_dispatch"], counters["analysis.sched.lane_failure.device"],
            counters["sched.breaker.failures"]) == (1, 1, 1)
    assert not counters.get("analysis.sched.failover") and not counters.get("kernel.dispatches.sparse_fused")
    assert backend.executor.host_runs == host_runs and len(backend.analysis_routes) == n_routes

    monkeypatch.setenv("NEMO_CHAOS", "wedge_dispatch:1")
    monkeypatch.setenv("NEMO_DISPATCH_TIMEOUT_S", "0.2")
    before = obs.metrics.snapshot()
    with pytest.raises(sched.DispatchTimeout):
        drain()
    wedged = [th for th in threading.enumerate() if th.name.startswith("nemo-sched-dispatch-") and th.is_alive()]
    assert wedged and all(th.daemon for th in wedged)
    deadline = time.monotonic() + 30
    while "chaos.injected.wedge_dispatch" not in obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    counters = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert (counters["watchdog.dispatch_timeout"], counters["analysis.sched.lane_failure.device"]) == (1, 1)
    assert not counters.get("analysis.sched.failover") and not counters.get("analysis.sched.abandoned_error")
    assert backend.executor.host_runs == host_runs and len(backend.analysis_routes) == n_routes

    monkeypatch.delenv("NEMO_CHAOS")
    monkeypatch.delenv("NEMO_DISPATCH_TIMEOUT_S")
    res = drain()
    got = _host_arrays(res[2])
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert len(backend.analysis_routes) == n_routes + 1 and backend.analysis_routes[-1]["route"] == "dense"


# ------------------------------------------- a real SIGKILL mid-sweep (leg c)


_CHILD = {
    "port": ("from nemo_tpu_torch.analysis.pipeline import run_debug\n"
             "from nemo_tpu_torch.backend.torch_backend import TorchBackend\n"
             "run_debug({d!r}, {out!r}, TorchBackend('cpu'), corpus_cache={cc!r}, result_cache={rc!r})\n"
             "print('COMPLETED')\n"),
    "jax": ("from nemo_tpu.analysis.pipeline import run_debug\n"
            "from nemo_tpu.backend.jax_backend import JaxBackend\n"
            "run_debug({d!r}, {out!r}, JaxBackend(), corpus_cache={cc!r}, result_cache={rc!r})\n"
            "print('COMPLETED')\n"),
}


def _child(code: str, chaos_spec: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, NEMO_CHAOS=chaos_spec, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def _three_segment_store(side: str, full: str, root) -> tuple[str, str]:
    """``full``'s first 8, 10, then 12 runs in ``side``'s corpus store: three
    segments.  Returns (the staged directory, the store root)."""
    d, cc = str(root / "staged" / os.path.basename(full)), str(root / "cc")
    store = resolve_store(cc) if side == "port" else JaxStore(cc)
    for n in (8, 10, 12):
        grow_corpus_dir(full, d, n)
        if n > 8:
            store.load_packed(d)
        elif side == "port":
            molly, _kind, snap = pipeline._ingest(d, True, store)
            pipeline._populate(store, d, molly, snap)
        else:
            jax_ingest(d, True, store)
    assert len(store._read_header(store.store_dir(d))["segments"]) == 3
    return d, cc


@pytest.fixture(scope="module")
def sweep_full(tmp_path_factory):
    return write_corpus(SynthSpec(n_runs=12, seed=2, eot=6), str(tmp_path_factory.mktemp("chaos_full")))


@pytest.mark.parametrize("stream", ["off", "on"])
def test_sigkill_mid_sweep_resumes_byte_equal(sweep_full, stream, tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_STREAM", stream)
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "crossover")  # the JAX side's routes = the port's defaults
    name = os.path.basename(sweep_full)
    trees, left = {}, {}
    for side, (_mod, obs_mod) in SIDES.items():
        root = tmp_path / side
        d, cc = _three_segment_store(side, sweep_full, root)
        rc, out = str(root / "rc"), str(root / "res")
        proc = _child(_CHILD[side].format(d=d, out=out, cc=cc, rc=rc), "kill_after_segments:1")
        assert proc.returncode == -9, proc.stderr[-2000:]
        assert "COMPLETED" not in proc.stdout
        left[side] = sorted(os.listdir(out)) if os.path.isdir(out) else None
        assert len(os.listdir(os.path.join(rc, "partial"))) == 1  # the one published checkpoint
        if side == "port":
            res, counters = _delta(obs_mod, lambda: run_debug(d, out, TorchBackend(device="cpu"), corpus_cache=cc,
                                                              result_cache=rc))
            trees[side] = report_tree_bytes(res.report_dir)
            scratch = run_debug(d, str(root / "scratch"), TorchBackend(device="cpu"), corpus_cache="off",
                                result_cache="off")
            _same_tree(trees[side], report_tree_bytes(scratch.report_dir))
            stale = [n for n in sorted(os.listdir(out)) if n != name]
            assert stale == left[side]  # the kill's leftover stays; the resume removed its own
        else:
            res, counters = _delta(obs_mod, lambda: jax_run_debug(d, out, JaxBackend(), corpus_cache=cc,
                                                                  result_cache=rc))
            trees[side] = jax_tree(res.report_dir)
            assert sorted(os.listdir(out)) == [name]
        cached, mapped = counters.get("delta.segments_cached", 0), counters.get("delta.segments_mapped", 0)
        assert cached >= 1 and cached + mapped == 3 and mapped < 3, (side, counters)
        assert not any(".stage-" in k or ".ckpt-" in k for k in trees[side])
    _same_tree(trees["port"], trees["jax"])
    # What the kill leaves beside the results directory (ROADMAP Queue C):
    # the port, its staging directory of the checkpointed segment's
    # figures; the JAX package, nothing (it stages in the system temp dir).
    assert left["jax"] is None
    assert len(left["port"]) == 1 and left["port"][0].startswith(f"{name}.stage-")
    leftover = tmp_path / "port" / "res" / left["port"][0]
    staged = os.listdir(leftover)
    assert staged and all(f.endswith((".dot", ".svg")) for f in staged)
    # Once older than the store's wreckage age, the next run sweeps it.
    aged = time.time() - CorpusStore._WRECKAGE_MAX_AGE_S - 60
    os.utime(leftover, (aged, aged))
    d = str(tmp_path / "port" / "staged" / name)
    again = run_debug(d, str(tmp_path / "port" / "res"), TorchBackend(device="cpu"), corpus_cache=str(
        tmp_path / "port" / "cc"), result_cache=str(tmp_path / "port" / "rc"))
    assert again.result_cache["state"] == "report_hit"
    assert sorted(os.listdir(tmp_path / "port" / "res")) == [name]


def test_stage_leftovers_swept_once_aged(corpus_dir, tmp_path, monkeypatch):
    """Staging directories a killed run left beside its report are removed
    by the next run of that report once older than the store's wreckage
    age, each removal logged; a younger one (maybe a live run's) and
    another report's stay."""
    name = os.path.basename(corpus_dir)
    res_root = tmp_path / "res"
    aged_at = time.time() - CorpusStore._WRECKAGE_MAX_AGE_S - 60
    made = {}
    for leaf, aged in ((f"{name}.stage-0a1b2c3d", True), (f"{name}.stage-0a1b2c3d.ckpt-x1y2z3", True),
                       (f"{name}.stage-young000", False), (f"other.stage-0a1b2c3d", True)):
        p = res_root / leaf
        p.mkdir(parents=True)
        (p / "run_1_spacetime.svg").write_text("<svg/>")
        if aged:
            os.utime(p, (aged_at, aged_at))
        made[leaf] = aged
    log_file = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log_file))
    run_debug(corpus_dir, str(res_root), TorchBackend(device="cpu"), figures="none")
    left = sorted(os.listdir(res_root))
    assert left == sorted([name, f"{name}.stage-young000", "other.stage-0a1b2c3d"])
    swept = [json.loads(line)["path"] for line in log_file.read_text().splitlines()
             if json.loads(line)["event"] == "pipeline.stage_swept"]
    assert sorted(swept) == sorted(str(res_root / leaf) for leaf, aged in made.items()
                                   if aged and leaf.startswith(name))


# -------------------------------------- a real SIGKILL in the store's publish


def test_sigkill_in_store_publish_leaves_only_wreckage(tmp_path):
    corpus = write_corpus(SynthSpec(n_runs=4, seed=7), str(tmp_path))
    root = str(tmp_path / "cache")
    code = ("from nemo_tpu_torch.ingest.molly import load_molly_output\n"
            "from nemo_tpu_torch.store import CorpusStore\n"
            f"CorpusStore({root!r}).put({corpus!r}, load_molly_output({corpus!r}))\n"
            "print('COMPLETED')\n")
    proc = _child(code, "kill_in_store_publish")
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "COMPLETED" not in proc.stdout
    store = CorpusStore(root)
    final = store.store_dir(corpus)
    assert not os.path.exists(os.path.join(final, "header.json"))
    wreck = [n for n in os.listdir(root) if ".npack.tmp-" in n]
    assert len(wreck) == 1 and os.listdir(os.path.join(root, wreck[0]))
    assert store.probe(corpus) == "miss"
    header, counters = _delta(obs, lambda: store.put(corpus, load_molly_output(corpus)))
    assert isinstance(header, dict) and counters["store.populate"] == 1
    assert not counters.get("store.gc_wreckage")  # fresh wreckage may be a live writer's
    loaded, counters = _delta(obs, lambda: store.load_packed(corpus))
    assert loaded is not None and counters["store.hit"] == 1
    aged = time.time() - CorpusStore._WRECKAGE_MAX_AGE_S - 60
    for n in wreck:
        p = os.path.join(root, n)
        os.utime(p, (os.path.getatime(p), aged))
    _, counters = _delta(obs, lambda: store.put(corpus, load_molly_output(corpus)))
    assert counters.get("store.gc_wreckage", 0) >= 1
    assert not [n for n in os.listdir(root) if ".npack.tmp-" in n]
    assert os.path.exists(f"{final}.lock")


# ------------------------------------------- a corrupted result-cache partial


def test_corrupted_partial_is_stale_and_recomputed(sweep_full, tmp_path):
    d, cc = _three_segment_store("port", sweep_full, tmp_path)
    rc = str(tmp_path / "rc")
    first = run_debug(d, str(tmp_path / "r0"), TorchBackend(device="cpu"), figures="failed", corpus_cache=cc,
                      result_cache=rc)
    want = report_tree_bytes(first.report_dir)
    assert len(os.listdir(os.path.join(rc, "partial"))) == 3
    entry = chaos.corrupt_rcache_entry(rc, "partial")
    assert entry is not None and chaos.corrupt_rcache_entry(rc, "nothing") is None
    # A fresh results directory: the flip also reaches the first report's
    # hardlinked copy of the entry's figure files.
    res, counters = _delta(obs, lambda: run_debug(d, str(tmp_path / "r1"), TorchBackend(device="cpu"),
                                                  figures="failed", corpus_cache=cc, result_cache=rc))
    assert counters["rcache.partial_stale"] == 1 and counters["rcache.partial_hit"] == 2
    assert counters["delta.segments_mapped"] == 1 and not counters.get("rcache.report_hit")
    _same_tree(report_tree_bytes(res.report_dir), want)
