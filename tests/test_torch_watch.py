"""The port's live watch loop (``nemo_tpu_torch/watch``) and adversarial
families against the JAX package's, on the CPU.

* the replay plans are equal, and a replay writes its generations;
* a sweep replayed generation by generation into both packages' watchers
  publishes byte-equal report trees at every update, on the port's default
  routes (against the JAX side's ``NEMO_ANALYSIS_IMPL=crossover``) and on
  its device lanes (host budgets 0, against the JAX side forced dense);
  every update maps only its new runs (Molly and trace-JSON layouts);
* the publish is an atomic symlink flip; a failed cycle is retried; a
  debounce window coalesces several writes into one update; a cycle that
  quarantined a file does not trigger itself again, and the file's repair
  re-arms the loop and maps 1 run; an unknown injector fails at once, an
  unsniffable directory after the initial wait; the CLI's ``--watch
  --replay``;
* the five adversarial families: the generator writes the JAX package's
  files, and the port's ``debugging.json`` equals the JAX package's on the
  default routes, the device lanes, the sparse_device tier forced and with
  every run on the giant path (device and host), each fix-point loop
  ending.

The watcher tests poll every 50 ms and assert counts, not wall times.
Tolerance: none.
"""

import json
import os
import threading
import time

import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.models import synth as jax_synth
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu.watch import WatchConfig as JaxWatchConfig
from nemo_tpu.watch import Watcher as JaxWatcher
from nemo_tpu.watch.replay import replay_plan as jax_replay_plan
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.adapters import MollyInjector, TraceJsonInjector, molly_to_trace
from nemo_tpu_torch.models.synth import ADVERSARIAL_FAMILIES, SynthSpec, adversarial_spec, generate_corpus, write_corpus
from nemo_tpu_torch.watch import WatchConfig, Watcher, replay_corpus, replay_plan

FIGURES = "failed"
DEVICE_LANES = {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0}
#: (the port's TorchBackend arguments, the JAX side's NEMO_ANALYSIS_IMPL)
ROUTES = {"default": ({}, "crossover"), "device_lanes": (DEVICE_LANES, "dense")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _watcher(tmp_path, dst, max_updates, figures="none", backend_kw=None):
    cfg = WatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=max_updates, figures=figures,
                      run_debug_kwargs={"corpus_cache": str(tmp_path / "cc"), "result_cache": str(tmp_path / "rc")})
    w = Watcher(str(dst), str(tmp_path / "wres"), lambda: TorchBackend(device="cpu", **(backend_kw or {})), cfg)
    return w, w.subscribe()


def _next_update(q, timeout=120):
    while True:
        ev = q.get(timeout=timeout)
        if ev["event"] == "report_update":
            return ev


@pytest.mark.parametrize("n,g", [(9, 3), (10, 3), (2, 5), (1, 1), (1700, 4), (240, 6)])
def test_replay_plan_matches_jax(n, g):
    assert replay_plan(n, g) == jax_replay_plan(n, g)
    assert replay_plan(n, g)[-1] == n


def test_replay_corpus_writes_generations(tmp_path):
    src = write_corpus(SynthSpec(n_runs=6, seed=1, name="s"), str(tmp_path))
    for inj, s in ((MollyInjector, src), (TraceJsonInjector, molly_to_trace(src, str(tmp_path / "t" / "s")))):
        dst = str(tmp_path / inj.name / "s")
        assert replay_corpus(s, dst, generations=3, interval_s=0.0) == 3
        assert inj.count_runs(dst) == 6


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replayed_watch_matches_jax_generation_by_generation(route, tmp_path, monkeypatch):
    """Both watchers tail a copy of one replayed sweep; after each
    generation both publish, and the live trees are byte-equal."""
    backend_kw, impl = ROUTES[route]
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", impl)
    src = write_corpus(SynthSpec(n_runs=9, seed=11, name="sweep"), str(tmp_path / "src"))
    dst_port, dst_jax = tmp_path / "port" / "live", tmp_path / "jax" / "live"
    w, q = _watcher(tmp_path, dst_port, 3, figures=FIGURES, backend_kw=backend_kw)
    jcfg = JaxWatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=3, figures=FIGURES,
                          run_debug_kwargs={"corpus_cache": str(tmp_path / "jcc"),
                                            "result_cache": str(tmp_path / "jrc")})
    jw = JaxWatcher(str(dst_jax), str(tmp_path / "jres"), JaxBackend, jcfg)
    jq = jw.subscribe()
    threads = [threading.Thread(target=x.run, daemon=True) for x in (w, jw)]
    for th in threads:
        th.start()
    try:
        for k, n in enumerate(replay_plan(9, 3)):
            MollyInjector.materialize_prefix(src, str(dst_port), n)
            MollyInjector.materialize_prefix(src, str(dst_jax), n)
            ev, jev = _next_update(q), _next_update(jq)
            assert (ev["runs_total"], ev["new_runs"]) == (jev["runs_total"], jev["new_runs"]) == (n, 3)
            assert ev["runs_mapped"] == jev["runs_mapped"] == 3
            assert ev["segments_cached"] == jev["segments_cached"] == k
            assert ev["kernel_dispatches"] > 0
            mine, theirs = report_tree_bytes(ev["report_dir"]), jax_tree(jev["report_dir"])
            assert sorted(mine) == sorted(theirs)
            assert [p for p in theirs if mine[p] != theirs[p]] == []
            assert ev["changed_total"] > 0 and "debugging.json" in ev["sections"]
    finally:
        w.stop()
        jw.stop()
        for th in threads:
            th.join(timeout=60)
    assert w.updates == 3
    # The last published tree is the one-shot report of the whole sweep.
    one_shot = run_debug(str(dst_port), str(tmp_path / "once"), TorchBackend(device="cpu", **backend_kw),
                         figures=FIGURES, corpus_cache="off", result_cache="off")
    assert report_tree_bytes(one_shot.report_dir) == mine


def test_trace_json_watch_is_incremental(tmp_path):
    src = molly_to_trace(write_corpus(SynthSpec(n_runs=8, seed=3, name="s"), str(tmp_path / "m")),
                         str(tmp_path / "t" / "s"))
    dst = tmp_path / "live" / "s"
    w, q = _watcher(tmp_path, dst, 2, figures=FIGURES)
    th = threading.Thread(target=w.run, daemon=True)
    th.start()
    try:
        for n in replay_plan(8, 2):
            TraceJsonInjector.materialize_prefix(src, str(dst), n)
            ev = _next_update(q)
            assert ev["runs_total"] == n and ev["runs_mapped"] == ev["new_runs"] == 4
    finally:
        w.stop()
        th.join(timeout=60)
    jax_once = jax_run_debug(str(dst), str(tmp_path / "jax"), JaxBackend(), reporter=JaxReporter(), figures=FIGURES,
                             ingest="python", corpus_cache="off", result_cache="off")
    assert report_tree_bytes(ev["report_dir"]) == jax_tree(jax_once.report_dir)


def test_debounce_coalesces_rapid_writes(tmp_path):
    src = write_corpus(SynthSpec(n_runs=8, seed=3, name="s"), str(tmp_path))
    dst = tmp_path / "live"
    w, q = _watcher(tmp_path, dst, 1)
    w.config.debounce_s = 0.4
    th = threading.Thread(target=w.run, daemon=True)
    th.start()
    for n in (2, 4, 6, 8):
        MollyInjector.materialize_prefix(src, str(dst), n)
        time.sleep(0.05)
    ev = _next_update(q)
    th.join(timeout=60)
    assert ev["runs_total"] == 8 and ev["update"] == 1 and w.updates == 1


def test_publish_is_an_atomic_symlink_flip(tmp_path):
    src = write_corpus(SynthSpec(n_runs=4, seed=5, name="s"), str(tmp_path))
    dst = tmp_path / "live"
    MollyInjector.materialize_prefix(src, str(dst), 4)
    stale = tmp_path / "wres" / "live"
    stale.mkdir(parents=True)
    (stale / "debugging.json").write_text("[]")
    w, q = _watcher(tmp_path, dst, 1)
    assert w.run() == 1
    ev = q.get(timeout=5)
    assert os.path.islink(ev["report_dir"]) and os.path.isfile(os.path.join(ev["report_dir"], "debugging.json"))
    assert len([p for p in os.listdir(tmp_path / "wres") if p.startswith("live.pre-watch-")]) == 1
    assert not [p for p in os.listdir(tmp_path / "wres") if ".link-" in p]


def test_failed_cycle_is_retried(tmp_path):
    dst = tmp_path / "live"
    dst.mkdir()
    (dst / "runs.json").write_text("[truncated")  # sniffs as Molly, does not parse
    w, q = _watcher(tmp_path, dst, 1)
    th = threading.Thread(target=w.run, daemon=True)
    th.start()
    ev = q.get(timeout=60)
    assert ev["event"] == "watch_error"
    src = write_corpus(SynthSpec(n_runs=3, seed=7, name="s"), str(tmp_path))
    MollyInjector.materialize_prefix(src, str(dst), 3)
    ev = _next_update(q)
    th.join(timeout=60)
    assert ev["runs_total"] == 3 and w.updates == 1


def test_quarantine_cycle_does_not_retrigger_and_repair_rearms(tmp_path):
    src = write_corpus(SynthSpec(n_runs=4, seed=5, name="s"), str(tmp_path))
    dst = tmp_path / "live"
    MollyInjector.materialize_prefix(src, str(dst), 4)
    victim = dst / "run_3_post_provenance.json"
    intact = victim.read_bytes()
    victim.write_bytes(intact[: len(intact) // 2])
    w, q = _watcher(tmp_path, dst, 3)
    th = threading.Thread(target=w.run, daemon=True)
    th.start()
    try:
        ev1 = _next_update(q)
        assert ev1["quarantined"] == 1 and ev1["runs_total"] == 3
        time.sleep(1.0)  # many poll periods, nothing on disk moves
        assert q.empty(), "an update after an unchanged quarantine cycle"
        victim.write_bytes(intact)
        ev2 = _next_update(q)
        assert ev2["quarantined"] == 0 and ev2["runs_mapped"] == 1 and ev2["runs_total"] == 4
    finally:
        w.stop()
        th.join(timeout=60)


def test_setup_errors(tmp_path, monkeypatch):
    dst = tmp_path / "empty"
    dst.mkdir()
    w, _ = _watcher(tmp_path, dst, 1)
    w.config.initial_wait_s = 0.2
    with pytest.raises(ValueError, match="cannot sniff"):
        w.run()
    monkeypatch.setenv("NEMO_INJECTOR", "mollly")
    w, _ = _watcher(tmp_path, dst, 1)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="unknown injector"):
        w.run()
    assert time.monotonic() - t0 < 5.0


def test_watch_config_env(monkeypatch):
    monkeypatch.setenv("NEMO_WATCH_POLL_S", "2.5")
    monkeypatch.setenv("NEMO_WATCH_DEBOUNCE_S", "1.25")
    cfg = WatchConfig()
    assert (cfg.poll_s, cfg.debounce_s) == (2.5, 1.25)
    monkeypatch.setenv("NEMO_WATCH_POLL_S", "junk")
    assert WatchConfig().poll_s == 0.5 == JaxWatchConfig().poll_s
    assert WatchConfig(poll_s=0.1).poll_s == 0.1


def test_cli_watch_replay(tmp_path, capsys):
    src = write_corpus(SynthSpec(n_runs=6, seed=2, name="s"), str(tmp_path / "src"))
    dst, out = str(tmp_path / "live" / "s"), str(tmp_path / "R")
    assert cli.main(["-faultInjOut", dst, "--device", "cpu", "--results-dir", out, "--figures", "none", "--watch",
                     "--watch-poll-s", "0.05", "--watch-debounce-s", "0.1", "--watch-max-updates", "3",
                     "--replay", src, "--replay-generations", "3", "--replay-interval-s", "0.3",
                     "--corpus-cache", str(tmp_path / "cc"), "--result-cache", str(tmp_path / "rc")]) == 0
    text = capsys.readouterr().out
    assert text.count("watch update ") == 3 and "watch update 3: 6 runs" in text
    assert os.path.islink(os.path.join(out, "s"))
    with open(os.path.join(out, "s", "debugging.json")) as fh:
        assert len(json.load(fh)) == 6
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", dst, "--device", "cpu", "--replay", src])


# ---------------------------------------------------------------------------
# adversarial families
# ---------------------------------------------------------------------------

ADV_RUNS = 10
#: The port's lanes for the adversarial reports, each against the JAX side's
#: default route: the defaults, the device lanes, the sparse_device tier
#: forced, and every run above 16 nodes on the giant path, on the device
#: (its union-find and walk in torch) and on the host lane.
ADV_LANES = {
    "default": {},
    "device_lanes": DEVICE_LANES,
    "sparse_device": {"analysis_impl": "sparse_device"},
    "giant": {"giant_v": 16},
    "giant_host": {"giant_v": 16, "analysis_impl": "sparse"},
}


@pytest.fixture(scope="module")
def adversarial(tmp_path_factory):
    """family -> (corpus directory, the JAX package's debugging.json)."""
    root = tmp_path_factory.mktemp("adversarial")
    out = {}
    for fam in ADVERSARIAL_FAMILIES:
        cd = jax_synth.write_corpus(jax_synth.adversarial_spec(fam, n_runs=ADV_RUNS, seed=13), str(root))
        res = jax_run_debug(cd, str(root / "jax"), JaxBackend(), reporter=JaxReporter(), figures="none",
                            ingest="python", corpus_cache="off", result_cache="off")
        with open(os.path.join(res.report_dir, "debugging.json"), "rb") as fh:
            out[fam] = (cd, fh.read())
    return out


@pytest.mark.parametrize("family", ADVERSARIAL_FAMILIES)
def test_adversarial_generator_matches_jax(family):
    mine = generate_corpus(adversarial_spec(family, n_runs=4, seed=13))
    assert mine == jax_synth.generate_corpus(jax_synth.adversarial_spec(family, n_runs=4, seed=13))
    assert adversarial_spec(family) == adversarial_spec(family)
    with pytest.raises(ValueError, match="unknown adversarial family"):
        adversarial_spec("nope")


@pytest.mark.parametrize("lanes", sorted(ADV_LANES))
@pytest.mark.parametrize("family", ADVERSARIAL_FAMILIES)
def test_adversarial_debugging_json_matches_jax(family, lanes, adversarial, tmp_path):
    cd, want = adversarial[family]
    backend = TorchBackend(device="cpu", **ADV_LANES[lanes])
    res = run_debug(cd, str(tmp_path), backend, figures="none")
    with open(os.path.join(res.report_dir, "debugging.json"), "rb") as fh:
        assert fh.read() == want
    routes = {r["route"] for r in backend.analysis_routes if r["verb"] in ("fused", "giant")}
    if lanes == "sparse_device":
        assert routes == {"sparse_device"}
    if lanes == "device_lanes":
        assert not backend.executor.host_runs
    if lanes.startswith("giant") and family in ("deep_chain", "cycles"):
        giants = {r["route"] for r in backend.analysis_routes if r["verb"] == "giant"}
        assert giants == ({"sparse"} if lanes == "giant_host" else {"sparse_device"})
