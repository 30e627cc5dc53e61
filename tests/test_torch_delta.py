"""The port's result cache on the CPU: the two tiers of run_debug.

* A repeated request is a whole-report hit: ``TorchBackend`` dispatches
  nothing, the tree is byte-equal to the first and to the JAX package's.
* A grown corpus (``grow_corpus_dir``) maps only its new segment's runs,
  merges the cached partial of the old one, and its report equals a
  from-scratch report of the port and the JAX package's report; so it does
  on the port's device lanes (every host budget 0) against the JAX
  package's report forced dense.
* ``sample:N`` skips the per-segment tier but not the whole-report one.
* The port's cache keys never equal the JAX package's for the same corpus,
  and a result-cache root shared with the JAX package serves the port
  nothing of the JAX package's.
* A cached entry the report cannot use whole is a miss, never served in
  part: a partial whose figure file goes before it is staged, a report
  whose partial was evicted, a report file edited in place through its
  hardlink.  Each time the report is computed again and equals the first.
* Past the root's size cap a publish evicts the least recently used
  entries.
* SegmentPartial survives its JSON round trip.

Tolerance: none.
"""

import json
import os
import shutil

import pytest
import torch

from nemo_tpu.analysis import delta as jax_delta
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu.store import resolve_store as jax_resolve_store
from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.models.synth import grow_corpus_dir
from nemo_tpu_torch.store import rcache, resolve_store


def _work(backend) -> dict:
    """What the backend computed, on either lane: device dispatches and
    host-lane runs per verb."""
    return {**backend.executor.dispatches, **backend.executor.host_runs}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_dir(tmp_path_factory):
    return write_corpus(SynthSpec(n_runs=10, seed=5), str(tmp_path_factory.mktemp("delta_full")))


def _jax_report(cd: str, out: str, figures: str) -> dict[str, bytes]:
    res = jax_run_debug(cd, out, JaxBackend(), reporter=JaxReporter(), figures=figures, ingest="python",
                        corpus_cache="off", result_cache="off")
    return jax_tree(res.report_dir)


def _cached_report(cd: str, out: str, tmp_path, figures: str, **backend_kw):
    backend = TorchBackend(device="cpu", **backend_kw)
    res = run_debug(cd, out, backend, figures=figures, ingest="native", corpus_cache=str(tmp_path / "cc"),
                    result_cache=str(tmp_path / "rc"))
    return res, backend


@pytest.mark.parametrize("figures", ["all", "sample:3"])
def test_repeat_is_a_report_hit_with_no_dispatch(full_dir, tmp_path, figures):
    first, b1 = _cached_report(full_dir, str(tmp_path / "R0"), tmp_path, figures)
    assert first.result_cache["state"] == "computed" and _work(b1)
    again, b2 = _cached_report(full_dir, str(tmp_path / "R1"), tmp_path, figures)
    assert (again.ingest, again.result_cache) == ("store_hit", {"state": "report_hit"})
    assert _work(b2) == {} and b2.analysis_routes == []
    tree = report_tree_bytes(again.report_dir)
    assert tree == report_tree_bytes(first.report_dir)
    assert tree == _jax_report(full_dir, str(tmp_path / "J"), figures)


@pytest.mark.parametrize("figures", ["failed", "none"])
def test_grown_corpus_maps_only_the_new_segment(full_dir, tmp_path, figures):
    cd = str(tmp_path / "grow" / "pb_synth")
    grow_corpus_dir(full_dir, cd, 7)
    _cached_report(cd, str(tmp_path / "R0"), tmp_path, figures)
    grow_corpus_dir(full_dir, cd, 10)
    res, backend = _cached_report(cd, str(tmp_path / "R1"), tmp_path, figures)
    assert res.ingest == "store_grown"
    assert res.result_cache == {
        "state": "computed", "segments_cached": 1, "segments_mapped": 1, "runs_cached": 7, "runs_mapped": 3,
    }
    # Only the new runs (plus the good run as context) were analysed.
    assert sum(r["rows"] for r in backend.analysis_routes if r["verb"] == "fused") <= 4
    tree = report_tree_bytes(res.report_dir)
    scratch = run_debug(cd, str(tmp_path / "S"), TorchBackend(device="cpu"), figures=figures, ingest="python",
                        corpus_cache="off", result_cache="off")
    assert tree == report_tree_bytes(scratch.report_dir)
    assert tree == _jax_report(cd, str(tmp_path / "J"), figures)
    # The merged report is now a whole-report hit.
    again, b2 = _cached_report(cd, str(tmp_path / "R2"), tmp_path, figures)
    assert again.result_cache["state"] == "report_hit" and _work(b2) == {}


def test_grown_corpus_device_lanes_match_jax(full_dir, tmp_path, monkeypatch):
    """The grown corpus's new segment on the dense lanes: the cached old
    partial merges with it into the JAX package's dense report."""
    lanes = {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0}
    cd = str(tmp_path / "grow" / "pb_synth")
    grow_corpus_dir(full_dir, cd, 7)
    _cached_report(cd, str(tmp_path / "R0"), tmp_path, "failed", **lanes)
    grow_corpus_dir(full_dir, cd, 10)
    res, backend = _cached_report(cd, str(tmp_path / "R1"), tmp_path, "failed", **lanes)
    assert res.result_cache["segments_cached"] == 1 and res.result_cache["runs_mapped"] == 3
    assert backend.executor.host_runs == {} and backend.executor.dispatches["fused"]
    assert not [r for r in backend.analysis_routes if r["route"] == "sparse"]
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    assert report_tree_bytes(res.report_dir) == _jax_report(cd, str(tmp_path / "J"), "failed")


def test_sample_policy_skips_partials(full_dir, tmp_path):
    cd = str(tmp_path / "grow" / "pb_synth")
    grow_corpus_dir(full_dir, cd, 7)
    _cached_report(cd, str(tmp_path / "R0"), tmp_path, "sample:2")
    grow_corpus_dir(full_dir, cd, 10)
    res, _ = _cached_report(cd, str(tmp_path / "R1"), tmp_path, "sample:2")
    assert res.result_cache["segments_cached"] == 0 and res.result_cache["runs_mapped"] == 10
    assert report_tree_bytes(res.report_dir) == _jax_report(cd, str(tmp_path / "J"), "sample:2")


def test_keys_never_collide_with_the_jax_package(full_dir, tmp_path):
    """Same corpus, same store content: the port's keys differ from the JAX
    package's, and a shared result root serves the port nothing."""
    port_store, jax_store = resolve_store(str(tmp_path / "pc")), jax_resolve_store(str(tmp_path / "jc"))
    from nemo_tpu.ingest.molly import load_molly_output as jax_load

    from nemo_tpu_torch.ingest.molly import load_molly_output

    assert port_store.put(full_dir, load_molly_output(full_dir))
    assert jax_store.put(full_dir, jax_load(full_dir))
    pm, jm = port_store.load_packed(full_dir), jax_store.load_packed(full_dir)
    assert [s["fingerprint"] for s in pm.store_segments] == [s["fingerprint"] for s in jm.store_segments]
    for figures in ("all", "failed", "none"):
        assert delta.report_cache_key(pm, figures) != jax_delta.report_cache_key(jm, figures)
        ps, js = delta.corpus_segments(pm), jax_delta.corpus_segments(jm)
        delta.attach_positions(ps, pm)
        jax_delta.attach_positions(js, jm)
        good = delta.choose_good_run(pm)
        assert delta.partial_cache_key(ps[0], ps, good, good, figures) != jax_delta.partial_cache_key(
            js[0], js, good, good, figures
        )
    assert delta.config_blob("all")["impl"] == "nemo_tpu_torch"

    shared = str(tmp_path / "shared")
    jax_run_debug(full_dir, str(tmp_path / "J"), JaxBackend(), figures="all", ingest="python",
                  corpus_cache=str(tmp_path / "jc2"), result_cache=shared)
    backend = TorchBackend(device="cpu")
    res = run_debug(full_dir, str(tmp_path / "P"), backend, figures="all", ingest="native",
                    corpus_cache=str(tmp_path / "pc2"), result_cache=shared)
    assert res.result_cache["state"] == "computed" and res.result_cache["segments_cached"] == 0
    assert _work(backend)


def test_partial_json_round_trip(full_dir, tmp_path):
    from nemo_tpu_torch.analysis.pipeline import select_figure_iters
    from nemo_tpu_torch.ingest.native import load_molly_output_packed
    from nemo_tpu_torch.utils.timing import PhaseTimer

    molly = load_molly_output_packed(full_dir)
    backend = TorchBackend(device="cpu")
    backend.init_graph_db("", molly)
    good = delta.choose_good_run(molly)
    figs = set(select_figure_iters("failed", molly.runs_iters, molly.failed_runs_iters, good))
    mo = delta.map_runs(backend, molly, full_dir, good, figs, PhaseTimer(), publish=True)
    p = mo.as_partial(molly.runs_iters)
    back = delta.SegmentPartial.from_json(p.to_json())
    assert back.to_json() == p.to_json()
    assert p.fig_files and all(f.startswith("run_") for f in p.fig_files)
    assert delta.reduce_partials([back], molly, good).repairs == delta.reduce_partials([p], molly, good).repairs


def test_partial_lost_before_staging_is_a_miss(full_dir, tmp_path, monkeypatch):
    """A concurrent eviction takes a cached partial's figure file between
    its verify and its staging: the segment is mapped, and the report (and
    the entry it publishes) holds every figure."""
    cd = str(tmp_path / "grow" / "pb_synth")
    grow_corpus_dir(full_dir, cd, 7)
    _cached_report(cd, str(tmp_path / "R0"), tmp_path, "failed")
    grow_corpus_dir(full_dir, cd, 10)
    load_entry = rcache.ResultCache._load_entry
    lost = []

    def evicting(self, kind, key):
        got = load_entry(self, kind, key)
        if got is not None and kind == "partial":
            fig = next(rel for rel, *_ in got[2] if rel.startswith("figures/"))
            os.remove(os.path.join(got[1], fig))
            lost.append(fig)
        return got

    monkeypatch.setattr(rcache.ResultCache, "_load_entry", evicting)
    res, _ = _cached_report(cd, str(tmp_path / "R1"), tmp_path, "failed")
    monkeypatch.undo()
    assert lost and res.result_cache["segments_cached"] == 0 and res.result_cache["runs_mapped"] == 10
    scratch = run_debug(cd, str(tmp_path / "S"), TorchBackend(device="cpu"), figures="failed", ingest="python",
                        corpus_cache="off", result_cache="off")
    want = report_tree_bytes(scratch.report_dir)
    assert report_tree_bytes(res.report_dir) == want
    again, b2 = _cached_report(cd, str(tmp_path / "R2"), tmp_path, "failed")
    assert again.result_cache["state"] == "report_hit" and _work(b2) == {}
    assert report_tree_bytes(again.report_dir) == want


def test_report_whose_partial_is_gone_is_a_miss(full_dir, tmp_path):
    first, _ = _cached_report(full_dir, str(tmp_path / "R0"), tmp_path, "all")
    want = report_tree_bytes(first.report_dir)
    shutil.rmtree(tmp_path / "rc" / "partial")
    res, backend = _cached_report(full_dir, str(tmp_path / "R1"), tmp_path, "all")
    assert res.result_cache["state"] == "computed" and _work(backend)
    assert report_tree_bytes(res.report_dir) == want
    # The partial is published again under its key, and the report entry
    # that names it serves again.
    again, b2 = _cached_report(full_dir, str(tmp_path / "R2"), tmp_path, "all")
    assert again.result_cache["state"] == "report_hit" and _work(b2) == {}
    assert report_tree_bytes(again.report_dir) == want


@pytest.mark.parametrize("victim, mapped", [("debugging.json", 0), ("figures", 1)])
def test_report_file_edited_in_place_is_not_served(full_dir, tmp_path, victim, mapped):
    """A report file shares its inode with the cache: an edit in place fails
    the manifest of the entry that holds it (the report's own file, or a
    figure of the partial the report names), and the next request computes
    the report, mapping the segment only if its partial failed."""
    first, _ = _cached_report(full_dir, str(tmp_path / "R0"), tmp_path, "all")
    want = report_tree_bytes(first.report_dir)
    path = os.path.join(first.report_dir, victim)
    if os.path.isdir(path):
        path = os.path.join(path, sorted(os.listdir(path))[0])
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(" ")
    res, backend = _cached_report(full_dir, str(tmp_path / "R1"), tmp_path, "all")
    assert res.result_cache["state"] == "computed" and res.result_cache["segments_mapped"] == mapped
    assert bool(_work(backend)) == bool(mapped)
    assert report_tree_bytes(res.report_dir) == want


def test_result_cache_evicts_the_least_recently_used(tmp_path, monkeypatch):
    rc = rcache.ResultCache(str(tmp_path / "rc"))
    figs = tmp_path / "figs"
    figs.mkdir()

    def put(key: str) -> None:
        name = f"run_{key[0]}_pre_prov.dot"
        (figs / name).write_bytes(b"x" * 1000)
        assert rc.put_partial(key, delta.SegmentPartial(iters=[0], fig_files=[name]), str(figs))

    keys = [c * 64 for c in "abc"]
    put(keys[0])
    put(keys[1])
    # keys[1] is the least recently used once keys[0] is read.
    os.utime(tmp_path / "rc" / "partial" / keys[1] / "entry.json", (1, 1))
    assert rc.load_partial(keys[0], str(tmp_path / "stage")) is not None
    sizes = [json.loads((tmp_path / "rc" / "partial" / k / "entry.json").read_text())["bytes"] for k in keys[:2]]
    monkeypatch.setattr(rcache, "RESULT_CACHE_MAX_BYTES", sum(sizes) + 10)
    put(keys[2])
    assert [rc.load_partial(k, str(tmp_path / "stage2")) is not None for k in keys] == [True, False, True]
