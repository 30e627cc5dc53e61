"""The port's corpus store on the CPU: every way a store serves a corpus
gives the arrays of a cold native parse and the JAX package's report.

* cold populate (the C++ engine's corpus), warm hit, a grown directory
  appended as a second segment, and a corrupted shard (a logged miss, then
  a re-parse that repopulates): the corpus arrays equal a cold
  ``ingest_native`` of the same directory (decoded through the vocabulary
  where an append interns in another order), and each report tree equals
  ``nemo_tpu.analysis.pipeline.run_debug``'s (object ingest, caches off);
* a store populated from the Python loader equals one from the engine;
* a corpus with quarantined runs stores its healthy rows and the
  quarantine record, and a warm hit reproduces quarantine.json; an edited
  source is stale,
  and an in-place rewrite outside the fast fingerprint's sample is stale
  under ``NEMO_STORE_FINGERPRINT=full``;
* ``load_corpus`` serves the packed corpus without the run records.

Tolerance: none.
"""

import json
import os

import numpy as np
import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output
from nemo_tpu_torch.ingest.native import ingest_native
from nemo_tpu_torch.models.synth import grow_corpus_dir
from nemo_tpu_torch.store import CorpusStore

FIGURES = "failed"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_dir(tmp_path_factory):
    return write_corpus(SynthSpec(n_runs=10, seed=5), str(tmp_path_factory.mktemp("store_full")))


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    """The JAX package's report tree of a directory, memoized by path."""
    memo = {}

    def get(cd: str) -> dict[str, bytes]:
        if cd not in memo:
            res = jax_run_debug(
                cd, str(tmp_path_factory.mktemp("jax")), JaxBackend(), reporter=JaxReporter(),
                figures=FIGURES, ingest="python", corpus_cache="off", result_cache="off",
            )
            memo[cd] = jax_tree(res.report_dir)
        return memo[cd]

    return get


def _decoded(c, cond: str, row: int) -> dict:
    """One run's graph with its ids decoded through the vocabulary."""
    cb = c.cond(cond)
    n, ne = int(cb.n_nodes[row]), int(cb.edge_mask[row].sum())
    return {
        "n_goals": int(cb.n_goals[row]),
        "tables": [c.tables[t] for t in cb.table_id[row, :n].tolist()],
        "labels": [c.labels[t] for t in cb.label_id[row, :n].tolist()],
        "times": [c.times[t] for t in cb.time_id[row, :n].tolist()],
        "types": cb.type_id[row, :n].tolist(),
        "edges": np.stack([cb.edge_src[row, :ne], cb.edge_dst[row, :ne]], 1).tolist(),
        "linear": bool(cb.chain_linear[row]),
        "ids": c.lazy_node_ids(cond, row),
        "prov": c.prov_json(cond, row),
    }


def _assert_same_corpus(got, cold, exact: bool) -> None:
    assert got.n_runs == cold.n_runs and got.max_depth == cold.max_depth
    np.testing.assert_array_equal(got.iteration, cold.iteration)
    np.testing.assert_array_equal(got.success, cold.success)
    for row in range(cold.n_runs):
        assert got.run_head_json(row) == cold.run_head_json(row)
        for cond in ("pre", "post"):
            assert _decoded(got, cond, row) == _decoded(cold, cond, row)
    if exact:
        assert (got.v, got.e, got.tables, got.labels, got.times) == (cold.v, cold.e, cold.tables, cold.labels,
                                                                    cold.times)
        for cond in ("pre", "post"):
            for f in ("table_id", "label_id", "time_id", "type_id", "is_goal", "node_mask", "edge_src",
                      "edge_dst", "edge_mask", "n_nodes", "n_goals", "chain_linear"):
                np.testing.assert_array_equal(getattr(got.cond(cond), f), getattr(cold.cond(cond), f))


def _report(cd: str, root: str, cc: str, figures: str = FIGURES):
    return run_debug(cd, root, TorchBackend(device="cpu"), figures=figures, ingest="native", corpus_cache=cc,
                     result_cache="off")


def test_cold_then_warm(full_dir, jax_report, tmp_path):
    cc = str(tmp_path / "cc")
    cold = _report(full_dir, str(tmp_path / "R0"), cc)
    assert cold.ingest == "native"
    assert report_tree_bytes(cold.report_dir) == jax_report(full_dir)
    store = CorpusStore(cc)
    assert store.probe(full_dir) == "hit"
    warm = store.load_packed(full_dir)
    assert warm.store_state == "hit" and len(warm.store_segments) == 1
    _assert_same_corpus(warm.native_corpus, ingest_native(full_dir, keep_handle=True), exact=True)
    res = _report(full_dir, str(tmp_path / "R1"), cc)
    assert res.ingest == "store_hit"
    assert report_tree_bytes(res.report_dir) == jax_report(full_dir)


def test_grown_directory_appends_a_segment(full_dir, jax_report, tmp_path):
    cd = str(tmp_path / "grow" / "pb_synth")
    cc = str(tmp_path / "cc")
    grow_corpus_dir(full_dir, cd, 6)
    assert _report(cd, str(tmp_path / "R0"), cc).ingest == "native"
    grow_corpus_dir(full_dir, cd, 10)
    store = CorpusStore(cc)
    assert store.probe(cd) == "grown"
    res = _report(cd, str(tmp_path / "R1"), cc)
    assert res.ingest == "store_grown"
    assert [s["n_runs"] for s in res.molly.store_segments] == [6, 4]
    assert report_tree_bytes(res.report_dir) == jax_report(cd)
    warm = store.load_packed(cd)
    assert warm.store_state == "hit"
    _assert_same_corpus(warm.native_corpus, ingest_native(cd, keep_handle=True), exact=False)


def _log_records(path) -> list[dict]:
    """The obs JSON-lines log records written to ``path`` (NEMO_LOG_FILE)."""
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_corrupt_shard_is_a_logged_miss_then_reparsed(full_dir, jax_report, tmp_path, monkeypatch):
    cc = str(tmp_path / "cc")
    _report(full_dir, str(tmp_path / "R0"), cc)
    store = CorpusStore(cc)
    shard = os.path.join(store.store_dir(full_dir), "seg-000", "arrays_pre.bin")
    with open(shard, "r+b") as fh:
        fh.seek(100)
        byte = fh.read(1)
        fh.seek(100)
        fh.write(bytes([byte[0] ^ 0xFF]))
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    assert store.load_packed(full_dir) is None
    assert any(r["level"] == "error" and r["event"] == "store.corrupt" and "crc32" in r["error"]
               for r in _log_records(log))
    res = _report(full_dir, str(tmp_path / "R1"), cc)
    assert res.ingest == "native"  # re-parsed, and the store repopulated
    assert report_tree_bytes(res.report_dir) == jax_report(full_dir)
    again = store.load_packed(full_dir)
    assert again is not None
    _assert_same_corpus(again.native_corpus, ingest_native(full_dir, keep_handle=True), exact=True)


def test_python_populate_equals_native_populate(full_dir, tmp_path):
    py_store, nat_store = CorpusStore(str(tmp_path / "py")), CorpusStore(str(tmp_path / "nat"))
    assert py_store.put(full_dir, load_molly_output(full_dir))
    from nemo_tpu_torch.ingest.native import load_molly_output_packed

    assert nat_store.put(full_dir, load_molly_output_packed(full_dir))
    a, b = py_store.load_packed(full_dir), nat_store.load_packed(full_dir)
    _assert_same_corpus(a.native_corpus, b.native_corpus, exact=True)
    assert [s["fingerprint"] for s in a.store_segments] == [s["fingerprint"] for s in b.store_segments]


def test_quarantined_corpus_is_not_stored(full_dir, tmp_path, monkeypatch):
    """The quarantined run is not stored, the rest of the corpus is: the
    store holds the healthy rows with the quarantine record, and a warm hit
    reproduces the cold report, quarantine.json included."""
    import shutil

    cd = str(tmp_path / "q" / "pb_synth")
    shutil.copytree(full_dir, cd)
    with open(os.path.join(cd, "run_3_post_provenance.json"), "w") as fh:
        fh.write('{"goals": [')
    cc = str(tmp_path / "cc")
    log = tmp_path / "log.jsonl"
    monkeypatch.setenv("NEMO_LOG_FILE", str(log))
    res = _report(cd, str(tmp_path / "R"), cc)
    assert res.ingest == "python_quarantine_fallback"
    assert any(r["level"] == "warning" and r["event"] == "ingest.native_failed_quarantine_fallback"
               and "quarantining Python loader" in r["detail"] for r in _log_records(log))
    store = CorpusStore(cc)
    assert store.probe(cd) == "hit"
    with open(os.path.join(store.store_dir(cd), "header.json")) as fh:
        header = json.load(fh)
    assert [(q["position"], q["file"]) for q in header["quarantined"]] == [(3, "run_3_post_provenance.json")]
    assert header["segments"][0]["positions"] == [p for p in range(10) if p != 3]
    with open(os.path.join(res.report_dir, "telemetry.json")) as fh:
        assert json.load(fh)["ingest"] == "python_quarantine_fallback"
    cold = report_tree_bytes(res.report_dir)
    assert json.loads(cold["quarantine.json"])[0]["position"] == 3
    warm = _report(cd, str(tmp_path / "R1"), cc)
    assert warm.ingest == "store_hit" and [r.iteration for r in warm.molly.runs] == [0, 1, 2, 4, 5, 6, 7, 8, 9]
    assert report_tree_bytes(warm.report_dir) == cold


def test_edited_source_is_stale(full_dir, tmp_path):
    import shutil

    cd = str(tmp_path / "e" / "pb_synth")
    shutil.copytree(full_dir, cd)
    cc = str(tmp_path / "cc")
    _report(cd, str(tmp_path / "R0"), cc)
    os.remove(os.path.join(cd, "run_9_spacetime.dot"))
    assert CorpusStore(cc).probe(cd) == "stale"
    assert CorpusStore(cc).load_packed(cd) is None


def test_full_fingerprint_catches_an_in_place_rewrite(tmp_path, monkeypatch):
    """An unsampled provenance file rewritten in place under the same name:
    the fast fingerprint's budget does not cover it; the full one does."""
    # 40 runs: 120 files, more than the fast fingerprint's 64-file sample.
    cd = write_corpus(SynthSpec(n_runs=40, seed=5), str(tmp_path / "f"))
    cc = str(tmp_path / "cc")
    _report(cd, str(tmp_path / "R0"), cc, figures="none")
    store = CorpusStore(cc)
    sample = {rec[0] for rec in store._read_header(store.store_dir(cd))["source"]["sample"]}
    victim = next(f"run_{i}_pre_provenance.json" for i in range(40) if f"run_{i}_pre_provenance.json" not in sample)
    path = os.path.join(cd, victim)
    st = os.stat(path)
    with open(path, "a") as fh:
        fh.write(" ")
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    os.utime(cd, ns=(os.stat(cd).st_atime_ns, store._read_header(store.store_dir(cd))["source"]["dir_mtime_ns"]))
    monkeypatch.delenv("NEMO_STORE_FINGERPRINT", raising=False)
    assert store.probe(cd) == "hit"
    monkeypatch.setenv("NEMO_STORE_FINGERPRINT", "full")
    assert store.probe(cd) == "stale"
    assert store.load_corpus(cd) is None


def test_load_corpus_is_the_packed_corpus_alone(full_dir, tmp_path):
    from nemo_tpu_torch.ingest.native import corpus_step_static

    cc = str(tmp_path / "cc")
    _report(full_dir, str(tmp_path / "R0"), cc)
    c = CorpusStore(cc).load_corpus(full_dir)
    cold = ingest_native(full_dir, keep_handle=True)
    _assert_same_corpus(c, cold, exact=True)
    assert len(c.store_segments) == 1 and not hasattr(c, "runs")
    assert corpus_step_static(c) == corpus_step_static(cold)


def test_populate_evicts_the_least_recently_used_store(full_dir, tmp_path, monkeypatch):
    """Past the root's size cap, populating evicts the stores used least
    recently, never the one just written."""
    import nemo_tpu_torch.store as store_mod

    other = write_corpus(SynthSpec(n_runs=6, seed=7), str(tmp_path / "o"))
    third = write_corpus(SynthSpec(n_runs=6, seed=8), str(tmp_path / "t"))
    store = CorpusStore(str(tmp_path / "cc"))
    assert store.put(full_dir, load_molly_output(full_dir))
    assert store.put(other, load_molly_output(other))
    # full_dir used last: other is the least recently used.
    os.utime(os.path.join(store.store_dir(other), "header.json"), (1, 1))
    assert store.load_packed(full_dir) is not None
    sizes = [store_mod.store_size_bytes(store.store_dir(d)) for d in (full_dir, other)]
    monkeypatch.setattr(store_mod, "STORE_MAX_BYTES", sizes[0] + sizes[1])
    assert store.put(third, load_molly_output(third))
    assert (store.probe(full_dir), store.probe(other), store.probe(third)) == ("hit", "miss", "hit")
