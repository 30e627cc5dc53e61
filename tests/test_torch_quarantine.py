"""Quarantine in the port's corpus store, against the JAX package's, on
the CPU.

A corpus with one or two malformed provenance files is reported by both
packages from one directory, each with its own corpus store and result
cache: cold (the engine stops at the first bad file, the quarantining
Python loader parses the rest, the store keeps the healthy rows and the
quarantine records), warm (a store hit and a whole-report hit, with its
quarantine.json), then after a repair of one file (the store re-ingests
that run alone as a GROWN append: the report maps 1 run) and again warm.
At every step the report trees are byte-equal, on the port's default
routes (against the JAX side's ``NEMO_ANALYSIS_IMPL=crossover``) and on
its device lanes (host budgets 0, against the JAX side forced dense), and
the store headers' ``quarantined`` records are equal, the watched files'
stats included.  Also: the trace-JSON layout's quarantine and its repair
through the index append; the report key covers the quarantine set;
``NEMO_QUARANTINE=off`` raises.  Tolerance: none.
"""

import json
import os
import shutil

import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.store import CorpusStore as JaxStore
from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.adapters import TraceJsonInjector, molly_to_trace
from nemo_tpu_torch.store import CorpusStore

FIGURES = "failed"
#: (the port's TorchBackend arguments, the JAX side's NEMO_ANALYSIS_IMPL)
ROUTES = {
    "default": ({}, "crossover"),
    "device_lanes": ({"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0}, "dense"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    return write_corpus(SynthSpec(n_runs=12, seed=5), str(tmp_path_factory.mktemp("q_pristine")))


def _corrupt(d: str, positions) -> None:
    """Truncate each position's post provenance file (a half-written run)."""
    for pos in positions:
        p = os.path.join(d, f"run_{pos}_post_provenance.json")
        with open(p, "rb") as fh:
            b = fh.read()
        with open(p, "wb") as fh:
            fh.write(b[: len(b) // 2])


class _Sides:
    """Both packages' reports of one directory, each with its own store and
    result cache under ``root``."""

    def __init__(self, d: str, root, route: str) -> None:
        self.d, self.root = d, root
        self.backend_kw, self.impl = ROUTES[route]

    def jax(self, tag: str):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NEMO_ANALYSIS_IMPL", self.impl)
            res = jax_run_debug(self.d, str(self.root / "jres" / tag), JaxBackend(), figures=FIGURES,
                                corpus_cache=str(self.root / "jcc"), result_cache=str(self.root / "jrc"))
            return jax_tree(res.report_dir)

    def port(self, tag: str):
        backend = TorchBackend(device="cpu", **self.backend_kw)
        res = run_debug(self.d, str(self.root / "pres" / tag), backend, figures=FIGURES,
                        corpus_cache=str(self.root / "pcc"), result_cache=str(self.root / "prc"))
        return res, backend, report_tree_bytes(res.report_dir)

    def headers(self) -> tuple[dict, dict]:
        def read(store):
            with open(os.path.join(store.store_dir(self.d), "header.json")) as fh:
                return json.load(fh)

        return read(JaxStore(str(self.root / "jcc"))), read(CorpusStore(str(self.root / "pcc")))

    def step(self, tag: str):
        want = self.jax(tag)
        res, backend, got = self.port(tag)
        assert sorted(got) == sorted(want)
        assert [k for k in want if got[k] != want[k]] == []
        jh, ph = self.headers()
        assert ph.get("quarantined") == jh.get("quarantined")
        assert [s.get("positions") for s in ph["segments"]] == [s.get("positions") for s in jh["segments"]]
        if self.impl == "dense" and res.result_cache.get("state") != "report_hit":
            assert not backend.executor.host_runs, backend.executor.host_runs
        return res, got


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_quarantine_cold_warm_repaired_match_jax(route, pristine, tmp_path):
    d = str(tmp_path / "sweep" / "pb_synth")
    shutil.copytree(pristine, d)
    _corrupt(d, (3, 8))
    sides = _Sides(d, tmp_path, route)

    cold, tree = sides.step("cold")
    assert cold.ingest == "python_quarantine_fallback"
    assert cold.result_cache["runs_mapped"] == 10
    assert [q["position"] for q in json.loads(tree["quarantine.json"])] == [3, 8]
    assert CorpusStore(str(tmp_path / "pcc")).probe(d) == "hit"

    warm, warm_tree = sides.step("warm")
    assert warm.ingest == "store_hit" and warm.result_cache == {"state": "report_hit"}
    assert warm_tree == tree
    assert [q["position"] for q in warm.molly.quarantined] == [3, 8]

    shutil.copy(os.path.join(pristine, "run_3_post_provenance.json"), os.path.join(d, "run_3_post_provenance.json"))
    assert CorpusStore(str(tmp_path / "pcc")).probe(d) == "grown"
    repaired, rep_tree = sides.step("repaired")
    assert repaired.ingest == "store_grown"
    assert repaired.result_cache == {"state": "computed", "segments_cached": 1, "segments_mapped": 1,
                                     "runs_cached": 10, "runs_mapped": 1}
    assert [q["position"] for q in json.loads(rep_tree["quarantine.json"])] == [8]
    assert delta.report_cache_key(repaired.molly, FIGURES) != delta.report_cache_key(warm.molly, FIGURES)
    # The repaired run was appended after the healthy rows; its metadata is
    # read by its source position.
    by_iter = {r.iteration: r for r in repaired.molly.runs}
    assert [r.iteration for r in repaired.molly.runs][-1] == 3
    assert by_iter[3].failure_spec is not None and by_iter[9].messages is not None

    again, again_tree = sides.step("again")
    assert again.ingest == "store_hit" and again.result_cache == {"state": "report_hit"}
    assert again_tree == rep_tree


def test_repair_of_every_quarantined_run_drops_quarantine_json(pristine, tmp_path):
    d = str(tmp_path / "sweep" / "pb_synth")
    shutil.copytree(pristine, d)
    _corrupt(d, (5,))
    sides = _Sides(d, tmp_path, "default")
    sides.step("cold")
    shutil.copy(os.path.join(pristine, "run_5_post_provenance.json"), os.path.join(d, "run_5_post_provenance.json"))
    res, tree = sides.step("repaired")
    assert "quarantine.json" not in tree and not res.molly.quarantined
    assert "quarantined" not in sides.headers()[1]
    assert res.result_cache["runs_mapped"] == 1


def test_trace_quarantine_repaired_through_the_index_append(pristine, tmp_path):
    """A bad trace entry is stored as quarantined (no watched file); the
    next rewrite of the document re-reads it, and once it converts the
    index append takes it alone."""
    full = molly_to_trace(pristine, str(tmp_path / "full" / "sweep"))
    d = str(tmp_path / "live" / "sweep")
    TraceJsonInjector.materialize_prefix(full, d, 12)
    path = os.path.join(d, "trace.json")
    with open(path) as fh:
        doc = json.load(fh)
    good = json.loads(json.dumps(doc["runs"][4]))
    doc["runs"][4]["provenance"]["pre"]["deps"].append(["x", "y"])
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    sides = _Sides(d, tmp_path, "default")
    cold, tree = sides.step("cold")
    assert cold.ingest == "python" and [q["position"] for q in cold.molly.quarantined] == [4]
    assert sides.headers()[1]["quarantined"][0]["files"] == []
    doc["runs"][4] = good
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    repaired, rep_tree = sides.step("repaired")
    assert repaired.ingest == "store_grown" and repaired.result_cache["runs_mapped"] == 1
    assert "quarantine.json" not in rep_tree


def test_report_key_covers_the_quarantine_set(pristine, tmp_path):
    """Two corpora with the same healthy runs and different quarantine
    records (the same file truncated, or filled with garbage) get different
    report keys; so does the JAX package's rule on a bare record."""

    class M:
        store_segments = [{"name": "seg-000", "n_runs": 2, "fingerprint": "f0"}]
        runs = [object(), object()]
        quarantined = []

    a, b = M(), M()
    b.quarantined = [{"position": 1, "file": "x", "error": "e"}]
    assert delta.report_cache_key(a, "all") != delta.report_cache_key(b, "all")

    keys = []
    for kind in ("truncate", "garbage"):
        d = str(tmp_path / kind / "pb_synth")
        shutil.copytree(pristine, d)
        p = os.path.join(d, "run_6_pre_provenance.json")
        if kind == "truncate":
            _corrupt(d, ())
            with open(p, "r+b") as fh:
                fh.truncate(10)
        else:
            with open(p, "w") as fh:
                fh.write("garbage")
        res = run_debug(d, str(tmp_path / "R" / kind), TorchBackend(device="cpu"), figures="none",
                        corpus_cache=str(tmp_path / "cc" / kind), result_cache="off")
        assert [q["position"] for q in res.molly.quarantined] == [6]
        keys.append((delta.report_cache_key(res.molly, "none"), [s["fingerprint"] for s in res.molly.store_segments]))
    assert keys[0][1] == keys[1][1]
    assert keys[0][0] != keys[1][0]


def test_quarantine_off_raises(pristine, tmp_path, monkeypatch):
    d = str(tmp_path / "pb_synth")
    shutil.copytree(pristine, d)
    _corrupt(d, (2,))
    monkeypatch.setenv("NEMO_QUARANTINE", "off")
    with pytest.raises(RuntimeError, match="native ingestion failed"):
        run_debug(d, str(tmp_path / "R"), TorchBackend(device="cpu"), figures="none", corpus_cache="off",
                  result_cache="off")
