"""TorchBackend (device="cpu") against the JAX package's JaxBackend on the CPU.

Both sides are pinned to the dense route (the port's
``analysis_impl="dense"``; the JAX side's NEMO_ANALYSIS_IMPL=dense: fused
and diff on the device kernels; NEMO_SYNTH_IMPL=sparse_device: the
synth_ext verb).  Compared: the four
create_prototypes outputs, every failed run's missing events (to_json),
achieved_pre_goal_counts and synth_candidates, over the shared synthetic
corpus and the six case-study families.  Tolerance: none.
"""

import json

import pytest
import torch

from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu_torch import cli
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNS = 12


@pytest.fixture(scope="module")
def family_root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_backend_families")


@pytest.fixture
def dense_route(monkeypatch):
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    monkeypatch.setenv("NEMO_SYNTH_IMPL", "sparse_device")


def _drive(backend, molly):
    backend.init_graph_db("", molly)
    backend.load_raw_provenance()
    backend.simplify_prov(molly.get_runs_iters())


def _compare(corpus: str) -> None:
    jm, tm = jax_load(corpus), port_load(corpus)
    assert (jm.success_runs_iters, jm.failed_runs_iters) == (tm.success_runs_iters, tm.failed_runs_iters)
    jb, tb = JaxBackend(), TorchBackend(device="cpu", analysis_impl="dense")
    _drive(jb, jm)
    _drive(tb, tm)
    succ, failed, runs = jm.success_runs_iters, jm.failed_runs_iters, jm.runs_iters
    assert tb.good_run_iter() == jb.good_run_iter()
    assert tb.create_prototypes(succ, failed) == jb.create_prototypes(succ, failed)
    assert tb.proto_tables_by_run(succ, failed) == jb.proto_tables_by_run(succ, failed)
    _, _, jax_missing = jb.create_naive_diff_prov(False, failed, None, dot_iters=[])
    port_missing = tb.missing_events(failed)
    assert [[m.to_json() for m in ev] for ev in port_missing] == [
        [m.to_json() for m in ev] for ev in jax_missing
    ]
    assert tb.achieved_pre_goal_counts() == jb.achieved_pre_goal_counts()
    assert tb.synth_candidates(runs) == jb.synth_candidates(runs)
    # The JAX side really took the dense device route, as the port does.
    routes = {(r["verb"], r["route"]) for r in jb.analysis_routes}
    assert ("fused", "dense") in routes and ("diff", "dense") in routes
    assert tb.executor.dispatches["fused"] >= 1 and tb.executor.dispatches["diff"] == 1


def test_backend_matches_jax_synthetic(corpus_dir, dense_route):
    _compare(corpus_dir)


@pytest.mark.parametrize("family", sorted(CASE_STUDIES))
def test_backend_matches_jax_case_study(family, family_root, dense_route):
    _compare(write_case_study(family, RUNS, 0, str(family_root)))


def test_cli_document(corpus_dir, tmp_path, dense_route):
    out = tmp_path / "analysis.json"
    assert cli.main(["-faultInjOut", corpus_dir, "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    jm = jax_load(corpus_dir)
    jb = JaxBackend()
    _drive(jb, jm)
    failed = jm.failed_runs_iters
    inter, inter_miss, union, union_miss = jb.create_prototypes(jm.success_runs_iters, failed)
    _, _, missing = jb.create_naive_diff_prov(False, failed, None, dot_iters=[])
    assert doc["device"] == "cpu" and doc["runs"] == len(jm.runs)
    assert doc["good_run"] == jb.good_run_iter()
    assert (doc["inter_proto"], doc["union_proto"]) == (inter, union)
    assert doc["inter_proto_missing"] == {str(f): m for f, m in zip(failed, inter_miss)}
    assert doc["union_proto_missing"] == {str(f): m for f, m in zip(failed, union_miss)}
    assert doc["missing_events"] == {
        str(f): [m.to_json() for m in ev] for f, ev in zip(failed, missing)
    }
    counts = jb.achieved_pre_goal_counts()
    assert doc["achieved_pre_goal_counts"] == {str(i): counts[i] for i in jm.runs_iters}
    synth = jb.synth_candidates(jm.runs_iters)
    assert doc["synth_candidates"] == {str(i): synth[i] for i in jm.runs_iters}
    assert set(doc["timings_s"]) >= {"ingest", "fused", "diff", "synth_ext"}
