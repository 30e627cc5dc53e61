"""The port's fault-injector seam (``nemo_tpu_torch/ingest/adapters.py``)
against the JAX package's, on the CPU.

* ``molly_to_trace`` writes the same trace.json as the JAX package's, and
  ``load_output`` of it (a case-study family and a synthetic seed) gives the
  same runs field for field, the same iteration lists and the same
  synthesized spacetime diagrams;
* sniffing, ``NEMO_INJECTOR``, the error of an unknown injector and of an
  unsniffable directory, and a quarantined trace entry are the same;
* the report tree of a trace-JSON corpus equals the JAX package's byte for
  byte, on the port's default routes (against the JAX side's
  ``NEMO_ANALYSIS_IMPL=crossover``) and on its device lanes (host budgets
  0, or dense forced, against the JAX side forced dense);
* through the corpus store: a cold populate, a warm hit and a sweep grown
  inside its one document (the index append), which maps only the new
  runs and equals the from-scratch report;
* the CLI's ``--injector``.

Tolerance: none.
"""

import json
import os

import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest import adapters as jax_adapters
from nemo_tpu.models.case_studies import write_case_study
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest import adapters

FIGURES = "failed"
#: The port's device lanes: every host budget 0, or the dense lane forced.
DEVICE_LANES = {
    "device_auto": {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0},
    "dense": {"analysis_impl": "dense"},
}
#: (the port's TorchBackend arguments, the JAX side's NEMO_ANALYSIS_IMPL)
ROUTES = {"default": ({}, "crossover"), **{k: (v, "dense") for k, v in DEVICE_LANES.items()}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Molly sweeps: a case-study family and a synthetic seed."""
    root = str(tmp_path_factory.mktemp("adapter_sources"))
    return {
        "family": write_case_study("CA-2434-bootstrap-synchronization", 12, 0, root),
        "synth": write_corpus(SynthSpec(n_runs=10, seed=5), root),
    }


@pytest.fixture(scope="module")
def traces(sources, tmp_path_factory):
    """Each source converted to the trace-JSON layout by the port."""
    root = tmp_path_factory.mktemp("adapter_traces")
    return {k: adapters.molly_to_trace(src, str(root / k / f"{k}_trace")) for k, src in sources.items()}


def _jax_report(corpus: str, out: str, impl: str, figures: str = FIGURES, **kw) -> dict[str, bytes]:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEMO_ANALYSIS_IMPL", impl)
        res = jax_run_debug(corpus, out, JaxBackend(), reporter=JaxReporter(), figures=figures, ingest="python",
                            corpus_cache="off", result_cache="off", **kw)
        return jax_tree(res.report_dir)


def _assert_same_tree(port: dict[str, bytes], jax: dict[str, bytes]) -> None:
    assert sorted(port) == sorted(jax)
    assert [k for k in jax if port[k] != jax[k]] == []


def _runs_doc(molly) -> list:
    return [(r.to_json(), r.time_pre_holds, r.time_post_holds, r.succeeded) for r in molly.runs]


@pytest.mark.parametrize("kind", ["family", "synth"])
def test_molly_to_trace_writes_the_jax_document(kind, sources, traces, tmp_path):
    theirs = jax_adapters.molly_to_trace(sources[kind], str(tmp_path / "jax"))
    with open(os.path.join(theirs, "trace.json"), "rb") as a, open(os.path.join(traces[kind], "trace.json"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kind", ["family", "synth"])
def test_load_output_matches_jax(kind, traces):
    mine, theirs = adapters.load_output(traces[kind]), jax_adapters.load_output(traces[kind])
    assert _runs_doc(mine) == _runs_doc(theirs)
    assert (mine.runs_iters, mine.success_runs_iters, mine.failed_runs_iters) == (
        theirs.runs_iters, theirs.success_runs_iters, theirs.failed_runs_iters)
    assert mine.ships_spacetime_dots is theirs.ships_spacetime_dots is False
    assert mine.quarantined == theirs.quarantined == []
    for run in mine.runs:
        assert mine.spacetime_dot_text(run.iteration, run=run) == theirs.spacetime_dot_text(run.iteration)


def test_trace_roundtrip_keeps_the_molly_runs(sources, traces):
    """The trace layout carries every field of the Molly runs, and its
    synthesized diagrams are the generator's own files."""
    from nemo_tpu_torch.ingest.molly import load_molly_output

    molly, trace = load_molly_output(sources["synth"]), adapters.load_output(traces["synth"])
    assert _runs_doc(trace) == _runs_doc(molly)
    for run in trace.runs:
        assert trace.spacetime_dot_text(run.iteration) == molly.spacetime_dot_text(run.iteration)


def test_sniffing_and_errors_match_jax(sources, traces, tmp_path, monkeypatch):
    monkeypatch.delenv("NEMO_INJECTOR", raising=False)
    for d, name in ((sources["synth"], "molly"), (traces["synth"], "trace-json")):
        assert adapters.resolve_injector(d).name == jax_adapters.resolve_injector(d).name == name
        assert adapters.resolve_injector(d).index_file == jax_adapters.resolve_injector(d).index_file
        assert adapters.MollyInjector.count_runs(sources["synth"]) == 10
    assert adapters.TraceJsonInjector.count_runs(traces["synth"]) == 10
    empty = tmp_path / "empty"
    empty.mkdir()
    errors = []
    for mod in (adapters, jax_adapters):
        with pytest.raises(ValueError) as ex:
            mod.resolve_injector(str(empty))
        errors.append(str(ex.value))
        with pytest.raises(ValueError) as ex:
            mod.resolve_injector(str(empty), "mollly")
        errors.append(str(ex.value))
    assert errors[:2] == errors[2:] and "cannot sniff" in errors[0] and "unknown injector" in errors[1]
    monkeypatch.setenv("NEMO_INJECTOR", "trace-json")
    assert adapters.injector_arg() == jax_adapters.injector_arg() == "trace-json"
    assert adapters.injector_arg("molly") == "molly"
    monkeypatch.setenv("NEMO_INJECTOR", "junk")
    with pytest.raises(ValueError, match="unknown injector 'junk'"):
        adapters.injector_arg()


def test_trace_quarantine_matches_jax(traces, tmp_path, monkeypatch):
    """A malformed trace entry (a dep naming an undeclared node, a missing
    id) is quarantined by both packages with the same record; with
    NEMO_QUARANTINE off the port raises."""
    with open(os.path.join(traces["synth"], "trace.json")) as fh:
        doc = json.load(fh)
    doc["runs"][2]["provenance"]["post"]["deps"].append(["nope", "nada"])
    del doc["runs"][6]["id"]
    d = tmp_path / "bad"
    d.mkdir()
    (d / "trace.json").write_text(json.dumps(doc))
    mine, theirs = adapters.load_output(str(d)), jax_adapters.load_output(str(d))
    assert [q["position"] for q in mine.quarantined] == [2, 6]
    assert mine.quarantined == theirs.quarantined
    assert _runs_doc(mine) == _runs_doc(theirs)
    monkeypatch.setenv("NEMO_QUARANTINE", "off")
    with pytest.raises(ValueError, match="undeclared node"):
        adapters.load_output(str(d))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", ["family", "synth"])
def test_trace_report_matches_jax(kind, route, traces, tmp_path):
    backend_kw, impl = ROUTES[route]
    want = _jax_report(traces[kind], str(tmp_path / "jax"), impl)
    backend = TorchBackend(device="cpu", **backend_kw)
    res = run_debug(traces[kind], str(tmp_path / "port"), backend, figures=FIGURES)
    _assert_same_tree(report_tree_bytes(res.report_dir), want)
    assert res.ingest == "python"
    assert any(k.endswith("_spacetime.svg") for k in want)
    if route != "default":
        assert not backend.executor.host_runs, backend.executor.host_runs


def test_trace_store_hit_and_index_append(sources, tmp_path):
    """A trace-JSON sweep through the corpus store and the result cache:
    cold (parsed, stored), warm (a report hit), then grown inside its one
    document: the store appends only the new entries and the report maps
    only them, equal to the from-scratch report and to the JAX package's."""
    full = adapters.molly_to_trace(sources["synth"], str(tmp_path / "full" / "sweep"))
    live = str(tmp_path / "live" / "sweep")
    cc, rc = str(tmp_path / "cc"), str(tmp_path / "rc")

    def report(tag):
        return run_debug(live, str(tmp_path / tag), TorchBackend(device="cpu"), figures=FIGURES, corpus_cache=cc,
                         result_cache=rc)

    adapters.TraceJsonInjector.materialize_prefix(full, live, 7)
    cold = report("cold")
    assert cold.ingest == "python" and cold.result_cache["runs_mapped"] == 7
    warm = report("warm")
    assert warm.ingest == "store_hit" and warm.result_cache == {"state": "report_hit"}
    assert report_tree_bytes(warm.report_dir) == report_tree_bytes(cold.report_dir)
    adapters.TraceJsonInjector.materialize_prefix(full, live, 10)
    grown = report("grown")
    assert grown.ingest == "store_grown"
    assert grown.result_cache == {"state": "computed", "segments_cached": 1, "segments_mapped": 1,
                                  "runs_cached": 7, "runs_mapped": 3}
    scratch = run_debug(live, str(tmp_path / "scratch"), TorchBackend(device="cpu"), figures=FIGURES)
    tree = report_tree_bytes(grown.report_dir)
    assert tree == report_tree_bytes(scratch.report_dir)
    _assert_same_tree(tree, _jax_report(live, str(tmp_path / "jax"), "crossover"))


def test_cli_injector(traces, tmp_path, capsys):
    out = str(tmp_path / "R")
    assert cli.main(["-faultInjOut", traces["synth"], "--device", "cpu", "--results-dir", out, "--figures", "none",
                     "--injector", "trace-json"]) == 0
    assert os.path.isfile(os.path.join(out, "synth_trace", "debugging.json"))
    assert "ingest python" in capsys.readouterr().out
    # A pinned layout is trusted: molly on a trace directory finds no runs.json.
    with pytest.raises(FileNotFoundError):
        cli.main(["-faultInjOut", traces["synth"], "--device", "cpu", "--results-dir", out, "--injector", "molly",
                  "--ingest", "python"])
    doc = str(tmp_path / "a.json")
    assert cli.main(["-faultInjOut", traces["synth"], "--device", "cpu", "--out", doc]) == 0
    with open(doc) as fh:
        assert json.load(fh)["runs"] == 10
