"""The reference agrees with the program's CPU run at small sizes: every
report document of the six families and of a long sweep, and every query
of the pool on both of the engine's lanes; the control, the reference with
every second run left out, is rejected; and the reference's copies of the
JAX package's modules hold the same text as those modules."""

import ast
import json
import os

import pytest

from nemo_tpu_torch.analysis.pipeline import run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.query.engine import execute_query, ingest_corpus
from nemo_tpu_torch.query.lang import parse_query as program_parse
from portbench.check import query_mismatch, report_mismatches
from portbench.control import control_readings
from portbench.corpora import write_corpora
from portbench.loops.query import query_pool
from portbench.reference.molly import load_molly_output
from portbench.reference.qlang import parse_query
from portbench.reference.query import expected_query
from portbench.reference.report import expected_report

from benchutil import REPO, small_copy

FAMILIES = {"generator": "case_studies", "n_runs": 30, "base_seed": 0, "families": [
    "pb_asynchronous", "CA-2083-hinted-handoff", "CA-2434-bootstrap-synchronization",
    "MR-2995-failed-after-expiry", "MR-3858-hadoop", "ZK-1270-racing-sent-flag"]}
LONG = {"generator": "synth", "spec": {"n_runs": 40, "eot": 80, "eff": 4, "name": "pb_long"}, "base_seed": 6}
with open(os.path.join(REPO, "portbench", "traffic", "query.json"), encoding="utf-8") as _f:
    QUERY_TRAFFIC = json.load(_f)
CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("config,figures", [(FAMILIES, "sample:8"), (LONG, "sample:8"), (LONG, "all")],
                         ids=["families", "long", "long-all"])
def test_reports_equal_the_reference(tmp_path, config, figures):
    for c in write_corpora(config, 4294967311, str(tmp_path / "c"), str(tmp_path / "cache")):
        res = run_debug(c["dir"], str(tmp_path / "r"), TorchBackend(device="cpu"), figures=figures,
                        corpus_cache="off", result_cache="off")
        assert report_mismatches(res.report_dir, expected_report(c["dir"], figures)) == []


def test_queries_equal_the_reference(tmp_path):
    cs = {c["name"]: c["dir"] for c in write_corpora(FAMILIES, 7, str(tmp_path / "c"), str(tmp_path / "cache"))}
    pool = query_pool(QUERY_TRAFFIC, list(cs))
    assert len(set(pool)) == len(pool) == 6 * 4 * 2
    for name, d in cs.items():
        molly = ingest_corpus(d, str(tmp_path / "store"))
        ref = load_molly_output(d)
        for _, text, host_work in [q for q in pool if q[0] == name]:
            doc = execute_query(program_parse(text), molly, device="cpu", use_cache=False,
                                query_host_work=host_work)
            assert not query_mismatch(doc, expected_query(parse_query(text), ref)), (name, text, host_work)


def test_the_canned_queries_are_the_verbs():
    from nemo_tpu_torch.query.verbs import VERB_QUERIES

    assert [program_parse(t) for t in QUERY_TRAFFIC["canned"]] == [
        VERB_QUERIES[v] for v in ("achieved_pre", "pre_triggers", "post_triggers", "ext_candidates")]


def test_a_wrong_document_is_rejected(tmp_path):
    (c,) = write_corpora(FAMILIES | {"families": ["ZK-1270-racing-sent-flag"]}, 3, str(tmp_path / "c"),
                         str(tmp_path / "cache"))
    res = run_debug(c["dir"], str(tmp_path / "r"), TorchBackend(device="cpu"), figures="sample:8",
                    corpus_cache="off", result_cache="off")
    exp = expected_report(c["dir"], "sample:8")
    exp["debugging"][3]["recommendation"] = ["altered"]
    assert report_mismatches(res.report_dir, exp) == [f"debugging.json run {exp['debugging'][3]['iteration']}"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_rejected(tmp_path, workload):
    root = small_copy(str(tmp_path / "checkout"))
    out = control_readings(workload, 11, str(tmp_path / "w"), f"{root}/portbench")
    assert out["answers_rejected"] == out["answers"] > 0
    assert out["mismatched_documents"] >= out["answers"]


# reference module -> the JAX package's module it copies
COPIES = {"corrections": "analysis/corrections.py", "protos": "analysis/protos.py", "figures": "report/figures.py",
          "dot": "report/dot.py", "qlang": "query/lang.py", "pgraph": "graphs/pgraph.py",
          "datatypes": "ingest/datatypes.py", "triggers": "analysis/queries.py", "synth": "analysis/synth.py"}


def _top_level(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            out[getattr(target, "id", ast.dump(target))] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize("module", sorted(COPIES))
def test_the_reference_copies_the_jax_package_text(module):
    """Every function, class and constant of the copy is the JAX package's,
    letter for letter: the reference shares no code with the program's
    timed path."""
    ours = _top_level(os.path.join(REPO, "portbench", "reference", f"{module}.py"))
    theirs = _top_level(os.path.join(REPO, "nemo_tpu", COPIES[module]))
    assert ours and {k: theirs.get(k) for k in ours} == ours
