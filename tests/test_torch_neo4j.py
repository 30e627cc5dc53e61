"""The port's Neo4j backend (nemo_tpu_torch/backend/neo4j_backend.py, over
the port's own Bolt client) against the JAX package's, on the CPU.

No Neo4j server runs here or on the card's machine: the backend talks real
Bolt v1 over TCP to tests/fake_neo4j.py's in-process server, which executes
each statement by its ``// nemo:<verb>`` marker.

* the report (debugging.json and every figure .dot) on the fixture corpus
  and two families equals the JAX Neo4jBackend's tree byte for byte and the
  port's PythonBackend's; like the JAX one it has no repairs.json (the
  backend has no synthesis hooks) and maps the whole corpus once through
  the global verbs (supports_delta False);
* the statements the server receives, text and parameters, in order, equal
  those the JAX Neo4jBackend sends on the same corpus;
* a store corrupted under the backend fails the bulk load's count check;
* every ``Q_*`` statement is the JAX module's, character for character.
"""

from __future__ import annotations

import json
import threading

import pytest

from fake_neo4j import FakeNeo4jServer
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend import neo4j_backend as jax_neo
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend import neo4j_backend as port_neo
from nemo_tpu_torch.backend.python_ref import PythonBackend
from nemo_tpu_torch.ingest.molly import load_molly_output
from nemo_tpu_torch.models.case_studies import write_case_study

FAMILIES = ["ZK-1270-racing-sent-flag", "CA-2083-hinted-handoff"]
CACHES_OFF = dict(corpus_cache="off", result_cache="off")


def test_statements_are_the_jax_modules():
    names = sorted(n for n in dir(jax_neo) if n.startswith("Q_"))
    assert names == sorted(n for n in dir(port_neo) if n.startswith("Q_"))
    assert len(names) >= 15
    for n in names:
        assert getattr(port_neo, n) == getattr(jax_neo, n), n
    assert (port_neo.CLEAN_OFFSET, port_neo.DIFF_OFFSET) == (jax_neo.CLEAN_OFFSET, jax_neo.DIFF_OFFSET)
    assert not port_neo.Neo4jBackend.supports_delta and not port_neo.Neo4jBackend.supports_synth


class _Recording:
    """A FakeNeo4jServer whose store records every statement it runs with
    its parameters, in the order the server received them."""

    def __init__(self) -> None:
        self.srv = FakeNeo4jServer()
        self.log: list[tuple[str, str]] = []
        lock = threading.Lock()
        run = self.srv.store.run

        def recorded(statement, params):
            with lock:
                self.log.append((statement, json.dumps(params, sort_keys=True)))
            return run(statement, params)

        self.srv.store.run = recorded

    def __enter__(self) -> "_Recording":
        return self

    def __exit__(self, *exc) -> None:
        self.srv.close()


@pytest.fixture(scope="module")
def corpora(corpus_dir, tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("neo4j"))
    out = {"fixture": corpus_dir}
    out.update({name: write_case_study(name, n_runs=4, seed=3, out_dir=root) for name in FAMILIES})
    return out


@pytest.mark.parametrize("name", ["fixture"] + FAMILIES)
def test_neo4j_report_and_statements_equal_jax_and_oracle(corpora, name, tmp_path):
    with _Recording() as port_srv:
        port = run_debug(corpora[name], str(tmp_path / "neo"), port_neo.Neo4jBackend(), conn=port_srv.srv.uri,
                         **CACHES_OFF)
    with _Recording() as jax_srv:
        jax = jax_run_debug(corpora[name], str(tmp_path / "jax"), jax_neo.Neo4jBackend(), conn=jax_srv.srv.uri,
                            **CACHES_OFF)
    assert port.result_cache == {"state": "off"} and port.ingest == "python"
    assert port_srv.log == jax_srv.log
    markers = {stmt.split("\n", 1)[0].removeprefix("// nemo:") for stmt, _ in port_srv.log}
    assert {"wipe", "load_goals", "load_rules", "load_edges_gr", "load_edges_rg", "mark_condition",
            "clean_kept_rules", "achieved_pre", "proto_tables", "clean_rule_tables", "count_pre_holds"} <= markers

    mine = report_tree_bytes(port.report_dir)
    assert mine == jax_tree(jax.report_dir)
    assert "repairs.json" not in mine and "debugging.json" in mine
    oracle = report_tree_bytes(run_debug(corpora[name], str(tmp_path / "py"), PythonBackend(), **CACHES_OFF)
                               .report_dir)
    compared = [k for k in oracle if k == "debugging.json" or k.endswith(".dot")]
    assert len(compared) > 1
    assert {k for k in compared if mine.get(k) != oracle[k]} == set()


def test_neo4j_count_verification_raises(corpus_dir):
    """Bulk-load count verification fires on store corruption
    (pre-post-prov.go:84-86)."""
    molly = load_molly_output(corpus_dir)
    with FakeNeo4jServer() as srv:
        backend = port_neo.Neo4jBackend()
        backend.init_graph_db(srv.uri, molly)
        srv.store.nodes["run_0_pre_intruder"] = {
            "id": "run_0_pre_intruder", "kind": "Goal", "run": 0, "condition": "pre", "label": "x", "table": "x",
            "seq": 999, "condition_holds": False,
        }
        with pytest.raises(RuntimeError, match="count mismatch"):
            backend.load_raw_provenance()
        backend.close_db()
        assert backend.conn1 is None and backend.molly is None


def test_neo4j_unreachable_server_raises(corpus_dir, tmp_path):
    """No fallback: a backend whose server does not answer fails the report."""
    with FakeNeo4jServer() as srv:
        uri = srv.uri
    with pytest.raises(OSError):
        run_debug(corpus_dir, str(tmp_path / "neo"), port_neo.Neo4jBackend(), conn=uri, **CACHES_OFF)
