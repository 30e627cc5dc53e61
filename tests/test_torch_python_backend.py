"""The port's Python oracle backend (nemo_tpu_torch/backend/python_ref.py)
against the JAX package's, and against the port's TorchBackend, on the CPU.

* every verb of the port's PythonBackend equals the JAX PythonBackend's on
  the ``corpus_dir`` fixture (the cases of tests/test_python_backend.py):
  condition marking, the clean copy and the @next contraction on
  micro-graphs and on the corpus, prototypes, the pulled DOTs, the diff and
  its missing frontier, corrections, extensions, the per-run hooks, the
  hazard figures;
* report trees with caches off: the port's PythonBackend tree equals the
  JAX PythonBackend's byte for byte, and the port's TorchBackend("cpu")
  tree as the oracle tree (analysis/pipeline.py:oracle_tree_diff), on the four
  ``THREE_WAY_FAMILIES`` at ``n_runs=4, seed=6``, the five ``SWEEP`` specs
  of tests/test_backend_differential.py and two dedalus corpora;
* the obs counters of an oracle report equal the JAX package's, series for
  series (the manner of tests/test_torch_obs_parity.py);
* past 1,000 runs, where the JAX package's oracle overwrites a run's graphs
  with a shadow run's of the same key (one dict for raw, simplified at
  1000+i and diff graphs at 2000+i), the port's oracle, which keeps one
  dict a kind, still equals TorchBackend.

The oracle tree: debugging.json, repairs.json and every figure byte-equal
but the simplified graphs' ``*_prov_clean.dot``, which hold the same DOT
statements in another order (the JAX package's oracle and JaxBackend
differ alike), and their ``.svg``, laid out from that order.
"""

from __future__ import annotations

import dataclasses

import pytest

from nemo_tpu import obs as jax_obs
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend import python_ref as jax_ref
from nemo_tpu.dedalus.faults import write_molly_output
from nemo_tpu.dedalus.parser import load_program
from nemo_tpu.dedalus.registry import BUNDLED_SPECS, bundled_spec_path
from nemo_tpu.graphs import pgraph as jax_pgraph
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis.pipeline import oracle_tree_diff, report_tree_bytes, run_debug
from nemo_tpu_torch.backend import python_ref as port_ref
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.graphs import pgraph as port_pgraph
from nemo_tpu_torch.ingest.molly import load_molly_output
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

#: tests/test_backend_differential.py's families and sweep.
THREE_WAY_FAMILIES = ["pb_asynchronous", "CA-2434-bootstrap-synchronization", "MR-2995-failed-after-expiry",
                      "MR-3858-hadoop"]
SWEEP = [
    SynthSpec(n_runs=5, seed=101, eot=4, eff=2),
    SynthSpec(n_runs=9, seed=202, eot=8, eff=5, fail_fraction=0.6),
    SynthSpec(n_runs=7, seed=303, eot=6, eff=3, vacuous_fraction=0.5),
    SynthSpec(n_runs=6, seed=404, eot=7, eff=4, fail_all_fraction=0.5),
    SynthSpec(n_runs=12, seed=505, eot=5, eff=3),
]
DEDALUS = ["pb_asynchronous", "mr_3858_hadoop"]


# ------------------------------------------------------------------- verbs


@pytest.fixture(scope="module")
def pair(corpus_dir):
    """The port's and the JAX package's oracle, each loaded and simplified
    over the fixture corpus."""
    out = []
    for mod, load in ((port_ref, load_molly_output), (jax_ref, jax_load)):
        molly = load(corpus_dir)
        b = mod.PythonBackend()
        b.init_graph_db("", molly)
        b.load_raw_provenance()
        b.simplify_prov(molly.runs_iters)
        out.append(b)
    return out


def _graph(g) -> tuple:
    return [dataclasses.asdict(n) for n in g.nodes.values()], list(g.edge_order), dict(g.out), dict(g.inn)


def _dots(dots) -> list[str]:
    return [d.to_string() for d in dots]


def test_offsets_and_flags_equal_jax():
    assert (port_ref.CLEAN_OFFSET, port_ref.DIFF_OFFSET) == (jax_ref.CLEAN_OFFSET, jax_ref.DIFF_OFFSET) == (1000, 2000)
    for flag in ("supports_delta", "supports_synth"):
        assert getattr(port_ref.PythonBackend, flag) is getattr(jax_ref.PythonBackend, flag) is True
    assert not getattr(port_ref.PythonBackend, "supports_packed_ingest", False)


def test_graphs_equal_after_load_and_simplify(pair):
    """The raw and simplified graphs (one dict in the JAX package's oracle,
    two in the port's) in the same order."""
    port, jax = pair
    mine = {**port.graphs, **port.clean}
    assert list(mine) == list(jax.graphs)
    for key in mine:
        assert _graph(mine[key]) == _graph(jax.graphs[key]), key
    assert any(n.type == "collapsed" for g in port.clean.values() for n in g.rules())


def _micro(mod):
    """tests/test_python_backend.py's micro-graphs in one package."""
    g = mod.PGraph()
    for nid, goal, label, table in [("g_top", True, "x(1)", "x"), ("r_top", False, "pre", "pre"),
                                    ("g_pre", True, "pre(1)", "pre"), ("r_mid", False, "pre", "pre"),
                                    ("g_y", True, "y(1)", "y")]:
        g.add_node(mod.PNode(id=nid, is_goal=goal, label=label, table=table))
    for s, d in [("g_top", "r_top"), ("r_top", "g_pre"), ("g_pre", "r_mid"), ("r_mid", "g_y")]:
        g.add_edge(s, d)
    c = mod.PGraph()
    for nid, goal in [("run_0_pre_goal_a", True), ("run_0_pre_rule_ok", False), ("run_0_pre_goal_b", True),
                      ("run_0_pre_rule_deadend", False), ("run_0_pre_rule_orphanhead", False),
                      ("run_0_pre_goal_c", True)]:
        c.add_node(mod.PNode(id=nid, is_goal=goal, label=nid[-1], table=nid[-1]))
    for s, d in [("run_0_pre_goal_a", "run_0_pre_rule_ok"), ("run_0_pre_rule_ok", "run_0_pre_goal_b"),
                 ("run_0_pre_goal_b", "run_0_pre_rule_deadend"),
                 ("run_0_pre_rule_orphanhead", "run_0_pre_goal_c")]:
        c.add_edge(s, d)
    return g, c


@pytest.mark.parametrize("case", ["mark_condition", "clean_copy", "kept_rule_ids", "collapse", "queries"])
def test_micro_graph_verbs_equal_jax(case):
    out = []
    for mod, ref in ((port_pgraph, port_ref), (jax_pgraph, jax_ref)):
        g, c = _micro(mod)
        if case == "mark_condition":
            ref.PythonBackend._mark_condition_holds(g, "pre")
            out.append(_graph(g))
        elif case == "clean_copy":
            out.append(_graph(ref.PythonBackend._clean_copy(c, 0, "pre")))
        elif case == "kept_rule_ids":
            out.append(_graph(ref.PythonBackend._clean_copy(c, 0, "pre", kept_rule_ids={"run_0_pre_rule_deadend"})))
        elif case == "collapse":
            chain = mod.PGraph()
            ids = ["g0", "n1", "g1", "n2", "g2", "n3", "g3"]
            for nid in ids:
                goal = nid.startswith("g")
                chain.add_node(mod.PNode(id=nid, is_goal=goal, label=nid, table="t",
                                         type="" if goal else "next"))
            for s, d in zip(ids, ids[1:]):
                chain.add_edge(s, d)
            ref.PythonBackend._collapse_next_chains(chain, 4, "post")
            out.append(_graph(chain))
        else:
            out.append((sorted(g.descendants("g_top")), sorted(g.reachable_from(["g_pre"])),
                        sorted(g.coreachable_to(["g_pre"])), [n.id for n in g.roots()],
                        [n.id for n in g.goals()], [n.id for n in g.rules()], _graph(g.copy())))
            g.remove_node("r_mid")
            out[-1] += (_graph(g),)
    assert out[0] == out[1]


@pytest.mark.parametrize("verb", ["create_prototypes", "proto_tables_by_run", "pull_pre_post_prov",
                                  "create_naive_diff_prov", "generate_corrections", "generate_extensions",
                                  "achieved_pre_goal_counts", "extension_suggestions", "synth_candidates",
                                  "create_hazard_analysis"])
def test_verb_equals_jax(pair, corpus_dir, verb):
    port, jax = pair
    succ, failed = port.molly.success_runs_iters, port.molly.failed_runs_iters
    outs = []
    for b in (port, jax):
        if verb == "create_prototypes":
            out = b.create_prototypes(succ, failed)
        elif verb == "proto_tables_by_run":
            ordered, present = b.proto_tables_by_run(succ, failed)
            out = (ordered, {f: sorted(v) for f, v in present.items()})
        elif verb == "pull_pre_post_prov":
            out = [_dots(d) for d in b.pull_pre_post_prov()]
        elif verb == "create_naive_diff_prov":
            post0 = b.pull_pre_post_prov([b.good_run_iter()])[1][0]
            diff, fail, missing = b.create_naive_diff_prov(False, failed, post0, dot_iters=failed[:1])
            out = (_dots(diff), _dots(fail), [[m.to_json() for m in ms] for ms in missing],
                   [_graph(getattr(b, "diffs", b.graphs)[(2000 + f, "post")]) for f in failed])
        elif verb == "create_hazard_analysis":
            out = _dots(b.create_hazard_analysis(corpus_dir))
        elif verb == "synth_candidates":
            out = b.synth_candidates(b.molly.runs_iters)
        else:
            out = getattr(b, verb)()
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0] not in ([], {}, None)


# ----------------------------------------------------------------- reports


@pytest.fixture(scope="module")
def corpora(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("oracle"))
    out = {name: write_case_study(name, n_runs=4, seed=6, out_dir=root) for name in THREE_WAY_FAMILIES}
    for spec in SWEEP:
        out[f"seed{spec.seed}"] = write_corpus(spec, f"{root}/seed{spec.seed}")
    for name in DEDALUS:
        out[name + "_ded"] = write_molly_output(load_program(bundled_spec_path(name)), BUNDLED_SPECS[name],
                                                f"{root}/ded", name)
    return out


def _oracle_reports(corpus: str, tmp_path) -> tuple:
    port = run_debug(corpus, str(tmp_path / "py"), port_ref.PythonBackend(), corpus_cache="off", result_cache="off")
    jax = jax_run_debug(corpus, str(tmp_path / "jax"), jax_ref.PythonBackend(), corpus_cache="off",
                        result_cache="off")
    assert port.result_cache == {"state": "off"} and port.ingest == "python"
    return port, jax


@pytest.mark.parametrize("name", THREE_WAY_FAMILIES + [f"seed{s.seed}" for s in SWEEP]
                         + [d + "_ded" for d in DEDALUS])
def test_oracle_report_equals_jax_and_torch(corpora, name, tmp_path):
    port, jax = _oracle_reports(corpora[name], tmp_path)
    torch_res = run_debug(corpora[name], str(tmp_path / "torch"), TorchBackend(device="cpu"), corpus_cache="off",
                          result_cache="off")
    mine = report_tree_bytes(port.report_dir)
    assert "debugging.json" in mine and "repairs.json" in mine
    assert any(k.endswith("_prov_clean.dot") for k in mine)
    assert mine == jax_tree(jax.report_dir)
    assert oracle_tree_diff(mine, report_tree_bytes(torch_res.report_dir)) == []


def test_oracle_tree_diff_sees_a_changed_statement(corpora, tmp_path):
    port, _ = _oracle_reports(corpora["pb_asynchronous"], tmp_path)
    tree = report_tree_bytes(port.report_dir)
    clean = next(k for k in sorted(tree) if k.endswith("_prov_clean.dot"))
    changed = dict(tree, **{clean: tree[clean].replace(b"black", b"white", 1)})
    assert oracle_tree_diff(tree, changed) == [clean]
    assert oracle_tree_diff(tree, {k: v for k, v in tree.items() if k != "repairs.json"}) == ["repairs.json"]


def _delta(obs_mod, fn):
    before = obs_mod.metrics.snapshot()
    out = fn()
    return out, obs_mod.Metrics.delta(obs_mod.metrics.snapshot(), before)


def _view(delta: dict) -> dict:
    """Every counter and every histogram's count, the one wall among the
    counters (render.render_s) left out."""
    out = {k: v for k, v in delta["counters"].items() if k != "render.render_s"}
    out.update({f"{k}#count": h["count"] for k, h in delta["histograms"].items()})
    return out


@pytest.mark.parametrize("name", ["MR-3858-hadoop", "pb_asynchronous_ded"])
def test_oracle_counters_equal_jax(corpora, name, tmp_path):
    """Each package records into its own registry: the port's delta around
    its oracle report against the JAX package's around its own."""
    kw = dict(corpus_cache="off", result_cache="off")
    _, mine = _delta(obs, lambda: run_debug(corpora[name], str(tmp_path / "py"), port_ref.PythonBackend(), **kw))
    _, theirs = _delta(jax_obs, lambda: jax_run_debug(corpora[name], str(tmp_path / "jax"), jax_ref.PythonBackend(),
                                                      **kw))
    a, b = _view(mine), _view(theirs)
    assert {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)} == {}
    assert mine["counters"]["render.figures"] > 0 and mine["counters"]["delta.runs_mapped"] > 0
    assert not any(k.startswith("kernel.dispatches.") for k in mine["counters"])


def test_oracle_past_1000_runs_equals_torch(tmp_path):
    """Run 1000 and up: the JAX package's oracle reports wrong missing
    events and prototypes there (its debugging.json departs from
    TorchBackend's), the port's equals TorchBackend's."""
    corpus = write_corpus(SynthSpec(n_runs=1012, seed=3, eot=4), str(tmp_path))
    kw = dict(figures="none", corpus_cache="off", result_cache="off")
    mine = report_tree_bytes(run_debug(corpus, str(tmp_path / "py"), port_ref.PythonBackend(), **kw).report_dir)
    card = report_tree_bytes(run_debug(corpus, str(tmp_path / "torch"), TorchBackend(device="cpu"), **kw).report_dir)
    jax = jax_tree(jax_run_debug(corpus, str(tmp_path / "jax"), jax_ref.PythonBackend(), **kw).report_dir)
    assert oracle_tree_diff(mine, card) == []
    assert "debugging.json" in oracle_tree_diff(jax, card)
