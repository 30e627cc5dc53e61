"""The port's query engine (``nemo_tpu_torch/query``) against the JAX
package's (``nemo_tpu/query``), on the CPU.

* parse, AST hash, ``describe()`` and every error message equal the JAX
  package's (the parity queries of tests/test_query.py, bench.py's query,
  the README's examples, the malformed cases);
* ``bucketize`` gives the JAX package's batches;
* the port's two lanes give equal capture masks; each result document
  (``stats`` removed) equals the JAX package's ``execute_query`` document
  and the port's ``oracle_query``, on both lanes and both ingest paths,
  over the six case-study families, a synthetic corpus with a total
  replication failure and the cyclic adversarial family;
* the lane rule equals the JAX package's scheduler plan with fresh models;
* the four verbs as query programs equal the port's native verbs over
  ``TorchBackend("cpu")`` and the JAX package's ``run_verb``;
* the cache: a warm repeat runs no bucket and no K2 call, a grown store
  maps only its new segment, a changed corpus and a changed query miss,
  no store reports ``off``; the partials merge in any order.

All comparisons are exact: the values are bools, ints and strings.
"""

import json
import random
import shutil

import numpy as np
import pytest
import torch

from nemo_tpu.analysis.pipeline import _ingest as jax_ingest
from nemo_tpu.graphs.packed import CorpusVocab as JaxCorpusVocab
from nemo_tpu.graphs.packed import bucketize as jax_bucketize
from nemo_tpu.graphs.packed import pack_graph as jax_pack_graph
from nemo_tpu.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu.models.synth import SynthSpec, adversarial_spec, grow_corpus_dir, write_corpus
from nemo_tpu.parallel.sched import HeterogeneousScheduler, Job, default_models
from nemo_tpu.query.engine import execute_query as jax_execute_query
from nemo_tpu.query.lang import QueryError as JaxQueryError
from nemo_tpu.query.lang import parse_query as jax_parse_query
from nemo_tpu.query.plan import plan_query as jax_plan_query
from nemo_tpu.query.verbs import run_verb as jax_run_verb
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.graphs.packed import CorpusVocab, bucketize, pack_graph
from nemo_tpu_torch.ingest.adapters import load_output
from nemo_tpu_torch.ops import sparse_device
from nemo_tpu_torch.query import QueryError, engine, parse_query, plan_query
from nemo_tpu_torch.query.engine import (
    QUERY_HOST_WORK,
    QueryPartial,
    corpus_vocab,
    execute_query,
    finalize,
    ingest_corpus,
    merge_query_partials,
    oracle_query,
    query_lane,
    run_query_text,
)
from nemo_tpu_torch.query.verbs import VERB_QUERIES, native_verb_result, run_verb

#: tests/test_query.py's parity queries: every aggregation, both graphs,
#: both hop kinds, a run filter, a negated type.
PARITY_QUERIES = [
    "from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> "
    "@rule[type=async] match @goal -> rule -> goal count by table",
    "from post match @goal[holds=true] tables",
    "from post match @rule -> goal[holds=false] runs",
    "from pre match rule[type=async] -> @goal -*-> rule count",
    "from pre where run.failed match @goal -*-> rule[type!=next] count by table",
]
#: bench.py's query tier (its three patterns, one -*->).
BENCH_QUERY = (
    "from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> @rule[type=async] "
    "match @goal -> rule -> goal count by table"
)
#: README.md's examples of the language.
README_QUERIES = [
    "from pre match goal[holds=true] -> @rule[type=async] count by table",
    "from post where run.failed match rule -*-> @goal[holds=false] runs",
    "from pre match goal[holds=true] -> @rule match @goal -> rule -> goal count by table",
    'match node[table!=log] -> goal[table="two words"] -*-> @rule tables',
    "from post match goal[holds=true] -> @rule[type=async] -> goal[holds=false] -> rule "
    "match goal[holds=false] -> @rule[type=async] where run.failed tables",
]
#: tests/test_query.py's malformed queries, and a tokenizer failure.
MALFORMED = [
    "select goal",
    "from neither match goal",
    "match wat",
    "match goal[frobs=1]",
    "match goal[holds=maybe]",
    "match rule[holds=true]",
    "match goal[type=async]",
    "match rule[type=weird]",
    "match goal where run.sometimes",
    "match goal count tables",
    "match @goal -> @rule",
    "match goal count by label",
    "match goal where failed",
    "match goal ->",
    "count",
    "match goal[table=@x]",
    'match goal[table="x]',
]

N_RUNS = 16
CORPORA = sorted(CASE_STUDIES) + ["synth", "cycles"]


def _strip(doc: dict) -> str:
    return json.dumps({k: v for k, v in doc.items() if k != "stats"}, sort_keys=True)


def _stages(lane: str | None) -> set:
    """The stages a query times (``stats["timings"]``): the plan alone on a
    whole-result cache hit (``lane`` None), else every stage, with the
    evaluation of the lane its buckets ran on."""
    if lane is None:
        return {"query.plan"}
    return {"query.plan", "query.prep", f"query.eval_{lane}", "query.extract"}


def _stats(doc: dict) -> tuple[dict, set]:
    """A document's stats: its cache bookkeeping, and the stages it timed."""
    stats = dict(doc["stats"])
    timings = stats.pop("timings")
    assert all(isinstance(v, float) and v >= 0 for v in timings.values()), timings
    return stats, set(timings)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("query_corpora"))
    out = {name: write_case_study(name, n_runs=N_RUNS, seed=11, out_dir=root) for name in sorted(CASE_STUDIES)}
    # Seed 2 at eot 6 has a total replication failure (no post graph).
    out["synth"] = write_corpus(SynthSpec(n_runs=24, seed=2, eot=6), root)
    out["cycles"] = write_corpus(adversarial_spec("cycles", n_runs=N_RUNS, seed=13), root)
    return out


def _port_molly(d: str, packed: bool):
    return ingest_corpus(d, "off") if packed else load_output(d)


# ---------------------------------------------------------------------------
# language and plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", PARITY_QUERIES + [BENCH_QUERY] + README_QUERIES)
def test_parse_hash_and_plan_match_jax(text):
    mine, theirs = parse_query(text), jax_parse_query(text)
    assert mine.to_json() == theirs.to_json()
    assert mine.ast_hash() == theirs.ast_hash()
    plan, jplan = plan_query(mine), jax_plan_query(theirs)
    assert plan.key == jplan.key == mine.ast_hash()
    assert plan.describe() == jplan.describe()
    assert (plan.needs_holds, plan.needs_time, plan.cond_tid) == (jplan.needs_holds, jplan.needs_time, jplan.cond_tid)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_query_errors_match_jax(text):
    with pytest.raises(JaxQueryError) as theirs:
        jax_parse_query(text)
    with pytest.raises(QueryError) as mine:
        parse_query(text)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "object"])
def test_unknown_name_error_matches_jax(corpora, packed):
    d = corpora["synth"]
    text = "from pre match goal[table=nope] tables"
    with pytest.raises(JaxQueryError) as theirs:
        jax_execute_query(jax_parse_query(text), jax_ingest(d, packed, None), use_cache=False)
    with pytest.raises(QueryError) as mine:
        execute_query(parse_query(text), _port_molly(d, packed), device="cpu", use_cache=False)
    assert str(mine.value) == str(theirs.value)
    assert "unknown table 'nope'" in str(mine.value)


def test_bound_plan_matches_jax(corpora):
    from nemo_tpu.query.engine import corpus_vocab as jax_corpus_vocab

    d = corpora["ZK-1270-racing-sent-flag"]
    mine, theirs = corpus_vocab(_port_molly(d, True)), jax_corpus_vocab(jax_ingest(d, True, None))
    for text in PARITY_QUERIES + ['match goal[table=pre, label!="zz"] -> @rule[type=next] tables']:
        assert plan_query(parse_query(text)).bind(mine) == jax_plan_query(jax_parse_query(text)).bind(theirs)


# ---------------------------------------------------------------------------
# buckets and lanes
# ---------------------------------------------------------------------------


def _graphs(molly, jax_side: bool, graph: str = "pre"):
    vocab = JaxCorpusVocab() if jax_side else CorpusVocab()
    pack = jax_pack_graph if jax_side else pack_graph
    rids, graphs = [], []
    for r in molly.runs:
        prov = r.pre_prov if graph == "pre" else r.post_prov
        if prov is None:
            continue
        g = pack(prov, vocab)
        if g.n_nodes:
            rids.append(r.iteration)
            graphs.append(g)
    return rids, graphs, vocab


@pytest.mark.parametrize("name", CORPORA)
def test_bucketize_matches_jax(corpora, name):
    mine = bucketize(*_graphs(load_output(corpora[name]), False)[:2])
    theirs = jax_bucketize(*_graphs(jax_ingest(corpora[name], False, None), True)[:2])
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert (a.run_ids, a.v, a.e, a.is_goal.shape[0], a.max_depth) == (b.run_ids, b.v, b.e, b.is_goal.shape[0],
                                                                         b.max_depth)
        for f in ("n_nodes", "n_goals", "is_goal", "node_mask", "table_id", "label_id", "type_id", "edge_src",
                  "edge_dst", "edge_mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", CORPORA)
def test_lanes_give_equal_capture_masks(corpora, name):
    molly = load_output(corpora[name])
    for text in PARITY_QUERIES:
        plan = plan_query(parse_query(text))
        rids, graphs, vocab = _graphs(molly, False, plan.graph)
        bound = plan.bind(vocab)
        for batch in bucketize(rids, graphs):
            tp = engine._time_plane(batch)
            host = engine._eval_host(batch, tp, bound, len(vocab.tables))
            dev = engine._eval_device(batch, tp, bound, len(vocab.tables), torch.device("cpu"))
            assert host.dtype == dev.dtype == bool
            np.testing.assert_array_equal(host, dev, err_msg=text)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "object"])
@pytest.mark.parametrize("name", CORPORA)
def test_documents_match_jax_and_oracle(corpora, name, packed):
    d = corpora[name]
    molly, jmolly = _port_molly(d, packed), jax_ingest(d, packed, None)
    for text in PARITY_QUERIES:
        q = parse_query(text)
        dev_routes, host_routes = [], []
        on_dev = execute_query(q, molly, device="cpu", use_cache=False, query_host_work=0, routes=dev_routes)
        on_host = execute_query(q, molly, device="cpu", use_cache=False, query_host_work=10**15,
                                routes=host_routes)
        assert dev_routes and {r["lane"] for r in dev_routes} == {"sparse_device"}
        assert {r["lane"] for r in host_routes} == {"host"}
        assert _stats(on_dev) == ({"cache": "off", "segments_mapped": 1}, _stages("device"))
        assert _stats(on_host) == ({"cache": "off", "segments_mapped": 1}, _stages("host"))
        want = _strip(jax_execute_query(jax_parse_query(text), jmolly, use_cache=False))
        assert _strip(on_dev) == _strip(on_host) == want, text
        assert _strip(oracle_query(q, molly)) == want, text


def test_empty_graphs_take_the_empty_value(corpora):
    """The synthetic corpus's total replication failure has no post graph:
    its run is in every document with the empty value, on both paths."""
    d = corpora["synth"]
    empty = [r.iteration for r in load_output(d).runs if r.post_prov is None or not r.post_prov.goals]
    assert empty
    for text, value in (("from post match @goal tables", []), ("from post match @goal count", 0)):
        for packed in (True, False):
            doc = execute_query(parse_query(text), _port_molly(d, packed), device="cpu", use_cache=False)
            assert all(doc["runs"][str(i)] == value for i in empty)


def _jax_plan_lane(rows: int, v: int, e: int, work: int) -> str:
    job = Job(index=0, verb="query", rows=rows, v=v, e=e, work=work, execute=lambda *a: {},
              lanes=("sparse_device", "host"), source="query")
    return HeterogeneousScheduler(models=default_models()).plan(job)[0]


def test_lane_rule_matches_the_jax_scheduler(corpora):
    cases = {(1, 16, 16, 126_666), (1, 16, 16, 126_667), (1, 16, 16, 0), (1, 16, 16, 10**9)}
    for name in sorted(CASE_STUDIES):
        rids, graphs, _ = _graphs(load_output(corpora[name]), False)
        for b in bucketize(rids, graphs):
            rows = len(b.run_ids)
            cases.add((rows, b.v, b.e, rows * (b.v + b.e)))
            cases.add((1700, b.v, b.e, 1700 * (b.v + b.e)))  # the bucket at the smoke's 1,700 runs
    assert QUERY_HOST_WORK == 126_667
    assert query_lane(126_666) == "host" and query_lane(126_667) == "sparse_device"
    for rows, v, e, work in sorted(cases):
        assert query_lane(work) == _jax_plan_lane(rows, v, e, work), (rows, v, e, work)
    assert query_lane(0, 0) == "sparse_device" and query_lane(10**12, 10**15) == "host"


# ---------------------------------------------------------------------------
# the verbs as query programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verb", sorted(VERB_QUERIES))
def test_verbs_match_native_and_jax(corpora, verb):
    for name in sorted(CASE_STUDIES) + ["synth"]:
        d = corpora[name]
        molly = _port_molly(d, True)
        backend = TorchBackend(device="cpu")
        backend.init_graph_db("", molly)
        native = native_verb_result(verb, backend)
        for host_work in (0, QUERY_HOST_WORK):
            doc = run_verb(verb, molly, device="cpu", use_cache=False, query_host_work=host_work)
            assert json.dumps(doc["runs"], sort_keys=True) == json.dumps(native, sort_keys=True), (name, verb)
        theirs = jax_run_verb(verb, jax_ingest(d, True, None), use_cache=False)
        assert _strip(doc) == _strip(theirs), (name, verb)


def test_verb_queries_equal_jax_programs():
    from nemo_tpu.query.verbs import VERB_QUERIES as JAX_VERBS

    assert sorted(VERB_QUERIES) == sorted(JAX_VERBS)
    for name, q in VERB_QUERIES.items():
        assert q.ast_hash() == JAX_VERBS[name].ast_hash()


# ---------------------------------------------------------------------------
# reduce and cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    ("agg", "values"),
    [
        ("tables", [["a", "c"], ["b"], [], ["a"]]),
        ("count", [3, 0, 7, 1]),
        ("runs", [True, False, True, False]),
        ("count_by_table", [{"a": 2}, {}, {"a": 1, "b": 3}, {"b": 1}]),
    ],
)
def test_merge_is_permutation_invariant(agg, values):
    text = {"tables": "match goal tables", "count": "match goal count", "runs": "match goal runs",
            "count_by_table": "match goal count by table"}[agg]
    plan = plan_query(parse_query(text))
    parts = [QueryPartial(per_run={i: v}, n_runs=1) for i, v in enumerate(values)]
    want = finalize(plan, merge_query_partials(parts))
    for seed in range(5):
        shuffled = list(parts)
        random.Random(seed).shuffle(shuffled)
        assert finalize(plan, merge_query_partials(shuffled)) == want
    assert QueryPartial.from_json(json.loads(json.dumps(parts[0].to_json()))) == parts[0]


@pytest.fixture
def k2_calls(monkeypatch):
    """Calls of K2's wrapper from the sparse tier (ops.sparse_device.edge_wave)."""
    calls = []
    wave = sparse_device.edge_wave

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return wave(*args, **kw)

    monkeypatch.setattr(sparse_device, "edge_wave", counted)
    return calls


def test_cache_warm_grown_changed_and_off(tmp_path, k2_calls):
    full = write_corpus(SynthSpec(n_runs=24, seed=2, eot=6), str(tmp_path / "full"))
    d = str(tmp_path / "sweep" / "pb_synth")
    grow_corpus_dir(full, d, 18)
    cc, rc = str(tmp_path / "cc"), str(tmp_path / "rc")
    text = BENCH_QUERY
    kw = dict(device="cpu", result_cache=rc, query_host_work=0)

    routes = []
    cold = run_query_text(text, ingest_corpus(d, cc), routes=routes, **kw)
    assert _stats(cold) == ({"cache": "miss", "segments_mapped": 1}, _stages("device"))
    # One -*-> hop, into the capture step: the forward reach only (the
    # backward pass stops at the capture step).
    assert routes and len(k2_calls) == len(routes)

    del k2_calls[:]
    routes = []
    warm = run_query_text(text, ingest_corpus(d, cc), routes=routes, **kw)
    assert _stats(warm) == ({"cache": "hit", "segments_mapped": 0}, _stages(None))
    assert routes == [] and k2_calls == []
    assert _strip(warm) == _strip(cold)

    other = run_query_text("from pre match @goal[holds=true] count", ingest_corpus(d, cc), **kw)
    assert other["stats"]["cache"] == "miss" and _strip(other) != _strip(cold)

    # Grown: the first segment's partial hits, only the new segment maps.
    grow_corpus_dir(full, d, 24)
    molly = ingest_corpus(d, cc)
    assert len(molly.store_segments) == 2
    routes = []
    grown = run_query_text(text, molly, routes=routes, **kw)
    assert _stats(grown) == ({"cache": "miss", "segments_mapped": 1}, _stages("device"))
    assert sum(r["rows"] for r in routes) <= 6
    scratch = run_query_text(text, ingest_corpus(full, "off"), device="cpu", use_cache=False)
    assert _strip(grown) == _strip(scratch)

    # Changed: the same directory rewritten with other runs is a miss.
    shutil.rmtree(d)
    changed_src = write_corpus(SynthSpec(n_runs=24, seed=3, eot=6), str(tmp_path / "other"))
    shutil.copytree(changed_src, d)
    changed = run_query_text(text, ingest_corpus(d, cc), **kw)
    assert _stats(changed) == ({"cache": "miss", "segments_mapped": 1}, _stages("device"))
    assert _strip(changed) == _strip(run_query_text(text, ingest_corpus(changed_src, "off"), device="cpu"))

    # No store: no fingerprints, so the cache is off.
    off = run_query_text(text, ingest_corpus(d, "off"), **kw)
    assert _stats(off) == ({"cache": "off", "segments_mapped": 1}, _stages("device"))
    assert oracle_query(parse_query(text), ingest_corpus(d, "off"))["stats"]["cache"] == "oracle"


def test_cache_keys_are_the_ports_own(tmp_path):
    from nemo_tpu.analysis.delta import blob_cache_key as jax_key

    from nemo_tpu_torch.analysis.delta import blob_cache_key

    meta = [{"fingerprint": "a"}, {"fingerprint": "b"}]
    assert blob_cache_key("query", meta, {"plan": "p"}) != jax_key("query", meta, {"plan": "p"})
    assert blob_cache_key("query", meta, {"plan": "p"}) == blob_cache_key("query", list(meta), {"plan": "p"})
    assert blob_cache_key("query", meta, {"plan": "q"}) != blob_cache_key("query", meta, {"plan": "p"})
    assert blob_cache_key("query", [{"fingerprint": None}], {}) is None
    assert blob_cache_key("query", None, {}) is None


def test_blob_entries_round_trip_and_fail_their_manifest(tmp_path):
    from nemo_tpu_torch.store.rcache import ResultCache

    rc = ResultCache(str(tmp_path / "rc"))
    assert rc.load_blob("query", "k") is None
    assert rc.put_blob("query", "k", b"payload")
    assert rc.load_blob("query", "k") == b"payload"
    assert rc.load_blob("query-partial", "k") is None
    # A payload written in place fails its identity manifest: a miss, and
    # the entry is removed.
    with open(tmp_path / "rc" / "blob_query" / "k" / "payload.bin", "wb") as fh:
        fh.write(b"tampered, longer")
    assert rc.load_blob("query", "k") is None
    assert not (tmp_path / "rc" / "blob_query" / "k").exists()


def test_query_on_cuda_raises_without_a_card(corpora, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        execute_query(parse_query("match goal count"), load_output(corpora["synth"]), use_cache=False)
