"""The port under its threaded drain (``NEMO_SCHED=on``) against the JAX
package, end to end on the CPU.

The port's reports, route records and query documents with every job list
drained by the cost-model scheduler (parallel/sched.py: one worker thread
per lane, work stealing), against the JAX package's serial drain
(``NEMO_SCHED=off``, its device-backend routes ``crossover``):

* every report tree byte-equal, on the six families, a synthetic corpus
  and a corpus of several buckets, on the default routes, the device lanes
  (every host budget 0) and the dense lane forced;
* the route records equal as multisets of (verb, rows, v, e, work), each
  record's route one of its job's lanes and a pinned job's route and
  reason the JAX package's; every forced route's records equal exactly;
* bench.py's query documents through the port's scheduler equal the JAX
  engine's (its scheduler, threaded), each bucket on one of its two lanes.
"""

import collections
import os

import pytest
import torch

from nemo_tpu.analysis.pipeline import _ingest as jax_ingest
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.synth import synth_impl_env
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.query.engine import run_query_text as jax_run_query_text
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
from nemo_tpu_torch.parallel import sched
from nemo_tpu_torch.query.engine import ingest_corpus, run_query_text

RUNS = 12
CORPORA = sorted(CASE_STUDIES) + ["synth", "mix"]

#: The port's lanes -> (TorchBackend knobs, the JAX package's env for the
#: same routes).
LANES = {
    "default": ({}, {}),
    "device_lanes": ({"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0},
                     {"NEMO_ANALYSIS_HOST_WORK": "0", "NEMO_DIFF_HOST_WORK": "0", "NEMO_SYNTH_HOST_WORK": "0"}),
    "dense": ({"analysis_impl": "dense"}, {"NEMO_ANALYSIS_IMPL": "dense", "NEMO_SYNTH_IMPL": "sparse_device"}),
}

#: A forced port route -> the JAX package's knobs for the same lanes
#: (tests/test_torch_routes.py).
FORCED = {
    "dense": {"NEMO_ANALYSIS_IMPL": "dense", "NEMO_GIANT_IMPL": "sparse_device", "NEMO_SYNTH_IMPL": "sparse_device"},
    "sparse": {"NEMO_ANALYSIS_IMPL": "sparse", "NEMO_GIANT_IMPL": "auto", "NEMO_SYNTH_IMPL": "sparse"},
    "sparse_device": {"NEMO_ANALYSIS_IMPL": "sparse_device", "NEMO_GIANT_IMPL": "auto",
                      "NEMO_SYNTH_IMPL": "sparse_device"},
}

BENCH_QUERY = (
    "from pre "
    "match goal[holds=true] -> @rule "
    "match goal[holds=false] -*-> @rule[type=async] "
    "match @goal -> rule -> goal "
    "count by table"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def threaded(monkeypatch):
    """The port threaded on fresh cpu models; the JAX side's device-backend
    routes, seeded budgets, synth routed per bucket."""
    for name, value in (("NEMO_SCHED", "on"), ("NEMO_FAILOVER_BACKOFF_S", "0"), ("NEMO_ANALYSIS_IMPL", "crossover"),
                        ("NEMO_GIANT_IMPL", "sparse_device"), ("NEMO_PROFILE", "off")):
        monkeypatch.setenv(name, value)
    for name in ("NEMO_ANALYSIS_HOST_WORK", "NEMO_DIFF_HOST_WORK", "NEMO_SYNTH_HOST_WORK", "NEMO_SYNTH_IMPL",
                 "NEMO_SPARSE_DEVICE_MEM_MB", "NEMO_GIANT_V", "NEMO_DISPATCH_TIMEOUT_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(JaxBackend, "_resolve_synth_impl", lambda self: synth_impl_env())
    sched.reset_session_models("cpu")
    sched.reset_device_breaker("cpu")
    yield
    sched.reset_session_models("cpu")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory) -> dict:
    root = str(tmp_path_factory.mktemp("sched_e2e"))
    out = {name: write_case_study(name, RUNS, 0, root) for name in sorted(CASE_STUDIES)}
    out["synth"] = write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), root)
    out["mix"] = write_corpus(SynthSpec(n_runs=60, seed=6, eot=20, name="mix"), root)
    return out


def _jax_serial(monkeypatch, fn):
    """``fn()`` with the JAX package's serial drain."""
    with monkeypatch.context() as m:
        m.setenv("NEMO_SCHED", "off")
        return fn()


def _jax_report(corpus: str, out: str, monkeypatch) -> tuple[dict, list]:
    backend = JaxBackend()
    res = _jax_serial(monkeypatch, lambda: jax_run_debug(
        corpus, out, backend, reporter=JaxReporter(), figures="failed", ingest="python", corpus_cache="off",
        result_cache="off"))
    return jax_tree(res.report_dir), list(backend.analysis_routes)


def _allowed_routes(rec: dict) -> set[str]:
    """The routes a scheduled job of the JAX record ``rec`` may run on (on
    the CPU a bucket's lanes are device and host, and sparse_device where
    its route is sparse_device; a pinned job keeps its route)."""
    if rec["verb"] == "diff" or rec["reason"] in ("forced", "mem", "giant_impl"):
        return {rec["route"]}
    if rec["verb"] == "synth":
        return {"sparse_device", "sparse"}
    return {"dense", "sparse"} | ({"sparse_device"} if rec["route"] == "sparse_device" else set())


def _assert_routes_as_multisets(port: list, jax: list) -> None:
    def key(r):
        return (r["verb"], r["rows"], r["v"], r["e"], r["work"])

    assert collections.Counter(map(key, port)) == collections.Counter(map(key, jax))
    by_key: dict = collections.defaultdict(list)
    for r in jax:
        by_key[key(r)].append(r)
    for r in port:
        want = by_key[key(r)][0]
        assert r["route"] in _allowed_routes(want), (r, want)
        if len(_allowed_routes(want)) == 1:
            assert r["reason"] == want["reason"], (r, want)
        else:
            assert r["reason"] in ("sched", "steal"), r


@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("name", CORPORA)
def test_threaded_report_matches_jax(corpora, name, lanes, tmp_path, monkeypatch):
    port_kw, jax_env = LANES[lanes]
    for k, v in jax_env.items():
        monkeypatch.setenv(k, v)
    want, jax_routes = _jax_report(corpora[name], str(tmp_path / "jax"), monkeypatch)
    backend = TorchBackend(device="cpu", **port_kw)
    res = run_debug(corpora[name], str(tmp_path / "port"), backend, figures="failed")
    got = report_tree_bytes(res.report_dir)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    if lanes == "dense":
        _assert_forced_equal(backend.analysis_routes, jax_routes)
    else:
        _assert_routes_as_multisets(backend.analysis_routes, jax_routes)
    records = sched.sched_snapshot("cpu")
    assert records and not any(r["failed_over"] for r in records)


def test_mix_corpus_schedules_several_jobs_on_both_lanes(corpora, tmp_path):
    """The corpus of several buckets puts jobs on both lanes (a bucket on
    each side of the crossover), threaded."""
    backend = TorchBackend(device="cpu", analysis_host_work=5000)
    run_debug(corpora["mix"], str(tmp_path / "port"), backend, figures="none")
    fused = [r for r in sched.sched_snapshot("cpu") if r["verb"] == "fused"]
    assert len(fused) >= 3 and {r["lane"] for r in fused} == {"device", "host"}


def _sorted_records(routes: list) -> list:
    return sorted((r["verb"], r["route"], r["rows"], r["v"], r["e"], r["work"], r["reason"]) for r in routes)


def _assert_forced_equal(port: list, jax: list) -> None:
    assert _sorted_records(port) == _sorted_records(jax)


@pytest.mark.parametrize("impl", sorted(FORCED))
@pytest.mark.parametrize("corpus", ["mix", "deep"])
def test_forced_routes_exact_under_the_scheduler(corpora, tmp_path_factory, monkeypatch, impl, corpus):
    """The counterpart of tests/test_shard.py's forced-route test: a forced
    route survives the threaded drain, every record's route and reason the
    JAX package's serial ones."""
    from nemo_tpu.ingest.molly import load_molly_output as jax_load
    from nemo_tpu_torch.ingest.molly import load_molly_output as port_load

    if corpus == "deep":
        corpora = dict(corpora, deep=write_corpus(SynthSpec(n_runs=6, seed=5, eot=30, name="deep"),
                                                  str(tmp_path_factory.mktemp("deep"))))
    for name, value in FORCED[impl].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("NEMO_GIANT_V", "64")

    def drive(backend, molly):
        backend.init_graph_db("", molly)
        backend.load_raw_provenance()
        failed = molly.get_failed_runs_iters()
        if failed and molly.get_success_runs_iters():
            backend.create_naive_diff_prov(False, failed, None, dot_iters=[])
        backend.synth_candidates(molly.get_runs_iters())
        return list(backend.analysis_routes)

    port = drive(TorchBackend(device="cpu", analysis_impl=impl, giant_v=64), port_load(corpora[corpus]))
    jax = _jax_serial(monkeypatch, lambda: drive(JaxBackend(), jax_load(corpora[corpus])))
    _assert_forced_equal(port, jax)
    assert sched.sched_snapshot("cpu")
    if corpus == "deep":
        assert any(r["verb"] == "giant" for r in port)


@pytest.mark.parametrize("serial", [False, True])
def test_threaded_query_documents_match_jax(corpora, serial):
    """bench.py's query and two more over the families: the port through
    its scheduler, the JAX engine through its own (threaded); documents
    equal, each bucket on one of its lanes."""
    texts = (BENCH_QUERY, "match goal -> @rule tables", "from post match @goal[holds=false] runs")
    for name in sorted(CASE_STUDIES):
        d = corpora[name]
        molly, jmolly = ingest_corpus(d, "off"), jax_ingest(d, True, None)
        for text in texts:
            routes: list = []
            doc = run_query_text(text, molly, device="cpu", use_cache=False, routes=routes, serial=serial)
            jdoc = jax_run_query_text(text, jmolly, use_cache=False, serial=serial)
            assert {k: v for k, v in doc.items() if k != "stats"} == {k: v for k, v in jdoc.items() if k != "stats"}
            assert routes and all(r["lane"] in ("sparse_device", "host") for r in routes)
            assert all(r["reason"] in ("sched", "steal") for r in routes)


def test_query_lane_override_pins_under_the_scheduler(corpora):
    """An explicit query_host_work pins every bucket to its lane (reason
    forced) under the scheduler; the document is the same."""
    molly = ingest_corpus(corpora["ZK-1270-racing-sent-flag"], "off")
    docs = {}
    for qhw, lane in ((0, "sparse_device"), (10**18, "host")):
        routes: list = []
        docs[lane] = run_query_text(BENCH_QUERY, molly, device="cpu", use_cache=False, query_host_work=qhw,
                                    routes=routes)
        assert routes and all((r["lane"], r["reason"]) == (lane, "forced") for r in routes)
    assert {k: v for k, v in docs["host"].items() if k != "stats"} == {
        k: v for k, v in docs["sparse_device"].items() if k != "stats"}


def test_telemetry_has_the_devices_decision_table(corpora, tmp_path):
    import json

    res = run_debug(corpora["mix"], str(tmp_path / "port"), TorchBackend(device="cpu"), figures="none")
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        tel = json.load(fh)
    assert tel["sched"] == sched.sched_snapshot("cpu")
    assert {"lane", "planned", "reason", "stolen", "predicted_s", "wall_s", "failed_over"} <= set(tel["sched"][0])
