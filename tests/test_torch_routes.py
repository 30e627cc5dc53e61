"""The port's routes against the JAX package's, record for record, and the
report trees of the host lane.

``TorchBackend("cpu").analysis_routes`` against ``JaxBackend.analysis_routes``
over the same corpus, every verb driven (fused and giant, the diff, the
synth pass), field for field: verb, route, rows, v, e, work, reason.  The
JAX side runs its device-backend auto, ``NEMO_ANALYSIS_IMPL=crossover``
(its CPU pin sends everything to the host; the port does not copy it),
``NEMO_GIANT_IMPL=sparse_device``, ``NEMO_SCHED=off`` (serial, no
stealing) and ``NEMO_PROFILE=off`` (the seeded budgets); its synth route
is resolved as on a device backend (auto, not the CPU pin).  Covered:
corpora below and above each budget (the fused, diff and synth budgets,
at their seeded values and set between two buckets' work on both sides),
the memory watermark, a giant good run, and every forced route.  Then
report trees, default route and forced ``sparse``, byte for byte against
the JAX package's (``report_tree_bytes``).
"""

import pkgutil

import numpy as np
import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.synth import synth_impl_env
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import ANALYSIS_IMPLS, TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_device_auto(monkeypatch):
    """The JAX side's device-backend routing, serial, seeded budgets."""
    for name, value in (("NEMO_ANALYSIS_IMPL", "crossover"), ("NEMO_GIANT_IMPL", "sparse_device"),
                        ("NEMO_SCHED", "off"), ("NEMO_PROFILE", "off")):
        monkeypatch.setenv(name, value)
    for name in ("NEMO_ANALYSIS_HOST_WORK", "NEMO_DIFF_HOST_WORK", "NEMO_SYNTH_HOST_WORK", "NEMO_SYNTH_IMPL",
                 "NEMO_SPARSE_DEVICE_MEM_MB", "NEMO_GIANT_V"):
        monkeypatch.delenv(name, raising=False)
    # A device backend resolves the synth route per bucket; the CPU pin of
    # _resolve_synth_impl would send every bucket to the host.
    monkeypatch.setattr(JaxBackend, "_resolve_synth_impl", lambda self: synth_impl_env())


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("routes"))
    return {
        "family": write_case_study("ZK-1270-racing-sent-flag", 12, 0, root),
        "mix": write_corpus(SynthSpec(n_runs=60, seed=6, eot=20, name="mix"), root),
        "deep": write_corpus(SynthSpec(n_runs=6, seed=5, eot=30, name="deep"), root),
    }


def _drive(backend, molly) -> list[dict]:
    """Every routed verb: the fused step (with its giants), the diff over
    every failed run, the synth pass over every run."""
    backend.init_graph_db("", molly)
    backend.load_raw_provenance()
    backend.simplify_prov(molly.get_runs_iters())
    failed = molly.get_failed_runs_iters()
    if failed and molly.get_success_runs_iters():
        backend.create_naive_diff_prov(False, failed, None, dot_iters=[])
    backend.synth_candidates(molly.get_runs_iters())
    return list(backend.analysis_routes)


def _routes_equal(corpus: str, **port_kw) -> list[dict]:
    port = _drive(TorchBackend(device="cpu", **port_kw), port_load(corpus))
    jax = _drive(JaxBackend(), jax_load(corpus))
    assert port == jax
    return port


def _bucket_works(corpus: str, **kw) -> list[int]:
    tb = TorchBackend(device="cpu", **kw)
    tb.init_graph_db("", port_load(corpus))
    return sorted(len(p.run_ids) * (p.v + p.e) for p, _ in tb._plan_fused_inputs()["batches"])


def test_seeded_budgets_send_a_small_corpus_to_the_host(corpora):
    routes = _routes_equal(corpora["family"])
    assert {(r["verb"], r["route"], r["reason"]) for r in routes} == {
        ("fused", "sparse", "crossover"), ("diff", "sparse", "crossover"), ("synth", "sparse", "crossover")}


@pytest.mark.parametrize("side", ["host", "device"])
def test_each_budget_from_both_sides(corpora, monkeypatch, side):
    """Budgets set between the corpus's bucket works (the fused and synth
    budgets) and at the diff's work (host) or one below it (device)."""
    works = _bucket_works(corpora["mix"])
    assert works[0] < works[-1]
    budget = works[len(works) // 2] if side == "host" else works[0] - 1
    probe = _drive(TorchBackend(device="cpu", diff_host_work=0), port_load(corpora["mix"]))
    (diff_work,) = [r["work"] for r in probe if r["verb"] == "diff"]
    diff_budget = diff_work if side == "host" else diff_work - 1
    for name, value in (("NEMO_ANALYSIS_HOST_WORK", budget), ("NEMO_SYNTH_HOST_WORK", budget),
                        ("NEMO_DIFF_HOST_WORK", diff_budget)):
        monkeypatch.setenv(name, str(value))
    routes = _routes_equal(corpora["mix"], analysis_host_work=budget, synth_host_work=budget,
                           diff_host_work=diff_budget)
    fused = {r["route"] for r in routes if r["verb"] == "fused"}
    synth = {r["route"] for r in routes if r["verb"] == "synth"}
    (diff,) = [(r["route"], r["reason"]) for r in routes if r["verb"] == "diff"]
    if side == "host":
        assert fused == {"sparse", "dense"} and synth == {"sparse", "sparse_device"}
        assert diff == ("sparse", "crossover")
    else:
        assert fused == {"dense"} and synth == {"sparse_device"} and diff == ("dense", "crossover")


@pytest.mark.parametrize("mem", [16 * 32 * 32 * 4, 1000])
def test_memory_watermark(corpora, monkeypatch, mem):
    """No host budget and a watermark of 64 KB (the larger buckets go sparse
    on the device by "mem", the others stay dense) or of 1 KB (every bucket
    and the diff by "mem")."""
    for name, value in (("NEMO_ANALYSIS_HOST_WORK", "0"), ("NEMO_DIFF_HOST_WORK", "0"),
                        ("NEMO_SYNTH_HOST_WORK", "0"), ("NEMO_SPARSE_DEVICE_MEM_MB", str(mem / 1e6))):
        monkeypatch.setenv(name, value)
    routes = _routes_equal(corpora["mix"], analysis_host_work=0, diff_host_work=0, synth_host_work=0,
                           sparse_device_mem_bytes=mem)
    got = {(r["verb"], r["route"], r["reason"]) for r in routes if r["verb"] != "synth"}
    if mem > 1000:
        assert {("fused", "sparse_device", "mem"), ("fused", "dense", "crossover")} <= got
    else:
        assert got == {("fused", "sparse_device", "mem"), ("diff", "sparse_device", "mem")}


def test_giant_good_run(corpora, monkeypatch):
    """Giant threshold 64: the giant runs leave the buckets for the sparse
    device step (reason giant_impl, work V + E), and the giant good run's
    diff goes to the host by "giant"."""
    monkeypatch.setenv("NEMO_GIANT_V", "64")
    routes = _routes_equal(corpora["deep"], giant_v=64)
    giants = [r for r in routes if r["verb"] == "giant"]
    assert giants and all((r["route"], r["reason"], r["work"]) == ("sparse_device", "giant_impl", r["v"] + r["e"])
                          for r in giants)
    assert [(r["route"], r["reason"]) for r in routes if r["verb"] == "diff"] == [("sparse", "giant")]


#: A forced port route -> the JAX package's knobs for the same lanes.
FORCED = {
    "dense": {"NEMO_ANALYSIS_IMPL": "dense", "NEMO_GIANT_IMPL": "sparse_device", "NEMO_SYNTH_IMPL": "sparse_device"},
    "sparse": {"NEMO_ANALYSIS_IMPL": "sparse", "NEMO_GIANT_IMPL": "auto", "NEMO_SYNTH_IMPL": "sparse"},
    "sparse_device": {"NEMO_ANALYSIS_IMPL": "sparse_device", "NEMO_GIANT_IMPL": "auto",
                      "NEMO_SYNTH_IMPL": "sparse_device"},
}


@pytest.mark.parametrize("impl", sorted(FORCED))
@pytest.mark.parametrize("corpus", ["mix", "deep"])
def test_forced_routes(corpora, monkeypatch, impl, corpus):
    for name, value in FORCED[impl].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("NEMO_GIANT_V", "64")
    routes = _routes_equal(corpora[corpus], analysis_impl=impl, giant_v=64)
    lane = {"sparse": "sparse"}.get(impl, "sparse_device")
    for r in routes:
        if r["verb"] == "giant":
            assert (r["route"], r["reason"]) == (lane, "giant_impl")
        elif r["verb"] == "synth":
            assert (r["route"], r["reason"]) == (lane, "forced")
        elif not (r["verb"] == "diff" and r["reason"] == "giant"):
            assert (r["route"], r["reason"]) == (impl, "forced")
    if corpus == "deep":
        assert any(r["verb"] == "giant" for r in routes)


def test_cli_analysis_impl_follows_analysis_impls():
    assert ANALYSIS_IMPLS == ("auto", "dense", "sparse", "sparse_device")
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", "x", "--device", "cpu", "--analysis-impl", "crossover"])


def test_isolation_walk_covers_the_slice():
    """tests/test_torch_isolation.py imports every module pkgutil walks;
    the host lane's, the stream's and the utilities' are among them."""
    import nemo_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(nemo_tpu_torch.__path__, "nemo_tpu_torch.")}
    assert {"nemo_tpu_torch.ops.sparse_host", "nemo_tpu_torch.analysis.stream", "nemo_tpu_torch.parallel.giant",
            "nemo_tpu_torch.utils", "nemo_tpu_torch.analysis.delta"} <= names


# --------------------------------------------------------------- report trees


def _jax_report(corpus: str, out: str, figures: str) -> dict[str, bytes]:
    res = jax_run_debug(corpus, out, JaxBackend(), reporter=JaxReporter(), figures=figures, ingest="python",
                        corpus_cache="off", result_cache="off")
    return jax_tree(res.report_dir)


@pytest.mark.parametrize("impl", ["auto", "sparse"])
@pytest.mark.parametrize("corpus", ["family", "deep"])
def test_report_tree_on_the_host_lane_equals_jax(corpora, tmp_path, monkeypatch, impl, corpus):
    monkeypatch.setenv("NEMO_GIANT_V", "64")
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "sparse")
    monkeypatch.setenv("NEMO_GIANT_IMPL", "auto")
    want = _jax_report(corpora[corpus], str(tmp_path / "jax"), "all")
    backend = TorchBackend(device="cpu", analysis_impl=impl, giant_v=64)
    res = run_debug(corpora[corpus], str(tmp_path / "port"), backend, figures="all")
    got = report_tree_bytes(res.report_dir)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    routes = {r["route"] for r in backend.analysis_routes if r["verb"] in ("fused", "diff", "synth")}
    assert routes == {"sparse"}
    assert backend.executor.dispatches == ({} if impl == "sparse" or corpus == "family" else {"sparse_fused": 2})
    assert np.sum(list(backend.executor.host_runs.values())) > 0
