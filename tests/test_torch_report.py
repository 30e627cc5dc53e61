"""The port's debugging report against the JAX package's, on the CPU.

The JAX side is ``nemo_tpu.analysis.pipeline.run_debug`` with a
``JaxBackend``, a sequential ``Reporter``, the object ingest and every
cache off; the port's is ``nemo_tpu_torch.analysis.pipeline.run_debug``
with ``TorchBackend(device="cpu")``.  Compared: ``report_tree_bytes`` of
the two report trees (every file but telemetry.json), on the six case-study
families, the shared synthetic corpus under every figure policy, an
all-failed and an all-success corpus and a small giant corpus on both
tiers; the JAX side on its default route and forced dense.  The six
families and the synthetic corpus again with the port on its device lanes
(every host budget 0, or the dense lane forced: the K1 path, the dense
diff's edge_keep overlays, synth_ext) against the JAX side forced dense.
Then the report verbs one by one against ``JaxBackend``, on the port's
default routes and on its device lanes: pull_pre_post_prov's DOT strings,
create_naive_diff_prov's overlay DOTs and missing events,
generate_corrections and generate_extensions.  Tolerance: none.
"""

import os

import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import REC_CANT_HELP, REC_WELL_DONE, report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load

RUNS = 12
FIGURE_FAMILIES = (
    "spacetime", "pre_prov", "post_prov", "pre_prov_clean", "post_prov_clean",
    "diff_post_prov-diff", "diff_post_prov-failed",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def family_root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_report_families")


@pytest.fixture(params=["default", "dense"])
def jax_route(request, monkeypatch):
    """The JAX side's route: its CPU default (the sparse host engine) or
    the dense device kernels."""
    if request.param == "dense":
        monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    else:
        monkeypatch.delenv("NEMO_ANALYSIS_IMPL", raising=False)
    return request.param


def _jax_report(corpus: str, out: str, figures: str) -> dict[str, bytes]:
    res = jax_run_debug(
        corpus, out, JaxBackend(), reporter=JaxReporter(), figures=figures,
        ingest="python", corpus_cache="off", result_cache="off",
    )
    return jax_tree(res.report_dir)


def _port_report(corpus: str, out: str, figures: str, **backend_kw) -> dict[str, bytes]:
    res = run_debug(corpus, out, TorchBackend(device="cpu", **backend_kw), figures=figures)
    return report_tree_bytes(res.report_dir)


def _assert_same_tree(port: dict[str, bytes], jax: dict[str, bytes]) -> None:
    assert sorted(port) == sorted(jax)
    assert [k for k in jax if port[k] != jax[k]] == []


def _compare(corpus: str, tmp_path, figures: str = "all", **backend_kw) -> dict[str, bytes]:
    want = _jax_report(corpus, str(tmp_path / "jax"), figures)
    got = _port_report(corpus, str(tmp_path / "port"), figures, **backend_kw)
    _assert_same_tree(got, want)
    return got


@pytest.mark.parametrize("family", sorted(CASE_STUDIES))
def test_report_matches_jax_case_study(family, family_root, tmp_path, jax_route):
    tree = _compare(write_case_study(family, RUNS, 0, str(family_root)), tmp_path)
    molly = port_load(os.path.join(str(family_root), family))
    assert {"index.html", "app.js", "nemo.css", "debugging.json", "repairs.json"} <= set(tree)
    for i in molly.runs_iters:
        assert f"figures/run_{i}_spacetime.svg" in tree
    for f in molly.failed_runs_iters:
        assert f"figures/run_{f}_diff_post_prov-diff.dot" in tree


def test_report_matches_jax_synthetic(corpus_dir, tmp_path, jax_route):
    _compare(corpus_dir, tmp_path)


#: The port's device lanes: every host budget 0 (auto then routes by the
#: memory and density steps), or the dense lane forced.
DEVICE_LANES = {
    "device_auto": {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0},
    "dense": {"analysis_impl": "dense"},
}


def _jax_dense_report(corpus: str, out: str) -> dict[str, bytes]:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEMO_ANALYSIS_IMPL", "dense")
        return _jax_report(corpus, out, "all")


def _compare_device_lanes(corpus: str, tmp_path, lanes: str) -> TorchBackend:
    """The port's report on its device lanes against the JAX package's
    forced dense; the port ran no verb on the host lane."""
    want = _jax_dense_report(corpus, str(tmp_path / "jax"))
    backend = TorchBackend(device="cpu", **DEVICE_LANES[lanes])
    res = run_debug(corpus, str(tmp_path / "port"), backend, figures="all")
    _assert_same_tree(report_tree_bytes(res.report_dir), want)
    assert backend.executor.host_runs == {}
    assert backend.analysis_routes and not [r for r in backend.analysis_routes if r["route"] == "sparse"]
    return backend


@pytest.mark.parametrize("lanes", sorted(DEVICE_LANES))
@pytest.mark.parametrize("family", sorted(CASE_STUDIES))
def test_report_device_lanes_match_jax_case_study(family, lanes, family_root, tmp_path):
    backend = _compare_device_lanes(write_case_study(family, RUNS, 0, str(family_root)), tmp_path, lanes)
    assert {"fused", "diff", "synth_ext"} <= set(backend.executor.dispatches)


@pytest.mark.parametrize("lanes", sorted(DEVICE_LANES))
def test_report_device_lanes_match_jax_synthetic(corpus_dir, tmp_path, lanes):
    backend = _compare_device_lanes(corpus_dir, tmp_path, lanes)
    assert {"fused", "diff"} <= set(backend.executor.dispatches)


@pytest.mark.parametrize("figures", ["failed", "sample:3", "none"])
def test_report_figure_policies(corpus_dir, tmp_path, figures):
    tree = _compare(corpus_dir, tmp_path, figures)
    n_svg = sum(k.endswith(".svg") for k in tree)
    assert (n_svg == 0) == (figures == "none")


def test_report_all_failed(tmp_path):
    """No successful run: no diff and no corrections; every run says Nemo
    can't help."""
    cd = write_corpus(
        SynthSpec(n_runs=3, seed=7, eot=6, first_run_kind="fail", fail_fraction=1.0,
                  vacuous_fraction=0.0, fail_all_fraction=0.0),
        str(tmp_path / "c"),
    )
    assert not jax_load(cd).success_runs_iters
    tree = _compare(cd, tmp_path)
    assert REC_CANT_HELP.encode() in tree["debugging.json"]
    assert not any("diff_post_prov" in k for k in tree)


def test_report_all_success(tmp_path):
    """No failed run: no diff, no corrections, well done."""
    cd = write_corpus(
        SynthSpec(n_runs=4, seed=3, eot=6, fail_fraction=0.0, vacuous_fraction=0.0,
                  fail_all_fraction=0.0),
        str(tmp_path / "c"),
    )
    assert not jax_load(cd).failed_runs_iters
    tree = _compare(cd, tmp_path)
    assert REC_WELL_DONE.encode() in tree["debugging.json"]
    assert not any("diff_post_prov" in k for k in tree)


@pytest.mark.parametrize("impl", ["auto", "sparse_device"])
def test_report_small_giant(tmp_path, monkeypatch, impl):
    """A giant threshold of 64 nodes on both sides: the runs above it take
    the sparse step one at a time (and a giant good run's diff the host
    lane), on the port's auto route and forced sparse_device."""
    cd = write_corpus(SynthSpec(n_runs=5, seed=4, eot=40), str(tmp_path / "c"))
    monkeypatch.setenv("NEMO_GIANT_V", "64")
    backend = TorchBackend(device="cpu", analysis_impl=impl, giant_v=64)
    want = _jax_report(cd, str(tmp_path / "jax"), "all")
    res = run_debug(cd, str(tmp_path / "port"), backend, figures="all")
    _assert_same_tree(report_tree_bytes(res.report_dir), want)
    verbs = {(r["verb"], r["route"]) for r in backend.analysis_routes}
    assert ("giant", "sparse_device") in verbs and ("diff", "sparse") in verbs


def test_cli_writes_the_report(corpus_dir, tmp_path):
    out = tmp_path / "R"
    assert cli.main(["-faultInjOut", corpus_dir, "--device", "cpu", "--results-dir", str(out),
                     "--figures", "all"]) == 0
    name = os.path.basename(corpus_dir)
    got = report_tree_bytes(str(out / name))
    _assert_same_tree(got, _jax_report(corpus_dir, str(tmp_path / "jax"), "all"))
    failed = port_load(corpus_dir).failed_runs_iters[0]
    for fam in FIGURE_FAMILIES:
        for ext in ("dot", "svg"):
            assert f"figures/run_{failed}_{fam}.{ext}" in got
    assert (out / name / "telemetry.json").exists()


# ------------------------------------------------------------ verb by verb


def _drive(backend, molly):
    backend.init_graph_db("", molly)
    backend.load_raw_provenance()
    backend.simplify_prov(molly.get_runs_iters())
    return backend


def _dots(dots) -> list[str]:
    return [d.to_string() for d in dots]


def _verbs_match(cd: str, port_backend: TorchBackend) -> TorchBackend:
    jm, tm = jax_load(cd), port_load(cd)
    jb, tb = _drive(JaxBackend(), jm), _drive(port_backend, tm)
    iters, failed = jm.runs_iters, jm.failed_runs_iters
    assert failed, "the corpus must have failed runs"

    jax_pull = jb.pull_pre_post_prov(iters)
    port_pull = tb.pull_pre_post_prov(iters)
    for j, p in zip(jax_pull, port_pull):
        assert _dots(p) == _dots(j)

    good = jb.good_run_iter()
    j_post, p_post = jax_pull[1][iters.index(good)], port_pull[1][iters.index(good)]
    dot_iters = failed[::2]
    jd, jf, jmiss = jb.create_naive_diff_prov(False, failed, j_post, dot_iters=dot_iters)
    pd, pf, pmiss = tb.create_naive_diff_prov(False, failed, p_post, dot_iters=dot_iters)
    assert len(pd) == len(dot_iters)
    assert _dots(pd) == _dots(jd) and _dots(pf) == _dots(jf)
    assert [[m.to_json() for m in ev] for ev in pmiss] == [[m.to_json() for m in ev] for ev in jmiss]

    assert tb.generate_corrections() == jb.generate_corrections()
    assert tb.generate_extensions() == jb.generate_extensions()
    assert tb.extension_suggestions() == jb.extension_suggestions()
    tb.close_db()
    assert tb.molly is None and tb.analysis_routes
    return tb


@pytest.mark.parametrize("corpus", ["synth", "ZK-1270-racing-sent-flag"])
def test_report_verbs_match_jax(corpus, corpus_dir, family_root, jax_route):
    cd = corpus_dir if corpus == "synth" else write_case_study(corpus, RUNS, 0, str(family_root))
    _verbs_match(cd, TorchBackend(device="cpu"))


@pytest.mark.parametrize("lanes", sorted(DEVICE_LANES))
@pytest.mark.parametrize("corpus", ["synth", "ZK-1270-racing-sent-flag"])
def test_report_verbs_device_lanes_match_jax(corpus, lanes, corpus_dir, family_root, monkeypatch):
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    cd = corpus_dir if corpus == "synth" else write_case_study(corpus, RUNS, 0, str(family_root))
    tb = _verbs_match(cd, TorchBackend(device="cpu", **DEVICE_LANES[lanes]))
    assert tb.executor.host_runs == {} and {"fused", "diff"} <= set(tb.executor.dispatches)


def test_reduce_of_split_partials_equals_one(corpus_dir):
    """The reduce does not depend on how the runs are split into partials:
    two partials, in either order, give the one-partial result."""
    from nemo_tpu_torch.analysis import delta
    from nemo_tpu_torch.analysis.pipeline import select_figure_iters
    from nemo_tpu_torch.utils.timing import PhaseTimer

    molly = port_load(corpus_dir)
    backend = TorchBackend(device="cpu")
    backend.init_graph_db("", molly)
    good = delta.choose_good_run(molly)
    figs = set(select_figure_iters("none", molly.runs_iters, molly.failed_runs_iters, good))
    mo = delta.map_runs(backend, molly, corpus_dir, good, figs, PhaseTimer())
    whole = delta.reduce_partials([mo.as_partial(molly.runs_iters)], molly, good)

    def part(iters):
        p = mo.as_partial(iters)
        keep = set(iters)
        for name in ("proto_ordered", "present", "missing", "achieved", "ext_candidates"):
            setattr(p, name, {k: v for k, v in getattr(p, name).items() if k in keep})
        return p

    half = len(molly.runs_iters) // 2
    a, b = part(molly.runs_iters[:half]), part(molly.runs_iters[half:])
    a.corrections = None  # anchor content rides on one partial only
    for parts in ([a, b], [b, a]):
        assert delta.reduce_partials(parts, molly, good) == whole
