"""The port's sparse-CSR device tier against the JAX package, on the CPU.

* K2's plain version (``edge_wave_plain``, what ``edge_wave`` runs on a CPU
  tensor) against ``edge_wave_pallas`` in interpret mode, for finite
  ``n_steps`` and to the fix point, on [B,E] and shared [E] edge lists and
  on cyclic graphs;
* ``sparse_device_step`` against the JAX ``sparse_device_step`` with its
  Pallas wave (interpret mode), every output key, on case-study families,
  deep / all-failed / bad-first synthetic corpora and the non-linear zigzag;
* ``diff_masks_sparse_device`` against JAX, the cyclic-termination case
  included; the ``CsrAdjRows`` views;
* ``TorchBackend`` on the forced sparse route, on giant runs, and on the
  auto route against ``JaxBackend`` under the matching environment knobs.

Inputs come from numpy (seeded) or from the JAX package's packing and reach
the port as numpy.  Tolerance: none — every output is bool or int.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.models import pipeline_model as jpm
from nemo_tpu.models.case_studies import write_case_study
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.ops import sparse_device as jsd
from nemo_tpu.ops.pallas_kernels import edge_wave_pallas
from nemo_tpu.parallel.giant import giant_plan as jax_giant_plan
from nemo_tpu_torch import cli
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.graphs.packed import pack_batch
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load
from nemo_tpu_torch.kernels.edge_wave import edge_wave, edge_wave_plain
from nemo_tpu_torch.models import pipeline_model as tpm
from nemo_tpu_torch.ops import sparse_device as tsd
from nemo_tpu_torch.ops.simplify import pair_chains_linear
from nemo_tpu_torch.parallel.giant import giant_linear
from nemo_tpu_torch.parallel.giant import giant_plan as port_giant_plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, got.dtype,
                                                                  want.shape, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------ K2, plain


def _wave_inputs(kind: str):
    """(state [B,V], src, dst, mask) numpy; edges [B,E], or [E] for
    "shared"; "cyclic" rows are permutation cycles plus random chords."""
    rng = np.random.default_rng({"random": 1, "cyclic": 2, "shared": 3}[kind])
    b, v, e = 9, 24, 40
    state = rng.random((b, v)) < 0.1
    state[3] = False  # a row that never moves
    if kind == "cyclic":
        src = np.zeros((b, e), dtype=np.int32)
        dst = np.zeros((b, e), dtype=np.int32)
        for r in range(b):
            perm = rng.permutation(v)
            src[r, :v], dst[r, :v] = perm, np.roll(perm, -1)
            src[r, v:], dst[r, v:] = rng.integers(0, v, e - v), rng.integers(0, v, e - v)
        mask = rng.random((b, e)) < 0.9
    elif kind == "shared":
        src = rng.integers(0, v, e).astype(np.int32)
        dst = rng.integers(0, v, e).astype(np.int32)
        mask = rng.random(e) < 0.8
    else:
        src = rng.integers(0, v, (b, e)).astype(np.int32)
        dst = rng.integers(0, v, (b, e)).astype(np.int32)
        mask = rng.random((b, e)) < 0.7
        mask[5] = False  # an all-false mask row
    return state, src, dst, mask


def _pallas(state, src, dst, mask, n_steps):
    """edge_wave_pallas (interpret mode) on [B,E] planes; n_steps=None
    repeats it until a call changes nothing (the fix point)."""
    b, e = state.shape[0], src.shape[-1]
    args = [jnp.asarray(np.broadcast_to(a, (b, e))) for a in (src, dst, mask)]
    cur = jnp.asarray(state)
    while True:
        nxt = edge_wave_pallas(cur, *args, n_steps=n_steps or 4, interpret=True)
        if n_steps is not None or bool((nxt == cur).all()):
            return np.asarray(nxt)
        cur = nxt


@pytest.mark.parametrize("kind", ["random", "cyclic", "shared"])
@pytest.mark.parametrize("n_steps", [1, 3, None])
def test_edge_wave_plain_matches_pallas(kind, n_steps):
    state, src, dst, mask = _wave_inputs(kind)
    want = _pallas(state, src, dst, mask, n_steps)
    ts = [torch.from_numpy(a) for a in (state, src, dst, mask)]
    _eq(edge_wave_plain(*ts, n_steps), want, f"{kind} n_steps={n_steps}")
    _eq(edge_wave(*ts, n_steps), want, "wrapper on a CPU tensor")
    assert torch.equal(ts[0], torch.from_numpy(state)), "the input state is not modified"


def test_edge_wave_plain_zero_steps_and_chain():
    """n_steps=0 is the identity; a V-node chain reaches its end only after
    V-1 synchronous waves (one hop per wave, never more)."""
    v = 12
    state = torch.zeros(1, v, dtype=torch.bool)
    state[0, 0] = True
    src = torch.arange(v - 1, dtype=torch.int32)
    dst = src + 1
    mask = torch.ones(v - 1, dtype=torch.bool)
    assert torch.equal(edge_wave_plain(state, src, dst, mask, 0), state)
    for k in (1, 5, v - 2):
        got = edge_wave_plain(state, src, dst, mask, k)
        assert got[0].nonzero().flatten().tolist() == list(range(k + 1))
    assert edge_wave_plain(state, src, dst, mask, None).all()


# ------------------------------------------------------------ the step


def _step_pair(corpus: str):
    """JAX packed (pre, post, static) and the port's BatchArrays of them."""
    pre, post, static = jpm.pack_molly_for_step(jax_load(corpus))
    port = [
        tpm.batch_from_numpy({f: np.asarray(getattr(b, f)) for f in b.FIELDS}, "cpu")
        for b in (pre, post)
    ]
    return pre, post, port, static


def _assert_step_parity(corpus: str, label: str) -> None:
    pre, post, port, st = _step_pair(corpus)
    kw = dict(v=st["v"], pre_tid=st["pre_tid"], post_tid=st["post_tid"],
              num_tables=st["num_tables"], comp_linear=st["comp_linear"])
    want = jsd.sparse_device_step(pre, post, wave_impl="pallas", **kw)
    got = tsd.sparse_device_step(*port, **kw)
    assert sorted(got) == sorted(want), label
    for k in sorted(want):
        _eq(got[k], want[k], f"{label}: {k}")
    packed = tsd.sparse_device_step(*port, pack_out=True, **kw)
    want_packed = jsd.sparse_device_step(pre, post, wave_impl="pallas", pack_out=True, **kw)
    _eq(packed["packed_summary"], want_packed["packed_summary"], f"{label}: packed_summary")


@pytest.mark.parametrize("family", ["ZK-1270-racing-sent-flag", "CA-2434-bootstrap-synchronization"])
def test_sparse_step_matches_jax_case_study(family, tmp_path):
    _assert_step_parity(write_case_study(family, 8, 11, str(tmp_path)), family)


@pytest.mark.parametrize(
    "spec",
    [
        SynthSpec(n_runs=3, seed=5, eot=60, name="deep"),
        SynthSpec(n_runs=6, seed=7, fail_all_fraction=0.9, name="failall"),
        SynthSpec(n_runs=5, seed=4, first_run_kind="fail", name="badfirst"),
    ],
    ids=lambda s: s.name,
)
def test_sparse_step_matches_jax_synth(spec, tmp_path):
    _assert_step_parity(write_corpus(spec, str(tmp_path)), spec.name)


def _write_zigzag(root, statuses=("success",)) -> str:
    from tests.test_giant_nonlinear import _zigzag_prov

    d = root / "zigzag"
    d.mkdir()
    runs = [
        {
            "iteration": i,
            "status": status,
            "failureSpec": {"eot": 4, "eff": 2, "maxCrashes": 0, "nodes": ["n1"]},
            "model": {"tables": {"pre": [["n1", "1"]], "post": [["n1", "1"]]}},
            "messages": [],
        }
        for i, status in enumerate(statuses)
    ]
    with open(d / "runs.json", "w") as f:
        json.dump(runs, f)
    for i in range(len(statuses)):
        for cond in ("pre", "post"):
            with open(d / f"run_{i}_{cond}_provenance.json", "w") as f:
                json.dump(_zigzag_prov(cond), f)
    return str(d)


def test_sparse_step_matches_jax_zigzag(tmp_path):
    """Non-linear member structure: the min-label relaxation, not pointer
    doubling."""
    d = _write_zigzag(tmp_path)
    assert not _step_pair(d)[3]["comp_linear"], "zigzag must reject the linear fast path"
    tsd.LOOP_STATS.clear()
    _assert_step_parity(d, "zigzag")
    assert tsd.LOOP_STATS["component_labels"]["iters"] > 0


# ------------------------------------------------------------ the diff


def _diff_both(src, dst, mask, is_goal, node_mask, label_id, fail_bits, v):
    want = jsd.diff_masks_sparse_device(src, dst, mask, is_goal, node_mask, label_id, fail_bits, v)
    got = tsd.diff_masks_sparse_device(
        *(torch.from_numpy(np.array(a)) for a in (src, dst, mask, is_goal, node_mask, label_id,
                                                     fail_bits)),
        v,
    )
    for name, g, w in zip(("node_keep", "edge_keep", "frontier_rule", "missing_goal"), got, want):
        _eq(g, w, name)
    return got


def test_sparse_diff_matches_jax():
    pre, post, static = jpm.synth_batch_arrays(n_runs=10, seed=3)
    fail_bits = np.random.default_rng(0).random((6, 8)) < 0.4
    got = _diff_both(
        *(np.asarray(getattr(post, f)[0]) for f in ("edge_src", "edge_dst", "edge_mask", "is_goal",
                                                     "node_mask", "label_id")),
        fail_bits,
        static["v"],
    )
    assert got[2].any(), "some failed run has a frontier rule"


def test_sparse_diff_terminates_on_cycles_like_jax():
    """A cyclic consequent: the max-plus loop stops at its cap of v
    iterations, where the JAX package's loop stops."""
    v = 8
    src = np.array([0, 2, 3, 4, 2], dtype=np.int32)
    dst = np.array([2, 3, 4, 2, 1], dtype=np.int32)  # 2 -> 3 -> 4 -> 2 cycle
    mask = np.ones(5, dtype=bool)
    is_goal = np.array([True, True] + [False] * 6)
    node_mask = np.array([True] * 5 + [False] * 3)
    label_id = np.array([0, 1, 2, 3, 4, -1, -1, -1], dtype=np.int32)
    fail_bits = np.zeros((2, 8), dtype=bool)
    fail_bits[0, 1] = True  # goal 1's label missing from failed run 0
    tsd.LOOP_STATS.clear()
    _diff_both(src, dst, mask, is_goal, node_mask, label_id, fail_bits, v)
    assert tsd.LOOP_STATS["diff_longest"]["iters"] == v


def test_csr_adj_rows_views():
    src = np.array([[0, 1, 0], [2, 2, 0]])
    dst = np.array([[1, 2, 0], [3, 1, 0]])
    mask = np.array([[True, True, False], [True, False, False]])
    got, want = tsd.CsrAdjRows(src, dst, mask, v=4), jsd.CsrAdjRows(src, dst, mask, v=4)
    assert got.shape == want.shape == (2, 4, 4) and len(got) == 2
    _eq(got[0], want[0])
    _eq(got[np.asarray([1, 0])], want[np.asarray([1, 0])])
    _eq(np.asarray(got), np.asarray(want))
    assert got[0].sum() == 2 and got[1][2, 3] and got[1].sum() == 1


# ------------------------------------------------------------ backend


def _drive(backend, molly):
    backend.init_graph_db("", molly)
    backend.load_raw_provenance()
    backend.simplify_prov(molly.get_runs_iters())


def _compare(corpus: str, tb: TorchBackend) -> None:
    """Prototypes, missing events, achieved counts and synth candidates of
    the port's backend against JaxBackend under the current environment."""
    jm, tm = jax_load(corpus), port_load(corpus)
    jb = JaxBackend()
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
    return jb


@pytest.fixture
def sparse_env(monkeypatch):
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "sparse_device")
    monkeypatch.setenv("NEMO_SPARSE_WAVE_IMPL", "pallas")
    monkeypatch.setenv("NEMO_SYNTH_IMPL", "sparse_device")


@pytest.mark.parametrize("corpus", ["synth", "MR-3858-hadoop"])
def test_backend_forced_sparse_matches_jax(corpus, corpus_dir, tmp_path, sparse_env):
    d = corpus_dir if corpus == "synth" else write_case_study(corpus, 10, 0, str(tmp_path))
    tb = TorchBackend(device="cpu", analysis_impl="sparse_device")
    jb = _compare(d, tb)
    port_routes = {(r["verb"], r["route"], r["reason"]) for r in tb.analysis_routes}
    assert port_routes == {("fused", "sparse_device", "forced"), ("diff", "sparse_device", "forced"),
                           ("synth", "sparse_device", "forced")}
    assert {(r["verb"], r["route"]) for r in jb.analysis_routes} >= {
        ("fused", "sparse_device"), ("diff", "sparse_device")
    }
    assert "fused" not in tb.executor.dispatches and tb.executor.dispatches["sparse_diff"] == 1


@pytest.fixture
def giant_env(monkeypatch):
    monkeypatch.setenv("NEMO_GIANT_V", "64")
    monkeypatch.setenv("NEMO_GIANT_IMPL", "sparse_device")
    monkeypatch.setenv("NEMO_ANALYSIS_IMPL", "dense")
    monkeypatch.setenv("NEMO_SYNTH_IMPL", "sparse_device")


@pytest.mark.parametrize("corpus", ["deep", "zigzag"])
def test_giant_runs_match_jax(corpus, tmp_path, giant_env):
    """giant_v=64: runs above 64 nodes leave the buckets for sparse_fused,
    one dispatch each, and a giant good run's diff goes to the host lane."""
    if corpus == "zigzag":
        d = _write_zigzag(tmp_path, ("success", "fail"))
    else:
        # Runs 0 (the good run) and 3 above 64 nodes, four below.
        d = write_corpus(SynthSpec(n_runs=6, seed=5, eot=30, name="deep"), str(tmp_path))
    tb = TorchBackend(device="cpu", giant_v=64)
    jb = _compare(d, tb)
    giants = [r for r in tb.analysis_routes if r["verb"] == "giant"]
    jax_giants = [r for r in jb.analysis_routes if r["verb"] == "giant"]
    assert giants and len(giants) == len(jax_giants)
    assert all(r["route"] == "sparse_device" and r["rows"] == 1 for r in giants)
    assert {r["route"] for r in jax_giants} == {"sparse_device"}
    assert tb.executor.dispatches["sparse_fused"] == len(giants)
    diff = [r for r in tb.analysis_routes if r["verb"] == "diff"]
    assert [(r["route"], r["reason"]) for r in diff] == [("sparse", "giant")]
    assert [r for r in jb.analysis_routes if r["verb"] == "diff"] == diff


def test_giant_plan_matches_jax(tmp_path):
    """The port's giant_plan (linear flag, depth bound, union-find labels)
    equals the JAX package's, and the device lane's flag (giant_linear)
    equals both and the bucket-level check on the run's one-row batches."""
    from nemo_tpu.graphs.packed import CorpusVocab as JaxVocab
    from nemo_tpu.graphs.packed import pack_graph as jax_pack

    flags = []
    for d in (_write_zigzag(tmp_path, ("success", "fail")),
              write_corpus(SynthSpec(n_runs=4, seed=5, eot=12), str(tmp_path))):
        tb = TorchBackend(device="cpu")
        tb.init_graph_db("", port_load(d))
        vocab = JaxVocab()
        for run in jax_load(d).runs:
            for cond, prov in (("pre", run.pre_prov), ("post", run.post_prov)):
                graph = tb.packed[(run.iteration, cond)]
                got, depth, labels = port_giant_plan(graph)
                want, want_depth, want_labels = jax_giant_plan(jax_pack(prov, vocab))
                assert (got, depth) == (want, want_depth), (d, run.iteration, cond)
                np.testing.assert_array_equal(labels, np.asarray(want_labels))
                assert got == giant_linear(graph)
                assert got == pair_chains_linear(*[pack_batch([run.iteration], [graph])] * 2)
                flags.append(got)
    assert True in flags and False in flags


# ------------------------------------------------------------ auto routing


@pytest.mark.parametrize(
    "rows,b,v,e,want",
    [
        (541, 1024, 64, 256, ("dense", "crossover")),
        (494, 512, 128, 256, ("dense", "crossover")),
        (544, 1024, 256, 256, ("sparse_device", "mem")),
        (121, 128, 512, 512, ("dense", "crossover")),
        (1, 8, 2048, 2048, ("sparse_device", "density")),
        (1, 8, 1024, 8192, ("dense", "crossover")),
        (3, 8, 512, 128, ("dense", "crossover")),
    ],
)
def test_auto_route_reasons(rows, b, v, e, want):
    """The JAX package's device route order on hand-sized buckets (host
    budget 0, so no bucket takes the host lane): the long-horizon sweep's
    four buckets, a density-routed and a dense large-V bucket, and a sparse
    small-V bucket under the density floor.  With the default budget, a
    bucket whose work B x (V + E) is within 100,000 takes the host lane."""
    work = rows * (v + e)
    tb = TorchBackend(device="cpu", analysis_host_work=0)
    assert tb._analysis_route(rows, v, e, b) == (*want, work)
    assert TorchBackend(device="cpu", analysis_impl="dense")._analysis_route(rows, v, e, b) == (
        "dense", "forced", work)
    default = TorchBackend(device="cpu")._analysis_route(rows, v, e, b)
    assert default == (("sparse", "crossover", work) if work <= 100_000 else (*want, work))


def test_auto_diff_route_reasons():
    """The JAX package's diff order: a giant good run -> the host lane;
    forced; work F x (V + E) within the host budget -> the host; past the
    watermark -> sparse on the device; else dense."""
    tb = TorchBackend(device="cpu")
    # (good nodes, good edges, failed runs, padded failed runs, V)
    assert tb._diff_route(5000, 5200, 2, 8, 8192) == ("sparse", "giant", 20400)
    assert tb._diff_route(40, 45, 1000, 1024, 64) == ("sparse", "crossover", 85000)
    no_host = TorchBackend(device="cpu", diff_host_work=0)
    assert no_host._diff_route(1371, 1400, 2, 8, 2048) == ("dense", "crossover", 5542)
    assert no_host._diff_route(1000, 1000, 100, 128, 2048) == ("sparse_device", "mem", 200000)
    assert no_host._diff_route(5000, 5200, 2, 8, 8192) == ("sparse", "giant", 20400)
    assert TorchBackend(device="cpu", analysis_impl="dense")._diff_route(5000, 5200, 2, 8, 8192) == (
        "sparse", "giant", 20400)
    assert TorchBackend(device="cpu", analysis_impl="sparse_device")._diff_route(10, 9, 8, 8, 64) == (
        "sparse_device", "forced", 152)
    assert TorchBackend(device="cpu", analysis_impl="sparse")._diff_route(10, 9, 8, 8, 64) == (
        "sparse", "forced", 152)
    with pytest.raises(ValueError, match="analysis_impl"):
        TorchBackend(device="cpu", analysis_impl="crossover")


def test_auto_mixes_both_tiers_and_matches_dense(tmp_path):
    """A watermark that splits the corpus: some buckets sparse by "mem",
    the rest dense, and the document equals the all-dense one."""
    d = write_corpus(SynthSpec(n_runs=40, seed=6, eot=20, name="mix"), str(tmp_path))
    dense = cli.analyze(d, device="cpu", analysis_impl="dense")
    tb_doc = None
    for mem in (16 * 32 * 32 * 4, 64 * 64 * 64 * 4):
        tb = TorchBackend(device="cpu", sparse_device_mem_bytes=mem, analysis_host_work=0)
        tm = port_load(d)
        _drive(tb, tm)
        routes = [(r["route"], r["reason"]) for r in tb.analysis_routes if r["verb"] == "fused"]
        if ("sparse_device", "mem") in routes and ("dense", "crossover") in routes:
            tb_doc = tb
            break
    assert tb_doc is not None, "no watermark split the corpus into both tiers"
    failed = tm.get_failed_runs_iters()
    succ = tm.get_success_runs_iters()
    inter, inter_miss, union, union_miss = tb_doc.create_prototypes(succ, failed)
    assert (inter, union) == (dense["inter_proto"], dense["union_proto"])
    assert dict(zip(map(str, failed), inter_miss)) == dense["inter_proto_missing"]
    missing = tb_doc.missing_events(failed)
    assert {str(f): [m.to_json() for m in ev] for f, ev in zip(failed, missing)} == dense[
        "missing_events"]
    synth = tb_doc.synth_candidates(tm.get_runs_iters())
    assert {str(i): synth[i] for i in tm.get_runs_iters()} == dense["synth_candidates"]


def test_cli_sparse_document_equals_dense(corpus_dir, tmp_path):
    out = tmp_path / "sparse.json"
    assert cli.main(["-faultInjOut", corpus_dir, "--device", "cpu", "--analysis-impl",
                     "sparse_device", "--out", str(out)]) == 0
    sparse = json.loads(out.read_text())
    dense = cli.analyze(corpus_dir, device="cpu", analysis_impl="dense")
    assert {r["route"] for r in sparse["routes"]} == {"sparse_device"}
    assert {(r["verb"], r["route"]) for r in dense["routes"]} == {
        ("fused", "dense"), ("diff", "dense"), ("synth", "sparse_device")}
    assert set(sparse["dispatches"]) == {"sparse_fused", "sparse_diff", "synth_ext"}
    facts = ("routes", "dispatches", "dispatch_wall_s", "timings_s")
    assert {k: v for k, v in sparse.items() if k not in facts} == {
        k: v for k, v in dense.items() if k not in facts
    }
