"""The host lane of the port (ops/sparse_host.py, ops/diff.py:diff_masks_host,
parallel/giant.py) against the JAX package's host engine on the CPU, and
against the port's own dense and sparse_device lanes.

Inputs: the packed buckets of the six case-study families at 12 runs, of
synth corpora from three seeds, and of a small giant corpus (giant_v 64),
made by the port's bucketizer and fed to both packages as the same numpy
arrays.  Compared: every output of sparse_analysis_step (the port's clean
adjacency, contracted edge planes, densified row by row), synth_ext_host,
diff_masks_host (edge_keep a mask over the good run's edges),
giant_plan's flag, depth bound and union-find labels, and
giant_analysis_host.  Tolerance: none (bool and int outputs).
"""

import numpy as np
import pytest
import torch

from nemo_tpu.models.case_studies import CASE_STUDIES
from nemo_tpu.ops.diff import diff_masks_host as jax_diff_masks_host
from nemo_tpu.ops.sparse_host import sparse_analysis_step as jax_sparse_analysis_step
from nemo_tpu.ops.sparse_host import synth_ext_host as jax_synth_ext_host
from nemo_tpu.parallel.giant import giant_analysis_host as jax_giant_analysis_host
from nemo_tpu.parallel.giant import giant_plan as jax_giant_plan
from nemo_tpu_torch.backend.torch_backend import TorchBackend, TorchExecutor, _verb_arrays, _wrap_sparse_clean
from nemo_tpu_torch.graphs.packed import bucket_size, pack_batch
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
from nemo_tpu_torch.ops.adjacency import build_adjacency
from nemo_tpu_torch.ops.diff import diff_masks, diff_masks_host
from nemo_tpu_torch.ops.sparse_device import CsrAdjRows, diff_masks_sparse_device, synth_ext_candidates
from nemo_tpu_torch.ops.sparse_host import sparse_analysis_step, synth_ext_host
from nemo_tpu_torch.parallel.giant import giant_analysis_host, giant_linear, giant_plan, pad_comp_labels

RUNS = 12

#: Outputs every lane of the fused step shares, besides the clean adjacency.
SUMMARY = ("pre_holds", "post_holds", "pre_alive", "post_alive", "pre_type", "post_type", "achieved_pre",
           "proto_bits", "proto_min_depth", "proto_present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparse_host"))
    out = {f: write_case_study(f, RUNS, 0, root) for f in sorted(CASE_STUDIES)}
    for seed in (2, 5, 7):
        out[f"synth{seed}"] = write_corpus(SynthSpec(n_runs=10, seed=seed, eot=8, name=f"synth{seed}"), root)
    return out


def _backend(corpus: str, **kw) -> TorchBackend:
    tb = TorchBackend(device="cpu", **kw)
    tb.init_graph_db("", port_load(corpus))
    return tb


def _dense(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_same(port: dict, other: dict, rows: int) -> None:
    """The summary outputs and the clean adjacency of the real rows."""
    for k in SUMMARY:
        np.testing.assert_array_equal(_dense(port[k])[:rows], _dense(other[k])[:rows], err_msg=k)
    for cond in ("pre", "post"):
        np.testing.assert_array_equal(
            _dense(port[f"{cond}_adj_clean"][np.arange(rows)]), _dense(other[f"{cond}_adj_clean"][np.arange(rows)]),
            err_msg=f"{cond}_adj_clean",
        )


@pytest.mark.parametrize("name", sorted(CASE_STUDIES) + ["synth2", "synth5", "synth7"])
def test_fused_and_synth_host_lane_matches_jax_and_the_device_lanes(corpora, name):
    tb = _backend(corpora[name])
    plan = tb._plan_fused_inputs()
    tids = plan["tids"]
    ex = TorchExecutor("cpu")
    for pre_b, post_b in plan["batches"]:
        rows = len(pre_b.run_ids)
        linear = all(tb._lin_by_iter[i] for i in pre_b.run_ids)
        port = _wrap_sparse_clean(sparse_analysis_step(pre_b, post_b, v=pre_b.v, comp_linear=linear, **tids), pre_b.v)
        jax = jax_sparse_analysis_step(pre_b, post_b, v=pre_b.v, comp_linear=linear, **tids)
        assert isinstance(port["pre_adj_clean"], CsrAdjRows)
        _assert_same(port, jax, rows)
        for k in ("proto_inter", "proto_union"):
            np.testing.assert_array_equal(port[k], jax[k], err_msg=k)
        # The port's own device lanes on the same bucket.
        dense = ex.run("fused", _verb_arrays(pre_b, post_b), dict(
            v=pre_b.v, max_depth=bucket_size(max(pre_b.max_depth, post_b.max_depth), plan["min_d"]),
            comp_linear=int(linear), num_labels=8, with_diff=0, **tids))
        _assert_same(port, dense, rows)
        sdev = _wrap_sparse_clean(ex.run("sparse_fused", _verb_arrays(pre_b, post_b),
                                         dict(v=pre_b.v, comp_linear=int(linear), **tids)), pre_b.v)
        _assert_same(port, sdev, rows)

        holds = np.asarray(port["pre_holds"])
        num_tables = tids["num_tables"]
        bits = synth_ext_host(pre_b, holds, num_tables)
        np.testing.assert_array_equal(bits, jax_synth_ext_host(pre_b, holds, num_tables))
        dev_bits = synth_ext_candidates(
            *(torch.from_numpy(np.asarray(getattr(pre_b, f))) for f in
              ("edge_src", "edge_dst", "edge_mask", "is_goal", "node_mask", "type_id", "table_id")),
            torch.from_numpy(holds), v=pre_b.v, num_tables=num_tables)
        np.testing.assert_array_equal(bits[:rows], dev_bits.numpy()[:rows])


@pytest.mark.parametrize("name", sorted(CASE_STUDIES) + ["synth2", "synth5", "synth7"])
def test_diff_host_lane_matches_jax_and_the_device_lanes(corpora, name):
    tb = _backend(corpora[name])
    failed = tb.molly.get_failed_runs_iters()
    if not failed:
        pytest.skip(f"{name} at {RUNS} runs has no failed run")
    good = tb.packed[(tb.good_run_iter(), "post")]
    gb = pack_batch([tb.good_run_iter()], [good])
    num_labels = bucket_size(max(1, len(tb.vocab.labels)), 8)
    bits = np.zeros((len(failed), num_labels), dtype=bool)
    for j, f in enumerate(failed):
        pg = tb.packed[(f, "post")]
        bits[j, pg.label_id[: pg.n_goals]] = True
    goal = np.zeros(gb.v, dtype=bool)
    goal[: good.n_goals] = True
    label = np.full(gb.v, -1, dtype=np.int64)
    label[: good.n_nodes] = good.label_id
    port = diff_masks_host(good.edges, gb.v, goal, label, bits)
    jax = jax_diff_masks_host(good.edges, gb.v, goal, label, bits)
    for p, j, k in zip(port, jax, ("node_keep", "edge_keep", "frontier_rule", "missing_goal")):
        np.testing.assert_array_equal(p, j, err_msg=k)

    # The dense diff's [F,V,V] edge_keep is the host mask over the edges.
    t = {k: torch.from_numpy(np.asarray(a)) for k, a in (
        ("edge_src", gb.edge_src), ("edge_dst", gb.edge_dst), ("edge_mask", gb.edge_mask),
        ("is_goal", gb.is_goal[0]), ("node_mask", gb.node_mask[0]), ("label_id", gb.label_id[0]),
        ("fail_bits", bits))}
    adj = build_adjacency(t["edge_src"], t["edge_dst"], t["edge_mask"], gb.v)[0]
    dense = [x.numpy() for x in diff_masks(adj, t["is_goal"], t["node_mask"], t["label_id"], t["fail_bits"],
                                           bucket_size(gb.max_depth, 4))]
    for k in (0, 2, 3):
        np.testing.assert_array_equal(port[k], dense[k])
    for j in range(len(failed)):
        plane = np.zeros((gb.v, gb.v), dtype=bool)
        kept = good.edges[port[1][j]]
        plane[kept[:, 0], kept[:, 1]] = True
        np.testing.assert_array_equal(plane, dense[1][j])
    sdev = [x.numpy() for x in diff_masks_sparse_device(
        t["edge_src"][0], t["edge_dst"][0], t["edge_mask"][0], t["is_goal"], t["node_mask"], t["label_id"],
        t["fail_bits"], v=gb.v)]
    for k in (0, 2, 3):
        np.testing.assert_array_equal(port[k], sdev[k])
    np.testing.assert_array_equal(port[1], sdev[1][:, : len(good.edges)])


@pytest.fixture(scope="module")
def giant_dir(tmp_path_factory):
    """Runs of up to ~250 nodes: above a giant threshold of 64."""
    return write_corpus(SynthSpec(n_runs=4, seed=5, eot=30, name="deep"),
                        str(tmp_path_factory.mktemp("sparse_host_giant")))


def test_giant_host_lane_matches_jax_and_the_device_lane(giant_dir):
    from nemo_tpu.graphs.packed import CorpusVocab as JaxVocab
    from nemo_tpu.graphs.packed import pack_graph as jax_pack
    from nemo_tpu.ingest.molly import load_molly_output as jax_load

    tb = _backend(giant_dir, giant_v=64)
    tids = tb._plan_fused_inputs()["tids"]
    ex = TorchExecutor("cpu")
    vocab = JaxVocab()
    runs = jax_load(giant_dir).runs
    graphs = [tb.packed[(r.iteration, c)] for r in runs for c in ("pre", "post")]
    v_g = bucket_size(max(g.n_nodes for g in graphs))
    e_g = bucket_size(max(1, *(len(g.edges) for g in graphs)))
    n_giant = 0
    for run in runs:
        gpre, gpost = tb.packed[(run.iteration, "pre")], tb.packed[(run.iteration, "post")]
        plans = {}
        for cond, g, prov in (("pre", gpre, run.pre_prov), ("post", gpost, run.post_prov)):
            lin, depth, labels = giant_plan(g)
            jlin, jdepth, jlabels = jax_giant_plan(jax_pack(prov, vocab))
            assert (lin, depth) == (jlin, jdepth) and lin == giant_linear(g)
            np.testing.assert_array_equal(labels, jlabels)
            plans[cond] = pad_comp_labels(labels, g.n_nodes, v_g)
        if max(gpre.n_nodes, gpost.n_nodes) <= 64:
            continue
        n_giant += 1
        pre_b = pack_batch([run.iteration], [gpre], v_g, e_g)
        post_b = pack_batch([run.iteration], [gpost], v_g, e_g)
        args = (pre_b, post_b, tids["pre_tid"], tids["post_tid"], tids["num_tables"], plans["pre"], plans["post"])
        port = _wrap_sparse_clean(giant_analysis_host(*args), v_g)
        jax = jax_giant_analysis_host(*args)
        _assert_same(port, jax, 1)
        linear = int(giant_linear(gpre) and giant_linear(gpost))
        sdev = _wrap_sparse_clean(ex.run("sparse_fused", _verb_arrays(pre_b, post_b),
                                         dict(v=v_g, comp_linear=linear, **tids)), v_g)
        _assert_same(port, sdev, 1)
    assert n_giant >= 2
