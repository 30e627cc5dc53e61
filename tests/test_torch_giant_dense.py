"""The port's dense node-sharded giant step (parallel/giant.py:
giant_analysis_step) and the ops it needs, against the JAX package, on the
CPU.

  * ops: collapse_chains with given labels and the scatter rewire (beside
    doubling and the closure labels), and proto_rule_bits(use_closure=False)
    (set-BFS), against the JAX ops on the same packed batches;
  * giant_analysis_step, key by key, against JAX's giant_analysis_step and
    against the port's giant_analysis_host (its contracted edge lists
    densified), in every label mode (doubling, host, closure), on the
    paritychain (seed 9, eot 50) and deep (seed 5, eot 60) corpora and on a
    hand-built merge of two chain heads whose rewire crosses ranks, on node
    meshes of 1 (this process, outside any group: one code path with the
    wider meshes, its collectives the identity), 2 and 4 ranks (spawned
    gloo worlds of the port, tests/torch_world.py).
Every output is bool or int: exact.
"""

import numpy as np
import pytest
import torch

from nemo_tpu.graphs.packed import CorpusVocab, bucket_size, pack_batch, pack_graph
from nemo_tpu.ingest.molly import load_molly_output
from nemo_tpu.models.pipeline_model import BatchArrays as JBA
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.ops import adjacency as jadj
from nemo_tpu.ops import proto as jproto
from nemo_tpu.ops import simplify as jsimp
from nemo_tpu.parallel.giant import giant_analysis_step as jax_giant_step
from nemo_tpu.parallel.giant import giant_plan, pad_comp_labels
from nemo_tpu.parallel.mesh import make_node_mesh
from nemo_tpu_torch.models.pipeline_model import batch_from_numpy
from nemo_tpu_torch.ops import adjacency as tadj
from nemo_tpu_torch.ops import proto as tproto
from nemo_tpu_torch.ops import simplify as tsimp
from nemo_tpu_torch.ops.sparse_device import CsrAdjRows
from nemo_tpu_torch.parallel.giant import giant_analysis_host

from torch_world import Worlds
from torch_world import giant as giant_task

FIELDS = JBA.FIELDS
CORPORA = {"paritychain": (9, 50), "deep": (5, 60)}
MODES = ("doubling", "host", "closure")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    w = Worlds()
    yield w
    w.close()


@pytest.fixture(scope="module")
def giant_cases(tmp_path_factory) -> dict:
    """corpus -> [one case a run]: the packed B=1 planes, giant_plan's
    outputs, the statics."""
    root = str(tmp_path_factory.mktemp("giant_dense"))
    out = {}
    for name, (seed, eot) in CORPORA.items():
        molly = load_molly_output(write_corpus(SynthSpec(n_runs=2, seed=seed, eot=eot, name=name), root))
        vocab = CorpusVocab()
        cases = []
        for run in molly.runs:
            gpre, gpost = pack_graph(run.pre_prov, vocab), pack_graph(run.post_prov, vocab)
            v = bucket_size(max(gpre.n_nodes, gpost.n_nodes))
            e = bucket_size(max(1, len(gpre.edges), len(gpost.edges)))
            pre_b, post_b = pack_batch([run.iteration], [gpre], v, e), pack_batch([run.iteration], [gpost], v, e)
            lin_pre, d_pre, lab_pre = giant_plan(gpre)
            lin_post, d_post, lab_post = giant_plan(gpost)
            cases.append(dict(
                pre={f: getattr(pre_b, f) for f in FIELDS}, post={f: getattr(post_b, f) for f in FIELDS},
                pre_b=pre_b, post_b=post_b, linear=lin_pre and lin_post,
                labels=(pad_comp_labels(lab_pre, gpre.n_nodes, v), pad_comp_labels(lab_post, gpost.n_nodes, v)),
                kw=dict(v=v, pre_tid=vocab.tables.lookup("pre"), post_tid=vocab.tables.lookup("post"),
                        num_tables=bucket_size(len(vocab.tables), 8),
                        max_depth=max(pre_b.max_depth, post_b.max_depth), proto_depth=max(d_pre, d_post)),
            ))
        out[name] = cases
    out["merge"] = [_merge_case()]
    return out


def _merge_case() -> dict:
    """Two @next chain heads merging into one component, the heads in
    different column blocks of a node mesh of 2 or 4 (slots 4 and 8 of
    V = 16): the scatter rewire moves the second head's goal edge onto the
    representative's column, across ranks."""
    from nemo_tpu.graphs.packed import TYPE_NEXT

    v, e = 16, 8
    # goals gA=0, gB=1, gC=2, m=3; rules h1=4, t=5, two idle rules, h2=8.
    edges = [(0, 4), (4, 3), (2, 8), (8, 3), (3, 5), (5, 1)]
    planes = {
        "edge_src": np.zeros((1, e), np.int32), "edge_dst": np.zeros((1, e), np.int32),
        "edge_mask": np.zeros((1, e), bool), "is_goal": np.zeros((1, v), bool),
        "table_id": np.full((1, v), -1, np.int32), "label_id": np.full((1, v), -1, np.int32),
        "type_id": np.zeros((1, v), np.int32), "node_mask": np.zeros((1, v), bool),
    }
    for k, (a, b) in enumerate(edges):
        planes["edge_src"][0, k], planes["edge_dst"][0, k], planes["edge_mask"][0, k] = a, b, True
    planes["is_goal"][0, :4] = planes["node_mask"][0, :9] = True
    planes["table_id"][0, :9] = [0, 1, 0, 2, 3, 3, 4, 4, 3]
    planes["label_id"][0, :9] = np.arange(9)
    planes["type_id"][0, [4, 5, 8]] = TYPE_NEXT
    labels = np.full((1, v), v, np.int32)
    labels[0, [3, 4, 5, 8]] = 3
    return dict(pre=planes, post={k: a.copy() for k, a in planes.items()}, pre_b=None, post_b=None, linear=False,
                labels=(labels, labels.copy()),
                kw=dict(v=v, pre_tid=0, post_tid=1, num_tables=8, max_depth=8, proto_depth=8))


def _mode_kw(case: dict, mode: str) -> dict:
    kw = dict(case["kw"], comp_linear=mode == "doubling")
    if mode == "host":
        kw.update(pre_labels=case["labels"][0], post_labels=case["labels"][1])
    return kw


def _jax_step(case: dict, mode: str) -> dict:
    """JAX's giant_analysis_step on a one-device node mesh (its outputs are
    the same on any mesh; one device compiles fastest)."""
    pre = JBA(*(case["pre"][f] for f in FIELDS))
    post = JBA(*(case["post"][f] for f in FIELDS))
    out = jax_giant_step(pre, post, mesh=make_node_mesh(1), **_mode_kw(case, mode))
    return {k: np.asarray(v) for k, v in out.items()}


def _host(case: dict) -> dict:
    kw = case["kw"]
    out = giant_analysis_host(case["pre_b"], case["post_b"], kw["pre_tid"], kw["post_tid"], kw["num_tables"],
                              *case["labels"])
    for c in ("pre", "post"):
        src, dst, mask = (out.pop(f"{c}_clean_{k}") for k in ("src", "dst", "mask"))
        out[f"{c}_adj_clean"] = CsrAdjRows(src, dst, mask, v=kw["v"])[np.array([0])]
    return out


def _same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{what}: {k}")


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("corpus", sorted(CORPORA) + ["merge"])
def test_giant_step_matches_jax_and_host(worlds, giant_cases, corpus, width):
    for i, case in enumerate(giant_cases[corpus]):
        host = _host(case) if case["pre_b"] is not None else None
        for mode in MODES:
            if mode == "doubling" and not case["linear"]:
                continue
            want = _jax_step(case, mode)
            if host is not None:
                _same(host, want, f"{corpus} run {i}: host lane vs JAX ({mode})")
            if width == 1:
                ranks = [giant_task(case["pre"], case["post"], _mode_kw(case, mode))]
            else:
                ranks = worlds[width].run("giant", case["pre"], case["post"], _mode_kw(case, mode))
            for rank, got in enumerate(ranks):
                assert got.pop("mesh_size", 1) == width
                _same(got, want, f"{corpus} run {i}, {mode}, width {width}, rank {rank}")


@pytest.fixture(scope="module")
def batch(giant_cases):
    """A packed multi-run batch of the synthetic chains, with giant_plan's
    labels per run: [B,V] planes for the JAX and the port ops."""
    cases = giant_cases["deep"] + giant_cases["paritychain"]
    v = max(c["kw"]["v"] for c in cases)
    e = max(c["post"]["edge_src"].shape[1] for c in cases)

    def pad(a: np.ndarray, width: int, fill: int = 0) -> np.ndarray:
        return np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=fill)

    post = {f: np.concatenate([pad(c["post"][f], e if f.startswith("edge_") else v) for c in cases])
            for f in FIELDS}
    # giant_plan's sentinel (the run's V) becomes the batch's V.
    labels = np.concatenate([pad(np.where(c["labels"][1] >= c["kw"]["v"], v, c["labels"][1]), v, v) for c in cases])
    return post, v, labels, max(c["kw"]["proto_depth"] for c in cases), cases[0]["kw"]["num_tables"]


def _adj_both(pre: dict, v: int):
    j = jadj.build_adjacency(pre["edge_src"], pre["edge_dst"], pre["edge_mask"], v)
    t = tadj.build_adjacency(*(torch.from_numpy(pre[k]) for k in ("edge_src", "edge_dst", "edge_mask")), v)
    return j, t


@pytest.mark.parametrize("labels_mode", ["given", "doubling", "closure"])
@pytest.mark.parametrize("rewire", ["matmul", "scatter"])
def test_collapse_chains_matches_jax(batch, labels_mode, rewire):
    pre, v, labels, _, _ = batch
    j_adj, t_adj = _adj_both(pre, v)
    T = {k: torch.from_numpy(pre[k]) for k in ("is_goal", "node_mask", "type_id")}
    j_clean, j_alive = jsimp.clean_masks(j_adj, pre["is_goal"], pre["node_mask"])
    t_clean, t_alive = tsimp.clean_masks(t_adj, T["is_goal"], T["node_mask"])
    kw_j = dict(rewire=rewire, comp_doubling=labels_mode == "doubling",
                comp_labels=labels if labels_mode == "given" else None)
    kw_t = dict(rewire=rewire, comp_doubling=labels_mode == "doubling",
                comp_labels=torch.from_numpy(labels) if labels_mode == "given" else None)
    want = jsimp.collapse_chains(j_clean, pre["is_goal"], pre["type_id"], j_alive, **kw_j)
    got = tsimp.collapse_chains(t_clean, T["is_goal"], T["type_id"], t_alive, **kw_t)
    for name, g, w in zip(("adj", "alive", "type"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{labels_mode}/{rewire}: {name}")
    with pytest.raises(ValueError):
        tsimp.collapse_chains(t_clean, T["is_goal"], T["type_id"], t_alive, rewire="gather")


@pytest.mark.parametrize("use_closure", [True, False])
def test_proto_rule_bits_set_bfs_matches_jax(batch, use_closure):
    pre, v, labels, depth, num_tables = batch
    j_adj, t_adj = _adj_both(pre, v)
    b = pre["is_goal"].shape[0]
    achieved = np.arange(b) % 2 == 0
    j_clean, j_alive = jsimp.clean_masks(j_adj, pre["is_goal"], pre["node_mask"])
    j_adj2, j_alive2, _ = jsimp.collapse_chains(j_clean, pre["is_goal"], pre["type_id"], j_alive, comp_labels=labels,
                                                rewire="scatter")
    want = jproto.proto_rule_bits(j_adj2, pre["is_goal"], j_alive2, pre["table_id"], achieved, num_tables, depth,
                                  closure_impl="xla", use_closure=use_closure)
    got = tproto.proto_rule_bits(torch.from_numpy(np.array(j_adj2)), torch.from_numpy(pre["is_goal"]),
                                 torch.from_numpy(np.array(j_alive2)), torch.from_numpy(pre["table_id"]),
                                 torch.from_numpy(achieved), num_tables, depth, use_closure=use_closure)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    reach_j = jproto._bfs_reach(pre["is_goal"], np.array(j_adj2), depth, backward=True)
    reach_t = tproto._bfs_reach(torch.from_numpy(pre["is_goal"]), torch.from_numpy(np.array(j_adj2)), depth,
                                backward=True)
    np.testing.assert_array_equal(reach_t.numpy(), np.asarray(reach_j))
