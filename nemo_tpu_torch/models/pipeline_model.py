"""The fused analysis step over a run batch.

Given the packed pre/post provenance batches of B fault-injection runs (both
padded to one bucket), ``analysis_step`` computes what the per-run Cypher
pipeline of the reference produces (main.go:106-180): condition marking for
both conditions, clean-copy + @next chain contraction, prototype bitsets with
cross-run intersection/union reductions and, with ``with_diff``, the
differential provenance of every run against the successful run in row 0.
Port of the JAX package's ``models/pipeline_model.py``: same inputs, same
output keys, same values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from nemo_tpu_torch.device import resolve_device
from nemo_tpu_torch.graphs.packed import CorpusVocab, bucket_size, pack_batch, pack_graph
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.ops.adjacency import build_adjacency
from nemo_tpu_torch.ops.condition import mark_condition_holds
from nemo_tpu_torch.ops.diff import diff_masks
from nemo_tpu_torch.ops.proto import all_rule_bits, proto_rule_bits, reduce_protos
from nemo_tpu_torch.ops.simplify import clean_masks, collapse_chains, pair_chains_linear


@dataclass
class BatchArrays:
    """Device tensors for one condition's run batch."""

    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    is_goal: torch.Tensor
    table_id: torch.Tensor
    label_id: torch.Tensor
    type_id: torch.Tensor
    node_mask: torch.Tensor

    # Field-name tuple for generic row slicing/padding (not a dataclass
    # field: no annotation).
    FIELDS = (
        "edge_src",
        "edge_dst",
        "edge_mask",
        "is_goal",
        "table_id",
        "label_id",
        "type_id",
        "node_mask",
    )

    @classmethod
    def from_packed(cls, batch, device=None) -> "BatchArrays":
        return batch_from_numpy({f: getattr(batch, f) for f in cls.FIELDS}, device)


def batch_from_numpy(fields: dict[str, np.ndarray], device=None) -> BatchArrays:
    """The JAX package's packed batch planes, as numpy, -> the port's
    BatchArrays on ``device`` (None = cuda).  dtypes are kept: bool planes
    stay bool, integer planes keep their width (widen_batch widens them).
    The planes are copied: the batch never aliases the caller's arrays."""
    dev = resolve_device(device)
    return BatchArrays(
        **{f: torch.from_numpy(np.array(fields[f])).to(dev) for f in BatchArrays.FIELDS}
    )


# The bool summary outputs folded into one bit-packed device->host transfer
# under pack_out=True, in pack order; the shape key resolves with b=batch,
# v=nodes, t=num_tables (unpack_summary is the inverse).
SUMMARY_PACK_LAYOUT = (
    ("pre_holds", "bv"),
    ("post_holds", "bv"),
    ("achieved_pre", "b"),
    ("proto_bits", "bt"),
    ("proto_present", "bt"),
    ("proto_inter", "t"),
    ("proto_union", "t"),
)

# The diff-tail bool outputs appended to the folded transfer when
# with_diff=True (all [B,V]).
DIFF_PACK_LAYOUT = (
    ("diff_node_keep", "bv"),
    ("diff_frontier_rule", "bv"),
    ("diff_missing_goal", "bv"),
)

# The giant verb's folded layout (parallel/giant.py): its output set has no
# proto_inter/proto_union; the backend merges a giant's prototype bitsets
# with the buckets' host-side.
GIANT_PACK_LAYOUT = (
    ("pre_holds", "bv"),
    ("post_holds", "bv"),
    ("achieved_pre", "b"),
    ("proto_bits", "bt"),
    ("proto_present", "bt"),
)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """A flat bool tensor -> uint8 bytes, most significant bit first, the
    last byte zero-padded: ``jnp.packbits``/``np.packbits`` order
    ([1,0,0,0,0,0,0,1] -> 129)."""
    flat = bits.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=flat.device)
    return (flat.reshape(-1, 8) * weights).sum(dim=-1, dtype=torch.uint8)


def fold_packed_summary(out: dict, layout) -> None:
    """Replace `layout`'s bool outputs in `out` with one bit-packed
    "packed_summary" vector, in place."""
    out["packed_summary"] = packbits(torch.cat([out.pop(name).reshape(-1) for name, _ in layout]))


def unpack_summary(
    packed: np.ndarray, b: int, v: int, t: int, with_diff: bool = False, giant: bool = False
) -> dict[str, np.ndarray]:
    """Inverse of the pack_out folding (SUMMARY_PACK_LAYOUT +
    DIFF_PACK_LAYOUT, or GIANT_PACK_LAYOUT for the giant verb): one host
    np.unpackbits + views."""
    if giant:
        layout = GIANT_PACK_LAYOUT
    else:
        layout = SUMMARY_PACK_LAYOUT + (DIFF_PACK_LAYOUT if with_diff else ())
    dims = {"bv": (b, v), "b": (b,), "bt": (b, t), "t": (t,)}
    flat = np.unpackbits(np.asarray(packed)).astype(bool)
    out: dict[str, np.ndarray] = {}
    ofs = 0
    for name, key in layout:
        shape = dims[key]
        n = int(np.prod(shape))
        out[name] = flat[ofs : ofs + n].reshape(shape)
        ofs += n
    return out


def widen_batch(ba: BatchArrays) -> BatchArrays:
    """Cast narrow integer planes (int8/int16, as a dispatch boundary may
    ship them) back to int32."""

    def w(a):
        return a.to(torch.int32) if a.dtype in (torch.int8, torch.int16) else a

    return dataclasses.replace(
        ba,
        edge_src=w(ba.edge_src),
        edge_dst=w(ba.edge_dst),
        table_id=w(ba.table_id),
        label_id=w(ba.label_id),
        type_id=w(ba.type_id),
    )


def analysis_step(
    pre: BatchArrays,
    post: BatchArrays,
    v: int,
    pre_tid: int,
    post_tid: int,
    num_tables: int,
    num_labels: int,
    max_depth: int,
    with_diff: bool = True,
    comp_linear: bool = False,
    pack_out: bool = False,
) -> dict[str, torch.Tensor]:
    """The fused pipeline for one run batch; every output stays on the
    batch's device.

    with_diff=False drops the differential-provenance tail (diff vs batch
    row 0): the backend runs diff as its own good-run-anchored dispatch.

    comp_linear=True (caller-VERIFIED via ops.simplify.chains_linear_host)
    labels chain components by pointer doubling instead of closures.

    pack_out=True replaces the bool summary outputs (and the diff tail's,
    when with_diff) with one bit-packed "packed_summary" uint8 vector
    (SUMMARY_PACK_LAYOUT / DIFF_PACK_LAYOUT): one device->host copy."""
    pre = widen_batch(pre)
    post = widen_batch(post)
    adj_pre = build_adjacency(pre.edge_src, pre.edge_dst, pre.edge_mask, v)
    adj_post = build_adjacency(post.edge_src, post.edge_dst, post.edge_mask, v)

    # Condition marking (pre-post-prov.go:218-244).
    pre_holds = mark_condition_holds(
        adj_pre, pre.is_goal, pre.table_id, pre.node_mask, pre_tid, num_tables
    )
    post_holds = mark_condition_holds(
        adj_post, post.is_goal, post.table_id, post.node_mask, post_tid, num_tables
    )
    achieved_pre = pre_holds.any(dim=-1)

    # Simplification of both conditions (preprocessing.go:351-387).
    pre_clean, pre_alive = clean_masks(adj_pre, pre.is_goal, pre.node_mask)
    pre_adj2, pre_alive2, pre_type2 = collapse_chains(
        pre_clean, pre.is_goal, pre.type_id, pre_alive, comp_doubling=comp_linear
    )
    post_clean, post_alive = clean_masks(adj_post, post.is_goal, post.node_mask)
    post_adj2, post_alive2, post_type2 = collapse_chains(
        post_clean, post.is_goal, post.type_id, post_alive, comp_doubling=comp_linear
    )

    # Prototypes over the simplified consequent (prototype.go:11-130).
    bits, min_depth = proto_rule_bits(
        post_adj2,
        post.is_goal,
        post_alive2,
        post.table_id,
        achieved_pre,
        num_tables,
        max_depth,
    )
    present = all_rule_bits(post.is_goal, post_alive2, post.table_id, num_tables)
    inter, union = reduce_protos(bits, achieved_pre)

    out = {
        "pre_holds": pre_holds,
        "post_holds": post_holds,
        "achieved_pre": achieved_pre,
        "pre_adj_clean": pre_adj2,
        "pre_alive": pre_alive2,
        "pre_type": pre_type2,
        "post_adj_clean": post_adj2,
        "post_alive": post_alive2,
        "post_type": post_type2,
        "proto_bits": bits,
        "proto_min_depth": min_depth,
        "proto_present": present,
        "proto_inter": inter,
        "proto_union": union,
    }
    if with_diff:
        # Differential provenance of every run vs the successful run in row
        # 0 (differential-provenance.go:18-243).  Label bitsets per run.
        lid = post.label_id.clamp(0, num_labels - 1).long()
        sel = post.is_goal & post.node_mask & (post.label_id >= 0)
        run_bits = torch.zeros(lid.shape[0], num_labels, dtype=torch.int32, device=lid.device)
        run_bits = run_bits.scatter_add_(1, lid, sel.to(torch.int32)) > 0
        node_keep, _edge_keep, frontier_rule, missing_goal = diff_masks(
            adj_post[0],
            post.is_goal[0],
            post.node_mask[0],
            post.label_id[0],
            run_bits,
            max_depth,
        )
        out["diff_node_keep"] = node_keep
        out["diff_frontier_rule"] = frontier_rule
        out["diff_missing_goal"] = missing_goal
    if pack_out:
        fold_packed_summary(out, SUMMARY_PACK_LAYOUT + (DIFF_PACK_LAYOUT if with_diff else ()))
    return out


def graphs_to_step(
    run_ids: list[int], pre_graphs: list, post_graphs: list, vocab: CorpusVocab, device=None
) -> tuple[BatchArrays, BatchArrays, dict]:
    """Common tail of every pack path: one shared (V, E) bucket over both
    conditions, two packed batches on ``device``, and analysis_step's
    static kwargs."""
    v = bucket_size(max(g.n_nodes for g in pre_graphs + post_graphs))
    e = bucket_size(max(max(len(g.edges) for g in pre_graphs + post_graphs), 1))
    pre_b = pack_batch(run_ids, pre_graphs, v, e)
    post_b = pack_batch(run_ids, post_graphs, v, e)
    static = dict(
        v=v,
        pre_tid=vocab.tables.lookup("pre"),
        post_tid=vocab.tables.lookup("post"),
        num_tables=bucket_size(len(vocab.tables), 8),
        num_labels=bucket_size(max(1, len(vocab.labels)), 8),
        # Static trip count for the depth loops: the batch's longest DAG
        # path (+1 margin), rounded up (packed.py:longest_path_len).
        max_depth=bucket_size(max(pre_b.max_depth, post_b.max_depth), 4),
        # Host-verified linear-chain flag: selects pointer-doubling labels.
        comp_linear=pair_chains_linear(pre_b, post_b),
    )
    return BatchArrays.from_packed(pre_b, device), BatchArrays.from_packed(post_b, device), static


def pack_molly_for_step(
    molly: MollyOutput, vocab: CorpusVocab | None = None, device=None
) -> tuple[BatchArrays, BatchArrays, dict]:
    """Pack a whole corpus into one common-bucket pre batch + post batch,
    returning (pre, post, static_kwargs) ready for analysis_step."""
    vocab = vocab or CorpusVocab()
    run_ids = [r.iteration for r in molly.runs]
    pre_graphs = [pack_graph(r.pre_prov, vocab) for r in molly.runs]
    post_graphs = [pack_graph(r.post_prov, vocab) for r in molly.runs]
    return graphs_to_step(run_ids, pre_graphs, post_graphs, vocab, device)


def synth_batch_arrays(
    n_runs: int, seed: int = 0, eot: int = 6, device=None
) -> tuple[BatchArrays, BatchArrays, dict]:
    """Synthetic corpus -> step inputs, for benchmarks and checks."""
    import tempfile

    from nemo_tpu_torch.ingest.molly import load_molly_output
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    with tempfile.TemporaryDirectory() as d:
        corpus = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, eot=eot), d)
        return pack_molly_for_step(load_molly_output(corpus), device=device)
