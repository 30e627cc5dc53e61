"""The host lane: the analysis of a packed run bucket in numpy.

Port of the JAX package's ``ops/sparse_host.py``, a numpy copy.  It is the
exact host mirror of the fused dense step (models/pipeline_model.py:
analysis_step, with_diff=False): condition marking, the clean copy with
@next chain contraction, and the prototype bitsets, computed as flat
edge-list scatters and CSR frontier pushes, O(B * (V + E)) per sweep
instead of the dense kernels' O(B * V^2..V^3).  ``TorchBackend`` routes a
bucket here when its work ``B x (V + E)`` is under the host budget, or
every bucket under ``analysis_impl="sparse"``.

  * The inputs are the packed buckets the device lanes read (the 8 packed
    fields at [B,V]/[B,E]).  Each condition's edge lists are flattened once
    into run-offset node indices (slot + row*V) by :class:`_CondCSR`, and
    every verb reuses that prep.
  * Edges never cross runs, so one flat [B*V] node space batches all runs
    through every scatter and BFS with no per-run Python loop.
  * Every reachability runs to its fix point over a CSR, so no depth bound
    is needed.
  * Component labels: pointer doubling along the member successor when the
    bucket is verified linear, else min-label relaxation to a fix point.
  * Unlike the JAX package's copy, the clean, collapsed adjacency leaves as
    the contracted edge list ``{cond}_clean_src/dst/mask`` [B,K] of the
    sparse device step (ops/sparse_device.py), which the backend wraps in
    ``CsrAdjRows``: the dense [B,V,V] planes are never built on the host.

Reference semantics: markConditionHolds (pre-post-prov.go:220-243),
clean-copy + collapseNextChains (preprocessing.go:17-345), extractProtos
(prototype.go:11-24).
"""

from __future__ import annotations

import numpy as np

from nemo_tpu_torch.graphs.packed import TYPE_ASYNC, TYPE_COLLAPSED, TYPE_NEXT
from nemo_tpu_torch.ops.proto import DEPTH_INF

__all__ = [
    "build_csr",
    "bfs_any",
    "bfs_depths",
    "edge_planes",
    "sparse_analysis_step",
    "synth_ext_host",
]


# --------------------------------------------------------------- CSR helpers


def build_csr(src: np.ndarray, dst: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Edge list -> (indptr [n+1], neighbors) CSR for frontier pushes.
    Duplicate edges are kept (every consumer here has 'any' semantics)."""
    order = np.argsort(src, kind="stable")
    nbr = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, nbr


def _expand(indptr: np.ndarray, nbr: np.ndarray, frontier: np.ndarray, return_counts: bool = False):
    """All CSR neighbors of the frontier nodes (with duplicates): the
    O(frontier edges) push step.  return_counts=True also returns the
    per-frontier-node out-degrees, for callers that pair each expanded edge
    with its source (the Kahn relaxation of ops/diff.py:diff_masks_host)."""
    cnt = indptr[frontier + 1] - indptr[frontier]
    tot = int(cnt.sum())
    if tot == 0:
        empty = np.zeros(0, dtype=np.int64)
        return (empty, cnt) if return_counts else empty
    starts = np.repeat(indptr[frontier], cnt)
    offs = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    targets = nbr[starts + offs]
    return (targets, cnt) if return_counts else targets


def bfs_any(indptr: np.ndarray, nbr: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Nodes reachable from ``start`` (flat bool [n]) in >= 1 hop, to the
    fix point.  Each wave touches only the frontier's edges, so a deep
    narrow graph stays O(E log E) in total."""
    n = len(indptr) - 1
    reach = np.zeros(n, dtype=bool)
    frontier = np.nonzero(start)[0]
    while frontier.size:
        targets = _expand(indptr, nbr, frontier)
        cand = targets[~reach[targets]] if targets.size else targets
        if not cand.size:
            break
        reach[cand] = True
        frontier = np.unique(cand)
    return reach


def bfs_depths(indptr: np.ndarray, nbr: np.ndarray, root: np.ndarray) -> np.ndarray:
    """Shortest hop distance from ``root`` (flat bool [n]); DEPTH_INF where
    unreachable (ops/proto.py:hop_depths semantics, exact)."""
    n = len(indptr) - 1
    depth = np.full(n, DEPTH_INF, dtype=np.int64)
    frontier = np.nonzero(root)[0]
    depth[frontier] = 0
    d = 0
    while frontier.size:
        d += 1
        targets = _expand(indptr, nbr, frontier)
        cand = targets[depth[targets] == DEPTH_INF] if targets.size else targets
        if not cand.size:
            break
        depth[cand] = d
        frontier = np.unique(cand)
    return depth


def edge_planes(src: np.ndarray, dst: np.ndarray, b: int, v: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat run-offset edges (slot + row*V) -> the per-run [B,K] edge planes
    (int32 src, int32 dst, bool mask) of the sparse step's contract, K the
    most edges any run has (at least 1), each run's edges in their order."""
    row = src // v
    order = np.argsort(row, kind="stable")
    row, s, d = row[order], src[order] % v, dst[order] % v
    counts = np.bincount(row, minlength=b)
    k = max(1, int(counts.max()) if len(row) else 1)
    pos = np.arange(len(row), dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    out_src = np.zeros((b, k), dtype=np.int32)
    out_dst = np.zeros((b, k), dtype=np.int32)
    mask = np.zeros((b, k), dtype=bool)
    out_src[row, pos] = s
    out_dst[row, pos] = d
    mask[row, pos] = True
    return out_src, out_dst, mask


# ------------------------------------------------------------ shared prep


class _CondCSR:
    """The flat-scatter prep of ONE condition of a packed run bucket, built
    once per (bucket, condition) and reused by every verb: the [B,E] edge
    planes mask-filtered and offset into the flat [B*V] node space.
    Accepts anything exposing the 8 packed fields."""

    __slots__ = ("b", "v", "n", "is_goal", "node_mask", "table", "type_id", "src", "dst", "goal")

    def __init__(self, batch) -> None:
        self.is_goal = np.asarray(batch.is_goal, dtype=bool)
        self.node_mask = np.asarray(batch.node_mask, dtype=bool)
        self.table = np.asarray(batch.table_id, dtype=np.int64)
        self.type_id = np.asarray(batch.type_id, dtype=np.int64)
        self.b, self.v = self.is_goal.shape
        self.n = self.b * self.v
        em = np.asarray(batch.edge_mask, dtype=bool).ravel()
        src = np.asarray(batch.edge_src, dtype=np.int64).ravel()
        dst = np.asarray(batch.edge_dst, dtype=np.int64).ravel()
        e = src.shape[0] // self.b if self.b else 0
        base = np.repeat(np.arange(self.b, dtype=np.int64) * self.v, e)
        self.src = (base + src)[em]
        self.dst = (base + dst)[em]
        self.goal = self.is_goal & self.node_mask

    def scat_any(self, at: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """[B,V] bool: any True ``vals`` scattered to flat node index ``at``
        (a bincount, far faster than ufunc.at)."""
        return np.bincount(at[vals], minlength=self.n).reshape(self.b, self.v) > 0


# ----------------------------------------------------------------- verbs


def _condition_holds(csr: _CondCSR, tid: int, num_tables: int) -> np.ndarray:
    """Batched mirror of ops/condition.py:mark_condition_holds."""
    goal, table = csr.goal, csr.table
    indeg = csr.scat_any(csr.dst, np.ones(len(csr.dst), dtype=bool))
    root = goal & (table == tid) & ~indeg
    rule = csr.scat_any(csr.dst, root.ravel()[csr.src]) & ~csr.is_goal & csr.node_mask & (table == tid)
    trig = csr.scat_any(csr.dst, rule.ravel()[csr.src]) & csr.is_goal & csr.node_mask
    any_trig = trig.any(axis=-1, keepdims=True)
    # Per-run table bitset of the triggered goals (clip + table>=0 guard).
    tclip = np.clip(table, 0, num_tables - 1)
    tvalid = table >= 0
    rows = np.broadcast_to(np.arange(csr.b)[:, None], table.shape)
    sel = trig & tvalid
    trig_tables = (
        np.bincount(rows[sel] * num_tables + tclip[sel], minlength=csr.b * num_tables).reshape(csr.b, num_tables)
        > 0
    )
    in_trig_table = np.take_along_axis(trig_tables, tclip, axis=-1) & tvalid
    return goal & any_trig & ((table == tid) | in_trig_table)


def _component_labels(csr: _CondCSR, member: np.ndarray, ks: np.ndarray, kd: np.ndarray, linear: bool) -> np.ndarray:
    """Within-row component ids [B,V] of the member subgraph over the kept
    member edges; ``v`` for non-members.  The labels only group: the
    representative is re-derived as the min head index.  linear=True (the
    bucket is verified linear): pointer doubling along the unique member
    successor, O(V log V).  Otherwise min-label relaxation to a fix point
    over the undirected member edges, exact for any member structure."""
    b, v, n = csr.b, csr.v, csr.n
    member_f = member.ravel()
    m_edge = member_f[ks] & member_f[kd]
    ms, md = ks[m_edge], kd[m_edge]
    if linear:
        p = np.arange(n, dtype=np.int64)
        p[ms] = md  # <=1 member successor per member (verified linear)
        for _ in range(max(1, (v - 1).bit_length())):
            p = p[p]
        return np.where(member_f, p % v, v).reshape(b, v)
    lab = np.where(member_f, np.tile(np.arange(v, dtype=np.int64), b), v)
    while ms.size:
        before = lab.copy()
        np.minimum.at(lab, md, lab[ms])
        np.minimum.at(lab, ms, lab[md])
        if np.array_equal(lab, before):
            break
    return lab.reshape(b, v)


def _simplify(csr: _CondCSR, linear: bool):
    """Batched mirror of clean_masks + collapse_chains.  Returns (alive_new
    [B,V], type_new [B,V], (new_src, new_dst) the flat contracted edges)."""
    b, v, n = csr.b, csr.v, csr.n
    goal = csr.goal
    goal_f = goal.ravel()

    # --- clean-copy restriction (ops/simplify.py:clean_masks)
    has_in_goal = csr.scat_any(csr.dst, goal_f[csr.src])
    has_out_goal = csr.scat_any(csr.src, goal_f[csr.dst])
    is_rule = ~csr.is_goal & csr.node_mask
    alive = goal | (is_rule & has_in_goal & has_out_goal)
    alive_f = alive.ravel()
    keep = np.where(goal_f[csr.src], has_out_goal.ravel()[csr.dst], has_in_goal.ravel()[csr.src])
    keep &= alive_f[csr.src] & alive_f[csr.dst]
    ks, kd = csr.src[keep], csr.dst[keep]

    # --- chain contraction (ops/simplify.py:collapse_chains)
    next_rule = is_rule & alive & (csr.type_id == TYPE_NEXT)
    nr_f = next_rule.ravel()
    in_from_next = csr.scat_any(kd, nr_f[ks])
    out_to_next = csr.scat_any(ks, nr_f[kd])
    member = next_rule | (goal & alive & in_from_next & out_to_next)
    member_f = member.ravel()

    lab = _component_labels(csr, member, ks, kd, linear)
    lab_c = np.clip(lab, 0, v - 1).ravel()

    in_from_member = csr.scat_any(kd, member_f[ks])
    out_to_member = csr.scat_any(ks, member_f[kd])
    head = next_rule & ~in_from_member
    tail = next_rule & ~out_to_member

    row_base = np.repeat(np.arange(b, dtype=np.int64) * v, v)
    idx_within = np.tile(np.arange(v, dtype=np.int64), b)
    comp_key = row_base + lab_c  # flat (row, component) slot

    rep_per_comp = np.full(n, v, dtype=np.int64)
    hm = head.ravel()  # head rules are members by construction
    np.minimum.at(rep_per_comp, comp_key[hm], idx_within[hm])
    n_rules_per_comp = np.bincount(comp_key[nr_f], minlength=n)
    collapsible_comp = (n_rules_per_comp >= 2) & (rep_per_comp < v)

    node_collapsible = member_f & collapsible_comp[comp_key]
    rep_of_node = np.where(node_collapsible, rep_per_comp[comp_key], idx_within)
    rep_flat = row_base + rep_of_node
    is_rep = node_collapsible & (idx_within == rep_of_node)
    dies = node_collapsible & ~is_rep
    ext_goal_f = goal_f & alive_f & ~member_f

    survive = ~node_collapsible[ks] & ~node_collapsible[kd]
    head_c = hm & node_collapsible
    tail_c = tail.ravel() & node_collapsible
    pred_sel = ext_goal_f[ks] & head_c[kd]
    succ_sel = tail_c[ks] & ext_goal_f[kd]
    new_src = np.concatenate([ks[survive], ks[pred_sel], rep_flat[ks[succ_sel]]])
    new_dst = np.concatenate([kd[survive], rep_flat[kd[pred_sel]], kd[succ_sel]])

    alive_new = alive & ~dies.reshape(b, v)
    type_new = np.where(is_rep.reshape(b, v), TYPE_COLLAPSED, csr.type_id).astype(np.int32)
    return alive_new, type_new, (new_src, new_dst)


def _proto(csr: _CondCSR, alive2: np.ndarray, edges: tuple[np.ndarray, np.ndarray], achieved: np.ndarray,
           num_tables: int):
    """Batched mirror of proto_rule_bits + all_rule_bits over the contracted
    consequent.  Returns (bits [B,T], min_depth [B,T] int32, present [B,T])."""
    b, v, n = csr.b, csr.v, csr.n
    alive_f = alive2.ravel()
    asrc, adst = edges
    ok = alive_f[asrc] & alive_f[adst]
    asrc, adst = asrc[ok], adst[ok]
    fwd = build_csr(asrc, adst, n)
    bwd = build_csr(adst, asrc, n)

    indeg = np.zeros(n, dtype=bool)
    indeg[adst] = True
    is_goal_f = csr.is_goal.ravel()
    root = is_goal_f & alive_f & ~indeg
    is_rule = ~is_goal_f & alive_f
    reach = bfs_any(*fwd, root)
    rule_desc = bfs_any(*bwd, is_rule)
    rule_anc = bfs_any(*fwd, is_rule & reach)
    achieved_f = np.repeat(np.asarray(achieved, dtype=bool), v)
    qualify = is_rule & reach & (rule_desc | rule_anc) & achieved_f

    depth = bfs_depths(*fwd, root)
    rule_depth = (depth + 1) // 2  # hops alternate goal/rule

    table_f = csr.table.ravel()
    rows = np.arange(n, dtype=np.int64) // v
    tclip = np.clip(table_f, 0, num_tables - 1)

    def table_bitset(mask: np.ndarray) -> np.ndarray:
        sel = mask & (table_f >= 0)
        return np.bincount(rows[sel] * num_tables + tclip[sel], minlength=b * num_tables).reshape(b, num_tables) > 0

    bits = table_bitset(qualify)
    present = table_bitset(is_rule)
    min_depth = np.full(b * num_tables, DEPTH_INF, dtype=np.int64)
    qsel = qualify & (table_f >= 0)
    np.minimum.at(min_depth, rows[qsel] * num_tables + tclip[qsel], rule_depth[qsel])
    return bits, min_depth.reshape(b, num_tables).astype(np.int32), present


# ------------------------------------------------------------- synthesis


def synth_ext_host(batch, holds: np.ndarray, num_tables: int) -> np.ndarray:
    """Host twin of the ``synth_ext`` verb (ops/sparse_device.py:
    synth_ext_candidates): per-run extension-candidate table bitsets [B,T],
    the async rules adjacent to the antecedent's condition boundary
    (extensions.go:63-67), for every run of a packed bucket in one pass.
    ``holds`` is the fused step's [B,V] pre_holds output."""
    csr = _CondCSR(batch)
    b, v, n = csr.b, csr.v, csr.n
    holds_f = np.asarray(holds, dtype=bool).ravel()
    goal_f = csr.goal.ravel()
    g_hold = goal_f & holds_f
    g_nohold = goal_f & ~holds_f
    nongoal = (~csr.is_goal & csr.node_mask).ravel()

    has_nongoal_child = csr.scat_any(csr.src, nongoal[csr.dst]).ravel()
    qual_child = g_nohold & has_nongoal_child
    holding_parent = csr.scat_any(csr.dst, g_hold[csr.src]).ravel()
    nonhold_parent = csr.scat_any(csr.dst, g_nohold[csr.src]).ravel()
    has_qual_child = csr.scat_any(csr.src, qual_child[csr.dst]).ravel()

    cand = nongoal & (csr.type_id.ravel() == TYPE_ASYNC) & ((holding_parent & has_qual_child) | nonhold_parent)
    table_f = csr.table.ravel()
    rows = np.arange(n, dtype=np.int64) // v
    tclip = np.clip(table_f, 0, num_tables - 1)
    sel = cand & (table_f >= 0)
    return np.bincount(rows[sel] * num_tables + tclip[sel], minlength=b * num_tables).reshape(b, num_tables) > 0


# ------------------------------------------------------------- fused step


def sparse_analysis_step(pre, post, v: int, pre_tid: int, post_tid: int, num_tables: int,
                         comp_linear: bool = False) -> dict[str, np.ndarray]:
    """Exact host mirror of analysis_step(with_diff=False) for one packed
    (pre, post) run bucket: the summary keys, shapes and values of the
    sparse device step (ops/sparse_device.py:sparse_device_step), the clean
    adjacencies as contracted edge planes ``{cond}_clean_src/dst/mask``.
    ``comp_linear`` is the bucket's verified linearity flag (the
    pointer-doubling component labels).  The differential tail is not
    mirrored: the backend diffs in its own pass (ops/diff.py)."""
    out: dict[str, np.ndarray] = {}
    post_ctx = None
    for name, batch, tid in (("pre", pre, pre_tid), ("post", post, post_tid)):
        csr = _CondCSR(batch)
        if csr.v != v:
            raise ValueError(f"batch V={csr.v} != static v={v}")
        out[f"{name}_holds"] = _condition_holds(csr, tid, num_tables)
        alive2, type_new, coll_edges = _simplify(csr, comp_linear)
        (out[f"{name}_clean_src"], out[f"{name}_clean_dst"],
         out[f"{name}_clean_mask"]) = edge_planes(*coll_edges, csr.b, v)
        out[f"{name}_alive"] = alive2
        out[f"{name}_type"] = type_new
        if name == "post":
            post_ctx = (csr, alive2, coll_edges)
    achieved = out["pre_holds"].any(axis=-1)
    out["achieved_pre"] = achieved

    csr_p, alive2_p, coll_p = post_ctx
    bits, min_depth, present = _proto(csr_p, alive2_p, coll_p, achieved, num_tables)
    out["proto_bits"] = bits
    out["proto_min_depth"] = min_depth
    out["proto_present"] = present
    # Cross-run reductions (ops/proto.py:reduce_protos semantics).
    masked = bits & achieved[:, None]
    out["proto_inter"] = np.all(masked | ~achieved[:, None], axis=0) & achieved.any()
    out["proto_union"] = np.any(masked, axis=0)
    return out
