"""The sparse-CSR device tier: gather/scatter waves over packed [B,E] edges.

Port of the JAX package's ``ops/sparse_device.py``.  The dense tier
(``models/pipeline_model.py``) materializes a [B,V,V] adjacency per bucket;
this tier computes the same analysis over the packed edge planes — [B,V]
node planes and [B,E] (src, dst, mask) edge planes — in O(B*(V+E)) device
memory, which is what keeps giant-V runs and buckets past the dense memory
watermark on the card:

  * every push is one gather by edge source plus one scatter to edge
    destinations (``scatter_add_`` / ``scatter_reduce_``), O(B*E);
  * reachability (``_reach_any``) runs to its fix point inside one launch
    of kernel K2 (``kernels/edge_wave.py``), with no host sync per wave;
  * the three other fix-point loops (BFS depths, component-label
    relaxation, the diff's max-plus longest path) stay plain torch and stop
    on a host-side convergence check every ``_CHECK_EVERY`` iterations —
    exact, because iterations past a fix point change nothing;
  * the clean, collapsed adjacency leaves as a contracted edge list ([B,E]
    src/dst/mask) that the host view :class:`CsrAdjRows` densifies per row.

Also here: the ``synth_ext`` verb (batched extension-candidate extraction),
which is single-step pushes only.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from nemo_tpu_torch.graphs.packed import TYPE_ASYNC, TYPE_COLLAPSED, TYPE_NEXT
from nemo_tpu_torch.kernels.edge_wave import edge_wave
from nemo_tpu_torch.ops.diff import NEG_INF
from nemo_tpu_torch.ops.proto import DEPTH_INF, reduce_protos

#: Iterations of a plain fix-point loop between two convergence checks
#: (each check is one device-to-host sync on the card).
_CHECK_EVERY = 4

#: Per plain fix-point loop (by name): calls, iterations run and host wall
#: seconds since the process started, or since a caller cleared it.
LOOP_STATS: dict[str, dict] = {}
#: the scheduler's lanes may finish loops at once
_STATS_LOCK = threading.Lock()


def _fix_point(name: str, step, x: torch.Tensor, cap: int | None = None) -> torch.Tensor:
    """x <- step(x) until an iteration changes nothing, or ``cap``
    iterations (the JAX package's ``lax.while_loop`` on a changed predicate,
    with its trip cap)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    it = 0
    while cap is None or it < cap:
        n = _CHECK_EVERY if cap is None else min(_CHECK_EVERY, cap - it)
        for _ in range(n):
            prev, x = x, step(x)
        it += n
        if torch.equal(prev, x):
            break
    wall = time.perf_counter() - t0
    with _STATS_LOCK:
        rec = LOOP_STATS.setdefault(name, {"calls": 0, "iters": 0, "wall_s": 0.0})
        rec["calls"] += 1
        rec["iters"] += it
        rec["wall_s"] += wall
    return x


# ------------------------------------------------------------ wave helpers


def _gather(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals [B,V] gathered by int64 idx [B,E] -> [B,E]."""
    return torch.gather(vals, 1, idx)


def _scat_any(vals_e: torch.Tensor, dst: torch.Tensor, v: int) -> torch.Tensor:
    """[B,E] bool scattered (any) to [B,V] by dst — the segment-sum push."""
    out = torch.zeros(dst.shape[0], v, dtype=torch.int32, device=dst.device)
    return out.scatter_add_(1, dst, vals_e.to(torch.int32)) > 0


def _push_any(state: torch.Tensor, src, dst, mask, v: int) -> torch.Tensor:
    """One frontier wave: nodes with an in-edge from `state` (>=1 hop)."""
    return _scat_any(_gather(state, src) & mask, dst, v)


def _reach_any(start: torch.Tensor, src, dst, mask, v: int) -> torch.Tensor:
    """Nodes reachable from `start` in >= 1 hop, exactly: the >=0-hop fix
    point from K2, then one push.  Edge planes are int64 [B,E] or one shared
    [E] list."""
    b, e = start.shape[0], src.shape[-1]
    reach0 = edge_wave(start, src.to(torch.int32), dst.to(torch.int32), mask, None)
    return _push_any(reach0, src.expand(b, e), dst.expand(b, e), mask.expand(b, e), v)


def _bfs_depths(root, src, dst, mask, v: int) -> torch.Tensor:
    """Shortest hop distance [B,V] int32 from root; DEPTH_INF where
    unreachable.  Scatter-min relaxation to the fix point."""
    b = src.shape[0]
    inf = torch.full((b, v), DEPTH_INF, dtype=torch.int32, device=src.device)

    def step(depth):
        stepped = torch.where(mask, _gather(depth, src) + 1, DEPTH_INF)
        nd = inf.scatter_reduce(1, dst, stepped, "amin", include_self=True)
        return torch.minimum(depth, nd)

    depth0 = torch.where(root, 0, DEPTH_INF).to(torch.int32)
    return _fix_point("bfs_depths", step, depth0)


def _table_any(mask_bv: torch.Tensor, table: torch.Tensor, num_tables: int) -> torch.Tensor:
    """[B,V] node mask -> [B,T] per-table any-bitset (table -1 = padding);
    the scatter twin of ops/adjacency.py:table_bitset."""
    tclip = table.clamp(0, num_tables - 1).long()
    sel = mask_bv & (table >= 0)
    out = torch.zeros(table.shape[0], num_tables, dtype=torch.int32, device=table.device)
    return out.scatter_add_(1, tclip, sel.to(torch.int32)) > 0


def _table_min(values, mask_bv, table, num_tables: int, fill: int) -> torch.Tensor:
    """[B,V] int values -> [B,T] int32 per-table min over masked nodes (else
    fill); the scatter twin of ops/adjacency.py:table_min."""
    tclip = table.clamp(0, num_tables - 1).long()
    sel = mask_bv & (table >= 0)
    vals = torch.where(sel, values, fill).to(torch.int32)
    out = torch.full((table.shape[0], num_tables), fill, dtype=torch.int32, device=table.device)
    return out.scatter_reduce(1, tclip, vals, "amin", include_self=True)


# ----------------------------------------------------------------- verbs


def _condition_holds(ba, src, dst, tid: int, num_tables: int, v: int) -> torch.Tensor:
    """Sparse mirror of ops/condition.py:mark_condition_holds over the raw
    [B,E] edge planes."""
    em = ba.edge_mask
    goal = ba.is_goal & ba.node_mask
    table = ba.table_id
    indeg = _scat_any(em, dst, v)
    root = goal & (table == tid) & ~indeg
    rule = _push_any(root, src, dst, em, v) & ~ba.is_goal & ba.node_mask & (table == tid)
    trig = _push_any(rule, src, dst, em, v) & ba.is_goal & ba.node_mask
    any_trig = trig.any(dim=-1, keepdim=True)
    trig_tables = _table_any(trig, table, num_tables)
    tclip = table.clamp(0, num_tables - 1).long()
    in_trig_table = torch.gather(trig_tables, 1, tclip) & (table >= 0)
    return goal & any_trig & ((table == tid) | in_trig_table)


def _component_labels(member, me, src, dst, v: int, comp_linear: bool) -> torch.Tensor:
    """Within-row component ids [B,V] of the member subgraph over the kept
    member edges `me` [B,E]; `v` for non-members.  Only the grouping
    matters (the representative is re-derived as the min head index).

    comp_linear=True (bucket-verified): pointer doubling along the unique
    member successor, O(V log V).  Otherwise min-label relaxation to the fix
    point over the undirected member edges — exact for any member
    structure, including zigzag components whose undirected diameter the
    directed depth does not bound."""
    b = src.shape[0]
    idx = torch.arange(v, device=src.device).expand(b, v)
    if comp_linear:
        # <=1 member successor per member (verified linear): a scatter-max
        # against the -1 sentinel recovers it exactly.
        succ = torch.full((b, v), -1, dtype=torch.int64, device=src.device)
        succ = succ.scatter_reduce(1, src, torch.where(me, dst, -1), "amax", include_self=True)
        p = torch.where(succ >= 0, succ, idx)
        for _ in range(max(1, (v - 1).bit_length())):
            p = torch.gather(p, 1, p)
        return torch.where(member, p, v)

    def step(lab):
        ls = torch.where(me, _gather(lab, src), v)
        ld = torch.where(me, _gather(lab, dst), v)
        new = lab.scatter_reduce(1, dst, ls, "amin", include_self=True)
        return new.scatter_reduce(1, src, ld, "amin", include_self=True)

    lab = _fix_point("component_labels", step, torch.where(member, idx, v))
    return torch.where(member, lab, v)


def _simplify(ba, src, dst, v: int, comp_linear: bool):
    """Sparse mirror of clean_masks + collapse_chains.  Returns (new_src,
    new_dst, new_mask — the CONTRACTED edge list [B,E], int64 indices —
    alive_new [B,V], type_new [B,V] int32)."""
    b = ba.is_goal.shape[0]
    em = ba.edge_mask
    goal = ba.is_goal & ba.node_mask

    # --- clean-copy restriction (ops/simplify.py:clean_masks)
    has_in_goal = _scat_any(_gather(goal, src) & em, dst, v)
    has_out_goal = _scat_any(_gather(goal, dst) & em, src, v)
    is_rule = ~ba.is_goal & ba.node_mask
    alive = goal | (is_rule & has_in_goal & has_out_goal)
    keep = em & torch.where(
        _gather(goal, src), _gather(has_out_goal, dst), _gather(has_in_goal, src)
    )
    keep &= _gather(alive, src) & _gather(alive, dst)

    # --- chain contraction (ops/simplify.py:collapse_chains)
    next_rule = is_rule & alive & (ba.type_id == TYPE_NEXT)
    in_from_next = _scat_any(_gather(next_rule, src) & keep, dst, v)
    out_to_next = _scat_any(_gather(next_rule, dst) & keep, src, v)
    member = next_rule | (goal & alive & in_from_next & out_to_next)
    me = keep & _gather(member, src) & _gather(member, dst)

    lab_c = _component_labels(member, me, src, dst, v, comp_linear).clamp(0, v - 1)

    in_from_member = _scat_any(_gather(member, src) & keep, dst, v)
    out_to_member = _scat_any(_gather(member, dst) & keep, src, v)
    head = next_rule & ~in_from_member
    tail = next_rule & ~out_to_member

    idx = torch.arange(v, device=src.device).expand(b, v)
    # head rules are members by construction, so `head` alone selects the
    # component heads whose min index becomes the representative.
    rep_per_comp = torch.full((b, v), v, dtype=torch.int64, device=src.device).scatter_reduce(
        1, lab_c, torch.where(head, idx, v), "amin", include_self=True
    )
    n_rules_per_comp = torch.zeros(b, v, dtype=torch.int32, device=src.device).scatter_add_(
        1, lab_c, next_rule.to(torch.int32)
    )
    collapsible_comp = (n_rules_per_comp >= 2) & (rep_per_comp < v)

    node_collapsible = member & torch.gather(collapsible_comp, 1, lab_c)
    rep_of_node = torch.where(node_collapsible, torch.gather(rep_per_comp, 1, lab_c), idx)
    is_rep = node_collapsible & (idx == rep_of_node)
    dies = node_collapsible & ~is_rep
    ext_goal = goal & alive & ~member

    # In-place edge contraction: survivors, ext-goal->head preds remapped to
    # the rep, tail->ext-goal succs remapped from the rep are mutually
    # exclusive per edge, so the contracted graph is a remap of the kept
    # edge list with the same [B,E] shape.
    nc_s = _gather(node_collapsible, src)
    nc_d = _gather(node_collapsible, dst)
    survive = ~nc_s & ~nc_d
    pred_sel = _gather(ext_goal, src) & _gather(head & node_collapsible, dst)
    succ_sel = _gather(tail & node_collapsible, src) & _gather(ext_goal, dst)
    new_mask = keep & (survive | pred_sel | succ_sel)
    new_src = torch.where(succ_sel, _gather(rep_of_node, src), src)
    new_dst = torch.where(pred_sel, _gather(rep_of_node, dst), dst)

    alive_new = alive & ~dies
    type_new = torch.where(is_rep, TYPE_COLLAPSED, ba.type_id).to(torch.int32)
    return new_src, new_dst, new_mask, alive_new, type_new


def _proto(ba, alive2, edges, achieved, num_tables: int, v: int):
    """Sparse mirror of proto_rule_bits + all_rule_bits over the contracted
    consequent `edges` (src, dst, mask).  Returns (bits [B,T], min_depth
    [B,T] int32, present [B,T])."""
    asrc, adst, amask = edges
    pm = amask & _gather(alive2, asrc) & _gather(alive2, adst)

    indeg = _scat_any(pm, adst, v)
    root = ba.is_goal & alive2 & ~indeg
    is_rule = ~ba.is_goal & alive2
    reach = _reach_any(root, asrc, adst, pm, v)
    rule_desc = _reach_any(is_rule, adst, asrc, pm, v)
    rule_anc = _reach_any(is_rule & reach, asrc, adst, pm, v)
    qualify = is_rule & reach & (rule_desc | rule_anc) & achieved[:, None]

    depth = _bfs_depths(root, asrc, adst, pm, v)
    rule_depth = torch.div(depth + 1, 2, rounding_mode="floor")  # hops alternate goal/rule

    bits = _table_any(qualify, ba.table_id, num_tables)
    present = _table_any(is_rule, ba.table_id, num_tables)
    min_depth = _table_min(rule_depth, qualify, ba.table_id, num_tables, DEPTH_INF)
    return bits, min_depth, present


# ------------------------------------------------------------- fused step


def sparse_device_step(
    pre,
    post,
    v: int,
    pre_tid: int,
    post_tid: int,
    num_tables: int,
    comp_linear: bool = False,
    pack_out: bool = False,
) -> dict[str, torch.Tensor]:
    """Sparse mirror of analysis_step(with_diff=False) for one packed (pre,
    post) run bucket (``BatchArrays``): the same summary keys, shapes and
    values, with the dense [B,V,V] clean adjacencies replaced by contracted
    edge lists ``{cond}_clean_src/dst/mask`` [B,E] (densify per row with
    :class:`CsrAdjRows`).  pack_out folds the bool summary outputs into one
    bit-packed ``packed_summary`` (SUMMARY_PACK_LAYOUT)."""
    from nemo_tpu_torch.models.pipeline_model import (
        SUMMARY_PACK_LAYOUT,
        fold_packed_summary,
        widen_batch,
    )

    out: dict = {}
    post_ctx = None
    for name, ba, tid in (("pre", widen_batch(pre), pre_tid), ("post", widen_batch(post), post_tid)):
        src, dst = ba.edge_src.long(), ba.edge_dst.long()
        out[f"{name}_holds"] = _condition_holds(ba, src, dst, tid, num_tables, v)
        new_src, new_dst, new_mask, alive2, type2 = _simplify(ba, src, dst, v, comp_linear)
        out[f"{name}_clean_src"] = new_src.to(torch.int32)
        out[f"{name}_clean_dst"] = new_dst.to(torch.int32)
        out[f"{name}_clean_mask"] = new_mask
        out[f"{name}_alive"] = alive2
        out[f"{name}_type"] = type2
        if name == "post":
            post_ctx = (ba, alive2, (new_src, new_dst, new_mask))
    achieved = out["pre_holds"].any(dim=-1)
    out["achieved_pre"] = achieved

    ba_p, alive2_p, edges_p = post_ctx
    bits, min_depth, present = _proto(ba_p, alive2_p, edges_p, achieved, num_tables, v)
    out["proto_bits"] = bits
    out["proto_min_depth"] = min_depth
    out["proto_present"] = present
    out["proto_inter"], out["proto_union"] = reduce_protos(bits, achieved)
    if pack_out:
        fold_packed_summary(out, SUMMARY_PACK_LAYOUT)
    return out


# ------------------------------------------------------------------- diff


def diff_masks_sparse_device(
    edge_src: torch.Tensor,  # [E] int (padded edge list of the good run's consequent)
    edge_dst: torch.Tensor,  # [E]
    edge_mask: torch.Tensor,  # [E] bool
    is_goal: torch.Tensor,  # [V] bool
    node_mask: torch.Tensor,  # [V] bool
    label_id: torch.Tensor,  # [V] int
    fail_bits: torch.Tensor,  # [B,L] bool
    v: int,
):
    """Sparse mirror of ops/diff.py:diff_masks over the good run's edge
    list, every failed run batched through the same waves (the shared [E]
    list is broadcast, never copied).  Returns (node_keep [B,V], edge_keep
    [B,E] — a mask over the edge list — frontier_rule [B,V], missing_goal
    [B,V])."""
    b, e = fail_bits.shape[0], edge_src.shape[0]
    num_labels = fail_bits.shape[-1]
    src, dst, em = edge_src.long(), edge_dst.long(), edge_mask.to(torch.bool)
    src_b, dst_b, em_b = src.expand(b, e), dst.expand(b, e), em.expand(b, e)
    lid = label_id.clamp(0, num_labels - 1).long()

    in_failed = fail_bits[:, lid] & (label_id >= 0)
    ok = (is_goal & node_mask)[None, :] & ~in_failed

    # >=0-hop reach from / to an ok goal (start | >=1-hop push).
    fwd = ok | _reach_any(ok, src, dst, em, v)
    bwd = ok | _reach_any(ok, dst, src, em, v)
    node_keep = fwd & bwd & node_mask[None, :]
    edge_keep = em_b & _gather(node_keep, src_b) & _gather(node_keep, dst_b)

    goal_b = is_goal[None, :] & node_keep
    indeg = _scat_any(edge_keep, dst_b, v)
    outdeg = _scat_any(edge_keep, src_b, v)
    root = goal_b & ~indeg
    leaf = goal_b & ~outdeg

    # Longest path from roots over the kept edges: max-plus relaxation to the
    # fix point, capped at v iterations (a simple path has < v edges, so the
    # cap never cuts a DAG short, and a cyclic input stops where the JAX
    # package's loop stops).
    neg = torch.full((b, v), NEG_INF, dtype=torch.int32, device=src.device)

    def step(dist):
        stepped = torch.where(edge_keep, _gather(dist, src_b) + 1, NEG_INF)
        return torch.maximum(dist, neg.scatter_reduce(1, dst_b, stepped, "amax", include_self=True))

    dist = _fix_point("diff_longest", step, torch.where(root, 0, NEG_INF).to(torch.int32), cap=v)

    leaf_dist = torch.where(leaf & (dist >= 1), dist, NEG_INF)
    max_len = leaf_dist.max(dim=-1, keepdim=True).values
    deepest_leaf = leaf & (dist == max_len)
    to_deepest = _scat_any(edge_keep & _gather(deepest_leaf, dst_b), src_b, v)
    frontier_rule = ~is_goal[None, :] & node_keep & (dist + 1 == max_len) & to_deepest
    missing_goal = goal_b & _scat_any(edge_keep & _gather(frontier_rule, src_b), dst_b, v)
    return node_keep, edge_keep, frontier_rule, missing_goal


# ------------------------------------------------------------- synthesis


def synth_ext_candidates(
    edge_src: torch.Tensor,  # [B,E] int
    edge_dst: torch.Tensor,  # [B,E]
    edge_mask: torch.Tensor,  # [B,E] bool
    is_goal: torch.Tensor,  # [B,V] bool
    node_mask: torch.Tensor,  # [B,V] bool
    type_id: torch.Tensor,  # [B,V] int
    table_id: torch.Tensor,  # [B,V] int
    holds: torch.Tensor,  # [B,V] bool (the fused step's {cond}_holds output)
    v: int,
    num_tables: int,
) -> torch.Tensor:
    """Per-run extension-candidate table bitsets [B,T]: the async rules
    adjacent to the antecedent's condition boundary
    (analysis/queries.py:extension_candidates, extensions.go:63-67).  A
    candidate rule r is non-goal, type async, and satisfies either

      cond_a: some holding goal parent AND some child goal that does not
              hold and itself has a non-goal child; or
      cond_b: some non-holding goal parent."""
    src, dst, em = edge_src.long(), edge_dst.long(), edge_mask
    goal = is_goal & node_mask
    g_hold = goal & holds
    g_nohold = goal & ~holds
    nongoal = ~is_goal & node_mask
    # c has a non-goal child (the inner qualifier of cond_a).
    has_nongoal_child = _scat_any(_gather(nongoal, dst) & em, src, v)
    qual_child = g_nohold & has_nongoal_child
    holding_parent = _scat_any(_gather(g_hold, src) & em, dst, v)
    nonhold_parent = _scat_any(_gather(g_nohold, src) & em, dst, v)
    has_qual_child = _scat_any(_gather(qual_child, dst) & em, src, v)
    cand = (
        nongoal
        & (type_id == TYPE_ASYNC)
        & ((holding_parent & has_qual_child) | nonhold_parent)
    )
    return _table_any(cand, table_id, num_tables)


# ------------------------------------------------------- host-side views


class CsrAdjRows:
    """Lazy dense view over a contracted [B,E] edge list: indexing
    densifies exactly the rows the caller touches into [V,V] / [k,V,V]
    bool planes; the whole-bucket [B,V,V] plane is never built, which is
    the sparse route's memory contract.

    Supports ``adj[row]`` (int) and ``adj[rows]`` (index array), both
    returning numpy."""

    __slots__ = ("src", "dst", "mask", "v", "shape")

    def __init__(self, src, dst, mask, v: int) -> None:
        self.src = np.asarray(src)
        self.dst = np.asarray(dst)
        self.mask = np.asarray(mask, dtype=bool)
        self.v = int(v)
        self.shape = (self.src.shape[0], self.v, self.v)

    def _densify(self, rows: np.ndarray) -> np.ndarray:
        out = np.zeros((len(rows), self.v, self.v), dtype=bool)
        for j, r in enumerate(rows):
            m = self.mask[r]
            out[j, self.src[r][m], self.dst[r][m]] = True
        return out

    def __getitem__(self, key):
        if np.ndim(key) == 0:
            return self._densify(np.asarray([key]).ravel())[0]
        return self._densify(np.asarray(key).ravel())

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        dense = self._densify(np.arange(self.shape[0]))
        return dense if dtype is None else dense.astype(dtype)
