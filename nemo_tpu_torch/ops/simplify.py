"""Graph simplification: clean-copy restriction and @next chain contraction.

Array form of the reference's SimplifyProv pass
(graphing/preprocessing.go:351-387); port of the JAX package's
``ops/simplify.py`` (closure, pointer-doubling or given labels; matmul or
scatter rewire).

  * clean_masks: keep all goals; keep rules with both an incoming and an
    outgoing goal edge; keep edge g->r iff r has an out-goal, r->g iff r has
    an in-goal (the Goal-[*0..]->Goal path restriction of
    preprocessing.go:17-27, expressed as degree masks on the bipartite graph).

  * collapse_chains: contract each connected component (with >=2 next rules)
    of the {type==next rules + goals strictly between next rules} subgraph
    into a single collapsed rule occupying the slot of the component's
    minimum-index head rule; external goal predecessors of head rules and
    goal successors of tail rules rewire to it; everything else in the
    component dies (preprocessing.go:66-348).  Component labels come from the
    closure kernel (K1), pointer doubling (verified-linear chains) or the
    caller (host union-find labels); edge rewiring moves columns/rows onto
    the representative slot by two boolean matmuls or, on the giant step,
    by O(V^2) scatters.
"""

from __future__ import annotations

import torch

from nemo_tpu_torch.graphs.packed import TYPE_COLLAPSED, TYPE_NEXT

from .adjacency import bool_matmul, closure, step_backward, step_forward


def clean_masks(
    adj: torch.Tensor, is_goal: torch.Tensor, node_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (adj_clean [B,V,V], alive [B,V])."""
    goal = is_goal & node_mask
    has_in_goal = step_forward(goal, adj)  # rule has an incoming goal edge
    has_out_goal = step_backward(goal, adj)  # rule has an outgoing goal edge
    is_rule = ~is_goal & node_mask
    alive = goal | (is_rule & has_in_goal & has_out_goal)
    # Edge u->v: from a goal, keep iff rule v has an out-goal; from a rule u,
    # keep iff u has an in-goal.
    keep = torch.where(goal[..., None], has_out_goal[..., None, :], has_in_goal[..., None])
    adj_clean = adj & keep & alive[..., None] & alive[..., None, :]
    return adj_clean, alive


def _labels_closure(und, member, v, idx):
    """Component labels = min member index reachable in the undirected
    member subgraph (closure kernel K1; exact for any member structure)."""
    comp_reach = closure(und)  # includes identity
    fill = torch.tensor(v, dtype=idx.dtype, device=idx.device)
    return torch.where(comp_reach & member[..., None], idx[None, :, None], fill).amin(dim=-2)


def _labels_doubling(a, member, v, idx):
    """Pointer-doubling along the DIRECTED member successor: every member's
    pointer converges to its chain tail in log2(V) jumps, and the tail index
    is the component label.  Exact ONLY for linear chains (each member has
    <= 1 member successor), which chains_linear_host verifies host-side.
    The successor is the FIRST set column (argmax takes the first max)."""
    succ_mask = a & member[..., None] & member[..., None, :]
    has_succ = succ_mask.any(dim=-1)
    first = torch.argmax(succ_mask.to(torch.uint8), dim=-1).to(idx.dtype)
    p = torch.where(has_succ, first, idx)  # [B,V]
    for _ in range(max(1, (v - 1).bit_length())):
        p = torch.gather(p, -1, p.long())
    fill = torch.tensor(v, dtype=idx.dtype, device=idx.device)
    return torch.where(member, p, fill)


def collapse_chains(
    adj: torch.Tensor,  # [B,V,V] clean adjacency
    is_goal: torch.Tensor,  # [B,V]
    type_id: torch.Tensor,  # [B,V]
    alive: torch.Tensor,  # [B,V]
    comp_doubling: bool = False,
    rewire: str = "matmul",
    comp_labels: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (adj_new, alive_new, type_new).

    Component labels (any consistent member-index-valued label works): the
    all-pairs closure (exact for ANY member structure); ``comp_labels``
    [B,V], precomputed labels (the giant step's host union-find labels);
    or with comp_doubling pointer doubling — linear chains only
    (caller-verified with chains_linear_host).

    rewire: "matmul" moves pred/succ edges onto representatives with two
    boolean matmuls (O(V^3), fine batched at small V); "scatter" moves the
    set entries themselves (O(V^2), the giant step)."""
    v = adj.shape[-1]
    dev = adj.device
    idx = torch.arange(v, device=dev, dtype=torch.int32)
    fill = torch.tensor(v, dtype=torch.int32, device=dev)

    a = adj & alive[..., None] & alive[..., None, :]
    next_rule = ~is_goal & alive & (type_id == TYPE_NEXT)
    in_from_next = step_forward(next_rule, a)
    out_to_next = step_backward(next_rule, a)
    chain_goal = is_goal & alive & in_from_next & out_to_next
    member = next_rule | chain_goal

    if comp_labels is not None:
        lab = torch.where(member, comp_labels.to(torch.int32), fill)
    elif comp_doubling:
        lab = _labels_doubling(a, member, v, idx)
    else:
        und = (a | a.transpose(-1, -2)) & member[..., None] & member[..., None, :]
        lab = _labels_closure(und, member, v, idx)
    lab_c = lab.clamp(0, v - 1).long()

    in_from_member = step_forward(member, a)
    out_to_member = step_backward(member, a)
    head = next_rule & ~in_from_member
    tail = next_rule & ~out_to_member

    one_hot_lab = (lab[..., None] == idx) & member[..., None]  # [B,V,C]
    rep_per_comp = torch.where(one_hot_lab & head[..., None], idx[:, None], fill).amin(
        dim=-2
    )  # [B,C] min head index, v if no head
    n_rules_per_comp = (one_hot_lab & next_rule[..., None]).sum(dim=-2)
    collapsible_comp = (n_rules_per_comp >= 2) & (rep_per_comp < v)

    node_collapsible = member & torch.gather(collapsible_comp, -1, lab_c)
    rep_of_node = torch.where(node_collapsible, torch.gather(rep_per_comp, -1, lab_c), idx)
    is_rep = node_collapsible & (idx == rep_of_node)
    dies = node_collapsible & ~is_rep

    # Edge moves onto the representative slot: external-goal predecessors of
    # heads rewire to the rep's column, goal successors of tails to its row.
    ext_goal = is_goal & alive & ~member
    if rewire == "matmul":
        on_rep = rep_of_node[..., None] == idx
        head_map = on_rep & head[..., None] & node_collapsible[..., None]
        tail_map = on_rep & tail[..., None] & node_collapsible[..., None]
        pred_edges = bool_matmul(a & ext_goal[..., None], head_map)  # goal -> rep
        succ_edges = bool_matmul(tail_map.transpose(-1, -2), a & ext_goal[..., None, :])  # rep -> goal
    elif rewire == "scatter":
        pred_src = a & ext_goal[..., None] & (head & node_collapsible)[..., None, :]
        succ_src = a & (tail & node_collapsible)[..., None] & ext_goal[..., None, :]
        rep = rep_of_node.long()
        pred_edges = torch.zeros_like(a)
        bb, i, j = pred_src.nonzero(as_tuple=True)
        pred_edges[bb, i, rep[bb, j]] = True  # column j onto the rep's column
        succ_edges = torch.zeros_like(a)
        bb, i, j = succ_src.nonzero(as_tuple=True)
        succ_edges[bb, rep[bb, i], j] = True  # row i onto the rep's row
    else:
        raise ValueError(f"unknown rewire {rewire!r} (expected matmul or scatter)")

    kill = node_collapsible
    adj_new = (a & ~kill[..., None] & ~kill[..., None, :]) | pred_edges | succ_edges
    alive_new = alive & ~dies
    type_new = torch.where(
        is_rep, torch.tensor(TYPE_COLLAPSED, dtype=type_id.dtype, device=dev), type_id
    )
    return adj_new, alive_new, type_new


def chains_linear_host(is_goal, node_mask, type_id, edge_src, edge_dst, edge_mask) -> bool:
    """chains_linear_rows of every run: True iff all hold."""
    return bool(chains_linear_rows(is_goal, node_mask, type_id, edge_src, edge_dst, edge_mask).all())


def chains_linear_rows(is_goal, node_mask, type_id, edge_src, edge_dst, edge_mask):
    """Host-side (numpy) linearity check over [B,V]/[B,E] packed batch
    arrays, one bool per run: True iff the run's @next chain-member
    subgraph (after the clean_masks restriction) has member in/out degree
    <= 1 — the precondition for the O(V log V) pointer-doubling labels in
    collapse_chains(comp_doubling=True).

    Conservative by construction: duplicate edge-list entries inflate the
    host degree counts (the device adjacency dedups them), so a duplicated
    chain edge can only flip the answer to False — costing the closure
    fallback, never correctness.  All scatters are flat bincounts (the
    ufunc.at equivalents are orders of magnitude slower at stress scale)."""
    import numpy as np

    is_goal = np.asarray(is_goal)
    node_mask = np.asarray(node_mask)
    type_id = np.asarray(type_id)
    src = np.asarray(edge_src).astype(np.int64)
    dst = np.asarray(edge_dst).astype(np.int64)
    em = np.asarray(edge_mask).astype(bool)
    b, v = is_goal.shape
    rows = np.broadcast_to(np.arange(b)[:, None], src.shape)
    flat_src = (rows * v + src).ravel()
    flat_dst = (rows * v + dst).ravel()

    def scatter_any(flat_idx, vals) -> "np.ndarray":
        return (
            np.bincount(flat_idx[vals.ravel()], minlength=b * v).reshape(b, v) > 0
        )

    goal = is_goal & node_mask
    src_goal = np.take(goal.ravel(), flat_src).reshape(src.shape) & em
    dst_goal = np.take(goal.ravel(), flat_dst).reshape(src.shape) & em
    has_in_goal = scatter_any(flat_dst, src_goal)
    has_out_goal = scatter_any(flat_src, dst_goal)
    rule_alive = ~is_goal & node_mask & has_in_goal & has_out_goal
    alive = goal | rule_alive
    # clean_masks edge keep: from a goal iff the rule dst has an out-goal;
    # from a rule iff it has an in-goal; endpoints alive.
    keep = (
        em
        & np.where(
            np.take(goal.ravel(), flat_src).reshape(src.shape),
            np.take(has_out_goal.ravel(), flat_dst).reshape(src.shape),
            np.take(has_in_goal.ravel(), flat_src).reshape(src.shape),
        )
        & np.take(alive.ravel(), flat_src).reshape(src.shape)
        & np.take(alive.ravel(), flat_dst).reshape(src.shape)
    )
    next_rule = ~is_goal & alive & (type_id == TYPE_NEXT)
    in_from_next = scatter_any(flat_dst, np.take(next_rule.ravel(), flat_src).reshape(src.shape) & keep)
    out_to_next = scatter_any(flat_src, np.take(next_rule.ravel(), flat_dst).reshape(src.shape) & keep)
    member = next_rule | (goal & alive & in_from_next & out_to_next)
    member_edge = (
        keep
        & np.take(member.ravel(), flat_src).reshape(src.shape)
        & np.take(member.ravel(), flat_dst).reshape(src.shape)
    )
    succ = np.bincount(flat_src[member_edge.ravel()], minlength=b * v).reshape(b, v)
    pred = np.bincount(flat_dst[member_edge.ravel()], minlength=b * v).reshape(b, v)
    return ((succ <= 1) | ~member).all(axis=1) & ((pred <= 1) | ~member).all(axis=1)


def pair_chains_linear(pre, post) -> bool:
    """chains_linear_host over a (pre, post) batch pair — the reduction the
    dispatch sites use."""
    return all(
        chains_linear_host(
            b.is_goal, b.node_mask, b.type_id, b.edge_src, b.edge_dst, b.edge_mask
        )
        for b in (pre, post)
    )
