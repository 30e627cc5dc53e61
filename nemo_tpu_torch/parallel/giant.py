"""Host planning and the host lane for giant runs: runs too large for the
dense buckets.

A run with more than ``TorchBackend.giant_v`` nodes leaves the buckets and
is analysed alone, packed at the corpus-common giant (V, E) buckets: on the
sparse device step (ops/sparse_device.py), which needs only
:func:`giant_linear`, or on the host lane, :func:`giant_analysis_host`,
which reads :func:`giant_plan`'s exact union-find component labels.

Port of the JAX package's ``parallel/giant.py``: ``giant_plan``,
``pad_comp_labels`` and ``giant_analysis_host``, in numpy.  Its dense
node-sharded giant step is not ported.
"""

from __future__ import annotations

import numpy as np

from nemo_tpu_torch.graphs.packed import TYPE_COLLAPSED, TYPE_NEXT, PackedGraph, longest_path_len
from nemo_tpu_torch.ops.proto import DEPTH_INF
from nemo_tpu_torch.ops.simplify import chains_linear_host


def giant_linear(graph: PackedGraph) -> bool:
    """chains_linear of one unpadded graph: every @next chain member has at
    most one member successor and predecessor in the clean graph — true for
    the linear ``t(C+1)@next :- t(C)`` chains the domain generates.  O(E),
    vectorized; giant_plan's first output, without its labels."""
    n, e = graph.n_nodes, len(graph.edges)
    edges = graph.edges.reshape(e, 2)
    return chains_linear_host(
        (np.arange(n) < graph.n_goals)[None],
        np.ones((1, n), dtype=bool),
        graph.type_id[None],
        edges[None, :, 0],
        edges[None, :, 1],
        np.ones((1, e), dtype=bool),
    )


def giant_plan(graph: PackedGraph) -> tuple[bool, int, np.ndarray]:
    """Host O(E) planning of one giant run: (chains_linear,
    collapsed_depth_bound, comp_labels).

    comp_labels [n_nodes] int32: exact union-find component labels of the
    member subgraph (member-index-valued; n_nodes for non-members,
    re-sentinelled to the bucket V by pad_comp_labels).  The host lane
    contracts chains by these labels, exact for any member structure.

    collapsed_depth_bound: the longest path of the graph after contracting
    each chain component to one node, plus a margin of 2, capped at
    n_nodes."""
    n = graph.n_nodes
    edges = graph.edges
    is_goal = np.zeros(n, dtype=bool)
    is_goal[: graph.n_goals] = True
    # clean_masks mirror: a rule is alive iff it has an in-goal and an
    # out-goal edge; edge g->r is kept iff r has an out-goal, r->g iff r has
    # an in-goal (ops/simplify.py:clean_masks).
    has_in_goal = np.zeros(n, dtype=bool)
    has_out_goal = np.zeros(n, dtype=bool)
    if len(edges):
        src, dst = edges[:, 0], edges[:, 1]
        np.logical_or.at(has_in_goal, dst, is_goal[src])
        np.logical_or.at(has_out_goal, src, is_goal[dst])
    alive = is_goal | (~is_goal & has_in_goal & has_out_goal)
    if len(edges):
        keep = np.where(is_goal[src], has_out_goal[dst], has_in_goal[src])
        keep &= alive[src] & alive[dst]
        src, dst = src[keep], dst[keep]
    else:
        src = dst = np.zeros(0, dtype=np.int64)

    next_rule = ~is_goal & alive & (graph.type_id == TYPE_NEXT)
    in_from_next = np.zeros(n, dtype=bool)
    out_to_next = np.zeros(n, dtype=bool)
    if len(src):
        np.logical_or.at(in_from_next, dst, next_rule[src])
        np.logical_or.at(out_to_next, src, next_rule[dst])
    member = next_rule | (is_goal & alive & in_from_next & out_to_next)

    member_edge = member[src] & member[dst] if len(src) else np.zeros(0, dtype=bool)
    succ_count = np.zeros(n, dtype=np.int64)
    pred_count = np.zeros(n, dtype=np.int64)
    np.add.at(succ_count, src[member_edge], 1)
    np.add.at(pred_count, dst[member_edge], 1)
    linear = bool((succ_count[member] <= 1).all() and (pred_count[member] <= 1).all())

    # Contract chain components (union-find over the member edges) and bound
    # the collapsed graph's longest path.
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, d in zip(src[member_edge], dst[member_edge]):
        rs, rd = find(int(s)), find(int(d))
        if rs != rd:
            parent[rs] = rd
    rep = np.array([find(i) for i in range(n)], dtype=np.int64)
    comp_labels = np.where(member, rep, n).astype(np.int32)
    cedges = np.stack([rep[src], rep[dst]], axis=1) if len(src) else np.zeros((0, 2), np.int64)
    cedges = cedges[cedges[:, 0] != cedges[:, 1]]
    depth = longest_path_len(n, cedges)
    return linear, min(n, depth + 2), comp_labels


def pad_comp_labels(labels: np.ndarray, n_nodes: int, v: int) -> np.ndarray:
    """giant_plan's [n_nodes] labels -> a [1, v] plane, with the non-member
    sentinel re-pinned to the bucket V (the contraction masks by member, so
    any value >= n works; V keeps it shape-consistent)."""
    out = np.full((1, v), v, dtype=np.int32)
    out[0, :n_nodes] = labels
    return out


def giant_analysis_host(pre, post, pre_tid: int, post_tid: int, num_tables: int, pre_labels, post_labels) -> dict:
    """The host lane of one giant run: the analysis of a B=1 (pre, post)
    PackedBatch pair as O(V + E) numpy edge-list scatters and fix-point BFS,
    with giant_plan's padded union-find labels (``pre_labels``,
    ``post_labels`` [1,V]) for the chain contraction.  Outputs are those of
    the sparse device step (ops/sparse_device.py:sparse_device_step) at B=1:
    the clean adjacency as the contracted edge planes
    ``{cond}_clean_src/dst/mask`` [1,K]; no [V,V] plane is built.

    Reference semantics: markConditionHolds (pre-post-prov.go:220-243),
    clean-copy + collapseNextChains (preprocessing.go:17-345),
    extractProtos (prototype.go:11-24)."""
    from nemo_tpu_torch.ops.sparse_host import edge_planes

    out: dict = {}
    alive_clean: dict = {}
    coll_edges: dict = {}
    labs = {"pre": pre_labels, "post": post_labels}

    for name, b, tid in (("pre", pre, pre_tid), ("post", post, post_tid)):
        v = b.v
        idx = np.arange(v)
        is_goal = np.asarray(b.is_goal[0])
        node_mask = np.asarray(b.node_mask[0])
        table = np.asarray(b.table_id[0]).astype(np.int64)
        type_id = np.asarray(b.type_id[0]).astype(np.int32)
        em = np.asarray(b.edge_mask[0]).astype(bool)
        src = np.asarray(b.edge_src[0])[em].astype(np.int64)
        dst = np.asarray(b.edge_dst[0])[em].astype(np.int64)

        def scat_any(at, vals, v=v):
            """bool [v]: any val scattered to index (bincount)."""
            return np.bincount(at[vals], minlength=v) > 0

        goal = is_goal & node_mask

        # --- condition marking (ops/condition.py:mark_condition_holds)
        indeg = scat_any(dst, np.ones(len(dst), dtype=bool))
        root = goal & (table == tid) & ~indeg
        rule = scat_any(dst, root[src]) & ~is_goal & node_mask & (table == tid)
        trig = scat_any(dst, rule[src]) & is_goal & node_mask
        any_trig = bool(trig.any())
        trig_tables = np.zeros(num_tables, dtype=bool)
        tt = table[trig]
        trig_tables[np.clip(tt, 0, num_tables - 1)[tt >= 0]] = True
        in_trig_table = trig_tables[np.clip(table, 0, num_tables - 1)] & (table >= 0)
        holds = goal & any_trig & ((table == tid) | in_trig_table)
        out[f"{name}_holds"] = holds[None]

        # --- clean-copy restriction (ops/simplify.py:clean_masks)
        has_in_goal = scat_any(dst, goal[src])
        has_out_goal = scat_any(src, goal[dst])
        is_rule = ~is_goal & node_mask
        alive = goal | (is_rule & has_in_goal & has_out_goal)
        keep = np.where(goal[src], has_out_goal[dst], has_in_goal[src])
        keep &= alive[src] & alive[dst]
        ksrc, kdst = src[keep], dst[keep]

        # --- chain contraction (ops/simplify.py:collapse_chains)
        next_rule = is_rule & alive & (type_id == TYPE_NEXT)
        in_from_next = scat_any(kdst, next_rule[ksrc])
        out_to_next = scat_any(ksrc, next_rule[kdst])
        member = next_rule | (goal & alive & in_from_next & out_to_next)
        lab = np.where(member, np.asarray(labs[name][0]).astype(np.int64), v)
        in_from_member = scat_any(kdst, member[ksrc])
        out_to_member = scat_any(ksrc, member[kdst])
        head = next_rule & ~in_from_member
        tail = next_rule & ~out_to_member

        rep_per_comp = np.full(v, v, dtype=np.int64)
        hm = member & head
        np.minimum.at(rep_per_comp, np.clip(lab[hm], 0, v - 1), idx[hm])
        nm = member & next_rule
        n_rules_per_comp = np.bincount(np.clip(lab[nm], 0, v - 1), minlength=v)
        collapsible_comp = (n_rules_per_comp >= 2) & (rep_per_comp < v)
        lab_c = np.clip(lab, 0, v - 1)
        node_collapsible = member & collapsible_comp[lab_c]
        rep_of_node = np.where(node_collapsible, rep_per_comp[lab_c], idx)
        is_rep = node_collapsible & (idx == rep_of_node)
        dies = node_collapsible & ~is_rep
        ext_goal = goal & alive & ~member

        survive = ~node_collapsible[ksrc] & ~node_collapsible[kdst]
        pred_sel = ext_goal[ksrc] & (head & node_collapsible)[kdst]
        succ_sel = (tail & node_collapsible)[ksrc] & ext_goal[kdst]
        new_src = np.concatenate([ksrc[survive], ksrc[pred_sel], rep_of_node[ksrc[succ_sel]]])
        new_dst = np.concatenate([kdst[survive], rep_of_node[kdst[pred_sel]], kdst[succ_sel]])
        alive_new = alive & ~dies
        type_new = np.where(is_rep, TYPE_COLLAPSED, type_id).astype(type_id.dtype)
        (out[f"{name}_clean_src"], out[f"{name}_clean_dst"],
         out[f"{name}_clean_mask"]) = edge_planes(new_src, new_dst, 1, v)
        out[f"{name}_alive"] = alive_new[None]
        out[f"{name}_type"] = type_new[None]
        alive_clean[name] = alive_new
        coll_edges[name] = (new_src, new_dst, is_goal, table)

    achieved = bool(out["pre_holds"].any())
    out["achieved_pre"] = np.array([achieved])

    # --- prototype bits on the collapsed consequent (ops/proto.py)
    v = post.v
    asrc, adst, is_goal_p, table_p = coll_edges["post"]
    alive2 = alive_clean["post"]
    ok = alive2[asrc] & alive2[adst]
    asrc, adst = asrc[ok], adst[ok]

    def scat_any_p(at, vals):
        return np.bincount(at[vals], minlength=v) > 0

    def bfs_any(start, forward: bool) -> np.ndarray:
        """Nodes reachable from ``start`` in >= 1 hop, to the fix point."""
        s, d = (asrc, adst) if forward else (adst, asrc)
        reach = np.zeros(v, dtype=bool)
        frontier = start
        while True:
            nxt = scat_any_p(d, frontier[s]) & ~reach
            if not nxt.any():
                return reach
            reach |= nxt
            frontier = nxt

    indeg2 = scat_any_p(adst, np.ones(len(adst), dtype=bool))
    root2 = is_goal_p & alive2 & ~indeg2
    is_rule2 = ~is_goal_p & alive2
    reach = bfs_any(root2, forward=True)
    rule_desc = bfs_any(is_rule2, forward=False)
    rule_anc = bfs_any(is_rule2 & reach, forward=True)
    qualify = is_rule2 & reach & (rule_desc | rule_anc) & achieved

    depth = np.full(v, DEPTH_INF, dtype=np.int64)
    depth[root2] = 0
    frontier, d = root2, 0
    while frontier.any():
        d += 1
        nxt = scat_any_p(adst, frontier[asrc]) & (depth == DEPTH_INF)
        depth[nxt] = d
        frontier = nxt
    rule_depth = (depth + 1) // 2

    bits = np.zeros(num_tables, dtype=bool)
    min_depth = np.full(num_tables, DEPTH_INF, dtype=np.int64)
    qt = np.clip(table_p[qualify], 0, num_tables - 1)
    qok = table_p[qualify] >= 0
    bits[qt[qok]] = True
    np.minimum.at(min_depth, qt[qok], rule_depth[qualify][qok])
    present = np.zeros(num_tables, dtype=bool)
    pm = is_rule2 & (table_p >= 0)
    present[np.clip(table_p[pm], 0, num_tables - 1)] = True

    out["proto_bits"] = bits[None]
    out["proto_min_depth"] = min_depth.astype(np.int32)[None]
    out["proto_present"] = present[None]
    return out
