"""Giant runs: runs too large for the dense buckets, analysed one at a time.

A run with more than ``TorchBackend.giant_v`` nodes leaves the buckets and
is analysed alone, packed at the corpus-common giant (V, E) buckets: on the
sparse device step (ops/sparse_device.py), which needs only
:func:`giant_linear`; on the host lane, :func:`giant_analysis_host`, which
reads :func:`giant_plan`'s exact union-find component labels; or on the
dense node-sharded step, :func:`giant_analysis_step` (the
``giant_impl="device"`` opt-in).

Port of the JAX package's ``parallel/giant.py``.  The dense step keeps the
node dimension sharded over a 1-D node mesh (parallel/mesh.py): each rank
holds only its column block of every [V,V] plane and the collectives move
[V] vectors: a column block's frontier step is all-gathered, a row-wise
step or search is reduced (OR / MIN) across ranks.  The step is
closure-free: component labels by pointer doubling (verified-linear
chains) or host union-find labels, prototype reachability by set-BFS,
O(proto_depth * V^2).  One code path serves every width: at width 1 the
block is the whole plane and, outside a process group, every collective
is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from nemo_tpu_torch.graphs.packed import TYPE_COLLAPSED, TYPE_NEXT, PackedGraph, longest_path_len
from nemo_tpu_torch.ops.adjacency import step_backward, step_forward, table_bitset, table_min
from nemo_tpu_torch.ops.condition import holds_of_triggers
from nemo_tpu_torch.ops.proto import DEPTH_INF, all_rule_bits
from nemo_tpu_torch.ops.simplify import chains_linear_host

from .mesh import Mesh, make_node_mesh, world_size
from .ring import closure_cols, gather_cols


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


_MESH_CACHE: dict[int, Mesh] = {}


def default_node_mesh(v: int) -> Mesh:
    """The node mesh of the giant step: the largest power of two <= the
    world that divides v (a power-of-two bucket), cached per width.  A
    world it does not span raises (every mesh spans the world)."""
    w = world_size()
    n = 1
    while n * 2 <= w and v % (n * 2) == 0:
        n *= 2
    mesh = _MESH_CACHE.get(n)
    if mesh is None or mesh.size != w:
        mesh = _MESH_CACHE[n] = make_node_mesh(n)
    return mesh


def giant_analysis_step(
    pre,
    post,
    v: int,
    pre_tid: int,
    post_tid: int,
    num_tables: int,
    max_depth: int,
    comp_linear: bool = True,
    proto_depth: int | None = None,
    mesh: Mesh | None = None,
    pre_labels=None,
    post_labels=None,
    pack_out: bool = False,
) -> dict[str, torch.Tensor]:
    """The analysis of ONE giant run (B=1 BatchArrays on this rank's
    device), with the fused step's keys (analysis_step(with_diff=False))
    but no proto_inter/proto_union.

    Label strategy, in order: ``doubling`` (comp_linear: verified-linear
    chains, O(V log V)); ``host`` (giant_plan's exact union-find labels
    ``pre_labels``/``post_labels`` [1,V]: the only sound bounded option for
    arbitrary member structures); ``closure`` (no labels: the exact
    all-pairs closure, K1 at width 1 and the ring-squared closure_cols on a
    wider mesh).  Edges are rewired by O(V^2) scatters, prototype
    reachability is set-BFS to proto_depth (giant_plan's collapsed bound;
    max_depth, the raw bound, when None).

    The step runs column-sharded (_giant_step) at every width, and
    every rank gets the same outputs, tensors on the device, the clean
    adjacencies as the contracted edge lists ``{cond}_clean_src/dst/mask``
    [1,K] (gathered once at the end: no [V,V] plane crosses ranks).
    pack_out folds the bool summary into one ``packed_summary``
    (models/pipeline_model.py:GIANT_PACK_LAYOUT)."""
    from nemo_tpu_torch.models.pipeline_model import GIANT_PACK_LAYOUT, fold_packed_summary, widen_batch

    mesh = mesh or default_node_mesh(v)
    if v % mesh.size:
        raise ValueError(f"V={v} not divisible by node mesh size {mesh.size}")
    proto_depth = proto_depth or max_depth
    mode = "doubling" if comp_linear else ("host" if pre_labels is not None and post_labels is not None
                                           else "closure")
    dev = pre.is_goal.device
    labels = {
        name: torch.as_tensor(lab).to(dev) if mode == "host" else None
        for name, lab in (("pre", pre_labels), ("post", post_labels))
    }
    pre, post = widen_batch(pre), widen_batch(post)
    out = _giant_step(_NodeCols(mesh, v), pre, post, pre_tid, post_tid, num_tables, proto_depth, mode, labels)
    if pack_out:
        fold_packed_summary(out, GIANT_PACK_LAYOUT)
    return out


class _NodeCols:
    """One rank's view of the node-sharded [B,V,V] planes: its column block
    [B,V,Vb] of each.  A frontier step forward yields a column block of the
    result, all-gathered; a step backward a partial result over the whole
    [B,V], reduced (OR) across ranks."""

    def __init__(self, mesh: Mesh, v: int) -> None:
        self.mesh = mesh
        self.v = v
        self.sl = mesh.block(v)
        self.lo = self.sl.start
        self.vb = self.sl.stop - self.sl.start

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """The block's columns of a [..., V] tensor."""
        return x[..., self.sl]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's [..., Vb] block -> the whole [..., V]."""
        return gather_cols(self.mesh, x)

    def fwd(self, frontier: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
        return self.gather(step_forward(frontier, blk))

    def bwd(self, frontier: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
        return self.mesh.any(step_backward(self.cols(frontier), blk))

    def in_degree_any(self, blk: torch.Tensor) -> torch.Tensor:
        return self.gather(blk.any(dim=-2))

    def build(self, b) -> torch.Tensor:
        """The column block of build_adjacency: the edges whose destination
        falls in it."""
        bsz = b.edge_src.shape[0]
        dst = b.edge_dst.long() - self.lo
        keep = b.edge_mask & (dst >= 0) & (dst < self.vb)
        rows = torch.arange(bsz, device=dst.device)[:, None]
        flat = (rows * self.v + b.edge_src.long()) * self.vb + dst.clamp(0, self.vb - 1)
        counts = torch.zeros(bsz * self.v * self.vb, dtype=torch.int32, device=dst.device)
        counts.index_add_(0, flat.reshape(-1), keep.reshape(-1).to(torch.int32))
        return (counts > 0).reshape(bsz, self.v, self.vb)

    def edges(self, blk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A B=1 column-blocked plane's set entries, every rank's, as the
        contracted edge list (src [1,K], dst [1,K], mask [1,K])."""
        _, i, j = blk.nonzero(as_tuple=True)
        got = self.mesh.all_gather_ragged(torch.stack([i, j + self.lo], dim=1))
        mask = torch.ones((1, got.shape[0]), dtype=torch.bool, device=blk.device)
        return got[None, :, 0].to(torch.int32), got[None, :, 1].to(torch.int32), mask

    def move_cols(self, src: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
        """The scatter rewire's column moves: each set entry (i, j) of the
        block goes to column rep[j].  Targets in the block are set here;
        the others cross ranks in one exchange of only the moved entries."""
        out = torch.zeros_like(src)
        bb, i, j = src.nonzero(as_tuple=True)
        tgt = rep[bb, j + self.lo]
        here = (tgt >= self.lo) & (tgt < self.lo + self.vb)
        out[bb[here], i[here], tgt[here] - self.lo] = True
        got = self.mesh.all_gather_ragged(torch.stack([bb[~here], i[~here], tgt[~here]], dim=1))
        got = got[(got[:, 2] >= self.lo) & (got[:, 2] < self.lo + self.vb)]
        out[got[:, 0], got[:, 1], got[:, 2] - self.lo] = True
        return out


def _giant_step(c: _NodeCols, pre, post, pre_tid: int, post_tid: int, num_tables: int, proto_depth: int,
                        mode: str, labels: dict) -> dict:
    """giant_analysis_step over the node mesh: the reference's ops
    (ops/condition.py, ops/simplify.py clean_masks + collapse_chains with
    the scatter rewire, ops/proto.py set-BFS) over column blocks."""
    v = c.v
    out: dict = {}
    alive2: dict = {}
    blocks: dict = {}
    for name, b, tid in (("pre", pre, pre_tid), ("post", post, post_tid)):
        adj = c.build(b)
        # --- condition marking (mark_condition_holds)
        root = b.is_goal & b.node_mask & (b.table_id == tid) & ~c.in_degree_any(adj)
        rule = c.fwd(root, adj) & ~b.is_goal & b.node_mask & (b.table_id == tid)
        trig = c.fwd(rule, adj) & b.is_goal & b.node_mask
        out[f"{name}_holds"] = holds_of_triggers(trig, b.is_goal, b.table_id, b.node_mask, tid, num_tables)
        # --- clean-copy restriction (clean_masks)
        goal = b.is_goal & b.node_mask
        has_in_goal = c.fwd(goal, adj)
        has_out_goal = c.bwd(goal, adj)
        alive = goal | (~b.is_goal & b.node_mask & has_in_goal & has_out_goal)
        keep = torch.where(goal[..., None], c.cols(has_out_goal)[..., None, :], has_in_goal[..., None])
        adj = adj & keep & alive[..., None] & c.cols(alive)[..., None, :]
        blocks[name], alive2[name], out[f"{name}_type"] = _collapse_cols(c, adj, b, alive, mode, labels[name])
        out[f"{name}_alive"] = alive2[name]
    achieved = out["pre_holds"].any(dim=-1)
    out["achieved_pre"] = achieved

    # --- prototypes over the collapsed consequent (proto_rule_bits, set-BFS)
    alive = alive2["post"]
    a = blocks["post"] & alive[..., None] & c.cols(alive)[..., None, :]
    root = post.is_goal & alive & ~c.in_degree_any(a)
    is_rule = ~post.is_goal & alive

    def bfs(start: torch.Tensor, backward: bool = False) -> torch.Tensor:
        hop = c.bwd if backward else c.fwd
        frontier = acc = hop(start, a)
        for _ in range(max(0, proto_depth - 1)):
            frontier = hop(frontier, a)
            acc = acc | frontier
        return acc

    reach = bfs(root)
    qualify = is_rule & reach & (bfs(is_rule, backward=True) | bfs(is_rule & reach)) & achieved[..., None]
    inf = torch.tensor(DEPTH_INF, dtype=torch.int32, device=a.device)
    depth = torch.where(root, torch.zeros_like(inf), inf)
    for _ in range(proto_depth):
        depth = torch.minimum(depth, c.gather(torch.where(a, depth[..., None], inf).amin(dim=-2) + 1))
    rule_depth = torch.div(depth + 1, 2, rounding_mode="floor")  # hops alternate goal/rule
    out["proto_bits"] = table_bitset(qualify, post.table_id, num_tables)
    out["proto_min_depth"] = table_min(rule_depth, qualify, post.table_id, num_tables, DEPTH_INF)
    out["proto_present"] = all_rule_bits(post.is_goal, alive, post.table_id, num_tables)
    for name in ("pre", "post"):
        out[f"{name}_clean_src"], out[f"{name}_clean_dst"], out[f"{name}_clean_mask"] = c.edges(blocks[name])
    return out


def _collapse_cols(c: _NodeCols, a: torch.Tensor, b, alive: torch.Tensor, mode: str, labels):
    """collapse_chains over column blocks (rewire="scatter").  Returns (the
    block of adj_new, alive_new, type_new)."""
    v = c.v
    dev = a.device
    idx = torch.arange(v, device=dev, dtype=torch.int32)
    fill = torch.tensor(v, dtype=torch.int32, device=dev)
    is_goal = b.is_goal
    a = a & alive[..., None] & c.cols(alive)[..., None, :]
    next_rule = ~is_goal & alive & (b.type_id == TYPE_NEXT)
    member = next_rule | (is_goal & alive & c.fwd(next_rule, a) & c.bwd(next_rule, a))

    if mode == "host":
        lab = torch.where(member, labels.to(torch.int32), fill)
    elif mode == "doubling":
        # Pointer doubling along the first member successor: the first set
        # column of each row, the MIN over the ranks' blocks.
        succ = a & member[..., None] & c.cols(member)[..., None, :]
        has = succ.any(dim=-1)
        first = torch.where(has, torch.argmax(succ.to(torch.uint8), dim=-1).to(torch.int32) + c.lo, fill)
        p = torch.where(c.mesh.any(has), c.mesh.min(first), idx)
        for _ in range(max(1, (v - 1).bit_length())):
            p = torch.gather(p, -1, p.long())
        lab = torch.where(member, p, fill)
    else:
        # The closure labels need the undirected member graph, whose
        # column block holds rows of every rank's: the one mode that moves
        # a whole plane.
        full = c.gather(a)
        und = (full | full.transpose(-1, -2)) & member[..., None] & member[..., None, :]
        reach = closure_cols(c.mesh, c.cols(und))
        lab = c.gather(torch.where(reach & member[..., None], idx[None, :, None], fill).amin(dim=-2))
    lab_c = lab.clamp(0, v - 1).long()

    head = next_rule & ~c.fwd(member, a)
    tail = next_rule & ~c.bwd(member, a)
    # Per component: its representative (min head index) and its rule count.
    rep_per_comp = torch.full(lab.shape, v, dtype=torch.int64, device=dev).scatter_reduce(
        -1, lab_c, torch.where(member & head, idx, fill).long(), "amin", include_self=True)
    n_rules = torch.zeros(lab.shape, dtype=torch.int32, device=dev).scatter_add_(
        -1, lab_c, (member & next_rule).to(torch.int32))
    collapsible = (n_rules >= 2) & (rep_per_comp < v)
    node_collapsible = member & torch.gather(collapsible, -1, lab_c)
    rep = torch.where(node_collapsible, torch.gather(rep_per_comp, -1, lab_c), idx.long())
    is_rep = node_collapsible & (idx == rep)
    ext_goal = is_goal & alive & ~member

    pred_edges = c.move_cols(a & ext_goal[..., None] & c.cols(head & node_collapsible)[..., None, :], rep)
    succ_src = a & (tail & node_collapsible)[..., None] & c.cols(ext_goal)[..., None, :]
    succ_edges = torch.zeros_like(a)
    bb, i, j = succ_src.nonzero(as_tuple=True)
    succ_edges[bb, rep[bb, i], j] = True  # row i onto the rep's row, in the block
    kill = node_collapsible
    adj_new = (a & ~kill[..., None] & ~c.cols(kill)[..., None, :]) | pred_edges | succ_edges
    type_new = torch.where(is_rep, torch.tensor(TYPE_COLLAPSED, dtype=b.type_id.dtype, device=dev), b.type_id)
    return adj_new, alive & ~(node_collapsible & ~is_rep), type_new


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
