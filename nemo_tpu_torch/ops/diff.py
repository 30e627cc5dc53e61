"""Differential-provenance kernels.

Array form of the reference's CreateNaiveDiffProv
(graphing/differential-provenance.go:18-243): the diff graph keeps
nodes/edges of the good run's consequent provenance that lie on a path
between two goals whose labels are absent from the failed run
(endpoint-filtered: forward-reachable from an ok goal AND backward-reachable
to one); the missing-event frontier is the terminal rule of the longest
root->leaf paths plus all its goal children.  Port of the JAX package's
``ops/diff.py:diff_masks``: its ``vmap`` over failed runs is the leading
[F] axis here, against one shared [V,V] closure of the good graph.  The host
lane's numpy copy, ``diff_masks_host``, works on the good run's edge list.
"""

from __future__ import annotations

import torch

from .adjacency import closure, in_degree_any, out_degree_any, step_backward, step_forward

NEG_INF = -(1 << 20)


def longest_depths(adj: torch.Tensor, start: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Longest path length (in edges) from start nodes; NEG_INF if
    unreachable.  Exactly max_depth max-plus steps; exact when max_depth >=
    the graph depth."""
    neg = torch.tensor(NEG_INF, dtype=torch.int32, device=adj.device)
    dist = torch.where(start, torch.zeros_like(neg), neg)
    for _ in range(max_depth):
        stepped = torch.where(adj, dist[..., None], neg).amax(dim=-2) + 1
        dist = torch.maximum(dist, stepped)
    return dist


def diff_masks(
    adj_good: torch.Tensor,  # [V,V] good run's raw consequent adjacency
    is_goal: torch.Tensor,  # [V]
    node_mask: torch.Tensor,  # [V]
    label_id: torch.Tensor,  # [V]
    fail_bits: torch.Tensor,  # [F,L] one label bitset per failed run
    max_depth: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (node_keep [F,V], edge_keep [F,V,V], frontier_rule [F,V],
    missing_goal [F,V])."""
    num_labels = fail_bits.shape[-1]
    lid = label_id.clamp(0, num_labels - 1).long()
    # [V,V], shared across failed runs; directed DAG closure, so the corpus
    # longest-path bound caps the squaring chain.
    clo = closure(adj_good, max_len=max_depth)

    in_failed = fail_bits[:, lid] & (label_id >= 0)  # [F,V]
    ok = is_goal & node_mask & ~in_failed
    fwd = step_forward(ok, clo)  # >=0 hops from an ok goal
    bwd = step_backward(ok, clo)  # >=0 hops to an ok goal
    node_keep = fwd & bwd & node_mask
    edge_keep = adj_good & fwd[:, :, None] & bwd[:, None, :]

    root = is_goal & node_keep & ~in_degree_any(edge_keep)
    leaf = is_goal & node_keep & ~out_degree_any(edge_keep)
    dist = longest_depths(edge_keep, root, max_depth)
    neg = torch.tensor(NEG_INF, dtype=dist.dtype, device=dist.device)
    leaf_dist = torch.where(leaf & (dist >= 1), dist, neg)
    max_len = leaf_dist.amax(dim=-1, keepdim=True)  # [F,1]
    deepest_leaf = leaf & (dist == max_len)
    frontier_rule = (
        ~is_goal
        & node_keep
        & (dist + 1 == max_len)
        & (edge_keep & deepest_leaf[:, None, :]).any(dim=-1)
    )
    missing_goal = is_goal & node_keep & (edge_keep & frontier_rule[:, :, None]).any(dim=-2)
    return node_keep, edge_keep, frontier_rule, missing_goal


def diff_masks_host(
    edges,  # [E,2] int (src, dst) of the good run's consequent provenance
    n_nodes: int,
    is_goal,  # [V] bool (numpy)
    label_id,  # [V] int
    fail_bits,  # [F,L] bool
):
    """The host lane of the diff: diff_masks's semantics in numpy over the
    good run's edge list, O(F * (V + E)) instead of dense [V,V] planes.
    Port of the JAX package's ``ops/diff.py:diff_masks_host``.  The edge
    list is offset into one flat [F*V] node space (edges never cross run
    copies), so every failed run goes through each CSR frontier push and
    one vectorized Kahn longest-path wave together.

    Returns (node_keep [F,V], edge_keep [F,E] — a mask over ``edges``, the
    sparse_diff convention — frontier_rule [F,V], missing_goal [F,V])."""
    import numpy as np

    from .sparse_host import _expand, bfs_any, build_csr

    v = n_nodes
    e = len(edges)
    b = fail_bits.shape[0]
    n = b * v
    num_labels = fail_bits.shape[-1]
    label_id = np.asarray(label_id)
    is_goal = np.asarray(is_goal, dtype=bool)
    lid = np.clip(label_id, 0, num_labels - 1)

    # Per-run ok-goal masks, then everything batches in the flat space.
    in_failed = np.asarray(fail_bits, dtype=bool)[:, lid] & (label_id >= 0)[None, :]
    okf = (is_goal[None, :] & ~in_failed).ravel()
    goal_f = np.tile(is_goal, b)

    if e:
        src = np.asarray(edges[:, 0], dtype=np.int64)
        dst = np.asarray(edges[:, 1], dtype=np.int64)
        base = np.repeat(np.arange(b, dtype=np.int64) * v, e)
        fsrc = base + np.tile(src, b)
        fdst = base + np.tile(dst, b)
    else:
        fsrc = fdst = np.zeros(0, dtype=np.int64)
    fwd = build_csr(fsrc, fdst, n)
    bwd = build_csr(fdst, fsrc, n)

    # >=0-hop reach from / to an ok goal (start | >=1-hop push).
    keepf = (okf | bfs_any(*fwd, okf)) & (okf | bfs_any(*bwd, okf))
    ekf = keepf[fsrc] & keepf[fdst]
    ks, kd = fsrc[ekf], fdst[ekf]

    indeg = np.bincount(kd, minlength=n)
    outdeg = np.bincount(ks, minlength=n)
    root = goal_f & keepf & (indeg == 0)
    leaf = goal_f & keepf & (outdeg == 0)

    # Longest path from the roots: Kahn waves over the kept edges.  A node
    # enters the frontier only when its kept in-degree reaches zero, so its
    # distance is final when its out-edges relax.
    kptr, knbr = build_csr(ks, kd, n)
    dist = np.where(root, 0, NEG_INF)
    deg = indeg.copy()
    frontier = np.nonzero(keepf & (deg == 0))[0]
    while frontier.size:
        targets, cnt = _expand(kptr, knbr, frontier, return_counts=True)
        if not targets.size:
            break
        np.maximum.at(dist, targets, np.repeat(dist[frontier], cnt) + 1)
        np.subtract.at(deg, targets, 1)
        uniq = np.unique(targets)
        frontier = uniq[deg[uniq] == 0]

    leaf_dist = np.where(leaf & (dist >= 1), dist, NEG_INF).reshape(b, v)
    max_len = leaf_dist.max(axis=1) if v else np.full(b, NEG_INF)
    deepest_leaf = (leaf.reshape(b, v) & (dist.reshape(b, v) == max_len[:, None])).ravel()
    to_deepest = np.bincount(ks[deepest_leaf[kd]], minlength=n) > 0
    frontier_rule = ~goal_f & keepf & (dist + 1 == np.repeat(max_len, v)) & to_deepest
    from_frontier = np.bincount(kd[frontier_rule[ks]], minlength=n) > 0
    missing_goal = goal_f & keepf & from_frontier
    return keepf.reshape(b, v), ekf.reshape(b, e), frontier_rule.reshape(b, v), missing_goal.reshape(b, v)
