"""Success-prototype kernels.

Array form of the reference's extractProtos/missingFrom Cypher
(graphing/prototype.go:11-24, :143-147; corrected semantics per SURVEY.md §7):
per run, the rule tables on paths root-[1]->rule-[*1..]->rule from in-degree-0
goals of the simplified consequent graph — rules reachable from a root that
have a rule descendant or a reachable rule ancestor — gated on the run having
achieved the antecedent.  Cross-run intersection/union are AND/OR reductions
over the run axis.  Port of the JAX package's ``ops/proto.py``: the closure
route (``use_closure=True``, kernel K1) and the set-BFS route of the giant
step (``use_closure=False``).
"""

from __future__ import annotations

import torch

from .adjacency import (
    closure,
    in_degree_any,
    reach_ge1,
    step_backward,
    step_forward,
    table_bitset,
    table_min,
)

DEPTH_INF = 1 << 20


def hop_depths(adj: torch.Tensor, start: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Shortest hop distance [B,V] from start nodes, DEPTH_INF if unreachable;
    exactly max_depth relaxation steps."""
    inf = torch.tensor(DEPTH_INF, dtype=torch.int32, device=adj.device)
    depth = torch.where(start, torch.zeros_like(inf), inf)
    for _ in range(max_depth):
        stepped = torch.where(adj, depth[..., None], inf).amin(dim=-2) + 1
        depth = torch.minimum(depth, stepped)
    return depth


def _bfs_reach(start: torch.Tensor, adj: torch.Tensor, max_depth: int, backward: bool = False) -> torch.Tensor:
    """Set-BFS: nodes reachable from ``start`` in >= 1 hop (forward along
    edges, or backward with backward=True), over max_depth hops.
    O(max_depth * V^2): the giant step's alternative to the all-pairs
    closure."""
    hop = step_backward if backward else step_forward
    frontier = acc = hop(start, adj)
    for _ in range(max(0, max_depth - 1)):
        frontier = hop(frontier, adj)
        acc = acc | frontier
    return acc


def proto_rule_bits(
    adj: torch.Tensor,  # [B,V,V] simplified consequent adjacency
    is_goal: torch.Tensor,  # [B,V]
    alive: torch.Tensor,  # [B,V]
    table_id: torch.Tensor,  # [B,V]
    achieved_pre: torch.Tensor,  # [B] bool
    num_tables: int,
    max_depth: int,
    use_closure: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (bits [B,T] bool, min_rule_depth [B,T] int32).

    use_closure=False swaps the all-pairs closure for three bounded
    set-BFS sweeps (O(max_depth * V^2) instead of O(V^3 log V)): the giant
    step's route, exact when max_depth >= the longest path."""
    a = adj & alive[..., None] & alive[..., None, :]
    root = is_goal & alive & ~in_degree_any(a)
    is_rule = ~is_goal & alive
    if use_closure:
        # Directed DAG closure: path lengths are bounded by the corpus
        # longest-path bound, so the squaring chain shortens with it.
        clo = closure(a, max_len=max_depth)
        d1 = reach_ge1(a, clo)  # >=1-hop reachability
        reach = step_forward(root, d1)  # nodes >=1 hop below a root
        rule_desc = step_backward(is_rule, d1)  # has a rule strictly below
        rule_anc = step_forward(is_rule & reach, d1)  # has a reachable rule strictly above
    else:
        reach = _bfs_reach(root, a, max_depth)
        rule_desc = _bfs_reach(is_rule, a, max_depth, backward=True)
        rule_anc = _bfs_reach(is_rule & reach, a, max_depth)
    qualify = is_rule & reach & (rule_desc | rule_anc) & achieved_pre[..., None]

    depth = hop_depths(a, root, max_depth)
    rule_depth = torch.div(depth + 1, 2, rounding_mode="floor")  # hops alternate goal/rule

    bits = table_bitset(qualify, table_id, num_tables)
    min_depth = table_min(rule_depth, qualify, table_id, num_tables, DEPTH_INF)
    return bits, min_depth


def all_rule_bits(
    is_goal: torch.Tensor, alive: torch.Tensor, table_id: torch.Tensor, num_tables: int
) -> torch.Tensor:
    """[B,T]: distinct rule tables present in each simplified graph
    (missingFrom's MATCH (r:Rule), prototype.go:143-147)."""
    return table_bitset(~is_goal & alive, table_id, num_tables)


def reduce_protos(bits: torch.Tensor, achieved: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(intersection [T], union [T]) over achieving runs."""
    masked = bits & achieved[..., None]
    inter = (masked | ~achieved[..., None]).all(dim=0) & achieved.any()
    union = masked.any(dim=0)
    return inter, union
