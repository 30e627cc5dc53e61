"""Condition-holds marking.

Array form of the reference's markConditionHolds Cypher
(graphing/pre-post-prov.go:218-244): find the root goal of the condition's
table (no incoming edge), its child rules of the same table, and THEIR child
goals g; if any such g exists, set condition_holds on every goal whose table
is the condition's or any g's.  Two masked BFS hops plus a table scatter,
batched over the run axis.  Port of the JAX package's ``ops/condition.py``.
"""

from __future__ import annotations

import torch

from .adjacency import in_degree_any, step_forward, table_bitset


def mark_condition_holds(
    adj: torch.Tensor,  # [B,V,V] bool
    is_goal: torch.Tensor,  # [B,V] bool
    table_id: torch.Tensor,  # [B,V] int
    node_mask: torch.Tensor,  # [B,V] bool
    cond_tid: int,
    num_tables: int,
) -> torch.Tensor:
    """Returns cond_holds [B,V] bool."""
    root = is_goal & node_mask & (table_id == cond_tid) & ~in_degree_any(adj)
    rule = step_forward(root, adj) & ~is_goal & node_mask & (table_id == cond_tid)
    trig = step_forward(rule, adj) & is_goal & node_mask
    return holds_of_triggers(trig, is_goal, table_id, node_mask, cond_tid, num_tables)


def holds_of_triggers(
    trig: torch.Tensor,
    is_goal: torch.Tensor,
    table_id: torch.Tensor,
    node_mask: torch.Tensor,
    cond_tid: int,
    num_tables: int,
) -> torch.Tensor:
    """cond_holds [B,V] from the trigger goals g [B,V]: every goal of the
    condition's table or of any g's table, where any g exists."""
    any_trig = trig.any(dim=-1, keepdim=True)
    trig_tables = table_bitset(trig, table_id, num_tables)  # [B,T]
    tid = table_id.clamp(0, num_tables - 1).long()
    in_trig_table = torch.gather(trig_tables, -1, tid) & (table_id >= 0)
    return is_goal & node_mask & any_trig & ((table_id == cond_tid) | in_trig_table)
