"""Host-side PGraph pattern queries shared by backends.

The trigger patterns behind corrections/extensions only ever run on run 0's
raw provenance (corrections.go:210-216, extensions.go:63-67) — they are O(one
small graph) host work, not batch workloads — so both backends share these
free functions; the JAX backend feeds them PGraphs whose condition_holds came
from the device kernels.
"""

# Copied from the JAX package's ``analysis/queries.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

from .pgraph import PGraph
from .datatypes import Goal, Rule

from .corrections import PostTrigger, PreTrigger, parse_receiver


def _goal_of(node, receiver: bool = True) -> Goal:
    return Goal(
        id=node.id,
        label=node.label,
        table=node.table,
        time=node.time,
        cond_holds=node.cond_holds,
        receiver=parse_receiver(node.label, node.table) if receiver else "",
    )


def _rule_of(node) -> Rule:
    return Rule(id=node.id, label=node.label, table=node.table, type=node.type)


def find_pre_triggers(g: PGraph) -> list[PreTrigger]:
    """(a:Rule)->(g:Goal !holds)->(r:Rule) with a holding goal above a
    (reference: corrections.go:30-34), in node/edge order."""
    out = []
    for a in g.nodes.values():
        if a.is_goal:
            continue
        if not any(g.nodes[p].is_goal and g.nodes[p].cond_holds for p in g.inn[a.id]):
            continue
        for gid in g.out[a.id]:
            goal = g.nodes[gid]
            if not goal.is_goal or goal.cond_holds:
                continue
            for rid in g.out[gid]:
                rule = g.nodes[rid]
                if rule.is_goal:
                    continue
                out.append(PreTrigger(agg=_rule_of(a), goal=_goal_of(goal), rule=_rule_of(rule)))
    return out


def find_post_triggers(g: PGraph) -> list[PostTrigger]:
    """(g:Goal holds)->(r:Rule) with a rule above g and a non-holding goal
    below r that itself has a rule below (reference: corrections.go:121-125)."""
    out = []
    for goal in g.nodes.values():
        if not goal.is_goal or not goal.cond_holds:
            continue
        if not any(not g.nodes[p].is_goal for p in g.inn[goal.id]):
            continue
        for rid in g.out[goal.id]:
            rule = g.nodes[rid]
            if rule.is_goal:
                continue
            qualifies = any(
                g.nodes[c].is_goal
                and not g.nodes[c].cond_holds
                and any(not g.nodes[cr].is_goal for cr in g.out[c])
                for c in g.out[rid]
            )
            if qualifies:
                out.append(PostTrigger(goal=_goal_of(goal), rule=_rule_of(rule)))
    return out


def extension_candidates(g: PGraph) -> list[str]:
    """Async rules adjacent to the antecedent's condition boundary:
    (holding goal)->r->(non-holding goal)->(rule) OR (non-holding goal)->r
    (reference: extensions.go:63-67).  Returns rule tables (with repeats)."""
    candidates = []
    for r in g.nodes.values():
        if r.is_goal or r.type != "async":
            continue
        cond_a = any(
            g.nodes[p].is_goal and g.nodes[p].cond_holds for p in g.inn[r.id]
        ) and any(
            g.nodes[c].is_goal
            and not g.nodes[c].cond_holds
            and any(not g.nodes[cr].is_goal for cr in g.out[c])
            for c in g.out[r.id]
        )
        cond_b = any(g.nodes[p].is_goal and not g.nodes[p].cond_holds for p in g.inn[r.id])
        if cond_a or cond_b:
            candidates.append(r.table)
    return candidates
