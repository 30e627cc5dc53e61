"""Correction and extension string synthesis, shared by all backends.

Backends extract trigger tuples from run 0's provenance (by Cypher-equivalent
pattern matching); this module turns them into the presentation-ready HTML
recommendation strings, format-identical to the reference
(graphing/corrections.go:202-328, graphing/extensions.go:13-99).

Determinism: the reference iterates Go maps here, so its output order is
nondeterministic (and its maps are keyed by pointer, so same-table triggers
are never actually merged).  Canonical order in this rebuild: aggregation
tables sorted; triggers of one aggregation in provenance edge order;
consequent triggers sorted by (receiver, table).
"""

# Copied from the JAX package's ``analysis/corrections.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

from dataclasses import dataclass

from .datatypes import Goal, Rule


def parse_receiver(label: str, table: str) -> str:
    """First argument of a goal label, e.g. 'log(b, foo)' -> 'b'.

    The reference trims the label with the table name as a TrimLeft *cutset*
    then splits on ', ' (corrections.go:65-67); this strips the table as a
    proper prefix instead, which agrees on every well-formed label and avoids
    over-trimming when an argument starts with a letter of the table name.
    """
    rest = label[len(table):] if label.startswith(table) else label
    rest = rest.strip("()")
    parts = rest.split(", ")
    return parts[0] if parts else ""


@dataclass
class PreTrigger:
    """One antecedent trigger chain: aggregation rule just below a holding
    goal, the non-holding goal under it, and that goal's rule
    (reference: corrections.go:30-34, the (a)->(g)->(r) match)."""

    agg: Rule
    goal: Goal
    rule: Rule


@dataclass
class PostTrigger:
    """One consequent trigger pair: holding non-root goal and the rule below
    it that leads to a non-holding goal (reference: corrections.go:121-125)."""

    goal: Goal
    rule: Rule


def synthesize_corrections(
    pre_triggers: list[PreTrigger], post_triggers: list[PostTrigger]
) -> list[str]:
    """Build correction recommendations (reference: corrections.go:202-328).

    For each antecedent aggregation table: reconstruct its trigger clause; if
    all consequent triggers fire on the same node, append their tables to the
    antecedent body (local order suffices); otherwise synthesize an
    ack_<rule>@async message round per differing consequent trigger and a
    buffer_<rule>@next persistence scheme per non-next antecedent trigger,
    ending with the old=>new rule rewrite.
    """
    recs: list[str] = []

    # Group pre triggers by aggregation table, preserving extraction order.
    by_table: dict[str, list[PreTrigger]] = {}
    for t in pre_triggers:
        by_table.setdefault(t.agg.table, []).append(t)

    posts = sorted(post_triggers, key=lambda p: (p.goal.receiver, p.goal.table))

    for agg_table in sorted(by_table):
        triggers = by_table[agg_table]

        # Compound trigger clause (corrections.go:231-243).
        clause = ""
        for t in triggers:
            if not clause:
                clause = (
                    f"{agg_table}({t.goal.receiver}, ...) :- "
                    f"{t.rule.table}({t.goal.receiver}, ...)"
                )
            else:
                clause = f"{clause}, {t.rule.table}({t.goal.receiver}, ...)"

        # Consequent triggers on a different node than a pre trigger goal
        # force a communication round (corrections.go:245-259).
        differing = [
            (t, p)
            for t in triggers
            for p in posts
            if t.goal.receiver != p.goal.receiver
        ]

        agg_new = clause
        if not differing:
            # Same node everywhere: local order suffices (corrections.go:264-272).
            for p in posts:
                agg_new = f"{agg_new}, {p.goal.table}({p.goal.receiver}, ...)"
        else:
            # Message round per (pre node, post trigger) pair (corrections.go:279-294).
            seen_pairs: set[tuple[str, str, str]] = set()
            for t, p in differing:
                pre_node = t.goal.receiver
                post_node = p.goal.receiver
                post_rule = p.goal.table
                key = (pre_node, post_node, post_rule)
                if key in seen_pairs:
                    continue
                seen_pairs.add(key)
                recs.append(
                    f"<code>{pre_node}</code> needs to know that <code>{post_node}</code> "
                    f"has executed <code>{post_rule}</code>. Add:<br /> &nbsp; &nbsp; "
                    f"&nbsp; &nbsp; <code>ack_{post_rule}({pre_node}, ...)@async :- "
                    f"{post_rule}({post_node}, ...), ...;</code>"
                )
                agg_new = f"{agg_new}, ack_{post_rule}({pre_node}, sender={post_node}, ...)"

            # Persistence scheme for one-shot antecedent triggers
            # (corrections.go:297-317).
            for t in triggers:
                if t.rule.type != "next":
                    rule, node = t.rule.table, t.goal.receiver
                    recs.append(
                        "Antecedent depends on timing of an onetime event. Make it "
                        "persistent. Add:<br /> &nbsp; &nbsp; &nbsp; &nbsp; "
                        f"<code>buffer_{rule}({node}, ...) :- {rule}({node}, ...), ...;"
                        "</code><br /> &nbsp; &nbsp; &nbsp; &nbsp; "
                        f"<code>buffer_{rule}({node}, ...)@next :- buffer_{rule}({node}, "
                        "...), ...;"
                    )
                    agg_new = agg_new.replace(
                        f"{rule}({node}, ...)", f"buffer_{rule}({node}, ...)"
                    )

        recs.append(
            f"Change: <code>{clause};</code> &nbsp; "
            '<i class = "fas fa-long-arrow-alt-right"></i> &nbsp; '
            f"<code>{agg_new};</code>"
        )

    return recs


def synthesize_extensions(async_rule_tables: list[str]) -> list[str]:
    """One hardening suggestion per distinct async rule table adjacent to the
    antecedent's condition boundary (reference: extensions.go:77-90), sorted."""
    return [
        f"<code>{table}(node, ...)@async :- ...;</code>"
        for table in sorted(set(async_rule_tables))
    ]
