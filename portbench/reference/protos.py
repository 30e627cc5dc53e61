"""Prototype set algebra shared by all backends.

Backends produce, per achieving run, an ordered list of rule tables (the
"skeleton" of how the consequent was derived); this module computes the
intersection- and union-prototypes and per-failed-run missing lists
(reference: graphing/prototype.go:80-130, :141-206).
"""

# Copied from the JAX package's ``analysis/protos.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations


def intersect_proto(per_run_tables: list[list[str]], condition: str) -> list[str]:
    """Rule tables present in EVERY condition-achieving run.

    Mirrors prototype.go:80-109: iterate the first run's list in order, keep
    entries found in all non-empty (achieving) lists, excluding the condition
    table itself.  Empty first list -> empty result (also mirrored).
    """
    achieving = [t for t in per_run_tables if t]
    if not achieving:
        return []
    first = achieving[0]
    rest = achieving[1:]
    out = []
    for table in first:
        if table == condition:
            continue
        if all(table in other for other in rest):
            out.append(table)
    return out


def union_proto(per_run_tables: list[list[str]], condition: str) -> list[str]:
    """All rule tables seen in any achieving run, interleaved positionally in
    first-seen order (prototype.go:112-130): position 0 of every run, then
    position 1, ..., skipping duplicates and the condition table."""
    achieving = [t for t in per_run_tables if t]
    if not achieving:
        return []
    longest = max(len(t) for t in achieving)
    seen: set[str] = set()
    out: list[str] = []
    for pos in range(longest):
        for tables in achieving:
            if pos < len(tables):
                table = tables[pos]
                if table != condition and table not in seen:
                    seen.add(table)
                    out.append(table)
    return out


def missing_from(proto: list[str], present_tables: set[str]) -> list[str]:
    """Prototype entries absent from a failed run's rule tables, wrapped in
    <code> for the report (prototype.go:189-197)."""
    return [f"<code>{t}</code>" for t in proto if t not in present_tables]


def wrap_code(items: list[str]) -> list[str]:
    """Presentation wrapper applied to final prototypes (prototype.go:245-251)."""
    return [f"<code>{t}</code>" for t in items]
