"""The comparisons that decide ``correct``: a report tree or a query
document of the program against the reference's.

Every comparison is exact: the number compared is the count of documents
that depart from the reference, and its limit is 0."""

from __future__ import annotations

import json
import os


def report_mismatches(report_dir: str, expected: dict) -> list[str]:
    """The documents of a program's report tree that depart from
    ``expected`` (reference/report.py:expected_report): ``debugging.json``
    run by run, ``repairs.json``, and every figure's ``.dot`` (a simplified
    graph's ``*_prov_clean.dot`` as a multiset of lines: the oracle adds a
    collapsed chain's rule after the graph's nodes, the program where the
    chain's head was) plus one ``.svg`` beside each ``.dot``."""
    bad: list[str] = []
    try:
        with open(os.path.join(report_dir, "debugging.json"), encoding="utf-8") as f:
            runs = json.load(f)
    except (OSError, ValueError) as ex:
        return [f"debugging.json: {type(ex).__name__}"]
    want = expected["debugging"]
    if not isinstance(runs, list) or len(runs) != len(want):
        bad.append(f"debugging.json: {len(runs) if isinstance(runs, list) else '?'} runs, want {len(want)}")
    else:
        bad += [f"debugging.json run {w.get('iteration')}" for g, w in zip(runs, want) if g != w]
    try:
        with open(os.path.join(report_dir, "repairs.json"), encoding="utf-8") as f:
            if json.load(f) != expected["repairs"]:
                bad.append("repairs.json")
    except (OSError, ValueError) as ex:
        bad.append(f"repairs.json: {type(ex).__name__}")
    fig_dir = os.path.join(report_dir, "figures")
    names = set(os.listdir(fig_dir)) if os.path.isdir(fig_dir) else set()
    want_figs = expected["figures"]
    want_names = set(want_figs) | {n[: -len(".dot")] + ".svg" for n in want_figs}
    bad += [f"figures/{n}: unexpected" for n in sorted(names - want_names)]
    bad += [f"figures/{n}: missing" for n in sorted(want_names - names)]
    for name in sorted(set(want_figs) & names):
        with open(os.path.join(fig_dir, name), encoding="utf-8") as f:
            text = f.read()
        if name.endswith("_prov_clean.dot"):
            same = sorted(text.splitlines()) == sorted(want_figs[name].splitlines())
        else:
            same = text == want_figs[name]
        if not same:
            bad.append(f"figures/{name}")
    return bad


def query_mismatch(doc: dict, expected: dict) -> bool:
    """A query document departs from the reference's: every key but the
    run's ``stats`` (cache and segment bookkeeping, not an answer)."""
    return {k: v for k, v in doc.items() if k != "stats"} != expected
