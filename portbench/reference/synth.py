"""Corpus-ranked correction and extension candidates (repairs.json): the
reduce that ranks each run's candidates across the corpus by supporting
runs.  The per-run candidates come from oracle.py."""

# Copied from the JAX package's ``analysis/synth.py``, which the port was made
# from: its constant and ranking functions, the text the same; its route
# knobs, which read the program's settings, are left out.

from __future__ import annotations


#: Supporting-run links shown per ranked candidate (repairs.json
#: ``example_runs``): the smallest supporting iterations, ascending — a
#: deterministic, permutation-safe sample regardless of corpus size.
MAX_EXAMPLE_RUNS = 5


def correction_suggestion(table: str) -> str:
    """Presentation-ready repair line for one correction candidate (the
    report frontend renders it next to the support count)."""
    return f"<code>{table}(node, ...)</code>"


def extension_suggestion(table: str) -> str:
    """Presentation-ready hardening line for one extension candidate —
    the same clause shape as analysis/corrections.py:synthesize_extensions
    so the ranked list and the reference-format recommendation agree."""
    return f"<code>{table}(node, ...)@async :- ...;</code>"


def _rank(support: "dict[str, list[int]]", total: int, suggest) -> list[dict]:
    """Support dict (table -> supporting iterations) -> ranked candidate
    records, most-supported first, table name as the deterministic
    tiebreak.  Example runs are the smallest supporting iterations —
    independent of insertion (segment) order."""
    out = [
        {
            "table": t,
            "support": len(its),
            "total": total,
            "example_runs": sorted(its)[:MAX_EXAMPLE_RUNS],
            "suggestion": suggest(t),
        }
        for t, its in support.items()
    ]
    out.sort(key=lambda c: (-c["support"], c["table"]))
    return out


def correction_candidates(good_proto, present) -> list[str]:
    """The anti-join for ONE failed run: good-run prototype tables absent
    from the run's clean consequent graph, sorted.  ``present`` is the
    run's distinct clean rule tables (the fused kernels' proto_present
    row, already in every SegmentPartial)."""
    return sorted(set(good_proto or ()) - set(present or ()))


def build_repairs(
    good_proto,
    ext_by_run: "dict[int, list[str]]",
    present: "dict[int, list[str] | set[str]]",
    molly,
    good_iter: "int | None",
) -> dict:
    """The order-insensitive support-count reduce: merge per-run candidate
    sets into the corpus-ranked repair document (repairs.json).

    Pure function of (anchor table set, per-run candidate dicts, the
    corpus run order) — per-run dicts are iteration-keyed and disjoint
    across segments, so any merge order of partials feeds identical inputs
    here, and the ranking (support desc, table asc) plus the ascending
    example-run sample are order-free.  This is what makes ranked repairs
    rcache-cacheable per segment, streamable through the tree reduce, and
    delta-updatable when a grown corpus's new segment shifts the
    corpus-wide ranking."""
    failed_iters = molly.get_failed_runs_iters()
    run_iters = molly.get_runs_iters()

    corr_support: dict[str, list[int]] = {}
    if good_iter is not None and good_proto:
        for f in failed_iters:
            for t in correction_candidates(good_proto, present.get(f)):
                corr_support.setdefault(t, []).append(f)

    ext_support: dict[str, list[int]] = {}
    for r in run_iters:
        for t in ext_by_run.get(r, ()):
            ext_support.setdefault(t, []).append(r)

    return {
        "good_run": good_iter,
        "runs_total": len(run_iters),
        "failed_total": len(failed_iters),
        "corrections": _rank(corr_support, len(failed_iters), correction_suggestion),
        "extensions": _rank(ext_support, len(run_iters), extension_suggestion),
    }

