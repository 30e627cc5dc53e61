"""Corpus-ranked correction and extension candidates (repairs.json), a copy
of the JAX package's ``analysis/synth.py`` without its route knobs: the
port's per-run candidates come from TorchBackend.synth_candidates.

The reference computes corrections and extensions from ONE run (the good
run's triggers, the baseline run's async boundary).  Here candidates are
extracted per run and ranked across the corpus by supporting-run count:

  * **corrections**: tables of the good run's prototype that a failed run's
    clean consequent graph lacks; support = failed runs lacking it.
  * **extensions**: async rules adjacent to the antecedent's condition
    boundary (extensions.go:63-67), per run; support = runs with it.

The ranking depends only on the per-run sets and the corpus run order, so
it does not depend on how runs were batched.
"""

from __future__ import annotations

#: Supporting-run links shown per ranked candidate (repairs.json
#: ``example_runs``): the smallest supporting iterations, ascending.
MAX_EXAMPLE_RUNS = 5


def correction_suggestion(table: str) -> str:
    """Presentation-ready repair line for one correction candidate."""
    return f"<code>{table}(node, ...)</code>"


def extension_suggestion(table: str) -> str:
    """Presentation-ready hardening line for one extension candidate, the
    clause shape of analysis/corrections.py:synthesize_extensions."""
    return f"<code>{table}(node, ...)@async :- ...;</code>"


def _rank(support: dict[str, list[int]], total: int, suggest) -> list[dict]:
    """Support dict (table -> supporting iterations) -> ranked candidate
    records, most-supported first, table name as the tiebreak."""
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
    from the run's clean consequent graph, sorted."""
    return sorted(set(good_proto or ()) - set(present or ()))


def build_repairs(
    good_proto,
    ext_by_run: dict[int, list[str]],
    present: dict[int, list[str] | set[str]],
    molly,
    good_iter: int | None,
) -> dict:
    """Per-run candidate sets -> the corpus-ranked repair document."""
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
