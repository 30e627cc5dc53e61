"""The fixed pattern verbs expressed as query programs.

A copy of the JAX package's ``query/verbs.py``.  The pattern-shaped
analysis verbs (the reference's Cypher queries corrections.go:30-34,
corrections.go:121-125, extensions.go:63-67, and the achieved-antecedent
gate) each have a query program here whose result equals, byte for byte,
the native verb's.  :func:`native_verb_result` computes the same per-run
map through the fixed verb path of ``TorchBackend``, so a parity check
compares two documents derived independently.
"""

from __future__ import annotations

from nemo_tpu_torch.query.lang import HOP_ADJ, Pattern, Pred, Query, Step

_GOAL_HOLDS = Step(kind="goal", preds=(Pred("holds", "=", True),))
_GOAL_NOHOLD = Step(kind="goal", preds=(Pred("holds", "=", False),))
_RULE = Step(kind="rule")
_ASYNC = Step(kind="rule", preds=(Pred("type", "=", "async"),), capture=True)


def _chain(*steps: Step) -> Pattern:
    return Pattern(steps=tuple(steps), hops=(HOP_ADJ,) * (len(steps) - 1))


#: verb name -> the query program computing it (all validated at import).
VERB_QUERIES: dict[str, Query] = {
    # Per-run achieved-antecedent goal count — the extensions gate
    # (backend.achieved_pre_goal_counts): pre-condition goals whose
    # condition holds, table == "pre".
    "achieved_pre": Query(
        graph="pre",
        agg="count",
        patterns=[
            Pattern(
                steps=(
                    Step(
                        kind="goal",
                        preds=(
                            Pred("holds", "=", True),
                            Pred("table", "=", "pre"),
                        ),
                        capture=True,
                    ),
                )
            )
        ],
    ),
    # Pre-correction triggers (corrections.go:30-34 /
    # analysis/queries.py:find_pre_triggers): aggregation rules `a` with a
    # holding goal above and a non-holding goal below that still derives —
    # captured as the distinct trigger-rule tables per run.
    "pre_triggers": Query(
        graph="pre",
        agg="tables",
        patterns=[
            _chain(
                _GOAL_HOLDS,
                Step(kind="rule", capture=True),
                _GOAL_NOHOLD,
                _RULE,
            )
        ],
    ),
    # Post-correction triggers (corrections.go:121-125 /
    # find_post_triggers): rules below a rule-derived holding goal whose
    # own child goal fails but still derives.
    "post_triggers": Query(
        graph="post",
        agg="tables",
        patterns=[
            _chain(
                _RULE,
                _GOAL_HOLDS,
                Step(kind="rule", capture=True),
                _GOAL_NOHOLD,
                _RULE,
            )
        ],
    ),
    # Extension candidates (extensions.go:63-67 / the batched synth verb,
    # ops/sparse_{device,host}.py:synth_ext_*): async rules on the
    # antecedent's condition boundary — the union of the two reference
    # disjuncts, each a chain capturing the async rule.
    "ext_candidates": Query(
        graph="pre",
        agg="tables",
        patterns=[
            _chain(_GOAL_HOLDS, _ASYNC, _GOAL_NOHOLD, _RULE),  # cond_a
            _chain(_GOAL_NOHOLD, _ASYNC),  # cond_b
        ],
    ),
}

for _q in VERB_QUERIES.values():
    _q.validate()


def verb_query(name: str) -> Query:
    """The query program for one fixed verb (loud on unknown names)."""
    if name not in VERB_QUERIES:
        raise KeyError(
            f"unknown verb {name!r} (expected one of {', '.join(VERB_QUERIES)})"
        )
    return VERB_QUERIES[name]


def run_verb(name: str, molly, **kw) -> dict:
    """Execute one fixed verb through the query engine."""
    from nemo_tpu_torch.query.engine import execute_query

    return execute_query(verb_query(name), molly, **kw)


def native_verb_result(name: str, backend) -> dict:
    """The native verb's per-run result, shaped like the query document's
    ``runs`` map: the reference for :func:`run_verb`.  ``backend`` is a
    ``TorchBackend`` that has ingested its corpus (``init_graph_db``).  The
    trigger verbs walk the raw property graphs whose condition holds come
    from the fused step (``raw_graph``), the extension candidates come from
    the batched synth verb, the achieved counts from the fused step."""
    from nemo_tpu_torch.analysis.queries import find_post_triggers, find_pre_triggers

    molly = backend.molly
    if name == "achieved_pre":
        return {str(k): v for k, v in backend.achieved_pre_goal_counts().items()}
    if name == "ext_candidates":
        iters = [r.iteration for r in molly.runs]
        return {str(k): v for k, v in backend.synth_candidates(iters).items()}
    if name == "pre_triggers":
        backend.load_raw_provenance()
        return {
            str(r.iteration): sorted({t.agg.table for t in find_pre_triggers(backend.raw_graph(r.iteration, "pre"))})
            for r in molly.runs
        }
    if name == "post_triggers":
        backend.load_raw_provenance()
        return {
            str(r.iteration): sorted({t.rule.table for t in find_post_triggers(backend.raw_graph(r.iteration, "post"))})
            for r in molly.runs
        }
    raise KeyError(f"unknown verb {name!r}")
