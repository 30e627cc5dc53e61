"""The query planner: lower a validated AST onto the batched kernel family.

A copy of the JAX package's ``query/plan.py``.  A :class:`QueryPlan` is the
symbolic lowering: per pattern, a conjunction of plane comparisons per step
plus the hop sequence, with the derived planes (condition holds, the time
plane) hoisted out so the executor builds each at most once per bucket.
Binding resolves predicate NAMES to vocabulary ids: the plan stays
name-keyed, the bound form is a flat hashable tuple.

Pattern evaluation is the forward/backward chain intersection on the
frontier primitives (ops/sparse_device.py ``_push_any`` / ``_reach_any``,
whose fix point is kernel K2; ops/sparse_host.py ``scat_any`` /
``bfs_any``)::

    f[0]   = mask(step 0)
    f[i]   = mask(step i) & hop_fwd(f[i-1])     (one wave, or >=1-hop reach)
    b[k]   = mask(step k)
    b[i]   = mask(step i) & hop_bwd(b[i+1])     (same wave, edges reversed)
    capture= f[ci] & b[ci]

``f[i] & b[i]`` is exact for chains: forward support proves a prefix path
into the node, backward support a suffix path out of it, and predicates are
node-local.  The query's capture set is the union over patterns, so every
aggregation is an order-insensitive reduce.
"""

from __future__ import annotations

from dataclasses import dataclass

from nemo_tpu_torch import obs
from nemo_tpu_torch.graphs.packed import _TYPE_IDS
from nemo_tpu_torch.query.lang import FIELDS, HOP_ADJ, Query, QueryError

#: Bound-predicate id of a name NO run of the bound vocabulary interned:
#: planes hold ids >= -1 (-1 = padding), so -2 never compares equal.  The
#: corpus-level check that raises on an unknown name runs before binding
#: (:meth:`QueryPlan.validate_names`).
_NO_ID = -2

_NAME_VOCABS = {"table": "tables", "label": "labels", "time": "times"}


@dataclass(frozen=True)
class PatternPlan:
    """One lowered chain: per-step test tuples, hops, capture index."""

    #: per step: tuple of atomic tests, each ("kind", k) / (field, op, value)
    steps: tuple
    hops: tuple
    capture: int


@dataclass(frozen=True)
class QueryPlan:
    """The symbolic plan: name-keyed, hashable, content-addressed."""

    graph: str
    cond_tid: int  # pinned condition table id: "pre"=0 / "post"=1
    run_filter: str
    agg: str
    needs_holds: bool
    needs_time: bool
    patterns: tuple
    key: str  # == Query.ast_hash(): the plan is a pure function of the AST

    def names(self) -> dict:
        """Vocabulary names the plan references, per name-valued field."""
        out: dict = {f: set() for f in _NAME_VOCABS}
        for p in self.patterns:
            for step in p.steps:
                for test in step:
                    if test[0] in _NAME_VOCABS:
                        out[test[0]].add(test[2])
        return out

    def validate_names(self, vocab) -> None:
        """Raise on a name no run of the corpus interned: a typo, not an
        empty result."""
        for fld, wanted in self.names().items():
            voc = getattr(vocab, _NAME_VOCABS[fld])
            for name in sorted(wanted):
                if voc.lookup(name) < 0:
                    raise QueryError(
                        f"unknown {fld} {name!r}: no run in this corpus "
                        f"defines it (vocabulary has {len(voc)} {fld}s)"
                    )

    def bind(self, vocab) -> tuple:
        """Resolve names to ids against one vocabulary: ``(patterns,
        needs_holds, cond_tid)`` with every test a ``(plane, op, int)``
        triple (or ``("kind", k)``)."""

        def bind_test(test: tuple) -> tuple:
            if test[0] == "kind":
                return test
            fld, op, val = test
            if fld in _NAME_VOCABS:
                vid = getattr(vocab, _NAME_VOCABS[fld]).lookup(val)
                return (fld, op, int(vid) if vid >= 0 else _NO_ID)
            if fld == "type":
                return (fld, op, _TYPE_IDS[val])
            return (fld, op, bool(val))  # holds

        pats = tuple(
            (tuple(tuple(bind_test(t) for t in step) for step in p.steps), p.hops, p.capture)
            for p in self.patterns
        )
        return (pats, self.needs_holds, self.cond_tid)

    def describe(self) -> list[str]:
        """The lowered kernel sequence, one line per primitive (``query
        --explain``)."""
        out = [f"select graph={self.graph} runs={self.run_filter}"]
        if self.needs_holds:
            out.append(f"condition_holds tid={self.cond_tid}")
        for pi, p in enumerate(self.patterns):
            for si, step in enumerate(p.steps):
                tests = " & ".join(
                    f"kind={t[1]!r}" if t[0] == "kind" else f"{t[0]}{t[1]}{t[2]!r}" for t in step
                )
                out.append(f"p{pi} mask s{si}: {tests}")
            for hi, hop in enumerate(p.hops):
                kern = "push_any" if hop == HOP_ADJ else "reach_any"
                out.append(f"p{pi} fwd {kern} s{hi}->s{hi + 1}")
            for hi in range(len(p.hops) - 1, -1, -1):
                kern = "push_any" if p.hops[hi] == HOP_ADJ else "reach_any"
                out.append(f"p{pi} bwd {kern} s{hi + 1}->s{hi}")
            out.append(f"p{pi} capture s{p.capture}: fwd & bwd")
        out.append(f"reduce {self.agg}")
        return out


def plan_query(q: Query) -> QueryPlan:
    """Lower a validated query to its plan; the plan key is the AST hash."""
    q.validate()
    needs_holds = needs_time = False
    pats = []
    for p in q.patterns:
        steps = []
        for s in p.steps:
            tests: list = [("kind", s.kind)]
            for pred in s.preds:
                needs_holds |= pred.field == "holds"
                needs_time |= pred.field == "time"
                tests.append((pred.field, pred.op, pred.value))
            steps.append(tuple(tests))
        pats.append(PatternPlan(steps=tuple(steps), hops=p.hops, capture=p.capture_index))
    plan = QueryPlan(
        graph=q.graph,
        cond_tid=0 if q.graph == "pre" else 1,  # CorpusVocab pins pre=0/post=1
        run_filter=q.run_filter,
        agg=q.agg,
        needs_holds=needs_holds,
        needs_time=needs_time,
        patterns=tuple(pats),
        key=q.ast_hash(),
    )
    obs.metrics.inc("query.plans")
    return plan


# Every field the language admits has a lowering here.
assert set(_NAME_VOCABS) | {"type", "holds"} == set(FIELDS)
