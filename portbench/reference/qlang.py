"""The declarative query language: typed AST + compact text front end.

The reference exposed its provenance store through Cypher — the ten canned
analyses were just stored pattern queries (PAPER.md), and an analyst could
ask anything else.  This module reopens that generality over the packed
corpus: a query is a UNION of chain patterns over one condition's
provenance graphs, each chain a sequence of node predicates joined by
one-hop (``->``) or transitive (``-*->``) edges, with a run filter and an
order-insensitive aggregation.  ``query/plan.py`` lowers the AST onto the
existing batched CSR kernels; nothing here touches arrays.

Text form (whitespace-separated clauses, any order, ``match`` repeatable)::

    from pre
    match goal[holds=true] -> @rule[type=async] -> goal[holds=false] -> rule
    match goal[holds=false] -> @rule[type=async]
    where run.failed
    tables

* ``from pre|post`` — which condition's provenance graphs (default pre).
* ``match <chain>`` — one pattern; several ``match`` clauses union.  A step
  is ``goal``/``rule``/``node`` with an optional ``[field=value, ...]``
  predicate list (``=``/``!=``; quote values containing spaces).  Exactly
  one step per query may carry the ``@`` capture marker (default: the last
  step of each chain); matched capture nodes feed the aggregation.
* ``where run.all|run.failed|run.success`` — run filter (default all).
* aggregation — exactly one of ``tables`` (per-run sorted distinct capture
  tables + corpus distinct), ``count`` (per-run capture-node counts +
  corpus total), ``count by table`` (corpus histogram), ``runs`` (run
  iterations with >= 1 match).

Validation is LOUD (the env-knob ``policy="raise"`` precedent,
utils/env.py): unknown clause keywords, step kinds, fields, operators,
aggregations — and, at bind time, vocabulary names no corpus run ever
interned — all raise ``QueryError`` naming the junk token and the accepted
set.  A typo'd query silently matching nothing would be the analysis-layer
analog of a typo'd algorithm knob.
"""

# Copied from the JAX package's ``query/lang.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field

#: Bumped whenever AST canonicalization, planning, or result layout changes
#: meaning — part of every query content address (analysis/delta.py ABI
#: precedent), so stale cached results can never be served across versions.
QUERY_ABI_VERSION = 1

STEP_KINDS = ("goal", "rule", "node")
#: field -> (value domain, step kinds it applies to)
FIELDS = {
    "table": ("name", ("goal", "rule", "node")),
    "label": ("name", ("goal", "rule", "node")),
    "time": ("name", ("goal", "node")),
    "type": ("type", ("rule", "node")),
    "holds": ("bool", ("goal",)),
}
OPS = ("=", "!=")
TYPE_VALUES = ("", "async", "next", "collapsed")
GRAPHS = ("pre", "post")
RUN_FILTERS = ("all", "failed", "success")
AGGS = ("tables", "count", "count_by_table", "runs")


class QueryError(ValueError):
    """Malformed or unresolvable query — always raised loudly."""


@dataclass(frozen=True)
class Pred:
    """One node-local comparison: ``field op value``."""

    field: str
    op: str  # "=" | "!="
    value: str | bool

    def validate(self, kind: str) -> None:
        if self.field not in FIELDS:
            raise QueryError(
                f"unknown predicate field {self.field!r} "
                f"(expected one of {', '.join(FIELDS)})"
            )
        domain, kinds = FIELDS[self.field]
        if kind not in kinds:
            raise QueryError(
                f"field {self.field!r} does not apply to {kind!r} steps "
                f"(applies to: {', '.join(kinds)})"
            )
        if self.op not in OPS:
            raise QueryError(f"unknown operator {self.op!r} (expected = or !=)")
        if domain == "bool" and not isinstance(self.value, bool):
            raise QueryError(
                f"{self.field}= takes true/false, got {self.value!r}"
            )
        if domain == "type" and self.value not in TYPE_VALUES:
            raise QueryError(
                f"unknown rule type {self.value!r} "
                f"(expected one of: {', '.join(repr(t) for t in TYPE_VALUES)})"
            )


@dataclass(frozen=True)
class Step:
    """One chain position: a node-kind constraint plus predicates."""

    kind: str  # "goal" | "rule" | "node"
    preds: tuple = ()
    capture: bool = False

    def validate(self) -> None:
        if self.kind not in STEP_KINDS:
            raise QueryError(
                f"unknown step kind {self.kind!r} "
                f"(expected one of {', '.join(STEP_KINDS)})"
            )
        for p in self.preds:
            p.validate(self.kind)


#: hop kinds: one edge vs transitive closure (>= 1 hop)
HOP_ADJ, HOP_REACH = "adj", "reach"


@dataclass(frozen=True)
class Pattern:
    """A chain: steps[0] -hops[0]-> steps[1] ... (len(hops)=len(steps)-1)."""

    steps: tuple
    hops: tuple = ()

    def validate(self) -> None:
        if not self.steps:
            raise QueryError("empty pattern")
        if len(self.hops) != len(self.steps) - 1:
            raise QueryError(
                f"pattern has {len(self.steps)} steps but {len(self.hops)} hops"
            )
        for h in self.hops:
            if h not in (HOP_ADJ, HOP_REACH):
                raise QueryError(f"unknown hop {h!r} (expected -> or -*->)")
        for s in self.steps:
            s.validate()

    @property
    def capture_index(self) -> int:
        for i, s in enumerate(self.steps):
            if s.capture:
                return i
        return len(self.steps) - 1


@dataclass
class Query:
    """The full typed query: union of patterns + run filter + aggregation."""

    patterns: list = field(default_factory=list)
    graph: str = "pre"
    run_filter: str = "all"
    agg: str = "tables"

    def validate(self) -> "Query":
        if self.graph not in GRAPHS:
            raise QueryError(
                f"unknown graph {self.graph!r} (expected one of {', '.join(GRAPHS)})"
            )
        if self.run_filter not in RUN_FILTERS:
            raise QueryError(
                f"unknown run filter {self.run_filter!r} "
                f"(expected run.{' run.'.join(RUN_FILTERS)})"
            )
        if self.agg not in AGGS:
            raise QueryError(
                f"unknown aggregation {self.agg!r} "
                f"(expected one of {', '.join(AGGS)})"
            )
        if not self.patterns:
            raise QueryError("query has no match clause")
        for p in self.patterns:
            p.validate()
            if sum(1 for s in p.steps if s.capture) > 1:
                raise QueryError("at most one @capture step per pattern")
        return self

    # -- canonical form / content address ---------------------------------
    def to_json(self) -> dict:
        return {
            "graph": self.graph,
            "run_filter": self.run_filter,
            "agg": self.agg,
            "patterns": [
                {
                    "steps": [
                        {
                            "kind": s.kind,
                            "preds": [[p.field, p.op, p.value] for p in s.preds],
                            "capture": bool(s.capture),
                        }
                        for s in p.steps
                    ],
                    "hops": list(p.hops),
                }
                for p in self.patterns
            ],
        }

    def ast_hash(self) -> str:
        """Content address of the query MEANING: canonical AST + language
        ABI.  One half of every query cache key (the other half is the
        segment fingerprints, analysis/delta.py:blob_cache_key)."""
        doc = {"ast": self.to_json(), "query_abi": QUERY_ABI_VERSION}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()


# ---------------------------------------------------------------------------
# text front end
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<arrow>-\*->|->) |
        (?P<punct>[\[\],@]) |
        (?P<quoted>"[^"]*") |
        (?P<cmp>!=|=) |
        (?P<word>[^\s\[\],=!@"]+)
    )""",
    re.VERBOSE,
)

_CLAUSE_KEYWORDS = ("from", "match", "where", "tables", "count", "runs")


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise QueryError(f"cannot tokenize query at: {text[pos:pos + 20]!r}")
            break
        tok = m.group(m.lastgroup)
        if tok.strip():
            toks.append(tok)
        pos = m.end()
    return toks


class _Cursor:
    def __init__(self, toks: list[str]) -> None:
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> str:
        tok = self.peek()
        if tok is None:
            raise QueryError("unexpected end of query")
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.take()
        if got != tok:
            raise QueryError(f"expected {tok!r}, got {got!r}")


def _value(tok: str):
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    return tok


def _parse_step(cur: _Cursor) -> Step:
    capture = False
    if cur.peek() == "@":
        cur.take()
        capture = True
    kind = cur.take()
    if kind not in STEP_KINDS:
        raise QueryError(
            f"unknown step kind {kind!r} (expected one of {', '.join(STEP_KINDS)})"
        )
    preds = []
    if cur.peek() == "[":
        cur.take()
        while True:
            fld = cur.take()
            op = cur.take()
            if op not in OPS:
                raise QueryError(f"expected = or != after {fld!r}, got {op!r}")
            preds.append(Pred(field=fld, op=op, value=_value(cur.take())))
            sep = cur.take()
            if sep == "]":
                break
            if sep != ",":
                raise QueryError(f"expected , or ] in predicate list, got {sep!r}")
    return Step(kind=kind, preds=tuple(preds), capture=capture)


def _parse_chain(cur: _Cursor) -> Pattern:
    steps, hops = [_parse_step(cur)], []
    while cur.peek() in ("->", "-*->"):
        hops.append(HOP_REACH if cur.take() == "-*->" else HOP_ADJ)
        steps.append(_parse_step(cur))
    return Pattern(steps=tuple(steps), hops=tuple(hops))


def parse_query(text: str) -> Query:
    """Parse the compact text form into a validated :class:`Query`."""
    cur = _Cursor(_tokenize(text))
    q = Query(patterns=[])
    seen_agg = False
    while cur.peek() is not None:
        kw = cur.take()
        if kw == "from":
            q.graph = cur.take()
        elif kw == "match":
            q.patterns.append(_parse_chain(cur))
        elif kw == "where":
            run = cur.take()
            if not run.startswith("run."):
                raise QueryError(
                    f"where takes run.all/run.failed/run.success, got {run!r}"
                )
            q.run_filter = run[len("run."):]
        elif kw in ("tables", "count", "runs"):
            if seen_agg:
                raise QueryError("more than one aggregation clause")
            seen_agg = True
            if kw == "count" and cur.peek() == "by":
                cur.take()
                by = cur.take()
                if by != "table":
                    raise QueryError(f"count by {by!r} unsupported (expected table)")
                q.agg = "count_by_table"
            else:
                q.agg = kw
        else:
            raise QueryError(
                f"unknown clause {kw!r} "
                f"(expected one of {', '.join(_CLAUSE_KEYWORDS)})"
            )
    return q.validate()
