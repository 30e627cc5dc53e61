"""The reference query: one result document by set traversal of each run's
provenance graph, node by node and name by name.

The semantics follow the language (qlang.py) and the reference's
condition marking (at15/nemo graphing/pre-post-prov.go:218-244): a chain
``s0 h0 s1 ... sk`` captures, at its ``@`` step ``c``, every node that
satisfies step ``c`` and lies on some path whose i-th node satisfies step
i, with ``->`` one edge and ``-*->`` one or more.  Nothing here imports the
program: the graphs come from reference/molly.py's parse of the corpus's
raw files, and predicates compare names, not vocabulary ids.
"""

from __future__ import annotations

from .molly import MollyOutput
from .qlang import HOP_ADJ, Query


class _Graph:
    """One run's provenance graph: per node its kind, table, label, time and
    rule type, and both adjacency lists."""

    def __init__(self, prov) -> None:
        self.nodes: list[dict] = []
        slot: dict[str, int] = {}
        for g in prov.goals:
            slot[g.id] = len(self.nodes)
            self.nodes.append({"goal": True, "table": g.table, "label": g.label, "time": g.time, "type": ""})
        for r in prov.rules:
            slot[r.id] = len(self.nodes)
            self.nodes.append({"goal": False, "table": r.table, "label": r.label, "time": "", "type": r.type})
        self.succ: list[set] = [set() for _ in self.nodes]
        self.pred: list[set] = [set() for _ in self.nodes]
        for e in prov.edges:
            s, d = slot[e.src], slot[e.dst]
            self.succ[s].add(d)
            self.pred[d].add(s)

    def holds(self, cond: str) -> set:
        """Goals whose condition holds: the condition's own goals and those of
        every table a condition rule under a root condition goal derives
        from, once any such trigger exists."""
        n = self.nodes
        trig_tables = {
            n[c]["table"]
            for r in range(len(n)) if n[r]["goal"] and n[r]["table"] == cond and not self.pred[r]
            for rule in self.succ[r] if not n[rule]["goal"] and n[rule]["table"] == cond
            for c in self.succ[rule] if n[c]["goal"]
        }
        if not trig_tables:
            return set()
        return {i for i, x in enumerate(n) if x["goal"] and (x["table"] == cond or x["table"] in trig_tables)}

    def hop(self, state: set, kind: str, forward: bool) -> set:
        adj = self.succ if forward else self.pred
        if kind == HOP_ADJ:
            return {d for s in state for d in adj[s]}
        reach: set = set()
        frontier = state
        while frontier:
            frontier = {d for s in frontier for d in adj[s]} - reach
            reach |= frontier
        return reach


def _matches(node: dict, i: int, step, holds: set) -> bool:
    if step.kind != "node" and node["goal"] != (step.kind == "goal"):
        return False
    for p in step.preds:
        cur = (i in holds) if p.field == "holds" else node[p.field]
        if (cur == p.value) != (p.op == "="):
            return False
    return True


def _capture(g: _Graph, q: Query, cond: str) -> set:
    holds = g.holds(cond) if any(p.field == "holds" for pat in q.patterns for s in pat.steps for p in s.preds) \
        else set()
    cap: set = set()
    for pat in q.patterns:
        masks = [{i for i, x in enumerate(g.nodes) if _matches(x, i, s, holds)} for s in pat.steps]
        fwd = [masks[0]]
        for i, h in enumerate(pat.hops):
            fwd.append(masks[i + 1] & g.hop(fwd[i], h, True))
        ci = pat.capture_index
        bwd = masks[-1]
        for i in range(len(pat.hops) - 1, ci - 1, -1):
            bwd = masks[i] & g.hop(bwd, pat.hops[i], False)
        cap |= fwd[ci] & bwd
    return cap


def _value(agg: str, g: _Graph | None, cap: set):
    tables = [g.nodes[i]["table"] for i in cap] if g is not None else []
    if agg == "tables":
        return sorted(set(tables))
    if agg == "count":
        return len(cap)
    if agg == "runs":
        return bool(cap)
    hist: dict = {}
    for t in tables:
        hist[t] = hist.get(t, 0) + 1
    return hist


def expected_query(q: Query, molly: MollyOutput) -> dict:
    """The result document of ``q`` over the corpus, without ``stats``."""
    q.validate()
    if q.run_filter == "failed":
        runs = [r for r in molly.runs if not r.succeeded]
    elif q.run_filter == "success":
        runs = [r for r in molly.runs if r.succeeded]
    else:
        runs = list(molly.runs)
    per_run: dict = {}
    for r in runs:
        prov = r.pre_prov if q.graph == "pre" else r.post_prov
        g = _Graph(prov) if prov is not None and (prov.goals or prov.rules) else None
        per_run[r.iteration] = _value(q.agg, g, _capture(g, q, q.graph) if g is not None else set())
    keys = sorted(per_run)
    doc: dict = {"agg": q.agg, "graph": q.graph, "n_runs": len(runs)}
    if q.agg == "tables":
        doc["runs"] = {str(k): per_run[k] for k in keys}
        doc["distinct"] = sorted({t for v in per_run.values() for t in v})
    elif q.agg == "count":
        doc["runs"] = {str(k): per_run[k] for k in keys}
        doc["total"] = sum(per_run.values())
    elif q.agg == "runs":
        doc["runs"] = [k for k in keys if per_run[k]]
    else:
        hist: dict = {}
        for v in per_run.values():
            for t, n in v.items():
                hist[t] = hist.get(t, 0) + n
        doc["by_table"] = {t: hist[t] for t in sorted(hist)}
        doc["total"] = sum(hist.values())
    return doc
