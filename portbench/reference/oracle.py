"""The reference's analysis: every verb of a report by direct traversal of
one run's property graph at a time.

A frozen copy of the port's property-graph oracle
(``backend/python_ref.py``, the Cypher semantics of at15/nemo's
graphing/*.go), with the base class's run choices and hazard figures
folded in.  It runs no device code and reads nothing the program made.
"""

from __future__ import annotations

import dataclasses

from .corrections import PostTrigger, PreTrigger, synthesize_corrections, synthesize_extensions
from .datatypes import Goal, MissingEvent, Rule
from .dot import DotGraph
from .figures import create_diff_dot, create_dot, create_hazard_dot
from .molly import MollyOutput
from .pgraph import PGraph, PNode, build_pgraph
from .triggers import extension_candidates, find_post_triggers, find_pre_triggers

CLEAN_OFFSET = 1000  # shadow run offset for simplified graphs (preprocessing.go:15)
DIFF_OFFSET = 2000  # shadow run offset for diff graphs (differential-provenance.go:40)


def choose_good_run(molly: MollyOutput) -> int | None:
    """The first status-success run that achieved the consequent, else the
    first status-success run, else None."""
    succ = molly.get_success_runs_iters()
    if not succ:
        return None
    by_iter = {r.iteration: r for r in molly.runs}
    for i in succ:
        if by_iter[i].time_post_holds:
            return i
    return succ[0]


def choose_baseline_run(molly: MollyOutput, good_iter: int | None) -> int | None:
    """The good run when one exists, else the first run."""
    if good_iter is not None:
        return good_iter
    return molly.runs[0].iteration if molly.runs else None


class Oracle:
    def __init__(self, molly: MollyOutput) -> None:
        self.molly = molly
        # (run_id, condition) -> graph, one dict per kind of graph: raw, and
        # the simplified and diff shadow runs under their offset run ids.
        self.graphs: dict[tuple[int, str], PGraph] = {}
        self.clean: dict[tuple[int, str], PGraph] = {}
        self.diffs: dict[tuple[int, str], PGraph] = {}
        self.good = choose_good_run(molly)
        self.baseline = choose_baseline_run(molly, self.good)

    def good_run_iter(self) -> int:
        if self.good is None:
            raise ValueError("no successful run to diff against")
        return self.good

    def baseline_run_iter(self) -> int:
        return self.baseline

    def create_hazard_analysis(self, iters: list[int]) -> list[DotGraph]:
        """Recolored space-time diagram per run (graphing/hazard-analysis.go:16-88)."""
        by_iter = {r.iteration: r for r in self.molly.runs}
        return [
            create_hazard_dot(self.molly.spacetime_dot_text(i), by_iter[i].time_pre_holds,
                              by_iter[i].time_post_holds)
            for i in iters
        ]

    # ------------------------------------------------------------------- load

    def load_raw_provenance(self) -> None:
        for run in self.molly.runs:
            for cond, prov in (("pre", run.pre_prov), ("post", run.post_prov)):
                g = build_pgraph(prov)
                self._mark_condition_holds(g, cond)
                self.graphs[(run.iteration, cond)] = g

    @staticmethod
    def _mark_condition_holds(g: PGraph, condition: str) -> None:
        """Reference: graphing/pre-post-prov.go:218-244 (see base.py)."""
        trigger_tables: set[str] = set()
        for root in g.roots():
            if not root.is_goal or root.table != condition:
                continue
            for rule_id in g.out[root.id]:
                rule = g.nodes[rule_id]
                if rule.is_goal or rule.table != condition:
                    continue
                for goal_id in g.out[rule_id]:
                    child = g.nodes[goal_id]
                    if child.is_goal:
                        trigger_tables.add(child.table)
        if trigger_tables:
            for node in g.nodes.values():
                if node.is_goal and (node.table == condition or node.table in trigger_tables):
                    node.cond_holds = True

    # --------------------------------------------------------------- simplify

    def simplify_prov(self, iters: list[int]) -> None:
        for i in iters:
            for cond in ("pre", "post"):
                clean = self._clean_copy(self.graphs[(i, cond)], i, cond)
                self._collapse_next_chains(clean, i, cond)
                self.clean[(CLEAN_OFFSET + i, cond)] = clean

    @staticmethod
    def _clean_copy(
        g: PGraph, iteration: int, cond: str, kept_rule_ids: set[str] | None = None
    ) -> PGraph:
        """Goal-[*0..]->Goal path restriction (preprocessing.go:17-27; see
        base.py for the degree-mask formulation).  Node IDs are rewritten from
        run_<i>_ to run_<1000+i>_ exactly as the reference's sed pass does
        (preprocessing.go:33-54).  `kept_rule_ids` lets a backend supply the
        kept-rule selection from its own store (Neo4jBackend's Cypher degree
        query) instead of the local degree check."""
        old_prefix = f"run_{iteration}_"
        new_prefix = f"run_{CLEAN_OFFSET + iteration}_"

        def rename(nid: str) -> str:
            return new_prefix + nid[len(old_prefix):] if nid.startswith(old_prefix) else nid

        out = PGraph()
        keep: set[str] = set()
        for node in g.nodes.values():
            if node.is_goal:
                keep.add(node.id)
            elif kept_rule_ids is not None:
                if node.id in kept_rule_ids:
                    keep.add(node.id)
            else:
                has_in = bool(g.inn[node.id])
                has_out = bool(g.out[node.id])
                if has_in and has_out:
                    keep.add(node.id)
        for nid in g.nodes:  # original insertion order (deterministic)
            if nid in keep:
                out.add_node(dataclasses.replace(g.nodes[nid], id=rename(nid)))
        for src, dst in g.edge_order:
            if src in keep and dst in keep:
                out.add_edge(rename(src), rename(dst))
        return out

    @staticmethod
    def _collapse_next_chains(g: PGraph, iteration: int, cond: str) -> None:
        """@next chain contraction (preprocessing.go:66-348; deterministic
        component semantics per base.py docstring), applied in place."""
        run = CLEAN_OFFSET + iteration
        next_rules = {n.id for n in g.nodes.values() if not n.is_goal and n.type == "next"}
        chain_goals = {
            n.id
            for n in g.nodes.values()
            if n.is_goal
            and any(p in next_rules for p in g.inn[n.id])
            and any(s in next_rules for s in g.out[n.id])
        }
        members = next_rules | chain_goals
        if not members:
            return

        # Weakly-connected components of the induced subgraph, discovered in
        # node insertion order for determinism.
        comp_of: dict[str, int] = {}
        components: list[list[str]] = []
        for start in g.nodes:
            if start not in members or start in comp_of:
                continue
            comp = []
            stack = [start]
            comp_of[start] = len(components)
            while stack:
                v = stack.pop()
                comp.append(v)
                for w in list(g.out[v]) + list(g.inn[v]):
                    if w in members and w not in comp_of:
                        comp_of[w] = len(components)
                        stack.append(w)
            components.append(comp)

        # Deterministic component order: by the insertion index of each
        # component's first head rule (matches the packed-array kernel, which
        # numbers collapsed rules by representative slot order).
        node_index = {nid: i for i, nid in enumerate(g.nodes)}
        ordered: list[tuple[int, list[str], list[str], list[str]]] = []
        for comp in components:
            comp_set = set(comp)
            comp_rules = [v for v in comp if v in next_rules]
            if len(comp_rules) < 2:
                continue  # a path needs two next rules (preprocessing.go:71)

            # Head rules: no predecessor chain goal within the component;
            # tail rules: no successor chain goal within the component.
            heads = sorted(
                (r for r in comp_rules if not any(p in comp_set for p in g.inn[r])),
                key=lambda r: node_index[r],
            )
            tails = [r for r in comp_rules if not any(s in comp_set for s in g.out[r])]
            rep_index = node_index[(heads or sorted(comp_rules, key=lambda r: node_index[r]))[0]]
            ordered.append((rep_index, comp, heads, tails))

        k = 0
        for _, comp, heads, tails in sorted(ordered):
            comp_set = set(comp)
            comp_rules = [v for v in comp if v in next_rules]
            # Preds/succs outside the component (preprocessing.go:146-245).
            preds: list[str] = []
            for r in heads:
                preds.extend(p for p in g.inn[r] if p not in comp_set and g.nodes[p].is_goal)
            succs: list[str] = []
            for r in tails:
                succs.extend(s for s in g.out[r] if s not in comp_set and g.nodes[s].is_goal)

            table = g.nodes[(heads or comp_rules)[0]].table
            label = f"{table}_collapsed"
            # ID format per preprocessing.go:252.
            coll_id = f"run_{run}_{cond}_{label}_{k}"
            k += 1
            g.add_node(
                PNode(id=coll_id, is_goal=False, label=label, table=table, type="collapsed")
            )
            for p in dict.fromkeys(preds):
                g.add_edge(p, coll_id)
            for s in dict.fromkeys(succs):
                g.add_edge(coll_id, s)
            for v in comp:
                g.remove_node(v)

    # ------------------------------------------------------------- prototypes

    def _achieved_pre(self, iteration: int) -> bool:
        """Any goal in the run's simplified antecedent graph with
        condition_holds (prototype.go:13-15, queried at run 1000+i)."""
        g = self.clean[(CLEAN_OFFSET + iteration, "pre")]
        return any(n.cond_holds for n in g.goals())

    def proto_rule_tables(self, iteration: int, condition: str) -> list[str]:
        """Ordered rule tables on root-[1]->rule-[*1..]->rule paths of the
        simplified graph (prototype.go:11-24), gated on achieving pre.
        Canonical order: (min rule-depth, table)."""
        if not self._achieved_pre(iteration):
            return []
        g = self.clean[(CLEAN_OFFSET + iteration, condition)]
        root_ids = [n.id for n in g.roots() if n.is_goal]
        if not root_ids:
            return []
        reach = set()
        for rid in root_ids:
            reach |= g.descendants(rid)
        qualifying: dict[str, int] = {}  # table -> min rule-depth
        # Rule-depth: number of rules on the shortest root path (BFS by hops).
        depth: dict[str, int] = {}
        frontier = list(root_ids)
        hops = 0
        seen = set(root_ids)
        while frontier:
            nxt = []
            for v in frontier:
                for w in g.out[v]:
                    if w not in seen:
                        seen.add(w)
                        depth[w] = hops + 1
                        nxt.append(w)
            frontier = nxt
            hops += 1
        for rid in reach:
            node = g.nodes[rid]
            if node.is_goal:
                continue
            has_rule_descendant = any(not g.nodes[d].is_goal for d in g.descendants(rid))
            has_rule_ancestor = any(
                not g.nodes[a].is_goal for a in g.coreachable_to([rid]) if a != rid and a in reach
            )
            if has_rule_descendant or has_rule_ancestor:
                rule_depth = (depth.get(rid, 0) + 1) // 2  # hops alternate goal/rule
                prev = qualifying.get(node.table)
                if prev is None or rule_depth < prev:
                    qualifying[node.table] = rule_depth
        return [t for t, _ in sorted(qualifying.items(), key=lambda kv: (kv[1], kv[0]))]

    def clean_rule_tables(self, iteration: int, condition: str) -> set[str]:
        """All distinct rule tables of the simplified graph (prototype.go:143-147)."""
        g = self.clean[(CLEAN_OFFSET + iteration, condition)]
        return {n.table for n in g.rules()}

    def proto_tables_by_run(
        self, success_iters: list[int], failed_iters: list[int]
    ) -> tuple[dict[int, list[str]], dict[int, set[str]]]:
        return (
            {i: self.proto_rule_tables(i, "post") for i in success_iters},
            {f: self.clean_rule_tables(f, "post") for f in failed_iters},
        )

    # ------------------------------------------------------------------- pull

    def pull_pre_post_prov(
        self, iters: list[int] | None = None
    ) -> tuple[list[DotGraph], list[DotGraph], list[DotGraph], list[DotGraph]]:
        run_ids = [r.iteration for r in self.molly.runs] if iters is None else list(iters)
        pre, post, pre_clean, post_clean = [], [], [], []
        for i in run_ids:
            pre.append(create_dot(self.graphs[(i, "pre")], "pre"))
            post.append(create_dot(self.graphs[(i, "post")], "post"))
            pre_clean.append(create_dot(self.clean[(CLEAN_OFFSET + i, "pre")], "pre"))
            post_clean.append(create_dot(self.clean[(CLEAN_OFFSET + i, "post")], "post"))
        return pre, post, pre_clean, post_clean

    # ------------------------------------------------------------------- diff

    def diff_graph(self, failed_iter: int) -> PGraph:
        """Good-minus-bad subgraph for one failed run (see base.py spec)."""
        g = self.good_run_iter()
        good = self.graphs[(g, "post")]
        bad = self.graphs[(failed_iter, "post")]
        fail_labels = {n.label for n in bad.goals()}
        ok_goals = [n.id for n in good.goals() if n.label not in fail_labels]
        fwd = good.reachable_from(ok_goals)  # >=0 hops from an ok goal
        bwd = good.coreachable_to(ok_goals)  # >=0 hops to an ok goal

        old_prefix = f"run_{g}_"
        new_prefix = f"run_{DIFF_OFFSET + failed_iter}_"

        def rename(nid: str) -> str:
            return new_prefix + nid[len(old_prefix):] if nid.startswith(old_prefix) else nid

        out = PGraph()
        for nid in good.nodes:
            if nid in fwd and nid in bwd:
                out.add_node(dataclasses.replace(good.nodes[nid], id=rename(nid)))
        for src, dst in good.edge_order:
            # Edge lies on an ok-goal->ok-goal path iff its source is
            # forward-reachable and its target backward-reachable; that also
            # implies both endpoints are in the node set.
            if src in fwd and dst in bwd:
                out.add_edge(rename(src), rename(dst))
        return out

    @staticmethod
    def _diff_missing(diff: PGraph) -> list[MissingEvent]:
        """Frontier of the diff graph: rules under the longest root->leaf
        paths plus all their goal children (differential-provenance.go:82-98)."""
        roots = [n.id for n in diff.roots() if n.is_goal]
        # Longest path DP over the DAG from roots.
        order: list[str] = []
        indeg = {nid: len(diff.inn[nid]) for nid in diff.nodes}
        stack = [nid for nid, d in indeg.items() if d == 0]
        while stack:
            v = stack.pop()
            order.append(v)
            for w in diff.out[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        dist = {nid: (0 if nid in roots else -(10**9)) for nid in diff.nodes}
        for v in order:
            for w in diff.out[v]:
                if dist[v] + 1 > dist[w]:
                    dist[w] = dist[v] + 1
        best = -1
        frontier_rules: dict[int, list[str]] = {}
        for nid, node in diff.nodes.items():
            if node.is_goal or not diff.out[nid]:
                continue
            for child in diff.out[nid]:
                cnode = diff.nodes[child]
                # The rule must itself lie on the maximal path: its own longest
                # root distance plus the final hop equals the leaf's distance
                # (length(path) = maxLen, differential-provenance.go:89-91).
                if (
                    cnode.is_goal
                    and not diff.out[child]
                    and dist[child] >= 1
                    and dist[nid] + 1 == dist[child]
                ):
                    frontier_rules.setdefault(dist[child], [])
                    if nid not in frontier_rules[dist[child]]:
                        frontier_rules[dist[child]].append(nid)
                    best = max(best, dist[child])
        if best < 0:
            return []
        missing = []
        for rid in sorted(frontier_rules[best]):
            rule = diff.nodes[rid]
            goals = sorted(
                (
                    diff.nodes[c]
                    for c in diff.out[rid]
                    if diff.nodes[c].is_goal  # all goal children, not only leaves (:94)
                ),
                key=lambda n: n.id,
            )
            missing.append(
                MissingEvent(
                    rule=Rule(id=rule.id, label=rule.label, table=rule.table, type=rule.type),
                    goals=[
                        Goal(
                            id=c.id,
                            label=c.label,
                            table=c.table,
                            time=c.time,
                            cond_holds=c.cond_holds,
                        )
                        for c in goals
                    ],
                )
            )
        return missing

    def create_naive_diff_prov(
        self,
        symmetric: bool,
        failed_iters: list[int],
        success_post_dot: DotGraph,
        dot_iters: list[int] | None = None,
    ) -> tuple[list[DotGraph], list[DotGraph], list[list[MissingEvent]]]:
        if not failed_iters:
            return [], [], []
        dot_set = set(failed_iters if dot_iters is None else dot_iters)
        diff_dots, failed_dots, missing_events = [], [], []
        good_iter = self.good_run_iter()
        for f in failed_iters:
            diff = self.diff_graph(f)
            self.diffs[(DIFF_OFFSET + f, "post")] = diff
            missing = self._diff_missing(diff)
            missing_events.append(missing)
            if f not in dot_set:
                continue
            diff_dot, failed_dot = create_diff_dot(
                DIFF_OFFSET + f, diff, self.graphs[(f, "post")], good_iter, success_post_dot, missing
            )
            diff_dots.append(diff_dot)
            failed_dots.append(failed_dot)
        return diff_dots, failed_dots, missing_events

    # ------------------------------------------------------------ corrections

    def find_pre_triggers(self, run: int) -> list[PreTrigger]:
        return find_pre_triggers(self.graphs[(run, "pre")])

    def find_post_triggers(self, run: int) -> list[PostTrigger]:
        return find_post_triggers(self.graphs[(run, "post")])

    def generate_corrections(self) -> list[str]:
        g = self.good_run_iter()
        return synthesize_corrections(self.find_pre_triggers(g), self.find_post_triggers(g))

    # ------------------------------------------------------------- extensions

    def achieved_pre_goal_counts(self) -> dict[int, int]:
        # Count goals with table == "pre" and condition_holds per raw
        # antecedent graph (extensions.go:25-50 counts goals, not runs).
        return {
            run.iteration: sum(
                1
                for n in self.graphs[(run.iteration, "pre")].goals()
                if n.table == "pre" and n.cond_holds
            )
            for run in self.molly.runs
        }

    def extension_suggestions(self) -> list[str]:
        candidates = extension_candidates(self.graphs[(self.baseline_run_iter(), "pre")])
        return synthesize_extensions(candidates)

    def synth_candidates(self, iters: list[int]) -> dict[int, list[str]]:
        # The per-run oracle: one PGraph walk per run, exactly what the
        # batched synth pass must reproduce per row.
        return {
            i: sorted(set(extension_candidates(self.graphs[(i, "pre")])))
            for i in iters
        }
