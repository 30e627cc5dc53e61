"""Neo4jBackend: GraphBackend over a live Neo4j server via Bolt, a copy of the
JAX package's ``backend/neo4j_backend.py`` over the port's own Bolt client
(backend/bolt/).  Every statement is that module's, character for character.

This is the rebuild of the reference's only backend (the `Neo4J` struct,
graphing/pre-post-prov.go:16-20, speaking Bolt through its vendored Go
driver).  The storage model is identical — one `:Goal` node per goal with
props {id, run, condition, label, table, time, condition_holds}
(pre-post-prov.go:27-58), one `:Rule` per rule (:90-118), `[:DUETO]` edges
(:150-195), simplified shadow graphs at run 1000+i (preprocessing.go:15) and
diff graphs at 2000+i (differential-provenance.go:40).

Differences from the reference mechanics (behavior preserved; see SURVEY.md
§7 step 2, which calls these out as pure implementation details):

  * bulk loads are batched `UNWIND $rows CREATE` statements instead of one
    Bolt round-trip per node/edge (the reference's dominant cost,
    pre-post-prov.go:36-58) — count verification after each bulk load is
    kept (:84-86, :144-146, :208-210);
  * the APOC-export → `docker exec sed` → re-import dance used for shadow-run
    copies (preprocessing.go:17-57, differential-provenance.go:22-79) is
    replaced by in-process id rewriting + parameterized CREATE;
  * a `seq` property on nodes/edges preserves insertion order across pulls,
    making every downstream ordering deterministic (the reference's map
    iteration makes its own output order nondeterministic — SURVEY.md §7
    hard part 5);
  * host-side passes (chain components, diff closure, trigger/prototype/
    correction synthesis) reuse the same shared analysis code as the other
    backends, exactly as the reference runs them in Go on query results.

Every statement carries a `// nemo:<verb>` marker comment; the in-process
fake server used by the tests dispatches on it (tests/test_neo4j_backend.py),
which lets the full backend run end-to-end without a Neo4j container.
"""

from __future__ import annotations

from nemo_tpu_torch.analysis.corrections import synthesize_corrections, synthesize_extensions
from nemo_tpu_torch.analysis.protos import intersect_proto, missing_from, union_proto, wrap_code
from nemo_tpu_torch.analysis.queries import (
    extension_candidates,
    find_post_triggers,
    find_pre_triggers,
)
from nemo_tpu_torch.backend.base import GraphBackend
from nemo_tpu_torch.backend.bolt import BoltConnection
from nemo_tpu_torch.graphs.pgraph import PGraph, PNode
from nemo_tpu_torch.ingest.datatypes import MissingEvent
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.report.dot import DotGraph
from nemo_tpu_torch.report.figures import create_diff_dot, create_dot

CLEAN_OFFSET = 1000
DIFF_OFFSET = 2000

# --------------------------------------------------------------------- Cypher

Q_WIPE = "// nemo:wipe\nMATCH (n) DETACH DELETE n"

# Uniqueness constraints + run indexes, created once per session
# (pre-post-prov.go:66-81, :126-141; Neo4j 3.x syntax).
Q_CONSTRAINTS = [
    "// nemo:constraint_goal\nCREATE CONSTRAINT ON (g:Goal) ASSERT g.id IS UNIQUE",
    "// nemo:constraint_rule\nCREATE CONSTRAINT ON (r:Rule) ASSERT r.id IS UNIQUE",
    "// nemo:index_goal_run\nCREATE INDEX ON :Goal(run)",
    "// nemo:index_rule_run\nCREATE INDEX ON :Rule(run)",
]

Q_LOAD_GOALS = """// nemo:load_goals
UNWIND $rows AS row
CREATE (g:Goal {id: row.id, run: $run, condition: $condition, label: row.label,
                table: row.table, time: row.time, condition_holds: row.condition_holds,
                seq: row.seq})"""

Q_LOAD_RULES = """// nemo:load_rules
UNWIND $rows AS row
CREATE (r:Rule {id: row.id, run: $run, condition: $condition, label: row.label,
                table: row.table, type: row.type, seq: row.seq})"""

# Edges split by direction so every MATCH is label-scoped and can use the
# :Goal(id)/:Rule(id) uniqueness indexes — the same goal->rule / rule->goal
# split the reference makes by inspecting the From id (pre-post-prov.go:150-195).
Q_LOAD_EDGES_GR = """// nemo:load_edges_gr
UNWIND $rows AS row
MATCH (a:Goal {id: row.src}) MATCH (b:Rule {id: row.dst})
MERGE (a)-[e:DUETO]->(b) SET e.seq = row.seq"""

Q_LOAD_EDGES_RG = """// nemo:load_edges_rg
UNWIND $rows AS row
MATCH (a:Rule {id: row.src}) MATCH (b:Goal {id: row.dst})
MERGE (a)-[e:DUETO]->(b) SET e.seq = row.seq"""

Q_COUNT_GOALS = """// nemo:count_goals
MATCH (n:Goal {run: $run, condition: $condition}) RETURN count(n)"""

Q_COUNT_RULES = """// nemo:count_rules
MATCH (n:Rule {run: $run, condition: $condition}) RETURN count(n)"""

Q_COUNT_EDGES = """// nemo:count_edges
MATCH (a:Goal {run: $run, condition: $condition})-[e:DUETO]->() RETURN count(e)
UNION ALL
MATCH (a:Rule {run: $run, condition: $condition})-[e:DUETO]->() RETURN count(e)"""

# Condition marking (pre-post-prov.go:220-243): from the root goal of the
# condition's own table, two hops down, mark every goal of the condition
# table or of a grandchild goal's table.
Q_MARK_CONDITION = """// nemo:mark_condition
MATCH (root:Goal {run: $run, condition: $condition, table: $condition})
WHERE NOT ( ()-[:DUETO]->(root) )
MATCH (root)-[:DUETO]->(r:Rule {run: $run, condition: $condition, table: $condition})
      -[:DUETO]->(g:Goal {run: $run, condition: $condition})
WITH collect(DISTINCT g.table) + [$condition] AS tables, $run AS run, $condition AS cond
MATCH (x:Goal {run: run, condition: cond}) WHERE x.table IN tables
SET x.condition_holds = true"""

# Neo4j requires identical column names across UNION arms; alias the
# kind-literal column ('Goal' vs 'Rule') explicitly.
Q_PULL_NODES = """// nemo:pull_nodes
MATCH (n:Goal {run: $run, condition: $condition})
RETURN n.id AS id, 'Goal' AS kind, n.label AS label, n.table AS table,
       n.time AS time, n.type AS type, n.condition_holds AS condition_holds,
       n.seq AS seq
UNION ALL
MATCH (n:Rule {run: $run, condition: $condition})
RETURN n.id AS id, 'Rule' AS kind, n.label AS label, n.table AS table,
       n.time AS time, n.type AS type, n.condition_holds AS condition_holds,
       n.seq AS seq"""

Q_PULL_EDGES = """// nemo:pull_edges
MATCH (a:Goal {run: $run, condition: $condition})-[e:DUETO]->(b)
RETURN a.id, b.id, e.seq
UNION ALL
MATCH (a:Rule {run: $run, condition: $condition})-[e:DUETO]->(b)
RETURN a.id, b.id, e.seq"""

# Rules kept by the clean copy: >=1 incoming and >=1 outgoing edge (the
# degree formulation of the Goal-[*0..]->Goal path restriction,
# preprocessing.go:17-27; see base.py).
Q_CLEAN_KEPT_RULES = """// nemo:clean_kept_rules
MATCH (r:Rule {run: $run, condition: $condition})
WHERE ( ()-[:DUETO]->(r) ) AND ( (r)-[:DUETO]->() )
RETURN r.id ORDER BY r.seq"""

# Antecedent achieved: any goal of the simplified antecedent graph holds
# (prototype.go:13-15, queried on shadow run 1000+i).
Q_ACHIEVED_PRE = """// nemo:achieved_pre
MATCH (g:Goal {run: $run, condition: 'pre'})
WHERE g.condition_holds RETURN count(g)"""

# Prototype rule tables (prototype.go:11-24, corrected semantics per
# SURVEY.md §7): rules >=1 hop below an in-degree-0 goal root that have a
# rule descendant or a reachable rule ancestor; min path length per table.
Q_PROTO_TABLES = """// nemo:proto_tables
MATCH (root:Goal {run: $run, condition: $condition})
WHERE NOT ( ()-[:DUETO]->(root) )
MATCH p = (root)-[:DUETO*1..]->(r:Rule)
WHERE ( (r)-[:DUETO*1..]->(:Rule) )
   OR ( (root)-[:DUETO*1..]->(:Rule)-[:DUETO*1..]->(r) )
RETURN r.table, min(length(p))"""

Q_CLEAN_RULE_TABLES = """// nemo:clean_rule_tables
MATCH (r:Rule {run: $run, condition: $condition})
RETURN DISTINCT r.table"""

# Extensions precheck (extensions.go:25-50): count holding top-level
# antecedent goals across all raw runs (run < 1000).
Q_COUNT_PRE_HOLDS = """// nemo:count_pre_holds
MATCH (g:Goal {condition: 'pre', table: 'pre'})
WHERE g.condition_holds AND g.run < 1000
RETURN count(g)"""


class Neo4jBackend(GraphBackend):
    """GraphBackend speaking Bolt to a Neo4j server (the reference's own
    backend).  It has no per-run hooks (supports_delta and supports_synth
    False): run_debug maps the whole corpus once with the global verbs, and
    the report has no repairs.json."""

    def __init__(self, auth: tuple[str, str] | None = None) -> None:
        self.molly: MollyOutput | None = None
        self.conn1: BoltConnection | None = None
        self.conn2: BoltConnection | None = None
        self.auth = auth
        self._pull_cache: dict[tuple[int, str], PGraph] = {}

    # ------------------------------------------------------------------ setup

    def init_graph_db(self, conn: str, molly: MollyOutput) -> None:
        """Open the two Bolt connections (reference opens Conn1/Conn2,
        graphing/helpers.go:38-49; no docker lifecycle here — the server is
        expected to be running at `conn`) and reset the store."""
        self.molly = molly
        self._pull_cache = {}
        self.conn1 = BoltConnection(conn, auth=self.auth)
        self.conn2 = BoltConnection(conn, auth=self.auth)
        self.conn1.exec(Q_WIPE)
        for stmt in Q_CONSTRAINTS:
            self.conn1.exec(stmt)

    def close_db(self) -> None:
        for c in (self.conn1, self.conn2):
            if c is not None:
                c.close()
        self.conn1 = self.conn2 = None
        self.molly = None
        self._pull_cache = {}

    # ------------------------------------------------------------------- load

    def _load_graph(self, run: int, cond: str, g: PGraph) -> None:
        """Bulk-load one graph under (run, cond) with count verification
        (pre-post-prov.go:25-213)."""
        assert self.conn1 is not None
        goals = [
            {
                "id": n.id,
                "label": n.label,
                "table": n.table,
                "time": n.time,
                "condition_holds": n.cond_holds,
                "seq": i,
            }
            for i, n in enumerate(g.nodes.values())
            if n.is_goal
        ]
        rules = [
            {"id": n.id, "label": n.label, "table": n.table, "type": n.type, "seq": i}
            for i, n in enumerate(g.nodes.values())
            if not n.is_goal
        ]
        edges_gr = [
            {"src": s, "dst": d, "seq": i}
            for i, (s, d) in enumerate(g.edge_order)
            if g.nodes[s].is_goal
        ]
        edges_rg = [
            {"src": s, "dst": d, "seq": i}
            for i, (s, d) in enumerate(g.edge_order)
            if not g.nodes[s].is_goal
        ]
        params = {"run": run, "condition": cond}
        if goals:
            self.conn1.exec(Q_LOAD_GOALS, {**params, "rows": goals})
        if rules:
            self.conn1.exec(Q_LOAD_RULES, {**params, "rows": rules})
        if edges_gr:
            self.conn1.exec(Q_LOAD_EDGES_GR, {**params, "rows": edges_gr})
        if edges_rg:
            self.conn1.exec(Q_LOAD_EDGES_RG, {**params, "rows": edges_rg})
        n_nodes = (
            self.conn1.exec(Q_COUNT_GOALS, params)[0][0]
            + self.conn1.exec(Q_COUNT_RULES, params)[0][0]
        )
        if n_nodes != len(g.nodes):
            raise RuntimeError(
                f"node count mismatch for run {run} {cond}: {n_nodes} != {len(g.nodes)}"
            )
        n_edges = sum(row[0] for row in self.conn1.exec(Q_COUNT_EDGES, params))
        if n_edges != len(g.edge_order):
            raise RuntimeError(
                f"edge count mismatch for run {run} {cond}: {n_edges} != {len(g.edge_order)}"
            )

    def load_raw_provenance(self) -> None:
        assert self.molly is not None and self.conn1 is not None
        from nemo_tpu_torch.graphs.pgraph import build_pgraph

        for run in self.molly.runs:
            for cond, prov in (("pre", run.pre_prov), ("post", run.post_prov)):
                self._load_graph(run.iteration, cond, build_pgraph(prov))
                self.conn1.exec(
                    Q_MARK_CONDITION, {"run": run.iteration, "condition": cond}
                )

    # ------------------------------------------------------------------- pull

    def _pull_graph(self, run: int, cond: str) -> PGraph:
        """Materialize one stored graph, insertion order restored host-side
        from the seq property (the UNION of label-scoped matches has no
        server-side order)."""
        assert self.conn1 is not None
        key = (run, cond)
        cached = self._pull_cache.get(key)
        if cached is not None:
            return cached
        g = PGraph()
        node_rows = self.conn1.exec(Q_PULL_NODES, {"run": run, "condition": cond})
        for nid, kind, label, table, time, typ, holds, _seq in sorted(
            node_rows, key=lambda r: r[7]
        ):
            g.add_node(
                PNode(
                    id=nid,
                    is_goal=kind == "Goal",
                    label=label,
                    table=table,
                    time=time or "",
                    type=typ or "",
                    cond_holds=bool(holds),
                )
            )
        edge_rows = self.conn1.exec(Q_PULL_EDGES, {"run": run, "condition": cond})
        for src, dst, _seq in sorted(edge_rows, key=lambda r: r[2]):
            g.add_edge(src, dst)
        self._pull_cache[key] = g
        return g

    # --------------------------------------------------------------- simplify

    def simplify_prov(self, iters: list[int]) -> None:
        """Clean copy + @next chain contraction into shadow run 1000+i
        (preprocessing.go:351-387).  The kept-rule selection runs as Cypher;
        id rewriting happens in-process (replacing the reference's
        docker-exec sed, preprocessing.go:33-54); the contraction reuses the
        shared deterministic component pass on the shadow graph and writes
        the result back."""
        from nemo_tpu_torch.backend.python_ref import PythonBackend

        for i in iters:
            for cond in ("pre", "post"):
                assert self.conn1 is not None
                kept_rule_ids = {
                    row[0]
                    for row in self.conn1.exec(
                        Q_CLEAN_KEPT_RULES, {"run": i, "condition": cond}
                    )
                }
                raw = self._pull_graph(i, cond)
                clean = PythonBackend._clean_copy(raw, i, cond, kept_rule_ids=kept_rule_ids)
                # Chain contraction: shared deterministic component pass
                # (python_ref._collapse_next_chains == kernel semantics).
                PythonBackend._collapse_next_chains(clean, i, cond)
                self._load_graph(CLEAN_OFFSET + i, cond, clean)
                self._pull_cache[(CLEAN_OFFSET + i, cond)] = clean

    # ------------------------------------------------------------- prototypes

    def _achieved_pre(self, iteration: int) -> bool:
        assert self.conn1 is not None
        n = self.conn1.exec(Q_ACHIEVED_PRE, {"run": CLEAN_OFFSET + iteration})[0][0]
        return n > 0

    def proto_rule_tables(self, iteration: int, condition: str) -> list[str]:
        """Cypher variable-length path query (prototype.go:11-24) + the
        canonical (min rule-depth, table) host ordering."""
        assert self.conn2 is not None
        if not self._achieved_pre(iteration):
            return []
        rows = self.conn2.exec(
            Q_PROTO_TABLES, {"run": CLEAN_OFFSET + iteration, "condition": condition}
        )
        by_table: dict[str, int] = {}
        for table, min_len in rows:
            rule_depth = (int(min_len) + 1) // 2  # hops alternate goal/rule
            prev = by_table.get(table)
            if prev is None or rule_depth < prev:
                by_table[table] = rule_depth
        return [t for t, _ in sorted(by_table.items(), key=lambda kv: (kv[1], kv[0]))]

    def clean_rule_tables(self, iteration: int, condition: str) -> set[str]:
        assert self.conn2 is not None
        rows = self.conn2.exec(
            Q_CLEAN_RULE_TABLES,
            {"run": CLEAN_OFFSET + iteration, "condition": condition},
        )
        return {r[0] for r in rows}

    def create_prototypes(
        self, success_iters: list[int], failed_iters: list[int]
    ) -> tuple[list[str], list[list[str]], list[str], list[list[str]]]:
        per_run = [self.proto_rule_tables(i, "post") for i in success_iters]
        inter = intersect_proto(per_run, "post")
        union = union_proto(per_run, "post")
        inter_miss, union_miss = [], []
        for f in failed_iters:
            present = self.clean_rule_tables(f, "post")
            inter_miss.append(missing_from(inter, present))
            union_miss.append(missing_from(union, present))
        return wrap_code(inter), inter_miss, wrap_code(union), union_miss

    # ------------------------------------------------------------------- pull

    def pull_pre_post_prov(
        self, iters: list[int] | None = None
    ) -> tuple[list[DotGraph], list[DotGraph], list[DotGraph], list[DotGraph]]:
        assert self.molly is not None
        run_ids = [r.iteration for r in self.molly.runs] if iters is None else list(iters)
        pre, post, pre_clean, post_clean = [], [], [], []
        for i in run_ids:
            pre.append(create_dot(self._pull_graph(i, "pre"), "pre"))
            post.append(create_dot(self._pull_graph(i, "post"), "post"))
            pre_clean.append(create_dot(self._pull_graph(CLEAN_OFFSET + i, "pre"), "pre"))
            post_clean.append(
                create_dot(self._pull_graph(CLEAN_OFFSET + i, "post"), "post")
            )
        return pre, post, pre_clean, post_clean

    # ------------------------------------------------------------------- diff

    def create_naive_diff_prov(
        self,
        symmetric: bool,
        failed_iters: list[int],
        success_post_dot: DotGraph,
        dot_iters: list[int] | None = None,
    ) -> tuple[list[DotGraph], list[DotGraph], list[list[MissingEvent]]]:
        """Good-minus-bad per failed run (differential-provenance.go:18-243).
        The diff subgraph is computed on the pulled good graph with the shared
        closure logic, stored to shadow run 2000+f (the reference's
        export/sed/import becomes rewrite+CREATE), and the frontier reuses the
        shared longest-path pass."""
        from nemo_tpu_torch.backend.python_ref import PythonBackend

        if not failed_iters:
            return [], [], []
        g = self.good_run_iter()
        helper = PythonBackend()
        helper.molly = self.molly
        helper.graphs = {
            (g, "post"): self._pull_graph(g, "post"),
        }
        dot_set = set(failed_iters if dot_iters is None else dot_iters)
        diff_dots, failed_dots, missing_events = [], [], []
        for f in failed_iters:
            helper.graphs[(f, "post")] = self._pull_graph(f, "post")
            diff = helper.diff_graph(f)
            self._load_graph(DIFF_OFFSET + f, "post", diff)
            missing = helper._diff_missing(diff)
            missing_events.append(missing)
            if f not in dot_set:
                continue
            diff_dot, failed_dot = create_diff_dot(
                DIFF_OFFSET + f,
                diff,
                helper.graphs[(f, "post")],
                g,
                success_post_dot,
                missing,
            )
            diff_dots.append(diff_dot)
            failed_dots.append(failed_dot)
        return diff_dots, failed_dots, missing_events

    # ------------------------------------------------------- corrections etc.

    def generate_corrections(self) -> list[str]:
        g = self.good_run_iter()
        pre_triggers = find_pre_triggers(self._pull_graph(g, "pre"))
        post_triggers = find_post_triggers(self._pull_graph(g, "post"))
        return synthesize_corrections(pre_triggers, post_triggers)

    def generate_extensions(self) -> tuple[bool, list[str]]:
        assert self.molly is not None and self.conn1 is not None
        achieved = self.conn1.exec(Q_COUNT_PRE_HOLDS)[0][0]
        all_achieved = achieved >= len(self.molly.runs)
        if all_achieved:
            return True, []
        candidates = extension_candidates(self._pull_graph(self.baseline_run_iter(), "pre"))
        return False, synthesize_extensions(candidates)
