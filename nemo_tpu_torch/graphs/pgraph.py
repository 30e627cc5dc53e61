"""In-memory property graph of one (run, condition) provenance graph, a copy
of the JAX package's ``graphs/pgraph.py`` trimmed to what the report path
uses: figure construction and the trigger queries.

Stands in for the reference's Neo4j node store (graphing/pre-post-prov.go:27-58
creates :Goal/:Rule nodes with :DUETO edges).  Graphs are bipartite: every edge
connects a goal and a rule (loadProv only ever creates goal->rule or
rule->goal edges, pre-post-prov.go:150-195).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nemo_tpu_torch.ingest.datatypes import ProvData


@dataclass
class PNode:
    """One provenance node with the properties loadProv stores
    (reference: graphing/pre-post-prov.go:28,91)."""

    id: str
    is_goal: bool
    label: str
    table: str
    time: str = ""  # goals only
    type: str = ""  # rules only: "", "async", "next", "collapsed"
    cond_holds: bool = False  # goals only


@dataclass
class PGraph:
    """One (run, condition) provenance graph with adjacency indexes."""

    nodes: dict[str, PNode] = field(default_factory=dict)
    # Insertion-ordered adjacency: node id -> successor/predecessor ids.
    out: dict[str, list[str]] = field(default_factory=dict)
    inn: dict[str, list[str]] = field(default_factory=dict)
    edge_order: list[tuple[str, str]] = field(default_factory=list)

    def add_node(self, node: PNode) -> None:
        if node.id in self.nodes:
            raise ValueError(f"duplicate node id {node.id}")
        self.nodes[node.id] = node
        self.out[node.id] = []
        self.inn[node.id] = []

    def add_edge(self, src: str, dst: str) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge endpoint missing: {src} -> {dst}")
        if dst in self.out[src]:
            return  # mirror Cypher MERGE: no duplicate edges (pre-post-prov.go:153)
        self.out[src].append(dst)
        self.inn[dst].append(src)
        self.edge_order.append((src, dst))


def build_pgraph(prov: ProvData) -> PGraph:
    """Build a PGraph from parsed Molly provenance.

    Edge direction is taken from the data; the reference picks the goal->rule
    vs rule->goal statement by substring match on the From id
    (pre-post-prov.go:173); here endpoints are resolved by node kind.
    """
    g = PGraph()
    for goal in prov.goals:
        g.add_node(
            PNode(
                id=goal.id,
                is_goal=True,
                label=goal.label,
                table=goal.table,
                time=goal.time,
                cond_holds=goal.cond_holds,
            )
        )
    for rule in prov.rules:
        g.add_node(
            PNode(id=rule.id, is_goal=False, label=rule.label, table=rule.table, type=rule.type)
        )
    for e in prov.edges:
        g.add_edge(e.src, e.dst)
    return g
