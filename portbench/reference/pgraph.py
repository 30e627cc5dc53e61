"""In-memory property-graph used by the Python oracle backend.

Stands in for the reference's Neo4j node store (graphing/pre-post-prov.go:27-58
creates :Goal/:Rule nodes with :DUETO edges).  Graphs are bipartite: every edge
connects a goal and a rule (loadProv only ever creates goal->rule or
rule->goal edges, pre-post-prov.go:150-195).
"""

# Copied from the JAX package's ``graphs/pgraph.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .datatypes import ProvData


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

    def remove_node(self, nid: str) -> None:
        """DETACH DELETE equivalent (preprocessing.go:318)."""
        for succ in self.out.pop(nid, []):
            self.inn[succ].remove(nid)
        for pred in self.inn.pop(nid, []):
            self.out[pred].remove(nid)
        self.edge_order = [(s, d) for (s, d) in self.edge_order if s != nid and d != nid]
        del self.nodes[nid]

    # -- queries --

    def goals(self) -> list[PNode]:
        return [n for n in self.nodes.values() if n.is_goal]

    def rules(self) -> list[PNode]:
        return [n for n in self.nodes.values() if not n.is_goal]

    def roots(self) -> list[PNode]:
        """Nodes with no incoming edge."""
        return [n for n in self.nodes.values() if not self.inn[n.id]]

    def descendants(self, start: str) -> set[str]:
        """All nodes reachable from start via >=1 hop."""
        seen: set[str] = set()
        stack = list(self.out[start])
        while stack:
            v = stack.pop()
            if v not in seen:
                seen.add(v)
                stack.extend(self.out[v])
        return seen

    def reachable_from(self, starts: list[str]) -> set[str]:
        """All nodes reachable from any start via >=0 hops."""
        seen: set[str] = set(starts)
        stack = list(starts)
        while stack:
            v = stack.pop()
            for w in self.out[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return seen

    def coreachable_to(self, targets: list[str]) -> set[str]:
        """All nodes that reach any target via >=0 hops."""
        seen: set[str] = set(targets)
        stack = list(targets)
        while stack:
            v = stack.pop()
            for w in self.inn[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return seen

    def copy(self) -> "PGraph":
        g = PGraph()
        for n in self.nodes.values():
            g.add_node(dataclasses.replace(n))
        for s, d in self.edge_order:
            g.add_edge(s, d)
        return g


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
