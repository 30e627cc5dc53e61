"""Minimal DOT graph model: build, serialize, and parse.

Replaces the reference's vendored gographviz (used to build provenance figures,
graphing/diagrams.go, and to parse Molly's spacetime diagrams,
graphing/hazard-analysis.go:34).  Only the DOT subset those paths need is
supported: a single directed graph, node statements with attributes, edge
statements, graph-level attributes.
"""

# Copied from the JAX package's ``report/dot.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

import re
from dataclasses import dataclass, field


def _quote(s: str) -> str:
    return '"' + s.replace('"', '\\"') + '"'


@dataclass
class DotNode:
    name: str
    attrs: dict[str, str] = field(default_factory=dict)


@dataclass
class DotEdge:
    src: str
    dst: str
    attrs: dict[str, str] = field(default_factory=dict)


@dataclass
class DotCluster:
    """A `subgraph cluster_*` block: rendered as a box around its member
    nodes (graphviz cluster semantics — Molly's spacetime diagrams wrap each
    process's timeline in one, parsed by the reference via gographviz,
    graphing/hazard-analysis.go:34)."""

    name: str
    attrs: dict[str, str] = field(default_factory=dict)
    nodes: list[str] = field(default_factory=list)


@dataclass
class DotGraph:
    """A directed DOT graph with insertion-ordered nodes, edges, and
    clusters.  Nodes always live in the flat `nodes` list; clusters hold
    member NAMES only (membership is first-declaration-wins, like dot)."""

    name: str = "dataflow"
    graph_attrs: dict[str, str] = field(default_factory=dict)
    nodes: list[DotNode] = field(default_factory=list)
    edges: list[DotEdge] = field(default_factory=list)
    clusters: list[DotCluster] = field(default_factory=list)
    _lookup: dict[str, DotNode] = field(default_factory=dict)
    _cluster_lookup: dict[str, DotCluster] = field(default_factory=dict)
    _cluster_of: dict[str, str] = field(default_factory=dict)

    def add_node(self, name: str, attrs: dict[str, str] | None = None) -> DotNode:
        """Add or update a node (last-writer-wins per attribute, matching
        gographviz AddNode semantics used at diagrams.go:109-118)."""
        node = self._lookup.get(name)
        if node is None:
            node = DotNode(name=name, attrs={})
            self.nodes.append(node)
            self._lookup[name] = node
        if attrs:
            node.attrs.update(attrs)
        return node

    def add_cluster(self, name: str, attrs: dict[str, str] | None = None) -> DotCluster:
        cluster = self._cluster_lookup.get(name)
        if cluster is None:
            cluster = DotCluster(name=name)
            self.clusters.append(cluster)
            self._cluster_lookup[name] = cluster
        if attrs:
            cluster.attrs.update(attrs)
        return cluster

    def assign_cluster(self, node_name: str, cluster_name: str) -> None:
        """Register membership (first declaration wins, dot semantics)."""
        if node_name in self._cluster_of:
            return
        self._cluster_of[node_name] = cluster_name
        self._cluster_lookup[cluster_name].nodes.append(node_name)

    def cluster_of(self, node_name: str) -> str | None:
        return self._cluster_of.get(node_name)

    def add_edge(self, src: str, dst: str, attrs: dict[str, str] | None = None) -> DotEdge:
        for endpoint in (src, dst):
            if endpoint not in self._lookup:
                self.add_node(endpoint)
        edge = DotEdge(src=src, dst=dst, attrs=dict(attrs or {}))
        self.edges.append(edge)
        return edge

    def lookup(self, name: str) -> DotNode | None:
        return self._lookup.get(name)

    def edges_between(self, src: str, dst: str) -> list[DotEdge]:
        return [e for e in self.edges if e.src == src and e.dst == dst]

    def to_string(self) -> str:
        lines = [f"digraph {self.name} {{"]
        if self.graph_attrs:
            attrs = ",".join(f"{k}={_quote(v)}" for k, v in sorted(self.graph_attrs.items()))
            lines.append(f"\tgraph [ {attrs} ];")
        # Cluster blocks first (bare member names; attribute statements
        # follow at top level and merge — membership re-parses
        # first-declaration-wins, so the roundtrip preserves it).
        for c in self.clusters:
            lines.append(f"\tsubgraph {_quote(c.name)} {{")
            if c.attrs:
                attrs = ",".join(f"{k}={_quote(v)}" for k, v in sorted(c.attrs.items()))
                lines.append(f"\t\tgraph [ {attrs} ];")
            for member in c.nodes:
                lines.append(f"\t\t{_quote(member)};")
            lines.append("\t}")
        for n in self.nodes:
            if n.attrs:
                attrs = ", ".join(f"{k}={_quote(v)}" for k, v in sorted(n.attrs.items()))
                lines.append(f"\t{_quote(n.name)} [ {attrs} ];")
            else:
                lines.append(f"\t{_quote(n.name)};")
        for e in self.edges:
            if e.attrs:
                attrs = ", ".join(f"{k}={_quote(v)}" for k, v in sorted(e.attrs.items()))
                lines.append(f"\t{_quote(e.src)} -> {_quote(e.dst)} [ {attrs} ];")
            else:
                lines.append(f"\t{_quote(e.src)} -> {_quote(e.dst)};")
        lines.append("}")
        return "\n".join(lines) + "\n"


_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
      | (?P<quoted>"(?:[^"\\]|\\.)*")
      | (?P<arrow>->)
      | (?P<punct>[{}\[\];=,])
      | (?P<word>[^\s{}\[\];=,"]+)
    )
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> list[str]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            break
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        tok = m.group(0).strip()
        if tok:
            tokens.append(tok)
    return tokens


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1].replace('\\"', '"')
    return tok


def parse_dot(text: str) -> DotGraph:
    """Parse the DOT subset Molly's spacetime diagrams use
    (graphing/hazard-analysis.go:34 reads them with gographviz)."""
    tokens = _tokenize(text)
    g = DotGraph()
    i = 0
    # Header: [strict] (digraph|graph) [name] {
    while i < len(tokens) and tokens[i] != "{":
        if tokens[i].lower() not in ("strict", "digraph", "graph"):
            g.name = _unquote(tokens[i])
        i += 1
    i += 1  # consume {

    def parse_attr_list(j: int) -> tuple[dict[str, str], int]:
        attrs: dict[str, str] = {}
        while j < len(tokens) and tokens[j] == "[":
            j += 1
            while j < len(tokens) and tokens[j] != "]":
                key = _unquote(tokens[j])
                if j + 2 < len(tokens) and tokens[j + 1] == "=":
                    attrs[key] = _unquote(tokens[j + 2])
                    j += 3
                else:
                    attrs[key] = ""
                    j += 1
                if j < len(tokens) and tokens[j] == ",":
                    j += 1
            j += 1  # consume ]
        return attrs, j

    # Cluster context: (cluster, depth at which its block opened).  Nodes
    # first declared while a cluster block is open belong to it (dot
    # semantics); non-cluster subgraphs still flatten.
    cluster_stack: list[tuple[DotCluster, int]] = []

    def declare(name: str, attrs: dict[str, str] | None = None) -> None:
        g.add_node(name, attrs)
        if cluster_stack:
            g.assign_cluster(name, cluster_stack[-1][0].name)

    def parse_group(j: int) -> tuple[list[str], int]:
        """Parse `{ ... }` starting at its opening brace; returns the
        member node names.  Handles nested groups, inner edge chains
        (with per-hop edge attrs), and `subgraph [name] { ... }`."""
        members: list[str] = []
        j += 1  # consume {
        prev: list[str] | None = None  # tail of an inner chain
        while j < len(tokens) and tokens[j] != "}":
            t = tokens[j]
            if t in (";", ","):
                prev = None
                j += 1
                continue
            if t == "->":
                src_grp = prev or []
                dst_grp, j = parse_endpoint(j + 1)
                eattrs, j = parse_attr_list(j)
                for a in src_grp:
                    for b in dst_grp:
                        g.add_edge(a, b, dict(eattrs))
                members.extend(n for n in dst_grp if n not in members)
                prev = dst_grp
                continue
            if t == "{" or t.lower() == "subgraph":
                # Nested group/subgraph: its nodes join this group too.
                inner, j = parse_endpoint(j)
                members.extend(n for n in inner if n not in members)
                prev = inner
                continue
            if t.lower() in ("graph", "node", "edge") and j + 1 < len(tokens) and tokens[j + 1] == "[":
                _, j = parse_attr_list(j + 1)  # default-attr statement
                continue
            if j + 1 < len(tokens) and tokens[j + 1] == "=":
                j += 3  # group-local attribute (e.g. rank=same): not a node
                continue
            # Node statement (possibly an inner chain head).
            nm = _unquote(t)
            node_attrs, j = parse_attr_list(j + 1)
            declare(nm, node_attrs)
            if nm not in members:
                members.append(nm)
            prev = [nm]
        return members, j + 1  # consume }

    def parse_endpoint(j: int) -> tuple[list[str], int]:
        """One chain endpoint: a braced group, a subgraph block, or a
        bare name.  A bare name does NOT consume a following attr
        list — that belongs to the edge chain."""
        if tokens[j] == "{":
            return parse_group(j)
        if tokens[j].lower() == "subgraph":
            j += 1
            if j < len(tokens) and tokens[j] != "{":
                j += 1  # optional subgraph name
            if j < len(tokens) and tokens[j] == "{":
                return parse_group(j)
            return [], j
        return [_unquote(tokens[j])], j + 1

    def parse_chain(endpoints: list[list[str]], j: int) -> int:
        """Continue an edge chain whose first endpoint group is given;
        j points at the first `->`."""
        while j < len(tokens) and tokens[j] == "->":
            ep, j = parse_endpoint(j + 1)
            endpoints.append(ep)
        attrs, j = parse_attr_list(j)
        for ep in endpoints:
            for n in ep:  # declare even when the chain has no edges left
                declare(n)
        for src_grp, dst_grp in zip(endpoints, endpoints[1:]):
            for a in src_grp:
                for b in dst_grp:
                    g.add_edge(a, b, dict(attrs))
        return j

    depth = 1  # the graph's own brace, consumed above
    while i < len(tokens):
        tok = tokens[i]
        if tok == "}":
            if cluster_stack and cluster_stack[-1][1] == depth:
                cluster_stack.pop()
            depth -= 1
            if depth <= 0:
                break
            i += 1  # closing a flattened subgraph / cluster block
            continue
        if tok == ";":
            i += 1
            continue
        if tok == "->":
            # Stray arrow (e.g. the continuation of `a -> { b } -> c` after
            # the flattened subgraph closed): never a node name.
            i += 1
            continue
        if tok.lower() in ("graph", "node", "edge") and i + 1 < len(tokens) and tokens[i + 1] == "[":
            attrs, i = parse_attr_list(i + 1)
            if tok.lower() == "graph":
                if cluster_stack:
                    # A cluster's graph [label=...] styles the cluster box.
                    cluster_stack[-1][0].attrs.update(attrs)
                elif depth == 1:
                    # Top level only: a flattened subgraph's graph attrs
                    # must not clobber the enclosing graph's.
                    g.graph_attrs.update(attrs)
            continue  # default node/edge attrs are not tracked
        if tok.lower() == "subgraph":
            # `subgraph cluster_*` keeps its identity (box semantics, like
            # the reference's gographviz + dot pipeline); anything else
            # flattens: skip the optional name and the opening brace, the
            # statements inside parse as usual.
            i += 1
            sub_name = None
            if i < len(tokens) and tokens[i] != "{":
                sub_name = _unquote(tokens[i])
                i += 1
            if i < len(tokens) and tokens[i] == "{":
                i += 1
                depth += 1
                if sub_name and sub_name.startswith("cluster"):
                    cluster_stack.append((g.add_cluster(sub_name), depth))
            continue
        if tok == "{":
            # Anonymous group at statement position: if its closing brace is
            # followed by `->`, this is a chain HEAD (`{ a b } -> c`); the
            # group members become the first endpoint set.  Otherwise it is
            # an anonymous subgraph whose contents were parsed (flattened)
            # by parse_group either way.
            members, j = parse_group(i)
            if j < len(tokens) and tokens[j] == "->":
                i = parse_chain([members], j)
            else:
                i = j
            continue
        name = _unquote(tok)
        if i + 1 < len(tokens) and tokens[i + 1] == "=":
            # Bare `name = value`: graph attributes at top level, cluster
            # attributes inside a cluster block; a flattened subgraph's
            # must not clobber the enclosing graph's.
            if cluster_stack:
                cluster_stack[-1][0].attrs[name] = _unquote(tokens[i + 2])
            elif depth == 1:
                g.graph_attrs[name] = _unquote(tokens[i + 2])
            i += 3
            continue
        if i + 1 < len(tokens) and tokens[i + 1] == "->":
            # Edge chain; any endpoint may be a braced node group
            # (`a -> { b c } -> d` = a->b, a->c, b->d, c->d: the DOT
            # grammar's subgraph-as-endpoint semantics, where the group
            # contributes ALL nodes appearing inside it, and inner edge
            # chains are real edges of the graph).
            i = parse_chain([[name]], i + 1)
            continue
        attrs, i = parse_attr_list(i + 1)
        declare(name, attrs)
    return g
