"""Figure construction: provenance DOT graphs, differential overlays, and
hazard-window recoloring.

Reimplements the reference's figure semantics (graphing/diagrams.go,
graphing/hazard-analysis.go) over our DotGraph/PGraph models.  The styling
constants match the reference exactly so reports stay visually comparable:
async rules = bold lawngreen border, next rules = gold font, goals whose
condition holds = firebrick (pre) / deepskyblue (post), rules = rects,
goals = ellipses (diagrams.go:53-106).
"""

# Copied from the JAX package's ``report/figures.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

from .pgraph import PGraph, PNode
from .datatypes import MissingEvent

from .dot import DotGraph, parse_dot

VISIBLE_STYLE = "filled, solid"
INVIS_STYLE = "invis"
MISSING_STYLE = "filled, dashed, bold"


def _node_attrs(node: PNode, graph_type: str) -> dict[str, str]:
    """Node styling per diagrams.go:44-106."""
    attrs = {
        "label": node.label,
        "style": VISIBLE_STYLE,
        "color": "black",
        "fontcolor": "black",
        "fillcolor": "white",
    }
    if node.type == "async":
        attrs["style"] = "filled, bold"
        attrs["color"] = "lawngreen"
    elif node.type == "next":
        attrs["fontcolor"] = "gold"
    if node.cond_holds and graph_type == "pre":
        attrs["color"] = "firebrick"
        attrs["fillcolor"] = "firebrick"
    elif node.cond_holds and graph_type == "post":
        attrs["color"] = "deepskyblue"
        attrs["fillcolor"] = "deepskyblue"
    attrs["shape"] = "ellipse" if node.is_goal else "rect"
    return attrs


def create_dot(graph: PGraph, graph_type: str) -> DotGraph:
    """Provenance graph -> DOT, one statement pair per edge
    (reference: graphing/diagrams.go:15-130 'createDOT')."""
    dot = DotGraph(name="dataflow")
    dot.graph_attrs["bgcolor"] = "transparent"
    for src, dst in graph.edge_order:
        dot.add_node(src, _node_attrs(graph.nodes[src], graph_type))
        dot.add_node(dst, _node_attrs(graph.nodes[dst], graph_type))
        dot.add_edge(src, dst, {"color": "black"})
    return dot


def create_diff_dot(
    diff_run_id: int,
    diff_graph: PGraph,
    failed_graph: PGraph,
    success_run_id: int,
    success_post_dot: DotGraph,
    missing: list[MissingEvent],
) -> tuple[DotGraph, DotGraph]:
    """Differential-provenance overlay DOTs
    (reference: graphing/diagrams.go:133-291 'createDiffDot').

    Both outputs start as an invisible copy of the successful run's consequent
    provenance with run IDs rewritten to the diff run; the diff overlay
    re-reveals the subgraph present in the diff (marking missing-frontier
    nodes dashed bold mediumvioletred), and the failed overlay re-reveals the
    nodes whose labels occur in the failed run's own provenance.  The report
    stacks these as z-ordered layers over the good graph.
    """
    missing_ids: set[str] = set()
    for m in missing:
        if m.rule is not None:
            missing_ids.add(m.rule.id)
        for goal in m.goals:
            missing_ids.add(goal.id)

    diff_dot = DotGraph(name="dataflow")
    failed_dot = DotGraph(name="dataflow")
    diff_dot.graph_attrs["bgcolor"] = "transparent"
    failed_dot.graph_attrs["bgcolor"] = "transparent"

    old, new = f"run_{success_run_id}", f"run_{diff_run_id}"

    # Copy the good graph with every node/edge hidden (diagrams.go:185-234).
    for node in success_post_dot.nodes:
        attrs = dict(node.attrs)
        attrs["style"] = INVIS_STYLE
        name = node.name.replace(old, new)
        diff_dot.add_node(name, dict(attrs))
        failed_dot.add_node(name, dict(attrs))
    for edge in success_post_dot.edges:
        attrs = dict(edge.attrs)
        attrs["style"] = INVIS_STYLE
        src = edge.src.replace(old, new)
        dst = edge.dst.replace(old, new)
        diff_dot.add_edge(src, dst, dict(attrs))
        failed_dot.add_edge(src, dst, dict(attrs))

    # Re-reveal the diff subgraph (diagrams.go:236-265).
    edges_by_pair: dict[tuple[str, str], list] = {}
    for e in diff_dot.edges:
        edges_by_pair.setdefault((e.src, e.dst), []).append(e)
    for src, dst in diff_graph.edge_order:
        for name in (src, dst):
            node = diff_dot.lookup(name)
            if node is None:
                continue
            if name in missing_ids:
                node.attrs["style"] = MISSING_STYLE
                node.attrs["color"] = "mediumvioletred"
            else:
                node.attrs["style"] = VISIBLE_STYLE
        for e in edges_by_pair.get((src, dst), []):
            e.attrs["style"] = VISIBLE_STYLE

    # Re-reveal nodes matched BY LABEL in the failed run (diagrams.go:267-288).
    failed_labels = {failed_graph.nodes[s].label for s, _ in failed_graph.edge_order} | {
        failed_graph.nodes[d].label for _, d in failed_graph.edge_order
    }
    for node in failed_dot.nodes:
        if node.attrs.get("label") in failed_labels:
            node.attrs["style"] = VISIBLE_STYLE
    visible = {n.name for n in failed_dot.nodes if n.attrs.get("style") == VISIBLE_STYLE}
    for edge in failed_dot.edges:
        if edge.src in visible and edge.dst in visible:
            edge.attrs["style"] = VISIBLE_STYLE

    return diff_dot, failed_dot


def create_hazard_dot(
    spacetime_dot_text: str,
    time_pre_holds: dict[str, bool],
    time_post_holds: dict[str, bool],
) -> DotGraph:
    """Recolor one Molly space-time diagram into the hazard-window figure
    (reference: graphing/hazard-analysis.go:16-88 'CreateHazardAnalysis').

    All nodes turn lightgrey; nodes at timesteps where the antecedent holds
    turn firebrick; where the consequent holds, the fill turns deepskyblue.
    The visual gap — pre colored but post not — is the hazard window.  The
    timestep is the last '_'-separated token of the node name
    (hazard-analysis.go:48-54); non-timestep suffixes simply never match.
    """
    g = parse_dot(spacetime_dot_text)
    for node in g.nodes:
        node.attrs.update(
            {"style": "solid, filled", "color": "lightgrey", "fillcolor": "lightgrey"}
        )
        node_time = node.name.rsplit("_", 1)[-1]
        if time_pre_holds.get(node_time):
            node.attrs.update({"color": "firebrick", "fillcolor": "firebrick"})
        if time_post_holds.get(node_time):
            node.attrs.update({"fillcolor": "deepskyblue"})
    return g
