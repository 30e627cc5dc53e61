"""Pure-Python DOT -> SVG renderer, a copy of the JAX package's
``report/svg.py`` (which pins its C++ twin byte-equal to it, so this one
engine writes the same bytes as either).

The reference shells out to graphviz `dot -Tsvg` per figure
(report/webpage.go:65); graphviz is not available in this environment, so this
module lays out the DAG itself: longest-path layering, barycenter ordering
within layers, straight-line edges with arrowheads.  It understands the
attribute vocabulary our figures use (shape rect/ellipse, style
invis/dashed/bold/filled, color/fillcolor/fontcolor, label).
"""

from __future__ import annotations

import html

from .dot import DotGraph

#: Layout/format version of this renderer, the JAX package's value: the two
#: renderers are held byte-equal, so it changes only with the JAX package's.
RENDER_FORMAT_VERSION = 1

_CHAR_W = 7.2  # approx px per character at font-size 12
_NODE_H = 36
_LAYER_GAP = 70
_X_GAP = 24
_MARGIN = 20


def _node_size(label: str) -> tuple[float, float]:
    w = max(60.0, _CHAR_W * len(label) + 16)
    return w, _NODE_H


def render_svg(g: DotGraph) -> str:
    nodes = list(g.nodes)
    names = {n.name for n in nodes}
    edges = [e for e in g.edges if e.src in names and e.dst in names]

    # Cluster rank: members of cluster k order before members of cluster
    # k+1 within each layer, keeping every cluster a contiguous horizontal
    # band so its box encloses only its own nodes (graphviz draws Molly's
    # per-process spacetime clusters the same way).
    # Non-members order after all clusters.  Rank len(clusters) everywhere
    # when there are no clusters — ordering is then untouched.
    cluster_rank = {
        member: k for k, c in enumerate(g.clusters) for member in c.nodes
    }
    default_rank = len(g.clusters)

    # Longest-path layering over the (possibly cyclic-free) DAG; fall back to
    # layer 0 on cycles.
    out: dict[str, list[str]] = {n.name: [] for n in nodes}
    indeg: dict[str, int] = {n.name: 0 for n in nodes}
    for e in edges:
        if e.src != e.dst:
            out[e.src].append(e.dst)
            indeg[e.dst] += 1
    layer: dict[str, int] = {}
    stack = [n for n, d in indeg.items() if d == 0]
    remaining = dict(indeg)
    for n in stack:
        layer[n] = 0
    order: list[str] = []
    while stack:
        v = stack.pop()
        order.append(v)
        for w in out[v]:
            layer[w] = max(layer.get(w, 0), layer[v] + 1)
            remaining[w] -= 1
            if remaining[w] == 0:
                stack.append(w)
    for n in nodes:  # cycle leftovers
        layer.setdefault(n.name, 0)

    by_layer: dict[int, list[str]] = {}
    for n in nodes:
        by_layer.setdefault(layer[n.name], []).append(n.name)

    # Two barycenter passes to reduce crossings.
    pos_in_layer = {name: i for names_ in by_layer.values() for i, name in enumerate(names_)}
    preds: dict[str, list[str]] = {n.name: [] for n in nodes}
    for e in edges:
        preds[e.dst].append(e.src)
    for _ in range(2):
        for li in sorted(by_layer):
            def key(name: str) -> tuple[int, float]:
                ps = preds[name]
                bary = (
                    pos_in_layer[name]
                    if not ps
                    else sum(pos_in_layer[p] for p in ps) / len(ps)
                )
                return (cluster_rank.get(name, default_rank), bary)

            by_layer[li].sort(key=key)
            for i, name in enumerate(by_layer[li]):
                pos_in_layer[name] = i

    # Coordinates.
    node_by_name = {n.name: n for n in nodes}
    sizes = {n.name: _node_size(n.attrs.get("label", n.name)) for n in nodes}
    coords: dict[str, tuple[float, float]] = {}
    width = 2 * _MARGIN
    for li in sorted(by_layer):
        x = _MARGIN
        for name in by_layer[li]:
            w, h = sizes[name]
            coords[name] = (x + w / 2, _MARGIN + li * _LAYER_GAP + h / 2)
            x += w + _X_GAP
        width = max(width, x + _MARGIN)
    height = 2 * _MARGIN + (max(by_layer, default=0) + 1) * _LAYER_GAP

    # Center layers horizontally.
    for li in sorted(by_layer):
        row = by_layer[li]
        if not row:
            continue
        row_w = sum(sizes[n][0] for n in row) + _X_GAP * (len(row) - 1)
        shift = (width - 2 * _MARGIN - row_w) / 2
        for name in row:
            x, y = coords[name]
            coords[name] = (x + shift, y)

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" height="{height:.0f}" '
        f'viewBox="0 0 {width:.0f} {height:.0f}">',
        "<defs><marker id='arrow' markerWidth='10' markerHeight='8' refX='9' refY='4' "
        "orient='auto'><path d='M0,0 L10,4 L0,8 z' fill='#444'/></marker></defs>",
    ]

    # Cluster boxes (under edges and nodes), each the bounding box of its
    # member nodes plus padding, labeled at the top-left inside the box.
    for c in g.clusters:
        members = [m for m in c.nodes if m in coords]
        if not members:
            continue
        x0 = min(coords[m][0] - sizes[m][0] / 2 for m in members) - 8
        x1 = max(coords[m][0] + sizes[m][0] / 2 for m in members) + 8
        y0 = min(coords[m][1] - sizes[m][1] / 2 for m in members) - 8
        y1 = max(coords[m][1] + sizes[m][1] / 2 for m in members) + 8
        parts.append(
            f'<rect x="{x0:.1f}" y="{y0:.1f}" width="{x1 - x0:.1f}" '
            f'height="{y1 - y0:.1f}" fill="none" stroke="#999" stroke-width="1"/>'
        )
        label = c.attrs.get("label", c.name)
        parts.append(
            f'<text x="{x0 + 4:.1f}" y="{y0 + 12:.1f}" font-family="monospace" '
            f'font-size="10" fill="#555">{html.escape(label)}</text>'
        )

    def style_of(attrs: dict[str, str]) -> dict[str, str]:
        style = attrs.get("style", "")
        return {
            "invis": "invis" in style,
            "dashed": "dashed" in style,
            "bold": "bold" in style,
        }

    for e in edges:
        st = style_of(e.attrs)
        if st["invis"]:
            continue
        (x1, y1), (x2, y2) = coords[e.src], coords[e.dst]
        y1 += sizes[e.src][1] / 2
        y2 -= sizes[e.dst][1] / 2
        color = e.attrs.get("color", "#444")
        dash = ' stroke-dasharray="6,3"' if st["dashed"] else ""
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="{color}" stroke-width="1.2"{dash} marker-end="url(#arrow)"/>'
        )

    for name in coords:
        n = node_by_name[name]
        st = style_of(n.attrs)
        if st["invis"]:
            continue
        x, y = coords[name]
        w, h = sizes[name]
        fill = n.attrs.get("fillcolor", "white")
        stroke = n.attrs.get("color", "black")
        stroke_w = 2.4 if st["bold"] else 1.2
        dash = ' stroke-dasharray="6,3"' if st["dashed"] else ""
        shape = n.attrs.get("shape", "ellipse")
        if shape == "rect":
            parts.append(
                f'<rect x="{x - w / 2:.1f}" y="{y - h / 2:.1f}" width="{w:.1f}" '
                f'height="{h:.1f}" rx="3" fill="{fill}" stroke="{stroke}" '
                f'stroke-width="{stroke_w}"{dash}/>'
            )
        else:
            parts.append(
                f'<ellipse cx="{x:.1f}" cy="{y:.1f}" rx="{w / 2:.1f}" ry="{h / 2:.1f}" '
                f'fill="{fill}" stroke="{stroke}" stroke-width="{stroke_w}"{dash}/>'
            )
        label = n.attrs.get("label", name)
        fontcolor = n.attrs.get("fontcolor", "black")
        parts.append(
            f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle" '
            f'font-family="monospace" font-size="12" fill="{fontcolor}">'
            f"{html.escape(label)}</text>"
        )

    parts.append("</svg>")
    return "\n".join(parts)
