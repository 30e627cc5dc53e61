"""Deduplicated DOT -> SVG rendering, a copy of the JAX package's
``report/render.py`` trimmed to the render key and the inline scheduler: no
worker pool and no persistent SVG cache.

Runs of one family draw from one protocol template, so their figures are
mostly isomorphic, but their DOT text is not: node ids embed the run
iteration (``run_<iter>_...``).  The renderer never draws node ids, only
labels, colors, shapes, style flags and node/edge/cluster ORDER
(report/svg.py), so figures are deduplicated by a *render key*, a hash over
exactly the renderer's inputs: renamed-but-isomorphic figures collide,
render once, and the SVG is written to every path that shares it.  The
output is byte-identical to rendering each figure in turn.
"""

from __future__ import annotations

import hashlib
import os
import time

from nemo_tpu_torch import obs

from .dot import DotGraph
from .svg import render_svg


def render_key(g: DotGraph) -> str:
    """Content hash of exactly the renderer's inputs: per-node (resolved
    label, shape, style, stroke, fill, fontcolor) in node order, per-edge
    (src index, dst index, color, style) in edge order over edges whose
    endpoints exist, and per-cluster (resolved label, member indices) in
    cluster order.  Node NAMES enter only through the label default, so
    renamed-but-isomorphic figures collide.  Graph name and graph-level
    attrs are not rendered and are left out."""
    index = {n.name: i for i, n in enumerate(g.nodes)}
    nodes = tuple(
        (
            n.attrs.get("label", n.name),
            n.attrs.get("shape", "ellipse"),
            n.attrs.get("style", ""),
            n.attrs.get("color", "black"),
            n.attrs.get("fillcolor", "white"),
            n.attrs.get("fontcolor", "black"),
        )
        for n in g.nodes
    )
    edges = tuple(
        (index[e.src], index[e.dst], e.attrs.get("color", "#444"), e.attrs.get("style", ""))
        for e in g.edges
        if e.src in index and e.dst in index
    )
    clusters = tuple(
        (
            c.attrs.get("label", c.name),
            tuple(index[m] for m in c.nodes if m in index),
        )
        for c in g.clusters
    )
    payload = repr(("rk1", nodes, edges, clusters)).encode("utf-8")
    return hashlib.sha256(payload).hexdigest()


class _Entry:
    """One unique render key: the graph to render and the paths its SVG
    goes to."""

    __slots__ = ("svg", "graph", "pending_paths", "link_src")

    def __init__(self, graph: DotGraph) -> None:
        self.svg: str | None = None
        self.graph: DotGraph | None = graph
        self.pending_paths: list[str] = []
        #: per directory, the path already written: the hardlink source of
        #: further paths in that directory.
        self.link_src: dict[str, str] = {}


class RenderScheduler:
    """``submit(dot, svg_path)`` registers a figure; ``drain()`` renders each
    unique key once, in submission order, in this process, writes its SVG
    to every path submitted since the last drain and returns ``stats()``.
    One scheduler may serve several reports (run_debug_dirs): their figures
    dedup together and land at its one drain."""

    def __init__(self) -> None:
        self._entries: dict[str, _Entry] = {}
        self._order: list[str] = []
        self.figures = 0  # figures submitted
        self.rendered = 0  # unique keys rendered
        self.render_s = 0.0  # rendering seconds, summed over unique renders
        self.render_wall_s = 0.0  # wall inside drain: renders and writes

    def submit(self, dot: DotGraph, svg_path: str) -> None:
        self.figures += 1
        obs.metrics.inc("render.figures")
        key = render_key(dot)
        ent = self._entries.get(key)
        if ent is None:
            ent = self._entries[key] = _Entry(dot)
            self._order.append(key)
            obs.metrics.inc("render.unique_figures")
        ent.pending_paths.append(svg_path)

    def _fan_out(self, ent: _Entry, path: str) -> None:
        """Write one target: the first per directory is a real write, the
        others in that directory hardlink it (a plain write where links are
        unsupported)."""
        d = os.path.dirname(path)
        src = ent.link_src.get(d)
        if src is not None:
            try:
                if os.path.lexists(path):
                    os.unlink(path)
                os.link(src, path)
                return
            except OSError:
                pass
        with open(path, "w", encoding="utf-8") as f:
            f.write(ent.svg)
        ent.link_src[d] = path

    def drain(self) -> dict:
        t0 = time.perf_counter()
        with obs.span("render:drain", pending=len(self._order)):
            for key in self._order:
                ent = self._entries[key]
                if not ent.pending_paths:
                    continue
                if ent.svg is None:
                    t = time.perf_counter()
                    with obs.span("render:svg", inline=True):
                        ent.svg = render_svg(ent.graph)
                    dt = time.perf_counter() - t
                    self.render_s += dt
                    ent.graph = None
                    self.rendered += 1
                    obs.metrics.inc("render.rendered")
                    obs.metrics.inc("render.render_s", dt)
                for path in ent.pending_paths:
                    self._fan_out(ent, path)
                ent.pending_paths = []
        self.render_wall_s += time.perf_counter() - t0
        return self.stats()

    def close(self) -> None:
        """Release the scheduler's renders.  Every figure must have been
        drained: a figure submitted and never written raises."""
        pending = sum(len(e.pending_paths) for e in self._entries.values())
        self._entries.clear()
        self._order.clear()
        if pending:
            raise RuntimeError(f"RenderScheduler closed with {pending} figure(s) never written")

    def stats(self) -> dict:
        """The frontend's "Figure pipeline" table (the JAX package's keys):
        figures submitted, unique renders, their ratio, SVG cache hits and
        render workers (none and one: no cache, no pool), render_s the pure
        rendering time, render_wall_s the drain's wall (renders and
        writes)."""
        unique = len(self._entries)
        return {
            "figures": self.figures,
            "unique_figures": unique,
            "dedup_ratio": round(self.figures / unique, 2) if unique else 1.0,
            "figure_cache_hits": 0,
            "rendered": self.rendered,
            "render_workers": 1,
            "render_s": round(self.render_s, 3),
            "render_wall_s": round(self.render_wall_s, 3),
        }
