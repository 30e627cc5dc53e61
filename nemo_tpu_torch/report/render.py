"""Deduplicated, cached DOT -> SVG rendering, a copy of the JAX package's
``report/render.py`` without its worker pool.

1. **Dedup.**  Runs of one family draw from one protocol template, so their
   figures are mostly isomorphic, but their DOT text is not: node ids embed
   the run iteration (``run_<iter>_...``).  The renderer never draws node
   ids, only labels, colors, shapes, style flags and node/edge/cluster ORDER
   (report/svg.py), so figures are deduplicated by a *render key*, a hash
   over exactly the renderer's inputs: renamed-but-isomorphic figures
   collide, render once, and the SVG is written to every path that shares
   it.

2. **Persistent cache.**  Unique SVGs are stored content-addressed on disk,
   keyed by (render key, renderer version), under
   ``~/.cache/nemo_tpu_torch/svg`` (``NEMO_SVG_CACHE`` moves or disables
   it; the JAX package's root is another, so the two never share an
   entry): a warm re-report renders nothing.

Cache misses render inline at drain, in the submitting process, through
``report/native.py:render_svg_auto``.  The JAX package's spawned process
pool is not ported: on an H100's host it lost to inline rendering on every
report measured (PERF.md).

The output is byte-identical to rendering each figure in turn: the render
key covers every input the renderer reads, and the C++ engine writes the
bytes of report/svg.py (tests/test_torch_report_native.py).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
import warnings

from nemo_tpu_torch import obs

from .dot import DotGraph
from .native import REPORT_ABI_VERSION, render_svg_auto
from .svg import RENDER_FORMAT_VERSION


def svg_cache_dir() -> str | None:
    """The persistent SVG store's root: ``NEMO_SVG_CACHE`` when set
    (0/off/none/false disables -> None), else
    ``~/.cache/nemo_tpu_torch/svg``."""
    env = os.environ.get("NEMO_SVG_CACHE")
    if env is not None:
        env = env.strip()
        if env.lower() in ("", "0", "off", "none", "false"):
            return None
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "nemo_tpu_torch", "svg")


def renderer_version() -> str:
    """Cache-key version component: the Python layout version and the native
    engine's ABI version (the two engines are byte-identical, so one
    changes only with the other)."""
    return f"svg{RENDER_FORMAT_VERSION}-abi{REPORT_ABI_VERSION}"


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


class SvgCache:
    """On-disk content-addressed SVG store: one file per (render key,
    renderer version), written atomically (temp + rename) so that
    concurrent reports never read a torn file.  ``root=None`` takes
    ``svg_cache_dir()``; ``""`` disables (every get misses, puts are
    no-ops)."""

    def __init__(self, root: str | None = None) -> None:
        self.root = svg_cache_dir() if root is None else (root or None)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, renderer_version(), key[:2], f"{key}.svg")

    def get(self, key: str) -> str | None:
        if self.root is None:
            self.misses += 1
            obs.metrics.inc("render.svg_cache_misses")
            return None
        try:
            with open(self._path(key), "r", encoding="utf-8") as f:
                svg = f.read()
        except OSError:
            self.misses += 1
            obs.metrics.inc("render.svg_cache_misses")
            return None
        self.hits += 1
        obs.metrics.inc("render.svg_cache_hits")
        return svg

    def put(self, key: str, svg: str) -> None:
        if self.root is None:
            return
        path = self._path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".svg", dir=os.path.dirname(path))
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(svg)
            os.replace(tmp, path)
        except OSError as ex:  # a read-only cache degrades, never fails a report
            warnings.warn(f"SVG cache write failed ({ex}); continuing uncached", stacklevel=2)


class _Entry:
    """One unique render key's lifetime state."""

    __slots__ = ("svg", "graph", "pending_paths", "render_dt", "count", "link_src")

    def __init__(self) -> None:
        self.svg: str | None = None
        self.graph: DotGraph | None = None  # held for the render at drain
        self.pending_paths: list[str] = []  # targets not yet written
        self.render_dt = 0.0  # seconds ONE render of this figure took
        self.count = 0  # submissions (fan-out width)
        #: per directory, the path already written: the hardlink source of
        #: further paths in that directory.
        self.link_src: dict[str, str] = {}


class RenderScheduler:
    """The dedup + cache figure renderer.

    ``submit(dot, svg_path)`` computes the render key and looks a new key
    up in the persistent cache.  ``drain()`` renders each miss once, in
    submission order, writes each SVG to every path submitted since the
    last drain, feeds the cache and returns ``stats()``.  Entries persist
    across drains: a key submitted again is served from memory.  One
    scheduler may serve several reports (run_debug_dirs): their figures
    dedup together and land at its drain.  ``cache`` defaults to an
    ``SvgCache()`` at ``svg_cache_dir()``.
    """

    def __init__(self, cache: SvgCache | None = None) -> None:
        self.cache = SvgCache() if cache is None else cache
        self._entries: dict[str, _Entry] = {}
        self._order: list[str] = []  # submission order, for deterministic drains
        self.figures = 0  # figures submitted
        self.rendered = 0  # unique keys rendered
        self.render_s = 0.0  # rendering seconds, summed over unique renders
        self.render_wall_s = 0.0  # wall inside drain: renders, cache I/O, writes

    def submit(self, dot: DotGraph, svg_path: str) -> None:
        """Register one figure: ``svg_path`` receives its SVG at the next
        drain().  Dedup and the cache lookup happen here."""
        self.figures += 1
        obs.metrics.inc("render.figures")
        key = render_key(dot)
        ent = self._entries.get(key)
        if ent is None:
            ent = self._entries[key] = _Entry()
            self._order.append(key)
            obs.metrics.inc("render.unique_figures")
            ent.svg = self.cache.get(key)
            if ent.svg is None:
                ent.graph = dot
        ent.count += 1
        ent.pending_paths.append(svg_path)

    def _fan_out(self, ent: _Entry, path: str) -> None:
        """Write one target: the first per directory is a real write, the
        others in that directory hardlink it (a plain write where links are
        unsupported).  Links never cross report directories, so each
        report stays a self-contained file set."""
        d = os.path.dirname(path)
        src = ent.link_src.get(d)
        if src is not None:
            try:
                if os.path.lexists(path):
                    os.unlink(path)
                os.link(src, path)
                return
            except OSError:
                pass  # src vanished / links unsupported: fall through
        with open(path, "w", encoding="utf-8") as f:
            f.write(ent.svg)
        ent.link_src[d] = path

    def drain(self) -> dict:
        """Render every pending miss, write every pending SVG and return
        stats().  An engine failure raises here.  A drain with nothing
        pending only snapshots."""
        t0 = time.perf_counter()
        try:
            with obs.span("render:drain", pending=len(self._order)):
                for key in self._order:
                    ent = self._entries[key]
                    if not ent.pending_paths:
                        continue
                    if ent.svg is None:
                        t = time.perf_counter()
                        with obs.span("render:svg", inline=True):
                            svg = render_svg_auto(ent.graph)
                        ent.svg, ent.render_dt, ent.graph = svg, time.perf_counter() - t, None
                        self.rendered += 1
                        self.render_s += ent.render_dt
                        obs.metrics.inc("render.rendered")
                        obs.metrics.inc("render.render_s", ent.render_dt)
                        self.cache.put(key, ent.svg)
                    for path in ent.pending_paths:
                        self._fan_out(ent, path)
                    ent.pending_paths = []
        finally:
            self.render_wall_s += time.perf_counter() - t0
        return self.stats()

    def stats(self) -> dict:
        """The frontend's "Figure pipeline" table (the JAX package's keys),
        lifetime totals: render_s is the pure rendering time (summed over
        unique renders); serial_render_est_s what rendering every figure in
        turn would have spent (each unique render's time times its fan-out
        width), so their ratio is the dedup's gain; render_wall_s the
        drains' wall (renders, cache I/O and writes); render_workers is 1,
        the submitting process."""
        unique = len(self._entries)
        serial_est = sum(e.render_dt * e.count for e in self._entries.values() if e.render_dt)
        return {
            "figures": self.figures,
            "unique_figures": unique,
            "dedup_ratio": round(self.figures / unique, 2) if unique else 1.0,
            "figure_cache_hits": self.cache.hits,
            "rendered": self.rendered,
            "render_workers": 1,
            "render_s": round(self.render_s, 3),
            "serial_render_est_s": round(serial_est, 3),
            "render_wall_s": round(self.render_wall_s, 3),
        }

    def close(self) -> None:
        """Release the renders.  Every figure must have been drained: a
        figure submitted and never written raises."""
        pending = sum(len(e.pending_paths) for e in self._entries.values())
        self._entries.clear()
        self._order.clear()
        if pending:
            raise RuntimeError(f"RenderScheduler closed with {pending} figure(s) never written")
