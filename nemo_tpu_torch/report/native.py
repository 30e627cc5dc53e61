"""ctypes bindings for the native figure-rendering engine, a copy of the JAX
package's ``report/native.py`` bound to the port's own copy of the engine
(``csrc/host/nemo_report.cpp``).

The reference's figures come from graphviz (report/webpage.go:65); here an
in-tree C++ layout engine produces SVG byte-identical to the Python renderer
(report/svg.py), which stays the parity oracle.  Attribute resolution (DOT
attrs -> labels, shapes, style flags, colors) happens in this module, so the
C++ core is a pure layout and string builder.  ``render_svg_auto`` picks the
engine (``NEMO_SVG_IMPL=native|python``, default native).

The engine is built with g++ into the port's build directory at its first
use (utils/cbuild.py).  Unlike the JAX package's ``auto``, the default
never falls back to Python: a build or load failure raises ``BuildError``,
as the port's ingest engine does.
"""

from __future__ import annotations

import ctypes

from nemo_tpu_torch.utils.cbuild import HOST_SRC_DIR, NativeLib
from nemo_tpu_torch.utils.env import env_choice

from .dot import DotGraph
from .svg import render_svg as render_svg_python

_INVIS, _DASHED, _BOLD = 1, 2, 4

#: ``NEMO_SVG_IMPL``'s values, the default first.
SVG_IMPLS = ("native", "python")

#: ABI version the compiled library must report.  Also part of the
#: persistent SVG cache key (report/render.py:renderer_version), since an
#: ABI bump accompanies any change to the native engine's output.
REPORT_ABI_VERSION = 2


def _bind(lib: ctypes.CDLL) -> None:
    lib.nemo_render_svg.restype = ctypes.c_void_p  # owned char*, freed below
    lib.nemo_render_svg.argtypes = [
        ctypes.c_int,  # n_nodes
        ctypes.POINTER(ctypes.c_char_p),  # labels
        ctypes.POINTER(ctypes.c_int32),  # label char counts
        ctypes.POINTER(ctypes.c_ubyte),  # shape_rect
        ctypes.POINTER(ctypes.c_ubyte),  # node flags
        ctypes.POINTER(ctypes.c_char_p),  # fill
        ctypes.POINTER(ctypes.c_char_p),  # stroke
        ctypes.POINTER(ctypes.c_char_p),  # fontcolor
        ctypes.c_int,  # n_edges
        ctypes.POINTER(ctypes.c_int32),  # esrc
        ctypes.POINTER(ctypes.c_int32),  # edst
        ctypes.POINTER(ctypes.c_char_p),  # edge color
        ctypes.POINTER(ctypes.c_ubyte),  # edge flags
        ctypes.c_int,  # n_clusters
        ctypes.POINTER(ctypes.c_char_p),  # cluster labels
        ctypes.POINTER(ctypes.c_int32),  # node cluster ordinal (-1 none)
    ]
    lib.nemo_report_free.argtypes = [ctypes.c_void_p]


REPORT = NativeLib(HOST_SRC_DIR / "nemo_report.cpp", _bind, "nemo_report_abi_version", REPORT_ABI_VERSION)


def build_native() -> str:
    """Build (if missing) and load the engine; returns the library's path.
    Raises ``BuildError`` when it cannot be built or loaded."""
    return REPORT.load()._name


def _style_flags(attrs: dict[str, str]) -> int:
    style = attrs.get("style", "")
    flags = 0
    if "invis" in style:
        flags |= _INVIS
    if "dashed" in style:
        flags |= _DASHED
    if "bold" in style:
        flags |= _BOLD
    return flags


def render_svg_native(g: DotGraph) -> str:
    """Render through the C++ engine (built at first use; a failure
    raises)."""
    lib = REPORT.load()

    nodes = list(g.nodes)
    index = {n.name: i for i, n in enumerate(nodes)}
    edges = [e for e in g.edges if e.src in index and e.dst in index]

    n = len(nodes)
    labels = [node.attrs.get("label", node.name) for node in nodes]
    c_labels = (ctypes.c_char_p * n)(*[lb.encode("utf-8") for lb in labels])
    c_label_chars = (ctypes.c_int32 * n)(*[len(lb) for lb in labels])
    c_shape = (ctypes.c_ubyte * n)(
        *[1 if node.attrs.get("shape", "ellipse") == "rect" else 0 for node in nodes]
    )
    c_nflags = (ctypes.c_ubyte * n)(*[_style_flags(node.attrs) for node in nodes])
    c_fill = (ctypes.c_char_p * n)(
        *[node.attrs.get("fillcolor", "white").encode("utf-8") for node in nodes]
    )
    c_stroke = (ctypes.c_char_p * n)(
        *[node.attrs.get("color", "black").encode("utf-8") for node in nodes]
    )
    c_fontcolor = (ctypes.c_char_p * n)(
        *[node.attrs.get("fontcolor", "black").encode("utf-8") for node in nodes]
    )

    m = len(edges)
    c_esrc = (ctypes.c_int32 * m)(*[index[e.src] for e in edges])
    c_edst = (ctypes.c_int32 * m)(*[index[e.dst] for e in edges])
    c_ecolor = (ctypes.c_char_p * m)(
        *[e.attrs.get("color", "#444").encode("utf-8") for e in edges]
    )
    c_eflags = (ctypes.c_ubyte * m)(*[_style_flags(e.attrs) for e in edges])

    k = len(g.clusters)
    c_cluster_labels = (ctypes.c_char_p * max(1, k))(
        *[c.attrs.get("label", c.name).encode("utf-8") for c in g.clusters]
        or [b""]
    )
    node_cluster = [-1] * n
    for ci, c in enumerate(g.clusters):
        for member in c.nodes:
            if member in index:
                node_cluster[index[member]] = ci
    c_node_cluster = (ctypes.c_int32 * max(1, n))(*(node_cluster or [0]))

    ptr = lib.nemo_render_svg(
        n, c_labels, c_label_chars, c_shape, c_nflags, c_fill, c_stroke, c_fontcolor,
        m, c_esrc, c_edst, c_ecolor, c_eflags,
        k, c_cluster_labels, c_node_cluster,
    )
    if not ptr:
        raise RuntimeError("native report engine returned NULL")
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.nemo_report_free(ptr)


def render_svg_auto(g: DotGraph) -> str:
    """Engine dispatch on ``NEMO_SVG_IMPL``: ``native`` (the default) renders
    with the C++ engine, whose build or load failure raises; ``python``
    with report/svg.py.  Any other value raises."""
    if env_choice("NEMO_SVG_IMPL", "native", SVG_IMPLS) == "python":
        return render_svg_python(g)
    return render_svg_native(g)
