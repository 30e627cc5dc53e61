"""The port's C++ SVG engine (report/native.py, csrc/host/nemo_report.cpp)
against the JAX package's engine and the port's Python renderer, on the
CPU, byte for byte:

* the unit graphs of tests/test_report_native.py: empty, defaults, styles
  and shapes, a self-loop and a cycle, label escaping, process clusters;
* seeded random graphs (numpy ``default_rng``), DAGs and cyclic, with
  random styles and clusters;
* every figure of a small report, parsed from its .dot files by each
  package's own parser.

The engine is the port's own byte copy of the JAX package's source, built
by g++ into the port's build directory; a build or load failure raises,
and ``render_svg_auto`` never falls back to Python unless
``NEMO_SVG_IMPL=python`` asks for it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from nemo_tpu.report.dot import DotEdge as JaxDotEdge
from nemo_tpu.report.dot import DotGraph as JaxDotGraph
from nemo_tpu.report.dot import parse_dot as jax_parse_dot
from nemo_tpu.report.native import native_available as jax_native_available
from nemo_tpu.report.native import render_svg_native as jax_render_svg_native
from nemo_tpu_torch.analysis.pipeline import run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.kernels.build import BuildError
from nemo_tpu_torch.models.synth import build_spacetime_dot
from nemo_tpu_torch.report import native
from nemo_tpu_torch.report.dot import DotEdge, DotGraph, parse_dot
from nemo_tpu_torch.report.svg import render_svg
from nemo_tpu_torch.utils.cbuild import NativeLib

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nemo_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _jax_engine():
    assert jax_native_available(), "the JAX package's engine must build here to compare against"


def assert_same(build) -> None:
    """``build(DotGraphClass)`` makes one graph in each package: the port's
    engine writes the JAX engine's bytes and the port's Python renderer's."""
    g, jg = build(DotGraph), build(JaxDotGraph)
    got = native.render_svg_native(g)
    assert got == jax_render_svg_native(jg)
    assert got == render_svg(g)


def _empty(DG):
    return DG()


def _defaults(DG):
    g = DG()
    g.add_node("a")
    return g


def _styles_and_shapes(DG):
    g = DG()
    g.add_node("r1", {"label": "agg_rule", "shape": "rect", "style": "bold", "color": "lawngreen"})
    g.add_node("g1", {"label": "goal(a, 1)", "shape": "ellipse", "style": "filled",
                      "fillcolor": "firebrick", "fontcolor": "white"})
    g.add_node("hidden", {"style": "invis"})
    g.add_node("d", {"style": "dashed,bold", "color": "mediumvioletred"})
    g.add_edge("r1", "g1", {"color": "gold"})
    g.add_edge("g1", "d", {"style": "dashed"})
    g.add_edge("r1", "hidden", {"style": "invis"})
    return g


def _self_loop_and_cycle(DG):
    g = DG()
    g.add_edge("a", "a")
    g.add_edge("b", "c")
    g.add_edge("c", "d")
    g.add_edge("d", "b")
    return g


def _escaping(DG):
    g = DG()
    g.add_node("x", {"label": 'pre(a) :- b<c & d>"e" \'f\''})
    g.add_node("y", {"label": ""})
    g.add_node("z", {"label": "ünïcödé → λ"})
    g.add_edge("x", "y")
    g.add_edge("y", "z")
    return g


def _spacetime(DG):
    msgs = [{"from": "a", "to": "b", "sendTime": 1, "receiveTime": 2},
            {"from": "b", "to": "C", "sendTime": 2, "receiveTime": 3}]
    text = build_spacetime_dot(["a", "b", "C"], 4, msgs, crashes={"b": 3})
    return (parse_dot if DG is DotGraph else jax_parse_dot)(text)


UNIT_GRAPHS = {f.__name__.lstrip("_"): f for f in (_empty, _defaults, _styles_and_shapes, _self_loop_and_cycle,
                                                    _escaping, _spacetime)}


@pytest.mark.parametrize("name", sorted(UNIT_GRAPHS))
def test_unit_graphs(name):
    assert_same(UNIT_GRAPHS[name])


def _random_graph(seed: int):
    """A seeded random graph (both packages build the same one): random
    labels, shapes, styles and fills; edges mostly forward (a DAG), some
    arbitrary (cycles, self-loops), a few to no node; a random subset of the
    nodes in up to three clusters."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    nodes = []
    for i in range(n):
        attrs = {}
        if rng.random() < 0.5:
            attrs["label"] = f"tbl_{rng.integers(8)}({rng.integers(4)}, {i})"
        if rng.random() < 0.3:
            attrs["shape"] = str(rng.choice(["rect", "ellipse"]))
        if rng.random() < 0.3:
            attrs["style"] = str(rng.choice(["bold", "dashed", "invis", "dashed,bold", "filled, solid"]))
        if rng.random() < 0.3:
            attrs["fillcolor"] = str(rng.choice(["firebrick", "deepskyblue", "lightgrey"]))
        nodes.append((f"n{i}", attrs))
    edges = []
    for _ in range(int(rng.integers(1, 3 * n))):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        attrs = {}
        if rng.random() < 0.3:
            attrs["color"] = "#888"
        if rng.random() < 0.2:
            attrs["style"] = str(rng.choice(["dashed", "invis"]))
        if rng.random() < 0.8 and a != b:
            a, b = min(a, b), max(a, b)
        edges.append((f"n{a}", f"n{b}" if rng.random() < 0.97 else "ghost", attrs))
    n_clusters = int(rng.integers(0, 4))
    members = [(f"n{i}", int(rng.integers(n_clusters))) for i in range(n) if n_clusters and rng.random() < 0.6]

    def build(DG):
        g = DG()
        for name, attrs in nodes:
            g.add_node(name, dict(attrs))
        for a, b, attrs in edges:
            if b == "ghost":  # an edge to no node: every renderer skips it
                g.edges.append((DotEdge if DG is DotGraph else JaxDotEdge)(src=a, dst=b, attrs=dict(attrs)))
            else:
                g.add_edge(a, b, dict(attrs))
        for c in range(n_clusters):
            g.add_cluster(f"cluster_{c}", {"label": f"box {c}"})
        for name, c in members:
            g.assign_cluster(name, f"cluster_{c}")
        return g

    return build


@pytest.mark.parametrize("seed", range(24))
def test_seeded_random_graphs(seed):
    assert_same(_random_graph(seed))


@pytest.fixture(scope="module")
def small_report(corpus_dir, tmp_path_factory):
    return run_debug(corpus_dir, str(tmp_path_factory.mktemp("native")), TorchBackend(device="cpu"), figures="all")


def test_every_figure_of_a_report(small_report):
    figs = os.path.join(small_report.report_dir, "figures")
    dots = sorted(f for f in os.listdir(figs) if f.endswith(".dot"))
    assert len(dots) >= 40
    for f in dots:
        text = open(os.path.join(figs, f), encoding="utf-8").read()
        g, jg = parse_dot(text), jax_parse_dot(text)
        got = native.render_svg_native(g)
        assert got == jax_render_svg_native(jg) == render_svg(g), f
        # The report wrote the engine's bytes.
        assert open(os.path.join(figs, f[: -len(".dot")] + ".svg"), encoding="utf-8").read() == got, f


def test_engine_is_the_ports_own_copy():
    lib = native.REPORT.load()
    assert native.REPORT.src == PORT / "csrc" / "host" / "nemo_report.cpp"
    assert native.REPORT.src.read_bytes() == (REPO / "native" / "nemo_report.cpp").read_bytes()
    assert Path(lib._name).parent == PORT / "build"
    assert Path(native.build_native()) == Path(lib._name)
    assert lib.nemo_report_abi_version() == native.REPORT_ABI_VERSION == 2


def test_build_failure_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int nemo_report_abi_version( { return 2; }\n")
    with pytest.raises(BuildError, match="g\\+\\+ failed"):
        NativeLib(bad, lambda lib: None, "nemo_report_abi_version", 2).load()
    with pytest.raises(BuildError, match="unreadable"):
        NativeLib(tmp_path / "missing.cpp", lambda lib: None, "nemo_report_abi_version", 2).load()


@pytest.mark.parametrize("impl", [None, "native"])
def test_auto_raises_where_the_engine_fails(impl, monkeypatch):
    """The default and ``native`` render only through the engine: its
    failure raises instead of a quiet Python render; ``python`` never
    loads it."""
    def broken():
        raise BuildError("g++ failed for nemo_report.cpp")

    monkeypatch.setattr(native.REPORT, "load", broken)
    if impl is None:
        monkeypatch.delenv("NEMO_SVG_IMPL", raising=False)
    else:
        monkeypatch.setenv("NEMO_SVG_IMPL", impl)
    g = _styles_and_shapes(DotGraph)
    with pytest.raises(BuildError):
        native.render_svg_auto(g)
    monkeypatch.setenv("NEMO_SVG_IMPL", "python")
    assert native.render_svg_auto(g) == render_svg(g)


@pytest.mark.parametrize("junk", ["auto", "bogus", "c++"])
def test_svg_impl_junk_raises(junk, monkeypatch):
    """``NEMO_SVG_IMPL`` takes ``native`` or ``python``; any other value
    raises instead of quietly picking an engine."""
    monkeypatch.setenv("NEMO_SVG_IMPL", junk)
    with pytest.raises(ValueError, match="NEMO_SVG_IMPL"):
        native.render_svg_auto(_styles_and_shapes(DotGraph))
