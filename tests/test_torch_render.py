"""The port's figure renderer against the JAX package's, on the CPU.

* ``render_svg`` (report/svg.py) writes the bytes of the JAX package's
  pure-Python ``render_svg`` on every figure of one small report (both
  sides parse the report's .dot files with their own ``parse_dot``), and
  ``render_key`` gives the JAX package's key;
* the dedup scheduler (report/render.py) writes the same bytes as
  rendering each figure in turn: every SVG of one report is the render of
  its own DOT although fewer renders ran than figures were written, and
  renamed but isomorphic figures render once.
"""

import json
import os

import pytest

from nemo_tpu.report.dot import parse_dot as jax_parse_dot
from nemo_tpu.report.render import render_key as jax_render_key
from nemo_tpu.report.svg import render_svg as jax_render_svg
from nemo_tpu_torch.analysis.pipeline import run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.report.dot import DotGraph, parse_dot
from nemo_tpu_torch.report.render import RenderScheduler, render_key
from nemo_tpu_torch.report.svg import render_svg


@pytest.fixture(scope="module")
def report(corpus_dir, tmp_path_factory):
    return run_debug(corpus_dir, str(tmp_path_factory.mktemp("render")), TorchBackend(device="cpu"))


@pytest.fixture(scope="module")
def report_dir(report):
    return report.report_dir


def _dot_files(report_dir: str) -> list[str]:
    figs = os.path.join(report_dir, "figures")
    return sorted(os.path.join(figs, f) for f in os.listdir(figs) if f.endswith(".dot"))


def test_render_svg_matches_jax_on_every_figure(report_dir):
    paths = _dot_files(report_dir)
    assert len(paths) >= 40
    kinds = set()
    for p in paths:
        text = open(p, encoding="utf-8").read()
        port_g, jax_g = parse_dot(text), jax_parse_dot(text)
        assert render_svg(port_g) == jax_render_svg(jax_g), p
        assert render_key(port_g) == jax_render_key(jax_g), p
        kinds.add(os.path.basename(p).split("_", 2)[2])
    assert len(kinds) == 7


def test_figure_svgs_are_the_renders_of_their_dots(report_dir):
    """Each written SVG is the render of its figure (the spacetime DOTs
    carry clusters, which the .dot text keeps)."""
    for p in _dot_files(report_dir):
        svg = open(p[: -len(".dot")] + ".svg", encoding="utf-8").read()
        assert svg == render_svg(parse_dot(open(p, encoding="utf-8").read())), p


def test_dedup_writes_the_bytes_of_one_render_per_figure(report):
    """The report's figures were written from fewer renders than figures,
    each SVG fanned out from its key's one render (the bytes are held
    against an in-turn render above), and telemetry.json carries the
    stats."""
    figs = os.path.join(report.report_dir, "figures")
    svgs = [open(os.path.join(figs, f), "rb").read() for f in os.listdir(figs) if f.endswith(".svg")]
    stats = report.figure_stats
    assert stats["figures"] == len(svgs)
    assert len(set(svgs)) <= stats["rendered"] == stats["unique_figures"] < stats["figures"]
    with open(os.path.join(report.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        assert json.load(fh)["figure_stats"] == stats


def _chain(prefix: str) -> DotGraph:
    g = DotGraph()
    for a, b in (("a", "b"), ("b", "c")):
        g.add_node(f"{prefix}{a}", {"label": a.upper(), "shape": "rect"})
        g.add_node(f"{prefix}{b}", {"label": b.upper()})
        g.add_edge(f"{prefix}{a}", f"{prefix}{b}", {"color": "black"})
    return g


def test_renamed_isomorphic_figures_render_once(tmp_path):
    s = RenderScheduler()
    graphs = [_chain("run_1_"), _chain("run_2_"), _chain("run_3_")]
    graphs[2].nodes[0].attrs["fillcolor"] = "firebrick"
    paths = [str(tmp_path / f"f{i}.svg") for i in range(3)]
    for g, p in zip(graphs, paths):
        s.submit(g, p)
    stats = s.drain()
    assert (stats["figures"], stats["unique_figures"], stats["rendered"]) == (3, 2, 2)
    for g, p in zip(graphs, paths):
        assert open(p, encoding="utf-8").read() == render_svg(g)
    assert s.drain()["rendered"] == 2  # nothing pending: no render
