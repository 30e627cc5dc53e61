"""The port's figure pipeline (report/render.py) against the JAX package's,
on the CPU, byte for byte: dedup by render key and the persistent SVG
cache, every miss rendered inline.

* ``render_key``, ``renderer_version`` and the cache's layout (version
  directory, key prefix) are the JAX package's; the two packages' default
  cache roots differ;
* a second scheduler on the same cache renders nothing; the
  ``NEMO_SVG_CACHE`` policy; a cache that cannot be written warns and the
  figures still land;
* an engine failure raises out of ``drain()``, through a Reporter's own
  scheduler too;
* ``run_debug(figures="all")`` and ``run_debug_dirs`` over two families
  write the JAX package's tree, file for file, each package on a fresh
  cache directory of its own, and a warm second run renders nothing;
* ``--svg-cache`` reaches the report's scheduler for the length of a CLI
  call;
* importing the report layer loads no torch (a fresh interpreter).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.pipeline import run_debug_dirs as jax_run_debug_dirs
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.report import render as jax_render
from nemo_tpu.report.dot import DotGraph as JaxDotGraph
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug, run_debug_dirs
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.kernels.build import BuildError
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.report import native, render
from nemo_tpu_torch.report.dot import DotGraph
from nemo_tpu_torch.report.native import render_svg_auto
from nemo_tpu_torch.report.render import RenderScheduler, SvgCache
from nemo_tpu_torch.report.svg import render_svg
from nemo_tpu_torch.report.writer import Reporter

REPO = Path(__file__).resolve().parent.parent


def _graph(DG, prefix: str, label: str = "goal") -> DotGraph:
    """A small styled DAG whose node NAMES carry ``prefix`` (the run_<iter>_
    shape) but whose rendered content does not."""
    g = DG(name="dataflow")
    g.graph_attrs["bgcolor"] = "transparent"
    attrs = {"label": label, "shape": "ellipse", "style": "filled, solid", "color": "black",
             "fillcolor": "white", "fontcolor": "black"}
    g.add_node(f"{prefix}_a", dict(attrs))
    g.add_node(f"{prefix}_b", {**attrs, "label": "rule", "shape": "rect"})
    g.add_edge(f"{prefix}_a", f"{prefix}_b", {"color": "black"})
    return g


def _jax_tree(report_dir: str) -> dict[str, bytes]:
    from nemo_tpu.analysis.pipeline import NONDETERMINISTIC_REPORT_FILES

    out = {}
    for dirpath, _, files in os.walk(report_dir):
        for f in files:
            if f not in NONDETERMINISTIC_REPORT_FILES:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, report_dir)] = Path(p).read_bytes()
    return out


def _same_tree(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert [k for k in got if got[k] != want[k]] == []


# ------------------------------------------------ keys, versions, layout


def test_key_version_and_cache_layout_are_the_jax_packages(tmp_path):
    for prefix, label in (("run_3_post", "goal"), ("run_999_post", "goal"), ("p", "other")):
        assert render.render_key(_graph(DotGraph, prefix, label)) == jax_render.render_key(
            _graph(JaxDotGraph, prefix, label))
    assert render.render_key(_graph(DotGraph, "run_1")) == render.render_key(_graph(DotGraph, "run_2"))
    assert render.renderer_version() == jax_render.renderer_version() == "svg1-abi2"
    key = render.render_key(_graph(DotGraph, "x"))
    ours, theirs = SvgCache(str(tmp_path / "a")), jax_render.SvgCache(str(tmp_path / "b"))
    assert os.path.relpath(ours._path(key), ours.root) == os.path.relpath(theirs._path(key), theirs.root) == (
        os.path.join("svg1-abi2", key[:2], f"{key}.svg"))


def test_cache_hits_across_instances(tmp_path):
    cache_dir = str(tmp_path / "cache")
    s1 = RenderScheduler(cache=SvgCache(cache_dir))
    s1.submit(_graph(DotGraph, "run_1"), str(tmp_path / "one.svg"))
    st1 = s1.drain()
    s1.close()
    assert (st1["rendered"], st1["figure_cache_hits"]) == (1, 0)
    assert os.path.isdir(os.path.join(cache_dir, render.renderer_version()))
    s2 = RenderScheduler(cache=SvgCache(cache_dir))
    s2.submit(_graph(DotGraph, "run_2"), str(tmp_path / "two.svg"))  # the same render key
    st2 = s2.drain()
    s2.close()
    assert (st2["rendered"], st2["figure_cache_hits"]) == (0, 1)
    assert (tmp_path / "one.svg").read_bytes() == (tmp_path / "two.svg").read_bytes() == render_svg_auto(
        _graph(DotGraph, "run_3")).encode()
    assert set(st2) == set(jax_render.RenderScheduler(workers=1, cache=jax_render.SvgCache("")).stats())


def test_svg_cache_policy(monkeypatch, tmp_path):
    monkeypatch.delenv("NEMO_SVG_CACHE", raising=False)
    home = os.path.expanduser("~")
    assert render.svg_cache_dir() == os.path.join(home, ".cache", "nemo_tpu_torch", "svg")
    assert jax_render.svg_cache_dir() == os.path.join(home, ".cache", "nemo_tpu", "svg")
    for off in ("off", "0", "none", "false", "OFF", " "):
        monkeypatch.setenv("NEMO_SVG_CACHE", off)
        assert render.svg_cache_dir() is None is jax_render.svg_cache_dir()
        assert SvgCache().root is None
    monkeypatch.setenv("NEMO_SVG_CACHE", str(tmp_path))
    assert render.svg_cache_dir() == str(tmp_path) == SvgCache().root
    assert SvgCache("").root is None


def test_a_cache_that_cannot_be_written_warns_and_the_figures_land(tmp_path):
    blocker = tmp_path / "cache"
    blocker.write_text("a file where the cache's directory would go")
    s = RenderScheduler(cache=SvgCache(str(blocker)))
    s.submit(_graph(DotGraph, "run_1"), str(tmp_path / "one.svg"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stats = s.drain()
    s.close()
    assert any("SVG cache write failed" in str(x.message) for x in w)
    assert stats["rendered"] == 1 and stats["figure_cache_hits"] == 0
    assert (tmp_path / "one.svg").read_text() == render_svg_auto(_graph(DotGraph, "run_1"))


def test_an_engine_failure_raises_out_of_drain(tmp_path, monkeypatch):
    """A Reporter with no scheduler submits to one of its own, which renders
    through render_svg_auto at drain: the C++ engine, whose failure raises
    (nothing is written), or the Python renderer under
    NEMO_SVG_IMPL=python."""
    rep = Reporter()
    assert isinstance(rep.scheduler, RenderScheduler)
    rep.scheduler.cache = SvgCache("")
    rep.figures_dir = str(tmp_path)
    g = _graph(DotGraph, "run_1")
    monkeypatch.delenv("NEMO_SVG_IMPL", raising=False)
    rep.generate_figures([1], "post_prov", [g])
    assert not (tmp_path / "run_1_post_prov.svg").exists()
    stats = rep.scheduler.drain()
    assert (tmp_path / "run_1_post_prov.svg").read_text() == native.render_svg_native(g) == render_svg(g)
    assert (tmp_path / "run_1_post_prov.dot").read_text() == g.to_string()
    assert stats["render_workers"] == 1 and stats["serial_render_est_s"] >= 0

    def broken():
        raise BuildError("g++ failed for nemo_report.cpp")

    monkeypatch.setattr(native.REPORT, "load", broken)
    rep.generate_figures([2], "post_prov", [_graph(DotGraph, "run_2", label="other")])
    with pytest.raises(BuildError):
        rep.scheduler.drain()
    assert not (tmp_path / "run_2_post_prov.svg").exists()
    monkeypatch.setenv("NEMO_SVG_IMPL", "python")
    rep.scheduler.drain()
    assert (tmp_path / "run_2_post_prov.svg").read_text() == render_svg(_graph(DotGraph, "run_2", label="other"))
    rep.scheduler.close()


# ------------------------------------------------------- whole reports


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("svg_families"))
    return [write_case_study(name, 6, 11, root) for name in ("CA-2083-hinted-handoff", "MR-3858-hadoop")]


def test_cached_report_equals_jax_then_warm(families, tmp_path, monkeypatch):
    """A fresh cache directory each side: the port's tree is the JAX
    package's, every unique figure rendered once; again on the warm caches,
    nothing renders and the trees hold."""
    d = families[0]
    trees = {}
    for tag in ("cold", "warm"):
        monkeypatch.setenv("NEMO_SVG_CACHE", str(tmp_path / "port-svg"))
        res = run_debug(d, str(tmp_path / f"port-{tag}"), TorchBackend(device="cpu"), figures="all")
        monkeypatch.setenv("NEMO_SVG_CACHE", str(tmp_path / "jax-svg"))
        jres = jax_run_debug(d, str(tmp_path / f"jax-{tag}"), JaxBackend(), figures="all")
        tree = report_tree_bytes(res.report_dir)
        _same_tree(tree, _jax_tree(jres.report_dir))
        fs, jfs = res.figure_stats, jres.figure_stats
        for k in ("figures", "unique_figures", "rendered", "figure_cache_hits", "render_workers"):
            assert fs[k] == jfs[k], k
        if tag == "cold":
            assert fs["rendered"] == fs["unique_figures"] < fs["figures"] and fs["figure_cache_hits"] == 0
        else:
            assert fs["rendered"] == 0 and fs["figure_cache_hits"] == fs["unique_figures"]
        trees[tag] = tree
    _same_tree(trees["warm"], trees["cold"])


def test_dirs_equal_jax_with_one_cache(families, tmp_path, monkeypatch):
    """run_debug_dirs over two families with one shared scheduler each side:
    the results roots are equal, file for file, and the stats too."""
    monkeypatch.setenv("NEMO_SVG_CACHE", str(tmp_path / "port-svg"))
    res = run_debug_dirs(families, str(tmp_path / "port"), lambda: TorchBackend(device="cpu"), figures="all")
    monkeypatch.setenv("NEMO_SVG_CACHE", str(tmp_path / "jax-svg"))
    jres = jax_run_debug_dirs(families, str(tmp_path / "jax"), JaxBackend, figures="all")
    for r, jr in zip(res, jres):
        _same_tree(report_tree_bytes(r.report_dir), _jax_tree(jr.report_dir))
    fs, jfs = res[0].figure_stats, jres[0].figure_stats
    assert fs["rendered"] == fs["unique_figures"] == jfs["rendered"] == jfs["unique_figures"]


def test_cli_svg_cache_flag(corpus_dir, tmp_path, capsys, monkeypatch):
    """``--svg-cache`` reaches the report's scheduler for the length of the
    call, and the figures line shows the hits; the environment is as
    before afterwards."""
    from nemo_tpu_torch import cli

    monkeypatch.setenv("NEMO_SVG_CACHE", "off")
    argv = ["-faultInjOut", corpus_dir, "--device", "cpu", "--results-dir", str(tmp_path / "R"), "--timings",
            "--corpus-cache", "off", "--result-cache", "off", "--svg-cache", str(tmp_path / "svg")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert ", 0 cache hits, 1 render workers" in out
    assert os.environ["NEMO_SVG_CACHE"] == "off"
    assert os.path.isdir(tmp_path / "svg" / render.renderer_version())
    assert cli.main(argv) == 0
    unique = json.loads((tmp_path / "R" / os.path.basename(corpus_dir) / "telemetry.json").read_text())[
        "figure_stats"]["unique_figures"]
    assert f", {unique} cache hits, 1 render workers" in capsys.readouterr().out


def test_report_layer_imports_no_torch():
    code = ("import sys\n"
            "import nemo_tpu_torch.report.render, nemo_tpu_torch.report.native, nemo_tpu_torch.report.writer\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith(('torch.', 'jax', 'nemo_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
