"""Report writer: results directory preparation and figure generation, a copy
of the JAX package's ``report/writer.py``.

Reference: report/webpage.go (Prepare copies the assets template into
results/<runName>/ and creates figures/, webpage.go:26-50; GenerateFigure
writes <name>.dot and renders <name>.svg, webpage.go:53-76; GenerateFigures
names files run_<iter>_<name>, webpage.go:79-99).  SVGs come from the
built-in layout engine instead of graphviz: the C++ engine
(csrc/host/nemo_report.cpp), or the Python renderer (report/svg.py) under
``NEMO_SVG_IMPL=python``.

SVG rendering goes through the Reporter's RenderScheduler
(report/render.py): deduplicated, served from the persistent SVG cache,
and the files land at the scheduler's drain().  The .dot files are written
at once.
"""

from __future__ import annotations

import os
import shutil

from .dot import DotGraph
from .render import RenderScheduler

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")


class Reporter:
    def __init__(self, scheduler: RenderScheduler | None = None) -> None:
        """``scheduler``: the RenderScheduler the SVGs go to, shared with
        other reports (run_debug_dirs) and drained by its owner; default a
        scheduler of this report's own."""
        self.res_dir = ""
        self.figures_dir = ""
        self.scheduler = scheduler if scheduler is not None else RenderScheduler()

    def prepare(self, all_results_dir: str, this_results_dir: str) -> None:
        """Copy the report template and create the figures directory
        (reference: report/webpage.go:26-50)."""
        os.makedirs(all_results_dir, exist_ok=True)
        if os.path.isdir(this_results_dir):
            shutil.rmtree(this_results_dir)
        shutil.copytree(ASSETS_DIR, this_results_dir)
        self.res_dir = this_results_dir
        self.figures_dir = os.path.join(this_results_dir, "figures")
        os.makedirs(self.figures_dir, exist_ok=True)

    def generate_figure(self, file_name: str, dot: DotGraph) -> None:
        """Write <name>.dot and submit <name>.svg to the scheduler, which
        writes it at drain() (reference: report/webpage.go:53-76)."""
        with open(os.path.join(self.figures_dir, f"{file_name}.dot"), "w", encoding="utf-8") as f:
            f.write(dot.to_string())
        self.scheduler.submit(dot, os.path.join(self.figures_dir, f"{file_name}.svg"))

    def generate_figures(self, iters: list[int], name: str, dots: list[DotGraph]) -> None:
        """One figure per run, named run_<iter>_<name>
        (reference: report/webpage.go:79-99)."""
        if len(iters) != len(dots):
            raise ValueError("Unequal number of iteration numbers and DOT graphs")
        for i, dot in zip(iters, dots):
            self.generate_figure(f"run_{i}_{name}", dot)
