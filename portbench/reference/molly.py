"""The reference's Molly loader: runs.json and each run's two provenance
files into RunData, with the reference's ingestion invariants
(at15/nemo faultinjectors/molly.go:15-163).

A frozen copy of the port's object loader (``ingest/molly.py``) without
its quarantine and logging: the benchmark's corpora are well formed, and a
file that fails to parse fails the check.

* holds-maps are keyed by the string timestep in the last column of the
  model's 'pre'/'post' table rows (molly.go:38-48);
* runs partition into success/failed on the exact status "success"
  (molly.go:52-57);
* clock goals take their time from the label (molly.go:76-89), the
  two-number match winning over the wildcard one;
* every goal/rule/edge id is namespaced ``run_<iter>_{pre,post}_<id>``;
* per-run files are indexed by position, not iteration (molly.go:59-60).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

from .datatypes import ProvData, RunData

_CLOCK_TIME_WILD = re.compile(r", (\d+), __WILDCARD__\)")
_CLOCK_TIME_TWO = re.compile(r", (\d+), (\d+)\)")


@dataclass
class MollyOutput:
    run_name: str = ""
    output_dir: str = ""
    runs: list[RunData] = field(default_factory=list)
    runs_iters: list[int] = field(default_factory=list)
    success_runs_iters: list[int] = field(default_factory=list)
    failed_runs_iters: list[int] = field(default_factory=list)

    def get_runs_iters(self):
        return self.runs_iters

    def get_success_runs_iters(self):
        return self.success_runs_iters

    def get_failed_runs_iters(self):
        return self.failed_runs_iters

    def spacetime_dot_text(self, iteration: int) -> str:
        with open(os.path.join(self.output_dir, f"run_{iteration}_spacetime.dot"), encoding="utf-8") as f:
            return f.read()


def _fix_clock_times(prov: ProvData) -> None:
    for g in prov.goals:
        if g.table == "clock":
            m_wild = _CLOCK_TIME_WILD.search(g.label)
            m_two = _CLOCK_TIME_TWO.search(g.label)
            if m_wild:
                g.time = m_wild.group(1)
            if m_two:
                g.time = m_two.group(1)


def _namespace_prov(prov: ProvData, iteration: int, cond: str) -> None:
    prefix = f"run_{iteration}_{cond}_"
    for g in prov.goals:
        g.id = prefix + g.id
        g.cond_holds = False
    for r in prov.rules:
        r.id = prefix + r.id
    for e in prov.edges:
        e.src = prefix + e.src
        e.dst = prefix + e.dst


def load_molly_output(output_dir: str) -> MollyOutput:
    out = MollyOutput(run_name=os.path.basename(os.path.normpath(output_dir)), output_dir=output_dir)
    with open(os.path.join(output_dir, "runs.json"), encoding="utf-8") as f:
        raw_runs = json.load(f)
    for position, raw in enumerate(raw_runs):
        run = RunData.from_json(raw)
        for cond, attr in (("pre", "pre_prov"), ("post", "post_prov")):
            with open(os.path.join(output_dir, f"run_{position}_{cond}_provenance.json"), encoding="utf-8") as f:
                prov = ProvData.from_json(json.load(f))
            _fix_clock_times(prov)
            _namespace_prov(prov, run.iteration, cond)
            setattr(run, attr, prov)
        tables = run.model.tables if run.model else {}
        run.time_pre_holds = {row[-1]: True for row in tables.get("pre", []) if row}
        run.time_post_holds = {row[-1]: True for row in tables.get("post", []) if row}
        out.runs.append(run)
        out.runs_iters.append(run.iteration)
        (out.success_runs_iters if run.succeeded else out.failed_runs_iters).append(run.iteration)
    return out


def subsample(molly: MollyOutput, stride: int) -> MollyOutput:
    """Every ``stride``-th run of a corpus (1: the corpus itself)."""
    if stride == 1:
        return molly
    out = MollyOutput(run_name=molly.run_name, output_dir=molly.output_dir)
    for run in molly.runs[::stride]:
        out.runs.append(run)
        out.runs_iters.append(run.iteration)
        (out.success_runs_iters if run.succeeded else out.failed_runs_iters).append(run.iteration)
    return out
