"""Molly fault-injector output loader (ETL).

Reads a Molly output directory — runs.json plus per-run
run_<i>_{pre,post}_provenance.json and run_<i>_spacetime.dot — into RunData
structures, preserving the reference's ingestion invariants
(reference: faultinjectors/molly.go:15-163):

  * holds-maps are keyed by the *string* timestep in the last column of the
    model's 'pre'/'post' table rows (molly.go:38-48);
  * runs partition into success/failed on the exact status "success"
    (molly.go:52-57);
  * goals of table "clock" get their time extracted from the label via the
    two regexes `, (\\d+), __WILDCARD__\\)` and `, (\\d+), (\\d+)\\)`
    (molly.go:76-89);
  * every goal/rule/edge ID is namespaced `run_<iter>_{pre,post}_<origID>`
    (molly.go:92,101,106-107,140,149,154-155);
  * goals start with cond_holds=False until condition marking (molly.go:96).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

from nemo_tpu_torch import obs

from .datatypes import ProvData, RunData

_CLOCK_TIME_WILD = re.compile(r", (\d+), __WILDCARD__\)")
_CLOCK_TIME_TWO = re.compile(r", (\d+), (\d+)\)")


def _fix_clock_times(prov: ProvData) -> None:
    """Extract goal timesteps for clock goals from their labels.

    Reference: faultinjectors/molly.go:72-89 (pre) / :120-137 (post).  Note the
    reference applies the two-number regex *after* the wildcard regex, so when
    both match, the two-number match wins.
    """
    for g in prov.goals:
        if g.table == "clock":
            m_wild = _CLOCK_TIME_WILD.search(g.label)
            m_two = _CLOCK_TIME_TWO.search(g.label)
            if m_wild:
                g.time = m_wild.group(1)
            if m_two:
                g.time = m_two.group(1)


def _namespace_prov(prov: ProvData, iteration: int, cond: str) -> None:
    """Prefix all IDs with run_<iter>_<cond>_ (faultinjectors/molly.go:92-107)."""
    prefix = f"run_{iteration}_{cond}_"
    for g in prov.goals:
        g.id = prefix + g.id
        g.cond_holds = False
    for r in prov.rules:
        r.id = prefix + r.id
    for e in prov.edges:
        e.src = prefix + e.src
        e.dst = prefix + e.dst


@dataclass
class MollyOutput:
    """Parsed contents of one Molly output directory: runs, per-status
    iteration lists, and the runs that failed to parse (quarantined)."""

    run_name: str = ""
    output_dir: str = ""
    runs: list[RunData] = field(default_factory=list)
    runs_iters: list[int] = field(default_factory=list)
    success_runs_iters: list[int] = field(default_factory=list)
    failed_runs_iters: list[int] = field(default_factory=list)
    #: One record per source position whose entry or provenance file failed
    #: to parse: {"position", "iteration" (None when the entry itself was
    #: bad), "file", "error"}.
    quarantined: list[dict] = field(default_factory=list)
    #: Whether the layout ships per-run spacetime DOT files (Molly does, the
    #: trace-JSON layout of ingest/adapters.py does not): gates the
    #: synthesis in spacetime_dot_text, so a Molly corpus with a missing
    #: file still raises.
    ships_spacetime_dots: bool = True

    def get_output(self):
        return self.runs

    def get_runs_iters(self):
        return self.runs_iters

    def get_success_runs_iters(self):
        return self.success_runs_iters

    def get_failed_runs_iters(self):
        return self.failed_runs_iters

    def spacetime_dot_path(self, iteration: int) -> str:
        """Path of Molly's space-time diagram for one run
        (reference: graphing/hazard-analysis.go:25)."""
        return os.path.join(self.output_dir, f"run_{iteration}_spacetime.dot")

    def spacetime_dot_text(self, iteration: int, run=None) -> str:
        """One run's space-time DOT text: the layout's per-run file where it
        ships one (a missing file raises FileNotFoundError), else built from
        the run's message history and failure spec by
        models/synth.py:build_spacetime_dot, the generators' own diagram writer.
        ``run`` spares the search by iteration."""
        if self.ships_spacetime_dots:
            with open(self.spacetime_dot_path(iteration), "r", encoding="utf-8") as f:
                return f.read()
        from nemo_tpu_torch.models.synth import build_spacetime_dot

        if run is None:
            run = next(r for r in self.runs if r.iteration == iteration)
        fs = run.failure_spec
        return build_spacetime_dot(
            list(fs.nodes or []) if fs else [],
            fs.eot if fs else 0,
            [m.to_json() for m in run.messages],
            crashes={c.node: c.time for c in (fs.crashes if fs else None) or []},
        )


def attach_run_metadata(out: MollyOutput, run, tables: dict | None = None) -> None:
    """Holds-maps + success/failure classification for one parsed run,
    shared by this loader and the packed-first one
    (ingest/native.py:load_molly_output_packed).  Holds-maps are keyed by
    the string timestep in the last column of each 'pre'/'post' model-table
    row (molly.go:38-48).  ``tables`` supplies the model tables directly
    (the packed loader passes the raw dict, so the Model objects stay
    unbuilt); by default they are read from ``run.model``."""
    if tables is None:
        tables = run.model.tables if run.model else {}
    run.time_pre_holds = {row[-1]: True for row in tables.get("pre", []) if row}
    run.time_post_holds = {row[-1]: True for row in tables.get("post", []) if row}
    out.runs_iters.append(run.iteration)
    if run.succeeded:
        out.success_runs_iters.append(run.iteration)
    else:
        out.failed_runs_iters.append(run.iteration)


def quarantine_record(position: int, iteration, file: str, ex: BaseException) -> dict:
    """One quarantined run's record: the one shape shared by this loader,
    the corpus store's header and the report's quarantine.json."""
    return {
        "position": int(position),
        "iteration": None if iteration is None else int(iteration),
        "file": file,
        "error": f"{type(ex).__name__}: {ex}",
    }


def load_molly_output(output_dir: str, quarantine: bool | None = None) -> MollyOutput:
    """Load a Molly output directory.  Reference: faultinjectors/molly.go:15-163.

    With ``quarantine`` on (default ``NEMO_QUARANTINE``, on), a run whose runs.json entry or provenance file is
    malformed is recorded on ``MollyOutput.quarantined`` instead of aborting
    the whole corpus; a corpus with no healthy runs at all still raises.
    runs.json itself failing to parse always raises."""
    if quarantine is None:
        from nemo_tpu_torch.utils.env import quarantine_enabled

        quarantine = quarantine_enabled()
    out = MollyOutput(run_name=os.path.basename(os.path.normpath(output_dir)), output_dir=output_dir)

    runs_path = os.path.join(output_dir, "runs.json")
    with open(runs_path, "r", encoding="utf-8") as f:
        raw_runs = json.load(f)

    for i, raw in enumerate(raw_runs):
        try:
            run = RunData.from_json(raw)
        except Exception as ex:
            if not quarantine:
                raise
            _quarantine(out, quarantine_record(i, None, "runs.json", ex))
            continue
        try:
            # Per-run provenance files are indexed by position i, not by the
            # iteration field (molly.go:59-60).
            load_run_prov(output_dir, i, run)
        except Exception as ex:
            if not quarantine:
                raise
            cond = "post" if run.pre_prov is not None else "pre"
            _quarantine(out, quarantine_record(i, run.iteration, f"run_{i}_{cond}_provenance.json", ex))
            continue
        out.runs.append(run)
        attach_run_metadata(out, run)

    if out.quarantined and not out.runs:
        raise RuntimeError(
            f"every run in {output_dir} failed to parse "
            f"({len(out.quarantined)} quarantined; first: "
            f"{out.quarantined[0]['error']})"
        )
    return out


def _quarantine(out: MollyOutput, rec: dict) -> None:
    out.quarantined.append(rec)
    obs.metrics.inc("ingest.quarantined")
    obs.log.get_logger("nemo.ingest").warning(
        "ingest.quarantined", corpus=out.output_dir, position=rec["position"], file=rec["file"], error=rec["error"]
    )


def load_run_prov(output_dir: str, position: int, run) -> None:
    """Parse + namespace one run's two provenance files (indexed by file
    POSITION, not iteration — molly.go:59-60)."""
    for cond, attr in (("pre", "pre_prov"), ("post", "post_prov")):
        prov_path = os.path.join(output_dir, f"run_{position}_{cond}_provenance.json")
        with open(prov_path, "r", encoding="utf-8") as f:
            prov = ProvData.from_json(json.load(f))
        _fix_clock_times(prov)
        _namespace_prov(prov, run.iteration, cond)
        setattr(run, attr, prov)
