"""End-to-end debugging pipeline: one corpus in, one report tree out.

A copy of the JAX package's ``analysis/pipeline.py`` trimmed to what
``run_debug`` needs on one corpus (no corpus store, result cache, streaming
or checkpoints).  The stage order mirrors the reference's main()
(main.go:106-292): ingest -> init backend -> load raw provenance ->
simplify -> hazard analysis -> prototypes -> pull provenance DOTs ->
differential provenance -> corrections (only when failures exist) ->
extensions -> repair synthesis -> recommendation assembly -> report
(debugging.json, repairs.json, 7 figure families, the HTML/JS frontend).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch

from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.backend.base import GraphBackend
from nemo_tpu_torch.ingest.molly import MollyOutput, load_molly_output
from nemo_tpu_torch.report.writer import Reporter
from nemo_tpu_torch.utils.timing import PhaseTimer

# Top-level recommendation texts (reference: main.go:195,205,212,216).
REC_FAULT = "A fault occurred. Let's try making the protocol correct first."
REC_EXTEND = (
    "Good job, no specification violation. At least one run did not establish "
    "the antecedent, though. Maybe double-check the fault tolerance of the "
    "following rules:"
)
REC_CANT_HELP = (
    "Nemo can't help with this type of bug. Please use the graphs below "
    "regarding differential provenance for guidance to root cause."
)
REC_WELL_DONE = "Well done! No faults, no missing fault tolerance."

#: Report files that are per-run wall-clock telemetry, different between
#: byte-identical reports; every byte-parity comparison skips exactly these.
NONDETERMINISTIC_REPORT_FILES = frozenset({"telemetry.json"})


@dataclass
class DebugResult:
    molly: MollyOutput
    report_dir: str
    timings: dict[str, float]
    #: RenderScheduler.stats() of the report's figures
    figure_stats: dict


def report_tree_bytes(root: str) -> dict[str, bytes]:
    """relpath -> content of every deterministic report file under ``root``
    (``NONDETERMINISTIC_REPORT_FILES`` left out): the byte-parity view of a
    report tree."""
    out: dict[str, bytes] = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f in NONDETERMINISTIC_REPORT_FILES:
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _write_telemetry(report_dir: str, timings: dict, figure_stats: dict) -> None:
    """telemetry.json next to debugging.json: the phase walls and the figure
    pipeline's stats (the frontend's "Run telemetry" section)."""
    doc = {
        "timings": {k: round(v, 6) for k, v in timings.items()},
        "figure_stats": figure_stats,
    }
    with open(os.path.join(report_dir, "telemetry.json"), "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)


def _run_json_str(run, good_iter: int | None) -> str:
    """One debugging.json run entry: json.dumps({**run.to_json(),
    "goodRunIteration": good_iter}) with the same key order and omitempty
    policy (datatypes.py:RunData.to_json)."""
    pairs: list[tuple[str, str]] = [
        ("iteration", json.dumps(run.iteration)),
        ("status", json.dumps(run.status)),
        ("failureSpec", json.dumps(run.failure_spec.to_json() if run.failure_spec else None)),
        ("model", json.dumps(run.model.to_json() if run.model else None)),
        ("messages", json.dumps([m.to_json() for m in run.messages])),
    ]
    if run.pre_prov is not None:
        pairs.append(("preProv", json.dumps(run.pre_prov.to_json())))
    if run.time_pre_holds:
        pairs.append(("timePreHolds", json.dumps(run.time_pre_holds)))
    if run.post_prov is not None:
        pairs.append(("postProv", json.dumps(run.post_prov.to_json())))
    if run.time_post_holds:
        pairs.append(("timePostHolds", json.dumps(run.time_post_holds)))
    if run.recommendation:
        pairs.append(("recommendation", json.dumps(run.recommendation)))
    if run.corrections:
        pairs.append(("corrections", json.dumps(run.corrections)))
    if run.missing_events:
        pairs.append(("missingEvents", json.dumps([m.to_json() for m in run.missing_events])))
    if run.inter_proto:
        pairs.append(("interProto", json.dumps(run.inter_proto)))
    if run.inter_proto_missing:
        pairs.append(("interProtoMissing", json.dumps(run.inter_proto_missing)))
    if run.union_proto:
        pairs.append(("unionProto", json.dumps(run.union_proto)))
    if run.union_proto_missing:
        pairs.append(("unionProtoMissing", json.dumps(run.union_proto_missing)))
    pairs.append(("goodRunIteration", json.dumps(good_iter)))
    return "{" + ", ".join(f'"{k}": {v}' for k, v in pairs) + "}"


def select_figure_iters(
    policy: str, iters: list[int], failed_iters: list[int], good_iter: int | None
) -> list[int]:
    """Figure materialization policy:

      all       every run gets figures (the reference, main.go:251-289)
      failed    failed runs + the good baseline run
      sample:N  N evenly-spaced failed runs + N evenly-spaced successes +
                the good run
      none      debugging.json only, no figures

    debugging.json always covers every run regardless of policy."""
    if policy in ("", "all"):
        return list(iters)
    sel: set[int] = set()
    include_good = False
    if policy == "none":
        pass
    elif policy == "failed":
        sel = set(failed_iters)
        include_good = True
    elif policy.startswith("sample:"):
        n = int(policy.split(":", 1)[1])
        failed_set = set(failed_iters)
        others = [i for i in iters if i not in failed_set]
        for pool in (list(failed_iters), others):
            if pool and n > 0:
                stride = max(1, len(pool) // n)
                sel.update(pool[::stride][:n])
        include_good = n > 0
    else:
        raise ValueError(
            f"unknown figure policy {policy!r} (expected all, failed, sample:N, none)"
        )
    # The good baseline run always renders under the restrictive policies,
    # including on an all-success corpus.
    if include_good and good_iter is not None:
        sel.add(good_iter)
    return [i for i in iters if i in sel]


def run_debug(
    fault_inj_out: str,
    results_root: str,
    backend: GraphBackend | None = None,
    figures: str = "all",
    report_name: str | None = None,
) -> DebugResult:
    """The full debug pipeline over one Molly directory; writes
    ``results_root/<report_name or corpus name>/``.  ``backend`` defaults to
    a TorchBackend on cuda, which raises without a card.  ``figures`` is
    the figure policy (select_figure_iters).  Figure SVGs render through
    the dedup scheduler (report/render.py), drained inside the report
    phase.  On the card every phase ends with ``torch.cuda.synchronize``,
    so the phase walls cover the device work."""
    if backend is None:
        from nemo_tpu_torch.backend.torch_backend import TorchBackend

        backend = TorchBackend()
    dev = getattr(getattr(backend, "executor", None), "device", None)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev is not None and dev.type == "cuda" else None
    timer = PhaseTimer(sync=sync)

    with timer.phase("ingest"):
        molly = load_molly_output(fault_inj_out)
    iters = molly.get_runs_iters()
    failed_iters = molly.get_failed_runs_iters()
    this_results_dir = os.path.join(results_root, report_name or molly.run_name)

    # The baseline good run (delta.choose_good_run): on an all-failed corpus
    # diff and corrections are skipped instead of raising.  The restrictive
    # figure policies include it even on an all-success corpus.
    good_iter = delta.choose_good_run(molly)
    fig_iters = select_figure_iters(figures, iters, failed_iters, good_iter)

    with timer.phase("init"):
        backend.init_graph_db("", molly)
    try:
        mo = delta.map_runs(backend, molly, fault_inj_out, good_iter, set(fig_iters), timer)
    finally:
        backend.close_db()

    with timer.phase("reduce"):
        red = delta.reduce_partials([mo.as_partial(iters)], molly, good_iter)

    # Recommendation assembly, 4-way priority (main.go:190-217), resolved by
    # iteration (the reference indexes its runs slice with iteration
    # numbers, main.go:195).
    runs = molly.get_output()
    by_iter = {r.iteration: r for r in runs}
    for i in iters:
        run = by_iter[i]
        if red.corrections:
            run.recommendation = [REC_FAULT, *red.corrections]
        elif failed_iters and good_iter is None:
            # Failures but no good run to synthesize corrections from.
            run.recommendation = [REC_CANT_HELP]
        elif red.extensions:
            run.recommendation = [REC_EXTEND, *red.extensions]
        elif not red.all_achieved:
            run.recommendation = [REC_CANT_HELP]
        else:
            run.recommendation = [REC_WELL_DONE]
        run.inter_proto = red.inter
        run.union_proto = red.union
    for f in failed_iters:
        run = by_iter[f]
        run.corrections = red.corrections
        run.missing_events = red.missing.get(f, [])
        run.inter_proto_missing = red.inter_miss.get(f, [])
        run.union_proto_missing = red.union_miss.get(f, [])

    # Reporting (main.go:239-292).
    with timer.phase("report"):
        reporter = Reporter()
        reporter.prepare(results_root, this_results_dir)
        # Each run entry carries the chosen good-run iteration, so the
        # frontend points its diff layers at the right run.
        with open(os.path.join(this_results_dir, "debugging.json"), "w", encoding="utf-8") as fh:
            fh.write("[")
            for j, r in enumerate(runs):
                if j:
                    fh.write(", ")
                fh.write(_run_json_str(r, good_iter))
            fh.write("]")
        with open(os.path.join(this_results_dir, "repairs.json"), "w", encoding="utf-8") as fh:
            json.dump(red.repairs, fh, indent=1)
        # The runs that failed to parse: the frontend's "Degraded runs".
        if molly.quarantined:
            with open(os.path.join(this_results_dir, "quarantine.json"), "w", encoding="utf-8") as fh:
                json.dump(sorted(molly.quarantined, key=lambda r: r["position"]), fh, indent=1)
        _generate_map_figures(reporter, fig_iters, mo)
        fig_stats = reporter.scheduler.drain()

    timings = timer.as_dict()
    _write_telemetry(this_results_dir, timings, fig_stats)
    return DebugResult(molly=molly, report_dir=this_results_dir, timings=timings, figure_stats=fig_stats)


def _generate_map_figures(reporter: Reporter, fig_iters: list[int], mo: delta.MapOutput) -> None:
    """Write the map's figure families through ``reporter``, family by
    family in the reference's order."""
    own_fig = [i for i in fig_iters if i in mo.hazard]

    def dots(d: dict) -> list:
        return [d[i] for i in own_fig]

    reporter.generate_figures(own_fig, "spacetime", dots(mo.hazard))
    reporter.generate_figures(own_fig, "pre_prov", dots(mo.pre))
    reporter.generate_figures(own_fig, "post_prov", dots(mo.post))
    reporter.generate_figures(own_fig, "pre_prov_clean", dots(mo.pre_clean))
    reporter.generate_figures(own_fig, "post_prov_clean", dots(mo.post_clean))
    diff_fig_iters = [f for f in fig_iters if f in mo.diff]
    reporter.generate_figures(
        diff_fig_iters, "diff_post_prov-diff", [mo.diff[f] for f in diff_fig_iters]
    )
    reporter.generate_figures(
        diff_fig_iters,
        "diff_post_prov-failed",
        [mo.diff_failed[f] for f in diff_fig_iters],
    )
