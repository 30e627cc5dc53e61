"""End-to-end debugging pipeline: one corpus in, one report tree out.

A copy of the JAX package's ``analysis/pipeline.py`` trimmed to what
``run_debug`` needs on one corpus: packed-first native ingest, the corpus
store and the two-tier result cache, without streaming, checkpoints or
several corpora at once.  The stage order mirrors the reference's main()
(main.go:106-292): ingest -> init backend -> load raw provenance ->
simplify -> hazard analysis -> prototypes -> pull provenance DOTs ->
differential provenance -> corrections (only when failures exist) ->
extensions -> repair synthesis -> recommendation assembly -> report
(debugging.json, repairs.json, 7 figure families, the HTML/JS frontend).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
from dataclasses import dataclass, field

import torch

from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.backend.base import GraphBackend
from nemo_tpu_torch.ingest.molly import MollyOutput, load_molly_output
from nemo_tpu_torch.report.writer import Reporter
from nemo_tpu_torch.utils.env import quarantine_enabled
from nemo_tpu_torch.utils.timing import PhaseTimer

_log = logging.getLogger("nemo_tpu_torch.pipeline")

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
    #: RenderScheduler.stats() of the report's figures (None on a
    #: whole-report cache hit: nothing was rendered)
    figure_stats: dict | None
    #: which ingest served the corpus: native, python, store_hit,
    #: store_grown or python_quarantine_fallback
    ingest: str = ""
    #: the result cache's part: "off", "report_hit" or "computed", and the
    #: segments and runs served from cached partials or mapped
    result_cache: dict = field(default_factory=dict)


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


def _write_telemetry(report_dir: str, timings: dict, figure_stats: dict | None, ingest: str,
                     result_cache: dict) -> None:
    """telemetry.json next to debugging.json: the phase walls, the figure
    pipeline's stats (the frontend's "Run telemetry" section), which ingest
    served the corpus and what the result cache did."""
    doc = {
        "timings": {k: round(v, 6) for k, v in timings.items()},
        "figure_stats": figure_stats,
        "ingest": ingest,
        "result_cache": result_cache,
    }
    with open(os.path.join(report_dir, "telemetry.json"), "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)


def _prov_json_str(prov) -> str:
    """A RawProv splices its parse-time bytes; a ProvData encodes."""
    if hasattr(prov, "json_str"):
        return prov.json_str()
    return json.dumps(prov.to_json())


def _run_json_str(run, good_iter: int | None) -> str:
    """One debugging.json run entry: json.dumps({**run.to_json(),
    "goodRunIteration": good_iter}) with the same key order and omitempty
    policy (datatypes.py:RunData.to_json), splicing a packed-first run's
    head fragment and provenance strings as they are."""
    head = getattr(run, "head_json", None)
    if head is not None:
        # The five metadata pairs, serialized by the C++ engine at parse
        # time (nemo_native.cpp:build_run_head) or read from the store.
        pairs: list[tuple[str, str]] = [("", head.decode())]
    else:
        pairs = [
            ("iteration", json.dumps(run.iteration)),
            ("status", json.dumps(run.status)),
            ("failureSpec", json.dumps(run.failure_spec.to_json() if run.failure_spec else None)),
            ("model", json.dumps(run.model.to_json() if run.model else None)),
            ("messages", json.dumps([m.to_json() for m in run.messages])),
        ]
    if run.pre_prov is not None:
        pairs.append(("preProv", _prov_json_str(run.pre_prov)))
    if run.time_pre_holds:
        pairs.append(("timePreHolds", json.dumps(run.time_pre_holds)))
    if run.post_prov is not None:
        pairs.append(("postProv", _prov_json_str(run.post_prov)))
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
    # An empty key marks a pre-rendered multi-pair fragment (the head).
    return "{" + ", ".join(v if not k else f'"{k}": {v}' for k, v in pairs) + "}"


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


INGEST_MODES = ("auto", "native", "python")


def _resolve_ingest_mode(backend: GraphBackend, ingest: str) -> bool:
    """ingest mode -> packed-first?  ``auto`` is native on a backend that
    consumes packed arrays (TorchBackend), else python.  The packed modes
    build and load the C++ engine here, so a build or load failure raises
    before any work, whether or not the store would have served."""
    if ingest not in INGEST_MODES:
        raise ValueError(f"unknown ingest mode {ingest!r} (expected one of {INGEST_MODES})")
    packed = getattr(backend, "supports_packed_ingest", False)
    if ingest == "python" or (ingest == "auto" and not packed):
        return False
    if not packed:
        raise ValueError(f"ingest='native' needs a packed-ingest backend; {type(backend).__name__} reads objects")
    from nemo_tpu_torch.ingest.native import NATIVE

    NATIVE.load()
    return True


def _ingest(fault_inj_out: str, use_packed: bool, store) -> tuple[MollyOutput, str, dict | None]:
    """One Molly directory -> (MollyOutput, which ingest served it, the
    pre-parse source snapshot when the corpus was parsed with the store on,
    for ``_populate``; else None).

    Packed-first, the corpus store is consulted first: a warm hit maps the
    stored arrays and strings (appending a grown directory's new runs
    first).  A miss parses with the C++ engine.  When the engine rejects
    the corpus (it parses in one pass and stops at the first malformed
    run), the Python loader re-parses it with per-run quarantine, logged
    and recorded as ``python_quarantine_fallback`` (``NEMO_QUARANTINE=off``
    raises instead).  The python mode reads objects and never touches the
    store."""
    if not use_packed:
        return load_molly_output(fault_inj_out, quarantine=quarantine_enabled()), "python", None
    from nemo_tpu_torch.ingest.native import load_molly_output_packed

    if store is not None:
        molly = store.load_packed(fault_inj_out)
        if molly is not None:
            return molly, f"store_{molly.store_state}", None
    # Snapshot before parsing: a file changed during the parse must
    # mismatch the fingerprint the populate stores.
    snap = store.snapshot(fault_inj_out) if store is not None else None
    try:
        molly, kind = load_molly_output_packed(fault_inj_out), "native"
    except Exception as ex:
        if not quarantine_enabled():
            raise
        _log.warning(
            "native ingest of %s failed (%s: %s); re-parsing with the quarantining Python loader",
            fault_inj_out, type(ex).__name__, ex,
        )
        molly, kind = load_molly_output(fault_inj_out, quarantine=True), "python_quarantine_fallback"
    return molly, kind, snap


def _populate(store, fault_inj_out: str, molly: MollyOutput, snap: dict) -> None:
    """Store a freshly parsed corpus and stamp it with the segment
    identities, so the cold run's results are content-addressed too and the
    next request can be a whole-report hit."""
    from nemo_tpu_torch.store import attach_store_provenance

    header = store.put(fault_inj_out, molly, snapshot=snap)
    if isinstance(header, dict):
        sd = store.store_dir(fault_inj_out)
        attach_store_provenance(molly, sd, header)
        nc = getattr(molly, "native_corpus", None)
        if nc is not None:
            attach_store_provenance(nc, sd, header)


def run_debug(
    fault_inj_out: str,
    results_root: str,
    backend: GraphBackend | None = None,
    figures: str = "all",
    report_name: str | None = None,
    ingest: str = "auto",
    corpus_cache: str | None = None,
    result_cache: str | None = None,
) -> DebugResult:
    """The full debug pipeline over one Molly directory; writes
    ``results_root/<report_name or corpus name>/``.  ``backend`` defaults to
    a TorchBackend on cuda, which raises without a card.  ``figures`` is
    the figure policy (select_figure_iters).  ``ingest`` picks the loader
    (``_resolve_ingest_mode``).  ``corpus_cache`` and ``result_cache`` are
    the roots of the corpus store and the result cache (``off`` disables;
    default ``NEMO_CORPUS_CACHE``/``NEMO_RESULT_CACHE``, else
    ``~/.cache/nemo_tpu_torch/{corpus,results}``).

    With a store-served corpus and the result cache on, a repeated request
    restores the whole report tree without initializing the backend (no
    kernel launch), and a grown corpus maps only the segments no cached
    partial serves, then reduces cached and fresh partials together.  On
    the card every phase ends with ``torch.cuda.synchronize``, so the phase
    walls cover the device work."""
    from nemo_tpu_torch.store import resolve_store
    from nemo_tpu_torch.store.rcache import resolve_result_cache

    if backend is None:
        from nemo_tpu_torch.backend.torch_backend import TorchBackend

        backend = TorchBackend()
    dev = getattr(getattr(backend, "executor", None), "device", None)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev is not None and dev.type == "cuda" else None
    timer = PhaseTimer(sync=sync)
    use_packed = _resolve_ingest_mode(backend, ingest)
    store = resolve_store(corpus_cache)

    with timer.phase("ingest"):
        molly, ingest_kind, snap = _ingest(fault_inj_out, use_packed, store)
    if snap is not None:
        with timer.phase("store_populate"):
            _populate(store, fault_inj_out, molly, snap)
    iters = molly.get_runs_iters()
    failed_iters = molly.get_failed_runs_iters()
    this_results_dir = os.path.join(results_root, report_name or molly.run_name)
    rcache = resolve_result_cache(result_cache)
    cache_doc: dict = {"state": "off"}

    # Tier 1: the whole report tree, addressed by every segment fingerprint
    # and the config blob.  A hit restores it and returns before the
    # backend is initialized.
    report_key = delta.report_cache_key(molly, figures) if rcache is not None else None
    if report_key is not None:
        with timer.phase("report"):
            hit = rcache.load_report(report_key, results_root, this_results_dir)
        if hit:
            timings = timer.as_dict()
            cache_doc = {"state": "report_hit"}
            _write_telemetry(this_results_dir, timings, None, ingest_kind, cache_doc)
            return DebugResult(molly=molly, report_dir=this_results_dir, timings=timings, figure_stats=None,
                               ingest=ingest_kind, result_cache=cache_doc)

    # The baseline good run (delta.choose_good_run): on an all-failed corpus
    # diff and corrections are skipped instead of raising.  The restrictive
    # figure policies include it even on an all-success corpus.
    good_iter = delta.choose_good_run(molly)
    baseline_iter = delta.choose_baseline_run(molly, good_iter)
    fig_iters = select_figure_iters(figures, iters, failed_iters, good_iter)
    fig_set = set(fig_iters)

    # Tier 2: a cached partial per store segment; only the segments none
    # serves are mapped, in one group, then cached and fresh partials
    # reduce together.  A cached partial's figure files are staged at
    # lookup (one that cannot be staged whole is a miss), and the staging
    # directory becomes the report's figures/.
    segments = delta.attach_positions(delta.corpus_segments(molly), molly)
    cached: list[tuple[delta.Segment, delta.SegmentPartial]] = []
    partial_keys: dict[str, str] = {}
    stage_dir = f"{this_results_dir}.stage-{uuid.uuid4().hex[:8]}"
    try:
        if rcache is not None:
            with timer.phase("cache_lookup"):
                for seg in segments:
                    k = delta.partial_cache_key(seg, segments, good_iter, baseline_iter, figures)
                    if k is None:
                        continue
                    partial_keys[seg.name] = k
                    p = rcache.load_partial(k, stage_dir)
                    if p is not None:
                        cached.append((seg, p))
        cached_names = {seg.name for seg, _ in cached}
        to_map = [s for s in segments if s.name not in cached_names]
        n_cached_runs = sum(s.n_runs for s, _ in cached)
        if rcache is not None:
            cache_doc = {
                "state": "computed",
                "segments_cached": len(cached),
                "segments_mapped": len(to_map),
                "runs_cached": n_cached_runs,
                "runs_mapped": len(molly.runs) - n_cached_runs,
            }
            if cached:
                _log.info("delta plan for %s: %s", fault_inj_out, cache_doc)

        mo = delta.MapOutput()
        if to_map:
            own_rows = sorted(r for s in to_map for r in range(s.start, s.stop))
            own_set = {molly.runs[r].iteration for r in own_rows}
            # The anchor runs ride along as context when a cached segment holds
            # them: the diff is against the good run's graph, the extensions
            # read the baseline run's antecedent.
            pos_of = segments[0]._pos_by_iter
            view_rows = sorted(
                set(own_rows) | {pos_of[it] for it in (good_iter, baseline_iter) if it is not None}
            )
            view = molly if len(view_rows) == len(molly.runs) else delta.subset_molly(molly, view_rows)
            with timer.phase("init"):
                backend.init_graph_db("", view)
            try:
                mo = delta.map_runs(
                    backend, view, fault_inj_out, good_iter, fig_set, timer, own_set=own_set,
                    publish=bool(partial_keys),
                )
            finally:
                backend.close_db()

        with timer.phase("reduce"):
            fresh = {s.name: mo.as_partial([r.iteration for r in molly.runs[s.start : s.stop]]) for s in to_map}
            red = delta.reduce_partials([p for _, p in cached] + list(fresh.values()), molly, good_iter)

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
            # frontend points its diff layers at the right run.  Written entry
            # by entry: packed-first runs splice their strings as they are.
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
            # Cached segments' figures come in with their staging directory
            # (same renderer version, part of the key), then mapped runs
            # render into it.  A name both would write (an iteration in two
            # segments) is rendered, never written through a cached file.
            if cached:
                staged = {f for _, p in cached for f in p.fig_files}
                for name in staged & {f for p in fresh.values() for f in p.fig_files}:
                    os.remove(os.path.join(stage_dir, name))
                os.makedirs(stage_dir, exist_ok=True)
                os.rmdir(reporter.figures_dir)
                os.rename(stage_dir, reporter.figures_dir)
            _generate_map_figures(reporter, fig_iters, mo)
            fig_stats = reporter.scheduler.drain()

        if rcache is not None:
            # Published with every figure on disk (telemetry.json, written
            # after, is never cached).  The report entry names the published
            # partials instead of holding their figure files again.
            with timer.phase("cache_publish"):
                figures_dir = os.path.join(this_results_dir, "figures")
                published = {partial_keys[seg.name]: p.fig_files for seg, p in cached}
                for name, p in fresh.items():
                    if name in partial_keys and rcache.put_partial(partial_keys[name], p, figures_dir):
                        published[partial_keys[name]] = p.fig_files
                if report_key is not None:
                    rcache.put_report(report_key, this_results_dir, NONDETERMINISTIC_REPORT_FILES, published)
        timings = timer.as_dict()
        _write_telemetry(this_results_dir, timings, fig_stats, ingest_kind, cache_doc)
        return DebugResult(molly=molly, report_dir=this_results_dir, timings=timings, figure_stats=fig_stats,
                           ingest=ingest_kind, result_cache=cache_doc)
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)


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
