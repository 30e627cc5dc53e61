"""End-to-end debugging pipeline: one corpus in, one report tree out.

A copy of the JAX package's ``analysis/pipeline.py``: ``run_debug`` on one
corpus (ingest through the fault-injector seam of ingest/adapters.py,
packed-first native ingest of Molly corpora, the corpus store, the two-tier
result cache, the segment-streamed map and per-segment checkpoints,
``--save-corpus``) and ``run_debug_dirs`` over several, each corpus parsed
while the one before it is analysed.  The stage order mirrors the reference's main()
(main.go:106-292): ingest -> init backend -> load raw provenance ->
simplify -> hazard analysis -> prototypes -> pull provenance DOTs ->
differential provenance -> corrections (only when failures exist) ->
extensions -> repair synthesis -> recommendation assembly -> report
(debugging.json, repairs.json, 7 figure families, the HTML/JS frontend).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import time
import uuid
from dataclasses import dataclass, field

import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.backend.base import GraphBackend
from nemo_tpu_torch.device import stream_sync
from nemo_tpu_torch.ingest import adapters
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.report.writer import Reporter
from nemo_tpu_torch.utils import chaos
from nemo_tpu_torch.utils.env import quarantine_enabled
from nemo_tpu_torch.utils.timing import PhaseTimer

_log = obs.log.get_logger("nemo.pipeline")

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
    #: which ingest served the corpus: native, python (the injector's
    #: object loader), store_hit, store_grown or python_quarantine_fallback
    ingest: str = ""
    #: the result cache's part: "off", "report_hit" or "computed", and the
    #: segments and runs served from cached partials or mapped
    result_cache: dict = field(default_factory=dict)
    #: a map of several segments: whether it streamed, the segments mapped,
    #: the bytes staged on the card ahead of their dispatches, the staging
    #: seconds, the process's peak RSS after the last segment and the
    #: checkpoints published; empty for a map of one group
    stream: dict = field(default_factory=dict)


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


def oracle_tree_diff(oracle: dict[str, bytes], tree: dict[str, bytes]) -> list[str]:
    """The files in which a report tree (``report_tree_bytes``) departs from
    the oracle's (backend/python_ref.py) tree of the same corpus: a file in
    one tree only, a file of other bytes, or a simplified graph's figure
    ``*_prov_clean.dot`` whose statements differ as a multiset.  Those hold
    the same statements in another order (the oracle adds a collapsed
    @next chain's rule after the graph's nodes, TorchBackend where the
    chain's head rule was, as the JAX package's oracle and JaxBackend do),
    so their ``.svg``, laid out from that order, are not compared."""
    bad = sorted(set(oracle) ^ set(tree))
    for name in sorted(set(oracle) & set(tree)):
        if name.endswith("_prov_clean.svg"):
            continue
        if name.endswith("_prov_clean.dot"):
            if sorted(oracle[name].splitlines()) != sorted(tree[name].splitlines()):
                bad.append(name)
        elif oracle[name] != tree[name]:
            bad.append(name)
    return bad


def _engine_stats(molly: MollyOutput) -> dict | None:
    """The C++ engine's counters of the corpus it parsed (read_s, parse_s,
    read_thread_s, workers, files, bytes), or None where no engine parsed
    it."""
    return getattr(getattr(molly, "native_corpus", None), "engine_stats", None)


def _write_telemetry(report_dir: str, timings: dict, figure_stats: dict | None, ingest: str,
                     result_cache: dict, stream: dict | None = None, backend: GraphBackend | None = None,
                     ingest_engine: dict | None = None) -> None:
    """telemetry.json next to debugging.json: the phase walls, the figure
    pipeline's stats (the frontend's "Run telemetry" section), which ingest
    served the corpus, what the result cache did and, for a map of several
    segments, the stream's and the checkpoints' record; where the C++
    engine parsed the corpus, its counters (``ingest_engine``: sums over
    the files, so not phases of ``timings``); then, as the JAX
    package writes them, the process's metrics snapshot, the trace id of
    the active trace (None when untraced), once the backend module is
    loaded in this process, its per-signature kernel cost table and the
    memory watermarks sampled now, once the scheduler module is loaded,
    the decision table of ``backend``'s device (``sched``: one record per
    job the scheduler ran in this process, newest last; absent when it ran
    none, as under the default ``NEMO_SCHED=off``) and, once the platform
    profile module is, which routing constants ``backend``'s device and
    explicit knobs resolve to and where each came from (arg > measured >
    seeded, platform/profile.py:telemetry_section; also on a report-cache
    hit, where the backend was never initialized)."""
    doc = {
        "timings": {k: round(v, 6) for k, v in timings.items()},
        "figure_stats": figure_stats,
        "ingest": ingest,
        "result_cache": result_cache,
    }
    if stream:
        doc["stream"] = stream
    if ingest_engine:
        doc["ingest_engine"] = {k: round(v, 6) if isinstance(v, float) else v for k, v in ingest_engine.items()}
    doc["metrics"] = obs.metrics.snapshot()
    doc["trace_id"] = obs.trace_id()
    tb = sys.modules.get("nemo_tpu_torch.backend.torch_backend")
    if tb is not None:
        costs = tb.kernel_cost_snapshot()
        if costs:
            doc["kernel_cost"] = costs
        doc["memory"] = tb.sample_memory_watermarks()
    dev = getattr(getattr(backend, "executor", None), "device", None)
    sch = sys.modules.get("nemo_tpu_torch.parallel.sched")
    if sch is not None and dev is not None:
        table = sch.sched_snapshot(dev)
        if table:
            doc["sched"] = table
    pp = sys.modules.get("nemo_tpu_torch.platform.profile")
    if pp is not None and dev is not None:
        doc["platform_profile"] = pp.telemetry_section(dev, backend.profile_args())
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


def _resolve_ingest_mode(backend: GraphBackend, ingest: str, save_corpus_path: str | None = None) -> bool:
    """ingest mode -> packed-first?  ``auto`` is native on a backend that
    consumes packed arrays (TorchBackend), else python; ``save_corpus_path``
    pins the object loader (graphs/corpus.py packs the provenance objects).
    The packed modes build and load the C++ engine here, so a build or load
    failure raises before any work, whether or not the store would have
    served."""
    if ingest not in INGEST_MODES:
        raise ValueError(f"unknown ingest mode {ingest!r} (expected one of {INGEST_MODES})")
    packed = getattr(backend, "supports_packed_ingest", False)
    if ingest == "native" and save_corpus_path:
        raise ValueError("ingest='native' is incompatible with --save-corpus (the corpus file is packed from the "
                         "provenance objects of the Python loader)")
    if ingest == "python" or (ingest == "auto" and (not packed or save_corpus_path)):
        return False
    if not packed:
        raise ValueError(f"ingest='native' needs a packed-ingest backend; {type(backend).__name__} reads objects")
    from nemo_tpu_torch.ingest.native import NATIVE

    NATIVE.load()
    return True


def _ingest(fault_inj_out: str, use_packed: bool, store, injector: str | None = None, timer=None
            ) -> tuple[MollyOutput, str, dict | None]:
    """One corpus directory -> (MollyOutput, which ingest served it, the
    pre-parse source snapshot when the corpus was parsed with the store on,
    for ``_populate``; else None).  ``injector`` names the fault-injector
    layout (ingest/adapters.py: molly, trace-json; None or auto sniffs,
    ``NEMO_INJECTOR`` first).

    Packed-first, the corpus store is consulted first: a warm hit maps the
    stored arrays and strings (appending a grown directory's new runs
    first).  A miss parses a Molly corpus with the C++ engine; any other
    layout goes through its injector's object loader, packed by the store's
    populate and by the backend.  When the engine rejects the corpus (it
    parses in one pass and stops at the first malformed run), the
    injector's loader re-parses it with per-run quarantine, logged and
    recorded as ``python_quarantine_fallback`` (``NEMO_QUARANTINE=off``
    raises instead).  The python mode reads objects and never touches the
    store.  ``timer`` (the report's PhaseTimer) gets the engine's phases
    (ingest/native.py:load_molly_output_packed)."""
    if not use_packed:
        return adapters.load_output(fault_inj_out, injector), "python", None
    from nemo_tpu_torch.ingest.native import load_molly_output_packed

    if store is not None:
        molly = store.load_packed(fault_inj_out)
        if molly is not None:
            return molly, f"store_{molly.store_state}", None
    inj = adapters.resolve_injector(fault_inj_out, injector)
    # Snapshot before parsing: a file changed during the parse must
    # mismatch the fingerprint the populate stores.
    snap = store.snapshot(fault_inj_out) if store is not None else None
    if not inj.native_capable:
        return inj.load(fault_inj_out), "python", snap
    try:
        molly, kind = load_molly_output_packed(fault_inj_out, timer), "native"
    except Exception as ex:
        if not quarantine_enabled():
            raise
        _log.warning(
            "ingest.native_failed_quarantine_fallback",
            corpus=fault_inj_out,
            error=f"{type(ex).__name__}: {ex}",
            detail="re-parsing with the quarantining Python loader (NEMO_QUARANTINE=off restores fail-fast)",
        )
        obs.metrics.inc("ingest.native_fallback")
        molly, kind = inj.load(fault_inj_out, quarantine=True), "python_quarantine_fallback"
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


def _attach_ingest_dir(ex: BaseException, d: str) -> BaseException:
    """Name the corpus directory in an ingest exception, in place, keeping
    its type: the first string argument gains the suffix (an OSError its
    strerror, which is what str() shows); an exception without a string
    argument gains one."""
    note = f"(while ingesting {d})"
    if isinstance(ex, OSError) and isinstance(getattr(ex, "strerror", None), str):
        if note not in ex.strerror:
            ex.strerror = f"{ex.strerror} {note}"
        return ex
    args = list(ex.args)
    for i, a in enumerate(args):
        if isinstance(a, str):
            if note not in a:
                args[i] = f"{a} {note}"
            break
    else:
        args.append(note)
    ex.args = tuple(args)
    return ex


def corpus_report_names(dirs: list[str]) -> list[str]:
    """Report directory names for several corpora under one results root:
    the directory's basename where it is unique among ``dirs``, else
    basename-<first 8 hex of the sha256 of its realpath>, stable across
    runs.  Raises when two entries are the same directory: both reports
    would write one tree."""
    import hashlib

    basenames = [os.path.basename(os.path.normpath(d)) for d in dirs]
    dupes = {b for b in basenames if basenames.count(b) > 1}
    names = [
        f"{b}-{hashlib.sha256(os.path.realpath(d).encode()).hexdigest()[:8]}" if b in dupes else b
        for d, b in zip(dirs, basenames)
    ]
    clashes = {n for n in names if names.count(n) > 1}
    if clashes:
        raise ValueError(
            f"corpus directories resolve to the same report name(s) {sorted(clashes)}: the same directory was "
            "listed more than once; each -faultInjOut must name a distinct corpus"
        )
    return names


def run_debug_dirs(dirs: list[str], results_root: str, make_backend=None, prefetch: bool = False,
                   **kwargs) -> list[DebugResult]:
    """run_debug over several corpus directories; with ``prefetch``, corpus
    k+1's ingest runs on a worker thread while corpus k is analysed and
    reported (the C++ engine's parse runs in a ctypes call that releases
    the GIL).  The JAX package prefetches by default; the port does not,
    because on an H100 host the six families took longer with the thread
    than without it (PERF.md).  One
    RenderScheduler serves every report and is drained once at the end
    (its wall is ``figure_stats["drain_wall_s"]``, the aggregate stats
    every result's ``figure_stats``); each report's result-cache publish
    waits for that drain, and its telemetry.json is written again after it,
    with ``ingest_prefetch``: the wall of a prefetched corpus's parse on the
    worker thread (its ``ingest`` phase, on the critical path, is ~0).

    ``make_backend()`` makes one backend per directory (default a
    TorchBackend on cuda); kwargs go to run_debug, except
    ``save_corpus_path``, which every corpus would overwrite and so
    raises.  Reports go to results_root/<corpus_report_names>.  Without
    prefetch, or on a one-core host, every ingest runs inline: the
    sequential loop."""
    import threading

    from nemo_tpu_torch.report.render import RenderScheduler
    from nemo_tpu_torch.store import resolve_store
    from nemo_tpu_torch.utils import effective_cpu_count

    if make_backend is None:
        from nemo_tpu_torch.backend.torch_backend import TorchBackend

        make_backend = TorchBackend
    if kwargs.get("save_corpus_path"):
        raise ValueError("save_corpus_path is not supported by run_debug_dirs: every corpus would overwrite the "
                         "same file; call run_debug per directory with distinct paths instead")
    report_names = corpus_report_names(dirs)
    if not dirs:
        return []
    prefetch = prefetch and effective_cpu_count() > 1
    use_packed = _resolve_ingest_mode(make_backend(), kwargs.get("ingest", "auto"))
    store = resolve_store(kwargs.get("corpus_cache"))

    prefetched: list = [None, None]  # (molly, exception) of the next directory

    def prefetch_next(d: str) -> None:
        try:
            t = time.perf_counter()
            # On the prefetch thread's own row of a trace, under the
            # analysing thread's phases.
            with obs.span("ingest:prefetch", dir=os.path.basename(d)):
                molly, kind, snap = _ingest(d, use_packed, store, kwargs.get("injector"))
                if snap is not None:
                    _populate(store, d, molly, snap)
            molly.ingest_kind = kind
            molly.ingest_prefetch_s = time.perf_counter() - t
            prefetched[0] = molly
        except BaseException as ex:  # re-raised on the consuming thread
            prefetched[1] = _attach_ingest_dir(ex, d)

    results: list[DebugResult] = []
    backends: list = []  # each report's, for its telemetry after the drain
    scheduler = RenderScheduler()
    th: threading.Thread | None = None
    molly = None
    try:
        for k, d in enumerate(dirs):
            if th is not None:
                th.join()
                th = None
                if prefetched[1] is not None:
                    raise prefetched[1]
                molly, prefetched[0] = prefetched[0], None
            if prefetch and k + 1 < len(dirs):
                th = threading.Thread(target=prefetch_next, args=(dirs[k + 1],), daemon=True,
                                      name="nemo-ingest-prefetch")
                th.start()
            backends.append(make_backend())
            results.append(run_debug(d, results_root, backends[-1], molly=molly, render_scheduler=scheduler,
                                     report_name=report_names[k], **kwargs))
            if molly is not None:
                # The parse's wall on the worker thread, off the critical path.
                results[-1].timings["ingest_prefetch"] = molly.ingest_prefetch_s
            molly = None
        t0 = time.perf_counter()
        stats = scheduler.drain()
        stats["drain_wall_s"] = round(time.perf_counter() - t0, 3)
    except BaseException:
        # The reports already written keep their figures; the error that
        # stopped the loop is the one raised.
        if th is not None:
            th.join()
        scheduler.drain()
        raise
    scheduler.close()
    for r, backend in zip(results, backends):
        r.figure_stats = stats
        _flush_result_cache(r)
        _write_telemetry(r.report_dir, r.timings, stats, r.ingest, r.result_cache, r.stream, backend,
                         _engine_stats(r.molly))
    return results


def run_debug(
    fault_inj_out: str,
    results_root: str,
    backend: GraphBackend | None = None,
    conn: str = "",
    figures: str = "all",
    report_name: str | None = None,
    ingest: str = "auto",
    corpus_cache: str | None = None,
    result_cache: str | None = None,
    molly: MollyOutput | None = None,
    render_scheduler=None,
    injector: str | None = None,
    save_corpus_path: str | None = None,
    profile_dir: str | None = None,
) -> DebugResult:
    """The full debug pipeline over one Molly directory; writes
    ``results_root/<report_name or corpus name>/``.  ``backend`` defaults to
    a TorchBackend on cuda, which raises without a card; ``conn`` is what
    its ``init_graph_db`` is given (Neo4jBackend's bolt:// URI; the other
    backends ignore it).  ``figures`` is
    the figure policy (select_figure_iters).  ``ingest`` picks the loader
    (``_resolve_ingest_mode``).  ``corpus_cache`` and ``result_cache`` are
    the roots of the corpus store and the result cache (``off`` disables;
    default ``NEMO_CORPUS_CACHE``/``NEMO_RESULT_CACHE``, else
    ``~/.cache/nemo_tpu_torch/{corpus,results}``).  ``injector`` names the
    corpus layout (ingest/adapters.py; default: sniffed).
    ``save_corpus_path``: write the packed corpus there as one ``.npz``
    (graphs/corpus.py) after the ingest, which it pins to the object
    loader.  ``molly``: the corpus
    already ingested (run_debug_dirs parses it ahead; its ``ingest_kind``
    says by what), so the ``ingest`` phase is ~0.  ``render_scheduler``: a
    RenderScheduler shared with other reports, which its owner drains; the
    SVGs land then, and the result-cache publish waits for
    ``_flush_result_cache``.

    A killed run leaves its staging directory ``<report>.stage-<hex>``
    beside the report; each run sweeps those of its report that are older
    than the corpus store's wreckage age (``_sweep_stage_leftovers``).

    A backend without the per-run hooks (``supports_delta`` False:
    Neo4jBackend) maps the whole corpus once with the global verbs and
    reduces it as it is, with no partial cache; one without
    ``supports_synth`` writes no repairs.json.

    With a store-served corpus and the result cache on, a repeated request
    restores the whole report tree without initializing the backend (no
    kernel launch), and a grown corpus maps only the segments no cached
    partial serves, then reduces cached and fresh partials together.
    Several segments to map are mapped one at a time where ``NEMO_STREAM``
    asks for it (streamed behind a prefetch, analysis/stream.py) or the
    result cache is on; then each segment's partial is published as a checkpoint as soon as
    it is mapped (``NEMO_CHECKPOINT``, default on), so a crash loses only
    the segment in flight.  On the card every phase ends by synchronizing
    the current stream, so the phase walls cover the device work.

    With ``profile_dir`` the map (where every kernel launches) runs under
    ``torch.profiler.profile`` (CPU activity, and CUDA activity on the
    card), exported as a Chrome trace into that directory
    (``tensorboard_trace_handler``: ``<host>_<pid>.<ts>.pt.trace.json``);
    the program's own spans label it: each phase ``phase:<name>`` and each
    kernel dispatch ``kernel:<verb>`` (obs/trace.py:profiler_label).  A
    profiled run never consults the result cache: the point of a profile
    is watching the kernels run."""
    from nemo_tpu_torch.analysis import stream as stream_mod
    from nemo_tpu_torch.store import resolve_store
    from nemo_tpu_torch.store.rcache import resolve_result_cache
    from nemo_tpu_torch.utils.env import env_flag

    if backend is None:
        from nemo_tpu_torch.backend.torch_backend import TorchBackend

        backend = TorchBackend()
    dev = getattr(getattr(backend, "executor", None), "device", None)
    timer = PhaseTimer(sync=stream_sync(dev))
    use_packed = _resolve_ingest_mode(backend, ingest, save_corpus_path)
    store = resolve_store(corpus_cache)

    snap = None
    with timer.phase("ingest"):
        if molly is None:
            molly, ingest_kind, snap = _ingest(fault_inj_out, use_packed, store, injector, timer)
        else:
            ingest_kind = getattr(molly, "ingest_kind", "prefetched")
    if snap is not None:
        with timer.phase("store_populate"):
            _populate(store, fault_inj_out, molly, snap)
    if save_corpus_path:
        from nemo_tpu_torch.graphs.corpus import pack_corpus, save_corpus

        with timer.phase("save_corpus"):
            save_corpus(pack_corpus(molly), save_corpus_path)
    iters = molly.get_runs_iters()
    failed_iters = molly.get_failed_runs_iters()
    this_results_dir = os.path.join(results_root, report_name or molly.run_name)
    _sweep_stage_leftovers(this_results_dir)
    rcache = None if profile_dir else resolve_result_cache(result_cache)
    if rcache is not None and hasattr(backend, "require_spmd_routes"):
        # Before the first lookup: in a world whose ranks meet in
        # collectives, a hit on one rank alone would strand the others.
        backend.require_spmd_routes(result_cache=True)
    profiler = _profiler(profile_dir, dev)
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
            _write_telemetry(this_results_dir, timings, None, ingest_kind, cache_doc, backend=backend,
                             ingest_engine=_engine_stats(molly))
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
    # serves are mapped, then cached and fresh partials reduce together.  A
    # cached partial's figure files are staged at lookup (one that cannot
    # be staged whole is a miss), and the staging directory becomes the
    # report's figures/.
    legacy = not getattr(backend, "supports_delta", False)
    segments = delta.attach_positions(delta.corpus_segments(molly), molly)
    cached: list[tuple[delta.Segment, delta.SegmentPartial]] = []
    partial_keys: dict[str, str] = {}
    stage_dir = f"{this_results_dir}.stage-{uuid.uuid4().hex[:8]}"
    try:
        if rcache is not None and not legacy:
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
        obs.metrics.inc("delta.segments_cached", len(cached))
        obs.metrics.inc("delta.segments_mapped", len(to_map))
        obs.metrics.inc("delta.runs_cached", n_cached_runs)
        obs.metrics.inc("delta.runs_mapped", len(molly.runs) - n_cached_runs)
        if cached:
            _log.info("delta.plan", corpus=fault_inj_out, segments_cached=len(cached),
                      segments_mapped=len(to_map), runs_cached=n_cached_runs,
                      runs_mapped=len(molly.runs) - n_cached_runs)

        def seg_iters(seg: delta.Segment) -> list[int]:
            return [r.iteration for r in molly.runs[seg.start : seg.stop]]

        # mo: what the report phase renders (and, for a map of one group,
        # every artifact).  Each segment mapped alone leaves its partial:
        # those whose figures were rendered into the staging directory with
        # their checkpoint (on_disk), and the others (to_render).
        mo = delta.MapOutput()
        on_disk: dict[str, delta.SegmentPartial] = {}
        to_render: dict[str, delta.SegmentPartial] = {}
        published: set[str] = set()
        stream_doc: dict = {}
        reducer = None
        if to_map:
            streamed = stream_mod.use_streaming(molly, backend, to_map, legacy=legacy)
            incremental = (len(to_map) > 1 and bool(partial_keys) and rcache is not None
                           and env_flag("NEMO_CHECKPOINT", True))
            map_groups = [[s] for s in to_map] if (incremental or streamed) else [to_map]
            # A streamed segment's anchor verbs run ungated even with nothing
            # to cache, so every partial carries the same anchor content and
            # the tree merge does not depend on the order.
            publish = streamed or bool(partial_keys)
            if len(map_groups) > 1:
                stream_doc = {"streamed": streamed, "segments_mapped": len(map_groups), "staged_bytes": 0,
                              "stage_s": 0.0, "checkpoints": 0}
            pos_by_iter = segments[0]._pos_by_iter

            def build_view(group):
                own_rows = sorted(r for s in group for r in range(s.start, s.stop))
                own_set = {molly.runs[r].iteration for r in own_rows}
                # The anchor runs ride along as context when another segment
                # holds them: the diff is against the good run's graph, the
                # extensions read the baseline run's antecedent.
                view_rows = sorted(
                    set(own_rows) | {pos_by_iter[it] for it in (good_iter, baseline_iter) if it is not None}
                )
                view = molly if len(view_rows) == len(molly.runs) else delta.subset_molly(molly, view_rows)
                return view, own_set

            if streamed:
                reducer = delta.TreeReducer()
                for _seg, p in cached:
                    reducer.push(p)
                group_iter = stream_mod.stream_groups(map_groups, build_view, backend, timer)
            else:
                group_iter = _serial_groups(map_groups, build_view, backend, timer, conn)
            with profiler:
                for staged in group_iter:
                    try:
                        group_mo = delta.map_runs(staged.backend, staged.view, fault_inj_out, good_iter, fig_set, timer,
                                                  own_set=staged.own_set, publish=publish)
                    finally:
                        staged.backend.close_db()
                        staged.release()
                    if stream_doc:
                        stream_doc["staged_bytes"] += staged.staged_bytes
                        stream_doc["stage_s"] += staged.stage_s
                    if len(staged.group) > 1 or legacy:
                        mo.merge(group_mo)
                        continue
                    seg = staged.group[0]
                    partial = group_mo.as_partial(seg_iters(seg))
                    key = partial_keys.get(seg.name)
                    ok = None
                    if incremental and key is not None:
                        with timer.phase("checkpoint"):
                            ok = _publish_segment_checkpoint(rcache, key, partial, group_mo, fig_iters, stage_dir)
                        if ok:
                            published.add(seg.name)
                            obs.metrics.inc("delta.partial_checkpoints")
                            _log.info("delta.checkpoint", corpus=fault_inj_out, segment=seg.name,
                                      published=len(published), remaining=len(to_map) - len(published))
                            # Chaos kill point: SIGKILL after N published
                            # checkpoints (the resume scenario's crash).
                            chaos.on_segment_published(len(published))
                    if ok is not None:
                        on_disk[seg.name] = partial
                    else:
                        to_render[seg.name] = partial
                        mo.merge_figures(group_mo)
                    if reducer is not None:
                        reducer.push(partial)
                    if stream_doc:
                        stream_mod.note_segment_done(stream_doc)
            if stream_doc:
                stream_doc["checkpoints"] = len(published)
                stream_doc["stage_s"] = round(stream_doc["stage_s"], 6)

        with timer.phase("reduce"):
            if legacy:
                red = delta.reduce_legacy(mo, molly, good_iter)
            else:
                if to_map and not on_disk and not to_render:
                    # One group: the map output holds every mapped segment.
                    to_render = {s.name: mo.as_partial(seg_iters(s)) for s in to_map}
                if reducer is not None:
                    partials = reducer.partials()
                else:
                    partials = [p for _, p in cached] + list(on_disk.values()) + list(to_render.values())
                red = delta.reduce_partials(partials, molly, good_iter)

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

        # Reporting (main.go:239-292), in three nested phases: the assets,
        # the JSON documents, the figures.
        fig_stats = None
        with timer.phase("report"):
            reporter = Reporter(scheduler=render_scheduler)
            with timer.phase("report.assets"):
                reporter.prepare(results_root, this_results_dir)
            with timer.phase("report.json"):
                # Each run entry carries the chosen good-run iteration, so the
                # frontend points its diff layers at the right run.  Written
                # entry by entry: packed-first runs splice their strings as
                # they are.
                with open(os.path.join(this_results_dir, "debugging.json"), "w", encoding="utf-8") as fh:
                    fh.write("[")
                    for j, r in enumerate(runs):
                        if j:
                            fh.write(", ")
                        fh.write(_run_json_str(r, good_iter))
                    fh.write("]")
                # The ranked repairs; none from a backend without synthesis hooks.
                if red.repairs is not None:
                    with open(os.path.join(this_results_dir, "repairs.json"), "w", encoding="utf-8") as fh:
                        json.dump(red.repairs, fh, indent=1)
                # The runs that failed to parse: the frontend's "Degraded runs".
                if molly.quarantined:
                    with open(os.path.join(this_results_dir, "quarantine.json"), "w", encoding="utf-8") as fh:
                        json.dump(sorted(molly.quarantined, key=lambda r: r["position"]), fh, indent=1)
            with timer.phase("report.figures"):
                # Cached segments' figures and those rendered with a
                # checkpoint come in with the staging directory (same
                # renderer version, part of the key), then the rest render
                # into it.  A name both would write (an iteration in two
                # segments) is rendered, never written through a staged file.
                staged_parts = [p for _, p in cached] + list(on_disk.values())
                if staged_parts:
                    rendered = {f for p in to_render.values() for f in p.fig_files}
                    for name in {f for p in staged_parts for f in p.fig_files} & rendered:
                        os.remove(os.path.join(stage_dir, name))
                    os.makedirs(stage_dir, exist_ok=True)
                    os.rmdir(reporter.figures_dir)
                    os.rename(stage_dir, reporter.figures_dir)
                _generate_map_figures(reporter, fig_iters, mo)
                if render_scheduler is None:
                    fig_stats = reporter.scheduler.drain()

        timings = timer.as_dict()
        result = DebugResult(molly=molly, report_dir=this_results_dir, timings=timings, figure_stats=fig_stats,
                             ingest=ingest_kind, result_cache=cache_doc, stream=stream_doc)
        if rcache is not None:
            # Published with every figure on disk (telemetry.json, written
            # after, is never cached): now, or, when a shared scheduler still
            # holds this report's SVGs, by its owner after the drain.  The
            # report entry names the published partials instead of holding
            # their figure files again.
            result._rcache_pending = (
                rcache,
                report_key,
                {partial_keys[seg.name]: p.fig_files for seg, p in cached}
                | {partial_keys[n]: on_disk[n].fig_files for n in published},
                [(partial_keys[n], p) for n, p in (to_render | on_disk).items()
                 if n in partial_keys and n not in published],
            )
            if render_scheduler is None:
                with timer.phase("cache_publish"):
                    _flush_result_cache(result)
                result.timings = timings = timer.as_dict()
        _write_telemetry(this_results_dir, timings, fig_stats, ingest_kind, cache_doc, stream_doc, backend,
                         _engine_stats(molly))
        return result
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)


def _sweep_stage_leftovers(this_results_dir: str) -> None:
    """Remove the staging directories of ``this_results_dir``'s report that
    a killed run left beside it (``<report>.stage-<hex>``, with its
    ``.ckpt-`` children, which share the prefix) once they are older than
    the corpus store's wreckage age; a younger one may belong to a live
    run and stays.  Each removal is logged."""
    from nemo_tpu_torch.store import CorpusStore

    parent, name = os.path.split(this_results_dir)
    try:
        names = sorted(n for n in os.listdir(parent) if n.startswith(f"{name}.stage-"))
    except FileNotFoundError:
        return
    now = time.time()
    for n in names:
        path = os.path.join(parent, n)
        try:
            if now - os.path.getmtime(path) < CorpusStore._WRECKAGE_MAX_AGE_S:
                continue
            shutil.rmtree(path)
        except FileNotFoundError:
            continue  # a concurrent run swept it first
        except OSError as ex:
            _log.warning("pipeline.stage_sweep_failed", path=path, error=f"{type(ex).__name__}: {ex}")
            continue
        _log.info("pipeline.stage_swept", path=path)


def _profiler(profile_dir: str | None, dev):
    """``torch.profiler.profile`` writing a Chrome trace into
    ``profile_dir`` when it exits, or a null context without one."""
    if not profile_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev is not None and dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return torch.profiler.profile(activities=acts,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))


def _serial_groups(map_groups, build_view, backend, timer, conn: str = ""):
    """The map groups on the caller's own backend, one after the other."""
    from nemo_tpu_torch.analysis.stream import StagedGroup

    for group in map_groups:
        view, own_set = build_view(group)
        with timer.phase("init"):
            backend.init_graph_db(conn, view)
        yield StagedGroup(group=group, view=view, own_set=own_set, backend=backend, shared_backend=True)


def _publish_segment_checkpoint(rcache, key: str, partial: delta.SegmentPartial, seg_mo: delta.MapOutput,
                                fig_iters: list[int], stage_dir: str) -> bool | None:
    """Publish one freshly mapped segment's partial to the result cache at
    once, figures included, so a crashed run resumes from it.  The
    segment's figures render into a directory beside ``stage_dir``, are
    published from there, then move into ``stage_dir``, the report's
    figures/ to be: the report phase does not render them again.  True when
    the partial was published; False (logged by the cache) leaves it for
    the end-of-run publish, its figures on disk either way.  None when
    rendering or publishing raised (counted ``rcache.checkpoint_failed``,
    logged, as the JAX package's): nothing was staged, and the caller
    renders the segment's figures in the report phase and publishes it
    at the end of the run."""
    import tempfile

    parent = os.path.dirname(stage_dir)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(stage_dir) + ".ckpt-", dir=parent)
    try:
        try:
            rep = Reporter()
            rep.figures_dir = tmp
            _generate_map_figures(rep, fig_iters, seg_mo)
            rep.scheduler.drain()
            ok = rcache.put_partial(key, partial, tmp)
        except Exception as ex:
            obs.metrics.inc("rcache.checkpoint_failed")
            _log.warning("delta.checkpoint_failed", key=key[:12], error=f"{type(ex).__name__}: {ex}")
            return None
        os.makedirs(stage_dir, exist_ok=True)
        for name in partial.fig_files:
            os.replace(os.path.join(tmp, name), os.path.join(stage_dir, name))
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _flush_result_cache(result: DebugResult) -> None:
    """Publish a report's result-cache entries: the fresh segment partials,
    then the report tree, which names every published partial.  Every
    figure must be on disk: a caller that shares a RenderScheduler calls
    this after its drain."""
    pending = result.__dict__.pop("_rcache_pending", None)
    if not pending:
        return
    rcache, report_key, published, puts = pending
    figures_dir = os.path.join(result.report_dir, "figures")
    for key, p in puts:
        if rcache.put_partial(key, p, figures_dir):
            published[key] = p.fig_files
    if report_key is not None:
        rcache.put_report(report_key, result.report_dir, NONDETERMINISTIC_REPORT_FILES, published)


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
