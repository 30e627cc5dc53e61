"""Command line: the debugging report of one or more fault-injection sweep
directories, on one device.

    python -m nemo_tpu_torch.cli -faultInjOut <dir> [<dir> ...] [--device cuda|cpu]
        [--results-dir DIR] [--figures all|failed|sample:N|none]
        [--analysis-impl auto|dense|sparse|sparse_device] [--shard auto|on|off]
        [--giant-impl auto|host|device|sparse_device] [--max-batch N]
        [--graph-backend torch|service|python|neo4j [-graphDBConn HOST:PORT|bolt://HOST:PORT]]
        [--ingest auto|native|python] [--injector auto|molly|trace-json]
        [--corpus-cache DIR|off] [--result-cache DIR|off] [--prefetch]
        [--svg-cache DIR|off] [--save-corpus FILE.npz] [--out analysis.json]
        [--serve PORT]
        [--trace FILE] [--metrics-out FILE|-] [--timings] [--profile DIR]
    python -m nemo_tpu_torch.cli -faultInjOut <dir> --watch [--watch-poll-s S]
        [--watch-debounce-s S] [--watch-max-updates N]
        [--replay SRC [--replay-generations N] [--replay-interval-s S]] [--serve PORT] ...
    python -m nemo_tpu_torch.cli query TEXT -faultInjOut <dir> [--device cuda|cpu]
        [--injector ...] [--corpus-cache DIR|off] [--result-cache DIR|off] [--explain]
    python -m nemo_tpu_torch.cli --calibrate [--device cuda|cpu] [-faultInjOut <dir> ...]

Writes the report tree ``DIR/<corpus>/`` (default ``./results``) of each
directory; several go through ``run_debug_dirs``, which names the reports
apart when two directories share a basename and, with ``--prefetch``,
parses each corpus while the one before it is analysed:
debugging.json, repairs.json, the figures as .dot and .svg and the HTML/JS
frontend, byte-equal to the JAX package's report of the same corpus, and
telemetry.json with the phase walls.  ``--figures`` picks the runs that get
figures (analysis/pipeline.py:select_figure_iters).  ``--ingest`` picks
the loader of the report: ``native`` (the C++ engine, packed arrays only),
``python`` (the object loader), ``auto`` (native on this backend; a build
failure raises).  ``--corpus-cache`` and ``--result-cache`` are the roots
of the memory-mapped corpus store and the result cache (default
``$NEMO_CORPUS_CACHE`` / ``$NEMO_RESULT_CACHE``, else
``~/.cache/nemo_tpu_torch/corpus`` and ``.../results``; ``off`` disables):
a repeated request restores the report with no kernel launch, a grown
corpus maps only its new runs.  ``--injector`` names the sweep's layout
(ingest/adapters.py): ``molly`` (runs.json and per-run files),
``trace-json`` (one trace.json) or ``auto`` (default, sniffed; or
``$NEMO_INJECTOR``).  ``--save-corpus`` writes the packed corpus of one
directory as one ``.npz`` (graphs/corpus.py), read by the Python loader.
Each unique figure renders once, in the C++ engine (``NEMO_SVG_IMPL=python``:
the Python renderer), and is served from then on by the persistent SVG
cache, ``--svg-cache`` (default ``$NEMO_SVG_CACHE``, else
``~/.cache/nemo_tpu_torch/svg``; ``off`` disables), which travels as its
env var for the length of the call (report/render.py reads it).

``--watch`` re-debugs the one directory as the injector writes it
(watch/watcher.py): each batch of new runs is appended to the corpus store,
only its runs are mapped, and ``DIR/<corpus>`` is a link flipped atomically
to the newest report, until ``--watch-max-updates`` updates or Ctrl-C.
``--replay SRC`` writes the finished corpus SRC into the watched directory
in ``--replay-generations`` growing prefixes, ``--replay-interval-s``
apart: a sweep that is still running, replayed.

``--serve PORT`` serves the report afterwards on http://127.0.0.1:PORT (the
results root when there are several corpora, or under ``--watch``, while
it watches), with ``POST /query``: a JSON body ``{"query": TEXT}`` (and
``"report": NAME`` to pick one of several corpora) answers with the query's
result document, or ``{"error": ...}`` and status 400.  Queries run one at
a time, on ``--device``.

``--trace FILE`` writes a Chrome-trace-event JSON of the run's host spans
(``phase:*``, ``kernel:<verb>``, ``analysis:*``, ``ingest:*``,
``render:*``; obs/trace.py), which ui.perfetto.dev opens; ``NEMO_TRACE``
is its environment equivalent.  A failed run still writes the partial
trace.  ``--metrics-out FILE`` writes the process's obs metrics registry
as Prometheus text after the run (``-``: stdout).  ``--timings`` prints
each phase's wall.  ``--profile DIR`` captures the map of each report
under ``torch.profiler`` (CUDA activity on the card) into DIR as a Chrome
trace, labelled by the program's own spans: each phase ``phase:<name>``,
each kernel dispatch ``kernel:<verb>``; a profiled run
bypasses the result cache.  The JSON log records (obs/log.py) go to
stderr (``NEMO_LOG_LEVEL``, ``NEMO_LOG_FILE``).

``query TEXT`` runs one ad-hoc provenance query (query/lang.py) over a
directory, ingested through the corpus store, and prints its result
document as JSON; ``--explain`` prints the lowered plan instead and reads
no corpus.  A malformed query or an unknown name exits 2.

``--profile-mode auto|off|force`` sets the platform profile's mode for the
run (platform/profile.py; else ``$NEMO_PROFILE``, else ``off``): ``auto``
loads the device's measured profile and calibrates it once when there is
none, ``off`` routes on the seeded constants, ``force`` recalibrates once.
``--calibrate`` recalibrates the device's profile now (bounded by
``$NEMO_PROFILE_BUDGET_S``, default 8 s, after the build), saves it under
``$NEMO_PROFILE_DIR`` (default ``~/.cache/nemo_tpu_torch/platform``) and
prints the constant table; without ``-faultInjOut`` it stops there, with
it the report routes by the new profile.  Unless a mode is named it runs
under ``auto``; under ``off`` it refuses (exit 2).

With ``--out FILE`` it writes instead one JSON analysis document (analyze):
the success and failed iterations, the good run, per-run achieved-antecedent
goal counts, the four prototype outputs, the missing events of every failed
run, the extension candidates of every run, the route taken by each
dispatch, the dispatch counts per verb and the wall time of each phase
(one directory only).  The device defaults to ``cuda``; without a card that
raises unless ``--device cpu`` is given.  ``--analysis-impl`` forces one
lane for every bucket, the diff and the synth pass: ``dense``, ``sparse``
(the host lane) or ``sparse_device`` (giant runs take the sparse device
step unless ``sparse``); ``auto`` routes each by the JAX package's
device-backend rules, with the host-lane work budgets of TorchBackend.
``--shard``, ``--giant-impl`` and ``--max-batch`` are TorchBackend's
``shard`` (the run mesh: ``on`` places even at one rank, ``auto`` only in a
world of several), ``giant_impl`` (``device``: the dense node-sharded giant
step) and ``max_batch`` (runs a dispatch at most); the JAX CLI reads them
from ``NEMO_SHARD``, ``NEMO_GIANT_IMPL`` and ``NEMO_MAX_BATCH``.
``-faultInjOut`` is also spelled ``--fault-inj-out``.

``--graph-backend service`` runs the device verbs on a sidecar at
``-graphDBConn HOST:PORT`` (``--graph-db-conn``, default
``127.0.0.1:50051``; start it with ``python -m
nemo_tpu_torch.service.server``), through ServiceBackend; the report is
TorchBackend's, byte for byte.  ``--device`` is then the sidecar's business
and not read.  ``torch`` (the default; the JAX CLI's default is
``python``) runs them in this process.  ``python`` runs every verb on the
host in the property-graph oracle (backend/python_ref.py) and ``neo4j`` on
the Neo4j server at ``-graphDBConn`` (default ``bolt://127.0.0.1:7687``)
over the port's Bolt client (backend/neo4j_backend.py); neither touches a
device or builds a kernel library, so ``--analysis-impl``, ``--shard``,
``--giant-impl``, ``--max-batch`` and ``--out`` are refused with them
(exit 2), and ``--device`` only picks where a ``--serve`` query runs.  A
Molly corpus to try them on comes from the bundled injector:
``python -m nemo_tpu_torch.dedalus -spec pb_asynchronous -o DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import torch

from nemo_tpu_torch.analysis.pipeline import INGEST_MODES, run_debug, run_debug_dirs
from nemo_tpu_torch.backend.torch_backend import ANALYSIS_IMPLS, GIANT_IMPLS, NoSuccessfulRunError, TorchBackend
from nemo_tpu_torch.ingest.adapters import INJECTORS, load_output
from nemo_tpu_torch.obs import trace as obs_trace
from nemo_tpu_torch.platform import profile
from nemo_tpu_torch.utils.env import env_override


def analyze(fault_inj_out: str, device=None, analysis_impl: str = "auto", injector: str | None = None,
            backend=None) -> dict:
    """The analysis document of one corpus (see the module docstring), on
    ``backend`` (default: a TorchBackend of ``device`` and
    ``analysis_impl``)."""
    timings: dict[str, float] = {}
    if backend is None:
        backend = TorchBackend(device=device, analysis_impl=analysis_impl)
    dev = backend.executor.device

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0
        return out

    molly = phase("ingest", load_output, fault_inj_out, injector)
    success, failed = molly.get_success_runs_iters(), molly.get_failed_runs_iters()
    phase("pack", backend.init_graph_db, "", molly)
    phase("fused", backend.load_raw_provenance)
    phase("simplify", backend.simplify_prov, molly.get_runs_iters())
    inter, inter_miss, union, union_miss = phase(
        "prototypes", backend.create_prototypes, success, failed
    )
    try:
        good = backend.good_run_iter()
    except NoSuccessfulRunError:
        good = None
    missing = phase("diff", backend.missing_events, failed) if good is not None else []
    counts = phase("achieved_pre", backend.achieved_pre_goal_counts)
    synth = phase("synth_ext", backend.synth_candidates, molly.get_runs_iters())
    return {
        "corpus": molly.run_name,
        "runs": len(molly.runs),
        "success_iters": success,
        "failed_iters": failed,
        "good_run": good,
        "achieved_pre_goal_counts": {str(i): counts.get(i, 0) for i in molly.get_runs_iters()},
        "inter_proto": inter,
        "inter_proto_missing": dict(zip(map(str, failed), inter_miss)),
        "union_proto": union,
        "union_proto_missing": dict(zip(map(str, failed), union_miss)),
        "missing_events": {
            str(f): [m.to_json() for m in events] for f, events in zip(failed, missing)
        },
        "synth_candidates": {str(i): synth[i] for i in molly.get_runs_iters()},
        "routes": list(backend.analysis_routes),
        "device": str(dev),
        "dispatches": dict(backend.executor.dispatches),
        "dispatch_wall_s": dict(backend.executor.wall_s),
        "timings_s": timings,
    }


#: --graph-backend: this process's device (torch), the sidecar (service), or
#: the host backends, which run every verb on the host (python, neo4j).
GRAPH_BACKENDS = ("torch", "service", "python", "neo4j")
HOST_BACKENDS = ("python", "neo4j")
#: -graphDBConn per backend when none is given (neo4j: the JAX CLI's).
DEFAULT_CONN = {"service": "127.0.0.1:50051", "neo4j": "bolt://127.0.0.1:7687"}


def _positive_int(text: str) -> int:
    try:
        n = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not an integer") from None
    if n < 1:
        raise argparse.ArgumentTypeError(f"{n} is not a positive integer")
    return n


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "query":
        # The query text is positional and the report's parser takes flags
        # only, so the subcommand has a parser of its own.
        return _query_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m nemo_tpu_torch.cli", description=__doc__.split("\n")[0])
    ap.add_argument("-faultInjOut", "--fault-inj-out", dest="fault_inj_out", nargs="+", metavar="DIR",
                    help="fault-injection sweep directory (or directories) to analyze")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # The device knobs default to None, so that one given with a host
    # backend (python, neo4j) is seen and refused; None resolves to auto.
    ap.add_argument("--analysis-impl", default=None, choices=ANALYSIS_IMPLS,
                    help="force one lane for every verb: dense, sparse (host) or sparse_device "
                         "(default auto: per bucket)")
    ap.add_argument("--shard", default=None, choices=("auto", "on", "off"),
                    help="the run mesh: on places the fused dispatches on it even at one rank, auto (the default) "
                         "only in a world of several (torch.distributed), off never")
    ap.add_argument("--giant-impl", default=None, choices=GIANT_IMPLS,
                    help="giant runs: host, device (the dense node-sharded step), sparse_device, or auto (the "
                         "default: the host under --analysis-impl sparse, else sparse_device)")
    ap.add_argument("--max-batch", type=_positive_int, default=None, metavar="N",
                    help="at most N runs a fused dispatch (default: one dispatch a bucket)")
    ap.add_argument("--graph-backend", default="torch", choices=GRAPH_BACKENDS,
                    help="run the device verbs in this process (torch), on the sidecar at -graphDBConn (service), "
                         "or every verb on the host: the Python oracle (python) or a Neo4j server at -graphDBConn "
                         "(neo4j)")
    ap.add_argument("-graphDBConn", "--graph-db-conn", dest="graph_db_conn", default=None,
                    metavar="HOST:PORT|bolt://HOST:PORT",
                    help="the sidecar's address under --graph-backend service (default 127.0.0.1:50051), the Neo4j "
                         "server's under neo4j (default bolt://127.0.0.1:7687)")
    ap.add_argument("--results-dir", default=os.path.join(os.getcwd(), "results"),
                    help="root directory of the report (default ./results)")
    ap.add_argument("--figures", default="all", metavar="POLICY",
                    help="figure policy: all, failed (failed runs + the good run), "
                         "sample:N (N failed + N other runs + the good run) or none")
    ap.add_argument("--ingest", default="auto", choices=INGEST_MODES,
                    help="report loader: native C++ engine, Python objects, or auto (native here)")
    ap.add_argument("--corpus-cache", default=None, metavar="DIR|off",
                    help="corpus store root (default $NEMO_CORPUS_CACHE or "
                         "~/.cache/nemo_tpu_torch/corpus; 'off' disables)")
    ap.add_argument("--result-cache", default=None, metavar="DIR|off",
                    help="result cache root (default $NEMO_RESULT_CACHE or "
                         "~/.cache/nemo_tpu_torch/results; 'off' disables)")
    ap.add_argument("--svg-cache", default=None, metavar="DIR|off",
                    help="persistent SVG cache root (default $NEMO_SVG_CACHE or ~/.cache/nemo_tpu_torch/svg; "
                         "'off' disables), keyed by render content and renderer version")
    ap.add_argument("--prefetch", action="store_true",
                    help="with several -faultInjOut directories, parse the next corpus on a worker thread "
                         "while the current one is analysed (default: one after the other)")
    ap.add_argument("--injector", default=None, choices=("auto", *INJECTORS),
                    help="sweep layout: molly (runs.json and per-run files), trace-json (one trace.json) or auto "
                         "(default $NEMO_INJECTOR, else sniffed)")
    ap.add_argument("--save-corpus", default=None, metavar="FILE",
                    help="write the packed corpus of the one directory to FILE (.npz), reading it with the "
                         "Python loader")
    ap.add_argument("--out", default=None,
                    help="write the JSON analysis document to this file instead of the report")
    ap.add_argument("--watch", action="store_true",
                    help="re-debug the one directory as the fault injector writes it, publishing each update "
                         "under --results-dir; Ctrl-C stops")
    ap.add_argument("--watch-poll-s", type=float, default=None, metavar="S",
                    help="watch poll interval (default $NEMO_WATCH_POLL_S or 0.5)")
    ap.add_argument("--watch-debounce-s", type=float, default=None, metavar="S",
                    help="how long the directory must hold still before an update (default "
                         "$NEMO_WATCH_DEBOUNCE_S or 0.25)")
    ap.add_argument("--watch-max-updates", type=int, default=0, metavar="N",
                    help="stop watching after N updates (default 0: until Ctrl-C)")
    ap.add_argument("--replay", default=None, metavar="SRC",
                    help="with --watch: write the finished corpus SRC into the watched directory generation "
                         "by generation")
    ap.add_argument("--replay-generations", type=int, default=3, metavar="N",
                    help="replay generations (default 3)")
    ap.add_argument("--replay-interval-s", type=float, default=1.0, metavar="S",
                    help="pause between replay generations (default 1.0)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="serve the report on http://127.0.0.1:PORT afterwards (with --watch: while watching), "
                         "with POST /query (default 0: off)")
    ap.add_argument("--timings", action="store_true", help="print per-phase wall-clock timings")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the analysis phases into DIR, labelled by the "
                         "program's phase:<name> and kernel:<verb> spans (view with TensorBoard or ui.perfetto.dev)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="write a Chrome-trace-event JSON of host spans (pipeline phases, kernel dispatches, "
                         "render) to FILE — open it at ui.perfetto.dev.  Equivalent env: NEMO_TRACE.  "
                         "Near-zero overhead when off")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="after the run, dump the obs metrics registry one-shot in Prometheus text format to "
                         "FILE ('-' for stdout)")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate the device's platform profile now (bounded by $NEMO_PROFILE_BUDGET_S, default "
                         "8 s, after the build), save it under $NEMO_PROFILE_DIR or ~/.cache/nemo_tpu_torch/platform "
                         "and print the constant table; recalibrates over an existing profile; without "
                         "-faultInjOut it exits after calibrating")
    ap.add_argument("--profile-mode", default=None, choices=("auto", "off", "force"),
                    help="platform profile: 'auto' loads the measured profile and calibrates once per fingerprint, "
                         "'off' (the default) routes on the seeded constants, 'force' recalibrates once.  Equivalent "
                         "env: NEMO_PROFILE")
    args = ap.parse_args(argv)
    if not args.fault_inj_out and not args.calibrate:
        ap.error("-faultInjOut is required (unless --calibrate runs standalone)")
    mode = args.profile_mode
    if args.calibrate and mode is None and not os.environ.get("NEMO_PROFILE"):
        mode = "auto"  # asking to calibrate turns the profile on
    svg_env = {} if args.svg_cache is None else {"NEMO_SVG_CACHE": args.svg_cache}
    with profile.mode_override(mode), env_override(svg_env):
        if args.calibrate:
            code = _calibrate_main(args.device)
            if not args.fault_inj_out:
                return code
        return _report_main(ap, args)


def _calibrate_main(device: str) -> int:
    """--calibrate: one forced calibration of ``device``'s profile, then the
    resolved constant table (arg > measured > seeded per row, the
    precedence every consumer uses)."""
    if profile.profile_mode() == "off":
        print("platform profile disabled (NEMO_PROFILE=off); nothing to calibrate", file=sys.stderr)
        return 2
    prof = profile.ensure_calibrated(device, force=True)
    fp = prof.fingerprint
    print(f"platform profile {prof.key} ({fp['platform']}/{fp['device_kind']} x{fp['device_count']}, torch "
          f"{fp['torch_version']}) calibrated in {prof.calibration_wall_s:.2f}s (build "
          f"{prof.probes['build_wall_s']:.2f}s) -> {profile.profile_path(prof.key)}")
    rejected = prof.probes.get("rejected_fits")
    if rejected:
        print(f"  {len(rejected)} probe round(s) rejected before the fit (a device slope at or above the host unit)")
    for row in profile.constant_sources(device):
        print(f"  {row['name']:>24} = {row['value']} [{row['source']}]")
    return 0


def _report_main(ap, args) -> int:
    """The report verbs of ``main`` (everything but ``query`` and a
    standalone ``--calibrate``)."""
    if (args.watch or args.save_corpus or args.out is not None) and len(args.fault_inj_out) != 1:
        ap.error("--watch, --save-corpus and --out take one -faultInjOut directory")
    if args.replay and not args.watch:
        ap.error("--replay drives --watch")
    if args.watch and (args.out is not None or args.save_corpus):
        ap.error("--watch writes reports: no --out or --save-corpus")
    if args.serve and args.out is not None:
        ap.error("--serve serves the report: no --out")
    if args.profile and args.out is not None:
        ap.error("--profile captures the report's analysis: no --out")
    if args.graph_backend == "service" and args.shard not in (None, "auto"):
        ap.error("--shard places this process's dispatches: not with --graph-backend service")
    if args.graph_backend in HOST_BACKENDS:
        given = [flag for flag, value in (("--analysis-impl", args.analysis_impl), ("--shard", args.shard),
                                          ("--giant-impl", args.giant_impl), ("--max-batch", args.max_batch))
                 if value is not None]
        if given:
            ap.error(f"device knobs ({', '.join(given)}) are not for --graph-backend {args.graph_backend}, "
                     "which runs every verb on the host")
        if args.out is not None:
            ap.error(f"--out writes TorchBackend's analysis document: not with --graph-backend {args.graph_backend}")
    conn = args.graph_db_conn if args.graph_db_conn is not None else DEFAULT_CONN.get(args.graph_backend, "")

    # Tracing: the flag wins, NEMO_TRACE is the env equivalent.  The trace
    # is written explicitly before the final prints (so the path is
    # announced), with an atexit backstop for crash paths.  The env is not
    # mutated: main() may run many times in one process.
    if args.trace:
        import atexit

        obs_trace.start_trace(args.trace)
        atexit.register(obs_trace.finish)
    else:
        obs_trace.configure_from_env()

    def make_backend():
        if args.graph_backend == "python":
            from nemo_tpu_torch.backend.python_ref import PythonBackend

            return PythonBackend()
        if args.graph_backend == "neo4j":
            from nemo_tpu_torch.backend.neo4j_backend import Neo4jBackend

            return Neo4jBackend()
        knobs = dict(analysis_impl=args.analysis_impl or "auto", giant_impl=args.giant_impl or "auto",
                     max_batch=args.max_batch)
        if args.graph_backend == "service":
            from nemo_tpu_torch.backend.service_backend import ServiceBackend

            return ServiceBackend(target=conn, **knobs)
        return TorchBackend(device=args.device, shard=args.shard or "auto", **knobs)

    kw = dict(conn=conn, figures=args.figures, ingest=args.ingest, corpus_cache=args.corpus_cache,
              result_cache=args.result_cache, injector=args.injector)
    if args.watch:
        return _watch_main(args, make_backend, kw)
    # The tracer is finished on failure too: the partial trace of a failed
    # run is written, and the global tracer disabled, so that main() can
    # run again in this process.
    try:
        if args.out is not None:
            doc = analyze(args.fault_inj_out[0], injector=args.injector, backend=make_backend())
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
            results = []
        elif len(args.fault_inj_out) == 1:
            results = [run_debug(args.fault_inj_out[0], args.results_dir, make_backend(),
                                 save_corpus_path=args.save_corpus, profile_dir=args.profile, **kw)]
        else:
            results = run_debug_dirs(args.fault_inj_out, args.results_dir, make_backend, prefetch=args.prefetch,
                                     profile_dir=args.profile, **kw)
    except BaseException:
        trace_path = obs_trace.finish()
        if trace_path:
            print(f"obs trace (partial, run failed) written to {trace_path}", file=sys.stderr)
        raise
    if args.out is not None:
        print(f"{doc['corpus']}: {doc['runs']} runs on {doc['device']} -> {args.out}")
    for res in results:
        where = {"torch": args.device, "service": f"the sidecar at {conn}", "python": "the host",
                 "neo4j": f"the Neo4j server at {conn}"}[args.graph_backend]
        print(f"{res.molly.run_name}: {len(res.molly.runs)} runs on {where} -> {res.report_dir}"
              f" (ingest {res.ingest}, result cache {res.result_cache['state']})")
    fs = results[-1].figure_stats if results else None
    if fs and fs["figures"]:
        print(f"figures: {fs['figures']} written from {fs['unique_figures']} unique renders "
              f"in {fs['render_wall_s']} s")
    if args.timings:
        for res in results:
            if len(results) > 1:
                print(f"--- {res.molly.run_name}")
            for phase, secs in res.timings.items():
                print(f"{phase:>22s}  {secs * 1e3:9.1f} ms")
        if fs and fs.get("figures"):
            print(f"figures: {fs['figures']} rendered as {fs['unique_figures']} unique (dedup "
                  f"{fs['dedup_ratio']}x), {fs['figure_cache_hits']} cache hits, {fs['render_workers']} render "
                  "workers")
        if args.out is not None:
            for phase, secs in doc["timings_s"].items():
                print(f"{phase:>22s}  {secs * 1e3:9.1f} ms")
    trace_path = obs_trace.finish()
    if trace_path:
        print(f"obs trace written to {trace_path} (open at ui.perfetto.dev)")
    if args.metrics_out:
        from nemo_tpu_torch.obs import promexp

        text = promexp.render_prometheus()
        if args.metrics_out == "-":
            sys.stdout.write(text)
        else:
            with open(args.metrics_out, "w", encoding="utf-8") as fh:
                fh.write(text)
            print(f"metrics written to {args.metrics_out} (Prometheus text format)")
    if args.serve:
        import http.server

        serve_dir = results[0].report_dir if len(results) == 1 else args.results_dir
        handler = query_http_handler(serve_dir, batch_molly_resolver(results), device=args.device,
                                     result_cache=args.result_cache)
        with http.server.ThreadingHTTPServer(("127.0.0.1", args.serve), handler) as httpd:
            print(f"Serving the report at http://127.0.0.1:{httpd.server_address[1]}/ (Ctrl-C to stop)", flush=True)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
    return 0


def _query_main(argv: list[str]) -> int:
    """``query TEXT``: one ad-hoc query over a corpus directory, its result
    document printed as JSON; exit 2 on a malformed query or unknown name."""
    from nemo_tpu_torch.query import QueryError, parse_query, plan_query
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus

    ap = argparse.ArgumentParser(prog="python -m nemo_tpu_torch.cli query",
                                 description="Run one ad-hoc provenance query over a corpus directory.")
    ap.add_argument("query", help="query text, e.g. 'from pre match goal[holds=true] -> @rule tables'")
    ap.add_argument("-faultInjOut", "--fault-inj-out", dest="fault_inj_out", default=None, metavar="DIR",
                    help="fault-injection sweep directory to query")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--injector", default=None, choices=("auto", *INJECTORS),
                    help="sweep layout (default $NEMO_INJECTOR, else sniffed)")
    ap.add_argument("--corpus-cache", default=None, metavar="DIR|off",
                    help="corpus store root (default $NEMO_CORPUS_CACHE or ~/.cache/nemo_tpu_torch/corpus)")
    ap.add_argument("--result-cache", default=None, metavar="DIR|off",
                    help="result cache root (default $NEMO_RESULT_CACHE or ~/.cache/nemo_tpu_torch/results)")
    ap.add_argument("--explain", action="store_true",
                    help="print the lowered plan (one line per primitive) and exit without executing")
    ap.add_argument("--serial", action="store_true",
                    help="drain query jobs serially instead of through the heterogeneous scheduler (debugging; "
                         "NEMO_SCHED=off, the default, drains serially anyway)")
    args = ap.parse_args(argv)
    try:
        q = parse_query(args.query)
    except QueryError as ex:
        print(f"query error: {ex}", file=sys.stderr)
        return 2
    if args.explain:
        for line in plan_query(q).describe():
            print(line)
        return 0
    if not args.fault_inj_out:
        ap.error("-faultInjOut is required (unless --explain)")
    if not os.path.isdir(args.fault_inj_out):
        ap.error(f"fault injector output directory not found: {args.fault_inj_out}")
    molly = ingest_corpus(args.fault_inj_out, args.corpus_cache, args.injector)
    try:
        doc = execute_query(q, molly, device=args.device, result_cache=args.result_cache, serial=args.serial)
    except QueryError as ex:
        print(f"query error: {ex}", file=sys.stderr)
        return 2
    # The walls (stats["timings"]) differ between identical runs: the
    # printed document is the answer and its cache bookkeeping only.
    doc["stats"].pop("timings", None)
    json.dump(doc, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0




def query_http_handler(serve_dir: str, resolve_molly, **query_kw):
    """A SimpleHTTPRequestHandler class serving ``serve_dir``, plus ``POST
    /query`` for the report's query box: ``resolve_molly(request)`` gives
    the corpus, ``query_kw`` go to ``run_query_text`` (device, result
    cache).  A failed query answers ``{"error": "<type>: <message>"}`` with
    status 400."""
    import functools
    import http.server

    from nemo_tpu_torch.query import run_query_text
    from nemo_tpu_torch.query.engine import QUERY_LOCK

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - http.server API
            if self.path.rstrip("/") != "/query":
                self.send_error(404, "unknown POST endpoint (expected /query)")
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n).decode("utf-8") or "{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                with QUERY_LOCK:
                    doc = run_query_text(str(req.get("query", "")), resolve_molly(req), **query_kw)
                body, status = json.dumps(doc).encode("utf-8"), 200
            except Exception as ex:  # the query box shows the error inline; the server goes on
                body, status = json.dumps({"error": f"{type(ex).__name__}: {ex}"}).encode("utf-8"), 400
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return functools.partial(Handler, directory=serve_dir)


def batch_molly_resolver(results):
    """The corpus of a query to the report server after a run: the one
    corpus, or among several the one whose report the request names
    (``"report"``, the report's directory name)."""
    from nemo_tpu_torch.query import QueryError

    by_name = {os.path.basename(res.report_dir): res.molly for res in results}

    def resolve(req: dict):
        if len(by_name) == 1:
            return next(iter(by_name.values()))
        name = str(req.get("report", ""))
        if name not in by_name:
            raise QueryError(f"query box needs a report name to pick the corpus; got {name!r} "
                             f"(one of: {', '.join(sorted(by_name))})")
        return by_name[name]

    return resolve


def watch_molly_resolver(sweep_dir: str, injector: str | None = None, corpus_cache: str | None = None):
    """The corpus of a query to the report server under ``--watch``: the
    sweep re-ingested through the corpus store (a warm hit maps it, a grown
    sweep appends), memoized on the injector's poll token, so queries
    between two generations share one ingest."""
    from nemo_tpu_torch.ingest.adapters import resolve_injector
    from nemo_tpu_torch.query.engine import ingest_corpus

    memo: dict = {}

    def resolve(req: dict):
        token = resolve_injector(sweep_dir, injector).poll_token(sweep_dir)
        if memo.get("token") != token:
            memo["molly"] = ingest_corpus(sweep_dir, corpus_cache, injector)
            memo["token"] = token
        return memo["molly"]

    return resolve


def _watch_main(args, make_backend, kw: dict) -> int:
    """``--watch``: a Watcher on the one directory, its updates printed as
    they are published, with ``--replay`` writing the source corpus into
    the directory on a thread and ``--serve`` serving the results root on
    another."""
    from nemo_tpu_torch.watch import WatchConfig, Watcher, start_replay

    sweep_dir = args.fault_inj_out[0]
    os.makedirs(sweep_dir, exist_ok=True)
    cfg = WatchConfig(poll_s=args.watch_poll_s, debounce_s=args.watch_debounce_s, max_updates=args.watch_max_updates,
                      figures=kw.pop("figures"), injector=kw.pop("injector"), run_debug_kwargs=kw)
    watcher = Watcher(sweep_dir, args.results_dir, make_backend, cfg)
    q = watcher.subscribe()

    def printer() -> None:
        while (ev := q.get()) is not None:
            if ev.get("event") == "report_update":
                print(f"watch update {ev['update']}: {ev['runs_total']} runs (+{ev['new_runs']} new, "
                      f"{ev['runs_mapped']} mapped, {ev['segments_cached']} segments cached, "
                      f"{ev['kernel_dispatches']} dispatches), {ev['quarantined']} quarantined, "
                      f"{ev['changed_total']} files changed, {ev['update_latency_s']:.2f} s", flush=True)
            elif ev.get("event") == "watch_error":
                print(f"watch cycle failed: {ev['detail']}", file=sys.stderr, flush=True)

    printing = threading.Thread(target=printer, daemon=True, name="nemo-watch-print")
    printing.start()
    httpd = None
    if args.serve:
        import http.server

        handler = query_http_handler(args.results_dir,
                                     watch_molly_resolver(sweep_dir, args.injector, kw.get("corpus_cache")),
                                     device=args.device, result_cache=kw.get("result_cache"))
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", args.serve), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True, name="nemo-watch-http").start()
        print(f"Serving live reports at http://127.0.0.1:{httpd.server_address[1]}/ (Ctrl-C to stop)", flush=True)
    replay_stop = None
    if args.replay:
        _, replay_stop = start_replay(args.replay, sweep_dir, generations=args.replay_generations,
                                      interval_s=args.replay_interval_s, injector=args.injector)
    try:
        watcher.run()
    except KeyboardInterrupt:
        watcher.stop()
    finally:
        if replay_stop is not None:
            replay_stop.set()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        q.put(None)
        printing.join()
        trace_path = obs_trace.finish()
        if trace_path:
            print(f"obs trace written to {trace_path} (open at ui.perfetto.dev)")
    if watcher.report_dir:
        print(f"watch finished after {watcher.updates} updates; live report: "
              f"{os.path.join(watcher.report_dir, 'index.html')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
