"""Command line: the debugging report of one or more fault-injection sweep
directories, on one device.

    python -m nemo_tpu_torch.cli -faultInjOut <dir> [<dir> ...] [--device cuda|cpu]
        [--results-dir DIR] [--figures all|failed|sample:N|none]
        [--analysis-impl auto|dense|sparse|sparse_device]
        [--ingest auto|native|python] [--injector auto|molly|trace-json]
        [--corpus-cache DIR|off] [--result-cache DIR|off] [--prefetch]
        [--save-corpus FILE.npz] [--out analysis.json]
    python -m nemo_tpu_torch.cli -faultInjOut <dir> --watch [--watch-poll-s S]
        [--watch-debounce-s S] [--watch-max-updates N]
        [--replay SRC [--replay-generations N] [--replay-interval-s S]] ...

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

``--watch`` re-debugs the one directory as the injector writes it
(watch/watcher.py): each batch of new runs is appended to the corpus store,
only its runs are mapped, and ``DIR/<corpus>`` is a link flipped atomically
to the newest report, until ``--watch-max-updates`` updates or Ctrl-C.
``--replay SRC`` writes the finished corpus SRC into the watched directory
in ``--replay-generations`` growing prefixes, ``--replay-interval-s``
apart: a sweep that is still running, replayed.

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from nemo_tpu_torch.analysis.pipeline import INGEST_MODES, run_debug, run_debug_dirs
from nemo_tpu_torch.backend.torch_backend import ANALYSIS_IMPLS, NoSuccessfulRunError, TorchBackend
from nemo_tpu_torch.ingest.adapters import INJECTORS, load_output


def analyze(fault_inj_out: str, device=None, analysis_impl: str = "auto", injector: str | None = None) -> dict:
    """The analysis document of one corpus (see the module docstring)."""
    timings: dict[str, float] = {}
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nemo_tpu_torch.cli", description=__doc__.split("\n")[0])
    ap.add_argument("-faultInjOut", dest="fault_inj_out", required=True, nargs="+", metavar="DIR",
                    help="fault-injection sweep directory (or directories) to analyze")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--analysis-impl", default="auto", choices=ANALYSIS_IMPLS,
                    help="force one lane for every verb: dense, sparse (host) or sparse_device "
                         "(default auto: per bucket)")
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
    args = ap.parse_args(argv)
    if (args.watch or args.save_corpus or args.out is not None) and len(args.fault_inj_out) != 1:
        ap.error("--watch, --save-corpus and --out take one -faultInjOut directory")
    if args.replay and not args.watch:
        ap.error("--replay drives --watch")
    if args.watch and (args.out is not None or args.save_corpus):
        ap.error("--watch writes reports: no --out or --save-corpus")
    if args.out is not None:
        doc = analyze(args.fault_inj_out[0], device=args.device, analysis_impl=args.analysis_impl,
                      injector=args.injector)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        print(f"{doc['corpus']}: {doc['runs']} runs on {doc['device']} -> {args.out}")
        return 0

    def make_backend():
        return TorchBackend(device=args.device, analysis_impl=args.analysis_impl)

    kw = dict(figures=args.figures, ingest=args.ingest, corpus_cache=args.corpus_cache,
              result_cache=args.result_cache, injector=args.injector)
    if args.watch:
        return _watch_main(args, make_backend, kw)
    if len(args.fault_inj_out) == 1:
        results = [run_debug(args.fault_inj_out[0], args.results_dir, make_backend(),
                             save_corpus_path=args.save_corpus, **kw)]
    else:
        results = run_debug_dirs(args.fault_inj_out, args.results_dir, make_backend, prefetch=args.prefetch, **kw)
    for res in results:
        print(f"{res.molly.run_name}: {len(res.molly.runs)} runs on {args.device} -> {res.report_dir}"
              f" (ingest {res.ingest}, result cache {res.result_cache['state']})")
        print("timings (s): " + ", ".join(f"{k} {v:.3f}" for k, v in res.timings.items()))
    fs = results[-1].figure_stats
    if fs and fs["figures"]:
        print(f"figures: {fs['figures']} written from {fs['unique_figures']} unique renders "
              f"in {fs['render_wall_s']} s")
    return 0


def _watch_main(args, make_backend, kw: dict) -> int:
    """``--watch``: a Watcher on the one directory, its updates printed as
    they are published, with ``--replay`` writing the source corpus into
    the directory on a thread."""
    import threading

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
        q.put(None)
        printing.join()
    if watcher.report_dir:
        print(f"watch finished after {watcher.updates} updates; live report: "
              f"{os.path.join(watcher.report_dir, 'index.html')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
