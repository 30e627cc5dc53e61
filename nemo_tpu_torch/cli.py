"""Command line: the debugging report of one or more Molly output
directories, on one device.

    python -m nemo_tpu_torch.cli -faultInjOut <dir> [<dir> ...] [--device cuda|cpu]
        [--results-dir DIR] [--figures all|failed|sample:N|none]
        [--analysis-impl auto|dense|sparse|sparse_device]
        [--ingest auto|native|python] [--corpus-cache DIR|off]
        [--result-cache DIR|off] [--prefetch] [--out analysis.json]

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
corpus maps only its new runs.

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
from nemo_tpu_torch.ingest.molly import load_molly_output


def analyze(fault_inj_out: str, device=None, analysis_impl: str = "auto") -> dict:
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

    molly = phase("ingest", load_molly_output, fault_inj_out)
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
                    help="Molly output directory (or directories) to analyze")
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
    ap.add_argument("--out", default=None,
                    help="write the JSON analysis document to this file instead of the report")
    args = ap.parse_args(argv)
    if args.out is not None:
        if len(args.fault_inj_out) != 1:
            ap.error("--out takes one -faultInjOut directory")
        doc = analyze(args.fault_inj_out[0], device=args.device, analysis_impl=args.analysis_impl)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        print(f"{doc['corpus']}: {doc['runs']} runs on {doc['device']} -> {args.out}")
        return 0

    def make_backend():
        return TorchBackend(device=args.device, analysis_impl=args.analysis_impl)

    kw = dict(figures=args.figures, ingest=args.ingest, corpus_cache=args.corpus_cache,
              result_cache=args.result_cache)
    if len(args.fault_inj_out) == 1:
        results = [run_debug(args.fault_inj_out[0], args.results_dir, make_backend(), **kw)]
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


if __name__ == "__main__":
    sys.exit(main())
