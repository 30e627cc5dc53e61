"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by name:

* ``workloads/<cell>.json``: the cell's configuration, traffic mix and chips;
* ``configs/<config>.json``: the corpora's generator and its parameters;
* ``traffic/<mix>.json``: the loop (``loops/<loop>.py``) and its parameters;
* ``metrics/<metric>.py``: a ``read(ctx)`` that returns the metric's value,
  or None where the run holds nothing for it to read.

``BENCHMARK.json`` says which metrics a cell reports: its end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: The checkout's fixed cache directory: builds, kernels and corpora.
CACHE = os.path.join(ROOT, ".portbench-cache")
#: Top-level modules that must not be loaded in the process that prints the
#: result: the JAX package the port was made from, and JAX itself.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nemo_tpu")
#: The per-layer metrics whose phase groups the result's ``window`` record
#: sums beside each report's wall.
PHASE_METRICS = ("ingest_ms_per_krun", "analysis_ms_per_krun", "report_ms_per_krun")


class Ctx:
    """What a loop and a metric reader see of the run."""

    def __init__(self, cell: str, workload: dict, config: dict, traffic: dict, seed: int, device: str,
                 workdir: str) -> None:
        self.cell, self.workload, self.config, self.traffic = cell, workload, config, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.loop = traffic["loop"]
        self.setup_parts: dict[str, float] = {}
        self.records: list[dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace: dict | None = None
        self._annotate = None

    def timed(self, part: str, fn):
        t = time.perf_counter()
        out = fn()
        self.setup_parts[part] = self.setup_parts.get(part, 0.0) + time.perf_counter() - t
        return out

    def write_corpora(self) -> list[dict]:
        from portbench.corpora import write_corpora

        return write_corpora(self.config, self.seed, os.path.join(self.workdir, "corpora"),
                             os.path.join(CACHE, "corpora"))

    def annotate(self, label: str):
        """A host label on the traced run's timeline; nothing untraced."""
        if self._annotate is None:
            return contextlib.nullcontext()
        return self._annotate(label)

    def work(self, unit: str) -> int:
        return sum(r.get(unit, 0) for r in self.records)


def _load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def _metric(name: str):
    """The module of metric ``name`` (metrics/<name>.py)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced; a metric without ``workloads`` is every cell's."""
    specs = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in specs if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> list[str]:
    found = sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN_MODULES))
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
    return found


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str], t_start: float, device: str = "cuda") -> int:
    """Run one cell once; the result is the last line of standard output.
    ``device`` is the card; a test passes ``cpu`` to drive the rest of a
    run without one."""
    args = parse_args(argv)
    bench = _load_json(ROOT, "BENCHMARK.json")
    workload = _load_json(BENCH_DIR, "workloads", f"{args.workload}.json")
    config = _load_json(BENCH_DIR, "configs", f"{workload['config']}.json")
    traffic = _load_json(BENCH_DIR, "traffic", f"{workload['traffic']}.json")
    metrics = cell_metrics(bench, args.workload, bool(args.trace))
    # Fixed cache directories inside the checkout, so that only a checkout's
    # first run builds: torch's extension builds and Triton's kernel cache.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]):
        print(f"portbench: {args.workload} needs {workload['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(args, bench, workload, config, traffic, metrics, device, workdir, t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, bench, workload, config, traffic, metrics, device, workdir, t_start) -> int:
    import torch

    ctx = Ctx(args.workload, workload, config, traffic, args.seed, device, workdir)
    ctx.setup_parts["import"] = time.perf_counter() - t_start
    ctx.timed("build_load", lambda: _load_program(device))
    loop = importlib.import_module(f"portbench.loops.{ctx.loop}").Loop(ctx)
    loop.setup()
    ctx.timed("warm", loop.warm)
    if device == "cuda":
        torch.cuda.synchronize()
    capture = None
    if args.trace:
        from torch.profiler import record_function

        from portbench.devtrace import Capture

        capture = Capture(workdir)
        ctx._annotate = record_function
    with capture or contextlib.nullcontext():
        t0 = time.perf_counter()
        ctx.setup_s = t0 - t_start
        cpu0 = time.process_time()
        k = 0
        # Whole cycles of the loop's traffic (every corpus, or every query of
        # the pool, once): each window weighs each unit of work alike.
        while time.perf_counter() - t0 < args.seconds or k % loop.cycle:
            t = time.perf_counter()
            rec = loop.step(k)
            rec["wall_s"] = time.perf_counter() - t
            ctx.records.append(rec)
            k += 1
        if device == "cuda":
            torch.cuda.synchronize()
        ctx.window_s = time.perf_counter() - t0
        window_cpu_s = time.process_time() - cpu0
    ctx._annotate = None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if forbidden_loaded():
        return 3
    if capture is not None:
        ctx.trace = capture.summary()

    values = {}
    for m in metrics:
        v = _metric(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # The program's state goes before the reference runs on the host.
    getattr(loop, "release", lambda: None)()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    verdict = loop.check(ctx.records)
    bad = verdict["mismatched_documents"]
    compared = {"mismatched_documents": {"value": len(bad), "limit": 0}}
    failed = len({b.split(":", 1)[0] for b in bad})
    for line in bad[:20]:
        print(f"portbench: mismatch {line}", file=sys.stderr)
    device_doc = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "count": workload["chips"],
        "memory_peak_bytes": peak,
    }
    result = {"correct": not bad, "attempted": verdict["attempted"], "failed": failed, "metrics": values,
              "device": device_doc}
    if ctx.trace is not None:
        device_doc["busy_s"] = ctx.trace["busy_s"]
        device_doc["window_s"] = ctx.window_s
        result["breakdown"] = ctx.trace["breakdown"]
        result["kernels"] = {k: {"launches": len(ctx.trace["launches"][k]), "device_s": ctx.trace["kernel_s"][k],
                                 "functions": ctx.trace["functions"].get(k, [])} for k in ctx.trace["launches"]}
    result["setup_parts_s"] = ctx.setup_parts
    groups = [_metric(n).PHASES for n in PHASE_METRICS] if ctx.loop == "report" else []
    # Beside the metrics, for whoever reads a run: each unit's wall and, for a
    # report, its phase groups' walls; the process's CPU seconds in the window.
    result["window"] = {"units": len(ctx.records), "cpu_s": window_cpu_s,
                        "walls_ms": [[r.get("corpus", "query"), round(r["wall_s"] * 1e3, 1)]
                                     + [round(sum(r["timings"].get(p, 0.0) for p in ps) * 1e3, 1) for ps in groups]
                                     for r in ctx.records]}
    result["compared"] = compared
    for name, c in compared.items():
        print(f"portbench: compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    # Once more before the result: the metric readers and the check ran
    # since the first look.
    if forbidden_loaded():
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _load_program(device: str) -> None:
    """Import the program, then build or load its host libraries and, on
    the card, its kernels, from the fixed build directory in the checkout."""
    from nemo_tpu_torch.ingest.native import NATIVE
    from nemo_tpu_torch.report.native import REPORT

    NATIVE.load()
    REPORT.load()
    if device == "cuda":
        from nemo_tpu_torch.kernels import build as kbuild

        kbuild.build()
