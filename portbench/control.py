"""The control of ``correct``: the reference put in the program's place with
one guarantee broken, which the comparison has to reject.

The configurations state no precision; their guarantee is that every run of
the corpus is analysed (every query evaluated over every selected run).
The control analyses every second run only, as a sampling shortcut would,
and its documents are compared with the reference's by the benchmark's own
comparison (check.py).  It needs no card and runs no program code:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: the answers (reports or queries) compared, how
many the comparison rejected, and ``mismatched_documents``, the number the
benchmark holds to its limit of 0."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import corpora  # noqa: E402
from portbench.check import query_mismatch  # noqa: E402

STRIDE = 2


def _load(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def _write_report(root: str, name: str, exp: dict) -> str:
    """A report tree holding a reference report's documents, as the
    program's writer lays them out."""
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "figures"))
    with open(os.path.join(d, "debugging.json"), "w", encoding="utf-8") as f:
        json.dump(exp["debugging"], f)
    with open(os.path.join(d, "repairs.json"), "w", encoding="utf-8") as f:
        json.dump(exp["repairs"], f)
    for fname, text in exp["figures"].items():
        for out in (fname, fname[: -len(".dot")] + ".svg"):
            with open(os.path.join(d, "figures", out), "w", encoding="utf-8") as f:
                f.write(text)
    return d


def control_readings(workload: str, seed: int, workdir: str, bench_dir: str) -> dict:
    from portbench.check import report_mismatches
    from portbench.loops.query import query_pool
    from portbench.reference.molly import load_molly_output, subsample
    from portbench.reference.qlang import parse_query
    from portbench.reference.query import expected_query
    from portbench.reference.report import expected_report

    wl = _load(bench_dir, "workloads", f"{workload}.json")
    config = _load(bench_dir, "configs", f"{wl['config']}.json")
    traffic = _load(bench_dir, "traffic", f"{wl['traffic']}.json")
    cs = corpora.write_corpora(config, seed, os.path.join(workdir, "corpora"),
                               os.path.join(os.path.dirname(bench_dir), ".portbench-cache", "corpora"))
    compared = rejected = mismatched = 0
    # The store loop's reports are the report loop's, served from a store.
    if traffic["loop"] in ("report", "report_store"):
        for c in cs:
            want = expected_report(c["dir"], traffic["figures"])
            got = _write_report(os.path.join(workdir, "control"), c["name"],
                                expected_report(c["dir"], traffic["figures"], stride=STRIDE))
            bad = report_mismatches(got, want)
            compared += 1
            rejected += bool(bad)
            mismatched += len(bad)
    else:
        dirs = {c["name"]: c["dir"] for c in cs}
        refs: dict[str, tuple] = {}
        for name, text, _ in query_pool(traffic, list(dirs)):
            if name not in refs:
                ref = load_molly_output(dirs[name])
                refs = {name: (ref, subsample(ref, STRIDE))}
            ref, half = refs[name]
            q = parse_query(text)
            bad = query_mismatch(expected_query(q, half), expected_query(q, ref))
            compared += 1
            rejected += bad
            mismatched += bad
    return {"workload": workload, "seed": seed, "answers": compared, "answers_rejected": rejected,
            "mismatched_documents": mismatched, "limit": 0}


def main(argv: list[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench_dir = os.path.dirname(os.path.abspath(__file__))
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            t = time.perf_counter()
            out = control_readings(args.workload, seed, workdir, bench_dir)
            out["seconds"] = time.perf_counter() - t
            print(json.dumps(out), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
