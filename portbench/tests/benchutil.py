"""Helpers of the benchmark's own tests: a copy of the benchmark at a small
size, and a runner script that runs one of its cells on the CPU in a child
process (the harness's look for a card skipped)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL_RUNS = {"case_studies": 24}

RUNNER = """
import sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench.harness import main
if __name__ == "__main__":
{prelude}
    sys.exit(main(sys.argv[1:], t, device="cpu"))
"""


def small_copy(dst: str) -> str:
    """The benchmark under ``dst`` (BENCHMARK.json and portbench/) with the
    corpora cut to SMALL_RUNS, beside a link to the program."""
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(REPO, "nemo_tpu_torch"), os.path.join(dst, "nemo_tpu_torch"))
    for name, runs in SMALL_RUNS.items():
        path = os.path.join(dst, "portbench", "configs", f"{name}.json")
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
        cfg["n_runs"] = runs
        with open(path, "w", encoding="utf-8") as f:
            json.dump(cfg, f, indent=1)
    return dst


def run_cell(root: str, workload: str, seed: int = 4294967311, seconds: float = 1.0, trace: int = 0,
             prelude: str = "") -> tuple[int, dict | None, str]:
    """(exit code, the result line or None, standard error) of one CPU run."""
    script = os.path.join(root, "runcell.py")
    with open(script, "w", encoding="utf-8") as f:
        f.write(RUNNER.format(root=root, prelude=textwrap.indent(prelude, "    ")))
    env = dict(os.environ, TMPDIR=os.path.join(root, "tmp"), NEMO_CORPUS_CACHE="off", NEMO_RESULT_CACHE="off")
    os.makedirs(env["TMPDIR"], exist_ok=True)
    proc = subprocess.run([sys.executable, script, "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr
