"""The harness end to end on the CPU at small sizes: every cell runs and
checks correct, traced and untraced; it refuses to run without a card or
without the program; a cell, a traffic mix and a metric are added by
adding files; and each fault a cell can have, planted under the timed
path, makes ``correct`` come out false; and a run that loads JAX or the JAX
package after its window prints no result."""

import json
import os
import subprocess
import sys

import pytest

from benchutil import REPO, run_cell

CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


def listed(root, cell, trace):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    specs = bench["per_layer"] if trace else bench["end_to_end"]
    return {m["name"] for m in specs if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(bench_copy, cell, trace):
    # The query cell's p90 needs 100 queries in the window.
    rc, res, err = run_cell(bench_copy, cell, trace=trace, seconds=4 if cell.endswith(".query") else 1)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared" and res["compared"]["mismatched_documents"] == {"value": 0, "limit": 0}
    assert err.rstrip().splitlines()[-1] == "portbench: compared mismatched_documents 0 limit 0"
    got = set(res["metrics"])
    want = listed(bench_copy, cell, trace)
    # No kernel launches on the CPU: the roofline readers find nothing to read.
    assert got == {m for m in want if "roofline" not in m}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"} and set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(isinstance(v["value"], float) and v["value"] > 0 for v in res["metrics"].values())


def test_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"), "--workload",
                           "case_studies.report", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_refuses_without_the_program(bench_copy):
    os.remove(os.path.join(bench_copy, "nemo_tpu_torch"))
    rc, res, err = run_cell(bench_copy, "case_studies.query")
    assert rc != 0 and res is None


def test_a_config_cell_traffic_and_metric_are_added_by_files(bench_copy):
    pb = os.path.join(bench_copy, "portbench")
    with open(os.path.join(pb, "configs", "sweep.json"), "w") as f:
        json.dump({"name": "sweep", "source": "https://github.com/at15/nemo/blob/master/case-studies/pb_asynchronous.ded",
                   "generator": "synth", "spec": {"n_runs": 30, "eot": 12, "name": "sweep"}, "base_seed": 6,
                   "reduced": []}, f)
    with open(os.path.join(pb, "traffic", "report_nofig.json"), "w") as f:
        json.dump({"loop": "report", "figures": "none", "corpus_cache": "off", "result_cache": "off",
                   "svg_cache": "off"}, f)
    with open(os.path.join(pb, "workloads", "sweep.report_nofig.json"), "w") as f:
        json.dump({"config": "sweep", "traffic": "report_nofig", "chips": 1}, f)
    with open(os.path.join(pb, "metrics", "reports_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.records))\n")
    path = os.path.join(bench_copy, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "sweep", "source": "https://github.com/at15/nemo/blob/master/case-studies/pb_asynchronous.ded",
                             "file": "portbench/configs/sweep.json", "reduced": [], "why": "a small sweep"})
    bench["workloads"].append({"name": "sweep.report_nofig", "config": "sweep", "traffic": "report_nofig",
                               "chips": 1, "why": "reports without figures"})
    for m in bench["end_to_end"]:
        if m["name"] == "runs_per_s":
            m["workloads"].append("sweep.report_nofig")
    bench["per_layer"].append({"name": "reports_in_window", "unit": "reports", "better": "higher",
                               "source": "host_clock", "layer": "pipeline entry", "moves": "runs_per_s",
                               "workloads": ["sweep.report_nofig"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    rc, res, err = run_cell(bench_copy, "sweep.report_nofig", trace=0)
    assert rc == 0 and res["correct"] and set(res["metrics"]) == {"setup_s", "runs_per_s"}, err[-2000:]
    rc, res, err = run_cell(bench_copy, "sweep.report_nofig", trace=1)
    assert rc == 0 and res["correct"], err[-2000:]
    assert res["metrics"]["reports_in_window"]["value"] >= 1


def test_the_window_ends_on_whole_cycles(bench_copy):
    for cell, cycle in (("case_studies.report", 6), ("case_studies.query", 48)):
        rc, res, err = run_cell(bench_copy, cell, seconds=0.1)
        assert rc == 0, err[-2000:]
        assert res["window"]["units"] == cycle


# A JAX stub put in ``sys.modules`` after the window has closed: by a metric
# reader, or by the check.
LOADS_AFTER_THE_WINDOW = {
    "metric": ("jax", """
import portbench.harness as h
_metric = h._metric
def _loading(name):
    mod = _metric(name)
    read = mod.read
    def reads(ctx):
        import sys, types
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return read(ctx)
    mod.read = reads
    return mod
h._metric = _loading
"""),
    "check": ("nemo_tpu", """
import portbench.loops.report as r
_check = r.Loop.check
def check(self, records):
    import sys, types
    sys.modules.setdefault("nemo_tpu.analysis", types.ModuleType("nemo_tpu.analysis"))
    return _check(self, records)
r.Loop.check = check
"""),
}


@pytest.mark.parametrize("where", sorted(LOADS_AFTER_THE_WINDOW))
def test_a_forbidden_module_loaded_after_the_window_withholds_the_result(bench_copy, where):
    name, prelude = LOADS_AFTER_THE_WINDOW[where]
    rc, res, err = run_cell(bench_copy, "case_studies.report", prelude=prelude, seconds=0.1)
    assert rc == 3 and res is None
    assert f"portbench: the process loaded {name}" in err


# Faults planted under the timed path, in the child before the harness runs.
REPORT_FAULTS = {
    # one answer altered where it is produced: a run's recommendation
    "answer_altered": """
import json, os
import nemo_tpu_torch.analysis.pipeline as p
_orig = p.run_debug
def run_debug(*a, **kw):
    res = _orig(*a, **kw)
    path = os.path.join(res.report_dir, "debugging.json")
    runs = json.load(open(path))
    runs[-1]["recommendation"] = ["altered"]
    json.dump(runs, open(path, "w"))
    return res
p.run_debug = run_debug
""",
    # half of the batch left out: the first half of the corpus's runs
    "half_the_runs": """
import json, os, shutil, tempfile
import nemo_tpu_torch.analysis.pipeline as p
_orig = p.run_debug
def run_debug(d, *a, **kw):
    runs = json.load(open(os.path.join(d, "runs.json")))
    half = os.path.join(tempfile.mkdtemp(), os.path.basename(d))
    shutil.copytree(d, half)
    json.dump(runs[: len(runs) // 2], open(os.path.join(half, "runs.json"), "w"))
    return _orig(half, *a, **kw)
p.run_debug = run_debug
""",
    # a step that returns its state unchanged: every report after the first
    # is the first one again
    "state_unchanged": """
import os, shutil, tempfile
import nemo_tpu_torch.analysis.pipeline as p
_orig = p.run_debug
_first = []
def run_debug(d, root, backend, **kw):
    res = _orig(d, root, backend, **kw)
    if not _first:
        _first.append(os.path.join(tempfile.mkdtemp(), "first"))
        shutil.copytree(res.report_dir, _first[0])
    else:
        shutil.rmtree(res.report_dir)
        shutil.copytree(_first[0], res.report_dir)
    return res
p.run_debug = run_debug
""",
}
QUERY_FAULTS = {
    "answer_altered": """
import nemo_tpu_torch.query.engine as e
_orig = e.execute_query
def execute_query(*a, **kw):
    doc = _orig(*a, **kw)
    doc["n_runs"] += 1
    return doc
e.execute_query = execute_query
""",
    "half_the_runs": """
import nemo_tpu_torch.query.engine as e
_orig = e.execute_query
def execute_query(q, molly, **kw):
    class Half:
        def __getattr__(self, name):
            return getattr(molly, name)
    h = Half()
    h.runs = molly.runs[: len(molly.runs) // 2]
    h.store_segments = None
    return _orig(q, h, **kw)
e.execute_query = execute_query
""",
    "state_unchanged": """
import nemo_tpu_torch.query.engine as e
_orig = e.execute_query
_first = []
def execute_query(*a, **kw):
    doc = _orig(*a, **kw)
    if not _first:
        _first.append(doc)
    return _first[0]
e.execute_query = execute_query
""",
}


FAULT_CASES = [(c, f) for c in CELLS for f in (QUERY_FAULTS if c.endswith(".query") else REPORT_FAULTS)]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_planted_fault_is_caught(bench_copy, cell, fault):
    faults = QUERY_FAULTS if cell.endswith(".query") else REPORT_FAULTS
    rc, res, err = run_cell(bench_copy, cell, prelude=faults[fault], seconds=1.5)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False and res["failed"] > 0
    assert res["compared"]["mismatched_documents"]["value"] > 0
    assert err.rstrip().splitlines()[-1].startswith("portbench: compared mismatched_documents ")
