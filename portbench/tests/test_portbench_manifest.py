"""BENCHMARK.json and every file it names: present, parsed, and within the
contract's characters, keys and limits."""

import json
import os
import re

import pytest

from benchutil import REPO

BENCH = os.path.join(REPO, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


MANIFEST = load(REPO, "BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    per_run = MANIFEST["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = load(REPO, c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and LINE.match(w["why"])
    assert load(BENCH, "workloads", f"{w['name']}.json") == {k: w[k] for k in ("config", "traffic", "chips")}
    traffic = load(BENCH, "traffic", f"{w['traffic']}.json")
    assert os.path.isfile(os.path.join(BENCH, "loops", f"{traffic['loop']}.py"))
    reported = [m for m in MANIFEST["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert {"setup_s"} < {m["name"] for m in reported}
    assert any(w["name"] in m.get("workloads", [w["name"]]) for m in MANIFEST["per_layer"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("m", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == E2E_KEYS
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))


def test_setup_s_bound():
    (setup,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == LAYER_KEYS
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert LINE.match(m["layer"])
    e2e = {x["name"]: x for x in MANIFEST["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in m["workloads"]:
        assert cell in cells and cell in e2e[m["moves"]].get("workloads", [cell])
    assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_share_one_name_each():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    with open(os.path.join(REPO, "PERF.md"), encoding="utf-8") as f:
        perf = f.read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
