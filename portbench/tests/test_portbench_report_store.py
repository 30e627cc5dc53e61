"""The report cell served from the corpus store (traffic ``report_store``)
on the CPU at a small size, two families: the warm pass fills a store of
the run's own under its work directory and nothing is written under
``HOME``; every window report is a store hit and equals the reference's; a
store made stale before the window fails the run; and the report cell, whose
corpus store is off, still parses every report and stores nothing.  (The
control is rejected on every cell's traffic in test_portbench_reference.)"""

import json
import os

import pytest

from benchutil import run_cell


CELL = "case_studies.report_store"
FAMILIES = ["pb_asynchronous", "ZK-1270-racing-sent-flag"]

# In the child before the harness runs: the store's place is the traffic's
# alone, and what the warm pass left and which ingest served each window
# report are written beside the checkout.  ``{loop}`` is the cell's loop.
OBSERVE = """
import json, os
os.environ.pop("NEMO_CORPUS_CACHE", None)
import portbench.loops.{loop} as r
_warm, _check = r.Loop.warm, r.Loop.check
def warm(self):
    _warm(self)
    store = os.path.join(self.ctx.workdir, "corpus-store")
    json.dump({{"workdir": self.ctx.workdir, "store": self.traffic["corpus_cache"],
               "stored": sorted(os.listdir(store)) if os.path.isdir(store) else None}},
              open("warm.json", "w"))
def check(self, records):
    json.dump([[rec["corpus"], json.load(open(os.path.join(rec["dir"], "telemetry.json")))["ingest"]]
               for rec in records], open("ingest.json", "w"))
    return _check(self, records)
r.Loop.warm, r.Loop.check = warm, check
"""
# After the warm pass, the first family's runs.json touched: its store no
# longer matches the corpus.
STALE = """
import time
_filled = r.Loop.warm
def stale_warm(self):
    _filled(self)
    path = os.path.join(self.corpora[0]["dir"], "runs.json")
    t = time.time_ns() + 10**9
    os.utime(path, ns=(t, t))
r.Loop.warm = stale_warm
"""


@pytest.fixture
def checkout(bench_copy, tmp_path, monkeypatch):
    """The small copy cut to two families, run with a ``HOME`` and cache
    home of its own, both empty."""
    path = os.path.join(bench_copy, "portbench", "configs", "case_studies.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["families"] = FAMILIES
    with open(path, "w") as f:
        json.dump(cfg, f)
    for var in ("HOME", "XDG_CACHE_HOME"):
        os.makedirs(tmp_path / var)
        monkeypatch.setenv(var, str(tmp_path / var))
    return bench_copy


def _run(root, cell=CELL, stale=False):
    loop = "report_store" if cell == CELL else "report"
    prelude = OBSERVE.format(loop=loop) + (STALE if stale else "")
    rc, res, err = run_cell(root, cell, seconds=1.0, prelude=prelude)
    with open(os.path.join(root, "warm.json")) as f:
        warm = json.load(f)
    with open(os.path.join(root, "ingest.json")) as f:
        ingest = json.load(f)
    return rc, res, err, warm, ingest


def _files_under(path):
    return [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]


def test_the_warm_pass_fills_a_store_under_the_work_directory(checkout):
    rc, res, err, warm, _ = _run(checkout)
    assert rc == 0, err[-3000:]
    assert warm["store"] == os.path.join(warm["workdir"], "corpus-store")
    assert [s.rsplit("-", 1)[0] for s in warm["stored"] if s.endswith(".npack")] == sorted(FAMILIES)
    assert not os.path.exists(warm["workdir"])


def test_nothing_is_written_under_home(checkout):
    rc, res, err, _, _ = _run(checkout)
    assert rc == 0, err[-3000:]
    assert _files_under(os.environ["HOME"]) == [] and _files_under(os.environ["XDG_CACHE_HOME"]) == []


def test_every_window_report_is_a_store_hit_and_correct(checkout):
    rc, res, err, _, ingest = _run(checkout)
    assert rc == 0, err[-3000:]
    assert {c for c, _ in ingest} == set(FAMILIES) and {k for _, k in ingest} == {"store_hit"}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == len(ingest)
    assert res["compared"]["mismatched_documents"] == {"value": 0, "limit": 0}


def test_a_store_made_stale_before_the_window_fails_the_run(checkout):
    rc, res, err, _, ingest = _run(checkout, stale=True)
    assert rc == 0, err[-3000:]
    parsed = [c for c, k in ingest if k != "store_hit"]
    assert parsed == [FAMILIES[0]]
    assert res["correct"] is False and res["failed"] == 1
    assert res["compared"]["mismatched_documents"]["value"] == 1
    assert "telemetry.json ingest 'native', want 'store_hit'" in err


def test_corpus_cache_off_parses_every_report_and_stores_nothing(checkout):
    rc, res, err, warm, ingest = _run(checkout, cell="case_studies.report")
    assert rc == 0, err[-3000:]
    assert res["correct"] and {k for _, k in ingest} == {"native"}
    assert warm["store"] == "off" and warm["stored"] is None
    assert _files_under(os.environ["HOME"]) == []

