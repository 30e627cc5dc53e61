"""The benchmark on the card at a small size: every cell's real entry
(``run.py``, no look skipped) runs, is correct, and reports the card.

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py"""

import json
import os
import subprocess
import sys

import pytest

from benchutil import REPO

CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, bench_copy, cell, trace):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "4294967311",
                           "--seconds", "3", "--trace", str(trace)], cwd=bench_copy, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], proc.stderr[-3000:]
    dev = res["device"]
    # At this size the default routes keep most of the work on the host
    # lane: the card may hold nothing and run nothing.
    assert dev["platform"] == "gpu" and dev["kind"] == card and dev["count"] == 1 and dev["memory_peak_bytes"] >= 0
    if trace:
        assert 0 <= dev["busy_s"] <= dev["window_s"]
        for name, m in res["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 105, name
