"""Observability of the port on a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py

* a traced report on cuda: its ``kernel:fused`` and ``kernel:diff`` spans
  count exactly the executor's dispatches, and the ``kernel.dispatches.*``
  deltas equal them; tracing adds no ``torch.cuda.synchronize``;
* a profiled report (``run_debug(profile_dir=...)``): the capture's device
  events include K1's kernel functions, launched under a ``kernel:fused``
  label, and telemetry.json's memory section has the device peak.
"""

import glob
import json
import os

import pytest
import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.obs import trace as obs_trace

#: K1's kernel functions (nemo_tpu_torch/csrc/closure.cu).
K1_FUNCTIONS = ("closure_warp_kernel", "closure_block_kernel", "square_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def family(tmp_path):
    return write_case_study("ZK-1270-racing-sent-flag", 64, 0, str(tmp_path / "corpus"))


def labelled_kernels(events: list[dict], label: str) -> set[str]:
    """Names of the device kernels whose launch (a ``cuda_runtime`` event,
    linked by its correlation id) lies inside a CPU range named ``label``
    on the same thread."""
    ranges = [(e["tid"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("name") == label and e.get("cat") != "gpu_user_annotation"]
    launched = {
        e["args"]["correlation"] for e in events
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
        and any(t == e["tid"] and a <= e["ts"] <= b for t, a, b in ranges)
    }
    return {e["name"] for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched}


@pytest.mark.cuda
def test_traced_report_spans_count_the_dispatches(cuda, family, tmp_path, monkeypatch):
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (syncs.append(1), real(*a, **k)))

    def report(tag: str):
        backend = TorchBackend(device="cuda", analysis_impl="dense")
        syncs.clear()
        res = run_debug(family, str(tmp_path / tag), backend, figures="failed", corpus_cache="off",
                        result_cache="off")
        return res, backend, len(syncs)

    _, _, untraced_syncs = report("U")
    path = str(tmp_path / "t.json")
    before = obs.metrics.snapshot()
    obs_trace.start_trace(path)
    try:
        res, backend, traced_syncs = report("R")
    finally:
        obs_trace.finish()
    monkeypatch.undo()
    assert traced_syncs == untraced_syncs  # the spans add no synchronize
    delta = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    with open(path, encoding="utf-8") as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    ex = backend.executor
    assert ex.dispatches["fused"] >= 1 and ex.dispatches["diff"] >= 1
    for verb, n in ex.dispatches.items():
        assert sum(e["name"] == f"kernel:{verb}" for e in spans) == n
        assert delta[f"kernel.dispatches.{verb}"] == n
    cpu = run_debug(family, str(tmp_path / "C"), TorchBackend(device="cpu", analysis_impl="dense"),
                    figures="failed", corpus_cache="off", result_cache="off")
    assert report_tree_bytes(res.report_dir) == report_tree_bytes(cpu.report_dir)


@pytest.mark.cuda
def test_profile_capture_shows_k1_under_its_label(cuda, family, tmp_path):
    prof = tmp_path / "P"
    res = run_debug(family, str(tmp_path / "R"), TorchBackend(device="cuda", analysis_impl="dense"),
                    figures="none", corpus_cache="off", result_cache="off", profile_dir=str(prof))
    (trace,) = glob.glob(str(prof / "*.pt.trace.json"))
    with open(trace, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    names = labelled_kernels(events, "kernel:fused")
    assert any(f in n for n in names for f in K1_FUNCTIONS), sorted(names)
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        mem = json.load(fh)["memory"]
    assert mem["device_peak_bytes"] >= mem["device_bytes_in_use"] >= 0 and mem["device_peak_bytes"] > 0
