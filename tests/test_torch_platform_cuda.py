"""The platform profile on a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_platform_cuda.py

* a real calibration on the card launches K1 (the fused probe), records
  the card's name in the fingerprint and the card's memory in the fitted
  watermark, fits a device slope below the host unit (no clamped
  budget), and leaves a file that a fresh load reads with no probe
  dispatch and no launch;
* a backend on the card resolves its budgets from that profile.
"""

import pytest
import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.adapters import load_output
from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.platform import profile as pp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def prof_env(tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path / "plat"))
    pp.reset_active_profile()
    yield tmp_path
    pp.reset_active_profile()


def _counters(fn):
    before = obs.metrics.snapshot()
    out = fn()
    return out, obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]


@pytest.mark.cuda
def test_calibration_on_the_card_launches_k1_and_loads_warm(cuda, prof_env):
    k1.closure.launches = 0
    prof, c = _counters(lambda: pp.ensure_calibrated(cuda))
    assert c["profile.calibrated"] == 1 and c["profile.probe.dispatches"] >= 2
    assert k1.closure.launches >= c["profile.probe.dispatches"]
    fp = prof.fingerprint
    assert (fp["platform"], fp["device_kind"]) == ("cuda", torch.cuda.get_device_name(cuda))
    mem_mb = torch.cuda.get_device_properties(cuda).total_memory * 0.25 / 1e6
    assert prof.measured_value("sparse_device_mem_mb") == mem_mb
    for name in ("sched_host_unit", "sched_device_fixed", "analysis_host_work", "diff_host_work"):
        assert prof.measured_value(name) is not None, name
    # The slope, measured or (no sound round) seeded, below the host unit.
    assert prof.constants["sched_device_unit"]["value"] < prof.measured_value("sched_host_unit")
    assert 1_000 < prof.measured_value("analysis_host_work") < 100_000_000
    assert prof.calibration_wall_s < pp.profile_budget_s() + 2.0

    pp.reset_active_profile()
    k1.closure.launches = 0
    again, c = _counters(lambda: pp.ensure_calibrated(cuda))
    assert again.key == prof.key and again.constants == prof.constants
    assert c["profile.loaded"] == 1 and not c.get("profile.probe.dispatches") and k1.closure.launches == 0


@pytest.mark.cuda
def test_backend_on_the_card_routes_by_its_profile(cuda, prof_env, tmp_path):
    prof = pp.ensure_calibrated(cuda)
    d = write_case_study("ZK-1270-racing-sent-flag", 16, 0, str(tmp_path / "corpus"))
    backend = TorchBackend(device=cuda, diff_host_work=0)
    backend.init_graph_db("", load_output(d))
    assert backend.analysis_host_work == int(prof.measured_value("analysis_host_work"))
    assert backend.sparse_device_mem_bytes == int(prof.measured_value("sparse_device_mem_mb") * 1e6)
    assert backend.diff_host_work == 0
    rows = {r["name"]: r for r in pp.constant_sources(cuda, backend.profile_args())}
    assert rows["diff_host_work"]["source"] == "arg" and rows["analysis_host_work"]["source"] == "measured"
