"""The scheduler's lanes launching at once on a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sched_cuda.py

* two threads launching K1 and K2 at once lose no launch count, and every
  launch's output equals the plain version's;
* a real out-of-memory on the card is a lane failure, and a kernel's own
  error type is not; a card's scheduler raises it, the host never running
  the job;
* a report of several buckets drained by the threaded scheduler on cuda
  equals the serial one, byte for byte, with every job on the card's lanes
  recorded and no failover.
"""

import numpy as np
import pytest
import torch

from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.kernels import edge_wave as k2
from nemo_tpu_torch.kernels.build import KernelError
from nemo_tpu_torch.parallel import sched


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_launching_threads_lose_no_count(cuda):
    import threading

    rng = np.random.default_rng(0)
    adj = torch.from_numpy(rng.random((64, 64, 64)) < 2.0 / 64).to(cuda)
    state = torch.from_numpy(rng.random((128, 256)) < 0.05).to(cuda)
    src = torch.from_numpy(rng.integers(0, 256, (128, 256), dtype=np.int32)).to(cuda)
    dst = torch.from_numpy(rng.integers(0, 256, (128, 256), dtype=np.int32)).to(cuda)
    mask = torch.ones((128, 256), dtype=torch.bool, device=cuda)
    want_c, want_w = k1.closure_plain(adj), k2.edge_wave_plain(state, src, dst, mask)
    n = 200
    bad = []

    def launch(kernel):
        for _ in range(n):
            got = k1.closure(adj) if kernel == "closure" else k2.edge_wave(state, src, dst, mask)
            if not torch.equal(got, want_c if kernel == "closure" else want_w):
                bad.append(kernel)

    before = (k1.closure.launches, k2.edge_wave.launches)
    threads = [threading.Thread(target=launch, args=(k,)) for k in ("closure", "edge_wave", "closure", "edge_wave")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads) and not bad
    assert (k1.closure.launches - before[0], k2.edge_wave.launches - before[1]) == (2 * n, 2 * n)


@pytest.mark.cuda
def test_card_out_of_memory_is_a_lane_failure(cuda):
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda)
    assert sched.is_lane_failure(info.value)
    assert not sched.is_lane_failure(KernelError("closure kernel failed: out of memory (cudaError 2)"))


@pytest.mark.cuda
def test_card_out_of_memory_is_raised_never_run_on_the_host(cuda):
    lanes = []

    def execute(lane, reason, stolen):
        lanes.append(lane)
        if lane != "host":
            torch.empty(1 << 50, dtype=torch.uint8, device=cuda)
        return lane

    job = sched.Job(index=0, verb="fused", rows=4000, v=64, e=256, work=4000 * 320, execute=execute)
    models = {"device": sched.LaneModel(0.0, 1e-9), "host": sched.LaneModel(0.0, 1e-6)}
    s = sched.HeterogeneousScheduler(models, device=cuda)
    s.breaker = sched.CircuitBreaker(failures=99, cooldown_s=1000)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        s.run([job], serial=True)
    assert lanes == ["device"] and s.failovers == 0


@pytest.mark.cuda
def test_threaded_report_equals_serial_on_the_card(cuda, tmp_path, monkeypatch):
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    corpus = write_corpus(SynthSpec(n_runs=300, seed=6, eot=40, name="mix"), str(tmp_path / "c"))
    trees = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("NEMO_SCHED", mode)
        sched.reset_session_models(cuda)
        res = run_debug(corpus, str(tmp_path / mode), TorchBackend(device="cuda", analysis_host_work=20_000),
                        figures="failed", corpus_cache="off", result_cache="off")
        trees[mode] = report_tree_bytes(res.report_dir)
    assert trees["on"] == trees["off"]
    records = sched.sched_snapshot(cuda)
    assert records and not any(r["failed_over"] for r in records)
    assert {r["lane"] for r in records} <= set(sched.LANES)
