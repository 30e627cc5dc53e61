"""The fleet on a CUDA card (marker ``cuda``): two spawned replicas, each a
``Loopback("cuda")`` with a result cache of its own, one shared tier
between them (chip_smoke.py:fleet_replica, as phase 6p spawns them).  They
skip without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py

* a cold herd of two AnalyzeDir requests released at one barrier: one
  ``nemo-fleet`` leader, one follower, byte-identical responses, K1
  launched in the leader's process only.
"""

import os

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_spawned_cuda_replicas_run_one_analysis(cuda, tmp_path):
    from chip_smoke import FleetChild
    from nemo_tpu_torch.models.case_studies import write_case_study
    from nemo_tpu_torch.query.engine import ingest_corpus

    d = write_case_study("ZK-1270-racing-sent-flag", 200, 0, str(tmp_path / "corpora"))
    cc = str(tmp_path / "corpus-cache")
    ingest_corpus(d, cc)
    ctx = torch.multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    base = {"NEMO_CORPUS_CACHE": cc, "NEMO_RCACHE_SHARED": str(tmp_path / "shared"), "NEMO_LEASE_TTL_S": "5",
            "NEMO_FLIGHT": "off", "NEMO_PROFILE": "off"}
    children = [FleetChild(ctx, f"replica-{i}", "cuda", dict(base, NEMO_RESULT_CACHE=str(tmp_path / f"rc-{i}")),
                           barrier) for i in range(2)]
    try:
        for c in children:
            c.get()
        for c in children:
            c.send("analyze", d, True)
        res = {c.name: c.get() for c in children}
    finally:
        for c in children:
            c.stop()
    roles = {n: r["trailing"].get("nemo-fleet") for n, r in res.items()}
    assert sorted(roles.values()) == ["follower", "leader"], roles
    leader, follower = (next(r for n, r in res.items() if roles[n] == role) for role in ("leader", "follower"))
    assert leader["payload"] == follower["payload"]
    assert leader["launches"]["closure"] > 0
    assert follower["launches"] == {"closure": 0, "edge_wave": 0}
    assert [r["counters"].get("serve.analyze_chunks", 0) for r in (leader, follower)] == [1, 0]
    assert os.path.isdir(tmp_path / "shared" / "blob_analyze_dir")
