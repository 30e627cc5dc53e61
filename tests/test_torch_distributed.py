"""torch.distributed init and the hybrid (dcn, ici) step
(nemo_tpu_torch/parallel/distributed.py) on the CPU.

init_distributed: a single process is left alone, half a configuration
warns and stays single-process, a configured world raises in a process
that holds shard="on"'s one-rank group, a spawned gloo world joins through it
(tests/torch_world.py starts every world that way).  analysis_step_hybrid
over (dcn, ici) meshes of 2 and 4 ranks equals the JAX package's unsharded
step and its hybrid step on as many virtual devices, exactly; a grid that
does not cover the world raises.
"""

import warnings

import numpy as np
import pytest
import torch.distributed as dist

from nemo_tpu.models import pipeline_model as jpm
from nemo_tpu.parallel import distributed as jdist
from nemo_tpu_torch.parallel import distributed, mesh

from torch_world import Worlds

FIELDS = jpm.BatchArrays.FIELDS


@pytest.fixture(scope="module")
def worlds():
    w = Worlds()
    yield w
    w.close()


def test_single_process_is_left_alone(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    initialized = dist.is_initialized()
    assert distributed.init_distributed() is False
    assert dist.is_initialized() == initialized


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"MASTER_ADDR": "localhost", "MASTER_PORT": "1"}])
def test_half_configuration_warns(monkeypatch, env):
    # As a process outside any group (this one may hold a one-rank group).
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    init = []
    monkeypatch.setattr(distributed.dist, "init_process_group", lambda *a, **k: init.append(a))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert distributed.init_distributed() is False
    assert any("single-process" in str(w.message) for w in caught)
    assert not init


def test_world_after_the_local_group_raises(tmp_path):
    """A world configured after shard="on" opened its one-rank group would
    be skipped: init_distributed raises instead, and the group closes."""
    assert not dist.is_initialized()
    mesh.open_local_group("cpu")
    try:
        assert mesh.local_group_open()
        with pytest.raises(RuntimeError, match="one-rank group"):
            distributed.init_distributed(init_method=f"file://{tmp_path / 'rdv'}", world=2, rank=0, device="cpu")
        assert distributed.init_distributed() is False
    finally:
        mesh.close_local_group()
    assert not dist.is_initialized() and not mesh.local_group_open()


def test_rank_device(monkeypatch):
    assert mesh.rank_device("cpu").type == "cpu"
    monkeypatch.setenv("LOCAL_RANK", "3")
    dev = mesh.rank_device()
    assert dev.type == "cuda" and dev.index == 3 % max(1, __import__("torch").cuda.device_count())


@pytest.mark.parametrize("width, grid", [(2, (2, 1)), (2, (1, 2)), (4, (2, 2)), (4, (1, 4))])
def test_hybrid_step_matches_jax(worlds, width, grid):
    pre, post, static = jpm.synth_batch_arrays(n_runs=7, seed=3)
    static = dict(static, with_diff=True, pack_out=True)
    want = {k: np.asarray(v) for k, v in jpm.analysis_step(pre, post, **{**static, "pack_out": False}).items()}
    jax_got = jdist.analysis_step_hybrid(jdist.make_hybrid_mesh(*grid), pre, post, static)
    p = {f: np.asarray(getattr(pre, f)) for f in FIELDS}
    q = {f: np.asarray(getattr(post, f)) for f in FIELDS}
    for rank, got in enumerate(worlds[width].run("sharded_step", p, q, static, hybrid=grid)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{grid}, rank {rank}: {k}")
            np.testing.assert_array_equal(np.asarray(jax_got[k]), want[k], err_msg=f"JAX {grid}: {k}")


def test_world_ranks_and_bad_grids(worlds):
    for rank, got in enumerate(worlds[2].run("world_checks")):
        assert got == {"world": 2, "rank": rank, "hybrid": (1, 2), "too_wide": True, "bad_grid": True,
                       "narrow": True}
