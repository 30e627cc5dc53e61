"""The port's run-axis mesh (nemo_tpu_torch/parallel/mesh.py) against the
JAX package, on the CPU.

Widths above 1 run in spawned gloo worlds of the port (tests/torch_world.py:
no JAX in the children, a timeout on every world and group); width 1 runs
in this process on a one-rank group.  Every output is bool or int, so every
comparison is exact:

  * analysis_step_sharded against JAX's unsharded step and JAX's sharded
    step at the same width, on a batch that divides the mesh and one that
    does not, with and without the packed summary;
  * TorchExecutor's sharded fused and sparse_fused dispatches against the
    unsharded ones (and sparse_fused against JAX's sparse step), on a
    batch that divides the mesh and one that does not;
  * report trees byte-equal to the JAX package's at widths 1, 2 and 4
    (dense and sparse_device forced, max_batch 3, the JAX side on its
    default 8-device sharding), and with giant_impl="device" at giant_v 64
    on the deep corpus (the node-sharded giant step);
  * a world whose routes could differ by rank (NEMO_SCHED or the platform
    profile on) raising before its first collective;
  * the knob's validation, the bucketizer's shard multiple and the pad
    counter, and a process outside a group keeping its routes and report.

A test that opens the one-rank group in this process closes it after
(``_no_group_left``), so that no other test finds itself inside a group.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.models import pipeline_model as jpm
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu.ops import sparse_device as jsd
from nemo_tpu.parallel import mesh as jmesh
from nemo_tpu_torch import obs
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend, TorchExecutor
from nemo_tpu_torch.graphs.packed import _pad_run_axis
from nemo_tpu_torch.models.pipeline_model import batch_from_numpy
from nemo_tpu_torch.parallel import mesh

from torch_world import Worlds

FIELDS = jpm.BatchArrays.FIELDS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    mesh.close_local_group()


@pytest.fixture(scope="module")
def worlds():
    w = Worlds()
    yield w
    w.close()


def _batch(n_runs: int):
    pre, post, static = jpm.synth_batch_arrays(n_runs=n_runs, seed=2)
    return ({f: np.asarray(getattr(pre, f)) for f in FIELDS}, {f: np.asarray(getattr(post, f)) for f in FIELDS},
            static, pre, post)


def _same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{what}: {k}")


def _port_sharded(worlds, width: int, pre: dict, post: dict, static: dict) -> list[dict]:
    if width == 1:
        m = mesh.run_mesh(1, "cpu")
        return [mesh.analysis_step_sharded(m, batch_from_numpy(pre, "cpu"), batch_from_numpy(post, "cpu"), static)]
    return worlds[width].run("sharded_step", pre, post, static)


@pytest.mark.parametrize("pack_out", [0, 1])
@pytest.mark.parametrize("n_runs", [6, 5])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_sharded_step_matches_jax(worlds, width, n_runs, pack_out):
    """Every rank's outputs of the whole batch equal JAX's unsharded step
    and JAX's step sharded over as many virtual devices; 5 and 6 runs leave
    a mesh of 2 or 4 with padding rows."""
    pre, post, static, jpre, jpost = _batch(n_runs)
    static = dict(static, with_diff=True, pack_out=pack_out)
    want = {k: np.asarray(v) for k, v in jpm.analysis_step(jpre, jpost, **{**static, "pack_out": False}).items()}
    if not pack_out:  # (JAX's own tests hold its packed sharded step)
        jax_sharded = jmesh.analysis_step_sharded(jmesh.make_run_mesh(width), jpre, jpost, static)
        _same(jax_sharded, want, "JAX sharded vs unsharded")
    for rank, got in enumerate(_port_sharded(worlds, width, pre, post, static)):
        _same(got, want, f"width {width}, rank {rank}")


SPARSE_PARAMS = ("v", "pre_tid", "post_tid", "num_tables", "comp_linear")


@pytest.mark.parametrize("n_runs", [6, 5])
@pytest.mark.parametrize("verb", ["fused", "sparse_fused"])
@pytest.mark.parametrize("width", [2, 4])
def test_executor_sharded_matches_unsharded(worlds, width, verb, n_runs):
    """TorchExecutor.run(verb) with the mesh on, every rank, equals the
    unsharded dispatch (padding shed, the packed summary unpacked, the
    ON_DEVICE planes gathered), one sharded dispatch each; sparse_fused also
    equals JAX's sparse step, key by key.  6 runs leave a mesh of 4 with
    padding rows, 5 runs a mesh of 2 or 4."""
    pre, post, static, jpre, jpost = _batch(n_runs)
    arrays = {f"{c}_{f}": x[f] for c, x in (("pre", pre), ("post", post)) for f in FIELDS}
    params = dict(static, with_diff=1, comp_linear=0)
    if verb == "sparse_fused":
        params = {k: params[k] for k in SPARSE_PARAMS}
    base = TorchExecutor("cpu").run(verb, dict(arrays), dict(params))
    base = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in base.items()}
    if verb == "sparse_fused":
        want = jsd.sparse_device_step(jpre, jpost, wave_impl="xla", **{k: params[k] for k in SPARSE_PARAMS})
        _same(base, {k: np.asarray(v) for k, v in want.items()}, "unsharded sparse_fused vs JAX")
    for rank, got in enumerate(worlds[width].run("executor_verb", verb, arrays, params)):
        _same(got["out"], base, f"{verb}, width {width}, rank {rank}")
        assert got["out"]["pre_holds"].shape[0] == n_runs and got["sharded"] == 1


def test_knobs_validate():
    assert mesh.parse_shard("auto") == "auto"
    for on in ("1", "true", "yes", "on", 1, True):
        assert mesh.parse_shard(on) == "on"
    for off in ("0", "false", "no", "off", 0, False):
        assert mesh.parse_shard(off) == "off"
    for bad in ("junk", "", "2"):
        with pytest.raises(ValueError):
            mesh.parse_shard(bad)
    for kw in ({"shard": "junk"}, {"giant_impl": "dense"}, {"max_batch": 0}, {"max_batch": "3"}):
        with pytest.raises(ValueError):
            TorchBackend(device="cpu", **kw)
    with pytest.raises(ValueError):
        TorchExecutor("cpu", shard="maybe")


def test_shard_plan_in_one_process():
    """In a world of one rank: auto never places, on places at width 1, off
    never; a wider mesh raises."""
    assert mesh.shard_plan("off") == (False, 1)
    assert mesh.shard_plan("auto") == (False, 1)
    assert mesh.shard_plan("on") == (True, 1)
    assert mesh.shard_device_count("on") == 1 and mesh.shard_device_count("auto") == 1
    with pytest.raises(ValueError):
        mesh.device_grid(2)
    with pytest.raises(ValueError):
        mesh.device_grid(1, (2, 1))


def test_shard_multiple_folds_into_bucketizer():
    """As the JAX package's: the run-axis pad rounds up to the mesh width,
    so place_rows pads (and counts analysis.shard.pad_copies) only a batch
    the bucketizer did not fold."""
    from nemo_tpu.graphs.packed import _pad_run_axis as jax_pad

    for args in ((3, None, 1), (3, 3, 1), (3, 3, 8), (10, None, 4), (12, 12, 8), (5, 3, 2)):
        assert _pad_run_axis(*args) == jax_pad(*args), args
    m = mesh.run_mesh(1, "cpu")
    arrays = {"x": np.ones((8, 3), dtype=np.int32), "stub": np.zeros((1, 1), dtype=np.int32)}
    before = obs.metrics.snapshot()["counters"].get("analysis.shard.pad_copies", 0)
    local, b_pad = mesh.place_rows(m, arrays, 8, "cpu")
    assert b_pad == 8 and local["x"].shape == (8, 3) and local["stub"].shape == (1, 1)
    assert obs.metrics.snapshot()["counters"].get("analysis.shard.pad_copies", 0) == before


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mesh"))
    return {
        "synth": write_corpus(SynthSpec(n_runs=8, seed=2, eot=6), root),
        "deep": write_corpus(SynthSpec(n_runs=3, seed=5, eot=60, name="deep"), root),
    }


def _jax_tree(corpus: str, out: str, monkeypatch, **env) -> dict:
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        res = jax_run_debug(corpus, out, JaxBackend(), figures="all")
    return {k: hashlib.sha256(v).hexdigest() for k, v in jax_tree(res.report_dir).items()}


@pytest.mark.parametrize("impl, width", [("dense", 1), ("dense", 2), ("dense", 4), ("sparse_device", 1),
                                         ("sparse_device", 2), ("sparse_device", 4)])
def test_report_tree_matches_jax(worlds, corpora, impl, width, tmp_path, monkeypatch):
    """The dense or the sparse device route forced and max_batch 3 (bucket
    widths that do not divide the mesh): every rank's tree equals the JAX
    package's, every fused dispatch of the route sharded."""
    want = _jax_tree(corpora["synth"], str(tmp_path / "jax"), monkeypatch, NEMO_ANALYSIS_IMPL=impl,
                     NEMO_MAX_BATCH="3")
    verb = "fused" if impl == "dense" else "sparse_fused"
    kw = dict(analysis_impl=impl, max_batch=3, shard="on")
    if width == 1:
        before = obs.metrics.snapshot()
        res = run_debug(corpora["synth"], str(tmp_path / "port"), TorchBackend(device="cpu", **kw), figures="all",
                        ingest="python", corpus_cache="off", result_cache="off")
        counters = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
        ranks = [{"tree": {k: hashlib.sha256(v).hexdigest() for k, v in report_tree_bytes(res.report_dir).items()},
                  "counters": counters}]
    else:
        ranks = worlds[width].run("report", corpora["synth"], str(tmp_path / "port"), kw)
    for r in ranks:
        assert r["tree"] == want
        c = r["counters"]
        assert c["kernel.sharded_dispatches"] == c[f"kernel.dispatches.{verb}"] == 3
        assert c["analysis.shard.gather_bytes"] > 0 and not c.get("analysis.shard.pad_copies")


@pytest.mark.parametrize("width", [2, 4])
def test_giant_device_report_matches_jax(worlds, corpora, width, tmp_path, monkeypatch):
    """giant_impl="device" at giant_v 64 on the deep corpus: the giant runs
    take the node-sharded dense step (route dense, reason giant_impl) on a
    node mesh of the whole world, and the tree equals the JAX package's."""
    want = _jax_tree(corpora["deep"], str(tmp_path / "jax"), monkeypatch, NEMO_GIANT_V="64",
                     NEMO_GIANT_IMPL="device")
    ranks = worlds[width].run("report", corpora["deep"], str(tmp_path / "port"),
                              dict(giant_impl="device", giant_v=64))
    for r in ranks:
        assert r["tree"] == want
        giants = [x for x in r["routes"] if x["verb"] == "giant"]
        assert giants and all((x["route"], x["reason"]) == ("dense", "giant_impl") for x in giants)
        assert r["giant_impl_used"] == "device" and r["counters"]["kernel.dispatches.giant"] == len(giants)


def test_giant_device_report_width_1(corpora, tmp_path, monkeypatch):
    """The same at width 1, in this process, outside any group: the same
    column-blocked step, its collectives the identity."""
    want = _jax_tree(corpora["deep"], str(tmp_path / "jax"), monkeypatch, NEMO_GIANT_V="64")
    be = TorchBackend(device="cpu", giant_impl="device", giant_v=64)
    res = run_debug(corpora["deep"], str(tmp_path / "port"), be, figures="all", ingest="python",
                    corpus_cache="off", result_cache="off")
    assert {k: hashlib.sha256(v).hexdigest() for k, v in report_tree_bytes(res.report_dir).items()} == want
    assert be.giant_impl_used == "device"
    assert {(x["route"], x["reason"]) for x in be.analysis_routes if x["verb"] == "giant"} == {("dense", "giant_impl")}


@pytest.mark.parametrize("env, backend_kw", [
    ({"NEMO_SCHED": "on"}, {"shard": "on"}),
    ({"NEMO_SCHED": "auto"}, {"shard": "auto"}),
    ({"NEMO_PROFILE": "auto"}, {"shard": "auto"}),
    ({"NEMO_SCHED": "on"}, {"shard": "off", "giant_impl": "device"}),
], ids=["sched-on", "sched-auto", "profile-auto", "sched-on-giant-device"])
def test_spmd_world_needs_serial_unprofiled_routes(worlds, corpora, env, backend_kw, tmp_path):
    """In a world of 2, a backend whose dispatches meet in collectives
    raises on every rank, before any dispatch, when its routes could
    follow each rank's own walls or measurements; with both off it runs."""
    for r in worlds[2].run("spmd_guard", corpora["synth"], str(tmp_path / "bad"), env, backend_kw):
        assert "same routes on every rank" in r
    ok = worlds[2].run("spmd_guard", corpora["synth"], str(tmp_path / "ok"), {"NEMO_SCHED": "off"},
                       {"shard": "off", "giant_impl": "sparse_device"} if "giant_impl" in backend_kw else backend_kw)
    assert ok == ["", ""]


@pytest.mark.parametrize("backend_kw", [{"shard": "on"}, {"shard": "off", "giant_impl": "device"}],
                         ids=["shard-on", "giant-device"])
def test_spmd_world_with_one_rank_cached_raises_at_once(worlds, corpora, backend_kw, tmp_path):
    """Two ranks, and only rank 0's result cache holds the report: rank 0
    would restore it and skip the collectives rank 1 waits in, for the
    group's timeout.  Both ranks raise before the lookup instead, naming
    the flag that turns the cache off; with the cache off both run."""
    cc0, rc0 = str(tmp_path / "cc0"), str(tmp_path / "rc0")
    warm = run_debug(corpora["synth"], str(tmp_path / "warm"), TorchBackend(device="cpu"), figures="none",
                     corpus_cache=cc0, result_cache=rc0)
    assert warm.result_cache["state"] == "computed"
    again = run_debug(corpora["synth"], str(tmp_path / "again"), TorchBackend(device="cpu"), figures="none",
                      corpus_cache=cc0, result_cache=rc0)
    assert again.result_cache["state"] == "report_hit"
    caches = [(cc0, rc0), (str(tmp_path / "cc1"), str(tmp_path / "rc1"))]
    for r in worlds[2].run("cache_guard", corpora["synth"], str(tmp_path / "bad"), caches, backend_kw):
        assert "--result-cache off" in r["error"] and r["seconds"] < 10, r
    ok = worlds[2].run("cache_guard", corpora["synth"], str(tmp_path / "ok"), [("off", "off")] * 2, backend_kw)
    assert [r["error"] for r in ok] == ["", ""]


def test_outside_a_group_keeps_its_routes(corpora, tmp_path):
    """shard="auto" (the default) in a world of one rank: no mesh, no
    gather, the same routes and tree as shard="off"."""
    assert not torch.distributed.is_initialized()
    trees, routes = [], []
    for shard in ("auto", "off"):
        before = obs.metrics.snapshot()
        be = TorchBackend(device="cpu", shard=shard)
        res = run_debug(corpora["synth"], str(tmp_path / shard), be, figures="all", ingest="python",
                        corpus_cache="off", result_cache="off")
        c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
        assert not any(k.startswith(("kernel.sharded", "analysis.shard.")) for k in c)
        trees.append(report_tree_bytes(res.report_dir))
        routes.append(be.analysis_routes)
    assert trees[0] == trees[1] and routes[0] == routes[1]
    assert TorchBackend(device="cpu").giant_impl == "auto"
    assert os.environ.get("WORLD_SIZE") is None
