"""A spawned gloo world of the port for the CPU tests, and the SPMD tasks
its ranks run.

``World(n)`` starts n child processes (the ``spawn`` start method: no
JAX, nothing of the parent's state), joined into one gloo process group
by ``parallel/distributed.py:init_distributed`` over a ``file://`` address,
every group with a timeout.  ``World.run(task, *args)`` sends one task of
this module to every rank and returns the ranks' results in rank order;
a rank's error is raised with its traceback, and a world that does not
answer within its timeout is killed and raises.  This module imports
nothing of the JAX package: the children import it to find their tasks.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import queue
import sys
import tempfile
import traceback

import numpy as np

#: Seconds a world may take to start, or to answer one task.
WORLD_TIMEOUT_S = 60.0


class World:
    def __init__(self, n: int, timeout_s: float = WORLD_TIMEOUT_S) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="torch_world_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._inbox = [ctx.Queue() for _ in range(n)]
        self._outbox = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, args=(r, n, init, self._inbox[r], self._outbox, timeout_s), daemon=True)
            for r in range(n)
        ]
        for p in self._procs:
            p.start()
        ready = self._collect("start")
        if any(ready):
            self.close()
            raise AssertionError("a rank of the world imported jax")

    def _collect(self, what: str) -> list:
        out: list = [None] * self.n
        for _ in range(self.n):
            try:
                rank, ok, value = self._outbox.get(timeout=self.timeout_s)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"the world of {self.n} ranks did not answer {what} in {self.timeout_s} s") from None
            if not ok:
                self.close()
                raise AssertionError(f"rank {rank} failed {what}:\n{value}")
            out[rank] = value
        return out

    def run(self, task: str, *args, **kw) -> list:
        """Task ``task`` of this module on every rank; the results by rank."""
        for box in self._inbox:
            box.put((task, args, kw))
        return self._collect(task)

    def close(self) -> None:
        for box in self._inbox:
            box.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()


def _worker(rank: int, n: int, init: str, inbox, outbox, timeout_s: float) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ.update(NEMO_SVG_CACHE="off", NEMO_CORPUS_CACHE="off", NEMO_RESULT_CACHE="off", NEMO_PROFILE="off",
                      NEMO_SCHED="off")
    try:
        from nemo_tpu_torch.parallel.distributed import init_distributed

        init_distributed(init_method=init, world=n, rank=rank, device="cpu", timeout_s=timeout_s)
        outbox.put((rank, True, "jax" in sys.modules))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    module = importlib.import_module(__name__)
    while True:
        msg = inbox.get()
        if msg is None:
            break
        task, args, kw = msg
        try:
            outbox.put((rank, True, getattr(module, task)(*args, **kw)))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tasks (run on every rank)
# ---------------------------------------------------------------------------


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v) for k, v in out.items()}


def sharded_step(pre: dict, post: dict, static: dict, hybrid: tuple | None = None) -> dict:
    """analysis_step_sharded over the world's run mesh, or with ``hybrid``
    (dcn, ici) analysis_step_hybrid over that 2-D mesh."""
    from nemo_tpu_torch.models.pipeline_model import batch_from_numpy
    from nemo_tpu_torch.parallel import distributed, mesh

    p, q = batch_from_numpy(pre, "cpu"), batch_from_numpy(post, "cpu")
    if hybrid is None:
        return mesh.analysis_step_sharded(mesh.make_run_mesh(), p, q, static)
    return distributed.analysis_step_hybrid(mesh.make_hybrid_mesh(*hybrid), p, q, static)


def executor_verb(verb: str, arrays: dict, params: dict) -> dict:
    """One dispatch of a sharded verb (fused, sparse_fused) of TorchExecutor
    with the mesh forced on, and the sharded-dispatch count it added."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.backend.torch_backend import TorchExecutor

    before = obs.metrics.snapshot()
    out = _numpy(TorchExecutor("cpu", shard="on").run(verb, arrays, params))
    counters = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    return {"out": out, "sharded": counters.get("kernel.sharded_dispatches", 0)}


def spmd_guard(corpus: str, root: str, env: dict, backend_kw: dict) -> str:
    """run_debug under ``env`` (NEMO_SCHED / NEMO_PROFILE) with a backend
    whose dispatches meet in collectives: the error it raises, or "" if it
    ran."""
    import torch.distributed as dist

    from nemo_tpu_torch.analysis.pipeline import run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        run_debug(corpus, os.path.join(root, f"rank{dist.get_rank()}"), TorchBackend(device="cpu", **backend_kw),
                  figures="none", corpus_cache="off", result_cache="off")
        return ""
    except RuntimeError as e:
        return str(e)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cache_guard(corpus: str, root: str, caches: list, backend_kw: dict) -> dict:
    """run_debug with this rank's own corpus store and result cache
    (``caches[rank]``: (corpus cache, result cache)) and a backend whose
    dispatches meet in collectives: the error it raises ("" if it ran) and
    the seconds it took."""
    import time

    import torch.distributed as dist

    from nemo_tpu_torch.analysis.pipeline import run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    cc, rc = caches[dist.get_rank()]
    t = time.perf_counter()
    try:
        run_debug(corpus, os.path.join(root, f"rank{dist.get_rank()}"), TorchBackend(device="cpu", **backend_kw),
                  figures="none", corpus_cache=cc, result_cache=rc)
        err = ""
    except RuntimeError as e:
        err = str(e)
    return {"error": err, "seconds": time.perf_counter() - t}


def ring(adj: np.ndarray, start: np.ndarray, steps: int) -> tuple:
    """ring_reach and closure_sharded over the world's node mesh."""
    import torch

    from nemo_tpu_torch.parallel import ring

    m = ring.make_node_mesh()
    a, s = torch.from_numpy(adj), torch.from_numpy(start)
    return ring.ring_reach(m, a, s, steps).numpy(), ring.closure_sharded(m, a).numpy()


def giant(pre: dict, post: dict, kw: dict) -> dict:
    """giant_analysis_step on the default node mesh, its contracted edge
    lists densified (CsrAdjRows) to the reference's [1,V,V] planes."""
    from nemo_tpu_torch.models.pipeline_model import batch_from_numpy
    from nemo_tpu_torch.ops.sparse_device import CsrAdjRows
    from nemo_tpu_torch.parallel.giant import default_node_mesh, giant_analysis_step

    v = kw["v"]
    out = _numpy(giant_analysis_step(batch_from_numpy(pre, "cpu"), batch_from_numpy(post, "cpu"), **kw))
    for c in ("pre", "post"):
        src, dst, mask = (out.pop(f"{c}_clean_{k}") for k in ("src", "dst", "mask"))
        out[f"{c}_adj_clean"] = CsrAdjRows(src, dst, mask, v=v)[np.array([0])]
    out["mesh_size"] = default_node_mesh(v).size
    return out


def report(corpus: str, root: str, backend_kw: dict, figures: str = "all", ingest: str = "python") -> dict:
    """run_debug over TorchBackend on the CPU, into this rank's own
    directory: relpath -> sha256 of every deterministic report file, and
    the backend's route records."""
    import torch.distributed as dist

    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch import obs

    before = obs.metrics.snapshot()
    be = TorchBackend(device="cpu", **backend_kw)
    res = run_debug(corpus, os.path.join(root, f"rank{dist.get_rank()}"), be, figures=figures, ingest=ingest,
                    corpus_cache="off", result_cache="off")
    tree = {k: hashlib.sha256(v).hexdigest() for k, v in report_tree_bytes(res.report_dir).items()}
    counters = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    return {"tree": tree, "routes": be.analysis_routes, "giant_impl_used": be.giant_impl_used,
            "counters": {k: v for k, v in counters.items() if k.startswith(("kernel.", "analysis.shard."))}}


class Worlds:
    """Worlds by width, each started on first use and kept until close():
    one module-scoped world serves every check of its width."""

    def __init__(self) -> None:
        self._worlds: dict[int, World] = {}

    def __getitem__(self, n: int) -> World:
        if n not in self._worlds:
            self._worlds[n] = World(n)
        return self._worlds[n]

    def close(self) -> None:
        for w in self._worlds.values():
            w.close()
        self._worlds.clear()


def world_checks() -> dict:
    """A rank's view of the world and the meshes that must raise."""
    from nemo_tpu_torch.parallel import mesh

    def raises(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    return {
        "world": mesh.world_size(),
        "rank": mesh.world_rank(),
        "hybrid": mesh.make_hybrid_mesh().devices.shape,
        "too_wide": raises(lambda: mesh.make_run_mesh(4)),
        "bad_grid": raises(lambda: mesh.make_hybrid_mesh(3)),
        "narrow": raises(lambda: mesh.make_run_mesh(1)),
    }
