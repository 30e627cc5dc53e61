"""Multi-process scale-out: torch.distributed init and the hybrid
(dcn, ici) step.

Port of the JAX package's ``parallel/distributed.py``.  Every process runs
the same program (SPMD); ``init_distributed`` wires them into one
process group, and the run batch is split over a 2-D (dcn, ici) mesh: the
outer axis spans hosts over the data-center network, the inner axis each
host's ranks.  The prototype reductions run hierarchically (inner axis
first, then one exchange along the outer); per-run kernels never
communicate.

Configuration comes from the arguments or torch's own environment, as
torchrun sets it (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), in place of the reference's ``JAX_*``
variables.  A single process is left untouched, so calling it is always
safe.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist

from .mesh import (  # noqa: F401  (make_hybrid_mesh re-export)
    DCN_AXIS,
    GROUP_TIMEOUT_S,
    ICI_AXIS,
    Mesh,
    local_group_open,
    make_hybrid_mesh,
    rank_device,
    run_step_sharded,
    world_size,
)


def init_distributed(
    init_method: str | None = None,
    world: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device=None,
    timeout_s: float = GROUP_TIMEOUT_S,
) -> bool:
    """Join the multi-process runtime when configured; returns whether a
    world of more than one rank is active.

    ``init_method`` is a torch.distributed address (``tcp://host:port``,
    ``file://path``); without it, ``MASTER_ADDR`` and ``MASTER_PORT`` make
    ``tcp://MASTER_ADDR:MASTER_PORT``.  ``world`` and ``rank`` default to
    ``WORLD_SIZE`` and ``RANK``.  Nothing configured: a single process,
    nothing done.  Half a configuration (an address without a world size,
    or the reverse) warns and stays single-process.

    ``backend`` is the process group's: NCCL for a card and gloo for the
    CPU by default (``device``: "cpu" or a card, as rank_device reads it).
    Gloo on a card only when asked, for ranks that share one card; its
    collectives then stage through host tensors.  Every group gets
    ``timeout_s``.  A failed init raises, and so does a configured world
    in a process that already holds the one-rank group of
    ``shard="on"`` (mesh.py:open_local_group): joining it would be
    skipped, and this rank would run alone."""
    if init_method is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    env_world = os.environ.get("WORLD_SIZE")
    world = world if world is not None else (int(env_world) if env_world else None)
    env_rank = os.environ.get("RANK")
    rank = rank if rank is not None else (int(env_rank) if env_rank else None)
    if init_method is None and world is None:
        return world_size() > 1  # single process: nothing to initialize
    if init_method is None or world is None:
        # A stray half configuration (a shared env file exporting only one
        # of the two) must not crash a plain single-process run.
        have, need = ("an address", "WORLD_SIZE") if init_method else ("WORLD_SIZE", "an address")
        warnings.warn(f"{have} set without {need}; ignoring and staying single-process", stacklevel=2)
        return world_size() > 1
    if local_group_open():
        raise RuntimeError(
            f"a world of {world} ranks is configured, but this process already holds the one-rank group that "
            "shard='on' opened: call init_distributed before the first sharded dispatch"
        )
    if dist.is_initialized():
        return world_size() > 1
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world,
        rank=rank if rank is not None else 0,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return world_size() > 1


def analysis_step_hybrid(mesh: Mesh, pre, post, static: dict) -> dict:
    """The fused step with the run batch data-parallel over BOTH axes of a
    (dcn, ici) mesh (runs split across hosts, then across each host's
    ranks): parallel/mesh.py:analysis_step_sharded on the 2-D layout, whose
    prototype reduction runs along the inner axis first."""
    return run_step_sharded(mesh, pre, post, static)
