"""Device topology and run-axis sharding on torch.distributed: THE mesh
module.

Port of the JAX package's ``parallel/mesh.py``.  The run axis is the
data-parallel axis (SURVEY.md §2.3): a bucket's packed run batch is split
into equal row blocks, one per rank; every rank runs the fused step on its
own block, kernels K1 and K2 included, and the cross-run pieces come
together in collectives: the prototype intersection and union in one
all-reduce, the row-0 good run in one broadcast when the diff tail is on,
and the summary in one all-gather a bucket.

A mesh is one rank per device, over the default process group.  A rank's
device is ``cuda:<LOCAL_RANK % device_count>``, or the CPU when the caller
asks for it (``rank_device``).  Every mesh spans the whole world: a
torch.distributed world is one program on every rank (SPMD), so a rank
outside the mesh would hold none of its results.  Every mesh this repo
builds (``make_run_mesh`` for the sharded fused dispatches,
``make_node_mesh`` for the giant step and the ring, ``make_hybrid_mesh``
for the (dcn, ici) grid) takes its ranks from ``device_grid``.

Collectives run on the world group, and along a 2-D mesh's axes on its row
and column groups.  On a gloo group a CUDA tensor is staged through host
memory (gloo has no CUDA all-gather or send/recv): that is how two ranks
share one card.

The sharding policy is the reference's, with the knob as an argument
(``TorchBackend(shard=...)``): ``auto`` places only when more than one
rank exists, ``on`` places even on one (opening a one-rank group when the
process has none), ``off`` never.  The reference's device cap has no
counterpart: a mesh that spans the world cannot be capped.

Outside a process group a mesh has one rank and its collectives are
identities, so the mesh code runs unchanged in a single process (the
giant step at width 1).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from nemo_tpu_torch import obs

RUN_AXIS = "run"
NODE_AXIS = "node"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"

#: Seconds a collective of a group this module opens waits for its peers
#: before it raises: a rank that dispatches where another does not fails
#: instead of hanging.
GROUP_TIMEOUT_S = 300.0

#: Outputs that are reductions over the run axis, not per-run rows.
CORPUS_LEVEL = frozenset({"proto_inter", "proto_union"})


def world_size() -> int:
    """Ranks of the default process group; 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group; 0 outside one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` names it, else
    ``cuda:<LOCAL_RANK % device_count>`` (LOCAL_RANK as torchrun sets it,
    0 when unset)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


#: The default group open_local_group opened, while it is open.
_LOCAL_GROUP: list = [None]


def open_local_group(device=None) -> None:
    """A one-rank default process group for a process that has none (NCCL
    for a card, gloo for the CPU), so that a width-1 mesh dispatches the
    mesh code path, its collectives included.  Its store is in-process:
    nothing is contacted.  It stays open until close_local_group."""
    if dist.is_initialized():
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if cuda else "gloo",
        store=dist.HashStore(),
        rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    _LOCAL_GROUP[0] = _default_group()


def local_group_open() -> bool:
    """Whether the default group is the one-rank group open_local_group
    opened."""
    return _LOCAL_GROUP[0] is not None and _LOCAL_GROUP[0] is _default_group()


def close_local_group() -> None:
    """Destroy the one-rank group open_local_group opened, if it is the
    default group, and forget the meshes built on it."""
    if local_group_open():
        dist.destroy_process_group()
    _LOCAL_GROUP[0] = None
    _RUN_MESH_CACHE.clear()
    _HYBRID_CACHE.clear()


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of the default group takes: bool as uint8,
    and host memory for a CUDA tensor on a group with no NCCL."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_cuda and "nccl" not in str(dist.get_backend()).lower():
        t = t.cpu()
    return t.contiguous()


def _restored(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


class Mesh:
    """A grid of the world's ranks with named axes.  ``devices`` is the grid
    of global ranks (the reference's device array); ``index`` is this
    rank's place in it, flattened row-major; ``axis_groups`` holds, on a
    2-D mesh, this rank's row group (the inner axis) and column group (the
    outer axis), over which reductions run inner axis first."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, axis_groups: dict | None = None) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.axis_groups = axis_groups or {}
        self.ranks = [int(r) for r in devices.ravel()]
        self.size = len(self.ranks)
        self.index = self.ranks.index(world_rank())

    @property
    def solo(self) -> bool:
        """One rank and no process group: every collective is the
        identity."""
        return self.size == 1 and not dist.is_initialized()

    def block(self, n: int) -> slice:
        """This rank's block of an axis of length n (a multiple of size)."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's [k, ...] tensor -> [size * k, ...], in mesh order."""
        if self.solo:
            return t
        x = _staged(t)
        parts = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(parts, x)
        return _restored(torch.cat([parts[r] for r in self.ranks]), t)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.solo:
            return t
        x = _staged(t)
        if self.axis_groups:
            for name in self.axis_names[::-1]:
                dist.all_reduce(x, op=op, group=self.axis_groups[name])
        else:
            dist.all_reduce(x, op=op)
        return _restored(x, t)

    def any(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise OR of a bool tensor over the mesh."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise MIN of an integer tensor over the mesh."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The first rank's tensor on every rank."""
        if self.solo:
            return t
        x = _staged(t)
        dist.broadcast(x, src=self.ranks[0])
        return _restored(x, t)

    def all_gather_ragged(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's [k_r, ...] tensor, k_r its own -> [sum k_r, ...], in
        mesh order: one all-gather of the counts, one of the rows padded to
        the largest."""
        if self.solo:
            return t
        counts = self.all_gather(torch.tensor([t.shape[0]], device=t.device))
        kmax = int(counts.max())
        buf = t.new_zeros((1, kmax) + tuple(t.shape[1:]))
        buf[0, : t.shape[0]] = t
        got = self.all_gather(buf)
        return got[torch.arange(kmax, device=t.device)[None] < counts[:, None]]

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the previous rank of the ring and return the next
        rank's: one batch_isend_irecv."""
        if self.size == 1:
            return t
        x = _staged(t)
        buf = torch.empty_like(x)
        prev = self.ranks[(self.index - 1) % self.size]
        nxt = self.ranks[(self.index + 1) % self.size]
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, prev), dist.P2POp(dist.irecv, buf, nxt)])
        for req in reqs:
            req.wait()
        return _restored(buf, t)


def device_grid(n_devices: int | None = None, shape: tuple | None = None) -> np.ndarray:
    """The validated rank array every mesh builds on: all ``n_devices``
    ranks of the world (default all), reshaped to ``shape`` (default 1-D).
    Raises, rather than truncating, where the request exceeds the world or
    the grid would drop ranks, and where it leaves ranks of the world out
    (every mesh spans the world)."""
    w = world_size()
    n = n_devices or w
    if n > w:
        raise ValueError(f"need {n} devices, have {w}")
    if n < w:
        raise ValueError(f"a mesh of {n} ranks in a world of {w}: every mesh spans the whole world")
    grid = np.arange(n)
    if shape is not None:
        if int(np.prod(shape)) != n:
            raise ValueError(f"grid shape {shape} does not cover {n} devices")
        grid = grid.reshape(shape)
    return grid


def make_run_mesh(n_devices: int | None = None) -> Mesh:
    """The 1-D run-axis mesh of the sharded fused dispatches."""
    return Mesh(device_grid(n_devices), (RUN_AXIS,))


def make_node_mesh(n_devices: int | None = None) -> Mesh:
    """The 1-D node-axis mesh of the giant step and the ring
    (parallel/giant.py, parallel/ring.py)."""
    return Mesh(device_grid(n_devices), (NODE_AXIS,))


_HYBRID_CACHE: dict[tuple, Mesh] = {}


def make_hybrid_mesh(dcn_size: int | None = None, ici_size: int | None = None) -> Mesh:
    """A 2-D (dcn, ici) mesh: the outer axis across hosts, the inner across
    each host's ranks.  dcn_size defaults to the world over
    ``LOCAL_WORLD_SIZE`` (the ranks of one host, as torchrun sets it; the
    whole world when unset), so each host owns one dcn row of consecutive
    ranks.  Every rank builds every row's and column's group, in one order
    (torch.distributed.new_group is collective); cached per shape."""
    w = world_size()
    if dcn_size is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE") or w)
        dcn_size = w // local if w % local == 0 else 1
    if ici_size is None:
        if w % dcn_size:
            raise ValueError(f"{w} devices not divisible by dcn axis {dcn_size}")
        ici_size = w // dcn_size
    grid = device_grid(dcn_size * ici_size, (dcn_size, ici_size))
    key = (dcn_size, ici_size, id(_default_group()))
    mesh = _HYBRID_CACHE.get(key)
    if mesh is None:
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        me = world_rank()
        groups: dict = {}
        for row in grid:
            g = dist.new_group(ranks=row.tolist(), timeout=timeout)
            if me in row:
                groups[ICI_AXIS] = g
        for col in grid.T:
            g = dist.new_group(ranks=col.tolist(), timeout=timeout)
            if me in col:
                groups[DCN_AXIS] = g
        mesh = _HYBRID_CACHE[key] = Mesh(grid, (DCN_AXIS, ICI_AXIS), groups)
    return mesh


def _default_group():
    return dist.distributed_c10d._get_default_group() if dist.is_initialized() else None


# ---------------------------------------------------------------------------
# the production sharding policy (TorchBackend's shard)
# ---------------------------------------------------------------------------

def parse_shard(value) -> str:
    """The shard knob, in the reference's spellings (auto; 1, true, yes, on;
    0, false, no, off).  Raises on anything else: a typo resolving to auto
    would change how many devices run the corpus."""
    v = str(value).strip().lower()
    if v == "auto":
        return "auto"
    if v in ("1", "true", "yes", "on"):
        return "on"
    if v in ("0", "false", "no", "off"):
        return "off"
    raise ValueError(f"shard={value!r} (expected auto, 1, or 0)")


def shard_plan(shard="auto") -> tuple[bool, int]:
    """The sharding decision: (place_on_mesh, n_devices), the mesh spanning
    the world.  False is the single-device dispatch: no mesh, no padding,
    no collective.  ``on`` places even at one rank (the mesh path kept
    dispatchable); ``auto`` only when more than one rank is there."""
    mode = parse_shard(shard)
    if mode == "off":
        return False, 1
    n = world_size()
    return (n > 1 if mode == "auto" else True), n


def shard_device_count(shard="auto") -> int:
    """Width of the run mesh under this knob: 1 means the single-device
    dispatch."""
    place, n = shard_plan(shard)
    return n if place else 1


_RUN_MESH_CACHE: dict[tuple, Mesh] = {}


def run_mesh(n_devices: int, device=None) -> Mesh:
    """The process-cached run mesh of ``n_devices`` ranks (a one-rank group
    opened for ``device`` where the process has none)."""
    if n_devices == 1:
        open_local_group(device)
    key = (n_devices, id(_default_group()))
    mesh = _RUN_MESH_CACHE.get(key)
    if mesh is None:
        mesh = _RUN_MESH_CACHE[key] = make_run_mesh(n_devices)
    return mesh


# ---------------------------------------------------------------------------
# the sharded step: place rows, run, reduce, gather
# ---------------------------------------------------------------------------


def _rows(a, lo: int, hi: int, b: int, device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of a [b, ...] plane on ``device``; rows at or past b
    are padding, all zero (empty graphs: every mask False, indices 0)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    t = t[lo : min(hi, b)].to(device)
    if hi > b:
        t = torch.cat([t, t.new_zeros((hi - max(lo, b),) + tuple(t.shape[1:]))])
    return t


def place_rows(mesh: Mesh, arrays: dict, b: int, device, with_row0: bool = False) -> tuple[dict, int]:
    """This rank's block of every [b, ...] array of a verb's named arrays,
    on ``device``, the run axis padded to a multiple of the mesh (counted in
    ``analysis.shard.pad_copies``: the bucketizer folds the multiple into
    its own pad, so production batches never need it).  Arrays whose
    leading dim is not the run axis replicate.  With ``with_row0``, the
    ranks past the first put the batch's row 0 (the good run the diff tail
    reads) in front of their block, broadcast from the first rank.
    Returns (local arrays, b_pad)."""
    n = mesh.size
    b_pad = -(-b // n) * n
    if b_pad != b:
        obs.metrics.inc("analysis.shard.pad_copies")
    blk = mesh.block(b_pad)
    dev = torch.device(device)
    out: dict = {}
    for name, a in arrays.items():
        if a is None:
            out[name] = None
        elif np.ndim(a) and a.shape[0] == b:
            out[name] = _rows(a, blk.start, blk.stop, b, dev)
        else:
            out[name] = _rows(a, 0, a.shape[0], a.shape[0], dev) if np.ndim(a) else torch.as_tensor(a, device=dev)
    if with_row0:
        names = [k for k, a in arrays.items() if a is not None and np.ndim(a) and a.shape[0] == b]
        like = [out[k][:1] for k in names]
        got = _byte_split(mesh.broadcast(_byte_cat(like)), like)
        if mesh.index > 0:
            out.update({k: torch.cat([g, out[k]]) for k, g in zip(names, got)})
    return out, b_pad


def pad_place_named_arrays(arrays: dict, b: int, n_devices: int, device=None,
                           with_row0: bool = False) -> tuple[dict, int]:
    """place_rows on the process-cached run mesh of ``n_devices`` ranks:
    the executor-boundary form of the reference's pad_batch_rows +
    shard_arrays.  Returns (this rank's arrays, b_pad)."""
    return place_rows(run_mesh(n_devices, device), arrays, b, device or "cpu", with_row0)


def finish_rows(mesh: Mesh, out: dict, row0_in_front: bool, layout=None) -> dict:
    """This rank's step outputs made the mesh's: the row-0 copy in front
    dropped, proto_inter / proto_union over every rank's rows (one
    all-reduce: AND as NOT-OR-NOT, OR, and whether any run achieved), and
    with ``layout`` the bool summary folded into one ``packed_summary``."""
    from nemo_tpu_torch.models.pipeline_model import fold_packed_summary

    if row0_in_front:
        out = {k: v if k in CORPUS_LEVEL else v[1:] for k, v in out.items()}
    ach, bits = out["achieved_pre"], out["proto_bits"]
    t = bits.shape[-1]
    masked = bits & ach[:, None]
    parts = torch.cat([~(masked | ~ach[:, None]).all(dim=0), masked.any(dim=0), ach.any()[None]])
    r = mesh.any(parts)
    out["proto_inter"] = ~r[:t] & r[-1]
    out["proto_union"] = r[t : 2 * t]
    if layout is not None:
        fold_packed_summary(out, layout)
    return out


def _byte_order(tensors: list[torch.Tensor]) -> list[int]:
    """Widest dtype first: every tensor's bytes then start aligned to its
    element size."""
    return sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())


def _byte_cat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Tensors of any dtypes -> one flat uint8 tensor of their bytes, widest
    dtype first, zero-padded to a multiple of 8 bytes (so that each of a
    gathered [size, k] buffer's rows starts aligned too)."""
    parts = [tensors[i].contiguous().reshape(-1).view(torch.uint8) for i in _byte_order(tensors)]
    n = sum(p.numel() for p in parts)
    dev = tensors[0].device if tensors else "cpu"
    return torch.cat(parts + [torch.zeros((-n) % 8, dtype=torch.uint8, device=dev)])


def _byte_split(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inverse of _byte_cat: views of ``buf`` shaped and typed as ``like``."""
    out: list = [None] * len(like)
    ofs = 0
    for i in _byte_order(like):
        t = like[i]
        n = t.numel() * t.element_size()
        out[i] = buf[ofs : ofs + n].view(t.dtype).reshape(t.shape)
        ofs += n
    return out


def _gather_cat(mesh: Mesh, out: dict, names: list[str]) -> dict:
    """One all-gather of the named outputs' bytes; the per-run ones
    concatenated over the ranks in mesh order, the per-rank ones
    (``packed_summary``) stacked [size, k], the corpus-level ones taken
    from the first rank."""
    if not names:
        return {}
    like = [out[k] for k in names]
    got = mesh.all_gather(_byte_cat(like)[None])
    pieces = [_byte_split(row, like) for row in got]
    res = {}
    for j, k in enumerate(names):
        if k in CORPUS_LEVEL:
            res[k] = pieces[0][j]
        elif k == "packed_summary":
            res[k] = torch.stack([p[j] for p in pieces])
        else:
            res[k] = torch.cat([p[j] for p in pieces])
    return res


def gather_rows(mesh: Mesh, out: dict, on_device: frozenset = frozenset()) -> tuple[dict, dict]:
    """The whole batch's outputs on every rank, from each rank's own:
    (host numpy outputs, device outputs).  The outputs outside
    ``on_device`` come back in one all-gather (the summary: a
    ``packed_summary`` stays per rank, [size, k]); the ``on_device`` planes
    in one more, left on the device, so that every rank's row gathers see
    every row."""
    host_names = [k for k in out if k not in on_device]
    dev_names = [k for k in out if k in on_device]
    host = {k: v.cpu().numpy() for k, v in _gather_cat(mesh, out, host_names).items()}
    return host, _gather_cat(mesh, out, dev_names)


def unpack_rows(host: dict, b_local: int, v: int, t: int, with_diff: bool = False) -> dict:
    """A gathered [size, k] ``packed_summary`` unpacked rank by rank
    (models/pipeline_model.py:unpack_summary at the local batch), its
    per-run outputs concatenated in mesh order."""
    from nemo_tpu_torch.models.pipeline_model import unpack_summary

    packed = host.pop("packed_summary", None)
    if packed is None:
        return host
    parts = [unpack_summary(p, b=b_local, v=v, t=t, with_diff=with_diff) for p in packed]
    for k in parts[0]:
        host[k] = parts[0][k] if k in CORPUS_LEVEL else np.concatenate([p[k] for p in parts])
    return host


def pad_batch_rows(arrays, multiple: int):
    """Pad a BatchArrays' run axis to a multiple (padding rows are empty
    graphs).  Returns (padded, n_real)."""
    import dataclasses

    b = arrays.is_goal.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return arrays, b
    return dataclasses.replace(
        arrays, **{f: _rows(getattr(arrays, f), 0, target, b, getattr(arrays, f).device) for f in arrays.FIELDS}
    ), b


def run_step_sharded(mesh: Mesh, pre, post, static: dict) -> dict[str, np.ndarray]:
    """The fused step (models/pipeline_model.py:analysis_step) with the run
    batch split over ``mesh``: every rank passes the whole (pre, post)
    BatchArrays, runs its own rows and gets every output of the whole
    batch as numpy, the padding rows shed; corpus-level outputs have no run
    axis to shed.  ``static`` is analysis_step's; its pack_out folds the
    summary for the gather, as the reference's does."""
    from nemo_tpu_torch.models.pipeline_model import (
        DIFF_PACK_LAYOUT,
        SUMMARY_PACK_LAYOUT,
        BatchArrays,
        analysis_step,
    )

    with_diff = bool(static.get("with_diff", True))
    pack_out = bool(static.get("pack_out", False))
    pre, b = pad_batch_rows(pre, mesh.size)
    post, _ = pad_batch_rows(post, mesh.size)
    b_pad = pre.is_goal.shape[0]
    arrays = {f"{c}_{f}": getattr(x, f) for c, x in (("pre", pre), ("post", post)) for f in BatchArrays.FIELDS}
    local, _ = place_rows(mesh, arrays, b_pad, pre.is_goal.device, with_row0=with_diff)
    out = analysis_step(
        BatchArrays(**{f: local[f"pre_{f}"] for f in BatchArrays.FIELDS}),
        BatchArrays(**{f: local[f"post_{f}"] for f in BatchArrays.FIELDS}),
        **{**static, "pack_out": False},
    )
    layout = (SUMMARY_PACK_LAYOUT + (DIFF_PACK_LAYOUT if with_diff else ())) if pack_out else None
    out = finish_rows(mesh, out, with_diff and mesh.index > 0, layout)
    host, dev = gather_rows(mesh, out)
    host = unpack_rows(host, b_pad // mesh.size, int(static["v"]), int(static["num_tables"]), with_diff)
    return {k: a if k in CORPUS_LEVEL else a[:b] for k, a in host.items()}


def analysis_step_sharded(mesh: Mesh, pre, post, static: dict) -> dict[str, np.ndarray]:
    """The fused step with the run batch data-parallel over a 1-D mesh."""
    return run_step_sharded(mesh, pre, post, static)
