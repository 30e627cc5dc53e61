"""Ring-scheduled frontier propagation and the column-sharded closure of
node-sharded giant graphs.

Port of the JAX package's ``parallel/ring.py``.  ``ring_reach`` shards the
adjacency by column blocks (each rank owns the in-edges of its node block)
and the frontier by row blocks; on each of the K ring steps a rank
multiplies the frontier chunk it holds against the matching row block of
its adjacency shard and passes the chunk to the previous rank
(batch_isend_irecv): the stationary-weights, moving-activations schedule
of ring attention, with no all-gather of the full frontier.
``closure_sharded`` squares a column-sharded (A|I) the same way: each
squaring passes the column blocks around the ring.

The per-hop products are boolean matmuls (bf16 on a card, float32 on the
CPU, accumulated in float32): exact on 0/1 entries.
"""

from __future__ import annotations

import torch

from nemo_tpu_torch.kernels.closure import closure, closure_steps

# Device topology comes from THE mesh module (parallel/mesh.py).
from .mesh import NODE_AXIS, Mesh, make_node_mesh  # noqa: F401  (re-export)


def _mm_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _check(mesh: Mesh, v: int) -> int:
    if v % mesh.size:
        raise ValueError(f"V={v} not divisible by mesh size {mesh.size}")
    return v // mesh.size


def ring_product(mesh: Mesh, chunk: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """This rank's column block of the boolean product L @ R, both operands
    column-sharded: ``chunk`` is this rank's [..., K, Vb] column block of L,
    ``shard`` its [..., V, Vb] column block of R.  OR over the ring of
    ``L[:, block j] @ R[block j, mine]``: every rank's chunk of L passes by
    once.  Returns [..., K, Vb] bool."""
    vb = shard.shape[-1]
    dt = _mm_dtype(shard.device)
    acc = None
    for i in range(mesh.size):
        # The chunk held now started at rank (index + i) mod size, so it
        # covers that row block of the operand.
        src = (mesh.index + i) % mesh.size
        part = torch.matmul(chunk.to(dt), shard[..., src * vb : (src + 1) * vb, :].to(dt)).float()
        acc = part if acc is None else acc + part
        if i + 1 < mesh.size:
            chunk = mesh.ring_shift(chunk)
    return acc > 0.5


def ring_reach(mesh: Mesh, adjacency: torch.Tensor, start: torch.Tensor, steps: int) -> torch.Tensor:
    """BFS reachability (>= 0 hops) over a node-sharded graph, ``steps``
    ring rotations.  Every rank passes the whole [V,V] adjacency and [V]
    start; each keeps its column block and start chunk.  V must divide by
    the mesh size.  Returns the reachable-set mask [V] on every rank."""
    v = adjacency.shape[-1]
    cols = mesh.block(v)
    _check(mesh, v)
    shard = adjacency[:, cols]
    reach = start[cols]
    for _ in range(steps):
        reach = reach | ring_product(mesh, reach[None], shard)[0]
    return mesh.all_gather(reach)


def closure_cols(mesh: Mesh, shard: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """This rank's [..., V, Vb] column block of the reflexive-transitive
    closure, from its column block of the adjacency: closure_steps(V,
    max_len) squarings of (A|I), each a ring pass of the column blocks
    (C[:, j] = OR_k C[:, k] @ C[k, j]).  On a mesh of one rank the block
    is the whole plane, and the squarings are kernel K1's
    (kernels/closure.py)."""
    if mesh.size == 1:
        return closure(shard.contiguous(), max_len)  # K1 takes a dense layout
    v = shard.shape[-2]
    cols = mesh.block(v)
    eye = torch.eye(v, dtype=torch.bool, device=shard.device)[:, cols]
    r = shard | eye
    for _ in range(closure_steps(v, max_len)):
        r = ring_product(mesh, r, r)
    return r


def gather_cols(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """Every rank's [..., Vb] column block -> the whole [..., V] matrix."""
    return mesh.all_gather(block.movedim(-1, 0).contiguous()).movedim(0, -1)


def closure_sharded(mesh: Mesh, adjacency: torch.Tensor) -> torch.Tensor:
    """Reflexive-transitive closure of ONE giant graph, node-sharded: each
    rank keeps the column block of the [V,V] adjacency, the squarings run
    as ring passes (closure_cols), and the whole closure comes back on
    every rank; equal to the dense closure (kernels/closure.py)."""
    v = adjacency.shape[-1]
    _check(mesh, v)
    return gather_cols(mesh, closure_cols(mesh, adjacency[..., mesh.block(v)]))
