"""Kernel K1: reflexive-transitive closure of boolean adjacency matrices.

Replaces the TPU kernel ``nemo_tpu/ops/pallas_kernels.py:closure_pallas``
(body ``_closure_kernel``), which fused the squaring chain in VMEM with
graphs packed block-diagonally into 128-wide MXU tiles.  On the H100 the
work at the analysis path's shapes is tiny next to the bytes, so the kernel
(``csrc/closure.cu``) is bound by one read of the ``[B,V,V]`` bool input
and one write of the output.  ``closure_plan`` picks its variant from the
shapes: one warp per graph for a single graph of V <= 64 (bit rows in
registers, coalesced 16-byte loads and stores), one CTA per graph with both
bit buffers in shared memory for batches and up to V = 960, and
device-memory bit rows with one launch per squaring above that.  Every variant squares out of
place, so the chain is bit-identical to the plain one.

``closure`` is the wrapper: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes ``closure_plain``, the float32 matmul squaring chain that
computes the same function.  ``closure.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from nemo_tpu_torch.kernels.build import KernelError, count_launch

#: Shared memory a block may use on the H100 (227 KB), and the part of it a
#: launch plan may take as dynamic shared memory: the rest is kept for the
#: kernels' static shared variables.
SMEM_PER_BLOCK = 232448
SMEM_DYNAMIC_MAX = SMEM_PER_BLOCK - 1024

#: Graphs per block of the warp variant (one warp each).
WARP_GRAPHS_PER_BLOCK = 8
#: Threads per block of the block variant, at most.
BLOCK_THREADS_MAX = 256
#: The C interface's variant numbers.
VARIANTS = {"warp": 0, "block": 1, "global": 2}


def closure_steps(v: int, max_len: int | None = None) -> int:
    """Squaring count for an exact >=0-hop closure: (A|I)^(2^k) covers every
    path of length <= 2^k, so k = ceil(log2(bound)) suffices when `bound`
    >= the longest path (in edges).  max_len supplies a tight bound (the
    corpus max_depth for DIRECTED closures); undirected component closures
    must not pass one.  Default v-1."""
    bound = min(v - 1, max_len) if max_len else v - 1
    return max(1, (max(1, bound) - 1).bit_length())


def closure_plain(adj: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """The plain PyTorch closure: closure_steps(V, max_len) float32 matrix
    squarings of (adj|I), thresholded after each.  Exact for 0/1 entries."""
    v = adj.shape[-1]
    r = adj | torch.eye(v, dtype=torch.bool, device=adj.device)
    for _ in range(closure_steps(v, max_len)):
        f = r.to(torch.float32)
        r = torch.matmul(f, f) > 0.5
    return r


@dataclass(frozen=True)
class ClosurePlan:
    """How one closure launches: the variant, graphs per block (warp
    variant), threads per block, dynamic shared-memory bytes, and the uint32
    words of device scratch (global variant)."""

    variant: str
    graphs_per_block: int
    threads: int
    smem: int
    scratch_words: int


def closure_plans(b: int, v: int) -> dict[str, ClosurePlan]:
    """Every variant's launch plan that can run a [b,v,v] batch: the warp
    variant for v <= 64, the block variant while two bit buffers of v rows
    fit shared memory (v <= 960), the global one always."""
    if b <= 0 or v <= 0:
        raise ValueError(f"closure_plans: empty batch [{b},{v},{v}]")
    words = v * ((v + 31) // 32)
    plans = {}
    if v <= 64:
        per_block = min(WARP_GRAPHS_PER_BLOCK, b)
        plans["warp"] = ClosurePlan("warp", per_block, 32 * per_block, per_block * 64 * 8, 0)
    if 8 * words <= SMEM_DYNAMIC_MAX:
        threads = min(BLOCK_THREADS_MAX, (words + 31) // 32 * 32)
        plans["block"] = ClosurePlan("block", 1, threads, 8 * words, 0)
    plans["global"] = ClosurePlan("global", 1, 256, 0, 2 * b * words)
    return plans


def closure_plan(b: int, v: int) -> ClosurePlan:
    """The plan ``closure`` launches: the warp variant for a single graph
    of at most 64 nodes (the [V,V] diff closures), else the first of block,
    global that takes the shape.  A batch takes the block variant even
    where the warp variant could run it: on the analyses' batched buckets
    (2,048 and 1,024 graphs at V = 64) the block variant's four warps per
    graph measured faster on the card (PERF.md)."""
    plans = closure_plans(b, v)
    if b > 1:
        plans.pop("warp", None)
    return next(plans[k] for k in VARIANTS if k in plans)


def _lib() -> ctypes.CDLL:
    from nemo_tpu_torch.kernels.build import load

    lib = load("closure")
    if not getattr(lib, "_nemo_bound", False):
        lib.nemo_closure.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.nemo_closure.restype = ctypes.c_int
        lib.nemo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nemo_cuda_error_string.restype = ctypes.c_char_p
        lib._nemo_bound = True
    return lib


def closure(adj: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """Reflexive-transitive closure of a [B,V,V] or [V,V] bool adjacency:
    exactly closure_steps(V, max_len) squarings of (adj|I).  Same shape and
    dtype out."""
    if adj.device.type == "cpu":
        return closure_plain(adj, max_len)
    b, v = _check(adj)
    return launch_plan(adj, closure_plan(b, v), max_len)


def _check(adj: torch.Tensor) -> tuple[int, int]:
    """(B, V) of a CUDA adjacency the kernel takes; raises on anything else."""
    if adj.device.type != "cuda":
        raise ValueError(f"closure: unsupported device {adj.device}")
    if adj.dtype != torch.bool:
        raise TypeError(f"closure: expected a bool tensor, got {adj.dtype}")
    if adj.ndim not in (2, 3) or adj.shape[-1] != adj.shape[-2]:
        raise ValueError(f"closure: expected [B,V,V] or [V,V], got {tuple(adj.shape)}")
    if not adj.is_contiguous():
        raise ValueError("closure: input must be contiguous")
    return (adj.shape[0] if adj.ndim == 3 else 1), adj.shape[-1]


def launch_plan(adj: torch.Tensor, plan: ClosurePlan, max_len: int | None = None) -> torch.Tensor:
    """The closure of a CUDA adjacency by the given launch plan (``closure``
    passes ``closure_plan``'s); counts one launch."""
    b, v = _check(adj)
    lib = _lib()
    out = torch.empty_like(adj)
    scratch = (
        torch.empty(plan.scratch_words, dtype=torch.int32, device=adj.device) if plan.scratch_words else None
    )
    with torch.cuda.device(adj.device):
        rc = lib.nemo_closure(
            adj.data_ptr(),
            out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b,
            v,
            closure_steps(v, max_len),
            VARIANTS[plan.variant],
            plan.graphs_per_block,
            plan.threads,
            plan.smem,
            torch.cuda.current_stream(adj.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(
            f"closure kernel failed: {lib.nemo_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    count_launch(closure)
    return out


closure.launches = 0
