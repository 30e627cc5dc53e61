"""Kernel K2: frontier waves over per-run edge lists.

Replaces the TPU kernel ``nemo_tpu/ops/pallas_kernels.py:edge_wave_pallas``
(body ``_edge_wave_kernel``), the reach wave of the sparse-CSR device tier:
``state |= push(state)`` — every node with an in-edge from the state joins
it — exactly ``n_steps`` times, or to the fix point with ``n_steps=None``.
The TPU kernel ran a fixed number of waves per HBM round trip as [E,V]
one-hot compares in VMEM.  On the H100 (``csrc/edge_wave.cu``) the fix
point of a run is found by a work-efficient kernel: its edges are staged in
shared memory once, swept in place while that is cheap, and what is left
(deep chains) is finished by a traversal of a CSR built from them, without
a barrier per hop — one warp per run for runs of up to 1,024 nodes, one
block per run above.  A finite ``n_steps``, small runs whose wave CTAs all
fit on the card at once, and runs whose edges do not fit shared memory take
the synchronous waves, one CTA per run sweeping all edges per wave.
``edge_wave_plan`` picks the variant from the shapes; see the source for
the design and its bounds.

``edge_wave`` is the wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes ``edge_wave_plain``, the gather/scatter pushes
that define the function.  ``edge_wave.launches`` counts kernel launches.
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

#: Runs of at most this many nodes and edges take one warp each.
WARP_MAX_V, WARP_MAX_E = 1024, 4096
#: Runs per block of the warp variant, at most.
WARP_RUNS_PER_BLOCK = 8
#: Threads per block of the worklist's block variant.
BLOCK_THREADS = 256
#: Threads the H100 holds resident at once: 132 SMs x 2,048.
RESIDENT_THREADS = 132 * 2048
#: The C interface's variant numbers, in the wrapper's order of preference.
VARIANTS = {"worklist_warp": 3, "worklist_block": 2, "waves_staged": 0, "waves_streamed": 1}


def edge_wave_plain(
    state: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    n_steps: int | None = None,
) -> torch.Tensor:
    """The plain PyTorch waves: ``n_steps`` synchronous pushes (one gather
    by edge source, one scatter to edge destinations each), or pushes until
    one changes nothing when ``n_steps`` is None.  Edge planes are [B,E] or
    one shared [E] list."""
    b, v = state.shape
    e = src.shape[-1]
    src_b = src.long().expand(b, e)
    dst_b = dst.long().expand(b, e)
    mask_b = mask.expand(b, e)
    cur = state.clone()
    step = 0
    while n_steps is None or step < n_steps:
        hit = torch.gather(cur, 1, src_b) & mask_b
        pushed = torch.zeros(b, v, dtype=torch.int32, device=state.device)
        nxt = cur | (pushed.scatter_add_(1, dst_b, hit.to(torch.int32)) > 0)
        step += 1
        if n_steps is None and torch.equal(nxt, cur):
            break
        cur = nxt
    return cur


@dataclass(frozen=True)
class WavePlan:
    """How one edge_wave launches: the variant, runs per block (worklist
    warp variant), threads per block and dynamic shared-memory bytes."""

    variant: str
    runs_per_block: int
    threads: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def worklist_run_bytes(v: int, e: int, stage_warps: int) -> int:
    """Shared-memory bytes of one run of the worklist kernels: a 64-byte
    control block, a batch of 32 nodes per warp, the bitset, the CSR offsets
    (uint32) and destinations, a V-entry queue and the staged edges (one
    uint32 each), each part 16-byte aligned, nodes 16-bit (the layout of
    csrc/edge_wave.cu:carve)."""
    return (
        64
        + _align16(stage_warps * 32 * 2)
        + _align16((v + 31) // 32 * 4)
        + _align16(v * 4)
        + _align16(e * 2)
        + _align16(v * 2)
        + _align16(e * 4)
    )


def edge_wave_plans(b: int, v: int, e: int, n_steps: int | None) -> dict[str, WavePlan]:
    """Every variant's launch plan that can run the shape ([b,v] state, e
    edges per run) at ``n_steps``.  The worklist variants run only the fix
    point (``n_steps=None``): one warp per run while v <= 1024 and e <=
    4096, one block per run while the run's CSR fits shared memory.  The
    waves run any ``n_steps``, the edges staged in shared memory where they
    fit, else streamed; a run whose two bitsets do not fit has no plan."""
    if b <= 0 or v <= 0 or e < 0:
        raise ValueError(f"edge_wave_plans: bad shape b={b} v={v} e={e}")
    plans = {}
    if n_steps is None:
        # A run takes at least 6 bytes of shared memory a node and 6 an
        # edge, which keeps V far below the 65,535 that 16-bit nodes allow.
        if v <= WARP_MAX_V and e <= WARP_MAX_E:
            per_run = worklist_run_bytes(v, e, 1)
            per_block = min(WARP_RUNS_PER_BLOCK, b, SMEM_DYNAMIC_MAX // per_run)
            plans["worklist_warp"] = WavePlan("worklist_warp", per_block, 32 * per_block, per_block * per_run)
        smem = worklist_run_bytes(v, e, BLOCK_THREADS // 32)
        if smem <= SMEM_DYNAMIC_MAX:
            plans["worklist_block"] = WavePlan("worklist_block", 1, BLOCK_THREADS, smem)
    threads = min(1024, max(64, (e + 31) // 32 * 32))
    bitsets = 2 * ((v + 31) // 32) * 4
    if bitsets + 8 * e <= SMEM_DYNAMIC_MAX:
        plans["waves_staged"] = WavePlan("waves_staged", 1, threads, bitsets + 8 * e)
    if bitsets <= SMEM_DYNAMIC_MAX:
        plans["waves_streamed"] = WavePlan("waves_streamed", 1, threads, bitsets)
    return plans


def edge_wave_plan(b: int, v: int, e: int, n_steps: int | None) -> WavePlan:
    """The plan ``edge_wave`` launches.  A finite ``n_steps`` takes the
    synchronous waves.  To the fix point, runs of at most WARP_MAX_V nodes
    whose wave CTAs all fit on the card at once (b x threads <=
    RESIDENT_THREADS) take the staged waves as well: a wave's barrier is
    then cheap and the kernel's set-up lighter than the worklist's staging,
    and it measured faster there on the card (PERF.md).  Every other shape
    takes the first of worklist_warp, worklist_block, waves_staged,
    waves_streamed that takes it: runs whose wave CTAs need more than one
    round on the card, and giant runs, whose chains the worklist follows
    without a sweep per hop.  Raises ValueError where no variant takes the
    shape (two bitsets of v nodes exceed shared memory: v above ~925,000)."""
    plans = edge_wave_plans(b, v, e, n_steps)
    staged = plans.get("waves_staged")
    if staged is not None and v <= WARP_MAX_V and b * staged.threads <= RESIDENT_THREADS:
        return staged
    for name in VARIANTS:
        if name in plans:
            return plans[name]
    raise ValueError(f"edge_wave: V={v} exceeds the nodes two shared-memory bitsets hold")


def _lib() -> ctypes.CDLL:
    from nemo_tpu_torch.kernels.build import load

    lib = load("edge_wave")
    if not getattr(lib, "_nemo_bound", False):
        lib.nemo_edge_wave.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.nemo_edge_wave.restype = ctypes.c_int
        lib.nemo_edge_wave_run_bytes.argtypes = [ctypes.c_int] * 3
        lib.nemo_edge_wave_run_bytes.restype = ctypes.c_longlong
        lib.nemo_edge_wave_error_string.argtypes = [ctypes.c_int]
        lib.nemo_edge_wave_error_string.restype = ctypes.c_char_p
        lib._nemo_bound = True
    return lib


def edge_wave(
    state: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    n_steps: int | None = None,
) -> torch.Tensor:
    """``state`` [B,V] bool after exactly ``n_steps`` synchronous waves over
    the edges (``src``/``dst`` int32 and ``mask`` bool, each [B,E] or one
    shared [E] list); ``n_steps=None`` runs to the fix point.  A new tensor
    out; the input is not modified."""
    if state.device.type == "cpu":
        return edge_wave_plain(state, src, dst, mask, n_steps)
    b, v, e = _check(state, src, dst, mask, n_steps)
    return launch_plan(edge_wave_plan(b, v, e, n_steps), state, src, dst, mask, n_steps)


def _check(state, src, dst, mask, n_steps) -> tuple[int, int, int]:
    """(B, V, E) of CUDA inputs the kernel takes; raises on anything else."""
    if state.device.type != "cuda":
        raise ValueError(f"edge_wave: unsupported device {state.device}")
    if state.dtype != torch.bool or mask.dtype != torch.bool:
        raise TypeError(f"edge_wave: state and mask must be bool, got {state.dtype}, {mask.dtype}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"edge_wave: src and dst must be int32, got {src.dtype}, {dst.dtype}")
    if state.ndim != 2:
        raise ValueError(f"edge_wave: state must be [B,V], got {tuple(state.shape)}")
    b, v = state.shape
    if not (src.shape == dst.shape == mask.shape) or src.ndim not in (1, 2) or (
        src.ndim == 2 and src.shape[0] != b
    ):
        raise ValueError(
            f"edge_wave: edge planes must be [B,E] or [E] for B={b}, got src "
            f"{tuple(src.shape)}, dst {tuple(dst.shape)}, mask {tuple(mask.shape)}"
        )
    tensors = (state, src, dst, mask)
    if any(t.device != state.device for t in tensors):
        raise ValueError("edge_wave: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("edge_wave: inputs must be contiguous")
    if n_steps is not None and n_steps < 0:
        raise ValueError(f"edge_wave: n_steps must be >= 0 or None, got {n_steps}")
    return b, v, src.shape[-1]


def launch_plan(
    plan: WavePlan,
    state: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    n_steps: int | None = None,
) -> torch.Tensor:
    """``edge_wave`` on CUDA inputs by the given launch plan (``edge_wave``
    passes ``edge_wave_plan``'s); counts one launch."""
    b, v, e = _check(state, src, dst, mask, n_steps)
    lib = _lib()
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        rc = lib.nemo_edge_wave(
            state.data_ptr(),
            src.data_ptr(),
            dst.data_ptr(),
            mask.data_ptr(),
            out.data_ptr(),
            b,
            v,
            e,
            int(src.ndim == 1),
            -1 if n_steps is None else int(n_steps),
            VARIANTS[plan.variant],
            plan.runs_per_block,
            plan.threads,
            plan.smem,
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    if rc != 0:
        raise KernelError(
            f"edge_wave kernel failed: {lib.nemo_edge_wave_error_string(rc).decode()} (cudaError {rc})"
        )
    count_launch(edge_wave)
    return out


edge_wave.launches = 0
