"""Kernel K2: frontier waves over per-run edge lists.

Replaces the TPU kernel ``nemo_tpu/ops/pallas_kernels.py:edge_wave_pallas``
(body ``_edge_wave_kernel``), the reach wave of the sparse-CSR device tier:
``state |= push(state)`` — every node with an in-edge from the state joins
it — exactly ``n_steps`` times, or to the fix point with ``n_steps=None``.
The TPU kernel ran a fixed number of waves per HBM round trip as [E,V]
one-hot compares in VMEM; on the H100 (``csrc/edge_wave.cu``) one CTA per
run keeps the node state as a bitset in shared memory, stages the run's
masked edges there once where they fit, and runs every wave to the end —
the fix point included — inside one launch, so the caller never syncs per
wave.  It is bound by one read of the state and edge planes and one write
of the state; see the source for the design.

``edge_wave`` is the wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes ``edge_wave_plain``, the gather/scatter pushes
that define the function.  ``edge_wave.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch


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


def _lib() -> ctypes.CDLL:
    from nemo_tpu_torch.kernels.build import load

    lib = load("edge_wave")
    if not getattr(lib, "_nemo_bound", False):
        lib.nemo_edge_wave.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nemo_edge_wave.restype = ctypes.c_int
        lib.nemo_edge_wave_max_v.argtypes = []
        lib.nemo_edge_wave_max_v.restype = ctypes.c_int
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
    lib = _lib()
    max_v = lib.nemo_edge_wave_max_v()
    if v > max_v:
        raise ValueError(f"edge_wave: V={v} exceeds the {max_v} nodes two shared-memory bitsets hold")
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
            src.shape[-1],
            int(src.ndim == 1),
            -1 if n_steps is None else int(n_steps),
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"edge_wave kernel failed: {lib.nemo_edge_wave_error_string(rc).decode()} (cudaError {rc})"
        )
    edge_wave.launches += 1
    return out


edge_wave.launches = 0
