"""Edge-case inputs of kernels K1 and K2, made with numpy from a seed.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold every launch plan of
a kernel against its plain version on these inputs; the CPU tests hold the
plain versions against independent references on them.  Each case is built
to defeat a shortcut a kernel might take: edge orders that a one-pass sweep
would get wrong, degrees that leave lanes idle or overflow a warp's batch,
duplicate and out-of-range edges, empty and one-node graphs, sizes that are
not multiples of a word or a vector.
"""

from __future__ import annotations

import numpy as np
import torch

#: The 10,000-node chain inside a V = E = 16,384 run (a giant run's shape).
CHAIN_V, CHAIN_NODES = 16384, 10000


def _chain(v: int, n: int, order: str, rng) -> tuple[np.ndarray, np.ndarray, int]:
    """An n-node chain through a random permutation of v nodes: its n-1
    edges (src, dst) in forward, reverse or shuffled order, and its head."""
    perm = rng.permutation(v)[:n]
    src, dst = perm[:-1], perm[1:]
    if order == "reverse":
        src, dst = src[::-1], dst[::-1]
    elif order == "shuffled":
        idx = rng.permutation(n - 1)
        src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32), int(perm[0])


def _rows(b: int, v: int, edges: list[tuple[np.ndarray, np.ndarray]], starts: list[list[int]]):
    """[b,v] state and [b,E] planes from per-row edge lists (padded with
    masked-out zeros to the longest) and per-row start nodes."""
    e = max(len(s) for s, _ in edges)
    src = np.zeros((b, e), dtype=np.int32)
    dst = np.zeros((b, e), dtype=np.int32)
    mask = np.zeros((b, e), dtype=bool)
    state = np.zeros((b, v), dtype=bool)
    for r, ((s, d), st) in enumerate(zip(edges, starts)):
        src[r, : len(s)], dst[r, : len(s)], mask[r, : len(s)] = s, d, True
        state[r, st] = True
    return state, src, dst, mask


def edge_wave_cases(seed: int = 0, large: bool = True) -> list[tuple[str, tuple[np.ndarray, ...]]]:
    """(name, (state [B,V], src, dst, mask)) for K2.  ``large`` adds the
    giant run (B = 1 at V = E = 16,384) and the shared [E] list over 1,024
    rows."""
    rng = np.random.default_rng(seed)
    cases = []
    for order in ("forward", "reverse", "shuffled"):
        # Rows of one chain each, started at the head, in the middle, and not
        # at all; a second chain in the warp variant's size range.
        v = 300
        rows = [_chain(v, 280, order, rng) for _ in range(3)]
        state, src, dst, mask = _rows(3, v, [(s, d) for s, d, _ in rows],
                                      [[rows[0][2]], [int(rows[1][0][140])], []])
        cases.append((f"chain {order} [3,{v}] E={src.shape[1]}", (state, src, dst, mask)))
        v = 2000
        s, d, head = _chain(v, 1990, order, rng)
        cases.append((f"chain {order} [1,{v}] E={len(s)}", _rows(1, v, [(s, d)], [[head]])))
    ring = rng.permutation(128).astype(np.int32)
    idx = rng.permutation(128)
    cases.append(("ring of 128 [2,128] E=128",
                  _rows(2, 128, [(ring[idx], np.roll(ring, -1)[idx])] * 2, [[int(ring[5])], []])))
    for v in (256, 3000):
        # A star whose hub reaches every other node, then short chains off
        # some leaves: one node's out-edges span many warps' batches.
        leaves = np.arange(1, v, dtype=np.int32)
        tails = rng.choice(leaves, size=v // 8, replace=False)
        s = np.concatenate([np.zeros(v - 1, dtype=np.int32), tails[:-1]])
        d = np.concatenate([leaves, tails[1:]])
        order = rng.permutation(len(s))
        cases.append((f"star fan-out {v - 1} [2,{v}] E={len(s)}",
                      _rows(2, v, [(s[order], d[order])] * 2, [[0], [int(tails[0])]])))
    v, e = 200, 150
    s = rng.integers(0, v, e).astype(np.int32)
    d = rng.integers(0, v, e).astype(np.int32)
    loops = rng.integers(0, v, 40).astype(np.int32)
    s = np.concatenate([s, s, s, loops])
    d = np.concatenate([d, d, d, loops])
    order = rng.permutation(len(s))
    cases.append((f"duplicates and self-loops [4,{v}] E={len(s)}",
                  _rows(4, v, [(s[order], d[order])] * 4,
                        [list(rng.integers(0, v, k)) for k in (1, 3, 0, 10)])))
    v, e = 96, 400
    s = rng.integers(-3, v + 3, e).astype(np.int32)
    d = rng.integers(-3, v + 3, e).astype(np.int32)
    s[::7], d[1::7] = v, -1
    cases.append((f"out-of-range edges [3,{v}] E={e}",
                  _rows(3, v, [(s, d)] * 3, [[0], [5, 50], list(range(v))])))
    cases.append(("E=0 [5,64]", (rng.random((5, 64)) < 0.2, np.zeros((5, 0), np.int32),
                                 np.zeros((5, 0), np.int32), np.zeros((5, 0), bool))))
    cases.append(("V=1 [3,1] E=4", (np.array([[True], [False], [True]]), np.zeros((3, 4), np.int32),
                                    np.zeros((3, 4), np.int32), rng.random((3, 4)) < 0.5)))
    for v, e in ((100, 300), (33, 50), (1000, 3000)):
        b = 11
        src = rng.integers(0, v, (b, e)).astype(np.int32)
        dst = rng.integers(0, v, (b, e)).astype(np.int32)
        cases.append((f"random [{b},{v}] E={e}",
                      (rng.random((b, v)) < 2.0 / v, src, dst, rng.random((b, e)) < 0.7)))
    if large:
        cases.append((f"chain of {CHAIN_NODES} [1,{CHAIN_V}] E={CHAIN_V}", chain_16k(rng)))
        v = e = 256
        src = rng.integers(0, v, e).astype(np.int32)
        dst = rng.integers(0, v, e).astype(np.int32)
        ring = rng.permutation(v)[:128]
        src[:128], dst[:128] = ring, np.roll(ring, -1)
        cases.append(("shared [E] list [1024,256] E=256",
                      (rng.random((1024, v)) < 2.0 / v, src, dst, rng.random(e) < 0.8)))
    return cases


def in_range(state: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor):
    """The planes the plain waves take for edges the kernel ignores: an edge
    with an end outside [0, V) is masked out (and its ends clipped, so the
    plain gather stays in bounds).  Identity on in-range planes."""
    v = state.shape[-1]
    ok = mask & (src >= 0) & (src < v) & (dst >= 0) & (dst < v)
    return state, src.clamp(0, v - 1), dst.clamp(0, v - 1), ok


def chain_16k(rng) -> tuple[np.ndarray, ...]:
    """One run of V = E = 16,384 holding a 10,000-node chain, its edges in
    shuffled order and the rest masked out; the state is the chain's head."""
    s, d, head = _chain(CHAIN_V, CHAIN_NODES, "shuffled", rng)
    src = np.zeros((1, CHAIN_V), dtype=np.int32)
    dst = np.zeros((1, CHAIN_V), dtype=np.int32)
    mask = np.zeros((1, CHAIN_V), dtype=bool)
    src[0, : len(s)], dst[0, : len(s)], mask[0, : len(s)] = s, d, True
    state = np.zeros((1, CHAIN_V), dtype=bool)
    state[0, head] = True
    return state, src, dst, mask


def closure_cases(seed: int = 0, large: bool = True) -> list[tuple[str, np.ndarray, int | None]]:
    """(name, adjacency [B,V,V] or [V,V] bool, max_len) for K1: every V in
    {1, 2, 31, 32, 33, 63, 64, 65, 128, 512, 960, 992} (960 and 992 only
    with ``large``), batches that are not a multiple of the warp variant's
    graphs per block, and cyclic graphs whose depth exceeds max_len."""
    rng = np.random.default_rng(seed)
    vs = [1, 2, 31, 32, 33, 63, 64, 65, 128, 512] + ([960, 992] if large else [])
    cases = []
    for v in vs:
        b = 13 if v <= 128 else 3
        adj = rng.random((b, v, v)) < 2.0 / v
        cases.append((f"[{b},{v},{v}]", adj, None))
        cases.append((f"[{b},{v},{v}] max_len=3", adj, 3))
    for b in (1, 7, 9, 17):
        cases.append((f"[{b},64,64] max_len=32", rng.random((b, 64, 64)) < 2.0 / 64, 32))
    cases.append(("2-D [64,64]", rng.random((64, 64)) < 2.0 / 64, None))
    for v in (40, 64, 128):
        cyc = np.zeros((5, v, v), dtype=bool)
        for g in range(5):
            perm = rng.permutation(v)
            cyc[g, perm, np.roll(perm, -1)] = True
        cyc |= rng.random((5, v, v)) < 0.5 / v
        cases.append((f"cyclic [5,{v},{v}] max_len=4", cyc, 4))
    return cases
