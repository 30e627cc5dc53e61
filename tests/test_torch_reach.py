"""The premise of K2's fix-point redesign, and K1's edge cases, on the CPU.

K2's worklist kernel computes ``edge_wave(..., n_steps=None)`` by a
traversal in whatever order its warps reach the nodes.  That is only right
if the fix point is the set reachable from the state, whatever the order and
multiplicity of the edges.  These tests hold the plain version (what the
wrapper runs on a CPU tensor, and what the kernel is held to on the card):

* against a numpy breadth-first search, on random graphs (hypothesis) and on
  the edge cases of ``kernels/cases.py``;
* unchanged when the edges are permuted or duplicated;
* against the JAX package's ``edge_wave_pallas`` in interpret mode, on graphs
  built to defeat a one-pass traversal: chains listed in reverse, rings,
  duplicated edges.

K1's edge cases (every V from 1 to 512, batches that are not a multiple of
the warp variant's graphs per block, cyclic graphs cut short by max_len) are
held against a numpy squaring chain and, up to V = 128, the JAX closure.
Tolerance: none — every output is bool.
"""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nemo_tpu.ops.adjacency import closure as jax_closure
from nemo_tpu.ops.pallas_kernels import edge_wave_pallas
from nemo_tpu_torch.kernels import cases
from nemo_tpu_torch.kernels.closure import closure_plain, closure_steps
from nemo_tpu_torch.kernels.edge_wave import edge_wave, edge_wave_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bfs_reach(state, src, dst, mask):
    """Nodes reachable (>= 0 hops) from each row's state over its masked,
    in-range edges: a queue-driven breadth-first search per row."""
    b, v = state.shape
    e = src.shape[-1]
    src, dst, mask = (np.broadcast_to(a, (b, e)) for a in (src, dst, mask))
    out = state.copy()
    for r in range(b):
        adj = [[] for _ in range(v)]
        for s, d, m in zip(src[r], dst[r], mask[r]):
            if m and 0 <= s < v and 0 <= d < v:
                adj[s].append(d)
        todo = deque(np.flatnonzero(out[r]))
        while todo:
            for d in adj[todo.popleft()]:
                if not out[r, d]:
                    out[r, d] = True
                    todo.append(d)
    return out


def _plain(state, src, dst, mask, n_steps=None):
    ts = cases.in_range(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (state, src, dst, mask)))
    return edge_wave_plain(*ts, n_steps).numpy()


@st.composite
def graphs(draw):
    b = draw(st.integers(1, 4))
    v = draw(st.integers(1, 40))
    e = draw(st.integers(0, 80))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    shape = (e,) if draw(st.booleans()) else (b, e)
    src = rng.integers(0, v, shape).astype(np.int32)
    dst = rng.integers(0, v, shape).astype(np.int32)
    mask = rng.random(shape) < draw(st.floats(0.0, 1.0))
    state = rng.random((b, v)) < draw(st.floats(0.0, 0.3))
    return state, src, dst, mask, rng


@settings(max_examples=60, deadline=None)
@given(graphs())
def test_fix_point_is_bfs_reachability(g):
    state, src, dst, mask, _ = g
    np.testing.assert_array_equal(_plain(state, src, dst, mask), bfs_reach(state, src, dst, mask))


@settings(max_examples=60, deadline=None)
@given(graphs())
def test_fix_point_ignores_edge_order_and_duplicates(g):
    state, src, dst, mask, rng = g
    want = _plain(state, src, dst, mask)
    e = src.shape[-1]
    perm = rng.permutation(e)
    np.testing.assert_array_equal(_plain(state, src[..., perm], dst[..., perm], mask[..., perm]), want)
    dup = np.concatenate([perm, rng.integers(0, max(e, 1), e) % max(e, 1)]) if e else perm
    np.testing.assert_array_equal(_plain(state, src[..., dup], dst[..., dup], mask[..., dup]), want)


@pytest.mark.parametrize("name,arrays", cases.edge_wave_cases(large=False))
def test_fix_point_on_the_kernel_edge_cases(name, arrays):
    want = bfs_reach(*arrays)
    np.testing.assert_array_equal(_plain(*arrays), want, err_msg=name)
    ts = cases.in_range(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(edge_wave(*ts, None).numpy(), want, err_msg="wrapper on a CPU tensor")


def _pallas_fix_point(state, src, dst, mask):
    """edge_wave_pallas (interpret mode, 4 waves a call) until a call
    changes nothing."""
    b, e = state.shape[0], src.shape[-1]
    args = [jnp.asarray(np.broadcast_to(a, (b, e))) for a in (src, dst, mask)]
    cur = jnp.asarray(state)
    while True:
        nxt = edge_wave_pallas(cur, *args, n_steps=4, interpret=True)
        if bool((nxt == cur).all()):
            return np.asarray(nxt)
        cur = nxt


def _adversarial(kind: str):
    """Small graphs against a one-pass traversal: a 20-node chain listed in
    reverse (each edge's source is reached only after the edge was seen), a
    ring entered at one node, and a graph with every edge tripled."""
    rng = np.random.default_rng({"reverse_chain": 1, "ring": 2, "duplicates": 3}[kind])
    b, v = 3, 24
    perm = rng.permutation(v)
    if kind == "reverse_chain":
        src, dst = perm[:19][::-1], perm[1:20][::-1]
    elif kind == "ring":
        src, dst = perm, np.roll(perm, -1)
    else:
        s, d = rng.integers(0, v, 12), rng.integers(0, v, 12)
        src, dst = np.tile(s, 3), np.tile(d, 3)
    src = np.tile(src.astype(np.int32), (b, 1))
    dst = np.tile(dst.astype(np.int32), (b, 1))
    mask = np.ones(src.shape, dtype=bool)
    state = np.zeros((b, v), dtype=bool)
    state[0, perm[0]] = True
    state[1, perm[7]] = True
    return state, src, dst, mask


@pytest.mark.parametrize("kind", ["reverse_chain", "ring", "duplicates"])
def test_fix_point_matches_pallas_on_adversarial_graphs(kind):
    state, src, dst, mask = _adversarial(kind)
    want = _pallas_fix_point(state, src, dst, mask)
    np.testing.assert_array_equal(_plain(state, src, dst, mask), want)
    np.testing.assert_array_equal(bfs_reach(state, src, dst, mask), want)
    if kind == "reverse_chain":
        assert want[0].sum() == 20, "the chain is reached to its end"


def _squaring_chain(adj: np.ndarray, max_len):
    v = adj.shape[-1]
    r = (adj | np.eye(v, dtype=bool)).astype(np.int64)
    for _ in range(closure_steps(v, max_len)):
        r = (r @ r > 0).astype(np.int64)
    return r.astype(bool)


@pytest.mark.parametrize("name,adj,max_len", cases.closure_cases(large=False))
def test_closure_plain_on_the_kernel_edge_cases(name, adj, max_len):
    got = closure_plain(torch.from_numpy(adj), max_len=max_len).numpy()
    np.testing.assert_array_equal(got, _squaring_chain(adj, max_len), err_msg=name)
    if adj.shape[-1] <= 128:
        xla = np.asarray(jax_closure(jnp.asarray(adj), impl="xla", max_len=max_len))
        np.testing.assert_array_equal(got, xla, err_msg=name)
