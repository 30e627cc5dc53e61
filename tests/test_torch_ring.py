"""The port's ring schedule and column-sharded closure
(nemo_tpu_torch/parallel/ring.py) against the dense versions and the JAX
package's, on the CPU.

ring_reach and closure_sharded run on node meshes of 1 (this process,
outside any group; the closure is then K1's), 2 and 4 ranks (spawned gloo worlds of the port,
tests/torch_world.py); every rank's result must equal the dense
reachability and the port's plain closure (kernels/closure.py), which the
JAX package's ring_reach and closure agree with.  Bool outputs: exact.
"""

import numpy as np
import pytest
import torch

from nemo_tpu.ops.adjacency import closure as jax_closure
from nemo_tpu.parallel import ring as jring
from nemo_tpu_torch.kernels.closure import closure_plain
from nemo_tpu_torch.parallel import ring

from torch_world import Worlds


@pytest.fixture(scope="module")
def worlds():
    w = Worlds()
    yield w
    w.close()


def _graph(v: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    adj = rng.random((v, v)) < density
    start = np.zeros(v, dtype=bool)
    start[rng.integers(0, v, size=2)] = True
    return adj, start


def _dense_reach(adj: np.ndarray, start: np.ndarray, steps: int) -> np.ndarray:
    reach = start.copy()
    for _ in range(steps):
        reach = reach | (reach.astype(np.int64) @ adj.astype(np.int64) > 0)
    return reach


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("v, density, steps, seed", [(64, 0.03, 8, 0), (128, 0.01, 40, 1), (32, 0.2, 3, 2)])
def test_ring_and_closure_match_dense(worlds, width, v, density, steps, seed):
    adj, start = _graph(v, density, seed)
    want_reach = _dense_reach(adj, start, steps)
    want_clo = closure_plain(torch.from_numpy(adj)).numpy()
    np.testing.assert_array_equal(np.asarray(jax_closure(adj, impl="xla")), want_clo)
    if width == 1:
        m = ring.make_node_mesh(1)  # outside any group: the collectives are identities
        a = torch.from_numpy(adj)
        got = [(ring.ring_reach(m, a, torch.from_numpy(start), steps).numpy(), ring.closure_sharded(m, a).numpy())]
    else:
        got = worlds[width].run("ring", adj, start, steps)
    for rank, (reach, clo) in enumerate(got):
        np.testing.assert_array_equal(reach, want_reach, err_msg=f"ring_reach, width {width}, rank {rank}")
        np.testing.assert_array_equal(clo, want_clo, err_msg=f"closure_sharded, width {width}, rank {rank}")


@pytest.mark.parametrize("width", [2, 4])
def test_ring_reach_matches_jax(worlds, width):
    """The JAX package's ring_reach on as many virtual devices, same graph."""
    adj, start = _graph(64, 0.05, 3)
    want = np.asarray(jring.ring_reach(jring.make_node_mesh(width), adj, start, 6))
    for reach, _ in worlds[width].run("ring", adj, start, 6):
        np.testing.assert_array_equal(reach, want)


def test_ring_rejects_a_width_that_does_not_divide_v():
    m = ring.make_node_mesh(1)
    m.size = 3  # a mesh V does not divide
    with pytest.raises(ValueError):
        ring.closure_sharded(m, torch.zeros(8, 8, dtype=torch.bool))
