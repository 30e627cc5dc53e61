"""Host planning for giant runs: runs too large for the dense buckets.

A run with more than ``TorchBackend.giant_v`` nodes leaves the buckets and
is analysed alone by the sparse step (``ops/sparse_device.py``), packed at
the corpus-common giant (V, E) buckets.  The one plan that step needs is
whether the run's @next chains are linear, which selects the
pointer-doubling component labels over the min-label relaxation.

Port of the JAX package's ``parallel/giant.py:giant_plan``, trimmed to that
flag: its depth bound and union-find labels feed only the JAX package's
dense node-sharded giant step, which the port does not have.
"""

from __future__ import annotations

import numpy as np

from nemo_tpu_torch.graphs.packed import PackedGraph
from nemo_tpu_torch.ops.simplify import chains_linear_host


def giant_plan(graph: PackedGraph) -> bool:
    """chains_linear of one unpadded graph: every @next chain member has at
    most one member successor and predecessor in the clean graph — true for
    the linear ``t(C+1)@next :- t(C)`` chains the domain generates.  O(E),
    host numpy; the graph's first ``n_goals`` slots are its goals."""
    n, e = graph.n_nodes, len(graph.edges)
    edges = graph.edges.reshape(e, 2)
    return chains_linear_host(
        (np.arange(n) < graph.n_goals)[None],
        np.ones((1, n), dtype=bool),
        graph.type_id[None],
        edges[None, :, 0],
        edges[None, :, 1],
        np.ones((1, e), dtype=bool),
    )
