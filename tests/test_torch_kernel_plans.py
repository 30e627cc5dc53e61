"""The launch plans of kernels K1 and K2, on the CPU.

The wrappers decide in Python how each kernel launches — the variant, the
graphs or runs per block, the threads, the shared-memory bytes, the width of
a node index — and pass the plan to the CUDA source.  These tests hold every
shape the analyses launch the kernels at (and the edge cases of
``kernels/cases.py``) to a plan that the H100 can run: dynamic shared memory
within the 227 KB (232,448 bytes) a block may use, less the room kept for
static shared variables; whole warps; at most 1,024 threads.  Shapes that no
variant takes raise.
"""

import pytest

from nemo_tpu_torch.kernels import cases
from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.kernels import edge_wave as k2

SMEM_LIMIT = 232448

#: (B, V, E, shared, the variant edge_wave picks to the fix point): the
#: shapes the sparse tier launches K2 at (a giant run, a giant good run's
#: diff broadcast over padded failed runs, sd_giantv's giant and its V =
#: 2,048 bucket, the sweep's mem bucket and its diff, ZK-1270 forced sparse
#: and its diff) and the kernel checks' shapes.  Runs of up to 1,024 nodes
#: whose wave CTAs all fit on the card at once take the staged waves; runs
#: whose CTAs need two rounds take the warp worklist, giant runs the block
#: worklist.
WAVE_SHAPES = [
    (1, 16384, 16384, False, "worklist_block"),
    (8, 16384, 16384, True, "worklist_block"),
    (1024, 16384, 16384, True, "worklist_block"),
    (1, 8192, 8192, False, "worklist_block"),
    (8, 2048, 2048, False, "worklist_block"),
    (1024, 256, 256, False, "waves_staged"),
    (1024, 256, 256, True, "waves_staged"),
    (544, 256, 256, False, "waves_staged"),
    (512, 128, 128, False, "waves_staged"),
    (128, 512, 512, False, "waves_staged"),
    (1024, 512, 512, True, "worklist_warp"),
    (2048, 64, 256, False, "worklist_warp"),
    (2048, 64, 64, False, "waves_staged"),
    (1024, 32, 32, True, "waves_staged"),
    (4096, 64, 64, False, "waves_staged"),
    (8192, 64, 64, False, "worklist_warp"),
    (1, 1, 0, False, "waves_staged"),
    (3, 1000, 4096, False, "waves_staged"),
    (3, 1025, 1025, False, "worklist_block"),
    (1, 19000, 19000, False, "worklist_block"),
    (1, 20000, 20000, False, "waves_staged"),
    (1, 30000, 30000, False, "waves_streamed"),
    (1, 60000, 60000, False, "waves_streamed"),
    (1, 900000, 16, False, "waves_staged"),
]

#: (B, V, the variant closure picks): the dense buckets at V = 64 (six
#: families, the sweep), the sweep's V = 128 and 512 buckets, the [V,V] diff
#: closures (V = 32 and 64, and 2,048 on sd_giantv), and the edge cases.  A
#: single graph of at most 64 nodes takes the warp variant, a batch the
#: block variant up to V = 960.
CLOSURE_SHAPES = [
    (2048, 64, "block"), (1700, 64, "block"), (1024, 64, "block"), (1, 64, "warp"), (1, 32, "warp"),
    (1, 1, "warp"), (13, 1, "block"), (13, 33, "block"), (2, 64, "block"), (1, 65, "block"),
    (512, 128, "block"), (494, 128, "block"), (128, 512, "block"), (3, 960, "block"),
    (3, 992, "global"), (1, 2048, "global"), (1, 4096, "global"),
]


def _assert_fits(plan, kind):
    assert 0 <= plan.smem <= SMEM_LIMIT - 1024, (kind, plan)
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0, (kind, plan)


@pytest.mark.parametrize("b,v,e,shared,variant", WAVE_SHAPES)
def test_edge_wave_plan_fits_the_card(b, v, e, shared, variant):
    plan = k2.edge_wave_plan(b, v, e, None)
    assert plan.variant == variant
    for n_steps in (None, 1, 7):
        for p in k2.edge_wave_plans(b, v, e, n_steps).values():
            _assert_fits(p, (b, v, e, n_steps))
            if p.variant == "worklist_warp":
                per_run = k2.worklist_run_bytes(v, e, 1)
                assert p.runs_per_block == min(k2.WARP_RUNS_PER_BLOCK, b, k2.SMEM_DYNAMIC_MAX // per_run)
                assert p.threads == 32 * p.runs_per_block
                assert p.smem == p.runs_per_block * per_run
            if p.variant == "worklist_block":
                assert p.smem == k2.worklist_run_bytes(v, e, p.threads // 32)
            if p.variant.startswith("worklist"):
                assert n_steps is None and v < 65535  # 16-bit nodes
    # A finite n_steps keeps the synchronous waves.
    assert k2.edge_wave_plan(b, v, e, 3).variant.startswith("waves")


@pytest.mark.parametrize("name,arrays", cases.edge_wave_cases(large=True))
def test_edge_wave_plan_takes_every_case(name, arrays):
    state, src = arrays[0], arrays[1]
    for n_steps in (None, 2):
        plans = k2.edge_wave_plans(state.shape[0], state.shape[1], src.shape[-1], n_steps)
        assert plans, name
        for p in plans.values():
            _assert_fits(p, name)


def test_edge_wave_plan_raises_past_shared_memory():
    with pytest.raises(ValueError, match="bitsets"):
        k2.edge_wave_plan(1, 1 << 20, 4, None)
    with pytest.raises(ValueError, match="bitsets"):
        k2.edge_wave_plan(1, 1 << 20, 4, 2)
    with pytest.raises(ValueError):
        k2.edge_wave_plans(0, 16, 4, None)


def test_worklist_run_bytes_layout():
    # A warp run: ctl 64 + stage 64 (one warp, 16-bit) + bits 32 + off 1024
    # + adj 512 + queue 512 + pairs 1024.
    assert k2.worklist_run_bytes(256, 256, 1) == 64 + 64 + 32 + 1024 + 512 + 512 + 1024
    # Every part rounds up to 16 bytes: V = 1, E = 3, one warp's stage.
    assert k2.worklist_run_bytes(1, 3, 1) == 64 + 64 + 16 + 16 + 16 + 16 + 16
    # A giant run: about 195 KB, inside one block's shared memory.
    assert k2.worklist_run_bytes(16384, 16384, 8) == 64 + 512 + 2048 + 65536 + 32768 + 32768 + 65536
    assert k2.worklist_run_bytes(16384, 16384, 8) <= k2.SMEM_DYNAMIC_MAX


@pytest.mark.parametrize("b,v,variant", CLOSURE_SHAPES)
def test_closure_plan_fits_the_card(b, v, variant):
    plan = k1.closure_plan(b, v)
    assert plan.variant == variant
    for p in k1.closure_plans(b, v).values():
        _assert_fits(p, (b, v))
        if p.variant == "warp":
            assert p.graphs_per_block == min(k1.WARP_GRAPHS_PER_BLOCK, b)
            assert p.smem == 512 * p.graphs_per_block
        if p.variant == "global":
            assert p.scratch_words == 2 * b * v * ((v + 31) // 32)
        else:
            assert p.scratch_words == 0


@pytest.mark.parametrize("name,adj,max_len", cases.closure_cases(large=True))
def test_closure_plan_takes_every_case(name, adj, max_len):
    b = adj.shape[0] if adj.ndim == 3 else 1
    plans = k1.closure_plans(b, adj.shape[-1])
    assert "global" in plans and len(plans) >= 2 or adj.shape[-1] > 960, name
    for p in plans.values():
        _assert_fits(p, name)


def test_closure_plan_raises_on_an_empty_batch():
    with pytest.raises(ValueError):
        k1.closure_plan(0, 64)
    with pytest.raises(ValueError):
        k1.closure_plans(3, 0)
