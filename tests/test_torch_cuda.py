"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs; the
outputs are bool, so the tolerance is none.
"""

import numpy as np
import pytest
import torch

from nemo_tpu_torch.kernels import cases
from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.kernels import edge_wave as k2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,v", [(1700, 64), (2048, 64), (7, 50), (3, 992), (1, 4096)])
def test_closure_kernel_matches_plain(cuda, b, v):
    rng = np.random.default_rng(v)
    adj = torch.from_numpy(rng.random((b, v, v)) < 2.0 / v).to(cuda)
    for max_len in (None, 3, 32):
        before = k1.closure.launches
        got = k1.closure(adj, max_len=max_len)
        torch.cuda.synchronize()
        assert k1.closure.launches == before + 1
        assert torch.equal(got, k1.closure_plain(adj, max_len=max_len))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(cases.closure_cases())))
def test_closure_every_plan_on_edge_cases(cuda, case):
    """Every variant that takes the shape (warp, block, global), on one
    edge case, bit for bit against the plain chain."""
    name, adj, max_len = cases.closure_cases()[case]
    adj = torch.from_numpy(adj).to(cuda)
    want = k1.closure_plain(adj, max_len=max_len)
    b = adj.shape[0] if adj.ndim == 3 else 1
    for variant, plan in k1.closure_plans(b, adj.shape[-1]).items():
        got = k1.launch_plan(adj, plan, max_len)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, variant)


@pytest.mark.cuda
def test_closure_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        k1.closure(torch.zeros(2, 8, 8, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError):
        k1.closure(torch.zeros(2, 8, 9, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        k1.closure(torch.zeros(2, 8, 8, dtype=torch.bool, device=cuda).transpose(1, 2))


def _wave_inputs(b, v, e, seed, shared=False):
    """Random edges with 20 % masked out, the last eighth of the rows
    padding (empty state, all-false mask); ``shared``: one [E] list."""
    rng = np.random.default_rng(seed)
    shape = (e,) if shared else (b, e)
    src = rng.integers(0, v, shape).astype(np.int32)
    dst = rng.integers(0, v, shape).astype(np.int32)
    mask = rng.random(shape) < 0.8
    state = rng.random((b, v)) < 2.0 / v
    pad = b - b // 8
    state[pad:] = False
    if not shared:
        mask[pad:] = False
    return [torch.from_numpy(a) for a in (state, src, dst, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,v,e,shared",
    [(2048, 64, 256, False), (1024, 256, 256, False), (128, 512, 512, False), (1024, 256, 256, True),
     (3, 40, 70, False)],
)
def test_edge_wave_kernel_matches_plain(cuda, b, v, e, shared):
    args = [t.to(cuda) for t in _wave_inputs(b, v, e, v + e, shared)]
    for n_steps in (1, 2, 3, 4, None):
        before = k2.edge_wave.launches
        got = k2.edge_wave(*args, n_steps)
        torch.cuda.synchronize()
        assert k2.edge_wave.launches == before + 1
        assert torch.equal(got, k2.edge_wave_plain(*args, n_steps)), n_steps


@pytest.mark.cuda
def test_edge_wave_kernel_long_chain(cuda):
    """A 10,000-node chain in a 16,384-node graph, edges in shuffled order:
    n_steps reaches exactly n_steps hops; the fix point reaches the end."""
    rng = np.random.default_rng(0)
    v = e = 16384
    perm = rng.permutation(v)
    order = rng.permutation(9999)
    src = np.zeros(e, dtype=np.int32)
    dst = np.zeros(e, dtype=np.int32)
    src[:9999], dst[:9999] = perm[:9999][order], perm[1:10000][order]
    mask = np.zeros(e, dtype=bool)
    mask[:9999] = True
    state = np.zeros((1, v), dtype=bool)
    state[0, perm[0]] = True
    args = [torch.from_numpy(a).to(cuda) for a in (state, src[None], dst[None], mask[None])]
    for n_steps in (1, 4, None):
        got = k2.edge_wave(*args, n_steps)
        assert int(got.sum()) == (10000 if n_steps is None else n_steps + 1)
        assert torch.equal(got, k2.edge_wave_plain(*args, n_steps))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(cases.edge_wave_cases())))
def test_edge_wave_every_plan_on_edge_cases(cuda, case):
    """Every variant that takes the shape (the worklist's warp and block
    variants at the fix point, the staged and streamed waves at every
    n_steps), on one edge case, bit for bit against the plain waves; the
    wrapper's own choice launches once."""
    name, arrays = cases.edge_wave_cases()[case]
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    b, v = args[0].shape
    for n_steps in (None, 1, 3):
        want = k2.edge_wave_plain(*cases.in_range(*args), n_steps)
        before = k2.edge_wave.launches
        assert torch.equal(k2.edge_wave(*args, n_steps), want), (name, n_steps)
        assert k2.edge_wave.launches == before + 1
        for variant, plan in k2.edge_wave_plans(b, v, args[1].shape[-1], n_steps).items():
            got = k2.launch_plan(plan, *args, n_steps)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, variant, n_steps)


@pytest.mark.cuda
def test_edge_wave_run_bytes_match_the_source(cuda):
    """The wrapper's shared-memory layout of a worklist run is the
    kernel's."""
    lib = k2._lib()
    for v, e, warps in ((1, 0, 1), (256, 256, 1), (100, 301, 8), (16384, 16384, 8)):
        assert lib.nemo_edge_wave_run_bytes(v, e, warps) == k2.worklist_run_bytes(v, e, warps)


@pytest.mark.cuda
def test_edge_wave_kernel_rejects_bad_input(cuda):
    state = torch.zeros(2, 8, dtype=torch.bool, device=cuda)
    e32 = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    mask = torch.zeros(2, 4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        k2.edge_wave(state, e32.long(), e32, mask, 1)
    with pytest.raises(TypeError):
        k2.edge_wave(state.to(torch.uint8), e32, e32, mask, 1)
    with pytest.raises(ValueError):
        k2.edge_wave(state, e32[:1], e32[:1], mask[:1], 1)
    with pytest.raises(ValueError):
        k2.edge_wave(state, e32, e32, mask, -1)
    with pytest.raises(ValueError):
        k2.edge_wave(state, e32.cpu(), e32, mask, 1)
    with pytest.raises(ValueError):
        k2.edge_wave(torch.zeros(1, 1 << 20, dtype=torch.bool, device=cuda), e32[0], e32[0], mask[0])


@pytest.mark.cuda
def test_sparse_step_on_card_matches_cpu(cuda, tmp_path):
    """The whole sparse step on the card (K2 in every reach) equals the
    same step on the CPU."""
    from nemo_tpu_torch.models.pipeline_model import synth_batch_arrays
    from nemo_tpu_torch.ops.sparse_device import sparse_device_step

    pre, post, st = synth_batch_arrays(n_runs=40, seed=6, eot=20, device="cpu")
    kw = dict(v=st["v"], pre_tid=st["pre_tid"], post_tid=st["post_tid"],
              num_tables=st["num_tables"], comp_linear=st["comp_linear"])
    want = sparse_device_step(pre, post, **kw)
    moved = [type(b)(**{f: getattr(b, f).to(cuda) for f in b.FIELDS}) for b in (pre, post)]
    before = k2.edge_wave.launches
    got = sparse_device_step(*moved, **kw)
    assert k2.edge_wave.launches == before + 3
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _staging_corpus(tmp_path, n_runs: int = 600):
    """A corpus with a device-lane bucket at the default budgets."""
    from nemo_tpu_torch.ingest.molly import load_molly_output
    from nemo_tpu_torch.models.case_studies import write_case_study

    return load_molly_output(write_case_study("ZK-1270-racing-sent-flag", n_runs, 0, str(tmp_path)))


@pytest.mark.cuda
def test_staged_planes_equal_unstaged(cuda, tmp_path):
    """stage_fused_inputs sends each device-lane bucket's verb arrays to the
    card on a side stream; after its event they equal the host arrays."""
    from nemo_tpu_torch.backend.torch_backend import TorchBackend, _verb_arrays

    molly = _staging_corpus(tmp_path)
    tb = TorchBackend(device=cuda)
    tb.init_graph_db("", molly)
    plan = tb.stage_fused_inputs()
    assert plan["staged"] and plan["staged_bytes"] > 0
    for bi, (on_dev, event) in plan["staged"].items():
        event.synchronize()
        pre_b, post_b = plan["batches"][bi]
        host = _verb_arrays(pre_b, post_b)
        assert set(on_dev) == set(host)
        for k, t in on_dev.items():
            assert t.is_cuda and np.array_equal(t.cpu().numpy(), np.asarray(host[k])), k


@pytest.mark.cuda
def test_dispatch_after_staging_equals_one_without(cuda, tmp_path):
    """The fused step on staged inputs (the streamed map's prefetch) gives
    the outputs of the same step without staging, bucket for bucket."""
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    molly = _staging_corpus(tmp_path)
    outs = []
    for stage in (True, False):
        tb = TorchBackend(device=cuda)
        tb.init_graph_db("", molly)
        if stage:
            assert tb.stage_fused_inputs()["staged"]
        outs.append(tb._fused())
        assert any(r["route"] == "dense" for r in tb.analysis_routes)
    for (_, _, a), (_, _, b) in zip(*outs):
        assert set(a) == set(b)
        for k in a:
            x, y = a[k], b[k]
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            assert np.array_equal(x, y), k


@pytest.mark.cuda
def test_query_device_lane_on_card_matches_cpu(cuda, tmp_path):
    """The query's sparse_device lane on the card (K2 for every -*-> hop)
    gives the cpu lane's document, on a family and the cyclic adversarial
    corpus."""
    from nemo_tpu_torch.models.case_studies import write_case_study
    from nemo_tpu_torch.models.synth import adversarial_spec, write_corpus
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus
    from nemo_tpu_torch.query.lang import parse_query

    dirs = [write_case_study("ZK-1270-racing-sent-flag", 64, 11, str(tmp_path)),
            write_corpus(adversarial_spec("cycles", n_runs=32, seed=13), str(tmp_path))]
    queries = [
        "from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> @rule[type=async] "
        "match @goal -> rule -> goal count by table",
        "from pre match rule[type=async] -> @goal -*-> rule count",
        "from post match @rule -> goal[holds=false] runs",
    ]
    for d in dirs:
        molly = ingest_corpus(d, "off")
        for text in queries:
            routes, before = [], k2.edge_wave.launches
            on_card = execute_query(parse_query(text), molly, device=cuda, use_cache=False, query_host_work=0,
                                    routes=routes)
            on_cpu = execute_query(parse_query(text), molly, device="cpu", use_cache=False, query_host_work=0)
            assert on_card == on_cpu, (d, text)
            assert {r["lane"] for r in routes} == {"sparse_device"}
            assert (k2.edge_wave.launches > before) == ("-*->" in text)
