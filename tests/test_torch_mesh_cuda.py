"""The device mesh on a CUDA card (marker ``cuda``).

They skip without one.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

* TorchExecutor's fused and sparse_fused dispatches with shard="on" (a
  width-1 mesh on a one-rank NCCL group) equal the unsharded dispatch on
  the card and the CPU's, the packed summary gathered and unpacked, K1 and
  K2 launched;
* the dense giant step (parallel/giant.py) on the card equals the CPU's in
  every label mode (closure labels by K1);
* ring_reach and closure_sharded on the card equal the dense versions;
* collapse_chains' scatter rewire on the card equals the CPU's.
Every output is bool or int: exact.
"""

import numpy as np
import pytest
import torch

from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.kernels import edge_wave as k2
from nemo_tpu_torch.models.pipeline_model import synth_batch_arrays


@pytest.fixture
def cuda():
    """The card; a one-rank group a test opened is closed after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    from nemo_tpu_torch.parallel import mesh

    mesh.close_local_group()


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}


def _same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def _fused_inputs(n_runs: int, seed: int):
    pre, post, static = synth_batch_arrays(n_runs=n_runs, seed=seed, device="cpu")
    arrays = {f"{c}_{f}": getattr(x, f).numpy() for c, x in (("pre", pre), ("post", post)) for f in pre.FIELDS}
    return arrays, static


@pytest.mark.cuda
@pytest.mark.parametrize("verb", ["fused", "sparse_fused"])
def test_width_one_mesh_equals_unsharded(cuda, verb):
    from nemo_tpu_torch.backend.torch_backend import TorchExecutor
    from nemo_tpu_torch.parallel import mesh

    arrays, static = _fused_inputs(12, 5)
    params = dict(static, with_diff=1, comp_linear=0)
    if verb == "sparse_fused":
        params = {k: params[k] for k in ("v", "pre_tid", "post_tid", "num_tables", "comp_linear")}
    want = _host(TorchExecutor("cpu").run(verb, dict(arrays), dict(params)))
    plain = _host(TorchExecutor(cuda).run(verb, dict(arrays), dict(params)))
    kernel = k1.closure if verb == "fused" else k2.edge_wave
    before = kernel.launches
    got = _host(TorchExecutor(cuda, shard="on").run(verb, dict(arrays), dict(params)))
    assert kernel.launches > before
    assert mesh.world_size() == 1 and "nccl" in str(torch.distributed.get_backend())
    _same(plain, want, "unsharded cuda vs cpu")
    _same(got, want, "width-1 mesh on cuda vs cpu")


def _giant_case(seed: int, eot: int):
    import tempfile

    from nemo_tpu_torch.graphs.packed import CorpusVocab, bucket_size, pack_batch, pack_graph
    from nemo_tpu_torch.ingest.molly import load_molly_output
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
    from nemo_tpu_torch.parallel.giant import giant_plan, pad_comp_labels

    with tempfile.TemporaryDirectory() as d:
        molly = load_molly_output(write_corpus(SynthSpec(n_runs=2, seed=seed, eot=eot, name="chain"), d))
    vocab = CorpusVocab()
    run = molly.runs[0]
    gpre, gpost = pack_graph(run.pre_prov, vocab), pack_graph(run.post_prov, vocab)
    v = bucket_size(max(gpre.n_nodes, gpost.n_nodes))
    e = bucket_size(max(1, len(gpre.edges), len(gpost.edges)))
    pre_b, post_b = pack_batch([0], [gpre], v, e), pack_batch([0], [gpost], v, e)
    (lin_a, d_a, lab_a), (lin_b, d_b, lab_b) = giant_plan(gpre), giant_plan(gpost)
    kw = dict(v=v, pre_tid=vocab.tables.lookup("pre"), post_tid=vocab.tables.lookup("post"),
              num_tables=bucket_size(len(vocab.tables), 8), max_depth=max(pre_b.max_depth, post_b.max_depth),
              proto_depth=max(d_a, d_b))
    labels = (pad_comp_labels(lab_a, gpre.n_nodes, v), pad_comp_labels(lab_b, gpost.n_nodes, v))
    return pre_b, post_b, kw, labels, lin_a and lin_b


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["doubling", "host", "closure"])
def test_dense_giant_step_on_the_card(cuda, mode):
    from nemo_tpu_torch.models.pipeline_model import BatchArrays
    from nemo_tpu_torch.parallel.giant import giant_analysis_step

    pre_b, post_b, kw, labels, linear = _giant_case(5, 60)
    if mode == "doubling" and not linear:
        pytest.skip("chains not linear")
    kw = dict(kw, comp_linear=mode == "doubling")
    if mode == "host":
        kw.update(pre_labels=labels[0], post_labels=labels[1])
    outs = []
    for dev in ("cpu", cuda):
        pre, post = (BatchArrays.from_packed(b, dev) for b in (pre_b, post_b))
        outs.append(_host(giant_analysis_step(pre, post, **kw)))
    _same(outs[1], outs[0], f"dense giant step ({mode}) on cuda vs cpu")


@pytest.mark.cuda
def test_ring_and_sharded_closure_on_the_card(cuda):
    from nemo_tpu_torch.kernels.closure import closure_plain
    from nemo_tpu_torch.parallel import mesh, ring

    mesh.open_local_group(cuda)
    g = torch.Generator().manual_seed(0)
    adj = (torch.rand(512, 512, generator=g) < 2 / 512).to(cuda)
    start = torch.zeros(512, dtype=torch.bool, device=cuda)
    start[:3] = True
    m = ring.make_node_mesh()
    reach = ring.ring_reach(m, adj, start, 12)
    want = start.clone()
    for _ in range(12):
        want |= (want.float() @ adj.float()) > 0.5
    assert torch.equal(reach, want)
    assert torch.equal(ring.closure_sharded(m, adj), closure_plain(adj))
    assert torch.equal(ring.closure_sharded(m, adj), k1.closure(adj.contiguous()))


@pytest.mark.cuda
def test_scatter_rewire_on_the_card(cuda):
    from nemo_tpu_torch.ops.adjacency import build_adjacency
    from nemo_tpu_torch.ops.simplify import clean_masks, collapse_chains

    pre, _post, static = synth_batch_arrays(n_runs=16, seed=3, device="cpu")
    outs = []
    for dev in ("cpu", cuda):
        b = {f: getattr(pre, f).to(dev) for f in pre.FIELDS}
        adj = build_adjacency(b["edge_src"], b["edge_dst"], b["edge_mask"], static["v"])
        a, alive = clean_masks(adj, b["is_goal"], b["node_mask"])
        outs.append([t.cpu().numpy() for t in collapse_chains(a, b["is_goal"], b["type_id"], alive,
                                                              rewire="scatter")])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
