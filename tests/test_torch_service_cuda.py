"""The sidecar on a CUDA card (marker ``cuda``), through the loopback: the
server's method table in this process, request and response as wire bytes
(the card's machine has no grpc).  They skip without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_service_cuda.py

* every verb of TorchExecutor.VERBS through the Kernel RPC equals
  TorchExecutor.run on the card, on one small report's recorded inputs;
* eight concurrent proto requests of one signature merge: fewer K1
  launches than requests, each demuxed output equal to its solo run.
"""

import threading

import numpy as np
import pytest
import torch

from nemo_tpu_torch.backend.torch_backend import TorchExecutor
from nemo_tpu_torch.kernels import closure as k1
from nemo_tpu_torch.serve.batch import KernelBatcher
from nemo_tpu_torch.service import codec, wire
from nemo_tpu_torch.service.client import RemoteAnalyzer
from nemo_tpu_torch.service.server import Loopback


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def record_verbs(root: str) -> dict:
    """verb -> (arrays, params) for every verb of TorchExecutor.VERBS, from
    cpu reports of a small synthetic corpus (device lanes) and a deep one
    (chip_smoke.py:record_verbs)."""
    from chip_smoke import record_verbs as record
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    small = write_corpus(SynthSpec(n_runs=40, seed=2, eot=6), root)
    deep = write_corpus(SynthSpec(n_runs=3, seed=5, eot=60, name="deep"), root)
    return record(root, small, deep, {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0})


@pytest.fixture(scope="module")
def verbs(tmp_path_factory):
    return record_verbs(str(tmp_path_factory.mktemp("service_cuda")))


def _host(out: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}


def _edges(out: dict, cond: str) -> set:
    src, dst, mask = (np.asarray(out[f"{cond}_clean_{k}"]) for k in ("src", "dst", "mask"))
    rows = np.broadcast_to(np.arange(src.shape[0])[:, None], src.shape)
    return set(zip(rows[mask].tolist(), src[mask].tolist(), dst[mask].tolist()))


@pytest.mark.cuda
def test_kernel_rpc_every_verb_equals_the_executor(cuda, verbs):
    assert set(verbs) == set(TorchExecutor.VERBS)
    lb = Loopback("cuda")
    ex = TorchExecutor("cuda")
    for verb, (arrays, params) in sorted(verbs.items()):
        raw, _ = lb.call("Kernel", codec.kernel_request_to_pb(verb, arrays, params).SerializeToString())
        got = codec.kernel_response_from_pb(wire.KernelResponse.FromString(raw))
        want = _host(ex.run(verb, arrays, params))
        assert set(got) == set(want), verb
        for cond in ("pre", "post"):
            if f"{cond}_clean_src" in want:
                assert _edges(got, cond) == _edges(want, cond), (verb, cond)
        for k, w in want.items():
            if not k.endswith(("_clean_src", "_clean_dst", "_clean_mask")):
                np.testing.assert_array_equal(got[k], w, err_msg=f"{verb}:{k}")


@pytest.mark.cuda
def test_concurrent_proto_requests_merge_into_fewer_launches(cuda, verbs):
    arrays, params = verbs["proto"]
    rows = arrays["adj"].shape[0] // 8
    assert rows >= 1
    reqs = [{k: v[i * rows:(i + 1) * rows] for k, v in arrays.items()} for i in range(8)]
    ex = TorchExecutor("cuda")
    solo = [_host(ex.run("proto", r, params)) for r in reqs]
    lb = Loopback("cuda")
    lb.impl.batcher = KernelBatcher(window_s=0.05)
    results = [None] * 8
    gate = threading.Barrier(8)

    def send(i):
        client = RemoteAnalyzer(lb)
        gate.wait()
        results[i] = client.kernel("proto", reqs[i], params)

    torch.cuda.synchronize()
    before = k1.closure.launches
    threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert 0 < k1.closure.launches - before < 8
    for got, want in zip(results, solo):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
