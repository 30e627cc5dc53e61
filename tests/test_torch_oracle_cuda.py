"""The Python oracle against the card (marker ``cuda``): the port's
PythonBackend report of each bundled Dedalus corpus equals the
TorchBackend("cuda") report as an oracle tree
(analysis/pipeline.py:oracle_tree_diff), with every cache off.  They skip
without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_oracle_cuda.py
"""

import pytest
import torch

from nemo_tpu_torch.analysis.pipeline import oracle_tree_diff, report_tree_bytes, run_debug
from nemo_tpu_torch.backend.python_ref import PythonBackend
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.dedalus.faults import write_molly_output
from nemo_tpu_torch.dedalus.parser import load_program
from nemo_tpu_torch.dedalus.registry import BUNDLED_SPECS, bundled_spec_path
from nemo_tpu_torch.kernels import closure as k1

CACHES_OFF = dict(corpus_cache="off", result_cache="off")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUNDLED_SPECS))
def test_oracle_tree_equals_the_cards(cuda, name, tmp_path):
    corpus = write_molly_output(load_program(bundled_spec_path(name)), BUNDLED_SPECS[name], str(tmp_path / "in"),
                                name)
    k1.closure.launches = 0
    card = run_debug(corpus, str(tmp_path / "cuda"), TorchBackend(device="cuda", analysis_host_work=0,
                                                                  diff_host_work=0, synth_host_work=0), **CACHES_OFF)
    assert k1.closure.launches > 0
    oracle = run_debug(corpus, str(tmp_path / "python"), PythonBackend(), **CACHES_OFF)
    assert card.result_cache == oracle.result_cache == {"state": "off"}
    mine = report_tree_bytes(oracle.report_dir)
    assert "debugging.json" in mine and "repairs.json" in mine
    assert oracle_tree_diff(mine, report_tree_bytes(card.report_dir)) == []
