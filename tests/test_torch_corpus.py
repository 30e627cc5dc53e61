"""The port's packed-corpus file (``nemo_tpu_torch/graphs/corpus.py``,
``--save-corpus``) against the JAX package's, on the CPU.

A file either package saves loads in the other, with every array, id list,
status and vocabulary equal; ``run_debug(save_corpus_path=...)`` and the
CLI's ``--save-corpus`` write it (the object loader, the report unchanged),
``run_debug_dirs`` and ``ingest="native"`` refuse it.  Tolerance: none.
"""

import os

import numpy as np
import pytest

from nemo_tpu.graphs import corpus as jax_corpus
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.models.case_studies import write_case_study
from nemo_tpu_torch import cli
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug, run_debug_dirs
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.graphs import corpus as port_corpus
from nemo_tpu_torch.ingest.adapters import molly_to_trace
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load

COLUMNS = ("table_id", "label_id", "time_id", "type_id", "edges")


def _assert_same(a, b) -> None:
    assert (a.run_name, a.run_ids, a.statuses) == (b.run_name, b.run_ids, b.statuses)
    for part in ("tables", "labels", "times"):
        assert getattr(a.vocab, part).strings == getattr(b.vocab, part).strings
        assert getattr(a.vocab, part).ids == getattr(b.vocab, part).ids
    assert sorted(a.graphs) == sorted(b.graphs)
    for key, ga in a.graphs.items():
        gb = b.graphs[key]
        assert (ga.n_goals, ga.n_nodes, ga.node_ids) == (gb.n_goals, gb.n_nodes, gb.node_ids), key
        for col in COLUMNS:
            x, y = getattr(ga, col), getattr(gb, col)
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (key, col)


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_file_loads_in_the_other_package(saved_by, corpus_dir, tmp_path):
    path = str(tmp_path / "c.npz")
    if saved_by == "port":
        port_corpus.save_corpus(port_corpus.pack_corpus(port_load(corpus_dir)), path)
    else:
        jax_corpus.save_corpus(jax_corpus.pack_corpus(jax_load(corpus_dir)), path)
    expected = jax_corpus.pack_corpus(jax_load(corpus_dir))
    _assert_same(port_corpus.load_corpus(path), expected)
    _assert_same(jax_corpus.load_corpus(path), expected)


def test_pack_matches_jax_and_roundtrips(tmp_path):
    cd = write_case_study("MR-2995-failed-after-expiry", 10, 3, str(tmp_path))
    mine = port_corpus.pack_corpus(port_load(cd))
    _assert_same(mine, jax_corpus.pack_corpus(jax_load(cd)))
    path = str(tmp_path / "c.npz")
    port_corpus.save_corpus(mine, path)
    _assert_same(port_corpus.load_corpus(path), mine)


def test_unknown_version_is_refused(corpus_dir, tmp_path):
    import json

    path = str(tmp_path / "c.npz")
    port_corpus.save_corpus(port_corpus.pack_corpus(port_load(corpus_dir)), path)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["version"] = 99
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="unsupported corpus format version 99"):
        port_corpus.load_corpus(path)


def test_run_debug_saves_the_corpus(corpus_dir, tmp_path):
    """save_corpus_path pins the object loader; the report is the one
    without it; a trace-JSON corpus saves the same file as its Molly source."""
    path = str(tmp_path / "c.npz")
    res = run_debug(corpus_dir, str(tmp_path / "R"), TorchBackend(device="cpu"), figures="failed",
                    save_corpus_path=path)
    assert res.ingest == "python" and "save_corpus" in res.timings
    plain = run_debug(corpus_dir, str(tmp_path / "R0"), TorchBackend(device="cpu"), figures="failed")
    assert plain.ingest == "native"
    assert report_tree_bytes(res.report_dir) == report_tree_bytes(plain.report_dir)
    _assert_same(jax_corpus.load_corpus(path), jax_corpus.pack_corpus(jax_load(corpus_dir)))
    trace = molly_to_trace(corpus_dir, str(tmp_path / "t" / os.path.basename(corpus_dir)))
    tpath = str(tmp_path / "t.npz")
    run_debug(trace, str(tmp_path / "RT"), TorchBackend(device="cpu"), figures="none", save_corpus_path=tpath)
    _assert_same(port_corpus.load_corpus(tpath), port_corpus.load_corpus(path))


def test_save_corpus_refusals(corpus_dir, tmp_path):
    with pytest.raises(ValueError, match="incompatible with --save-corpus"):
        run_debug(corpus_dir, str(tmp_path / "R"), TorchBackend(device="cpu"), ingest="native",
                  save_corpus_path=str(tmp_path / "c.npz"))
    with pytest.raises(ValueError, match="not supported by run_debug_dirs"):
        run_debug_dirs([corpus_dir], str(tmp_path / "R"), lambda: TorchBackend(device="cpu"),
                       save_corpus_path=str(tmp_path / "c.npz"))
    with pytest.raises(SystemExit):
        cli.main(["-faultInjOut", corpus_dir, corpus_dir, "--device", "cpu", "--save-corpus",
                  str(tmp_path / "c.npz")])


def test_cli_save_corpus(corpus_dir, tmp_path):
    path = str(tmp_path / "cli.npz")
    assert cli.main(["-faultInjOut", corpus_dir, "--device", "cpu", "--results-dir", str(tmp_path / "R"),
                     "--figures", "none", "--save-corpus", path]) == 0
    _assert_same(port_corpus.load_corpus(path), jax_corpus.pack_corpus(jax_load(corpus_dir)))
