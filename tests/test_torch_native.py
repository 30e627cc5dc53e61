"""The port's native C++ ingest against the JAX package's and its own
Python loader, on the CPU.

* ``nemo_tpu_torch.ingest.native.ingest_native`` equals
  ``nemo_tpu.ingest.native.ingest_native`` on the six case-study families
  at 60 runs, a synthetic corpus and a small corpus of giant runs: dims,
  vocabularies, every packed array, node ids, prov JSON and head fragments.
* It equals the port's own Python pack (``load_molly_output`` +
  ``pack_graph``, all pre graphs interned first), and its strings equal
  the Python objects' serializations.
* A dozen malformed corpora, from the classes of
  ``tests/test_native_malformed.py``, raise RuntimeError in both engines
  with the same message.
* A source that cannot be built or loaded raises; nothing falls back.
* The engine's counters: every file it read (runs.json and two a run) and
  their bytes, and a read and parse wall within the ``ingest.engine``
  phase around its call; the pool's size and its workers' summed reads.
* The pool: at 200 runs a family, one worker and eight give corpora
  byte-equal to each other and to the JAX package's engine; the default
  size follows the process's CPU affinity set, capped at the runs; a
  corpus with two faults under eight workers raises the fault the serial
  order meets first, as the JAX package's engine does.

Tolerance: none (integers, booleans and bytes).
"""

import ctypes
import json
import os
import shutil

import numpy as np
import pytest

from nemo_tpu.ingest.native import ingest_native as jax_ingest_native
from nemo_tpu.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu.models.synth import SynthSpec, write_corpus
from nemo_tpu_torch.graphs.packed import CorpusVocab, pack_batch, pack_graph
from nemo_tpu_torch.ingest import native
from nemo_tpu_torch.ingest.molly import load_molly_output
from nemo_tpu_torch.store.npack import head_bytes
from nemo_tpu_torch.utils.cbuild import BUILD_DIR, NativeLib
from nemo_tpu_torch.utils.timing import PhaseTimer
from portbench.gen import synth as bench_synth

FAMILY_RUNS = 60
#: Runs a family for the pool's tests.
POOL_RUNS = 200
POOL_CORPORA = sorted(CASE_STUDIES) + ["bench_synth"]
CORPORA = sorted(CASE_STUDIES) + ["synth", "giant"]
ARRAYS = (
    "table_id", "label_id", "time_id", "type_id", "is_goal", "node_mask",
    "edge_src", "edge_dst", "edge_mask", "n_nodes", "n_goals", "chain_linear",
)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_native"))
    out = {name: write_case_study(name, FAMILY_RUNS, 0, root) for name in sorted(CASE_STUDIES)}
    out["synth"] = write_corpus(SynthSpec(n_runs=12, seed=5, eot=7, name="synth"), root)
    # Two runs of ~4,200 nodes: above TorchBackend's giant threshold.
    out["giant"] = write_corpus(SynthSpec(n_runs=2, seed=2, eot=1200, name="giant"), root)
    return out


@pytest.fixture(scope="module")
def pool_corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_native_pool"))
    out = {name: write_case_study(name, POOL_RUNS, 3, root) for name in sorted(CASE_STUDIES)}
    out["bench_synth"] = bench_synth.write_corpus(bench_synth.SynthSpec(n_runs=POOL_RUNS, seed=9, name="bench_synth"), root)
    return out


def _ingest_forced(output_dir: str, workers: int) -> native.NativeCorpus:
    """``ingest_native(keep_handle=True)`` with the engine's pool forced to
    ``workers`` through the C ABI, which the package never does."""
    lib = native.NATIVE.load()
    err = ctypes.create_string_buffer(1024)
    handle = lib.nemo_ingest(os.fsencode(output_dir), err, len(err), 1, workers)
    if not handle:
        raise RuntimeError(f"native ingestion failed: {err.value.decode()}")
    return native._unpack(native.CorpusHandle(lib, handle), with_node_ids=True, keep_handle=True)


def _assert_same_corpus(a: native.NativeCorpus, b: native.NativeCorpus) -> None:
    for f in ("n_runs", "v", "e", "tables", "labels", "times", "pre_tid", "post_tid", "max_depth"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.iteration, b.iteration)
    np.testing.assert_array_equal(a.success, b.success)
    for cond in ("pre", "post"):
        for f in ARRAYS:
            x, y = getattr(a.cond(cond), f), getattr(b.cond(cond), f)
            assert x.dtype == y.dtype, (cond, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{cond}.{f}")
    assert a.node_ids_pre == b.node_ids_pre and a.node_ids_post == b.node_ids_post
    for row in range(a.n_runs):
        assert a.run_head_json(row) == b.run_head_json(row)
        for cond in ("pre", "post"):
            assert a.prov_json(cond, row) == b.prov_json(cond, row)


@pytest.mark.parametrize("name", POOL_CORPORA)
def test_pool_of_eight_equals_one_worker(pool_corpora, name):
    cd = pool_corpora[name]
    one, eight = _ingest_forced(cd, 1), _ingest_forced(cd, 8)
    assert (one.engine_stats["workers"], eight.engine_stats["workers"]) == (1, 8)
    _assert_same_corpus(one, eight)
    _assert_same_corpus(one, native.ingest_native(cd, keep_handle=True))
    _assert_same_corpus(eight, jax_ingest_native(cd, keep_handle=True))
    for k in ("files", "bytes"):
        assert one.engine_stats[k] == eight.engine_stats[k]
    assert one.engine_stats["files"] == 2 * POOL_RUNS + 1


def test_more_workers_than_cores_parse_alike(pool_corpora):
    """A stress of the pool's shared run counter: more workers than cores,
    a few times over; a run claimed twice or never would differ."""
    cd = pool_corpora["bench_synth"]
    ref = jax_ingest_native(cd, keep_handle=True)
    many = 2 * len(os.sched_getaffinity(0)) + 1
    for _ in range(3):
        got = _ingest_forced(cd, many)
        assert got.engine_stats["workers"] == many
        _assert_same_corpus(got, ref)


def test_pool_size_follows_the_affinity_set(corpora, pool_corpora):
    rule = min(max(len(os.sched_getaffinity(0)), 2), 16)
    assert native.ingest_native(pool_corpora["bench_synth"]).engine_stats["workers"] == rule
    # Never more workers than runs.
    for name in ("synth", "giant"):
        got = native.ingest_native(corpora[name])
        assert got.engine_stats["workers"] == min(rule, got.n_runs)


@pytest.mark.parametrize("name", CORPORA)
def test_ingest_equals_jax_engine(corpora, name):
    cd = corpora[name]
    port = native.ingest_native(cd, keep_handle=True)
    ref = jax_ingest_native(cd, keep_handle=True)
    for f in ("n_runs", "v", "e", "tables", "labels", "times", "pre_tid", "post_tid", "max_depth"):
        assert getattr(port, f) == getattr(ref, f), f
    np.testing.assert_array_equal(port.iteration, ref.iteration)
    np.testing.assert_array_equal(port.success, ref.success)
    for cond in ("pre", "post"):
        for f in ARRAYS:
            a, b = getattr(port.cond(cond), f), getattr(ref.cond(cond), f)
            assert a.dtype == b.dtype, (cond, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{cond}.{f}")
    assert port.node_ids_pre == ref.node_ids_pre and port.node_ids_post == ref.node_ids_post
    for row in range(port.n_runs):
        assert port.run_head_json(row) == ref.run_head_json(row)
        for cond in ("pre", "post"):
            assert port.prov_json(cond, row) == ref.prov_json(cond, row)
    assert port.static_kwargs == ref.static_kwargs


@pytest.mark.parametrize("name", CORPORA)
def test_ingest_equals_python_pack(corpora, name):
    cd = corpora[name]
    nat = native.ingest_native(cd, keep_handle=True)
    molly = load_molly_output(cd)
    vocab = CorpusVocab()
    graphs = {
        "pre": [pack_graph(r.pre_prov, vocab) for r in molly.runs],
        "post": [pack_graph(r.post_prov, vocab) for r in molly.runs],
    }
    assert (nat.tables, nat.labels, nat.times) == (vocab.tables.strings, vocab.labels.strings, vocab.times.strings)
    assert nat.iteration.tolist() == molly.runs_iters
    assert nat.success.tolist() == [r.succeeded for r in molly.runs]
    for cond, gs in graphs.items():
        py = pack_batch(molly.runs_iters, gs, nat.v, nat.e)
        nc = nat.cond(cond)
        for f in ("table_id", "label_id", "type_id", "is_goal", "node_mask", "edge_src", "edge_dst",
                  "edge_mask", "n_nodes", "n_goals"):
            np.testing.assert_array_equal(getattr(nc, f), getattr(py, f), err_msg=f"{cond}.{f}")
        for i, g in enumerate(gs):
            np.testing.assert_array_equal(nc.time_id[i, : g.n_nodes], g.time_id)
            assert nat.lazy_node_ids(cond, i) == g.node_ids
    for i, run in enumerate(molly.runs):
        assert nat.run_head_json(i) == head_bytes(run)
        assert nat.prov_json("pre", i).decode() == json.dumps(run.pre_prov.to_json())
        assert nat.prov_json("post", i).decode() == json.dumps(run.post_prov.to_json())


def test_packed_loader_matches_object_loader(corpora):
    """load_molly_output_packed: the same run bookkeeping and holds maps as
    the object loader, RawProv placeholders that splice the same JSON."""
    cd = corpora["synth"]
    packed, objs = native.load_molly_output_packed(cd), load_molly_output(cd)
    for f in ("runs_iters", "success_runs_iters", "failed_runs_iters"):
        assert getattr(packed, f) == getattr(objs, f)
    for p, o in zip(packed.runs, objs.runs):
        assert (p.time_pre_holds, p.time_post_holds) == (o.time_pre_holds, o.time_post_holds)
        assert p.pre_prov.json_str() == json.dumps(o.pre_prov.to_json())
        with pytest.raises(AttributeError, match="RawProv"):
            p.pre_prov.goals
    assert native.corpus_step_static(packed.native_corpus)["comp_linear"] in (True, False)


@pytest.mark.parametrize("name", CORPORA)
def test_engine_counts_its_files_bytes_and_wall(corpora, name):
    cd = corpora[name]
    timer = PhaseTimer()
    molly = native.load_molly_output_packed(cd, timer)
    stats = molly.native_corpus.engine_stats
    files = ["runs.json"] + [f"run_{i}_{c}_provenance.json" for i in range(len(molly.runs)) for c in ("pre", "post")]
    assert stats["files"] == len(files) == 2 * len(molly.runs) + 1
    assert stats["bytes"] == sum(os.path.getsize(os.path.join(cd, f)) for f in files)
    walls = timer.as_dict()
    assert set(walls) == {"ingest.engine", "ingest.unpack"}
    assert set(stats) == {"read_s", "parse_s", "read_thread_s", "workers", "files", "bytes"}
    assert stats["read_s"] > 0 and stats["parse_s"] > 0
    assert stats["read_s"] + stats["parse_s"] <= walls["ingest.engine"]
    assert stats["workers"] >= 1 and stats["read_thread_s"] > 0
    assert native.ingest_native(cd).engine_stats["files"] == stats["files"]


def _malformed_cases(cd: str) -> list[tuple[str, str, bytes]]:
    """(label, file, content): one or two of each corruption class."""
    with open(os.path.join(cd, "runs.json"), "rb") as fh:
        runs = fh.read()
    with open(os.path.join(cd, "run_0_pre_provenance.json"), "rb") as fh:
        prov = fh.read()
    runs_doc, prov_doc = json.loads(runs), json.loads(prov)
    brace = prov.find(b"{")

    def swap(doc, path, value):
        d = json.loads(json.dumps(doc))
        tgt = d[0] if isinstance(d, list) else d
        for key in path[:-1]:
            tgt = tgt[key]
        tgt[path[-1]] = value
        return json.dumps(d).encode()

    return [
        ("truncate", "run_0_pre_provenance.json", prov[: len(prov) // 2]),
        ("empty", "runs.json", b""),
        ("bad-bytes", "run_0_post_provenance.json", prov[:10] + b"\xff" + prov[10:]),
        ("bom", "runs.json", b"\xef\xbb\xbf" + runs),
        ("trailing-garbage", "run_0_pre_provenance.json", prov + b"} extra ["),
        ("deep-array", "run_0_pre_provenance.json", b"[" * 5000),
        ("unterminated-string", "runs.json", runs[: len(runs) - 4] + b'"abc'),
        ("lenient-number", "run_0_pre_provenance.json", prov[: brace + 1] + b'"__bad": 01, ' + prov[brace + 1 :]),
        ("iteration-type", "runs.json", swap(runs_doc, ("iteration",), "x")),
        ("goals-type", "run_0_pre_provenance.json", swap(prov_doc, ("goals",), 42)),
        ("edge-from-type", "run_0_pre_provenance.json", swap(prov_doc, ("edges",), [{"from": None, "to": "x"}])),
        ("iteration-int32", "runs.json", swap(runs_doc, ("iteration",), 2**40)),
    ]


def test_malformed_corpora_raise_alike(tmp_path):
    base = write_case_study("pb_asynchronous", 2, 11, str(tmp_path / "base"))
    cases = _malformed_cases(base)
    assert len(cases) == 12
    for k, (label, fname, content) in enumerate(cases):
        d = str(tmp_path / f"c{k}")
        shutil.copytree(base, d)
        with open(os.path.join(d, fname), "wb") as fh:
            fh.write(content)
        with pytest.raises(RuntimeError) as port_err:
            native.ingest_native(d, keep_handle=True)
        with pytest.raises(RuntimeError) as jax_err:
            jax_ingest_native(d, keep_handle=True)
        assert str(port_err.value) == str(jax_err.value), label


#: (label, [(file, corruption)]): two faults, or one late, in a corpus of
#: ERROR_RUNS runs; the serial order meets the first fault listed first.
ERROR_RUNS = 100
TWO_FAULTS = [
    ("post-70-then-row-90", [("run_70_post_provenance.json", "truncate"), ("runs.json", "iteration@90")]),
    ("row-30-then-pre-80", [("runs.json", "iteration@30"), ("run_80_pre_provenance.json", "truncate")]),
    ("truncate-99", [("run_99_pre_provenance.json", "truncate")]),
    ("deep-array-93", [("run_93_post_provenance.json", "deep")]),
]


@pytest.fixture(scope="module")
def error_base(tmp_path_factory):
    return write_case_study("pb_asynchronous", ERROR_RUNS, 11, str(tmp_path_factory.mktemp("torch_native_errors")))


@pytest.mark.parametrize("label", [c[0] for c in TWO_FAULTS])
def test_eight_workers_raise_the_serial_orders_first_fault(tmp_path, error_base, label):
    d = str(tmp_path / "c")
    shutil.copytree(error_base, d)
    for fname, kind in dict(TWO_FAULTS)[label]:
        path = os.path.join(d, fname)
        with open(path, "rb") as fh:
            raw = fh.read()
        if kind == "truncate":
            raw = raw[: len(raw) // 2]
        elif kind == "deep":
            raw = b"[" * 5000
        else:
            rows = json.loads(raw)
            rows[int(kind.split("@")[1])]["iteration"] = "x"
            raw = json.dumps(rows).encode()
        with open(path, "wb") as fh:
            fh.write(raw)
    with pytest.raises(RuntimeError) as jax_err:
        jax_ingest_native(d, keep_handle=True)
    for run in (lambda: _ingest_forced(d, 8), lambda: native.ingest_native(d, keep_handle=True)):
        with pytest.raises(RuntimeError) as port_err:
            run()
        assert str(port_err.value) == str(jax_err.value)


def test_unbuildable_source_raises(monkeypatch, tmp_path, corpus_dir):
    from nemo_tpu_torch.analysis.pipeline import run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    missing = NativeLib(tmp_path / "missing.cpp", native._bind, "nemo_abi_version", native.ABI_VERSION)
    monkeypatch.setattr(native, "NATIVE", missing)
    with pytest.raises(RuntimeError, match="missing.cpp"):
        native.ingest_native(corpus_dir)
    for mode in ("native", "auto"):
        with pytest.raises(RuntimeError, match="missing.cpp"):
            run_debug(corpus_dir, str(tmp_path / "R"), TorchBackend(device="cpu"), ingest=mode)
    assert not (tmp_path / "R").exists()
    # The object loader needs no engine.
    res = run_debug(corpus_dir, str(tmp_path / "R"), TorchBackend(device="cpu"), ingest="python", figures="none")
    assert res.ingest == "python"


def test_compile_error_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "broken_engine.cpp"
    src.write_text("int nemo_abi_version() { return 5 }\n")
    broken = NativeLib(src, native._bind, "nemo_abi_version", native.ABI_VERSION)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken_engine.cpp") as err:
        broken.load()
    assert "error" in str(err.value)
    assert not any(p.name.startswith("libbroken_engine") for p in BUILD_DIR.iterdir())


def test_abi_mismatch_raises(tmp_path):
    src = tmp_path / "old_engine.cpp"
    src.write_text('extern "C" int nemo_abi_version() { return 5; }\n')
    with pytest.raises(RuntimeError, match="ABI 5, expected 7"):
        NativeLib(src, native._bind, "nemo_abi_version", native.ABI_VERSION).load()
