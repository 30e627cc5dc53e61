"""Several corpora, the segment-streamed map, the tree reduce and the
per-segment checkpoints of the port, against the JAX package on the CPU.

* ``corpus_report_names`` equals the JAX package's, duplicate basenames
  included, and raises alike on the same directory twice;
* ``run_debug_dirs`` over several families, prefetch on and off, writes
  the JAX package's ``run_debug_dirs`` trees;
* a corpus the store holds in three segments (18 runs, 6 per segment, the
  shape of tests/test_stream.py), streamed and in memory, result cache on
  and off, equals the JAX package's streamed report (``NEMO_STREAM=on``);
  again on the port's device lanes (every host budget 0) against the JAX
  package's streamed report forced dense; the port does not stream unless
  asked (``NEMO_STREAM`` defaults to off);
* ``merge_partials`` and ``TreeReducer`` at arities 2, 3 and 8 over
  shuffled partials equal the JAX package's, and the flat fold; the port's
  fixed arity is the JAX package's default;
* a run that raises after its first published checkpoint resumes: the
  rerun maps only the other segments (``segments_cached`` 1) and its tree
  equals an uninterrupted report.

Tolerance: none (report bytes, JSON documents).
"""

import os
import random

import pytest
import torch

from nemo_tpu.analysis import delta as jax_delta
from nemo_tpu.analysis.pipeline import _ingest as jax_ingest
from nemo_tpu.analysis.pipeline import corpus_report_names as jax_report_names
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.pipeline import run_debug_dirs as jax_run_debug_dirs
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.store import resolve_store as jax_resolve_store
from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.analysis import pipeline
from nemo_tpu_torch.analysis.pipeline import corpus_report_names, report_tree_bytes, run_debug, run_debug_dirs
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.models.case_studies import write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, grow_corpus_dir, write_corpus
from nemo_tpu_torch.store import resolve_store

FIGURES = "failed"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: The port's device lanes: no verb on the host lane.
DEVICE_LANES = {"analysis_host_work": 0, "diff_host_work": 0, "synth_host_work": 0}


def _port_backend():
    return TorchBackend(device="cpu")


def _same_tree(got: dict[str, bytes], want: dict[str, bytes]) -> None:
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


# ------------------------------------------------------------ several corpora


def test_corpus_report_names_match_jax(tmp_path):
    dirs = [str(tmp_path / "a" / "pb"), str(tmp_path / "b" / "pb"), str(tmp_path / "c" / "zk"), str(tmp_path / "zk2")]
    names = corpus_report_names(dirs)
    assert names == jax_report_names(dirs)
    assert names[2:] == ["zk", "zk2"] and names[0] != names[1] and names[0].startswith("pb-")
    twice = [str(tmp_path / "a" / "pb"), str(tmp_path / "a" / ".." / "a" / "pb")]
    with pytest.raises(ValueError, match="same report name"):
        corpus_report_names(twice)
    with pytest.raises(ValueError):
        jax_report_names(twice)
    assert corpus_report_names([]) == []


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """Three families at 12 runs, two of them under the same basename."""
    root = tmp_path_factory.mktemp("dirs")
    return [
        write_case_study("pb_asynchronous", 12, 0, str(root / "one")),
        write_case_study("CA-2083-hinted-handoff", 12, 0, str(root / "one")),
        write_case_study("pb_asynchronous", 12, 1, str(root / "two")),
    ]


@pytest.fixture(scope="module")
def jax_dirs_trees(family_dirs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_dirs"))
    res = jax_run_debug_dirs(family_dirs, out, JaxBackend, prefetch=False, figures="sample:2", ingest="python",
                             corpus_cache="off", result_cache="off")
    return [(os.path.basename(r.report_dir), jax_tree(r.report_dir)) for r in res]


@pytest.mark.parametrize("prefetch", [True, False])
def test_run_debug_dirs_matches_jax(family_dirs, jax_dirs_trees, tmp_path, prefetch):
    res = run_debug_dirs(family_dirs, str(tmp_path), _port_backend, prefetch=prefetch, figures="sample:2",
                         corpus_cache="off", result_cache="off")
    assert len(res) == len(jax_dirs_trees)
    for r, (name, want) in zip(res, jax_dirs_trees):
        assert os.path.basename(r.report_dir) == name
        _same_tree(report_tree_bytes(r.report_dir), want)
        assert r.figure_stats is res[0].figure_stats and "drain_wall_s" in r.figure_stats
        assert r.ingest == "native"
    assert res[0].figure_stats["figures"] > 0


def test_run_debug_dirs_names_the_failing_directory(family_dirs, tmp_path):
    bad = str(tmp_path / "missing-corpus")
    with pytest.raises(Exception, match="missing-corpus"):
        run_debug_dirs([family_dirs[0], bad], str(tmp_path / "R"), _port_backend, figures="sample:2",
                       corpus_cache="off", result_cache="off")


def test_cli_prefetch_flag(family_dirs, jax_dirs_trees, tmp_path, monkeypatch):
    """``--prefetch`` parses each later corpus on the worker thread; the
    trees stay the JAX package's."""
    import json

    from nemo_tpu_torch import cli

    monkeypatch.setattr("nemo_tpu_torch.utils.effective_cpu_count", lambda: 2)
    out = tmp_path / "R"
    assert cli.main(["-faultInjOut", *family_dirs, "--device", "cpu", "--results-dir", str(out), "--figures",
                     "sample:2", "--corpus-cache", "off", "--result-cache", "off", "--prefetch"]) == 0
    for k, (name, want) in enumerate(jax_dirs_trees):
        _same_tree(report_tree_bytes(str(out / name)), want)
        with open(out / name / "telemetry.json", encoding="utf-8") as fh:
            assert ("ingest_prefetch" in json.load(fh)["timings"]) == (k > 0)


def test_cli_takes_several_directories(family_dirs, jax_dirs_trees, tmp_path):
    from nemo_tpu_torch import cli

    out = tmp_path / "R"
    assert cli.main(["-faultInjOut", *family_dirs, "--device", "cpu", "--results-dir", str(out), "--figures",
                     "sample:2", "--corpus-cache", "off", "--result-cache", "off"]) == 0
    for name, want in jax_dirs_trees:
        _same_tree(report_tree_bytes(str(out / name)), want)


# ------------------------------------------------------------ streamed store


@pytest.fixture(scope="module")
def seg_store(tmp_path_factory):
    """One corpus directory grown 6 -> 12 -> 18 runs, held in three segments
    by the port's store and by the JAX package's store.  Returns (dir, the
    port's store root, the JAX package's store root)."""
    root = tmp_path_factory.mktemp("seg_store")
    full = write_corpus(SynthSpec(n_runs=18, seed=3, eot=6, name="seg18"), str(root / "full"))
    d = str(root / "corpus" / "seg18")
    cc, jcc = str(root / "cc"), str(root / "jcc")
    store, jstore = resolve_store(cc), jax_resolve_store(jcc)
    for n in (6, 12, 18):
        grow_corpus_dir(full, d, n)
        molly, _kind, snap = pipeline._ingest(d, True, store)
        if snap is not None:
            pipeline._populate(store, d, molly, snap)
        jax_ingest(d, True, jstore)
    assert [s.n_runs for s in delta.corpus_segments(store.load_packed(d))] == [6, 6, 6]
    return d, cc, jcc


@pytest.fixture(scope="module")
def jax_streamed_tree(seg_store, tmp_path_factory):
    d, _cc, jcc = seg_store
    mp = pytest.MonkeyPatch()
    mp.setenv("NEMO_STREAM", "on")
    try:
        res = jax_run_debug(d, str(tmp_path_factory.mktemp("jax_seg")), JaxBackend(), figures=FIGURES,
                            corpus_cache=jcc, result_cache="off")
    finally:
        mp.undo()
    return jax_tree(res.report_dir)


@pytest.mark.parametrize("stream", ["on", "off", "auto"])
@pytest.mark.parametrize("cache", [True, False])
def test_three_segment_store_matches_jax(seg_store, jax_streamed_tree, tmp_path, monkeypatch, stream, cache):
    d, cc, _jcc = seg_store
    monkeypatch.setenv("NEMO_STREAM", stream)
    rc = str(tmp_path / "rc") if cache else "off"
    res = run_debug(d, str(tmp_path / "R"), _port_backend(), figures=FIGURES, corpus_cache=cc, result_cache=rc)
    _same_tree(report_tree_bytes(res.report_dir), jax_streamed_tree)
    assert res.ingest == "store_hit"
    if stream == "off" and not cache:
        assert res.stream == {}  # one group: the in-memory map
    else:
        assert res.stream["streamed"] == (stream != "off") and res.stream["segments_mapped"] == 3
        assert res.stream["checkpoints"] == (3 if cache else 0) and res.stream["staged_bytes"] == 0
    if cache:
        again = run_debug(d, str(tmp_path / "R2"), _port_backend(), figures=FIGURES, corpus_cache=cc,
                          result_cache=rc)
        assert again.result_cache == {"state": "report_hit"}
        _same_tree(report_tree_bytes(again.report_dir), jax_streamed_tree)


@pytest.fixture(scope="module")
def jax_streamed_dense_tree(seg_store, tmp_path_factory):
    d, _cc, jcc = seg_store
    mp = pytest.MonkeyPatch()
    mp.setenv("NEMO_STREAM", "on")
    mp.setenv("NEMO_ANALYSIS_IMPL", "dense")
    try:
        res = jax_run_debug(d, str(tmp_path_factory.mktemp("jax_seg_dense")), JaxBackend(), figures=FIGURES,
                            corpus_cache=jcc, result_cache="off")
    finally:
        mp.undo()
    return jax_tree(res.report_dir)


@pytest.mark.parametrize("stream", ["on", "off"])
def test_three_segment_store_device_lanes_match_jax(seg_store, jax_streamed_dense_tree, tmp_path, monkeypatch,
                                                    stream):
    """Every segment's buckets, diff and synth pass on the device lanes,
    streamed and in memory, each segment a checkpoint."""
    d, cc, _jcc = seg_store
    monkeypatch.setenv("NEMO_STREAM", stream)
    backend = TorchBackend(device="cpu", **DEVICE_LANES)
    res = run_debug(d, str(tmp_path / "R"), backend, figures=FIGURES, corpus_cache=cc,
                    result_cache=str(tmp_path / "rc"))
    _same_tree(report_tree_bytes(res.report_dir), jax_streamed_dense_tree)
    assert res.stream["streamed"] == (stream == "on") and res.stream["checkpoints"] == 3
    assert backend.executor.host_runs == {} and {"fused", "diff"} <= set(backend.executor.dispatches)


def test_stream_is_off_by_default(seg_store, jax_streamed_tree, tmp_path, monkeypatch):
    """Without NEMO_STREAM the port maps a three-segment corpus in memory,
    where the JAX package streams it; the bytes are the same."""
    from nemo_tpu.analysis import stream as jax_stream
    from nemo_tpu_torch.analysis import stream

    d, cc, _jcc = seg_store
    monkeypatch.delenv("NEMO_STREAM", raising=False)
    assert (stream.stream_env(), jax_stream.stream_env()) == ("off", "auto")
    res = run_debug(d, str(tmp_path / "R"), _port_backend(), figures=FIGURES, corpus_cache=cc, result_cache="off")
    assert res.stream == {}
    _same_tree(report_tree_bytes(res.report_dir), jax_streamed_tree)


def test_sample_policy_streams_without_checkpoints(seg_store, tmp_path, monkeypatch):
    """sample:N partials are not cached per segment, so a streamed map
    publishes no checkpoint, and equals the in-memory report."""
    d, cc, _jcc = seg_store
    trees = {}
    for stream in ("on", "off"):
        monkeypatch.setenv("NEMO_STREAM", stream)
        res = run_debug(d, str(tmp_path / stream), _port_backend(), figures="sample:2", corpus_cache=cc,
                        result_cache=str(tmp_path / f"rc-{stream}"))
        assert res.stream.get("checkpoints", 0) == 0
        trees[stream] = report_tree_bytes(res.report_dir)
    _same_tree(trees["on"], trees["off"])


def test_checkpoint_resume(seg_store, jax_streamed_tree, tmp_path, monkeypatch):
    """A crash after the first published checkpoint: the rerun maps only
    the two other segments and writes the uninterrupted report."""
    d, cc, _jcc = seg_store
    rc = str(tmp_path / "rc")
    real = pipeline._publish_segment_checkpoint
    published = []

    def crash_after_first(*args, **kw):
        ok = real(*args, **kw)
        published.append(ok)
        if ok:
            raise RuntimeError("crash after the first checkpoint")
        return ok

    monkeypatch.setattr(pipeline, "_publish_segment_checkpoint", crash_after_first)
    with pytest.raises(RuntimeError, match="crash after the first checkpoint"):
        run_debug(d, str(tmp_path / "R"), _port_backend(), figures=FIGURES, corpus_cache=cc, result_cache=rc)
    assert published == [True]
    monkeypatch.setattr(pipeline, "_publish_segment_checkpoint", real)
    backend = _port_backend()
    res = run_debug(d, str(tmp_path / "R"), backend, figures=FIGURES, corpus_cache=cc, result_cache=rc)
    assert res.result_cache == {"state": "computed", "segments_cached": 1, "segments_mapped": 2, "runs_cached": 6,
                                "runs_mapped": 12}
    assert res.stream["segments_mapped"] == 2 and res.stream["checkpoints"] == 2
    _same_tree(report_tree_bytes(res.report_dir), jax_streamed_tree)
    assert not [n for n in os.listdir(tmp_path) if ".stage-" in n]


# ------------------------------------------------------------ tree reduce


def _partial_docs(seed: int, n: int = 11) -> list[dict]:
    """n partials over disjoint runs; every carrier of the anchor content
    holds the same copy, as every publishing map does."""
    rng = random.Random(seed)
    tables = [f"t{i}" for i in range(6)]
    anchor = {"corrections": ["<code>t1(node, ...)</code>"], "extensions": ["ext"], "good_proto": ["t0", "t2"]}
    docs, it = [], 0
    for k in range(n):
        iters = list(range(it, it + rng.randint(1, 4)))
        it = iters[-1] + 1
        failed = [i for i in iters if rng.random() < 0.4]
        succ = [i for i in iters if i not in failed]
        carrier = rng.random() < 0.6 or k == 0
        docs.append({
            "iters": iters,
            "success_iters": succ,
            "failed_iters": failed,
            "proto_ordered": {str(i): rng.sample(tables, 2) for i in succ},
            "present": {str(i): sorted(rng.sample(tables, 3)) for i in failed},
            "missing": {str(i): [{"rule": {"id": f"r{i}"}, "goals": []}] for i in failed},
            "achieved": {str(i): rng.randint(0, 3) for i in iters},
            "corrections": anchor["corrections"] if carrier else None,
            "extensions": anchor["extensions"] if carrier else None,
            "ext_candidates": {str(i): sorted(rng.sample(tables, 2)) for i in iters},
            "good_proto": anchor["good_proto"] if carrier else None,
            "fig_files": [f"run_{i}_pre_prov.dot" for i in iters],
        })
    return docs


def _content(doc: dict) -> dict:
    """A merged partial's content, independent of the order of its lists."""
    return {k: sorted(v) if isinstance(v, list) and k in ("iters", "success_iters", "failed_iters", "fig_files")
            else v for k, v in doc.items()}


@pytest.mark.parametrize("arity", [2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_reduce_matches_jax_and_the_flat_fold(arity, seed):
    docs = _partial_docs(seed)
    random.Random(seed + 100).shuffle(docs)
    port = [delta.SegmentPartial.from_json(d) for d in docs]
    jax = [jax_delta.SegmentPartial.from_json(d) for d in docs]
    merged = delta.merge_partials(port, arity=arity).to_json()
    assert merged == jax_delta.merge_partials(jax, arity=arity).to_json()
    flat = delta.merge_partials(port, arity=len(port)).to_json()
    assert _content(merged) == _content(flat)

    reducer, jreducer = delta.TreeReducer(arity=arity), jax_delta.TreeReducer(arity=arity)
    for p, j in zip(port, jax):
        reducer.push(p)
        jreducer.push(j)
    assert reducer.pushed == len(docs) and reducer.live() == jreducer.live()
    assert [p.to_json() for p in reducer.partials()] == [p.to_json() for p in jreducer.partials()]
    assert _content(delta.merge_partials(reducer.partials(), arity=arity).to_json()) == _content(flat)


def test_reduce_arity_is_the_jax_default(monkeypatch):
    """The port's fixed arity is the JAX package's default, and a reducer
    made without one folds at it."""
    monkeypatch.delenv("NEMO_REDUCE_ARITY", raising=False)
    assert delta.REDUCE_ARITY == jax_delta.reduce_arity() == 8
    assert delta.TreeReducer().arity == delta.REDUCE_ARITY
    docs = _partial_docs(3, n=20)
    port = [delta.SegmentPartial.from_json(d) for d in docs]
    jax = [jax_delta.SegmentPartial.from_json(d) for d in docs]
    assert delta.merge_partials(port).to_json() == jax_delta.merge_partials(jax).to_json()


def test_prefetched_parse_wall_is_recorded(family_dirs, tmp_path, monkeypatch):
    """With the prefetch thread, every corpus after the first records its
    parse's wall on the thread as ``ingest_prefetch`` in telemetry.json."""
    import json

    monkeypatch.setattr("nemo_tpu_torch.utils.effective_cpu_count", lambda: 2)
    res = run_debug_dirs(family_dirs, str(tmp_path), _port_backend, prefetch=True, figures="none",
                         corpus_cache="off", result_cache="off")
    assert "ingest_prefetch" not in res[0].timings
    for r in res[1:]:
        assert r.timings["ingest_prefetch"] > 0
        with open(os.path.join(r.report_dir, "telemetry.json"), encoding="utf-8") as fh:
            assert json.load(fh)["timings"]["ingest_prefetch"] > 0
