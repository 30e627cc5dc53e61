"""ctypes bindings for the port's native C++ ingestion engine
(``csrc/host/nemo_native.cpp``, C ABI version 7): Molly JSON straight to
packed batch arrays, with no per-goal Python objects.

A copy of the JAX package's ``ingest/native.py``, trimmed to the
packed-first report path (no sidecar or client packers).  The engine is
built with g++ into ``nemo_tpu_torch/build/`` on first use
(``utils/cbuild.py``); a build, load or ABI failure raises, it never falls
back to the Python loader.  The arrays, vocabularies, node ids and
serialized strings equal the Python loader's (``ingest/molly.py`` +
``graphs/packed.py:pack_graph``, interning all pre graphs in run order,
then all post), which ``tests/test_torch_native.py`` checks.

The engine reads and parses the provenance files on a pool of threads:
it walks runs.json's rows in order, then its workers claim runs in order
and parse each run's pre and post file, then it interns every graph into
the vocabularies in run order, so every id is the serial order's.  The
pool has as many workers as the process's CPU affinity set, at least 2
(a file read is a wait another worker's parse can hide) and at most 16,
and never more than the corpus's runs; ``nemo_ingest``'s last argument,
always 0 here, forces a size for tests only.  A malformed corpus raises
the error the serial order meets first.

The engine counts its own wall per corpus (``nemo_ingest_stats``;
``NativeCorpus.engine_stats``, telemetry.json's ``ingest_engine``):

* ``read_s`` and ``parse_s`` split its wall.  ``read_s`` is runs.json's
  read plus the pool's wall times its workers' share of time in file reads
  (open, read, UTF-8 check); ``parse_s`` is the rest (JSON parse,
  provenance transform, packing).
* ``read_thread_s``: the workers' file reads summed over the workers.  Over
  ``files`` it is a read's latency under the pool: growing with
  ``workers``, it says the file system serialises the opens.
* ``workers``: the pool's size; ``files`` and ``bytes``: every file read.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
from dataclasses import dataclass

import numpy as np

from nemo_tpu_torch.ingest.datatypes import FailureSpec, Message, Model, RunData
from nemo_tpu_torch.utils.cbuild import HOST_SRC_DIR, NativeLib

ABI_VERSION = 7


def _bind(lib: ctypes.CDLL) -> None:
    lib.nemo_ingest.restype = ctypes.c_void_p
    lib.nemo_ingest.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.nemo_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.nemo_copy.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12
    lib.nemo_runs.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.nemo_vocab.restype = ctypes.c_char_p
    lib.nemo_vocab.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.nemo_node_ids.restype = ctypes.c_char_p
    lib.nemo_node_ids.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.nemo_prov_json.restype = ctypes.c_char_p
    lib.nemo_prov_json.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.nemo_run_head_json.restype = ctypes.c_char_p
    lib.nemo_run_head_json.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nemo_ingest_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.nemo_free.argtypes = [ctypes.c_void_p]


NATIVE = NativeLib(HOST_SRC_DIR / "nemo_native.cpp", _bind, "nemo_abi_version", ABI_VERSION)


@dataclass
class NativeCondBatch:
    """One condition's packed batch in the pack_batch layout ([B,V]/[B,E])."""

    table_id: np.ndarray
    label_id: np.ndarray
    time_id: np.ndarray
    type_id: np.ndarray
    is_goal: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    n_nodes: np.ndarray
    n_goals: np.ndarray
    #: [B] bool: per-run @next-chain linearity checked at parse time
    #: (nemo_native.cpp:graph_chain_linear), the pointer-doubling gate.
    chain_linear: np.ndarray


class CorpusHandle:
    """Owns one live C++ corpus for lazy per-run string access (node ids,
    prov JSON, head fragments).  The arrays are copied out eagerly, so
    closing only invalidates the string accessors, which then raise."""

    def __init__(self, lib, handle) -> None:
        self._lib = lib
        self._h = handle

    def _live(self):
        if self._h is None:
            raise RuntimeError("native corpus handle already closed")
        return self._h

    def prov_json(self, cond: int, run: int) -> bytes:
        out = self._lib.nemo_prov_json(self._live(), cond, run)
        if not out:
            # The C side returns "" for an out-of-range row; splicing that
            # into debugging.json would write malformed output silently.
            raise RuntimeError(f"no serialized provenance for cond {cond} run row {run} (row out of range)")
        return out

    def run_head_json(self, run: int) -> bytes:
        out = self._lib.nemo_run_head_json(self._live(), run)
        if not out:
            raise RuntimeError(
                f"no head fragment for run row {run} (row out of range, or corpus ingested without heads)"
            )
        return out

    def node_ids(self, cond: int, run: int) -> list[str]:
        joined = self._lib.nemo_node_ids(self._live(), cond, run).decode()
        return joined.split("\n") if joined else []

    def close(self) -> None:
        if self._h is not None:
            self._lib.nemo_free(self._h)
            self._h = None

    def __del__(self) -> None:
        self.close()


@dataclass
class NativeCorpus:
    """The native ETL's product for one Molly directory."""

    n_runs: int
    v: int
    e: int
    tables: list[str]
    labels: list[str]
    times: list[str]
    pre_tid: int
    post_tid: int
    max_depth: int  # corpus-wide longest DAG path (+1), capped at v
    iteration: np.ndarray  # [B] int32
    success: np.ndarray  # [B] bool
    pre: NativeCondBatch
    post: NativeCondBatch
    node_ids_pre: list[list[str]]
    node_ids_post: list[list[str]]
    #: live C++ handle for lazy string access (keep_handle=True), else None
    handle: CorpusHandle | None = None
    #: the engine's counters of this corpus: read_s and parse_s (their sum
    #: is the engine's wall), read_thread_s, workers, files and bytes read
    #: (the module's docstring); None where no engine parsed it (a
    #: corpus-store load)
    engine_stats: dict | None = None

    def cond(self, name: str) -> NativeCondBatch:
        return self.pre if name == "pre" else self.post

    def prov_json(self, cond_name: str, row: int) -> bytes:
        """Byte-exact json.dumps(ProvData.to_json()) of one run's namespaced
        provenance, serialized by the C++ engine at parse time."""
        if self.handle is None:
            raise RuntimeError("corpus was ingested without keep_handle=True")
        return self.handle.prov_json(0 if cond_name == "pre" else 1, row)

    def run_head_json(self, row: int) -> bytes:
        """The debugging.json head fragment of one run (iteration, status,
        failureSpec, model, messages), byte-equal to the Python
        RunData round trip."""
        if self.handle is None:
            raise RuntimeError("corpus was ingested without keep_handle=True")
        return self.handle.run_head_json(row)

    def lazy_node_ids(self, cond_name: str, row: int) -> list[str]:
        if self.handle is None:
            return (self.node_ids_pre if cond_name == "pre" else self.node_ids_post)[row]
        return self.handle.node_ids(0 if cond_name == "pre" else 1, row)

    @property
    def static_kwargs(self) -> dict:
        """Static arguments of models.pipeline_model.analysis_step for the
        whole corpus, powers of two as graphs_to_step rounds them."""
        from nemo_tpu_torch.graphs.packed import bucket_size

        return dict(
            v=self.v,
            pre_tid=self.pre_tid,
            post_tid=self.post_tid,
            num_tables=bucket_size(len(self.tables), 8),
            num_labels=bucket_size(max(1, len(self.labels)), 8),
            max_depth=bucket_size(self.max_depth, 4),
        )


def _copy_cond(lib, handle, cond: int, b: int, v: int, e: int) -> NativeCondBatch:
    i32, u8 = np.int32, np.uint8
    arrs = dict(
        table_id=np.empty((b, v), i32),
        label_id=np.empty((b, v), i32),
        time_id=np.empty((b, v), i32),
        type_id=np.empty((b, v), i32),
        is_goal=np.empty((b, v), u8),
        node_mask=np.empty((b, v), u8),
        edge_src=np.empty((b, e), i32),
        edge_dst=np.empty((b, e), i32),
        edge_mask=np.empty((b, e), u8),
        n_nodes=np.empty((b,), i32),
        n_goals=np.empty((b,), i32),
        chain_linear=np.empty((b,), u8),
    )
    lib.nemo_copy(handle, cond, *(a.ctypes.data_as(ctypes.c_void_p) for a in arrs.values()))
    for k in ("is_goal", "node_mask", "edge_mask", "chain_linear"):
        arrs[k] = arrs[k].astype(bool)
    return NativeCondBatch(**arrs)


def _phase(timer, name: str):
    """``timer.phase(name)`` (utils/timing.py:PhaseTimer), or nothing
    without a timer."""
    return contextlib.nullcontext() if timer is None else timer.phase(name)


def _engine(output_dir: str, keep_handle: bool, timer=None) -> CorpusHandle:
    """The engine's parse of one directory (phase ``ingest.engine``): the
    live C++ corpus.  Raises RuntimeError when the engine cannot be built
    or loaded, or rejects the corpus."""
    lib = NATIVE.load()
    err = ctypes.create_string_buffer(1024)
    with _phase(timer, "ingest.engine"):
        handle = lib.nemo_ingest(os.fsencode(output_dir), err, len(err), int(keep_handle), 0)
    if not handle:
        raise RuntimeError(f"native ingestion failed: {err.value.decode()}")
    return CorpusHandle(lib, handle)


def _unpack(keeper: CorpusHandle, with_node_ids: bool, keep_handle: bool) -> NativeCorpus:
    """The arrays, vocabularies and counters copied out of a live C++
    corpus; the corpus is freed unless ``keep_handle``."""
    lib, handle = keeper._lib, keeper._live()
    try:
        dims = (ctypes.c_int64 * 9)()
        lib.nemo_dims(handle, dims)
        b, v, e, n_tables, n_labels, n_times, pre_tid, post_tid, max_depth = (int(x) for x in dims)
        secs, counts = (ctypes.c_double * 3)(), (ctypes.c_int64 * 3)()
        lib.nemo_ingest_stats(handle, secs, counts)
        iteration = np.empty((b,), np.int32)
        success = np.empty((b,), np.uint8)
        lib.nemo_runs(handle, iteration.ctypes.data_as(ctypes.c_void_p), success.ctypes.data_as(ctypes.c_void_p))
        tables = [lib.nemo_vocab(handle, 0, i).decode() for i in range(n_tables)]
        labels = [lib.nemo_vocab(handle, 1, i).decode() for i in range(n_labels)]
        times = [lib.nemo_vocab(handle, 2, i).decode() for i in range(n_times)]
        pre = _copy_cond(lib, handle, 0, b, v, e)
        post = _copy_cond(lib, handle, 1, b, v, e)
        ids_pre = [keeper.node_ids(0, i) for i in range(b)] if with_node_ids else []
        ids_post = [keeper.node_ids(1, i) for i in range(b)] if with_node_ids else []
        return NativeCorpus(
            n_runs=b,
            v=v,
            e=e,
            tables=tables,
            labels=labels,
            times=times,
            pre_tid=pre_tid,
            post_tid=post_tid,
            max_depth=max_depth,
            iteration=iteration,
            success=success.astype(bool),
            pre=pre,
            post=post,
            node_ids_pre=ids_pre,
            node_ids_post=ids_post,
            handle=keeper if keep_handle else None,
            engine_stats={"read_s": secs[0], "parse_s": secs[1], "read_thread_s": secs[2], "workers": counts[2],
                          "files": counts[0], "bytes": counts[1]},
        )
    finally:
        if not keep_handle:
            keeper.close()


def ingest_native(output_dir: str, with_node_ids: bool = True, keep_handle: bool = False) -> NativeCorpus:
    """Parse and pack a Molly output directory entirely in C++.

    With ``keep_handle`` the C++ corpus stays alive on the result
    (``corpus.handle``) for lazy per-run node ids, prov JSON and head
    fragments (heads are built only then).  Raises RuntimeError when the
    engine cannot be built or loaded, or rejects the corpus."""
    return _unpack(_engine(output_dir, keep_handle), with_node_ids, keep_handle)


class RawProv:
    """One run's provenance on the packed-first path: the graph lives only
    as packed arrays and its debugging.json serialization as a string held
    by the corpus.  The report writer splices ``json_str()``; the backend
    reads the arrays; any other attribute raises."""

    __slots__ = ("_corpus", "_cond", "_row")

    def __init__(self, corpus, cond: str, row: int) -> None:
        self._corpus = corpus
        self._cond = cond
        self._row = row

    def json_str(self) -> str:
        return self._corpus.prov_json(self._cond, self._row).decode()

    def __getattr__(self, name):
        raise AttributeError(
            f"RawProv has no {name!r}: packed-first ingest keeps provenance as arrays "
            "and raw JSON; use the Python loader (ingest/molly.py) for objects"
        )


class LazyRunData(RunData):
    """RunData whose failureSpec/model/messages materialize from the raw
    runs.json dict only on attribute access: on the packed-first path their
    debugging.json serialization is the C++ head fragment, so for most runs
    the typed objects are never built.  Touching or assigning one of them
    (or iteration/status) drops the head fragment, and serialization then
    rebuilds from the live objects."""

    _SENTINEL = object()

    def __init__(self, raw: dict, corpus, row: int) -> None:
        self._raw = raw
        self._lazy = {}
        self._head_row = None
        super().__init__(iteration=int(raw.get("iteration", 0)), status=raw.get("status", ""))
        self._lazy = {"failure_spec": self._SENTINEL, "model": self._SENTINEL, "messages": self._SENTINEL}
        self._head_corpus = corpus
        self._head_row = row

    @property
    def head_json(self) -> bytes | None:
        """The parse-time head fragment, or None once a field in it was
        touched."""
        if self._head_row is None:
            return None
        return self._head_corpus.run_head_json(self._head_row)

    def _drop_head(self) -> None:
        if getattr(self, "_head_row", None) is not None:
            self._head_row = None

    def _materialize(self, name: str):
        val = self._lazy[name]
        if val is self._SENTINEL:
            d = self._raw
            if name == "failure_spec":
                val = FailureSpec.from_json(d["failureSpec"]) if d.get("failureSpec") is not None else None
            elif name == "model":
                val = Model.from_json(d["model"]) if d.get("model") is not None else None
            else:
                val = [Message.from_json(m) for m in d.get("messages") or []]
            self._lazy[name] = val
            # A mutable object escapes: the parse-time head may go stale.
            self._drop_head()
        return val

    def _assign(self, name: str, v) -> None:
        self._lazy[name] = v
        self._drop_head()

    def _plain_guarded(name: str):
        def setter(self, v):
            self.__dict__[name] = v
            self._drop_head()

        return property(lambda self: self.__dict__[name], setter)

    # Data descriptors win over instance attributes of the dataclass.
    failure_spec = property(
        lambda self: self._materialize("failure_spec"), lambda self, v: self._assign("failure_spec", v)
    )
    model = property(lambda self: self._materialize("model"), lambda self, v: self._assign("model", v))
    messages = property(lambda self: self._materialize("messages"), lambda self, v: self._assign("messages", v))
    iteration = _plain_guarded("iteration")
    status = _plain_guarded("status")
    del _plain_guarded

    @property
    def holds_tables(self) -> dict:
        """The 'pre'/'post' model tables with Model.from_json's row
        normalization, which is all attach_run_metadata reads."""
        tables = (self._raw.get("model") or {}).get("tables") or {}
        return {k: [list(r) for r in tables[k]] for k in ("pre", "post") if k in tables}


def load_molly_output_packed(output_dir: str, timer=None):
    """Packed-first Molly ingest: run metadata from runs.json by the Python
    loader's rules, both provenance files of every run through the C++
    engine.  Returns a MollyOutput whose runs carry RawProv placeholders and
    which exposes the packed arrays as ``.native_corpus``.  ``timer`` (a
    PhaseTimer) gets two phases: ``ingest.engine``, the engine's call,
    and ``ingest.unpack``, the rest (copy-out, vocabularies, the runs.json
    parse and the per-run objects)."""
    from nemo_tpu_torch.ingest import molly
    from nemo_tpu_torch.ingest.molly import MollyOutput

    keeper = _engine(output_dir, keep_handle=True, timer=timer)
    with _phase(timer, "ingest.unpack"):
        corpus = _unpack(keeper, with_node_ids=False, keep_handle=True)
        out = MollyOutput(run_name=os.path.basename(os.path.normpath(output_dir)), output_dir=output_dir)
        with open(os.path.join(output_dir, "runs.json"), "r", encoding="utf-8") as f:
            raw_runs = json.load(f)
        if len(raw_runs) != corpus.n_runs:
            raise RuntimeError(f"native corpus has {corpus.n_runs} runs but runs.json has {len(raw_runs)}")
        out.runs = [LazyRunData(r, corpus, i) for i, r in enumerate(raw_runs)]
        for i, run in enumerate(out.runs):
            molly.attach_run_metadata(out, run, tables=run.holds_tables)
            run.pre_prov = RawProv(corpus, "pre", i)
            run.post_prov = RawProv(corpus, "post", i)
        out.native_corpus = corpus
    return out


def corpus_step_static(c) -> dict:
    """analysis_step statics for a whole packed corpus: ``static_kwargs``
    plus comp_linear, the AND of the per-graph parse-time checks."""
    lin = bool(np.asarray(c.pre.chain_linear).all() and np.asarray(c.post.chain_linear).all())
    return dict(c.static_kwargs, comp_linear=lin)


def packed_host_available(output_dir: str) -> bool:
    """Whether ``pack_molly_dir_host`` serves this directory: a warm corpus
    store serves it by mmap, else the engine parses it.  The port's engine
    builds or raises (utils/cbuild.py), so a failed build raises here
    rather than returning False, unlike the JAX package's quiet degrade."""
    from nemo_tpu_torch.store import resolve_store

    store = resolve_store()
    if store is not None and store.probe(output_dir) in ("hit", "grown"):
        return True
    NATIVE.load()
    return True


def pack_molly_dir_host(output_dir: str, timings: dict | None = None):
    """Directory -> (the packed corpus, analysis_step statics): host numpy
    arrays with no device transfer, for the sidecar client's chunk
    producers.  The corpus store (``NEMO_CORPUS_CACHE``) is consulted
    first and serves a warm hit by mmap (appending a grown directory's new
    runs first); a miss parses with the engine and never populates the
    store (the report pipeline and the sidecar's AnalyzeDir are the
    populating producers).  ``timings["linear_check_s"]``: the host cost of
    the corpus-level comp_linear flag, an AND over the engine's per-graph
    checks (0 on a store hit)."""
    import time

    from nemo_tpu_torch.store import resolve_store

    store = resolve_store()
    if store is not None:
        c = store.load_corpus(output_dir)
        if c is not None:
            if timings is not None:
                timings["linear_check_s"] = 0.0
            return c, corpus_step_static(c)
    c = ingest_native(output_dir, with_node_ids=False)
    t0 = time.perf_counter()
    static = corpus_step_static(c)
    if timings is not None:
        timings["linear_check_s"] = time.perf_counter() - t0
    return c, static
