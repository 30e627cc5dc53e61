"""TorchBackend: the analysis path on one device, with the host lane.

The device boundary is ``TorchExecutor.run(verb, arrays, params)``, the
contract of the JAX package's ``LocalExecutor`` (backend/jax_backend.py):
named kernels over named numpy arrays and integer params.  Verbs: ``fused``
(one dense dispatch per joint (pre, post) bucket: condition marking,
clean-copy, chain contraction, prototype bitsets), ``sparse_fused`` (the
same analysis as gather/scatter waves over the [B,E] edge planes),
``diff`` and ``sparse_diff`` (one good-run-anchored dispatch over all failed
runs, dense or sparse) and ``synth_ext`` (per-run extension candidates).

Beside them runs the host lane, the JAX package's exact numpy engine
(ops/sparse_host.py, ops/diff.py:diff_masks_host,
parallel/giant.py:giant_analysis_host), route ``sparse``.  Routes follow
the JAX package's device-backend auto (its ``crossover``): a bucket whose
work ``B x (V + E)`` is within ``analysis_host_work`` goes to the host
lane; past the dense memory watermark (reason ``mem``) or large and very
sparse (``density``) to ``sparse_device``; else ``dense``.  Runs above
``giant_v`` nodes leave the buckets for ``sparse_device`` one at a time.
The diff goes to the host for a giant good run or within
``diff_host_work``, else sparse past the watermark, else dense; the synth
pass to the host within ``synth_host_work``.

The fused buckets, the giant runs and the synth buckets are jobs
(parallel/sched.py:Job) drained as ``NEMO_SCHED`` says: ``off`` (the
default) runs each on its routed lane in order on the caller's thread;
``auto`` and ``on`` drain them through the cost-model scheduler, one worker
thread per lane, where an unpinned job may run on another lane than its
route's and a device-side out-of-memory or deadline fails over to the host
lane, recorded.  Results land by job index either way.  Every other
device-lane failure raises; nothing falls back silently.
Packing, bucketing and the report-facing extraction are host numpy.

The report verbs (``pull_pre_post_prov``, ``create_naive_diff_prov``'s
overlays, the trigger queries) build host property graphs lazily, only for
the runs a caller asks for, from rows gathered off the device in one batch.

Every corpus reaches the device as packed corpus arrays.  A packed-first
ingest's (``molly.native_corpus``: the C++ engine's arrays or a
corpus-store load) is read in place; the Python loader's run objects are
packed once into the same arrays (``store/npack.py:payload_from_molly``).
The vocabulary is the corpus's, per-run graphs are lazy array views, the
buckets are sliced from the corpus arrays and the linear-chain gate is the
per-graph flags; no graph is repacked.
"""

from __future__ import annotations

import contextlib
import os
import resource
import threading
import time

import numpy as np
import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import log as _obs_log
from nemo_tpu_torch.analysis.corrections import synthesize_corrections, synthesize_extensions
from nemo_tpu_torch.analysis.protos import intersect_proto, missing_from, union_proto, wrap_code
from nemo_tpu_torch.analysis.queries import extension_candidates, find_post_triggers, find_pre_triggers
from nemo_tpu_torch.backend.base import GraphBackend, NoSuccessfulRunError  # noqa: F401 (re-exported)
from nemo_tpu_torch.device import resolve_device
from nemo_tpu_torch.graphs.packed import (
    TYPE_NAMES,
    CorpusGraphs,
    CorpusVocab,
    PackedBatch,
    bucket_size,
    bucketize_pairs_corpus,
    pack_batch,
    rewrite_run_prefix,
    unpack_to_pgraph,
)
from nemo_tpu_torch.graphs.pgraph import PGraph, PNode
from nemo_tpu_torch.ingest.datatypes import Goal, MissingEvent, Rule
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.kernels.build import thread_loads
from nemo_tpu_torch.models.pipeline_model import (
    DIFF_PACK_LAYOUT,
    SUMMARY_PACK_LAYOUT,
    BatchArrays,
    analysis_step,
)
from nemo_tpu_torch.ops.adjacency import build_adjacency
from nemo_tpu_torch.ops.diff import diff_masks, diff_masks_host
from nemo_tpu_torch.ops.proto import DEPTH_INF
from nemo_tpu_torch.ops.sparse_device import (
    CsrAdjRows,
    diff_masks_sparse_device,
    sparse_device_step,
    synth_ext_candidates,
)
from nemo_tpu_torch.ops.sparse_host import sparse_analysis_step, synth_ext_host
from nemo_tpu_torch.parallel import sched as sched_mod
from nemo_tpu_torch.parallel.giant import giant_analysis_host, giant_linear, giant_plan, pad_comp_labels
from nemo_tpu_torch.platform import profile as _platform_profile
from nemo_tpu_torch.report.dot import DotGraph
from nemo_tpu_torch.report.figures import create_diff_dot, create_dot
from nemo_tpu_torch.utils import chaos as _chaos

#: Shadow-run id offsets of the simplified graphs (preprocessing.go:15) and
#: of the differential-provenance graphs (differential-provenance.go:40).
CLEAN_OFFSET = 1000
DIFF_OFFSET = 2000

_log = _obs_log.get_logger("nemo.backend")


def _device_annotation(name: str):
    """A ``torch.profiler.record_function`` label around one kernel
    dispatch, so a profiler capture (``run_debug(profile_dir=...)``, the
    CLI's ``--profile``) carries the obs span's name on the device
    timeline: the counterpart of the JAX package's ``TraceAnnotation``.
    Entered only while a capture is running: ``record_function`` costs
    host time even with no profiler."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


#: Per-signature kernel cost table: one record per (verb, input shapes and
#: dtypes, statics) this process dispatched, with the JAX package's fields
#: (``jax_backend.py:_record_kernel_cost``).  ``flops`` and
#: ``bytes_accessed`` are None (they come from XLA's cost analysis, which
#: eager PyTorch has no counterpart of) and ``compiled`` is False (no jit).
_KERNEL_COSTS: dict[tuple, dict] = {}

#: Dispatch tick of the memory-watermark throttle.
_MEM_SAMPLE_TICK = [0]

#: Guards the cost table and the tick: the scheduler's lanes dispatch from
#: several threads.
_COST_LOCK = threading.Lock()


def _dtype_name(a) -> str:
    d = getattr(a, "dtype", None)
    return type(a).__name__ if d is None else str(d).removeprefix("torch.")


def _cost_signature(verb: str, arrays: dict, params: dict) -> tuple:
    """verb + per-input (name, shape, dtype) + sorted statics."""
    shapes = tuple(
        (n, tuple(a.shape), _dtype_name(a)) for n, a in sorted(arrays.items()) if a is not None
    )
    return (verb, shapes, tuple(sorted((k, int(v)) for k, v in params.items())))


def _record_kernel_cost(verb: str, sig: tuple, wall_s: float, pad_rows: int) -> bool:
    """First sight of a signature files its record with the dispatch's
    wall; every sight bumps its dispatch count.  True on first sight.
    Past ``NEMO_COST_MAX_SIGNATURES`` (default 512) signatures, new ones
    are counted in ``kernel.cost.uncosted_dispatches`` instead."""
    with _COST_LOCK:
        rec = _KERNEL_COSTS.get(sig)
        first = rec is None
        if first:
            try:
                cap = int(os.environ.get("NEMO_COST_MAX_SIGNATURES", "512"))
            except ValueError:
                cap = 512
            if len(_KERNEL_COSTS) >= cap:
                obs.metrics.inc("kernel.cost.uncosted_dispatches")
                return False
            rec = _KERNEL_COSTS[sig] = {
                "verb": verb,
                "shapes": " ".join(f"{n}[{','.join(map(str, s))}]{d}" for n, s, d in sig[1]),
                "statics": dict(sig[2]),
                "flops": None,
                "bytes_accessed": None,
                "first_dispatch_s": wall_s,
                "compiled": False,
                "dispatches": 0,
                "pad_rows": int(pad_rows),
            }
        rec["dispatches"] += 1
        rec["pad_rows"] = int(pad_rows)
        return first


def kernel_cost_snapshot() -> list[dict]:
    """The per-signature cost table as JSON-able records, most-dispatched
    first: telemetry.json's ``kernel_cost`` section."""
    with _COST_LOCK:
        recs = [dict(rec) for rec in _KERNEL_COSTS.values()]
    return sorted(
        recs,
        key=lambda r: (-r["dispatches"], r["verb"], r["shapes"]),
    )


def sample_memory_watermarks() -> dict:
    """The process peak RSS always, and, once this process has used the
    card, its allocator's peak and current bytes over every device
    (``torch.cuda.max_memory_allocated`` / ``memory_allocated``; the peak
    is never reset, so it is monotone within a process, as the JAX
    package's PJRT peaks are).  Recorded as the ``mem.*`` gauges too."""
    out: dict = {}
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on Linux
    out["host_peak_rss_bytes"] = int(ru) * 1024
    obs.metrics.gauge("mem.host_peak_rss_bytes", out["host_peak_rss_bytes"])
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        n = torch.cuda.device_count()
        peak = sum(int(torch.cuda.max_memory_allocated(i)) for i in range(n))
        in_use = sum(int(torch.cuda.memory_allocated(i)) for i in range(n))
        out["device_peak_bytes"] = peak
        out["device_bytes_in_use"] = in_use
        obs.metrics.gauge("mem.device_peak_bytes", peak)
        obs.metrics.gauge("mem.device_bytes_in_use", in_use)
    return out


def _k_fused(*args):
    pre = BatchArrays(*args[:8])
    post = BatchArrays(*args[8:16])
    (v, pre_tid, post_tid, num_tables, num_labels, max_depth, with_diff, comp_linear,
     pack_out) = args[16:]
    return analysis_step(
        pre,
        post,
        v=v,
        pre_tid=pre_tid,
        post_tid=post_tid,
        num_tables=num_tables,
        num_labels=num_labels,
        max_depth=max_depth,
        with_diff=bool(with_diff),
        comp_linear=bool(comp_linear),
        pack_out=bool(pack_out),
    )


def _k_sparse_fused(*args):
    pre = BatchArrays(*args[:8])
    post = BatchArrays(*args[8:16])
    v, pre_tid, post_tid, num_tables, comp_linear, pack_out = args[16:]
    return sparse_device_step(
        pre,
        post,
        v=v,
        pre_tid=pre_tid,
        post_tid=post_tid,
        num_tables=num_tables,
        comp_linear=bool(comp_linear),
        pack_out=bool(pack_out),
    )


def _k_diff(edge_src, edge_dst, edge_mask, is_goal, node_mask, label_id, fail_bits, v, max_depth):
    adj_good = build_adjacency(edge_src, edge_dst, edge_mask, v)[0]
    return diff_masks(adj_good, is_goal, node_mask, label_id, fail_bits, max_depth)


def _k_synth_ext(
    edge_src, edge_dst, edge_mask, is_goal, node_mask, type_id, table_id, holds, v, num_tables
):
    return synth_ext_candidates(
        edge_src, edge_dst, edge_mask, is_goal, node_mask, type_id, table_id, holds,
        v=v, num_tables=num_tables,
    )


#: Field order of BatchArrays, used to (de)serialize the fused verb's inputs
#: through the executor's named-array contract.
_BA_FIELDS = BatchArrays.FIELDS


def unpack_summary(
    packed: np.ndarray, b: int, v: int, t: int, with_diff: bool = False
) -> dict[str, np.ndarray]:
    """Inverse of the pack_out folding (SUMMARY_PACK_LAYOUT +
    DIFF_PACK_LAYOUT): one host np.unpackbits + views."""
    layout = SUMMARY_PACK_LAYOUT + (DIFF_PACK_LAYOUT if with_diff else ())
    dims = {"bv": (b, v), "b": (b,), "bt": (b, t), "t": (t,)}
    flat = np.unpackbits(np.asarray(packed)).astype(bool)
    out: dict[str, np.ndarray] = {}
    ofs = 0
    for name, key in layout:
        shape = dims[key]
        n = int(np.prod(shape))
        out[name] = flat[ofs : ofs + n].reshape(shape)
        ofs += n
    return out


def _children_of_edges(kept: np.ndarray, v: int):
    """children(slot) -> [V] bool over a kept [K,2] edge list (the sparse
    diff's edge_keep, applied to the good run's edges)."""

    def children(r: int) -> np.ndarray:
        row = np.zeros(v, dtype=bool)
        row[kept[kept[:, 0] == r, 1]] = True
        return row

    return children


def _dense_of_edges(kept: np.ndarray, v: int) -> np.ndarray:
    """[V,V] bool plane of a kept [K,2] edge list."""
    dense = np.zeros((v, v), dtype=bool)
    if len(kept):
        dense[kept[:, 0], kept[:, 1]] = True
    return dense


def _gather_rows(a, rows: list[int]):
    """Rows ``rows`` of a per-bucket output: one index_select on the
    tensor's device (the host copy is the caller's), or the rows of a
    CsrAdjRows, densified for those rows only."""
    if isinstance(a, torch.Tensor):
        return a.index_select(0, torch.as_tensor(rows, dtype=torch.long, device=a.device))
    return a[np.asarray(rows)]


def _to_host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on_device(a, device: torch.device) -> torch.Tensor:
    """One verb input on the executor's device: a staged tensor as it is, a
    numpy array copied up."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a)).to(device)


class TorchExecutor:
    """The backend's device boundary: named kernels over named numpy arrays
    and integer params, run on one device."""

    VERBS = {
        "diff": (
            _k_diff,
            ("edge_src", "edge_dst", "edge_mask", "is_goal", "node_mask", "label_id", "fail_bits"),
            ("v", "max_depth"),
            ("node_keep", "edge_keep", "frontier_rule", "missing_goal"),
        ),
        "fused": (
            _k_fused,
            tuple(f"pre_{f}" for f in _BA_FIELDS) + tuple(f"post_{f}" for f in _BA_FIELDS),
            (
                "v",
                "pre_tid",
                "post_tid",
                "num_tables",
                "num_labels",
                "max_depth",
                "with_diff",
                "comp_linear",
                "pack_out",
            ),
            None,  # dict-returning: output names come from analysis_step
        ),
        "sparse_fused": (
            _k_sparse_fused,
            tuple(f"pre_{f}" for f in _BA_FIELDS) + tuple(f"post_{f}" for f in _BA_FIELDS),
            ("v", "pre_tid", "post_tid", "num_tables", "comp_linear", "pack_out"),
            None,  # dict-returning: output names come from sparse_device_step
        ),
        "sparse_diff": (
            diff_masks_sparse_device,
            ("edge_src", "edge_dst", "edge_mask", "is_goal", "node_mask", "label_id", "fail_bits"),
            ("v",),
            ("node_keep", "edge_keep", "frontier_rule", "missing_goal"),
        ),
        "synth_ext": (
            _k_synth_ext,
            ("edge_src", "edge_dst", "edge_mask", "is_goal", "node_mask",
             "type_id", "table_id", "holds"),
            ("v", "num_tables"),
            ("ext_bits",),
        ),
    }

    #: Outputs that stay on the device, by verb.  The fused steps' dense
    #: [B,V,V] clean adjacencies (plus alive/type rows) and the dense diff's
    #: [F,V,V] edge_keep planes are read by row gathers for the runs a
    #: figure or a missing-event list needs, never whole.  The sparse
    #: step's contracted edge lists come back to the host for CsrAdjRows.
    _CLEAN = frozenset(
        {"pre_adj_clean", "post_adj_clean", "pre_alive", "post_alive", "pre_type", "post_type"}
    )
    ON_DEVICE = {"fused": _CLEAN, "sparse_fused": _CLEAN, "diff": frozenset({"edge_keep"})}

    #: Params that may be absent; 0 selects the generic path, except
    #: pack_out, which the executor resolves for its own device.
    OPTIONAL_PARAMS = frozenset({"comp_linear", "pack_out"})

    #: Verbs batched over the run axis: the ``kernel.batch_rows`` signal.
    BATCHED_VERBS = frozenset({"fused", "sparse_fused"})

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        #: dispatches per verb since construction.
        self.dispatches: dict[str, int] = {}
        #: host wall seconds per verb: upload, compute and the copy of the
        #: outputs back (which waits for the device).
        self.wall_s: dict[str, float] = {}
        #: host-lane runs per verb (the JAX package's metric names:
        #: sparse_fused, sparse_giant, sparse_diff, synth_host), counted here
        #: beside the dispatches so that a result-cache hit can be shown to
        #: compute nothing on either lane.
        self.host_runs: dict[str, int] = {}
        #: the three counts are bumped by the scheduler's lanes at once
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def last_dispatch_cold(self) -> bool:
        """Whether this thread's last dispatch paid a one-off cost: the
        verb's first dispatch on this device in the process, or a kernel
        library built or loaded during it (the scheduler keeps such walls
        out of its cost model)."""
        return getattr(self._tls, "cold", False)

    def count_host(self, verb: str) -> None:
        """One host-lane run, counted under the same ``kernel.dispatches.*``
        prefix as the device verbs, as the JAX package counts it: the
        result cache's zero-dispatch evidence sums the prefix."""
        with self._lock:
            self.host_runs[verb] = self.host_runs.get(verb, 0) + 1
        obs.metrics.inc(f"kernel.dispatches.{verb}")

    def run(
        self, verb: str, arrays: dict, params: dict, rows: int | None = None
    ) -> dict[str, np.ndarray]:
        """Returns a dict of numpy arrays, except the verb's ON_DEVICE bulk
        outputs, which stay tensors on the device.  An input may already be
        a tensor on the device (staged by ``stage_fused_inputs``).  ``rows``
        is the caller's real-run count (the batches carry padding rows): the
        dense verbs compute every row regardless, and it feeds the
        ``kernel.batch_rows`` histogram and the cost table only.

        Instrumented as the JAX package's ``LocalExecutor.run``: a
        ``kernel:<verb>`` span (``upload_bytes``: the bytes of the inputs
        as given, numpy or staged tensors; ``rows``) around the dispatch,
        which is host-side (nothing here waits for the device), the
        ``kernel.*`` counters, the cost table, the memory watermarks and
        the slow-dispatch watchdog (``NEMO_SLOW_DISPATCH_MS``)."""
        if verb not in self.VERBS:
            raise ValueError(f"unknown kernel verb {verb!r}")
        # Chaos injection point (utils/chaos.py): one env lookup when
        # NEMO_CHAOS is unset; armed, it fails or wedges the first N
        # dispatches, before anything is counted or launched.
        _chaos.on_device_dispatch(verb)
        fn, array_names, param_names, out_names = self.VERBS[verb]
        if verb in self.BATCHED_VERBS and "pack_out" not in params:
            # One bit-packed device->host copy on the card; on the CPU the
            # "copy" is free.
            params = dict(params, pack_out=int(self.device.type == "cuda"))
        statics = [
            int(params.get(n, 0)) if n in self.OPTIONAL_PARAMS else int(params[n])
            for n in param_names
        ]
        upload = sum(int(a.nbytes) for a in arrays.values() if a is not None)
        span_attrs = {"upload_bytes": upload}
        b_in = rows_real = None
        if verb in self.BATCHED_VERBS and arrays.get("pre_is_goal") is not None:
            b_in = int(arrays["pre_is_goal"].shape[0])
            rows_real = min(int(rows), b_in) if rows is not None else b_in
            obs.metrics.observe("kernel.batch_rows", rows_real)
            span_attrs["rows"] = rows_real
        elif rows is not None and verb == "synth_ext":
            b_in = int(arrays["is_goal"].shape[0])
            rows_real = min(int(rows), b_in)
            span_attrs["rows"] = rows_real
        obs.metrics.inc(f"kernel.dispatches.{verb}")
        obs.metrics.inc("kernel.upload_bytes", upload)
        with self._lock:
            self.dispatches[verb] = self.dispatches.get(verb, 0) + 1
        cold = sched_mod.first_dispatch(verb, self.device)
        loads = thread_loads()
        t0 = time.perf_counter()
        try:
            args = [_on_device(arrays[n], self.device) for n in array_names]
            t_disp = time.perf_counter()
            with obs.span(f"kernel:{verb}", **span_attrs):
                with _device_annotation(f"nemo:{verb}"):
                    out = fn(*args, *statics)
            wall_s = time.perf_counter() - t_disp
            first = _record_kernel_cost(
                verb, _cost_signature(verb, arrays, params), wall_s,
                pad_rows=(b_in - rows_real) if rows_real is not None else 0,
            )
            self._tls.cold = cold or thread_loads() != loads
            # Watermarks off the hot path: a signature's first dispatch and
            # every 64th (peaks are monotone), plus one at report time.
            with _COST_LOCK:
                _MEM_SAMPLE_TICK[0] += 1
                tick = _MEM_SAMPLE_TICK[0]
            if first or tick % 64 == 0:
                sample_memory_watermarks()
            slow_ms = _obs_log.slow_dispatch_ms()
            if slow_ms and wall_s * 1000.0 > slow_ms:
                obs.metrics.inc("watchdog.slow_kernel")
                _log.warning(
                    "kernel.slow_dispatch",
                    verb=verb,
                    wall_ms=round(wall_s * 1000.0, 1),
                    threshold_ms=slow_ms,
                    compiled=False,
                    rows=span_attrs.get("rows"),
                    v=int(params["v"]) if "v" in params else None,
                    upload_bytes=upload,
                )
            return self._materialize(verb, out, arrays, params, out_names)
        finally:
            with self._lock:
                self.wall_s[verb] = self.wall_s.get(verb, 0.0) + time.perf_counter() - t0

    def _materialize(self, verb: str, out, arrays: dict, params: dict, out_names) -> dict:
        keep = self.ON_DEVICE.get(verb, frozenset())
        if isinstance(out, dict):
            res = {n: (o if n in keep else o.cpu().numpy()) for n, o in out.items()}
            if "packed_summary" in res:
                res.update(
                    unpack_summary(
                        res.pop("packed_summary"),
                        b=int(arrays["pre_is_goal"].shape[0]),
                        v=int(params["v"]),
                        t=int(params["num_tables"]),
                        with_diff=bool(params.get("with_diff", 0)),
                    )
                )
            return res
        if not isinstance(out, tuple):
            out = (out,)
        return {n: (o if n in keep else o.cpu().numpy()) for n, o in zip(out_names, out)}


def _verb_arrays(pre_b: PackedBatch, post_b: PackedBatch) -> dict[str, np.ndarray]:
    """The fused verbs' named-array inputs for one (pre, post) bucket."""
    return {
        f"{prefix}_{f}": getattr(b, f)
        for prefix, b in (("pre", pre_b), ("post", post_b))
        for f in _BA_FIELDS
    }


def _wrap_sparse_clean(res: dict, v: int) -> dict:
    """sparse_fused output -> a fused-compatible result: the contracted
    ``{cond}_clean_src/dst/mask`` edge planes become lazy
    ``{cond}_adj_clean`` CsrAdjRows views."""
    out = dict(res)
    for cond in ("pre", "post"):
        out[f"{cond}_adj_clean"] = CsrAdjRows(
            out.pop(f"{cond}_clean_src"),
            out.pop(f"{cond}_clean_dst"),
            out.pop(f"{cond}_clean_mask"),
            v=v,
        )
    return out


class _CorpusPacked:
    """(run iteration, cond) -> PackedGraph over a packed corpus: each graph
    is a lazy array view, built on first access instead of repacked."""

    def __init__(self, graphs: CorpusGraphs, row_by_iter: dict[int, int]) -> None:
        self._graphs = graphs
        self._row_by_iter = row_by_iter

    def __getitem__(self, key: tuple[int, str]):
        rid, cond = key
        return self._graphs.get(cond, self._row_by_iter[rid])


#: The synth pass's route records by lane: its device lane is the
#: synth_ext verb, which has no dense form.
_SYNTH_ROUTE_OF_LANE = {"device": "sparse_device", "host": "sparse"}


#: Analysis routes a caller may ask for: per-bucket auto routing, or one
#: lane forced for every verb: ``dense`` (the fused dense step and diff),
#: ``sparse`` (the host lane, giants and synth included) or
#: ``sparse_device``.  Giant runs never take the dense step: the port has no
#: dense giant path, so under ``dense`` they take ``sparse_device``.
ANALYSIS_IMPLS = ("auto", "dense", "sparse", "sparse_device")


def _stage_arrays(arrays: dict[str, np.ndarray], device: torch.device, stream) -> tuple[dict, object, int]:
    """Copy one bucket's verb arrays into pinned host memory and send them
    to ``device`` on the side ``stream`` without blocking; returns (the
    device tensors, the event recorded after the copies, the bytes)."""
    pinned = {k: torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for k, a in arrays.items()}
    with torch.cuda.stream(stream):
        on_dev = {k: p.to(device, non_blocking=True) for k, p in pinned.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return on_dev, event, sum(p.numel() * p.element_size() for p in pinned.values())


def _adopt_staged(on_dev: dict, event, device: torch.device) -> dict:
    """Staged tensors for a dispatch on the current stream: it waits for the
    side stream's copies, and each tensor is marked used by it, so the
    caching allocator does not hand its memory out before the dispatch is
    done."""
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for t in on_dev.values():
        t.record_stream(cur)
    return on_dev


class TorchBackend(GraphBackend):
    """The analysis path of the JAX package's ``JaxBackend`` on one device:
    fused buckets (dense, sparse on the device, or the host lane), giant
    runs, the good-run-anchored diff and the synth_ext extension pass, with
    the same host-side extraction and report verbs.

    Route knobs, with the JAX package's defaults: ``analysis_impl`` (see
    ANALYSIS_IMPLS), the host-lane work budgets ``analysis_host_work``,
    ``diff_host_work`` and ``synth_host_work`` (0 sends no work to the
    host), ``giant_v`` (runs with more nodes leave the buckets),
    ``sparse_device_mem_bytes`` (dense footprint watermark; 0 disables),
    ``sparse_device_density`` and ``sparse_device_min_v`` (the density
    crossover; density 0 disables).  ``auto`` resolves the same on cpu and
    cuda.  The jobs drain as ``NEMO_SCHED`` says (the module's docstring).

    The budgets, the watermark and the density default to None: resolved
    at ``init_graph_db``, after ``platform.ensure_calibrated`` on the
    executor's device, as the explicit argument, else the device's measured
    profile, else the seed (platform/profile.py:CONSTANTS).  Until then
    they hold the argument or the seed."""

    #: run_debug's ingest policy reads this: the backend consumes packed
    #: corpus arrays, so ``ingest="auto"`` takes the native loader.
    supports_packed_ingest = True

    def __init__(
        self,
        device=None,
        analysis_impl: str = "auto",
        giant_v: int = 4096,
        sparse_device_mem_bytes: int | None = None,
        sparse_device_density: float | None = None,
        sparse_device_min_v: int = 1024,
        analysis_host_work: int | None = None,
        diff_host_work: int | None = None,
        synth_host_work: int | None = None,
        executor: TorchExecutor | None = None,
    ) -> None:
        if analysis_impl not in ANALYSIS_IMPLS:
            raise ValueError(f"analysis_impl {analysis_impl!r} (expected one of {ANALYSIS_IMPLS})")
        self.executor = executor if executor is not None else TorchExecutor(device)
        self.analysis_impl = analysis_impl
        self.giant_v = int(giant_v)
        self.sparse_device_min_v = int(sparse_device_min_v)
        #: the profile-resolved knobs as given (None: not given)
        self._given = {
            "analysis_host_work": analysis_host_work,
            "diff_host_work": diff_host_work,
            "synth_host_work": synth_host_work,
            "sparse_device_mem_bytes": sparse_device_mem_bytes,
            "sparse_device_density": sparse_device_density,
        }
        self._resolve_knobs(_platform_profile.SEEDED)
        #: one record per routed dispatch of the current corpus: verb,
        #: route, rows, v, e, work, reason (the JAX package's
        #: analysis_routes); kept past close_db for the caller to read.
        self.analysis_routes: list[dict] = []
        self._release(None)

    def stream_clone(self) -> "TorchBackend":
        """A fresh backend with the same knobs for the segment-streamed map,
        sharing the executor (its device and counts): only the per-corpus
        state is the clone's own."""
        return type(self)(
            analysis_impl=self.analysis_impl,
            giant_v=self.giant_v,
            sparse_device_min_v=self.sparse_device_min_v,
            executor=self.executor,
            **self._given,
        )

    def _resolve_knobs(self, values: dict) -> None:
        """Set the profile-resolved knobs: each argument as given, else its
        constant's value in ``values`` (sparse_device_mem_mb in MB)."""
        given = self._given
        mem = given["sparse_device_mem_bytes"]
        self.sparse_device_mem_bytes = int(values["sparse_device_mem_mb"] * 1e6) if mem is None else int(mem)
        density = given["sparse_device_density"]
        self.sparse_device_density = float(values["sparse_device_density"] if density is None else density)
        for name in ("analysis_host_work", "diff_host_work", "synth_host_work"):
            setattr(self, name, int(values[name] if given[name] is None else given[name]))

    def profile_args(self) -> dict:
        """The explicit knobs as profile constants (name -> value in the
        constant's unit), for the arg > measured > seeded table."""
        args = {k: v for k, v in self._given.items() if v is not None and k != "sparse_device_mem_bytes"}
        if self._given["sparse_device_mem_bytes"] is not None:
            args["sparse_device_mem_mb"] = self._given["sparse_device_mem_bytes"] / 1e6
        return args

    def _release(self, molly: MollyOutput | None) -> None:
        """Drop every per-corpus state and attach ``molly``."""
        self.molly = molly
        self.vocab = CorpusVocab()
        self.packed: _CorpusPacked | None = None
        self.simplified: dict[str, list] = {}
        self._simplified_row: dict[tuple[int, str], tuple[int, int]] = {}
        self._fused_out: list[tuple[PackedBatch, PackedBatch, dict]] | None = None
        #: the fused plan that stage_fused_inputs made ahead of _fused
        self._staged_plan: dict | None = None
        self._row_of: dict[int, tuple[int, int]] = {}
        self._proto_tables_cache = None
        #: host property graphs, built on first use: (run, cond) -> PGraph
        self._raw: dict[tuple[int, str], PGraph] = {}
        self._clean: dict[tuple[int, str], PGraph] = {}
        #: (run, cond) -> host (alive, adj, type) rows of the simplify outputs
        self._clean_rows: dict[tuple[int, str], tuple] = {}
        #: the packed corpus, its graph views, iteration -> corpus row, and
        #: iteration -> per-graph linearity
        self._corpus = None
        self._corpus_graphs: CorpusGraphs | None = None
        self._row_by_iter: dict[int, int] = {}
        self._lin_by_iter: dict[int, bool] = {}

    # ---------------------------------------------------------------- ingest

    def init_graph_db(self, conn: str, molly: MollyOutput) -> None:
        """Take a packed-first corpus's vocabulary and arrays as they are,
        or pack the Python loader's run objects once into a corpus of the
        same arrays (``conn`` is the reference's graph-store address; the
        port keeps the signature and needs none).  First, as the JAX
        package's ``init_graph_db`` does, the platform profile: the first
        contact with a device under ``NEMO_PROFILE=auto`` and no profile on
        disk calibrates it once (device work); every later call loads or
        reuses it, host work only (the streamed map calls it on its
        prefetch thread).  Then the budgets resolve: argument > measured >
        seeded."""
        dev = self.executor.device
        _platform_profile.ensure_calibrated(dev)
        self._resolve_knobs(_platform_profile.resolve_constants(dev, self.profile_args()))
        self._release(molly)
        self.analysis_routes = []
        nc = getattr(molly, "native_corpus", None)
        if nc is None:
            from nemo_tpu_torch.store.npack import corpus_from_payload, payload_from_molly

            nc = corpus_from_payload(payload_from_molly(molly))
        # Every corpus interns "pre"/"post" first (ids 0/1), so re-interning
        # its strings in order gives the same ids.
        for part in ("tables", "labels", "times"):
            vocab = getattr(self.vocab, part)
            for text in getattr(nc, part):
                vocab.intern(text)
        self._corpus = nc
        self._corpus_graphs = CorpusGraphs(nc)
        self._row_by_iter = {int(it): i for i, it in enumerate(nc.iteration)}
        self.packed = _CorpusPacked(self._corpus_graphs, self._row_by_iter)
        # Built by position, so runs that share an iteration AND their flags:
        # a collision can only cost the fast path, never take it wrongly.
        for i, it in enumerate(nc.iteration.tolist()):
            flag = bool(nc.pre.chain_linear[i] and nc.post.chain_linear[i])
            self._lin_by_iter[it] = self._lin_by_iter.get(it, True) and flag

    def close_db(self) -> None:
        """Release everything init_graph_db and the verbs allocated (the
        reference's CloseDB, graphing/helpers.go:58-86); the route records
        and the executor's counts stay, and the backend stays reusable.  A
        packed corpus's native handle stays open: the molly owns it, and
        the report writer splices its prov JSON after close_db."""
        self._release(None)

    # ---------------------------------------------------------------- routes

    def _analysis_route(self, rows: int, v: int, e: int, rows_dispatch: int) -> tuple[str, str, int]:
        """(route, reason, work) of one fused bucket, in the order of the
        JAX package's ``_analysis_route``.  ``work`` is the host engine's
        cost model B x (V + E); ``rows_dispatch`` is the padded batch width
        the dense step would allocate, which the memory watermark prices.
        Auto: work within the host budget -> the host lane ("sparse",
        "crossover"); past the dense memory watermark (rows x V^2 x ~4
        bytes: the bool adjacency and its closure copies) -> sparse on the
        device by "mem"; large and very sparse -> by "density"; else dense."""
        work = rows * (v + e)
        if self.analysis_impl != "auto":
            return self.analysis_impl, "forced", work
        if work <= self.analysis_host_work:
            return "sparse", "crossover", work
        mem = self.sparse_device_mem_bytes
        if mem and max(rows_dispatch, rows) * v * v * 4 > mem:
            return "sparse_device", "mem", work
        if (
            self.sparse_device_density
            and v >= self.sparse_device_min_v
            and e <= v * v * self.sparse_device_density
        ):
            return "sparse_device", "density", work
        return "dense", "crossover", work

    def _diff_route(self, good_nodes: int, good_edges: int, n_failed: int, f_pad: int, v: int) -> tuple[str, str, int]:
        """(route, reason, work) of the diff, in the order of the JAX
        package's ``create_naive_diff_prov``: a giant good run -> the host
        lane by "giant"; a forced route; work n_failed x (V + E) of the good
        run within the host budget -> the host by "crossover"; past the
        watermark (F_pad x V^2 bytes of dense edge_keep planes) -> sparse on
        the device by "mem"; else dense."""
        work = n_failed * (good_nodes + good_edges)
        if good_nodes > self.giant_v:
            return "sparse", "giant", work
        if self.analysis_impl != "auto":
            return self.analysis_impl, "forced", work
        if work <= self.diff_host_work:
            return "sparse", "crossover", work
        if self.sparse_device_mem_bytes and f_pad * v * v > self.sparse_device_mem_bytes:
            return "sparse_device", "mem", work
        return "dense", "crossover", work

    def _synth_route(self, rows: int, v: int, e: int) -> tuple[str, str, int]:
        """(route, reason, work) of one synth bucket: the host twin
        ("sparse") or the synth_ext verb ("sparse_device"; it has no dense
        form).  A forced analysis route forces it too: "sparse" to the host,
        "dense" and "sparse_device" to the device.  Auto: the host budget
        decides (the JAX package's ``_synth_route``)."""
        work = rows * (v + e)
        if self.analysis_impl == "sparse":
            return "sparse", "forced", work
        if self.analysis_impl != "auto":
            return "sparse_device", "forced", work
        if work <= self.synth_host_work:
            return "sparse", "crossover", work
        return "sparse_device", "crossover", work

    def _record_route(self, verb: str, route: str, rows: int, v: int, e: int, work: int, reason: str) -> dict:
        """One route record: the ``analysis.route.<verb>.<route>`` counter,
        an entry in analysis_routes, and the attrs of the routed
        execution's ``analysis:route`` span."""
        obs.metrics.inc(f"analysis.route.{verb}.{route}")
        rec = {"verb": verb, "route": route, "rows": int(rows), "v": int(v), "e": int(e), "work": int(work),
               "reason": reason}
        self.analysis_routes.append(rec)
        return rec

    # ------------------------------------------------------------------ fused

    def _plan_fused_inputs(self) -> dict:
        """The host half of the fused step: the giant split, the size
        floors and the joint (pre, post) buckets.  A pure function of the
        initialized corpus, so the streamed map's prefetch thread can run it
        for segment k+1 (stage_fused_inputs) while segment k dispatches."""
        assert self.molly is not None
        nc = self._corpus
        # Node counts straight from the corpus arrays: no graph view is
        # built just to split off the giants.
        nmax = np.maximum(nc.pre.n_nodes, nc.post.n_nodes)
        rows = np.nonzero(nmax <= self.giant_v)[0].tolist()
        giant_ids = [int(nc.iteration[i]) for i in np.nonzero(nmax > self.giant_v)[0]]
        # Size floors: at corpus scale, pad every family to one bucket shape
        # (the JAX backend's compile-sharing floors, kept so both backends
        # bucket identically).  Only the bucketed runs count.
        big = len(rows) >= 512
        min_v, min_e, min_t, min_d = (64, 256, 32, 32) if big else (16, 16, 8, 4)
        with obs.span("analysis:pack", runs=len(rows)):
            batches = bucketize_pairs_corpus(self._corpus_graphs, rows, nc.iteration, min_v=min_v, min_e=min_e)
        return {
            "batches": batches,
            "giant_ids": giant_ids,
            "min_d": min_d,
            "tids": dict(
                pre_tid=self.vocab.tables.lookup("pre"),
                post_tid=self.vocab.tables.lookup("post"),
                num_tables=bucket_size(len(self.vocab.tables), min_t),
            ),
            "staged": {},
            "staged_bytes": 0,
        }

    def stage_fused_inputs(self) -> dict:
        """Plan the fused step ahead of it (_plan_fused_inputs) and, on the
        card, send each device-lane bucket's verb arrays up ahead of the
        dispatch: into pinned host memory, then to the card without
        blocking on a side stream, with an event the dispatch waits on.  On
        the CPU staging is the plan alone.  Called on the streamed map's
        prefetch thread after init_graph_db; never synchronizes the device.
        The next _fused adopts the plan.  Returns it (``staged_bytes``: the
        bytes sent up)."""
        plan = self._plan_fused_inputs()
        dev = self.executor.device
        if dev.type == "cuda":
            side = torch.cuda.Stream(device=dev)
            for bi, (pre_b, post_b) in enumerate(plan["batches"]):
                route, _, _ = self._analysis_route(len(pre_b.run_ids), pre_b.v, pre_b.e, pre_b.is_goal.shape[0])
                if route == "sparse":
                    continue
                on_dev, event, nbytes = _stage_arrays(_verb_arrays(pre_b, post_b), dev, side)
                plan["staged"][bi] = (on_dev, event)
                plan["staged_bytes"] += nbytes
        self._staged_plan = plan
        return plan

    def _fused(self) -> list[tuple[PackedBatch, PackedBatch, dict]]:
        """Run the analysis step once per joint size bucket and once per
        giant run, each a job drained by ``_drain``; cached.  Results are in
        bucket order, giants last, whatever the schedule."""
        if self._fused_out is None:
            assert self.molly is not None
            plan, self._staged_plan = self._staged_plan, None
            if plan is None:
                plan = self._plan_fused_inputs()
            jobs: list[sched_mod.Job] = []
            routes: list[tuple[str, str]] = []
            # Unpinned buckets may take any of the three lanes where the
            # card backs both device lanes and the routes are auto (the JAX
            # package offers sparse_device on an accelerator only).
            three = self.analysis_impl == "auto" and self.executor.device.type == "cuda"
            for bi, (pre_b, post_b) in enumerate(plan["batches"]):
                self._fused_job(jobs, routes, plan, bi, pre_b, post_b, three)
            if plan["giant_ids"]:
                self._giant_jobs(jobs, routes, plan["giant_ids"], plan["tids"])
            out = self._drain(jobs, routes)
            for bi, (pre_b, _post_b, _res) in enumerate(out):
                for row, rid in enumerate(pre_b.run_ids):
                    self._row_of[rid] = (bi, row)
            self._fused_out = out
        return self._fused_out

    def _drain(self, jobs: list[sched_mod.Job], routes: list[tuple[str, str]]) -> list:
        """The jobs' results in job order.  ``NEMO_SCHED`` off, or auto with
        one job: each job on its routed (lane, reason) in ``routes``, in
        order, on this thread.  Else through the cost-model scheduler on
        this device's lanes (parallel/sched.py)."""
        mode = sched_mod.sched_env()
        if mode != "off" and (mode == "on" or len(jobs) > 1):
            dev = self.executor.device
            scheduler = sched_mod.HeterogeneousScheduler(
                sched_mod.session_models(dev, self.analysis_host_work), device=dev)
            return scheduler.run(jobs)
        return [job.execute(lane, reason, False) for job, (lane, reason) in zip(jobs, routes)]

    def _add_job(self, jobs: list, routes: list, verb: str, rows: int, v: int, e: int, work: int, lane: str,
                 reason: str, pin_reasons: tuple, lanes: tuple, route_of_lane: dict, run) -> None:
        """Append a Job, routed to (``lane``, ``reason``) and pinned to its
        lane where ``reason`` is one of ``pin_reasons``.  Its execute
        records the route of the lane it runs on (``route_of_lane``) under
        ``verb`` and runs ``run(lane, job)`` inside the route's span.  The
        route is recorded once the run returns, and not by a dispatch the
        scheduler abandoned past its deadline (sched.claim_dispatch)."""
        job = sched_mod.Job(index=len(jobs), verb=verb, rows=rows, v=v, e=e, work=work, execute=None,
                            pinned=lane if reason in pin_reasons else None, reason=reason, lanes=lanes)
        record_verb = "synth" if verb == "synth_ext" else verb

        def execute(run_lane: str, rec_reason: str, stolen: bool):
            route = route_of_lane[run_lane]
            with obs.span("analysis:route", verb=record_verb, route=route, rows=rows, v=v, e=e, work=work,
                          reason=rec_reason):
                res = run(run_lane, job)
                if sched_mod.claim_dispatch():
                    self._record_route(record_verb, route, rows, v, e, work, rec_reason)
            return res

        job.execute = execute
        jobs.append(job)
        routes.append((lane, reason))

    def _taint_if_cold(self, job: sched_mod.Job) -> None:
        """Keep a wall that paid a one-off cost out of the scheduler's EWMA."""
        if self.executor.last_dispatch_cold:
            job.wall_tainted = True

    def _fused_job(self, jobs: list, routes: list, plan: dict, bi: int, pre_b: PackedBatch, post_b: PackedBatch,
                   three: bool) -> None:
        """One bucket's job, as the JAX package builds it: pinned by a
        forced route or the memory watermark; the host lane runs the numpy
        engine, sparse_device the sparse step, device the dense step."""
        rows = len(pre_b.run_ids)
        route, reason, work = self._analysis_route(rows, pre_b.v, pre_b.e, pre_b.is_goal.shape[0])
        tids = plan["tids"]
        # The linear-chain fast path must hold for every run of the bucket:
        # the AND of its graphs' flags.
        linear = int(all(self._lin_by_iter[i] for i in pre_b.run_ids))
        lanes = sched_mod.LANES if three or route == "sparse_device" else ("device", "host")

        def run(lane: str, job: sched_mod.Job):
            if lane == "host":
                self.executor.count_host("sparse_fused")
                with obs.span("kernel:fused", impl="sparse_host", rows=rows):
                    res = sparse_analysis_step(pre_b, post_b, v=pre_b.v, comp_linear=bool(linear), **tids)
                return (pre_b, post_b, _wrap_sparse_clean(res, pre_b.v))
            # Staged tensors are adopted on the launching thread's stream.
            staged = plan["staged"].get(bi)
            arrays = (_adopt_staged(*staged, self.executor.device) if staged is not None
                      else _verb_arrays(pre_b, post_b))
            if lane == "sparse_device":
                res = self._sparse_fused(arrays, pre_b.v, rows, linear, tids)
            else:
                res = self.executor.run(
                    "fused",
                    arrays,
                    dict(
                        v=pre_b.v,
                        max_depth=bucket_size(max(pre_b.max_depth, post_b.max_depth), plan["min_d"]),
                        comp_linear=linear,
                        num_labels=8,  # unused without the diff tail
                        with_diff=0,
                        **tids,
                    ),
                    rows=rows,
                )
            self._taint_if_cold(job)
            return (pre_b, post_b, res)

        self._add_job(jobs, routes, "fused", rows, pre_b.v, pre_b.e, work, sched_mod.LANE_OF_ROUTE[route], reason,
                      ("forced", "mem"), lanes, sched_mod.ROUTE_OF_LANE, run)

    def _giant_jobs(self, jobs: list, routes: list, giant_ids: list[int], tids: dict) -> None:
        """A job for each giant run alone, packed at corpus-common (V, E)
        buckets, pinned (reason ``giant_impl``, work V + E, as the JAX
        package records them) to the host lane under
        ``analysis_impl="sparse"`` (with giant_plan's union-find labels),
        else to the sparse device step."""
        graphs = [self.packed[(rid, c)] for rid in giant_ids for c in ("pre", "post")]
        v_g = bucket_size(max(g.n_nodes for g in graphs))
        e_g = bucket_size(max(1, *(len(g.edges) for g in graphs)))
        lane = "host" if self.analysis_impl == "sparse" else "sparse_device"
        for rid in giant_ids:
            gpre, gpost = self.packed[(rid, "pre")], self.packed[(rid, "post")]

            def run(run_lane: str, job: sched_mod.Job, rid=rid, gpre=gpre, gpost=gpost):
                pre_b = pack_batch([rid], [gpre], v_g, e_g)
                post_b = pack_batch([rid], [gpost], v_g, e_g)
                if run_lane == "host":
                    _, _, lab_pre = giant_plan(gpre)
                    _, _, lab_post = giant_plan(gpost)
                    self.executor.count_host("sparse_giant")
                    res = giant_analysis_host(
                        pre_b, post_b, tids["pre_tid"], tids["post_tid"], tids["num_tables"],
                        pad_comp_labels(lab_pre, gpre.n_nodes, v_g), pad_comp_labels(lab_post, gpost.n_nodes, v_g),
                    )
                    return (pre_b, post_b, _wrap_sparse_clean(res, v_g))
                linear = int(giant_linear(gpre) and giant_linear(gpost))
                res = self._sparse_fused(_verb_arrays(pre_b, post_b), v_g, 1, linear, tids)
                self._taint_if_cold(job)
                return (pre_b, post_b, res)

            self._add_job(jobs, routes, "giant", 1, v_g, e_g, v_g + e_g, lane, "giant_impl", ("giant_impl",),
                          ("device", "host"), sched_mod.ROUTE_OF_LANE, run)

    def _sparse_fused(self, arrays: dict, v: int, rows: int, linear: int, tids: dict) -> dict:
        res = self.executor.run("sparse_fused", arrays, dict(v=v, comp_linear=linear, **tids), rows=rows)
        return _wrap_sparse_clean(res, v)

    def load_raw_provenance(self) -> None:
        """Condition marking for every run (the fused dispatches)."""
        self._fused()

    def cond_holds(self, rid: int, cond: str) -> np.ndarray:
        """Per-node condition_holds of one run's graph (its real nodes)."""
        bi, row = self._row_of[rid]
        pre_b, post_b, res = self._fused()[bi]
        b = pre_b if cond == "pre" else post_b
        return np.asarray(res[f"{cond}_holds"][row])[: int(b.n_nodes[row])]

    def simplify_prov(self, iters: list[int]) -> None:
        """The fused step simplifies every run; this registers the shadow-graph
        rows for the requested iterations."""
        want = set(iters)
        for cond in ("pre", "post"):
            outs = []
            for pre_b, post_b, res in self._fused():
                b = pre_b if cond == "pre" else post_b
                bi = len(outs)
                outs.append((b, res[f"{cond}_adj_clean"], res[f"{cond}_alive"], res[f"{cond}_type"]))
                for row, rid in enumerate(b.run_ids):
                    if rid in want:
                        self._simplified_row[(rid, cond)] = (bi, row)
            self.simplified[cond] = outs

    # ------------------------------------------------------- lazy host graphs

    def raw_graph(self, rid: int, cond: str) -> PGraph:
        """One run's raw provenance as a host property graph, its goals'
        condition_holds mirrored from the fused step; built on first use."""
        key = (rid, cond)
        g = self._raw.get(key)
        if g is None:
            g = self._raw[key] = self._corpus_pgraph(key, self.cond_holds(rid, cond).tolist())
        return g

    def _corpus_pgraph(self, key: tuple[int, str], holds: list) -> PGraph:
        """graphs/pgraph.py:build_pgraph over the packed corpus arrays: the
        same node order (goals, then rules, in provenance order), edge order
        and duplicate-edge merge as building it from the provenance objects,
        so figures and queries see the same graph."""
        pg = self.packed[key]
        tables, labels, times = self.vocab.tables, self.vocab.labels, self.vocab.times
        ids = [pg.node_ids[s] for s in range(pg.n_nodes)]
        table_l, label_l = pg.table_id.tolist(), pg.label_id.tolist()
        time_l, type_l = pg.time_id.tolist(), pg.type_id.tolist()
        g = PGraph()
        for s in range(pg.n_nodes):
            is_goal = s < pg.n_goals
            g.add_node(
                PNode(
                    id=ids[s],
                    is_goal=is_goal,
                    label=labels[label_l[s]],
                    table=tables[table_l[s]],
                    time=times[time_l[s]] if is_goal else "",
                    type="" if is_goal else TYPE_NAMES.get(type_l[s], ""),
                    cond_holds=bool(holds[s]) if is_goal else False,
                )
            )
        for s, d in pg.edges.tolist():
            g.add_edge(ids[s], ids[d])
        return g

    def clean_graph(self, rid: int, cond: str) -> PGraph:
        """One run's simplified shadow graph (run 1000+rid) as a host
        property graph, from the simplify outputs; built on first use."""
        key = (rid, cond)
        g = self._clean.get(key)
        if g is None:
            bi, row = self._simplified_row[key]
            batch = self.simplified[cond][bi][0]
            if key not in self._clean_rows:
                self._prefetch_clean_rows([rid])
            alive_r, adj_r, type_r = self._clean_rows[key]
            holds = np.zeros(batch.v, dtype=bool)
            holds[: int(batch.n_nodes[row])] = self.cond_holds(rid, cond)
            g = self._clean[key] = unpack_to_pgraph(
                batch, row, self.vocab, alive_r, adj_r, type_r, holds,
                id_prefix=f"run_{CLEAN_OFFSET + rid}_{cond}_",
            )
        return g

    def _prefetch_clean_rows(self, run_ids: list[int]) -> None:
        """Bring the simplify outputs of the given runs to the host: one
        index_select per (bucket, array) on the device, then one copy of
        each gathered batch, never a copy per row.  A sparse bucket's
        CsrAdjRows densifies the gathered rows only."""
        gathers = []
        for cond in ("pre", "post"):
            by_bucket: dict[int, list[tuple[int, int]]] = {}
            for rid in run_ids:
                loc = self._simplified_row.get((rid, cond))
                if loc is not None and (rid, cond) not in self._clean_rows:
                    by_bucket.setdefault(loc[0], []).append((loc[1], rid))
            for bi, pairs in by_bucket.items():
                _, adj, alive, type_new = self.simplified[cond][bi]
                rows = [r for r, _ in pairs]
                gathers.append((cond, pairs, [_gather_rows(a, rows) for a in (alive, adj, type_new)]))
        for cond, pairs, arrays in gathers:
            alive_g, adj_g, type_g = (_to_host(a) for a in arrays)
            for j, (_, rid) in enumerate(pairs):
                self._clean_rows[(rid, cond)] = (alive_g[j], adj_g[j], type_g[j])

    def pull_pre_post_prov(
        self, iters: list[int] | None = None
    ) -> tuple[list[DotGraph], list[DotGraph], list[DotGraph], list[DotGraph]]:
        assert self.molly is not None
        run_ids = [r.iteration for r in self.molly.runs] if iters is None else list(iters)
        self._prefetch_clean_rows(run_ids)
        pre, post, pre_clean, post_clean = [], [], [], []
        for i in run_ids:
            pre.append(create_dot(self.raw_graph(i, "pre"), "pre"))
            post.append(create_dot(self.raw_graph(i, "post"), "post"))
            pre_clean.append(create_dot(self.clean_graph(i, "pre"), "pre"))
            post_clean.append(create_dot(self.clean_graph(i, "post"), "post"))
        return pre, post, pre_clean, post_clean

    # ------------------------------------------------------------ prototypes

    def _proto_tables_by_run(self) -> tuple[dict[int, list[str]], dict[int, set[str]]]:
        """Slice the fused step's prototype outputs per run: (ordered
        qualifying tables per run — by depth, then name — and all present
        rule tables per run).  Memoized per corpus."""
        if self._proto_tables_cache is not None:
            return self._proto_tables_cache
        ordered: dict[int, list[str]] = {}
        present: dict[int, set[str]] = {}
        names = np.asarray(self.vocab.tables.strings, dtype=object)
        for _, post_b, res in self._fused():
            bits, min_depth, present_bits = (
                np.asarray(res["proto_bits"]),
                np.asarray(res["proto_min_depth"]),
                np.asarray(res["proto_present"]),
            )
            nm = names[: bits.shape[1]]
            rows, ts = np.nonzero(bits & (min_depth < DEPTH_INF))
            order = np.lexsort((nm[ts], min_depth[rows, ts], rows))
            rows_o, names_o = rows[order], nm[ts[order]]
            starts = np.searchsorted(rows_o, np.arange(bits.shape[0] + 1))
            p_rows, p_ts = np.nonzero(present_bits)
            p_starts = np.searchsorted(p_rows, np.arange(bits.shape[0] + 1))
            p_names = nm[p_ts]
            for row, rid in enumerate(post_b.run_ids):
                ordered[rid] = list(names_o[starts[row] : starts[row + 1]])
                present[rid] = set(p_names[p_starts[row] : p_starts[row + 1]])
        self._proto_tables_cache = (ordered, present)
        return self._proto_tables_cache

    def create_prototypes(
        self, success_iters: list[int], failed_iters: list[int]
    ) -> tuple[list[str], list[list[str]], list[str], list[list[str]]]:
        ordered, present = self._proto_tables_by_run()
        per_run = [ordered.get(i, []) for i in success_iters]
        inter = intersect_proto(per_run, "post")
        union = union_proto(per_run, "post")
        inter_miss = [missing_from(inter, present.get(f, set())) for f in failed_iters]
        union_miss = [missing_from(union, present.get(f, set())) for f in failed_iters]
        return wrap_code(inter), inter_miss, wrap_code(union), union_miss

    def proto_tables_by_run(
        self, success_iters: list[int], failed_iters: list[int]
    ) -> tuple[dict[int, list[str]], dict[int, set[str]]]:
        ordered, present = self._proto_tables_by_run()
        return (
            {i: ordered.get(i, []) for i in success_iters},
            {f: present.get(f, set()) for f in failed_iters},
        )

    # ------------------------------------------------------------------ diff

    def _diff_batch(self, failed_iters: list[int]) -> tuple[int, object, PackedBatch, np.ndarray]:
        """The diff's inputs: (the good run, its packed graph, its one-row
        batch, the [F_pad, L] label bitsets of the failed runs).  The
        failed-run axis and the label dim pad to powers of two (all-false
        padding rows)."""
        g = self.good_run_iter()
        good = self.packed[(g, "post")]
        num_labels = bucket_size(max(1, len(self.vocab.labels)), 8)
        gb = pack_batch([g], [good])
        bits = np.zeros((bucket_size(max(1, len(failed_iters)), 8), num_labels), dtype=bool)
        # One scatter over the corpus rows (is_goal is exactly the slots
        # below n_goals) instead of a graph view per failed run.
        rows = np.asarray([self._row_by_iter[f] for f in failed_iters], dtype=np.int64)
        isg = self._corpus.post.is_goal[rows]
        lab = self._corpus.post.label_id[rows]
        j_idx, s_idx = np.nonzero(isg)
        bits[j_idx, lab[j_idx, s_idx]] = True
        return g, good, gb, bits

    def _diff_dispatch(self, route: str, good, gb: PackedBatch, bits: np.ndarray, n_failed: int) -> dict:
        """The diff on one lane: node_keep, edge_keep (dense [F,V,V] planes
        left on the device by ``diff``; a mask over the good run's edge list
        on the host lane and ``sparse_diff``), frontier_rule, missing_goal."""
        arrays = {
            "edge_src": gb.edge_src,
            "edge_dst": gb.edge_dst,
            "edge_mask": gb.edge_mask,
            "is_goal": gb.is_goal[0],
            "node_mask": gb.node_mask[0],
            "label_id": gb.label_id[0],
            "fail_bits": bits,
        }
        if route == "sparse":
            # The host lane takes only the real failed-run rows: the padding
            # rows exist for the device dispatch.
            goal = np.zeros(gb.v, dtype=bool)
            goal[: good.n_goals] = True
            label = np.full(gb.v, -1, dtype=np.int64)
            label[: good.n_nodes] = good.label_id
            self.executor.count_host("sparse_diff")
            return dict(zip(("node_keep", "edge_keep", "frontier_rule", "missing_goal"),
                            diff_masks_host(good.edges, gb.v, goal, label, bits[:n_failed])))
        if route == "sparse_device":
            for name in ("edge_src", "edge_dst", "edge_mask"):
                arrays[name] = arrays[name][0]
            return self.executor.run("sparse_diff", arrays, {"v": gb.v}, rows=n_failed)
        return self.executor.run("diff", arrays, {"v": gb.v, "max_depth": bucket_size(gb.max_depth, 4)},
                                 rows=n_failed)

    def create_naive_diff_prov(
        self,
        symmetric: bool,
        failed_iters: list[int],
        success_post_dot: DotGraph | None,
        dot_iters: list[int] | None = None,
    ) -> tuple[list[DotGraph], list[DotGraph], list[list[MissingEvent]]]:
        """One diff over all failed runs against the good run, on the lane
        ``_diff_route`` records (the host lane, ``sparse_diff`` or the dense
        ``diff``): every failed run's missing events, and the overlay DOTs
        of the runs in ``dot_iters`` (None = every failed run).  The dense
        diff's [F,V,V] edge_keep planes stay on the device: the
        missing events read the kept-child rows of the frontier rules, and
        the overlays the planes of the ``dot_iters`` runs, each in one
        gather."""
        assert self.molly is not None
        if not failed_iters:
            return [], [], []
        dot_set = set(failed_iters if dot_iters is None else dot_iters)
        g, good, gb, bits = self._diff_batch(failed_iters)
        route, reason, work = self._diff_route(good.n_nodes, len(good.edges), len(failed_iters), bits.shape[0], gb.v)
        rec = self._record_route("diff", route, len(failed_iters), good.n_nodes, len(good.edges), work, reason)
        with obs.span("analysis:route", **rec):
            out = self._diff_dispatch(route, good, gb, bits, len(failed_iters))
        dot_js = [j for j, f in enumerate(failed_iters) if f in dot_set]
        if route in ("sparse", "sparse_device"):
            # edge_keep is a mask over the good run's (padded) edge list.
            edge_keep = out["edge_keep"][:, : len(good.edges)]

            def children(j: int):
                return _children_of_edges(good.edges[edge_keep[j]], gb.v)

            def plane(j: int) -> np.ndarray:
                return _dense_of_edges(good.edges[edge_keep[j]], gb.v)
        else:
            ek = out["edge_keep"]
            fj, fr = np.nonzero(out["frontier_rule"][: len(failed_iters)])
            kept_rows = _to_host(
                ek[torch.as_tensor(fj, device=ek.device), torch.as_tensor(fr, device=ek.device)]
            )
            row_of = {jr: k for k, jr in enumerate(zip(fj.tolist(), fr.tolist()))}
            planes = _to_host(_gather_rows(ek, dot_js)) if dot_js else None
            plane_of = {j: k for k, j in enumerate(dot_js)}

            def children(j: int):
                return lambda r: kept_rows[row_of[(j, r)]]

            def plane(j: int) -> np.ndarray:
                return planes[plane_of[j]]
        holds = np.zeros(gb.v, dtype=bool)
        holds[: good.n_nodes] = self.cond_holds(g, "post")
        diff_dots, failed_dots, missing_events = [], [], []
        for j, f in enumerate(failed_iters):
            prefix = f"run_{DIFF_OFFSET + f}_post_"
            missing = self._missing_events(
                gb, out["frontier_rule"][j], out["missing_goal"][j], children(j), prefix, holds
            )
            missing_events.append(missing)
            if f not in dot_set:
                continue
            diff_graph = unpack_to_pgraph(
                gb, 0, self.vocab, out["node_keep"][j], plane(j), gb.type_id[0], holds,
                id_prefix=prefix,
            )
            diff_dot, failed_dot = create_diff_dot(
                DIFF_OFFSET + f, diff_graph, self.raw_graph(f, "post"), g, success_post_dot, missing
            )
            diff_dots.append(diff_dot)
            failed_dots.append(failed_dot)
        return diff_dots, failed_dots, missing_events

    def missing_events(self, failed_iters: list[int]) -> list[list[MissingEvent]]:
        """The missing events of every failed run against the good run, with
        no overlay DOTs (create_naive_diff_prov's third output)."""
        return self.create_naive_diff_prov(False, failed_iters, None, dot_iters=[])[2]

    def _missing_events(
        self,
        gb: PackedBatch,
        frontier_rule: np.ndarray,
        missing_goal: np.ndarray,
        children,  # callable(slot) -> [V] bool kept-edge children of slot
        prefix: str,
        holds: np.ndarray,
    ) -> list[MissingEvent]:
        good = gb.graphs[0]

        def rename(slot: int) -> str:
            return rewrite_run_prefix(good.node_ids[slot], prefix)

        out = []
        for r in sorted(np.nonzero(frontier_rule)[0].tolist(), key=rename):
            rule = Rule(
                id=rename(r),
                label=self.vocab.labels[int(good.label_id[r])],
                table=self.vocab.tables[int(good.table_id[r])],
                type=TYPE_NAMES[int(good.type_id[r])],
            )
            goals = []
            for gslot in sorted(np.nonzero(children(r) & missing_goal)[0].tolist(), key=rename):
                goals.append(
                    Goal(
                        id=rename(gslot),
                        label=self.vocab.labels[int(good.label_id[gslot])],
                        table=self.vocab.tables[int(good.table_id[gslot])],
                        time=self.vocab.times[int(good.time_id[gslot])],
                        cond_holds=bool(holds[gslot]),
                    )
                )
            out.append(MissingEvent(rule=rule, goals=goals))
        return out

    # ------------------------------------------------------------ corrections

    def generate_corrections(self) -> list[str]:
        g = self.good_run_iter()
        return synthesize_corrections(
            find_pre_triggers(self.raw_graph(g, "pre")), find_post_triggers(self.raw_graph(g, "post"))
        )

    # ------------------------------------------------------------ extensions

    def extension_suggestions(self) -> list[str]:
        return synthesize_extensions(extension_candidates(self.raw_graph(self.baseline_run_iter(), "pre")))

    def generate_extensions(self) -> tuple[bool, list[str]]:
        assert self.molly is not None
        achieved = sum(self.achieved_pre_goal_counts().values())
        if achieved >= len(self.molly.runs):
            return True, []
        return False, self.extension_suggestions()

    def achieved_pre_goal_counts(self) -> dict[int, int]:
        """Per run: the count of antecedent goals with condition_holds
        (extensions.go:25-50 counts goals, not runs)."""
        assert self.molly is not None
        pre_tid = self.vocab.tables.lookup("pre")
        counts: dict[int, int] = {}
        for pre_b, _post_b, res in self._fused():
            holds = np.asarray(res["pre_holds"])
            k = len(pre_b.run_ids)
            sel = holds[:k] & pre_b.is_goal[:k] & (pre_b.table_id[:k] == pre_tid)
            per_run = sel.sum(axis=1)
            for row, rid in enumerate(pre_b.run_ids):
                counts[rid] = counts.get(rid, 0) + int(per_run[row])
        return counts

    def synth_candidates(self, iters: list[int]) -> dict[int, list[str]]:
        """Per run in ``iters``: the sorted distinct extension-candidate rule
        tables of its antecedent provenance — one ``synth_ext`` dispatch or
        one host-twin pass per fused bucket, as ``_synth_route`` records,
        each bucket a job drained by ``_drain`` (lanes device, the
        synth_ext verb, and host; pinned by a forced route)."""
        assert self.molly is not None
        want = set(iters)
        out: dict[int, list[str]] = {i: [] for i in iters}
        names = np.asarray(self.vocab.tables.strings, dtype=object)
        jobs: list[sched_mod.Job] = []
        routes: list[tuple[str, str]] = []
        for pre_b, _post_b, res in self._fused():
            if not any(rid in want for rid in pre_b.run_ids):
                continue
            rows = len(pre_b.run_ids)
            route, reason, work = self._synth_route(rows, pre_b.v, pre_b.e)
            holds = np.asarray(res["pre_holds"])
            # The table-bitset width the fused step used for this bucket.
            num_tables = int(np.asarray(res["proto_bits"]).shape[1])

            def run(lane: str, job: sched_mod.Job, pre_b=pre_b, holds=holds, num_tables=num_tables, rows=rows):
                if lane == "host":
                    self.executor.count_host("synth_host")
                    return pre_b, synth_ext_host(pre_b, holds, num_tables)
                bits = self.executor.run(
                    "synth_ext",
                    {
                        "edge_src": pre_b.edge_src,
                        "edge_dst": pre_b.edge_dst,
                        "edge_mask": pre_b.edge_mask,
                        "is_goal": pre_b.is_goal,
                        "node_mask": pre_b.node_mask,
                        "type_id": pre_b.type_id,
                        "table_id": pre_b.table_id,
                        "holds": holds,
                    },
                    {"v": pre_b.v, "num_tables": num_tables},
                    rows=rows,
                )["ext_bits"]
                self._taint_if_cold(job)
                return pre_b, bits

            self._add_job(jobs, routes, "synth_ext", rows, pre_b.v, pre_b.e, work,
                          "host" if route == "sparse" else "device", reason, ("forced",), ("device", "host"),
                          _SYNTH_ROUTE_OF_LANE, run)
        for pre_b, bits in self._drain(jobs, routes):
            nm = names[: bits.shape[1]]
            rows_i, ts = np.nonzero(bits)
            order = np.lexsort((nm[ts], rows_i))
            rows_o, names_o = rows_i[order], nm[ts[order]]
            starts = np.searchsorted(rows_o, np.arange(bits.shape[0] + 1))
            for row, rid in enumerate(pre_b.run_ids):
                if rid in want:
                    out[rid] = list(names_o[starts[row] : starts[row + 1]])
        return out
