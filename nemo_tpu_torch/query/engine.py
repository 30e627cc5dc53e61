"""The query executor: segments -> bucket jobs -> order-insensitive reduce.

A port of the JAX package's ``query/engine.py``:

* a segment's runs pack into power-of-two (V, E) buckets
  (graphs/packed.py:bucketize), one job per bucket;
* each job runs on one of two lanes with equal outputs: ``sparse_device``
  (:func:`_eval_device`, torch on the backend's device: plane compares,
  ``_push_any`` waves and, for every ``-*->`` hop, ``_reach_any``, whose
  fix point is kernel K2) or ``host`` (:func:`_eval_host`, numpy over the
  host lane's CSR prep);
* per-segment results are :class:`QueryPartial`\\ s, iteration-keyed plain
  data with a commutative, associative merge, cached per segment and as a
  whole-result blob in the result cache, keyed on (query AST hash, segment
  fingerprints, analysis ABI) by ``blob_cache_key``.  A warm repeat is a
  cache hit with no job run.

Under ``NEMO_SCHED=off`` (the port's default) the jobs drain in bucket
order on the caller's thread, each on the lane the JAX package's scheduler
plans with fresh cost models under the device's platform profile
(``query_lane`` against ``derived_query_host_work``).  Under ``auto`` or
``on`` they drain through the port's scheduler (parallel/sched.py), as the
JAX package's do: the device's session lane models (EWMA feedback), work
stealing between the two lanes, the dispatch deadline and the breaker
(on the CPU a recorded failover to the host; on the card the failure is
raised); ``serial`` keeps its plans but runs them on the caller's thread.

A query's wall is staged by a PhaseTimer (utils/timing.py), returned as the
document's ``stats["timings"]``: ``query.plan``; ``query.prep`` (lane
crossover, vocabulary, name validation, graph views, bind, bucketize);
``query.eval_host`` and ``query.eval_device`` (each bucket's execute on its
lane: time plane, uploads, waves, the copy back); ``query.extract``
(per-run values, merge, finalize).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from nemo_tpu_torch import obs
from nemo_tpu_torch.query.lang import HOP_ADJ, Query, QueryError
from nemo_tpu_torch.query.plan import QueryPlan, plan_query
from nemo_tpu_torch.utils.timing import PhaseTimer

#: The seeded crossover: ``derived_query_host_work`` with no measured
#: profile (host 1e-6 s a unit; sparse_device a fixed 100,000 x (1e-6 -
#: 5e-8) = 0.095 s plus 2.5e-7 s a unit; they meet at 126,666.7).  These
#: are the TPU's seeds, not a fit for the H100.
QUERY_HOST_WORK = 126_667


def derived_query_host_work(device=None) -> int:
    """The first bucket work (rows x (V + E)) at which a query job takes the
    ``sparse_device`` lane: the lane the JAX package's scheduler plans for
    a query job with fresh cost models (nemo_tpu/parallel/sched.py:
    default_models and HeterogeneousScheduler.plan) under ``device``'s
    profile.  Host predicts ``host_unit x work``; sparse_device
    ``device_fixed + sparse_device_unit x work``, its fixed cost measured,
    else the analysis budget's worth of the host-device unit spread; a tie
    goes to the device.  Each constant is measured or seeded
    (platform/profile.py); with no profile this is QUERY_HOST_WORK."""
    from nemo_tpu_torch.platform.profile import SEEDED, active_profile

    prof = active_profile(device)

    def measured(name: str) -> float | None:
        return None if prof is None else prof.measured_value(name)

    def value(name: str) -> float:
        m = measured(name)
        return SEEDED[name] if m is None else m

    host_unit = value("sched_host_unit")
    device_unit = value("sched_device_unit")
    budget = int(value("analysis_host_work"))
    fixed = measured("sched_device_fixed")
    if fixed is None:
        fixed = budget * max(host_unit - device_unit, 1e-12)
    fixed, sparse_unit = float(fixed), float(value("sched_sparse_device_unit"))

    def on_device(work: int) -> bool:
        return fixed + sparse_unit * work <= 0.0 + host_unit * work

    if host_unit <= sparse_unit:
        return 0 if on_device(0) else 2**63 - 1  # the lines never cross
    work = max(int(np.ceil(fixed / (host_unit - sparse_unit))), 0)
    while work > 0 and on_device(work - 1):
        work -= 1
    while not on_device(work):
        work += 1
    return work


def query_lane(work: int, query_host_work: int = QUERY_HOST_WORK) -> str:
    """The lane of one query job: ``host`` below ``query_host_work``, else
    ``sparse_device`` (0 sends every job to the device)."""
    return "host" if work < query_host_work else "sparse_device"


# ---------------------------------------------------------------------------
# the serializable intermediate
# ---------------------------------------------------------------------------


@dataclass
class QueryPartial:
    """One segment's slice of a query result: iteration-keyed plain data
    (names, not vocabulary ids), JSON-serializable, merged in any order.
    ``per_run`` values depend on the aggregation: list[str] (tables), int
    (count), bool (runs), dict[str, int] (count_by_table)."""

    per_run: dict = field(default_factory=dict)  # iteration -> value
    n_runs: int = 0

    def to_json(self) -> dict:
        return {"per_run": {str(k): v for k, v in self.per_run.items()}, "n_runs": self.n_runs}

    @classmethod
    def from_json(cls, d: dict) -> "QueryPartial":
        return cls(per_run={int(k): v for k, v in d["per_run"].items()}, n_runs=int(d["n_runs"]))


def merge_query_partials(parts: list) -> QueryPartial:
    """Segments own disjoint iteration sets, so the union does not depend on
    the order of ``parts``."""
    out = QueryPartial()
    for p in parts:
        out.per_run.update(p.per_run)
        out.n_runs += p.n_runs
    return out


def finalize(plan: QueryPlan, merged: QueryPartial) -> dict:
    """Partial -> the result document.  Every rollup is computed from the
    iteration-keyed map in sorted-key order, so the document's bytes are a
    function of its content only."""
    runs = {str(k): merged.per_run[k] for k in sorted(merged.per_run)}
    doc: dict = {"agg": plan.agg, "graph": plan.graph, "n_runs": merged.n_runs}
    if plan.agg == "tables":
        doc["runs"] = runs
        doc["distinct"] = sorted({t for v in merged.per_run.values() for t in v})
    elif plan.agg == "count":
        doc["runs"] = runs
        doc["total"] = int(sum(merged.per_run.values()))
    elif plan.agg == "runs":
        doc["runs"] = sorted(k for k, v in merged.per_run.items() if v)
    else:  # count_by_table
        hist: dict = {}
        for v in merged.per_run.values():
            for t, n in v.items():
                hist[t] = hist.get(t, 0) + int(n)
        doc["by_table"] = {t: hist[t] for t in sorted(hist)}
        doc["total"] = int(sum(hist.values()))
    return doc


# ---------------------------------------------------------------------------
# the two lane evaluators (equal outputs over one bound plan)
# ---------------------------------------------------------------------------


def _step_mask(planes: dict, step: tuple):
    """One step's node mask: the kind constraint and every plane compare,
    shared by both lanes (numpy arrays or torch tensors).  The ``holds``
    plane is true only on holding goal nodes, and ``holds`` predicates
    validate only on goal steps, so the negated form needs no goal guard."""
    is_goal = planes["is_goal"]
    m = planes["node_mask"]
    for test in step:
        if test[0] == "kind":
            if test[1] == "goal":
                m = m & is_goal
            elif test[1] == "rule":
                m = m & ~is_goal
            continue
        fld, op, val = test
        if fld == "holds":
            want = bool(val) if op == "=" else not val
            m = (m & planes["holds"]) if want else (m & ~planes["holds"])
            continue
        plane = planes[fld]
        m = (m & (plane == val)) if op == "=" else (m & (plane != val))
    return m


def _eval_patterns(planes: dict, patterns: tuple, hop, zeros):
    """The forward/backward chain intersection, shared by both lanes:
    ``hop(state, kind, fwd)`` is the lane's wave primitive."""
    cap = zeros
    for steps, hops, ci in patterns:
        masks = [_step_mask(planes, s) for s in steps]
        fwd = [masks[0]]
        for i, h in enumerate(hops):
            fwd.append(masks[i + 1] & hop(fwd[i], h, True))
        bwd = masks[-1]
        for i in range(len(hops) - 1, ci - 1, -1):
            bwd = masks[i] & hop(bwd, hops[i], False)
        cap = cap | (fwd[ci] & bwd)
    return cap


class _BatchPlanes(NamedTuple):
    """The node planes ``ops/sparse_device.py:_condition_holds`` reads (the
    verb path hands it a whole batch; the query has only planes)."""

    is_goal: object
    node_mask: object
    table_id: object
    edge_mask: object


def _eval_device(batch, time_plane: np.ndarray, bound: tuple, num_tables: int, device) -> np.ndarray:
    """The ``sparse_device`` lane: the bucket's planes on ``device``, plane
    compares, one ``_push_any`` wave per ``->`` hop and one ``_reach_any``
    per ``-*->`` hop (kernel K2's fix point and one push, on the edges as
    they are forward and swapped backward).  Returns the [B,V] capture mask
    on the host."""
    import torch

    from nemo_tpu_torch.ops.sparse_device import _condition_holds, _push_any, _reach_any

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    patterns, needs_holds, cond_tid = bound
    v = batch.v
    is_goal, node_mask = put(batch.is_goal, torch.bool), put(batch.node_mask, torch.bool)
    table = put(batch.table_id, torch.int32)
    src, dst = put(batch.edge_src, torch.int64), put(batch.edge_dst, torch.int64)
    emask = put(batch.edge_mask, torch.bool)
    planes = {
        "is_goal": is_goal, "node_mask": node_mask, "table": table,
        "label": put(batch.label_id, torch.int32), "time": put(time_plane, torch.int32),
        "type": put(batch.type_id, torch.int32),
    }
    if needs_holds:
        ba = _BatchPlanes(is_goal=is_goal, node_mask=node_mask, table_id=table, edge_mask=emask)
        planes["holds"] = _condition_holds(ba, src, dst, cond_tid, num_tables, v)

    def hop(state, kind, fwd: bool):
        a, b = (src, dst) if fwd else (dst, src)
        if kind == HOP_ADJ:
            return _push_any(state, a, b, emask, v)
        return _reach_any(state, a, b, emask, v)

    zeros = torch.zeros(is_goal.shape, dtype=torch.bool, device=device)
    return _eval_patterns(planes, patterns, hop, zeros).cpu().numpy()


def _eval_host(batch, time_plane: np.ndarray, bound: tuple, num_tables: int) -> np.ndarray:
    """The ``host`` lane: the same boolean algebra over the flat-scatter CSR
    prep (ops/sparse_host.py): ``scat_any`` waves and ``bfs_any`` fix
    points."""
    from nemo_tpu_torch.ops.sparse_host import _CondCSR, _condition_holds, bfs_any, build_csr

    csr = _CondCSR(batch)
    patterns, needs_holds, cond_tid = bound
    planes = {
        "is_goal": csr.is_goal, "node_mask": csr.node_mask, "table": csr.table,
        "label": np.asarray(batch.label_id, dtype=np.int64),
        "time": np.asarray(time_plane, dtype=np.int64),
        "type": csr.type_id,
    }
    if needs_holds:
        planes["holds"] = _condition_holds(csr, cond_tid, num_tables)
    csrs: dict = {}

    def hop(state, kind, fwd: bool):
        at, frm = (csr.dst, csr.src) if fwd else (csr.src, csr.dst)
        if kind == HOP_ADJ:
            return csr.scat_any(at, state.ravel()[frm])
        if fwd not in csrs:
            csrs[fwd] = build_csr(frm, at, csr.n)
        indptr, nbr = csrs[fwd]
        return bfs_any(indptr, nbr, state.ravel()).reshape(csr.b, csr.v)

    return _eval_patterns(planes, patterns, hop, np.zeros((csr.b, csr.v), dtype=bool))


# ---------------------------------------------------------------------------
# map / extract
# ---------------------------------------------------------------------------


def _time_plane(batch) -> np.ndarray:
    """[B,V] time-id plane (a PackedBatch carries it only per graph)."""
    out = np.full((len(batch.n_nodes), batch.v), -1, dtype=np.int32)
    for i, g in enumerate(batch.graphs):
        out[i, : g.n_nodes] = g.time_id
    return out


def _extract(plan: QueryPlan, batch, cap: np.ndarray, vocab) -> dict:
    """Capture mask -> per-run plain-data values (names via the vocabulary)."""
    table = np.asarray(batch.table_id)
    out: dict = {}
    for i, rid in enumerate(batch.run_ids):
        m = cap[i]
        if plan.agg == "tables":
            out[rid] = sorted({vocab.tables[t] for t in np.unique(table[i][m]) if t >= 0})
        elif plan.agg == "count":
            out[rid] = int(m.sum())
        elif plan.agg == "runs":
            out[rid] = bool(m.any())
        else:  # count_by_table
            tids, counts = np.unique(table[i][m & (table[i] >= 0)], return_counts=True)
            out[rid] = {vocab.tables[t]: int(n) for t, n in zip(tids, counts)}
    return out


def _filter_runs(runs: list, run_filter: str) -> list:
    if run_filter == "failed":
        return [r for r in runs if not r.succeeded]
    if run_filter == "success":
        return [r for r in runs if r.succeeded]
    return list(runs)


def _empty_value(agg: str):
    """The aggregation value of a run with no captures, and of a run with no
    graph (a total replication failure has no post graph): every lane and
    both ingest paths put it in the per-run map."""
    return {"tables": [], "count": 0, "runs": False, "count_by_table": {}}[agg]


def _graph_getter(plan: QueryPlan, molly, vocab):
    """``run -> PackedGraph | None`` of the plan's condition: views over the
    packed corpus arrays on the packed-first path, else the run's
    provenance packed against ``vocab``."""
    from nemo_tpu_torch.graphs.packed import CorpusGraphs, pack_graph

    nc = getattr(molly, "native_corpus", None)
    if nc is not None:
        cg = CorpusGraphs(nc)
        row_by_iter = {int(it): i for i, it in enumerate(nc.iteration)}
        return lambda r: cg.get(plan.graph, row_by_iter[r.iteration])

    def graph_of(r):
        prov = r.pre_prov if plan.graph == "pre" else r.post_prov
        return None if prov is None else pack_graph(prov, vocab)

    return graph_of


def map_segment_runs(
    plan: QueryPlan,
    runs: list,
    vocab,
    graph_of,
    device,
    query_host_work: int = QUERY_HOST_WORK,
    pin_lanes: bool = False,
    routes: list | None = None,
    serial: bool = False,
    timer: PhaseTimer | None = None,
) -> QueryPartial:
    """Map one segment's runs: bucketize their graphs (``graph_of(run) ->
    PackedGraph | None``), one job a bucket (verb ``query``, lanes
    ``sparse_device`` and ``host``), drained as ``NEMO_SCHED`` says (the
    module's docstring).  Under ``off`` each bucket takes the lane
    ``query_lane`` picks for its work against ``query_host_work``; under
    the scheduler, ``pin_lanes`` pins each job to that lane (reason
    ``forced``).  ``routes``, when given, gets one record per bucket, as the
    bucket ran: rows, v, e, work, lane, reason (none for a dispatch the
    scheduler abandoned past its deadline).  ``timer`` gets the phases
    ``query.prep``, ``query.eval_<lane>`` and ``query.extract``."""
    from nemo_tpu_torch.graphs.packed import bucketize
    from nemo_tpu_torch.kernels.build import thread_loads
    from nemo_tpu_torch.parallel import sched as sched_mod

    timer = timer or PhaseTimer()
    with timer.phase("query.prep"):
        selected = _filter_runs(runs, plan.run_filter)
        part = QueryPartial(n_runs=len(selected))
        rids, graphs = [], []
        for r in selected:
            g = graph_of(r)
            if g is None or g.n_nodes == 0:
                part.per_run[r.iteration] = _empty_value(plan.agg)
                continue
            rids.append(r.iteration)
            graphs.append(g)
        if rids:
            bound = plan.bind(vocab)
            batches = bucketize(rids, graphs)
    if not rids:
        return part
    num_tables = max(1, len(vocab.tables))

    def make_execute(batch, job):
        rows, work = job.rows, job.work

        def execute(lane: str, reason: str, stolen: bool) -> np.ndarray:
            obs.metrics.inc("kernel.dispatches.query")
            obs.metrics.inc("query.rows_scanned", rows)
            with timer.phase("query.eval_host" if lane == "host" else "query.eval_device"):
                tp = _time_plane(batch) if plan.needs_time else np.full((rows, batch.v), -1, dtype=np.int32)
                if lane == "host":
                    cap = _eval_host(batch, tp, bound, num_tables)
                else:
                    loads = thread_loads()
                    cold = sched_mod.first_dispatch("query", device)
                    cap = _eval_device(batch, tp, bound, num_tables, device)
                    if cold or thread_loads() != loads:
                        job.wall_tainted = True
            if sched_mod.claim_dispatch():
                obs.metrics.inc(f"query.route.{lane}")
                if routes is not None:
                    routes.append({"rows": rows, "v": batch.v, "e": batch.e, "work": work, "lane": lane,
                                   "reason": reason})
            return cap

        return execute

    jobs = []
    for i, batch in enumerate(batches):
        work = len(batch.run_ids) * (batch.v + batch.e)
        pin = query_lane(work, query_host_work) if pin_lanes else None
        job = sched_mod.Job(index=i, verb="query", rows=len(batch.run_ids), v=batch.v, e=batch.e, work=work,
                            execute=None, pinned=pin, reason="forced" if pin else "sched",
                            lanes=("sparse_device", "host"), source="query")
        job.execute = make_execute(batch, job)
        jobs.append(job)
    if sched_mod.sched_env() == "off":
        caps = [job.execute(query_lane(job.work, query_host_work), "crossover", False) for job in jobs]
    else:
        scheduler = sched_mod.HeterogeneousScheduler(sched_mod.session_models(device), device=device)
        caps = scheduler.run(jobs, serial=serial)
    with timer.phase("query.extract"):
        for batch, cap in zip(batches, caps):
            part.per_run.update(_extract(plan, batch, cap, vocab))
    return part


# ---------------------------------------------------------------------------
# the corpus-level entry points
# ---------------------------------------------------------------------------


def corpus_vocab(molly):
    """One deterministic corpus-wide vocabulary, interned in run order (the
    packer's order), so bound plans and name validation never depend on
    which segments hit the cache.  On the packed-first path it is rebuilt
    from the corpus's string lists, which the engine interned in the same
    order."""
    from nemo_tpu_torch.graphs.packed import CorpusVocab

    vocab = CorpusVocab()
    nc = getattr(molly, "native_corpus", None)
    if nc is not None:
        for part in ("tables", "labels", "times"):
            voc = getattr(vocab, part)
            for text in getattr(nc, part):
                voc.intern(text)
        return vocab
    for r in molly.runs:
        for prov in (r.pre_prov, r.post_prov):
            if prov is None:
                continue
            for g in prov.goals:
                vocab.tables.intern(g.table)
                vocab.labels.intern(g.label)
                vocab.times.intern(g.time)
            for ru in prov.rules:
                vocab.tables.intern(ru.table)
                vocab.labels.intern(ru.label)
    return vocab


#: Held by every query that a serving surface runs (the report server's
#: ``POST /query``, the sidecar's Query RPC): their request threads never
#: run two queries on the device at once.
QUERY_LOCK = threading.Lock()


def ingest_corpus(fault_inj_out: str, corpus_cache: str | None = None, injector: str | None = None):
    """A corpus directory -> its packed-first MollyOutput, through the corpus
    store (``corpus_cache``: a root, ``off``, or None for
    ``NEMO_CORPUS_CACHE``), populating the store on a miss so the result
    is content-addressed (the JAX package's ``_ingest`` with packed ingest
    on).  The C++ engine is built first: a build failure raises."""
    from nemo_tpu_torch.analysis.pipeline import _ingest, _populate
    from nemo_tpu_torch.ingest.native import NATIVE
    from nemo_tpu_torch.store import resolve_store

    NATIVE.load()
    store = resolve_store(corpus_cache)
    molly, _kind, snap = _ingest(fault_inj_out, True, store, injector)
    if snap is not None:
        _populate(store, fault_inj_out, molly, snap)
    return molly


def execute_query(
    q: Query,
    molly,
    *,
    device=None,
    result_cache: str | None = None,
    use_cache: bool = True,
    query_host_work: int | None = None,
    routes: list | None = None,
    serial: bool = False,
) -> dict:
    """Plan and execute one query over an ingested corpus on ``device``
    (None: cuda, which raises without a card).  Returns the result document
    with ``stats``: ``cache`` (``hit``, ``miss``, or ``off`` when the corpus
    is not store-served), ``segments_mapped`` and ``timings`` (phase name ->
    seconds, the module's docstring; on the card each phase ends with a
    synchronize of the current stream).

    Two cache tiers in the result cache (``result_cache``: a root, ``off``,
    or None for ``NEMO_RESULT_CACHE``; ``use_cache=False`` skips both),
    keyed by ``analysis/delta.py:blob_cache_key``: the whole document
    (namespace ``query``), which a warm repeat returns with no job run, and
    one partial per segment (``query-partial``), so a grown corpus maps
    only its new segments.  ``query_host_work`` (None:
    ``derived_query_host_work`` on the device, resolved once a query) is
    the off drain's crossover; an explicit one also pins every job to its
    lane under the scheduler (:func:`map_segment_runs`'s ``pin_lanes``).
    ``routes`` and ``serial``: see :func:`map_segment_runs`."""
    from nemo_tpu_torch.analysis.delta import blob_cache_key, corpus_segments
    from nemo_tpu_torch.device import resolve_device, stream_sync
    from nemo_tpu_torch.store.rcache import resolve_result_cache

    dev = resolve_device(device)
    timer = PhaseTimer(sync=stream_sync(dev))
    with timer.phase("query.plan"):
        plan = plan_query(q)
    rc = resolve_result_cache(result_cache) if use_cache else None
    full_key = blob_cache_key("query", getattr(molly, "store_segments", None), {"plan": plan.key})
    if rc is not None and full_key is not None:
        blob = rc.load_blob("query", full_key)
        if blob is not None:
            obs.metrics.inc("query.cache.hit")
            doc = json.loads(blob.decode("utf-8"))
            doc["stats"] = {"cache": "hit", "segments_mapped": 0, "timings": timer.as_dict()}
            return doc
        obs.metrics.inc("query.cache.miss")

    with obs.span("query:execute", plan=plan.key[:12]):
        with timer.phase("query.prep"):
            qhw = derived_query_host_work(dev) if query_host_work is None else query_host_work
            vocab = corpus_vocab(molly)
            plan.validate_names(vocab)
            graph_of = _graph_getter(plan, molly, vocab)
        parts, mapped = [], 0
        for seg in corpus_segments(molly):
            pkey = None
            if seg.fingerprint is not None:
                pkey = blob_cache_key("query-partial", [{"fingerprint": seg.fingerprint}], {"plan": plan.key})
            if rc is not None and pkey is not None:
                blob = rc.load_blob("query-partial", pkey)
                if blob is not None:
                    obs.metrics.inc("query.partial.hit")
                    parts.append(QueryPartial.from_json(json.loads(blob.decode("utf-8"))))
                    continue
            obs.metrics.inc("query.partial.miss")
            part = map_segment_runs(plan, molly.runs[seg.start : seg.stop], vocab, graph_of, dev,
                                    query_host_work=qhw, pin_lanes=query_host_work is not None, routes=routes,
                                    serial=serial, timer=timer)
            mapped += 1
            if rc is not None and pkey is not None:
                rc.put_blob("query-partial", pkey, json.dumps(part.to_json(), sort_keys=True).encode("utf-8"))
            parts.append(part)
        with timer.phase("query.extract"):
            doc = finalize(plan, merge_query_partials(parts))
    if rc is not None and full_key is not None:
        rc.put_blob("query", full_key, json.dumps(doc, sort_keys=True).encode("utf-8"))
    obs.metrics.inc("query.executes")
    doc["stats"] = {"cache": "miss" if full_key is not None else "off", "segments_mapped": mapped,
                    "timings": timer.as_dict()}
    return doc


# ---------------------------------------------------------------------------
# the per-run Python oracle
# ---------------------------------------------------------------------------


def _oracle_holds(g, succ: dict, pred: dict, cond_tid: int) -> set:
    """Per-graph pure-Python mirror of ops/condition.py:mark_condition_holds."""
    goals = range(g.n_goals)
    tab = g.table_id
    roots = [n for n in goals if int(tab[n]) == cond_tid and not pred.get(n)]
    rules = {d for r in roots for d in succ.get(r, ()) if d >= g.n_goals and int(tab[d]) == cond_tid}
    trig = {d for r in rules for d in succ.get(r, ()) if d < g.n_goals}
    if not trig:
        return set()
    trig_tables = {int(tab[t]) for t in trig if int(tab[t]) >= 0}
    return {n for n in goals if int(tab[n]) == cond_tid or (int(tab[n]) >= 0 and int(tab[n]) in trig_tables)}


def _oracle_eval_graph(g, bound: tuple) -> set:
    """One graph's capture set by dict/set traversal: the semantics of
    ``_eval_patterns`` with none of its machinery (no planes, no waves, no
    buckets)."""
    patterns, needs_holds, cond_tid = bound
    succ: dict = {}
    pred: dict = {}
    for s, d in g.edges:
        succ.setdefault(int(s), []).append(int(d))
        pred.setdefault(int(d), []).append(int(s))
    holds = _oracle_holds(g, succ, pred, cond_tid) if needs_holds else set()
    planes = {"table": g.table_id, "label": g.label_id, "time": g.time_id, "type": g.type_id}

    def passes(i: int, step: tuple) -> bool:
        for test in step:
            if test[0] == "kind":
                ok = (i < g.n_goals) if test[1] == "goal" else (i >= g.n_goals)
            elif test[0] == "holds":
                want = bool(test[2]) if test[1] == "=" else not test[2]
                ok = (i in holds) == want
            else:
                fld, op, val = test
                cur = int(planes[fld][i])
                ok = (cur == val) if op == "=" else (cur != val)
            if not ok:
                return False
        return True

    def hop(state: set, kind, fwd: bool) -> set:
        adj = succ if fwd else pred
        if kind == HOP_ADJ:
            return {d for s in state for d in adj.get(s, ())}
        reach: set = set()
        frontier = state
        while frontier:
            frontier = {d for s in frontier for d in adj.get(s, ())} - reach
            reach |= frontier
        return reach

    cap: set = set()
    for steps, hops, ci in patterns:
        masks = [{i for i in range(g.n_nodes) if passes(i, s)} for s in steps]
        fwd = [masks[0]]
        for i, h in enumerate(hops):
            fwd.append(masks[i + 1] & hop(fwd[i], h, True))
        bwd = masks[-1]
        for i in range(len(hops) - 1, ci - 1, -1):
            bwd = masks[i] & hop(bwd, hops[i], False)
        cap |= fwd[ci] & bwd
    return cap


def oracle_query(q: Query, molly) -> dict:
    """The plain version of the query path: the same result document as
    :func:`execute_query`, one run at a time by dict/set graph traversal: no
    buckets, no lanes, no kernels, no cache."""
    plan = plan_query(q)
    vocab = corpus_vocab(molly)
    plan.validate_names(vocab)
    bound = plan.bind(vocab)
    graph_of = _graph_getter(plan, molly, vocab)
    selected = _filter_runs(molly.runs, plan.run_filter)
    part = QueryPartial(n_runs=len(selected))
    for r in selected:
        g = graph_of(r)
        if g is None or g.n_nodes == 0:
            part.per_run[r.iteration] = _empty_value(plan.agg)
            continue
        cap = _oracle_eval_graph(g, bound)
        tab = g.table_id
        if plan.agg == "tables":
            val = sorted({vocab.tables[int(tab[i])] for i in cap if int(tab[i]) >= 0})
        elif plan.agg == "count":
            val = len(cap)
        elif plan.agg == "runs":
            val = bool(cap)
        else:  # count_by_table
            hist: dict = {}
            for i in cap:
                t = int(tab[i])
                if t >= 0:
                    name = vocab.tables[t]
                    hist[name] = hist.get(name, 0) + 1
            val = hist
        part.per_run[r.iteration] = val
    doc = finalize(plan, part)
    doc["stats"] = {"cache": "oracle", "segments_mapped": 0}
    return doc


def run_query_text(text: str, molly, **kw) -> dict:
    """Text -> result document (the CLI's and the HTTP endpoint's entry)."""
    from nemo_tpu_torch.query.lang import parse_query

    obs.metrics.inc("query.compiles")
    return execute_query(parse_query(text), molly, **kw)


__all__ = [
    "QUERY_HOST_WORK",
    "QueryError",
    "QueryPartial",
    "corpus_vocab",
    "derived_query_host_work",
    "execute_query",
    "finalize",
    "ingest_corpus",
    "map_segment_runs",
    "merge_query_partials",
    "oracle_query",
    "query_lane",
    "run_query_text",
]
