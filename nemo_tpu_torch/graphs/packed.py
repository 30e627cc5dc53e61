"""Packed-array graph batches: the device-side representation.

Host-side numpy, shared by every device route of the port; a copy of the
JAX package's ``graphs/packed.py`` trimmed to what the port uses.

Each (run, condition) provenance graph becomes fixed-shape integer/boolean
arrays; runs of similar size share a bucket (padded to the bucket's V/E) so
kernels vmap over the run axis without ragged shapes (SURVEY.md §7 hard
part 2).  Bucketing-by-size is this framework's expert-parallelism analog:
same-shaped work groups per compiled program (SURVEY.md §2.3).

Node slot convention: goals first (in ProvData order), then rules; slot ids
are local to the graph.  Type ids: 0 none, 1 async, 2 next, 3 collapsed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nemo_tpu_torch.ingest.datatypes import ProvData

from .pgraph import PGraph, PNode
from .vocab import Vocab

TYPE_NONE, TYPE_ASYNC, TYPE_NEXT, TYPE_COLLAPSED = 0, 1, 2, 3
_TYPE_IDS = {"": TYPE_NONE, "async": TYPE_ASYNC, "next": TYPE_NEXT, "collapsed": TYPE_COLLAPSED}
TYPE_NAMES = {v: k for k, v in _TYPE_IDS.items()}


@dataclass
class CorpusVocab:
    """Corpus-wide interning of tables and labels (shared by all runs).

    "pre" and "post" are pinned to table ids 0/1 for every corpus: the two
    condition-table ids are STATIC args of the fused device program, so
    pinning removes the last corpus-content-dependent value from the
    stress-scale compile signature — all six case-study families (and any
    same-shape corpus) share ONE compiled program."""

    tables: Vocab = field(default_factory=Vocab)
    labels: Vocab = field(default_factory=Vocab)
    times: Vocab = field(default_factory=Vocab)

    def __post_init__(self) -> None:
        self.tables.intern("pre")
        self.tables.intern("post")


@dataclass
class PackedGraph:
    """One graph in packed form (host-side numpy; unpadded)."""

    n_goals: int
    n_nodes: int
    node_ids: list[str]  # slot -> original id string (host-side only)
    table_id: np.ndarray  # [n_nodes] int32
    label_id: np.ndarray  # [n_nodes] int32
    time_id: np.ndarray  # [n_nodes] int32
    type_id: np.ndarray  # [n_nodes] int32
    edges: np.ndarray  # [n_edges, 2] int32 (src slot, dst slot)


def pack_graph(prov: ProvData, vocab: CorpusVocab) -> PackedGraph:
    slot: dict[str, int] = {}
    node_ids: list[str] = []
    tables, labels, times, types = [], [], [], []
    for g in prov.goals:
        slot[g.id] = len(node_ids)
        node_ids.append(g.id)
        tables.append(vocab.tables.intern(g.table))
        labels.append(vocab.labels.intern(g.label))
        times.append(vocab.times.intern(g.time))
        types.append(TYPE_NONE)
    for r in prov.rules:
        slot[r.id] = len(node_ids)
        node_ids.append(r.id)
        tables.append(vocab.tables.intern(r.table))
        labels.append(vocab.labels.intern(r.label))
        times.append(vocab.times.intern(""))
        types.append(_TYPE_IDS.get(r.type, TYPE_NONE))
    edges = np.array(
        [[slot[e.src], slot[e.dst]] for e in prov.edges], dtype=np.int32
    ).reshape(-1, 2)
    return PackedGraph(
        n_goals=len(prov.goals),
        n_nodes=len(node_ids),
        node_ids=node_ids,
        table_id=np.asarray(tables, dtype=np.int32),
        label_id=np.asarray(labels, dtype=np.int32),
        time_id=np.asarray(times, dtype=np.int32),
        type_id=np.asarray(types, dtype=np.int32),
        edges=edges,
    )


def bucket_size(n: int, minimum: int = 16) -> int:
    """Next power of two >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def longest_path_len(n_nodes: int, edges: np.ndarray) -> int:
    """Longest path (in edges) of a DAG via topological relaxation; returns
    n_nodes if a cycle is present (the conservative trip-count fallback).

    The bounded-iteration kernels (ops/proto.py:hop_depths,
    ops/diff.py:longest_depths) only need trip counts >= this, not >= V —
    provenance DAGs are shallow (diameter ~ EOT x rule depth, SURVEY.md §5),
    so a tight static bound cuts the dominant sequential loops several-fold.
    """
    if n_nodes == 0 or len(edges) == 0:
        return 0
    indeg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(indeg, edges[:, 1], 1)
    out: list[list[int]] = [[] for _ in range(n_nodes)]
    for s, d in edges:
        out[s].append(d)
    dist = np.zeros(n_nodes, dtype=np.int64)
    stack = [i for i in range(n_nodes) if indeg[i] == 0]
    seen = 0
    while stack:
        u = stack.pop()
        seen += 1
        du = dist[u]
        for w in out[u]:
            if du + 1 > dist[w]:
                dist[w] = du + 1
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(w)
    if seen < n_nodes:  # cycle: fall back to the safe bound
        return n_nodes
    return int(dist.max())


@dataclass
class PackedBatch:
    """A batch of same-bucket graphs, padded to [B, V] / [B, E] (numpy)."""

    run_ids: list[int]  # batch row -> run iteration
    graphs: list[PackedGraph]  # batch row -> unpadded graph (host-side)
    v: int
    e: int
    n_nodes: np.ndarray  # [B] int32
    n_goals: np.ndarray  # [B] int32
    is_goal: np.ndarray  # [B, V] bool
    node_mask: np.ndarray  # [B, V] bool
    table_id: np.ndarray  # [B, V] int32 (-1 pad)
    label_id: np.ndarray  # [B, V] int32 (-1 pad)
    type_id: np.ndarray  # [B, V] int32
    edge_src: np.ndarray  # [B, E] int32 (0 pad)
    edge_dst: np.ndarray  # [B, E] int32 (0 pad)
    edge_mask: np.ndarray  # [B, E] bool
    # Tight static trip count for the depth-relaxation kernels: the batch's
    # longest DAG path (+1), capped at v.
    max_depth: int = 0


def pack_batch(
    run_ids: list[int],
    graphs: list[PackedGraph],
    v: int | None = None,
    e: int | None = None,
    b: int | None = None,
) -> PackedBatch:
    """Pack graphs into one padded batch.  `b` pads the RUN axis beyond
    len(graphs) with fully-masked rows (empty graphs): batch size is a shape
    dim in the compiled program's signature, so padding it to a common
    bucket lets differently-sized corpora share one compiled program.
    Padding rows never surface — consumers iterate `run_ids` (len = actual
    batch) and every kernel respects node_mask/edge_mask."""
    b = b or len(graphs)
    if b < len(graphs):
        raise ValueError(f"batch pad {b} smaller than graph count {len(graphs)}")
    v = v or bucket_size(max((g.n_nodes for g in graphs), default=1))
    e = e or bucket_size(max((len(g.edges) for g in graphs), default=1))
    n_nodes = np.zeros(b, dtype=np.int32)
    n_goals = np.zeros(b, dtype=np.int32)
    n_nodes[: len(graphs)] = [g.n_nodes for g in graphs]
    n_goals[: len(graphs)] = [g.n_goals for g in graphs]
    is_goal = np.zeros((b, v), dtype=bool)
    node_mask = np.zeros((b, v), dtype=bool)
    table_id = np.full((b, v), -1, dtype=np.int32)
    label_id = np.full((b, v), -1, dtype=np.int32)
    type_id = np.zeros((b, v), dtype=np.int32)
    edge_src = np.zeros((b, e), dtype=np.int32)
    edge_dst = np.zeros((b, e), dtype=np.int32)
    edge_mask = np.zeros((b, e), dtype=bool)
    for i, g in enumerate(graphs):
        n = g.n_nodes
        if n > v or len(g.edges) > e:
            raise ValueError(f"graph {i} exceeds bucket (V={v}, E={e}): n={n}, e={len(g.edges)}")
        is_goal[i, : g.n_goals] = True
        node_mask[i, :n] = True
        table_id[i, :n] = g.table_id
        label_id[i, :n] = g.label_id
        type_id[i, :n] = g.type_id
        ne = len(g.edges)
        if ne:
            edge_src[i, :ne] = g.edges[:, 0]
            edge_dst[i, :ne] = g.edges[:, 1]
            edge_mask[i, :ne] = True
    depth = max((longest_path_len(g.n_nodes, g.edges) for g in graphs), default=0)
    return PackedBatch(
        run_ids=list(run_ids),
        graphs=list(graphs),
        v=v,
        e=e,
        max_depth=min(v, max(1, depth + 1)),
        n_nodes=n_nodes,
        n_goals=n_goals,
        is_goal=is_goal,
        node_mask=node_mask,
        table_id=table_id,
        label_id=label_id,
        type_id=type_id,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_mask=edge_mask,
    )


def bucketize(run_ids: list[int], graphs: list[PackedGraph]) -> list[PackedBatch]:
    """Group graphs into same-(V,E)-bucket batches, in (V, E) order, keeping
    run order within each bucket; the run axis is not padded.  The query
    engine's buckets (query/engine.py), and so K2's shapes on that path."""
    groups: dict[tuple[int, int], tuple[list[int], list[PackedGraph]]] = {}
    for rid, g in zip(run_ids, graphs):
        key = (bucket_size(g.n_nodes), bucket_size(max(1, len(g.edges))))
        rids, gs = groups.setdefault(key, ([], []))
        rids.append(rid)
        gs.append(g)
    return [pack_batch(rids, gs, v, e) for (v, e), (rids, gs) in sorted(groups.items())]


def _pad_run_axis(n_runs: int, max_batch: int | None, shard_multiple: int = 1) -> int:
    """The run-axis pad: a power-of-two bucket (capped at max_batch), so
    differently-sized corpora share one batch shape, rounded UP to the run
    mesh's width, so that placing the batch on the mesh never pads it again
    (parallel/mesh.py:place_rows).  The multiple may push the pad past
    max_batch by fewer than shard_multiple rows: they would exist as mesh
    padding anyway."""
    b_pad = bucket_size(n_runs, 8)
    if max_batch:
        b_pad = min(b_pad, max_batch)
    if shard_multiple > 1:
        b_pad = -(-b_pad // shard_multiple) * shard_multiple
    return b_pad


# ---------------------------------------------------------------------------
# Packed-first corpus views: native ETL (or corpus store) arrays to batches
# with no per-graph Python repack.
# ---------------------------------------------------------------------------


class LazyNodeIds:
    """list-like slot -> namespaced-id view, fetched from the corpus on first
    index: only the runs a figure or a missing-event list needs (and the
    good run) ever materialize their id strings."""

    __slots__ = ("_corpus", "_cond", "_row", "_ids")

    def __init__(self, corpus, cond: str, row: int) -> None:
        self._corpus = corpus
        self._cond = cond
        self._row = row
        self._ids: list[str] | None = None

    def _materialize(self) -> list[str]:
        if self._ids is None:
            self._ids = self._corpus.lazy_node_ids(self._cond, self._row)
        return self._ids

    def __getitem__(self, i):
        return self._materialize()[i]

    def __len__(self) -> int:
        return len(self._materialize())

    def __iter__(self):
        return iter(self._materialize())


class CorpusGraphs:
    """Cache of per-(cond, row) PackedGraph views over a packed corpus: node
    arrays are numpy slices of the corpus's batch arrays (the edge pairs one
    stack), node ids are LazyNodeIds."""

    def __init__(self, corpus) -> None:
        self.corpus = corpus
        self._cache: dict[tuple[str, int], PackedGraph] = {}

    def get(self, cond: str, row: int) -> PackedGraph:
        key = (cond, row)
        g = self._cache.get(key)
        if g is None:
            cb = self.corpus.cond(cond)
            n = int(cb.n_nodes[row])
            ne = int(cb.edge_mask[row].sum())  # a contiguous True prefix
            edges = np.stack([cb.edge_src[row, :ne], cb.edge_dst[row, :ne]], axis=1).astype(
                np.int32, copy=False
            )
            g = self._cache[key] = PackedGraph(
                n_goals=int(cb.n_goals[row]),
                n_nodes=n,
                node_ids=LazyNodeIds(self.corpus, cond, row),
                table_id=cb.table_id[row, :n],
                label_id=cb.label_id[row, :n],
                time_id=cb.time_id[row, :n],
                type_id=cb.type_id[row, :n],
                edges=edges,
            )
        return g


class BatchGraphs:
    """PackedBatch.graphs of a corpus-built batch: batch row -> lazy view."""

    __slots__ = ("_cg", "_cond", "_rows")

    def __init__(self, cg: CorpusGraphs, cond: str, rows: list[int]) -> None:
        self._cg = cg
        self._cond = cond
        self._rows = rows

    def __getitem__(self, i: int) -> PackedGraph:
        return self._cg.get(self._cond, self._rows[i])

    def __len__(self) -> int:
        return len(self._rows)


def pack_batch_corpus(
    cg: CorpusGraphs,
    cond: str,
    rows: list[int],
    run_ids: list[int],
    v: int,
    e: int,
    b_pad: int,
    max_depth: int,
) -> PackedBatch:
    """pack_batch over corpus rows by vectorized slicing, no per-graph loop.
    Cutting the columns to the bucket's (v, e) is exact: every selected row
    has n_nodes <= v and n_edges <= e (its bucket key), so the dropped
    columns are padding."""
    cb = cg.corpus.cond(cond)
    k = len(rows)
    idx = np.asarray(rows, dtype=np.int64)

    def window(src: np.ndarray, width: int, fill) -> np.ndarray:
        # The bucket may be narrower (sub-bucket) or wider (a size floor
        # above the corpus dim) than the source; outside the copied window
        # everything is padding.  src[idx, :w] gathers only the window.
        w = min(width, src.shape[1])
        out = np.full((b_pad, width), fill, dtype=src.dtype)
        out[:k, :w] = src[idx, :w]
        return out

    n_nodes = np.zeros(b_pad, dtype=np.int32)
    n_goals = np.zeros(b_pad, dtype=np.int32)
    n_nodes[:k] = cb.n_nodes[idx]
    n_goals[:k] = cb.n_goals[idx]
    return PackedBatch(
        run_ids=list(run_ids),
        graphs=BatchGraphs(cg, cond, list(rows)),
        v=v,
        e=e,
        max_depth=min(v, max(1, max_depth)),
        n_nodes=n_nodes,
        n_goals=n_goals,
        is_goal=window(cb.is_goal, v, False),
        node_mask=window(cb.node_mask, v, False),
        table_id=window(cb.table_id, v, -1),
        label_id=window(cb.label_id, v, -1),
        type_id=window(cb.type_id, v, 0),
        edge_src=window(cb.edge_src, e, 0),
        edge_dst=window(cb.edge_dst, e, 0),
        edge_mask=window(cb.edge_mask, e, False),
    )


def bucketize_pairs_corpus(
    cg: CorpusGraphs,
    rows: list[int],
    iterations: np.ndarray,
    max_batch: int | None = None,
    min_v: int = 16,
    min_e: int = 16,
    shard_multiple: int = 1,
) -> list[tuple[PackedBatch, PackedBatch]]:
    """Joint size-bucketing of corpus rows, built by array slicing: both
    conditions of a run share one bucket, padded to the pair's common
    (V, E) — the shape contract of the fused analysis step
    (models/pipeline_model.py), which takes the pre and post batches of the
    same runs in one dispatch.  Run order is kept within a bucket, the run
    axis is padded as _pad_run_axis says (shard_multiple: the run mesh's
    width), and min_v/min_e floor the bucket dims.
    max_depth is the corpus-wide DAG bound rather than each bucket's:
    relaxation past the longest path changes nothing."""
    corpus = cg.corpus
    pre_cb, post_cb = corpus.pre, corpus.post
    idx = np.asarray(rows, dtype=np.int64)
    nmax = np.maximum(pre_cb.n_nodes[idx], post_cb.n_nodes[idx])
    emax = np.maximum(1, np.maximum(pre_cb.edge_mask[idx].sum(1), post_cb.edge_mask[idx].sum(1)))

    def vbucket(x: np.ndarray, floor: int) -> np.ndarray:
        x = np.maximum(x, floor).astype(np.float64)
        return (2 ** np.ceil(np.log2(x))).astype(np.int64)

    groups: dict[tuple[int, int], list[int]] = {}
    for r, vv, ee in zip(rows, vbucket(nmax, min_v).tolist(), vbucket(emax, min_e).tolist()):
        groups.setdefault((vv, ee), []).append(r)
    depth = int(corpus.max_depth)
    batches = []
    for (v, e), rws in sorted(groups.items()):
        step = max_batch or len(rws)
        for s in range(0, len(rws), step):
            chunk = rws[s : s + step]
            b_pad = _pad_run_axis(len(chunk), max_batch, shard_multiple)
            run_ids = [int(iterations[r]) for r in chunk]
            batches.append(
                (
                    pack_batch_corpus(cg, "pre", chunk, run_ids, v, e, b_pad, depth),
                    pack_batch_corpus(cg, "post", chunk, run_ids, v, e, b_pad, depth),
                )
            )
    return batches


def rewrite_run_prefix(orig_id: str, new_prefix: str) -> str:
    """Replace the run_<i>_<cond>_ namespace of an ingested node id
    (ingest/molly.py prefixing, reference molly.go:92) with a shadow-run
    prefix, mirroring the reference's sed rewrites (preprocessing.go:33-54)."""
    return new_prefix + orig_id.split("_", 3)[-1] if orig_id.count("_") >= 3 else new_prefix + orig_id


def unpack_to_pgraph(
    batch: PackedBatch,
    row: int,
    vocab: CorpusVocab,
    alive: np.ndarray,
    adj: np.ndarray,
    type_id: np.ndarray,
    cond_holds: np.ndarray,
    id_prefix: str,
) -> PGraph:
    """Materialize one (possibly kernel-rewritten) graph row back into a
    PGraph for DOT rendering.  ``alive``/``adj``/``type_id``/``cond_holds``
    are the step's numpy outputs for this row ([V], [V,V], [V], [V]);
    collapsed rules (slots whose type became TYPE_COLLAPSED) get fresh
    ids/labels per preprocessing.go:251-252."""
    g = batch.graphs[row]
    n = g.n_nodes
    alive_l = np.asarray(alive[:n]).tolist()
    type_l = np.asarray(type_id[:n]).tolist()
    holds_l = np.asarray(cond_holds[:n]).tolist()
    table_l = batch.table_id[row, :n].tolist()
    label_l = batch.label_id[row, :n].tolist()
    orig_type_l = batch.type_id[row, :n].tolist()
    time_l = g.time_id.tolist()
    out = PGraph()
    n_coll = 0
    names: dict[int, str] = {}
    for slot in range(n):
        if not alive_l[slot]:
            continue
        is_goal = slot < g.n_goals
        table = vocab.tables[table_l[slot]]
        if not is_goal and type_l[slot] == TYPE_COLLAPSED and orig_type_l[slot] != TYPE_COLLAPSED:
            label = f"{table}_collapsed"
            nid = f"{id_prefix}{label}_{n_coll}"
            n_coll += 1
        else:
            label = vocab.labels[label_l[slot]]
            nid = rewrite_run_prefix(g.node_ids[slot], id_prefix)
        names[slot] = nid
        out.add_node(
            PNode(
                id=nid,
                is_goal=is_goal,
                label=label,
                table=table,
                time=vocab.times[time_l[slot]] if is_goal else "",
                type="" if is_goal else TYPE_NAMES.get(type_l[slot], ""),
                cond_holds=bool(holds_l[slot]) if is_goal else False,
            )
        )
    srcs, dsts = np.nonzero(adj)
    for s, d in zip(srcs.tolist(), dsts.tolist()):
        if s in names and d in names:
            out.add_edge(names[s], names[d])
    return out
