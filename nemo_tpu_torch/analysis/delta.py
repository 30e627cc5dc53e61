"""The analysis as a map per corpus-store segment plus a reduce, a copy of
the JAX package's ``analysis/delta.py``.

  * **map** (:func:`map_runs`): the per-run verbs (condition marking,
    simplification, hazard and provenance figures, per-run prototype rule
    tables, good-anchored differential provenance) over a set of runs, and
    the anchor verbs (corrections, extension suggestions, repair
    candidates).  A run's artifacts do not depend on which runs share its
    batch, so mapping a segment alone gives the same bytes.
  * **reduce** (:func:`reduce_partials`): the cross-run aggregation:
    prototype intersection and union (analysis/protos.py set algebra over
    the per-run tables), per-failed-run missing lists, the achieved-
    antecedent count, the ranked repairs.  It imposes the corpus's run
    order itself, so it does not depend on the order of its partials.  The
    partials merge as a k-ary tree (:func:`merge_partials`); the streamed
    map pushes them into a :class:`TreeReducer` as its segments finish.

A :class:`SegmentPartial` is the intermediate: one segment's per-run
artifacts as plain strings and ints (no vocabulary ids, so it survives the
vocabulary growing on an append) and the names of its figure files.  The
result cache (``store/rcache.py``) keeps partials and whole reports under
the keys made here, which pin the corpus content (store segment
fingerprints), the anchor runs, the figure policy and the versions in
:func:`config_blob`, and name the implementation, so no key of the JAX
package's cache is ever served to the port.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from nemo_tpu_torch import obs
from nemo_tpu_torch.ingest.datatypes import MissingEvent

#: Bump when a verb or the reduce changes its OUTPUT: every cached result is
#: keyed on it.
ANALYSIS_ABI_VERSION = 2

#: Figure families of every figure-selected run (writer.py naming
#: run_<iter>_<family>.{dot,svg}), then those of a selected failed run when
#: a good run exists to diff against.
FIG_FAMILIES = ("spacetime", "pre_prov", "post_prov", "pre_prov_clean", "post_prov_clean")
DIFF_FAMILIES = ("diff_post_prov-diff", "diff_post_prov-failed")


def choose_good_run(molly) -> int | None:
    """The baseline successful run used for differential provenance: the
    first status-success run that ACHIEVED the consequent, else the first
    status-success run, else None.  ``GraphBackend.good_run_iter`` reads
    this one definition."""
    succ = molly.get_success_runs_iters()
    if not succ:
        return None
    by_iter = {r.iteration: r for r in molly.runs}
    for i in succ:
        if by_iter[i].time_post_holds:
            return i
    return succ[0]


def choose_baseline_run(molly, good_iter: int | None) -> int | None:
    """The good run when one exists, else the first run (the run whose
    antecedent provenance seeds extension candidates)."""
    if good_iter is not None:
        return good_iter
    return molly.runs[0].iteration if molly.runs else None


# ---------------------------------------------------------------------------
# segments and cache keys
# ---------------------------------------------------------------------------


@dataclass
class Segment:
    """One store segment's slice of the corpus, or the whole corpus as one
    anonymous segment when no store served the ingest."""

    name: str
    fingerprint: str | None  # None = anonymous (not cacheable)
    start: int  # first global run position
    n_runs: int

    @property
    def stop(self) -> int:
        return self.start + self.n_runs


def corpus_segments(molly) -> list[Segment]:
    """The segment spans the store attached to the ingest
    (``molly.store_segments``, append order = run order), else one
    anonymous segment."""
    meta = getattr(molly, "store_segments", None)
    if not meta or sum(int(m["n_runs"]) for m in meta) != len(molly.runs):
        return [Segment("all", None, 0, len(molly.runs))]
    out, start = [], 0
    for m in meta:
        n = int(m["n_runs"])
        out.append(Segment(str(m["name"]), m.get("fingerprint"), start, n))
        start += n
    return out


def config_blob(figures: str) -> dict:
    """Everything but the corpus content that decides the report bytes: the
    figure policy, the output-affecting versions, and the implementation,
    which keeps the port's keys apart from the JAX package's even under a
    shared cache root."""
    from nemo_tpu_torch.report.svg import RENDER_FORMAT_VERSION
    from nemo_tpu_torch.store.npack import NPACK_ABI_VERSION

    return {
        "impl": "nemo_tpu_torch",
        "figures": figures or "all",
        "analysis_abi": ANALYSIS_ABI_VERSION,
        "render_format": RENDER_FORMAT_VERSION,
        "npack_abi": NPACK_ABI_VERSION,
    }


def _key(doc: dict) -> str:
    return hashlib.sha256(json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def report_cache_key(molly, figures: str) -> str | None:
    """Content address of a whole report tree: every segment fingerprint,
    the config blob and the quarantine set (quarantine.json is part of the
    tree: two corpora with the same healthy segments and different
    quarantined runs must not share an entry).  None when a segment is
    anonymous (no store)."""
    segs = corpus_segments(molly)
    if any(s.fingerprint is None for s in segs):
        return None
    return _key({
        "kind": "report", "config": config_blob(figures), "segments": [s.fingerprint for s in segs],
        "quarantined": [[q["position"], q.get("file"), q.get("error")] for q in molly.quarantined or ()],
    })


def blob_cache_key(kind: str, segments_meta, extra: dict) -> str | None:
    """Content address of an opaque result blob derived from a stored corpus
    (the query's documents and segment partials): every segment
    fingerprint, the caller's ``extra`` (the query's plan key), the
    analysis ABI and the implementation.  None when the corpus carries no
    segment identities (not store-served)."""
    fps = [s.get("fingerprint") for s in segments_meta or ()]
    if not fps or any(f is None for f in fps):
        return None
    return _key({"kind": kind, "impl": "nemo_tpu_torch", "segments": fps, "extra": extra,
                 "analysis_abi": ANALYSIS_ABI_VERSION})


def partial_cache_key(
    seg: Segment, segments: list[Segment], good_iter: int | None, baseline_iter: int | None, figures: str
) -> str | None:
    """Content address of one segment's partial: its fingerprint, the config
    blob and the ANCHOR context (the good and baseline runs and the
    fingerprints of their segments: the diff, corrections and extensions
    are functions of those runs, so a changed anchor misses every old
    partial).  None for ``sample:N``, whose selection depends on the whole
    corpus's run list, so figure ownership does not split by segment."""
    if seg.fingerprint is None or (figures or "all").startswith("sample:"):
        return None

    def anchor_fp(it: int | None) -> str | None:
        pos = None if it is None else segments[0]._pos_by_iter.get(it)
        if pos is None:
            return None
        return next((s.fingerprint for s in segments if s.start <= pos < s.stop), None)

    return _key(
        {
            "kind": "partial",
            "config": config_blob(figures),
            "segment": seg.fingerprint,
            "good": [good_iter, anchor_fp(good_iter)],
            "baseline": [baseline_iter, anchor_fp(baseline_iter)],
        }
    )


def attach_positions(segments: list[Segment], molly) -> list[Segment]:
    """Give the segment table an iteration -> position index (a repeated
    iteration keeps its first position, like every by-iteration dict)."""
    tbl: dict[int, int] = {}
    for pos, r in enumerate(molly.runs):
        tbl.setdefault(r.iteration, pos)
    for s in segments:
        s._pos_by_iter = tbl
    return segments


# ---------------------------------------------------------------------------
# sub-corpus views (a grown corpus maps only its new rows)
# ---------------------------------------------------------------------------

_COND_FIELDS = (
    "table_id", "label_id", "time_id", "type_id", "is_goal", "node_mask",
    "edge_src", "edge_dst", "edge_mask", "n_nodes", "n_goals", "chain_linear",
)


class _CorpusRowView:
    """Row subset of a NativeCorpus/StoreCorpus: the batch arrays gathered
    to the rows, the per-run strings delegated to the base corpus by its
    own row."""

    def __init__(self, base, rows: list[int]) -> None:
        from nemo_tpu_torch.ingest.native import NativeCondBatch

        idx = np.asarray(rows, dtype=np.int64)
        self._base = base
        self._rows = list(rows)
        self.n_runs = len(rows)
        for name in ("v", "e", "max_depth", "tables", "labels", "times", "pre_tid", "post_tid"):
            setattr(self, name, getattr(base, name))
        self.iteration = np.asarray(base.iteration)[idx]
        self.success = np.asarray(base.success)[idx]

        def gather(cb, f):
            # A multi-segment store batch gathers from its per-segment maps
            # without building the corpus-wide plane.
            take = getattr(cb, "take", None)
            return take(f, idx) if take is not None else np.asarray(getattr(cb, f))[idx]

        self.pre = NativeCondBatch(**{f: gather(base.pre, f) for f in _COND_FIELDS})
        self.post = NativeCondBatch(**{f: gather(base.post, f) for f in _COND_FIELDS})

    def cond(self, name: str):
        return self.pre if name == "pre" else self.post

    def prov_json(self, cond_name: str, row: int) -> bytes:
        return self._base.prov_json(cond_name, self._rows[row])

    def run_head_json(self, row: int) -> bytes:
        return self._base.run_head_json(self._rows[row])

    def lazy_node_ids(self, cond_name: str, row: int) -> list[str]:
        return self._base.lazy_node_ids(cond_name, self._rows[row])


def subset_molly(molly, rows: list[int]):
    """MollyOutput view over a row subset (global positions, ascending).
    The run objects are shared with the full molly: the map never changes
    them, only the recommendation assembly does, on the full molly."""
    from nemo_tpu_torch.ingest.molly import MollyOutput

    out = MollyOutput(run_name=molly.run_name, output_dir=molly.output_dir,
                      ships_spacetime_dots=molly.ships_spacetime_dots)
    out.runs = [molly.runs[r] for r in rows]
    for run in out.runs:
        out.runs_iters.append(run.iteration)
        (out.success_runs_iters if run.succeeded else out.failed_runs_iters).append(run.iteration)
    nc = getattr(molly, "native_corpus", None)
    if nc is not None:
        out.native_corpus = _CorpusRowView(nc, rows)
    return out


# ---------------------------------------------------------------------------
# the intermediate
# ---------------------------------------------------------------------------


class _JsonEvent:
    """A MissingEvent read back from a cached partial: only its to_json is
    consumed (debugging.json), so the stored JSON is carried as it is."""

    __slots__ = ("_doc",)

    def __init__(self, doc: dict) -> None:
        self._doc = doc

    def to_json(self) -> dict:
        return self._doc


@dataclass
class SegmentPartial:
    """Everything the reduce needs from one set of runs, keyed by iteration
    (in memory the missing events are objects; ``to_json``/``from_json``
    carry them as their JSON)."""

    iters: list[int] = field(default_factory=list)
    success_iters: list[int] = field(default_factory=list)
    failed_iters: list[int] = field(default_factory=list)
    #: per success run: ordered qualifying prototype rule tables ([] = run
    #: did not achieve the antecedent)
    proto_ordered: dict[int, list[str]] = field(default_factory=dict)
    #: per failed run: sorted distinct rule tables of its simplified
    #: consequent graph (prototype missing-list input)
    present: dict[int, list[str]] = field(default_factory=dict)
    #: per failed run: its MissingEvents (diff frontier)
    missing: dict[int, list[MissingEvent]] = field(default_factory=dict)
    #: per run: achieved-antecedent goal count (extensions gate input)
    achieved: dict[int, int] = field(default_factory=dict)
    #: anchor content (derived from the good and baseline runs)
    corrections: list[str] | None = None
    extensions: list[str] | None = None
    #: per run: sorted distinct extension-candidate rule tables; None = the
    #: map's backend has no synthesis hooks (supports_synth False), so the
    #: reduce builds no ranked repairs
    ext_candidates: dict[int, list[str]] | None = None
    #: anchor content: the good run's qualifying prototype rule tables (the
    #: left side of the correction anti-join); None without a good run
    good_proto: list[str] | None = None
    #: figure files (basenames under figures/) of these runs
    fig_files: list[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "iters": self.iters,
            "success_iters": self.success_iters,
            "failed_iters": self.failed_iters,
            "proto_ordered": {str(k): v for k, v in self.proto_ordered.items()},
            "present": {str(k): v for k, v in self.present.items()},
            "missing": {str(k): [m.to_json() for m in v] for k, v in self.missing.items()},
            "achieved": {str(k): v for k, v in self.achieved.items()},
            "corrections": self.corrections,
            "extensions": self.extensions,
            "ext_candidates": None
            if self.ext_candidates is None
            else {str(k): v for k, v in self.ext_candidates.items()},
            "good_proto": self.good_proto,
            "fig_files": self.fig_files,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentPartial":
        ext = d.get("ext_candidates")
        return cls(
            iters=[int(i) for i in d["iters"]],
            success_iters=[int(i) for i in d["success_iters"]],
            failed_iters=[int(i) for i in d["failed_iters"]],
            proto_ordered={int(k): list(v) for k, v in d["proto_ordered"].items()},
            present={int(k): list(v) for k, v in d["present"].items()},
            missing={int(k): [_JsonEvent(m) for m in v] for k, v in d["missing"].items()},
            achieved={int(k): int(v) for k, v in d["achieved"].items()},
            corrections=d.get("corrections"),
            extensions=d.get("extensions"),
            ext_candidates=None if ext is None else {int(k): list(v) for k, v in ext.items()},
            good_proto=d.get("good_proto"),
            fig_files=list(d.get("fig_files") or []),
        )


def figure_files_for_run(iteration: int, failed: bool, has_diff: bool, selected: bool) -> list[str]:
    """The figure file basenames of one run (none unless the policy selected
    it; the diff families only for a failed run with a diff)."""
    if not selected:
        return []
    fams = list(FIG_FAMILIES) + (list(DIFF_FAMILIES) if failed and has_diff else [])
    return [f"run_{iteration}_{fam}.{ext}" for fam in fams for ext in ("dot", "svg")]


@dataclass
class MapOutput:
    """The map's per-run artifacts of its owned runs plus the DOT graphs of
    their figure-selected subset, keyed by iteration."""

    own_iters: list[int] = field(default_factory=list)
    proto_ordered: dict[int, list[str]] = field(default_factory=dict)
    present: dict[int, list[str]] = field(default_factory=dict)
    missing: dict[int, list[MissingEvent]] = field(default_factory=dict)
    achieved: dict[int, int] = field(default_factory=dict)
    corrections: list[str] = field(default_factory=list)
    extensions: list[str] = field(default_factory=list)
    #: None = the backend has no synthesis hooks: no repairs.json
    ext_candidates: dict[int, list[str]] | None = None
    good_proto: list[str] | None = None
    # figure dots per family, keyed by iteration (figure-selected runs)
    hazard: dict = field(default_factory=dict)
    pre: dict = field(default_factory=dict)
    post: dict = field(default_factory=dict)
    pre_clean: dict = field(default_factory=dict)
    post_clean: dict = field(default_factory=dict)
    diff: dict = field(default_factory=dict)
    diff_failed: dict = field(default_factory=dict)
    #: filled instead of the per-run dicts when the backend has no per-run
    #: decomposition (supports_delta False): the global verbs' outputs
    legacy: dict | None = None

    def merge(self, other: "MapOutput") -> None:
        """Fold another map's artifacts in (a map of several groups, one
        segment each).  Per-run dicts are keyed by iteration and disjoint
        across segments; the anchor content is a function of the anchor
        runs, which ride in every view, so any group's copy is the
        corpus's."""
        self.merge_figures(other)
        for name in ("proto_ordered", "present", "missing", "achieved"):
            getattr(self, name).update(getattr(other, name))
        self.corrections = list(other.corrections)
        self.extensions = list(other.extensions)
        self.good_proto = other.good_proto
        if other.ext_candidates is not None:
            if self.ext_candidates is None:
                self.ext_candidates = {}
            self.ext_candidates.update(other.ext_candidates)
        if other.legacy is not None:
            self.legacy = other.legacy

    def merge_figures(self, other: "MapOutput") -> None:
        """Fold in only what the report phase reads: the owned runs and the
        figure DOTs (the streamed map: every per-run artifact travels in the
        segment partials instead)."""
        self.own_iters.extend(other.own_iters)
        for name in ("hazard", "pre", "post", "pre_clean", "post_clean", "diff", "diff_failed"):
            getattr(self, name).update(getattr(other, name))

    def as_partial(self, iters: list[int]) -> SegmentPartial:
        """The reduce's input: this map's artifacts sliced to runs ``iters``
        (one segment's, or all)."""
        succ = [i for i in iters if i in self.proto_ordered]
        failed = [i for i in iters if i in self.present]
        return SegmentPartial(
            iters=list(iters),
            success_iters=succ,
            failed_iters=failed,
            proto_ordered={i: self.proto_ordered[i] for i in succ},
            present={i: self.present[i] for i in failed},
            missing={i: self.missing[i] for i in failed if i in self.missing},
            achieved={i: self.achieved[i] for i in iters if i in self.achieved},
            corrections=list(self.corrections),
            extensions=list(self.extensions),
            ext_candidates=None
            if self.ext_candidates is None
            else {i: self.ext_candidates[i] for i in iters if i in self.ext_candidates},
            good_proto=None if self.good_proto is None else list(self.good_proto),
            fig_files=[
                f
                for i in iters
                for f in figure_files_for_run(
                    i, failed=i in self.present, has_diff=i in self.diff, selected=i in self.hazard
                )
            ],
        )


def map_runs(
    backend,
    molly_view,
    fault_inj_out: str,
    good_iter: int | None,
    fig_set: set,
    timer,
    own_set: set | None = None,
    publish: bool = False,
) -> MapOutput:
    """Run the analysis verbs over ``molly_view`` (already init_graph_db'd
    into ``backend``) in the reference's phase order (main.go:106-292) and
    collect the per-run artifacts of the OWNED runs (``own_set``, default
    all; the anchor runs may ride along as context only) and the figure
    DOTs of those in ``fig_set``.  ``publish`` says the output will be
    cached per segment: the anchor verbs then run ungated (a grown corpus
    may gain its first failure in a new segment and merge this partial);
    otherwise they keep the reference's gates, corrections only when a run
    failed (main.go:166-173), extension suggestions only when some run
    missed the antecedent.

    A backend without the per-run hooks (``supports_delta`` False,
    Neo4jBackend) runs the global verbs instead, create_prototypes and
    generate_extensions, whose outputs ride in ``MapOutput.legacy`` to
    ``reduce_legacy``; one without ``supports_synth`` leaves
    ``ext_candidates`` None, and the report has no repairs.json."""
    from nemo_tpu_torch.backend.base import NoSuccessfulRunError

    out = MapOutput()
    view_iters = molly_view.get_runs_iters()
    view_failed = molly_view.get_failed_runs_iters()
    own = set(view_iters) if own_set is None else own_set
    out.own_iters = [i for i in view_iters if i in own]
    try:
        view_good = backend.good_run_iter()
    except NoSuccessfulRunError:
        view_good = None
    if view_good != good_iter:
        raise RuntimeError(
            f"the view chose good run {view_good!r}, the corpus {good_iter!r}: the anchor run must be in the view"
        )

    fig_iters = [i for i in view_iters if i in fig_set]
    own_fig = [i for i in fig_iters if i in own]
    own_failed = [f for f in view_failed if f in own]
    own_fig_failed = [f for f in own_failed if f in fig_set]

    with timer.phase("load_raw_provenance"):
        backend.load_raw_provenance()
    with timer.phase("simplify"):
        backend.simplify_prov(view_iters)
    with timer.phase("hazard"):
        out.hazard = dict(zip(own_fig, backend.create_hazard_analysis(fault_inj_out, own_fig)))

    view_succ = molly_view.get_success_runs_iters()
    own_succ = [i for i in view_succ if i in own]
    legacy = not getattr(backend, "supports_delta", False)
    with timer.phase("prototypes"):
        if legacy:
            inter, inter_miss, union, union_miss = backend.create_prototypes(view_succ, view_failed)
        else:
            ordered, present = backend.proto_tables_by_run(own_succ, own_failed)
            out.proto_ordered = {i: list(ordered.get(i, [])) for i in own_succ}
            out.present = {f: sorted(present.get(f, ())) for f in own_failed}

    # The good run's post dot is the diff overlay's backdrop: pulled even
    # when the good run is context from a cached segment.
    pull_iters = list(own_fig)
    if good_iter is not None and good_iter in fig_set and good_iter not in own:
        pull_iters = sorted(set(pull_iters) | {good_iter}, key=view_iters.index)
    with timer.phase("pull_prov"):
        pre_dots, post_dots, pre_clean_dots, post_clean_dots = backend.pull_pre_post_prov(pull_iters)
    by = dict(zip(pull_iters, zip(pre_dots, post_dots, pre_clean_dots, post_clean_dots)))
    for i in own_fig:
        out.pre[i], out.post[i], out.pre_clean[i], out.post_clean[i] = by[i]

    missing_events: list[list[MissingEvent]] = [[] for _ in own_failed]
    diff_dots: list = []
    failed_dots: list = []
    if good_iter is not None and own_failed:
        success_post_dot = by[good_iter][1] if good_iter in by else None
        with timer.phase("diff_prov"):
            diff_dots, failed_dots, missing_events = backend.create_naive_diff_prov(
                False, own_failed, success_post_dot, dot_iters=own_fig_failed
            )
    out.missing = dict(zip(own_failed, missing_events))
    out.diff = dict(zip(own_fig_failed, diff_dots))
    out.diff_failed = dict(zip(own_fig_failed, failed_dots))

    # The legacy map is never published: the reference's failures gate.
    if good_iter is not None and (view_failed or (publish and not legacy)):
        with timer.phase("corrections"):
            out.corrections = backend.generate_corrections()
    with timer.phase("extensions"):
        if legacy:
            all_achieved, extensions = backend.generate_extensions()
            out.legacy = {
                "inter": inter,
                "inter_miss": dict(zip(view_failed, inter_miss)),
                "union": union,
                "union_miss": dict(zip(view_failed, union_miss)),
                "all_achieved": all_achieved,
                "extensions": extensions,
            }
        else:
            counts = backend.achieved_pre_goal_counts()
            out.achieved = {i: int(counts.get(i, 0)) for i in out.own_iters}
            # Unpublished, the map is the whole corpus, so its achieved sum
            # is the reduce's all-achieved gate.
            if publish or sum(out.achieved.values()) < len(view_iters):
                out.extensions = backend.extension_suggestions()

    # Corpus-ranked repair candidates: per-run extension candidates plus the
    # good run's prototype tables (the correction anti-join's left side),
    # anchor content every partial carries alike.
    if not legacy and getattr(backend, "supports_synth", False):
        with timer.phase("synthesis"):
            ext = backend.synth_candidates(out.own_iters)
            out.ext_candidates = {i: list(ext.get(i, [])) for i in out.own_iters}
            if good_iter is not None:
                g_ordered, _ = backend.proto_tables_by_run([good_iter], [])
                out.good_proto = list(g_ordered.get(good_iter, []))
    return out


#: Merge arity of the tree reduce (the JAX package's NEMO_REDUCE_ARITY
#: default; the port reads no knob for it).  The reduce state stays at
#: O(arity * log_arity(S)) live partials instead of all S.
REDUCE_ARITY = 8


def merge_partials(parts: list[SegmentPartial], arity: int | None = None) -> SegmentPartial:
    """Merge partials into one as a k-ary tree (pairwise at arity 2).  Per-run
    dicts are keyed by iteration and disjoint across partials; the anchor
    content (corrections, extensions, good_proto) is taken together from the
    later carrier of a merge, the flat left fold's last-wins: every carrier
    holds the same values, so the tree equals the flat fold for any arity
    and any order."""
    if not parts:
        return SegmentPartial()
    k = arity or REDUCE_ARITY
    items = list(parts)
    while len(items) > 1:
        items = [_merge_group(items[i : i + k]) for i in range(0, len(items), k)]
        obs.metrics.inc("delta.tree_merge_levels")
    return items[0]


def _merge_group(group: list[SegmentPartial]) -> SegmentPartial:
    """One merge node: fold a group of at most arity partials left to right."""
    if len(group) == 1:
        return group[0]
    out = SegmentPartial()
    for p in group:
        out.iters.extend(p.iters)
        out.success_iters.extend(p.success_iters)
        out.failed_iters.extend(p.failed_iters)
        out.fig_files.extend(p.fig_files)
        out.proto_ordered.update(p.proto_ordered)
        out.present.update(p.present)
        out.missing.update(p.missing)
        out.achieved.update(p.achieved)
        if p.ext_candidates is not None:
            if out.ext_candidates is None:
                out.ext_candidates = {}
            out.ext_candidates.update(p.ext_candidates)
        if p.corrections is not None:
            out.corrections = list(p.corrections)
            out.extensions = list(p.extensions or [])
            out.good_proto = None if p.good_proto is None else list(p.good_proto)
    obs.metrics.inc("delta.tree_merges")
    return out


class TreeReducer:
    """The streamed reduce: partials are pushed as their segments finish and
    fold like a binary counter: level 0 buffers up to ``arity`` partials, a
    full buffer merges into one level-1 partial, and so on, so at most
    ``arity * ceil(log_arity(S))`` partials are live.  ``partials()`` is the
    live frontier in push order (deepest level first), which
    :func:`reduce_partials` finishes: equal to reducing the flat list."""

    def __init__(self, arity: int | None = None) -> None:
        self.arity = arity or REDUCE_ARITY
        self._levels: list[list[SegmentPartial]] = []
        self.pushed = 0

    def push(self, p: SegmentPartial) -> None:
        self.pushed += 1
        lvl = 0
        while True:
            if len(self._levels) <= lvl:
                self._levels.append([])
            buf = self._levels[lvl]
            buf.append(p)
            if len(buf) < self.arity:
                return
            p = _merge_group(buf)
            self._levels[lvl] = []
            lvl += 1

    def live(self) -> int:
        return sum(len(b) for b in self._levels)

    def partials(self) -> list[SegmentPartial]:
        """The live frontier, in push order (a level-N item was pushed
        before any surviving lower-level item)."""
        out: list[SegmentPartial] = []
        for lvl in reversed(range(len(self._levels))):
            out.extend(self._levels[lvl])
        return out


@dataclass
class Reduced:
    """Global analysis results, ready for recommendation assembly."""

    inter: list[str]  # <code>-wrapped
    union: list[str]
    inter_miss: dict[int, list[str]]  # per failed iteration
    union_miss: dict[int, list[str]]
    missing: dict[int, list]  # per failed iteration: MissingEvent-likes
    corrections: list[str]
    extensions: list[str]
    all_achieved: bool
    #: corpus-ranked repair document (analysis/synth.py:build_repairs,
    #: repairs.json); None when the backend has no synthesis hooks
    repairs: dict | None = None


def reduce_legacy(mo: MapOutput, molly, good_iter: int | None) -> Reduced:
    """The corpus-global results of one map by a backend without per-run
    hooks (``MapOutput.legacy``: its global verbs' outputs), passed through
    with the map's missing events and corrections, under the reference's
    gates; no repairs."""
    failed_iters = molly.get_failed_runs_iters()
    legacy = mo.legacy
    return Reduced(
        inter=legacy["inter"],
        union=legacy["union"],
        inter_miss=dict(legacy["inter_miss"]),
        union_miss=dict(legacy["union_miss"]),
        missing={f: mo.missing.get(f, []) for f in failed_iters},
        corrections=list(mo.corrections) if (good_iter is not None and failed_iters) else [],
        # generate_extensions applied the all-achieved gate already.
        extensions=legacy["extensions"],
        all_achieved=legacy["all_achieved"],
    )


def reduce_partials(partials: list[SegmentPartial], molly, good_iter: int | None) -> Reduced:
    """Merge partials into the corpus-global analysis results, in the
    corpus's run order (analysis/protos.py's set algebra)."""
    from nemo_tpu_torch.analysis.protos import intersect_proto, missing_from, union_proto, wrap_code
    from nemo_tpu_torch.analysis.synth import build_repairs

    failed_iters = molly.get_failed_runs_iters()
    success_iters = molly.get_success_runs_iters()

    with obs.span("analysis:reduce", segments=len(partials)):
        merged = merge_partials(partials)
        missing = dict(merged.missing)
        if merged.corrections is None and molly.runs:
            raise RuntimeError("no partial carried the anchor (good/baseline) results")

        per_run = [merged.proto_ordered.get(i, []) for i in success_iters]
        inter_raw = intersect_proto(per_run, "post")
        union_raw = union_proto(per_run, "post")
        inter_miss: dict[int, list[str]] = {}
        union_miss: dict[int, list[str]] = {}
        for f in failed_iters:
            ptab = set(merged.present.get(f, ()))
            inter_miss[f] = missing_from(inter_raw, ptab)
            union_miss[f] = missing_from(union_raw, ptab)
            missing.setdefault(f, [])

        all_achieved = sum(merged.achieved.values()) >= len(molly.runs)
        repairs = None
        if merged.ext_candidates is not None:
            repairs = build_repairs(merged.good_proto, merged.ext_candidates, merged.present, molly, good_iter)
    return Reduced(
        inter=wrap_code(inter_raw),
        union=wrap_code(union_raw),
        inter_miss=inter_miss,
        union_miss=union_miss,
        missing=missing,
        # The reference gates corrections on failures existing and a good
        # run to diff against (main.go:166-173); extension suggestions only
        # apply when some run missed the antecedent.
        corrections=list(merged.corrections or []) if (good_iter is not None and failed_iters) else [],
        extensions=[] if all_achieved else list(merged.extensions or []),
        all_achieved=all_achieved,
        repairs=repairs,
    )


def kernel_dispatch_count(counters: dict) -> int:
    """Total analysis kernel dispatches in a metrics counter dict: the
    device verbs and the host lane's runs (``kernel.dispatches.*``).  A
    warm result-cache hit sums to exactly 0."""
    return int(sum(v for k, v in counters.items() if k.startswith("kernel.dispatches.")))
