"""The analysis as one map over the corpus plus a reduce, a copy of the JAX
package's ``analysis/delta.py`` trimmed to one segment: no store segments,
cache keys or streamed tree reduce.

  * **map** (:func:`map_runs`): the per-run verbs (condition marking,
    simplification, hazard and provenance figures, per-run prototype rule
    tables, good-anchored differential provenance) and the anchor verbs
    (corrections, extension suggestions, repair candidates).
  * **reduce** (:func:`reduce_partials`): the cross-run aggregation:
    prototype intersection and union (analysis/protos.py set algebra over
    the per-run tables), per-failed-run missing lists, the achieved-
    antecedent count, the ranked repairs.  It imposes the corpus's run
    order itself, so it does not depend on the order of its partials.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nemo_tpu_torch.ingest.datatypes import MissingEvent


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


@dataclass
class SegmentPartial:
    """Everything the reduce needs from one set of runs, keyed by
    iteration."""

    iters: list[int] = field(default_factory=list)
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
    #: per run: sorted distinct extension-candidate rule tables
    ext_candidates: dict[int, list[str]] = field(default_factory=dict)
    #: anchor content: the good run's qualifying prototype rule tables (the
    #: left side of the correction anti-join); None without a good run
    good_proto: list[str] | None = None


@dataclass
class MapOutput:
    """The map's per-run artifacts plus the DOT graphs of its
    figure-selected runs, keyed by iteration."""

    proto_ordered: dict[int, list[str]] = field(default_factory=dict)
    present: dict[int, list[str]] = field(default_factory=dict)
    missing: dict[int, list[MissingEvent]] = field(default_factory=dict)
    achieved: dict[int, int] = field(default_factory=dict)
    corrections: list[str] = field(default_factory=list)
    extensions: list[str] = field(default_factory=list)
    ext_candidates: dict[int, list[str]] = field(default_factory=dict)
    good_proto: list[str] | None = None
    # figure dots per family, keyed by iteration (figure-selected runs)
    hazard: dict = field(default_factory=dict)
    pre: dict = field(default_factory=dict)
    post: dict = field(default_factory=dict)
    pre_clean: dict = field(default_factory=dict)
    post_clean: dict = field(default_factory=dict)
    diff: dict = field(default_factory=dict)
    diff_failed: dict = field(default_factory=dict)

    def as_partial(self, iters: list[int]) -> SegmentPartial:
        """The reduce's input: this map's artifacts over runs ``iters``."""
        return SegmentPartial(
            iters=list(iters),
            proto_ordered=self.proto_ordered,
            present=self.present,
            missing=self.missing,
            achieved=self.achieved,
            corrections=self.corrections,
            extensions=self.extensions,
            ext_candidates=self.ext_candidates,
            good_proto=self.good_proto,
        )


def map_runs(backend, molly, fault_inj_out: str, good_iter: int | None, fig_set: set, timer) -> MapOutput:
    """Run the analysis verbs over the whole corpus (already
    init_graph_db'd into ``backend``) in the reference's phase order
    (main.go:106-292) and collect the per-run artifacts and the figure DOTs
    of the runs in ``fig_set``.  The anchor verbs keep the reference's
    gates: corrections only when a run failed (main.go:166-173), extension
    suggestions only when some run missed the antecedent."""
    from nemo_tpu_torch.backend.base import NoSuccessfulRunError

    out = MapOutput()
    iters = molly.get_runs_iters()
    failed = molly.get_failed_runs_iters()
    try:
        backend_good = backend.good_run_iter()
    except NoSuccessfulRunError:
        backend_good = None
    if backend_good != good_iter:
        raise RuntimeError(f"the backend chose good run {backend_good!r}, the pipeline {good_iter!r}")

    fig_iters = [i for i in iters if i in fig_set]
    fig_failed = [f for f in failed if f in fig_set]

    with timer.phase("load_raw_provenance"):
        backend.load_raw_provenance()
    with timer.phase("simplify"):
        backend.simplify_prov(iters)
    with timer.phase("hazard"):
        out.hazard = dict(zip(fig_iters, backend.create_hazard_analysis(fault_inj_out, fig_iters)))

    succ = molly.get_success_runs_iters()
    with timer.phase("prototypes"):
        ordered, present = backend.proto_tables_by_run(succ, failed)
        out.proto_ordered = {i: list(ordered.get(i, [])) for i in succ}
        out.present = {f: sorted(present.get(f, ())) for f in failed}

    with timer.phase("pull_prov"):
        pre_dots, post_dots, pre_clean_dots, post_clean_dots = backend.pull_pre_post_prov(fig_iters)
    by = dict(zip(fig_iters, zip(pre_dots, post_dots, pre_clean_dots, post_clean_dots)))
    for i in fig_iters:
        out.pre[i], out.post[i], out.pre_clean[i], out.post_clean[i] = by[i]

    missing_events: list[list[MissingEvent]] = [[] for _ in failed]
    diff_dots: list = []
    failed_dots: list = []
    if good_iter is not None and failed:
        # The good run's post dot is the diff overlay's backdrop.
        success_post_dot = by[good_iter][1] if good_iter in by else None
        with timer.phase("diff_prov"):
            diff_dots, failed_dots, missing_events = backend.create_naive_diff_prov(
                False, failed, success_post_dot, dot_iters=fig_failed
            )
    out.missing = dict(zip(failed, missing_events))
    out.diff = dict(zip(fig_failed, diff_dots))
    out.diff_failed = dict(zip(fig_failed, failed_dots))

    if good_iter is not None and failed:
        with timer.phase("corrections"):
            out.corrections = backend.generate_corrections()
    with timer.phase("extensions"):
        counts = backend.achieved_pre_goal_counts()
        out.achieved = {i: int(counts.get(i, 0)) for i in iters}
        if sum(out.achieved.values()) < len(iters):
            out.extensions = backend.extension_suggestions()

    # Corpus-ranked repair candidates: per-run extension candidates plus the
    # good run's prototype tables (the correction anti-join's left side).
    with timer.phase("synthesis"):
        ext = backend.synth_candidates(iters)
        out.ext_candidates = {i: list(ext.get(i, [])) for i in iters}
        if good_iter is not None:
            g_ordered, _ = backend.proto_tables_by_run([good_iter], [])
            out.good_proto = list(g_ordered.get(good_iter, []))
    return out


def merge_partials(parts: list[SegmentPartial]) -> SegmentPartial:
    """Fold partials left to right.  Per-run dicts are keyed by iteration
    and disjoint across partials; the anchor content (corrections,
    extensions, good_proto) is taken together from the last partial that
    carries it."""
    if len(parts) == 1:
        return parts[0]
    out = SegmentPartial()
    for p in parts:
        out.iters.extend(p.iters)
        out.proto_ordered.update(p.proto_ordered)
        out.present.update(p.present)
        out.missing.update(p.missing)
        out.achieved.update(p.achieved)
        out.ext_candidates.update(p.ext_candidates)
        if p.corrections is not None:
            out.corrections = list(p.corrections)
            out.extensions = list(p.extensions or [])
            out.good_proto = None if p.good_proto is None else list(p.good_proto)
    return out


@dataclass
class Reduced:
    """Global analysis results, ready for recommendation assembly."""

    inter: list[str]  # <code>-wrapped
    union: list[str]
    inter_miss: dict[int, list[str]]  # per failed iteration
    union_miss: dict[int, list[str]]
    missing: dict[int, list[MissingEvent]]  # per failed iteration
    corrections: list[str]
    extensions: list[str]
    all_achieved: bool
    #: corpus-ranked repair document (analysis/synth.py:build_repairs,
    #: repairs.json)
    repairs: dict


def reduce_partials(partials: list[SegmentPartial], molly, good_iter: int | None) -> Reduced:
    """Merge partials into the corpus-global analysis results, in the
    corpus's run order (analysis/protos.py's set algebra)."""
    from nemo_tpu_torch.analysis.protos import intersect_proto, missing_from, union_proto, wrap_code
    from nemo_tpu_torch.analysis.synth import build_repairs

    failed_iters = molly.get_failed_runs_iters()
    success_iters = molly.get_success_runs_iters()

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
