"""The reference report: what a debugging report of one corpus must hold.

Reads the corpus directory itself (the same raw files the program reads),
runs the oracle's verbs in the reference's phase order (at15/nemo
main.go:106-292), reduces them as one partial and assembles, per run, the
``debugging.json`` entry, then ``repairs.json`` and the ``.dot`` text of
every figure the policy selects.  Nothing here imports the program.
"""

from __future__ import annotations

from .molly import load_molly_output, subsample
from .oracle import Oracle
from .protos import intersect_proto, missing_from, union_proto, wrap_code
from .synth import build_repairs

# Top-level recommendation texts (main.go:195,205,212,216).
REC_FAULT = "A fault occurred. Let's try making the protocol correct first."
REC_EXTEND = (
    "Good job, no specification violation. At least one run did not establish "
    "the antecedent, though. Maybe double-check the fault tolerance of the "
    "following rules:"
)
REC_CANT_HELP = (
    "Nemo can't help with this type of bug. Please use the graphs below "
    "regarding differential provenance for guidance to root cause."
)
REC_WELL_DONE = "Well done! No faults, no missing fault tolerance."

FIG_FAMILIES = ("spacetime", "pre_prov", "post_prov", "pre_prov_clean", "post_prov_clean")
DIFF_FAMILIES = ("diff_post_prov-diff", "diff_post_prov-failed")


def select_figure_iters(policy: str, iters: list[int], failed_iters: list[int], good_iter: int | None) -> list[int]:
    """The runs whose figures a policy (all, failed, sample:N, none) selects."""
    if policy in ("", "all"):
        return list(iters)
    sel: set[int] = set()
    include_good = False
    if policy == "failed":
        sel = set(failed_iters)
        include_good = True
    elif policy.startswith("sample:"):
        n = int(policy.split(":", 1)[1])
        failed_set = set(failed_iters)
        others = [i for i in iters if i not in failed_set]
        for pool in (list(failed_iters), others):
            if pool and n > 0:
                stride = max(1, len(pool) // n)
                sel.update(pool[::stride][:n])
        include_good = n > 0
    elif policy != "none":
        raise ValueError(f"unknown figure policy {policy!r}")
    if include_good and good_iter is not None:
        sel.add(good_iter)
    return [i for i in iters if i in sel]


def expected_report(corpus_dir: str, figures: str, stride: int = 1) -> dict:
    """{"debugging": [entry per run], "repairs": doc, "figures": {file name:
    .dot text}} of the report of ``corpus_dir`` under figure policy
    ``figures``.  ``stride`` > 1 is the control (control.py): every
    stride-th run alone is analysed, as a sampling shortcut would."""
    molly = subsample(load_molly_output(corpus_dir), stride)
    iters = molly.get_runs_iters()
    failed = molly.get_failed_runs_iters()
    succ = molly.get_success_runs_iters()
    ora = Oracle(molly)
    good = ora.good
    fig_iters = select_figure_iters(figures, iters, failed, good)
    fig_set = set(fig_iters)
    fig_failed = [f for f in failed if f in fig_set]

    ora.load_raw_provenance()
    ora.simplify_prov(iters)
    hazard = dict(zip(fig_iters, ora.create_hazard_analysis(fig_iters)))
    ordered, present_sets = ora.proto_tables_by_run(succ, failed)
    present = {f: sorted(present_sets.get(f, ())) for f in failed}
    pulled = dict(zip(fig_iters, zip(*ora.pull_pre_post_prov(fig_iters)))) if fig_iters else {}

    missing: dict[int, list] = {}
    diff_dots: dict[int, object] = {}
    if good is not None and failed:
        success_post_dot = pulled[good][1] if good in pulled else None
        d_dots, f_dots, events = ora.create_naive_diff_prov(False, failed, success_post_dot, dot_iters=fig_failed)
        missing = dict(zip(failed, events))
        diff_dots = {f: pair for f, pair in zip(fig_failed, zip(d_dots, f_dots))}
    corrections = ora.generate_corrections() if (good is not None and failed) else []
    achieved = ora.achieved_pre_goal_counts()
    all_achieved = sum(achieved.values()) >= len(iters)
    extensions = [] if all_achieved else ora.extension_suggestions()
    ext_candidates = ora.synth_candidates(iters)
    good_proto = ora.proto_tables_by_run([good], [])[0].get(good, []) if good is not None else None

    per_run = [ordered.get(i, []) for i in succ]
    inter_raw = intersect_proto(per_run, "post")
    union_raw = union_proto(per_run, "post")
    inter, union = wrap_code(inter_raw), wrap_code(union_raw)
    repairs = build_repairs(good_proto, ext_candidates, present, molly, good)

    if corrections:
        rec = [REC_FAULT, *corrections]
    elif failed and good is None:
        rec = [REC_CANT_HELP]
    elif extensions:
        rec = [REC_EXTEND, *extensions]
    elif not all_achieved:
        rec = [REC_CANT_HELP]
    else:
        rec = [REC_WELL_DONE]
    failed_set = set(failed)
    entries = []
    for run in molly.runs:
        e = run.to_json()
        e["recommendation"] = rec
        if inter:
            e["interProto"] = inter
        if union:
            e["unionProto"] = union
        if run.iteration in failed_set:
            f = run.iteration
            if corrections:
                e["corrections"] = corrections
            if missing.get(f):
                e["missingEvents"] = [m.to_json() for m in missing[f]]
            inter_miss = missing_from(inter_raw, set(present[f]))
            union_miss = missing_from(union_raw, set(present[f]))
            if inter_miss:
                e["interProtoMissing"] = inter_miss
            if union_miss:
                e["unionProtoMissing"] = union_miss
        e["goodRunIteration"] = good
        entries.append(e)

    figs: dict[str, str] = {}
    for i in fig_iters:
        for fam, dot in zip(FIG_FAMILIES, (hazard[i], *pulled[i])):
            figs[f"run_{i}_{fam}.dot"] = dot.to_string()
        if i in diff_dots:
            for fam, dot in zip(DIFF_FAMILIES, diff_dots[i]):
                figs[f"run_{i}_{fam}.dot"] = dot.to_string()
    return {"debugging": entries, "repairs": repairs, "figures": figs}
