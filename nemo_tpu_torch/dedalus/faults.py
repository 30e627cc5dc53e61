"""Bounded fault injection over a Dedalus program, Molly-output compatible.

Molly explores the crash/omission fault space of a protocol guided by
lineage (the reference consumes its output, README.md:5-8).  This stand-in
enumerates a bounded, deterministic fault space instead:

  run 0            the failure-free execution (the reference hardcodes run 0
                   as the good run, differential-provenance.go:26);
  omission runs    one per message observed in the failure-free trace with
                   send time < EFF (dropping it re-executes the protocol);
  crash runs       one per (node, crash time <= EFF) when max_crashes > 0,
                   for nodes that sent or received a message.

Each run re-executes the program under its fault assignment and is classified
success/fail by the pre ⇒ post invariant at EOT.  Output is a Molly-format
directory: runs.json, run_<i>_{pre,post}_provenance.json,
run_<i>_spacetime.dot (schema per faultinjectors/data-types.go:6-98; file
layout per faultinjectors/molly.go:18,59-60, hazard-analysis.go:25).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

from nemo_tpu_torch.obs import log as _obs_log

from .ast import Program
from .eval import Evaluator, FactInst, RunResult

_log = _obs_log.get_logger("nemo.dedalus")


@dataclass
class FaultSpec:
    eot: int = 6
    eff: int = 4
    max_crashes: int = 0
    nodes: list[str] | None = None
    max_runs: int = 256  # cap on enumerated fault runs (run 0 excluded)


@dataclass
class FaultRun:
    crashes: dict[str, int]
    omissions: set[tuple[str, str, int]]
    result: RunResult


def _condition_prov(result: RunResult, cond: str, eot: int) -> dict[str, Any]:
    """Provenance JSON of one condition: the derivation subgraph reachable
    from the condition table's goals; when the condition never held, fall
    back to the base facts' subgraph so the file is still meaningful."""
    roots = [
        result.derived[t].inst(cond, args)
        for t in range(1, eot + 1)
        for args in result.derived[t].facts(cond)
    ]
    if not roots:
        roots = [
            f
            for f in result.prov.goal_id
            if isinstance(f, FactInst)
            and f.time == 1
            and f.rel not in ("crash", "clock")
        ]
    return result.prov.extract(roots)


def _spacetime_dot(nodes: list[str], eot: int, run: FaultRun) -> str:
    """Space-time diagram via the shared builder (models/synth.py): local
    clock edges stop at a crash; only delivered messages draw arrows."""
    from nemo_tpu_torch.models.synth import build_spacetime_dot

    messages = [
        {
            "from": m.src,
            "to": m.dst,
            "sendTime": m.send_time,
            "receiveTime": m.send_time + 1,
        }
        for m in run.result.messages
        if m.delivered
    ]
    return build_spacetime_dot(nodes, eot, messages, crashes=run.crashes)


def _infer_nodes(program: Program, runs: list[FaultRun]) -> list[str]:
    nodes: list[str] = []

    def add(n: str) -> None:
        if n and n not in nodes:
            nodes.append(n)

    for f in program.facts:
        if f.atom.args:
            add(f.atom.args[0].value)
    for r in runs:
        for m in r.result.messages:
            add(m.src)
            add(m.dst)
    return nodes


def enumerate_runs(program: Program, spec: FaultSpec) -> list[FaultRun]:
    """Run 0 failure-free, then one run per enumerated fault (bounded)."""
    base = Evaluator(program, spec.eot).run()
    runs = [FaultRun(crashes={}, omissions=set(), result=base)]

    # Enumeration order is coverage priority under the max_runs cap: the
    # linear classes (single omissions, single crashes) come before the
    # quadratic ones (omission pairs, crash x omission, crash pairs), so a
    # tight cap still explores every 1-fault execution before any 2-fault
    # combination displaces it.
    faults: list[tuple[dict[str, int], set[tuple[str, str, int]]]] = []
    singles: list[tuple[str, str, int]] = []
    for m in base.messages:
        key = (m.src, m.dst, m.send_time)
        if m.send_time < spec.eff and key not in singles:
            singles.append(key)
            faults.append(({}, {key}))
    crash_cands: list[tuple[str, int]] = []
    if spec.max_crashes > 0:
        nodes = _infer_nodes(program, runs)
        # Crash times start at 1: a node that is down from the very first
        # timestep is a reachable (and often the most violating) fault.
        crash_cands = [(n, tc) for n in nodes for tc in range(1, spec.eff + 1)]
        for n, tc in crash_cands:
            faults.append(({n: tc}, set()))
    # Pairs of omissions: protocols with redundancy (e.g. replication to two
    # backups) only fail when every copy is lost — single-fault enumeration
    # would never surface their violation.
    for i in range(len(singles)):
        for j in range(i + 1, len(singles)):
            faults.append(({}, {singles[i], singles[j]}))
    if spec.max_crashes > 0:
        # Crash x omission combinations: losses that redundancy absorbs only
        # become violations when the surviving holder also crashes.
        for n, tc in crash_cands:
            for key in singles:
                faults.append(({n: tc}, {key}))
        if spec.max_crashes >= 2:
            # Pairs of crashes on distinct nodes; violations that need two
            # replicas down are unreachable through single crashes.
            for i, (n1, t1) in enumerate(crash_cands):
                for n2, t2 in crash_cands[i + 1 :]:
                    if n1 != n2:
                        faults.append(({n1: t1, n2: t2}, set()))
        if spec.max_crashes > 2:
            _log.warning(
                "dedalus.max_crashes_capped",
                max_crashes=spec.max_crashes,
                detail="only single crashes and crash pairs are enumerated",
            )

    if len(faults) > spec.max_runs:
        _log.warning(
            "dedalus.fault_space_truncated",
            max_runs=spec.max_runs,
            enumerated=len(faults),
            detail="raise -max-runs to cover all",
        )
    for crashes, omissions in faults[: spec.max_runs]:
        result = Evaluator(program, spec.eot, crashes, omissions).run()
        runs.append(FaultRun(crashes=crashes, omissions=omissions, result=result))
    return runs


def write_molly_output(
    program: Program, spec: FaultSpec, out_dir: str, run_name: str
) -> str:
    """Execute the fault space and write a Molly-format output directory."""
    runs = enumerate_runs(program, spec)
    nodes = spec.nodes or _infer_nodes(program, runs)
    corpus = os.path.join(out_dir, run_name)
    os.makedirs(corpus, exist_ok=True)

    runs_json = []
    for i, run in enumerate(runs):
        res = run.result
        runs_json.append(
            {
                "iteration": i,
                "status": res.status,
                "failureSpec": {
                    "eot": spec.eot,
                    "eff": spec.eff,
                    "maxCrashes": spec.max_crashes,
                    "nodes": nodes,
                    "crashes": [
                        {"node": n, "time": t} for n, t in sorted(run.crashes.items())
                    ],
                    "omissions": [
                        {"from": s, "to": d, "time": t}
                        for s, d, t in sorted(run.omissions)
                    ],
                },
                "model": {"tables": {"pre": res.pre_rows, "post": res.post_rows}},
                "messages": [
                    {
                        "table": f"{m.rel}({', '.join(m.args)})",
                        "from": m.src,
                        "to": m.dst,
                        "sendTime": m.send_time,
                        "receiveTime": m.send_time + 1,
                    }
                    for m in res.messages
                    if m.delivered
                ],
            }
        )
        for cond in ("pre", "post"):
            path = os.path.join(corpus, f"run_{i}_{cond}_provenance.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(_condition_prov(res, cond, spec.eot), f, indent=1)
        with open(os.path.join(corpus, f"run_{i}_spacetime.dot"), "w", encoding="utf-8") as f:
            f.write(_spacetime_dot(nodes, spec.eot, run))

    with open(os.path.join(corpus, "runs.json"), "w", encoding="utf-8") as f:
        json.dump(runs_json, f, indent=1)
    return corpus
