"""Synthetic Molly-corpus generator.

Molly (the external Scala fault injector the reference consumes,
reference: README.md:5-8) is not available in this environment, so this module
fabricates Molly-format output directories — runs.json,
run_<i>_{pre,post}_provenance.json, run_<i>_spacetime.dot — with the exact JSON
schema of reference faultinjectors/data-types.go:6-98 and the file layout read
by faultinjectors/molly.go:18,59-60 and graphing/hazard-analysis.go:25.

The generated protocol is an asynchronous primary/backup replication in the
spirit of the reference case study (case-studies/pb_asynchronous.ded): a client
C sends a request to primary P, which acks immediately (antecedent `pre` =
payload acked) and replicates to backups in the background (consequent `post` =
payload logged on all correct replicas).  Fault-injection runs either:

  * succeed with full replication (kind "success");
  * lose a replicate message, violating the invariant (kind "fail");
  * lose the initial request, so the antecedent is never achieved and the
    invariant holds vacuously (kind "vacuous" — still status "success").

Provenance graphs are built with realistic structure: alternating
goal->rule->goal edges, @next persistence chains of varying length (these are
what graph simplification contracts), @async network rules, and clock goals.

A frozen copy of the port's ``models/synth.py``, kept with the benchmark so
that its corpora cannot change with the program; a test holds the two
byte-equal at small sizes.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ProvBuilder:
    """Accumulates one provenance graph in Molly JSON form."""

    goals: list[dict[str, Any]] = field(default_factory=list)
    rules: list[dict[str, Any]] = field(default_factory=list)
    edges: list[dict[str, Any]] = field(default_factory=list)
    _n: int = 0

    def goal(self, table: str, args: list[str], time: int | str = "") -> str:
        gid = f"goal_{self._n}"
        self._n += 1
        label = f"{table}({', '.join(str(a) for a in args)})"
        self.goals.append({"id": gid, "label": label, "table": table, "time": str(time)})
        return gid

    def clock_goal(self, frm: str, to: str, t: int, wildcard: bool = False) -> str:
        """Clock goals carry their time inside the label; the loader extracts it
        with the reference's regexes (faultinjectors/molly.go:76-89)."""
        last = "__WILDCARD__" if wildcard else str(t + 1)
        return self.goal("clock", [frm, to, str(t), last])

    def rule(self, table: str, rtype: str = "", label: str | None = None) -> str:
        rid = f"rule_{self._n}"
        self._n += 1
        self.rules.append(
            {"id": rid, "label": label if label is not None else table, "table": table, "type": rtype}
        )
        return rid

    def edge(self, src: str, dst: str) -> None:
        self.edges.append({"from": src, "to": dst})

    def next_chain(self, table: str, args: list[str], t_hi: int, t_lo: int) -> tuple[str, str]:
        """Build goal@t_hi -> next-rule -> goal@t_hi-1 -> ... -> goal@t_lo.

        Returns (top goal id, bottom goal id).  This is the @next
        timer/persistence chain shape that SimplifyProv contracts
        (reference: graphing/preprocessing.go:70-78).
        """
        top = self.goal(table, args, t_hi)
        cur = top
        for t in range(t_hi - 1, t_lo - 1, -1):
            r = self.rule(table, "next", label=f"{table}_next")
            g = self.goal(table, args, t)
            self.edge(cur, r)
            self.edge(r, g)
            cur = g
        return top, cur

    def build(self) -> dict[str, Any]:
        return {"goals": self.goals, "rules": self.rules, "edges": self.edges}


def _build_pre_prov(
    achieved: bool, eot: int, ack_time: int, client: str, primary: str, payload: str
) -> dict[str, Any]:
    """Antecedent provenance: pre(payload) <- acked(...) <- ack@async <- request@async."""
    b = ProvBuilder()
    if not achieved:
        # Antecedent never held: only the inert begin fact has provenance.
        g_begin = b.goal("begin", [client, payload], 1)
        r_begin = b.rule("begin")
        b.edge(g_begin, r_begin)
        g_clock = b.clock_goal(client, client, 1)
        b.edge(r_begin, g_clock)
        return b.build()

    g_pre = b.goal("pre", [payload], eot)
    r_pre = b.rule("pre")
    b.edge(g_pre, r_pre)

    # acked persistence chain from eot down to the ack time.
    g_acked_top, g_acked_bot = b.next_chain("acked", [client, primary, payload], eot, ack_time)
    b.edge(r_pre, g_acked_top)

    # acked(...) :- ack(...): deductive rule under the bottom of the chain.
    r_acked = b.rule("acked")
    b.edge(g_acked_bot, r_acked)
    g_ack = b.goal("ack", [client, primary, payload], ack_time)
    b.edge(r_acked, g_ack)

    # ack@async :- request: network hop primary -> client.
    r_ack = b.rule("ack", "async")
    b.edge(g_ack, r_ack)
    g_req = b.goal("request", [primary, payload, client], ack_time - 1)
    b.edge(r_ack, g_req)
    b.edge(r_ack, b.clock_goal(primary, client, ack_time - 1))

    # request@async :- begin, conn_out: network hop client -> primary.
    r_req = b.rule("request", "async")
    b.edge(g_req, r_req)
    b.edge(r_req, b.goal("begin", [client, payload], 1))
    b.edge(r_req, b.goal("conn_out", [client, primary], 1))
    b.edge(r_req, b.clock_goal(client, primary, 1))

    return b.build()


def _build_post_prov(
    replicas_logged: list[str],
    eot: int,
    log_time: int,
    achieved: bool,
    primary: str,
    client: str,
    payload: str,
) -> dict[str, Any]:
    """Consequent provenance: post(payload) <- log(Rep, payload) for each replica."""
    b = ProvBuilder()
    if achieved:
        g_post = b.goal("post", [payload], eot)
        r_post = b.rule("post")
        b.edge(g_post, r_post)

    g_req = None
    for rep in replicas_logged:
        g_log_top, g_log_bot = b.next_chain("log", [rep, payload], eot, log_time)
        if achieved:
            b.edge(r_post, g_log_top)

        # log(Rep, payload) :- replicate(Rep, payload, ...).
        r_log = b.rule("log")
        b.edge(g_log_bot, r_log)
        g_repl = b.goal("replicate", [rep, payload, primary, client], log_time - 1)
        b.edge(r_log, g_repl)

        # replicate@async :- request, replica: network hop primary -> replica.
        r_repl = b.rule("replicate", "async")
        b.edge(g_repl, r_repl)
        if g_req is None:
            g_req = b.goal("request", [primary, payload, client], 1)
        b.edge(r_repl, g_req)
        b.edge(r_repl, b.goal("replica", [primary, rep], 1))
        b.edge(r_repl, b.clock_goal(primary, rep, log_time - 1))

    return b.build()


def build_spacetime_dot(
    nodes: list[str],
    eot: int,
    messages: list[dict[str, Any]],
    crashes: dict[str, int] | None = None,
) -> str:
    """Space-time DOT diagram in the shape hazard analysis parses: node names
    end in _<timestep> (reference: graphing/hazard-analysis.go:48-54), with
    each process's timeline wrapped in a `subgraph cluster_<n>` block — the
    structure Molly emits and the reference's gographviz parse + `dot -Tsvg`
    pipeline renders as per-process boxes.  A crashed process's clock edges
    stop at its crash time.  Shared by the synthetic generators and the
    mini-Dedalus fault injector."""
    crashes = crashes or {}
    lines = ["digraph spacetime {"]
    for n in nodes:
        last = crashes.get(n, eot)
        lines.append(f'\tsubgraph "cluster_{n}" {{')
        lines.append(f'\t\tlabel="process {n}";')
        for t in range(1, eot + 1):
            label = f"{n}@{t}" + (" CRASHED" if n in crashes and t >= last else "")
            lines.append(f'\t\t"{n}_{t}" [label="{label}"];')
        for t in range(1, min(last, eot)):
            lines.append(f'\t\t"{n}_{t}" -> "{n}_{t + 1}";')
        lines.append("\t}")
    for m in messages:
        if m["sendTime"] < eot:
            lines.append(f'\t"{m["from"]}_{m["sendTime"]}" -> "{m["to"]}_{m["receiveTime"]}";')
    lines.append("}")
    return "\n".join(lines)


_build_spacetime_dot = build_spacetime_dot  # module-internal callers


@dataclass
class SynthSpec:
    """Configuration for one synthetic corpus."""

    n_runs: int = 4
    seed: int = 0
    eot: int = 6
    eff: int = 4
    name: str = "pb_synth"
    # Fraction of runs (beyond run 0, which always succeeds) per kind.
    fail_fraction: float = 0.4
    vacuous_fraction: float = 0.2
    # A total replication failure: every replicate message lost, so the failed
    # run's consequent provenance is empty and whole rule tables go missing.
    fail_all_fraction: float = 0.15
    # Kind forced on run 0.  Molly puts the failure-free execution first, and
    # the reference relies on that (differential-provenance.go:22); set to
    # "fail" to exercise the rebuild's good-run selection guard.
    first_run_kind: str = "success"
    # Adversarial graph family: "pb" is the standard
    # primary/backup protocol above; the ADVERSARIAL_FAMILIES values warp
    # it into the shapes that stress specific analysis machinery — see
    # each family's note at adversarial_spec().
    family: str = "pb"
    # deep_chain: @next persistence-chain length (eot is raised to fit).
    depth: int = 64
    # wide_fanout: replica count (one post <- log branch per replica).
    fanout: int = 16
    # vocab_growth: fresh goal/rule tables EVERY run adds to the corpus
    # vocabulary.
    vocab_per_run: int = 6


def _gen_run(spec: SynthSpec, rng: random.Random, i: int) -> tuple[dict, dict[str, Any]]:
    """Generate ONE run: (its runs.json entry, its three files).  Consumes
    the rng in a fixed order, so the streaming writer and the in-memory
    generator produce identical corpora for identical (seed, index)
    sequences.  Adversarial families (spec.family) warp the protocol shape
    but keep the exact Molly schema, so every downstream layer analyzes
    them unchanged."""
    client, primary = "C", "a"
    if spec.family == "wide_fanout":
        # One consequent goal fanning out to `fanout` log branches: the
        # scatter/gather frontier kernels' widest single wave.
        replicas = [f"r{k}" for k in range(max(2, spec.fanout))]
    else:
        replicas = ["b", "c"]
    nodes = [client, primary] + replicas
    payload = "foo"

    if i == 0:
        kind = spec.first_run_kind
    else:
        u = rng.random()
        if u < spec.fail_fraction:
            kind = "fail"
        elif u < spec.fail_fraction + spec.vacuous_fraction:
            kind = "vacuous"
        elif u < spec.fail_fraction + spec.vacuous_fraction + spec.fail_all_fraction:
            kind = "fail_all"
        else:
            kind = "success"

    eot = spec.eot
    if spec.family == "deep_chain":
        # The collapseNextChains worst case at corpus scale: every run's
        # pre/post chains span `depth` timesteps.
        eot = max(eot, spec.depth + 3)
    if spec.family == "near_dup":
        # Near-duplicate runs: times pinned so consecutive runs differ in
        # nothing but iteration (and one in four by a single timestep) —
        # the render-dedup / result-cache aliasing stress.  The rng is
        # still consumed (below) so the corpus prefix stays stable if the
        # family is toggled.
        _, _ = rng.randint(3, max(3, eot - 2)), rng.randint(3, max(3, eot - 1))
        ack_time, log_time = 3, 4 + (1 if i % 4 == 3 else 0)
    else:
        ack_time = rng.randint(3, max(3, eot - 2))
        log_time = rng.randint(3, max(3, eot - 1))
    if spec.family == "deep_chain":
        # Pin the chain bottoms low: the chains (eot -> ack/log time) then
        # span ~depth steps regardless of the rng draw above.
        ack_time, log_time = 3, 3

    omissions: list[dict[str, Any]] = []
    crashes: list[dict[str, Any]] = []

    if kind == "fail":
        # Lose the replicate message to one replica.
        lost = rng.choice(replicas)
        logged = [r for r in replicas if r != lost]
        omissions.append({"from": primary, "to": lost, "time": log_time - 1})
        pre_achieved, post_achieved = True, False
        status = "fail"
    elif kind == "fail_all":
        # Lose every replicate message: the ack still happens (async
        # primary/backup acks before replicating) but the consequent
        # provenance is empty and whole rule tables go missing.
        logged = []
        for rep in replicas:
            omissions.append({"from": primary, "to": rep, "time": log_time - 1})
        pre_achieved, post_achieved = True, False
        status = "fail"
    elif kind == "vacuous":
        # Lose the initial request: antecedent never achieved.
        logged = []
        omissions.append({"from": client, "to": primary, "time": 1})
        pre_achieved, post_achieved = False, False
        status = "success"
    else:
        logged = list(replicas)
        pre_achieved, post_achieved = True, True
        status = "success"

    messages = [
        {"table": "request", "from": client, "to": primary, "sendTime": 1, "receiveTime": 2},
    ]
    if pre_achieved:
        messages.append(
            {
                "table": "ack",
                "from": primary,
                "to": client,
                "sendTime": ack_time - 1,
                "receiveTime": ack_time,
            }
        )
        for rep in logged:
            messages.append(
                {
                    "table": "replicate",
                    "from": primary,
                    "to": rep,
                    "sendTime": log_time - 1,
                    "receiveTime": log_time,
                }
            )

    # Model tables: last column of each 'pre'/'post' row is the timestep at
    # which the condition held (faultinjectors/molly.go:38-48).
    tables: dict[str, list[list[str]]] = {"pre": [], "post": []}
    if pre_achieved:
        tables["pre"] = [[payload, str(t)] for t in range(ack_time, eot + 1)]
    if post_achieved:
        tables["post"] = [[payload, str(t)] for t in range(log_time, eot + 1)]

    entry = {
        "iteration": i,
        "status": status,
        "failureSpec": {
            "eot": eot,
            "eff": spec.eff,
            "maxCrashes": 1,
            "nodes": nodes,
            "crashes": crashes,
            "omissions": omissions,
        },
        "model": {"tables": tables},
        "messages": messages,
    }
    pre_prov = _build_pre_prov(pre_achieved, eot, ack_time, client, primary, payload)
    post_prov = _build_post_prov(
        logged, eot, log_time, post_achieved, primary, client, payload
    )
    if spec.family == "vocab_growth":
        _grow_vocab(pre_prov, i, spec.vocab_per_run)
    elif spec.family == "cycles":
        _add_cycle(post_prov, i)
    files = {
        f"run_{i}_pre_provenance.json": pre_prov,
        f"run_{i}_post_provenance.json": post_prov,
        f"run_{i}_spacetime.dot": _build_spacetime_dot(nodes, eot, messages),
    }
    return entry, files


def _grow_vocab(prov: dict[str, Any], i: int, n: int) -> None:
    """Pathological vocabulary growth (adversarial family): hang ``n``
    goals with RUN-UNIQUE table/label/time strings off the graph's first
    goal.  Every run then grows the corpus vocabularies linearly — the
    stress for vocab interning, store vocab generations, and any
    [T]-shaped kernel plane."""
    base = prov["goals"][0]["id"] if prov["goals"] else None
    for j in range(n):
        g = {
            "id": f"aux_g_{i}_{j}",
            "label": f"aux_{i}_{j}(v{j}, t{i})",
            "table": f"aux_{i}_{j}",
            "time": str(10 + i),
        }
        r = {
            "id": f"aux_r_{i}_{j}",
            "label": f"aux_rule_{i}_{j}",
            "table": f"aux_rule_{i}_{j}",
            "type": "",
        }
        prov["goals"].append(g)
        prov["rules"].append(r)
        prov["edges"].append({"from": g["id"], "to": r["id"]})
        if base is not None:
            prov["edges"].append({"from": r["id"], "to": base})


def _add_cycle(prov: dict[str, Any], i: int) -> None:
    """Schema-valid provenance CYCLE (adversarial family): goal -> rule ->
    goal -> rule -> back to the first goal, attached under the graph's
    first rule when one exists.  Exercises every fix-point loop's
    termination (the sparse-device diff's capped max-plus sweep, the host
    relaxation, dense closure) — a depth-bounded wave that assumed a DAG
    would spin or truncate here."""
    anchor = prov["rules"][0]["id"] if prov["rules"] else None
    g0 = {"id": f"cyc_g0_{i}", "label": f"cyc({i}, a)", "table": "cyc", "time": "2"}
    g1 = {"id": f"cyc_g1_{i}", "label": f"cyc({i}, b)", "table": "cyc", "time": "3"}
    r0 = {"id": f"cyc_r0_{i}", "label": "cyc_step", "table": "cyc_step", "type": ""}
    r1 = {"id": f"cyc_r1_{i}", "label": "cyc_step", "table": "cyc_step", "type": ""}
    prov["goals"] += [g0, g1]
    prov["rules"] += [r0, r1]
    prov["edges"] += [
        {"from": g0["id"], "to": r0["id"]},
        {"from": r0["id"], "to": g1["id"]},
        {"from": g1["id"], "to": r1["id"]},
        {"from": r1["id"], "to": g0["id"]},
    ]
    if anchor is not None:
        prov["edges"].append({"from": anchor, "to": g0["id"]})


def generate_corpus(spec: SynthSpec) -> dict[str, Any]:
    """Generate an in-memory corpus: file name -> JSON-serializable content.

    By default run 0 succeeds with full replication — the reference assumes
    the first run is the successful one everywhere it hardcodes run 0
    (e.g. graphing/corrections.go:210-216, differential-provenance.go:26).
    Override with spec.first_run_kind to test that assumption's guard.
    """
    rng = random.Random(spec.seed)
    files: dict[str, Any] = {}
    runs_json = []
    for i in range(spec.n_runs):
        entry, run_files = _gen_run(spec, rng, i)
        runs_json.append(entry)
        files.update(run_files)
    files["runs.json"] = runs_json
    return files


def write_corpus(spec: SynthSpec, out_dir: str) -> str:
    """Write a generated corpus as a Molly output directory; returns its path."""
    corpus_dir = os.path.join(out_dir, spec.name)
    os.makedirs(corpus_dir, exist_ok=True)
    for name, content in generate_corpus(spec).items():
        path = os.path.join(corpus_dir, name)
        with open(path, "w", encoding="utf-8") as f:
            if name.endswith(".json"):
                json.dump(content, f, indent=1)
            else:
                f.write(content)
    return corpus_dir


def grow_corpus_dir(full_dir: str, dst_dir: str, n_runs: int) -> None:
    """Materialize the first ``n_runs`` runs of an already-written corpus
    (synth or case-study layout: run_<i>_{pre,post}_provenance.json,
    run_<i>_spacetime.dot, runs.json) into ``dst_dir``.  Monotonic: call
    again with a larger ``n_runs`` to grow the directory the way a
    still-running Molly sweep appends runs.  Existing run files are left
    untouched (their mtimes, and so the corpus store's fingerprints, stay);
    only runs.json is rewritten.  A copy of the JAX package's
    ``models/synth.py:grow_corpus_dir``."""
    import shutil

    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(full_dir, "runs.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    for i in range(n_runs):
        for name in (f"run_{i}_pre_provenance.json", f"run_{i}_post_provenance.json", f"run_{i}_spacetime.dot"):
            src, dst = os.path.join(full_dir, name), os.path.join(dst_dir, name)
            if os.path.exists(src) and not os.path.exists(dst):
                shutil.copy2(src, dst)
    with open(os.path.join(dst_dir, "runs.json"), "w", encoding="utf-8") as fh:
        json.dump(raw[:n_runs], fh, indent=1)


# ---------------------------------------------------------------------------
# adversarial graph families
# ---------------------------------------------------------------------------

#: The adversarial families (the JAX package's stress tiers); each keeps
#: the Molly schema and stresses one part of the analysis.
ADVERSARIAL_FAMILIES: tuple[str, ...] = (
    "deep_chain",    # ~depth-step @next chains: chain collapse, wave depth
    "wide_fanout",   # one consequent goal, `fanout` log branches: the widest wave
    "near_dup",      # floods of isomorphic runs: render dedup, cache aliasing
    "vocab_growth",  # run-unique tables, labels and times: vocabulary growth
    "cycles",        # schema-valid provenance cycles: every fix-point loop's end
)


def adversarial_spec(family: str, n_runs: int = 8, seed: int = 0, **overrides) -> SynthSpec:
    """The SynthSpec of one adversarial family (or "pb", the baseline),
    deterministic per (family, n_runs, seed)."""
    if family != "pb" and family not in ADVERSARIAL_FAMILIES:
        raise ValueError(f"unknown adversarial family {family!r} (expected pb, {', '.join(ADVERSARIAL_FAMILIES)})")
    kw: dict[str, Any] = dict(n_runs=n_runs, seed=seed, name=f"adv_{family}", family=family)
    if family == "deep_chain":
        kw["depth"] = 64
    elif family == "wide_fanout":
        kw["fanout"] = 24
    kw.update(overrides)
    return SynthSpec(**kw)
