"""The six case-study protocol families, as synthetic Molly corpora.

The reference ships six Dedalus case studies that Molly model-checks and Nemo
debugs (reference: case-studies/*.ded, 6 files; each header carries the Molly
invocation bounds — EOT 6-8, EFF 3-5, <=1 crash, 2-4 nodes, per SURVEY.md §2).
Molly itself is not available in this environment, so each family here is a
deterministic generator of Molly-format output directories (the schema of
faultinjectors/data-types.go:6-98) with that family's protocol vocabulary,
topology, bounds, and fault mode:

  * pb_asynchronous          (case-studies/pb_asynchronous.ded:62-63)
    async primary/backup: ack before replication; lost replicate violates
    "payload logged on all correct replicas".
  * CA-2083-hinted-handoff   (case-studies/CA-2083-hinted-handoff.ded:23-24)
    Cassandra hinted handoff: coordinator acks a write, stores hints for a
    crashed replica; a lost replay leaves the write un-stored. Crash faults.
  * CA-2434-bootstrap-synchronization
                             (case-studies/CA-2434-bootstrap-synchronization.ded:27-28)
    Cassandra bootstrap: a joining node must receive every key range from its
    peers before serving.
  * MR-2995-failed-after-expiry
                             (case-studies/MR-2995-failed-after-expiry.ded:27-28)
    MapReduce: tasks assigned to workers must complete even when a worker
    fails after its lease expiry. Crash faults, 4 nodes.
  * MR-3858-hadoop           (case-studies/MR-3858-hadoop.ded:31-32)
    Hadoop write pipeline: an acked block must be stored on every datanode.
  * ZK-1270-racing-sent-flag (case-studies/ZK-1270-racing-sent-flag.ded:32-33)
    ZooKeeper: the leader's sent-flag is raised concurrently with the commit
    broadcast (modeled as an extra @next flag chain in the antecedent
    provenance); a lost commit leaves a follower uncommitted.

All families share the protocol *shape* (antecedent = client acked;
consequent = payload persisted on all targets) because that is the shape of
the reference invariants; they differ in vocabulary, topology, timing bounds,
fault mode, and graph structure — which is exactly what exercises
vocabulary-keyed analyses (prototypes, diff-by-label) across corpora.

A frozen copy of the port's ``models/case_studies.py``, kept with the benchmark so
that its corpora cannot change with the program; a test holds the two
byte-equal at small sizes.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any

from .synth import ProvBuilder, _build_spacetime_dot


@dataclass(frozen=True)
class FamilySpec:
    """One case-study family: protocol vocabulary + topology + bounds."""

    name: str
    ref: str  # the reference .ded file this family models
    eot: int
    eff: int
    max_crashes: int
    client: str
    coordinator: str
    targets: tuple[str, ...]
    payload: str
    begin_table: str  # client-local start fact
    request_table: str  # client -> coordinator @async
    ack_table: str  # coordinator -> client @async
    acked_table: str  # @next persistence chain of the ack (antecedent)
    propagate_table: str  # coordinator -> target @async
    persist_table: str  # @next persistence chain on the target (consequent)
    member_table: str  # static membership fact joined by propagation
    conn_table: str = "conn_out"
    crash_faults: bool = False  # failed runs crash a target instead of losing a message
    flag_chain_table: str | None = None  # ZK-1270: racing sent-flag @next chain


CASE_STUDIES: dict[str, FamilySpec] = {
    s.name: s
    for s in [
        FamilySpec(
            name="pb_asynchronous",
            ref="case-studies/pb_asynchronous.ded",
            eot=6, eff=4, max_crashes=1,
            client="C", coordinator="a", targets=("b", "c"), payload="foo",
            begin_table="begin", request_table="request", ack_table="ack",
            acked_table="acked", propagate_table="replicate",
            persist_table="log", member_table="replica",
        ),
        FamilySpec(
            name="CA-2083-hinted-handoff",
            ref="case-studies/CA-2083-hinted-handoff.ded",
            eot=7, eff=4, max_crashes=1,
            client="C", coordinator="co", targets=("r1", "r2"), payload="v1",
            begin_table="write_req", request_table="write", ack_table="write_ack",
            acked_table="client_acked", propagate_table="hint_replay",
            persist_table="stored", member_table="replica_of",
            crash_faults=True,
        ),
        FamilySpec(
            name="CA-2434-bootstrap-synchronization",
            ref="case-studies/CA-2434-bootstrap-synchronization.ded",
            eot=8, eff=5, max_crashes=1,
            client="n", coordinator="seed", targets=("p1", "p2"), payload="range0",
            begin_table="join_req", request_table="join", ack_table="join_ack",
            acked_table="joined", propagate_table="stream_range",
            persist_table="range_synced", member_table="ring_member",
        ),
        FamilySpec(
            name="MR-2995-failed-after-expiry",
            ref="case-studies/MR-2995-failed-after-expiry.ded",
            eot=8, eff=4, max_crashes=1,
            client="J", coordinator="jt", targets=("w1", "w2"), payload="job1",
            begin_table="submit_req", request_table="submit", ack_table="submit_ack",
            acked_table="accepted", propagate_table="assign",
            persist_table="task_done", member_table="worker",
            crash_faults=True,
        ),
        FamilySpec(
            name="MR-3858-hadoop",
            ref="case-studies/MR-3858-hadoop.ded",
            eot=7, eff=3, max_crashes=1,
            client="C", coordinator="nn", targets=("d1", "d2"), payload="blk_1",
            begin_table="put_req", request_table="put", ack_table="put_ack",
            acked_table="client_ok", propagate_table="pipeline_write",
            persist_table="block_stored", member_table="datanode",
        ),
        FamilySpec(
            name="ZK-1270-racing-sent-flag",
            ref="case-studies/ZK-1270-racing-sent-flag.ded",
            eot=8, eff=5, max_crashes=1,
            client="C", coordinator="L", targets=("f1", "f2"), payload="txn7",
            begin_table="txn_req", request_table="propose", ack_table="prop_ack",
            acked_table="proposed", propagate_table="commit_msg",
            persist_table="committed", member_table="follower",
            flag_chain_table="sent_flag",
        ),
    ]
}


def _pre_prov(spec: FamilySpec, achieved: bool, ack_time: int) -> dict[str, Any]:
    """Antecedent provenance:
    pre <- <acked chain> <- <ack rule @async> <- <request rule @async>."""
    b = ProvBuilder()
    client, coord, payload = spec.client, spec.coordinator, spec.payload
    if not achieved:
        g_begin = b.goal(spec.begin_table, [client, payload], 1)
        r_begin = b.rule(spec.begin_table)
        b.edge(g_begin, r_begin)
        b.edge(r_begin, b.clock_goal(client, client, 1))
        return b.build()

    g_pre = b.goal("pre", [payload], spec.eot)
    r_pre = b.rule("pre")
    b.edge(g_pre, r_pre)

    g_top, g_bot = b.next_chain(spec.acked_table, [client, coord, payload], spec.eot, ack_time)
    b.edge(r_pre, g_top)

    r_acked = b.rule(spec.acked_table)
    b.edge(g_bot, r_acked)
    g_ack = b.goal(spec.ack_table, [client, coord, payload], ack_time)
    b.edge(r_acked, g_ack)

    if spec.flag_chain_table:
        # ZK-1270: the racing sent-flag — a parallel @next chain the acked
        # deduction also depends on, raised concurrently with the broadcast.
        f_top, f_bot = b.next_chain(spec.flag_chain_table, [coord, payload], spec.eot, ack_time)
        b.edge(r_pre, f_top)
        r_flag = b.rule(spec.flag_chain_table)
        b.edge(f_bot, r_flag)
        b.edge(r_flag, b.clock_goal(coord, coord, ack_time - 1))

    r_ack = b.rule(spec.ack_table, "async")
    b.edge(g_ack, r_ack)
    g_req = b.goal(spec.request_table, [coord, payload, client], ack_time - 1)
    b.edge(r_ack, g_req)
    b.edge(r_ack, b.clock_goal(coord, client, ack_time - 1))

    r_req = b.rule(spec.request_table, "async")
    b.edge(g_req, r_req)
    b.edge(r_req, b.goal(spec.begin_table, [client, payload], 1))
    b.edge(r_req, b.goal(spec.conn_table, [client, coord], 1))
    b.edge(r_req, b.clock_goal(client, coord, 1))
    return b.build()


def _post_prov(
    spec: FamilySpec, persisted: list[str], persist_time: int, achieved: bool
) -> dict[str, Any]:
    """Consequent provenance:
    post <- <persist chain per target> <- <propagate rule @async>."""
    b = ProvBuilder()
    coord, client, payload = spec.coordinator, spec.client, spec.payload
    r_post = None
    if achieved:
        g_post = b.goal("post", [payload], spec.eot)
        r_post = b.rule("post")
        b.edge(g_post, r_post)

    g_req = None
    for tgt in persisted:
        g_top, g_bot = b.next_chain(spec.persist_table, [tgt, payload], spec.eot, persist_time)
        if r_post is not None:
            b.edge(r_post, g_top)

        r_persist = b.rule(spec.persist_table)
        b.edge(g_bot, r_persist)
        g_prop = b.goal(spec.propagate_table, [tgt, payload, coord, client], persist_time - 1)
        b.edge(r_persist, g_prop)

        r_prop = b.rule(spec.propagate_table, "async")
        b.edge(g_prop, r_prop)
        if g_req is None:
            g_req = b.goal(spec.request_table, [coord, payload, client], 1)
        b.edge(r_prop, g_req)
        b.edge(r_prop, b.goal(spec.member_table, [coord, tgt], 1))
        b.edge(r_prop, b.clock_goal(coord, tgt, persist_time - 1))
    return b.build()


def generate_case_study(spec: FamilySpec, n_runs: int, seed: int = 0) -> dict[str, Any]:
    """In-memory Molly corpus for one family: file name -> content.

    Run 0 always succeeds with full propagation (the reference hardcodes run 0
    as the good run, e.g. graphing/corrections.go:210-216).  Failed runs
    either lose one propagation (message omission, or a target crash when the
    family's fault mode is crashes), lose all propagations, or lose the
    initial request (vacuous success: antecedent never achieved).
    """
    # str seeds hash via sha512 in random.seed — stable across processes
    # (tuple.__hash__ would be salted by PYTHONHASHSEED).
    rng = random.Random(f"{seed}:{spec.name}")
    nodes = [spec.client, spec.coordinator, *spec.targets]
    files: dict[str, Any] = {}
    runs_json = []

    for i in range(n_runs):
        if i == 0:
            kind = "success"
        else:
            u = rng.random()
            kind = (
                "fail" if u < 0.4 else
                "vacuous" if u < 0.6 else
                "fail_all" if u < 0.75 else
                "success"
            )

        ack_time = rng.randint(3, max(3, spec.eot - 2))
        # Faults fire at persist_time - 1, and Molly only injects faults at
        # times <= EFF (the failure window in the .ded headers) — keep the
        # generated failureSpec self-consistent by bounding the draw.
        persist_time = rng.randint(3, max(3, min(spec.eot - 1, spec.eff + 1)))
        omissions: list[dict[str, Any]] = []
        crashes: list[dict[str, Any]] = []

        if kind == "fail":
            lost = rng.choice(list(spec.targets))
            persisted = [t for t in spec.targets if t != lost]
            if spec.crash_faults:
                crashes.append({"node": lost, "time": persist_time - 1})
            else:
                omissions.append(
                    {"from": spec.coordinator, "to": lost, "time": persist_time - 1}
                )
            pre_achieved, post_achieved, status = True, False, "fail"
        elif kind == "fail_all":
            # Crash-fault families crash one target (respecting maxCrashes=1)
            # and lose the remaining propagations; omission families lose all.
            persisted = []
            for k, tgt in enumerate(spec.targets):
                if spec.crash_faults and k == 0:
                    crashes.append({"node": tgt, "time": persist_time - 1})
                else:
                    omissions.append(
                        {"from": spec.coordinator, "to": tgt, "time": persist_time - 1}
                    )
            pre_achieved, post_achieved, status = True, False, "fail"
        elif kind == "vacuous":
            persisted = []
            omissions.append({"from": spec.client, "to": spec.coordinator, "time": 1})
            pre_achieved, post_achieved, status = False, False, "success"
        else:
            persisted = list(spec.targets)
            pre_achieved, post_achieved, status = True, True, "success"

        messages = [
            {
                "table": spec.request_table,
                "from": spec.client,
                "to": spec.coordinator,
                "sendTime": 1,
                "receiveTime": 2,
            }
        ]
        if pre_achieved:
            messages.append(
                {
                    "table": spec.ack_table,
                    "from": spec.coordinator,
                    "to": spec.client,
                    "sendTime": ack_time - 1,
                    "receiveTime": ack_time,
                }
            )
            for tgt in persisted:
                messages.append(
                    {
                        "table": spec.propagate_table,
                        "from": spec.coordinator,
                        "to": tgt,
                        "sendTime": persist_time - 1,
                        "receiveTime": persist_time,
                    }
                )

        tables: dict[str, list[list[str]]] = {"pre": [], "post": []}
        if pre_achieved:
            tables["pre"] = [[spec.payload, str(t)] for t in range(ack_time, spec.eot + 1)]
        if post_achieved:
            tables["post"] = [[spec.payload, str(t)] for t in range(persist_time, spec.eot + 1)]

        runs_json.append(
            {
                "iteration": i,
                "status": status,
                "failureSpec": {
                    "eot": spec.eot,
                    "eff": spec.eff,
                    "maxCrashes": spec.max_crashes,
                    "nodes": nodes,
                    "crashes": crashes,
                    "omissions": omissions,
                },
                "model": {"tables": tables},
                "messages": messages,
            }
        )
        files[f"run_{i}_pre_provenance.json"] = _pre_prov(spec, pre_achieved, ack_time)
        files[f"run_{i}_post_provenance.json"] = _post_prov(
            spec, persisted, persist_time, post_achieved
        )
        files[f"run_{i}_spacetime.dot"] = _build_spacetime_dot(nodes, spec.eot, messages)

    files["runs.json"] = runs_json
    return files


def write_case_study(name: str, n_runs: int, seed: int, out_dir: str) -> str:
    """Write one family's corpus as a Molly output directory; returns its path."""
    import json
    import os

    spec = CASE_STUDIES[name]
    corpus_dir = os.path.join(out_dir, spec.name)
    os.makedirs(corpus_dir, exist_ok=True)
    for fname, content in generate_case_study(spec, n_runs, seed).items():
        path = os.path.join(corpus_dir, fname)
        with open(path, "w", encoding="utf-8") as f:
            if fname.endswith(".json"):
                json.dump(content, f, indent=1)
            else:
                f.write(content)
    return corpus_dir


def write_all_case_studies(n_runs: int, seed: int, out_dir: str) -> dict[str, str]:
    """Write every family; returns name -> corpus directory."""
    return {name: write_case_study(name, n_runs, seed, out_dir) for name in CASE_STUDIES}
