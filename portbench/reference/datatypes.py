"""Core data model for fault-injector output.

JSON field names match the Molly output schema consumed by the reference
(reference: faultinjectors/data-types.go:6-98), so that the same Molly output
directories — and the same debugging.json report contract — work unchanged.
"""

# Copied from the JAX package's ``ingest/datatypes.py``, which the port was made from:
# the text is the same but for the imports, which name this folder's
# modules (test_portbench_reference.py holds the copy).

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class CrashFailure:
    """A node crash injected by the fault injector.

    Reference: faultinjectors/data-types.go:6-9.
    """

    node: str = ""
    time: int = 0

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CrashFailure":
        return cls(node=d.get("node", ""), time=int(d.get("time", 0)))

    def to_json(self) -> dict[str, Any]:
        return {"node": self.node, "time": self.time}


@dataclass
class MessageLoss:
    """A message omission injected by the fault injector.

    Reference: faultinjectors/data-types.go:12-16.
    """

    src: str = ""
    dst: str = ""
    time: int = 0

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "MessageLoss":
        return cls(src=d.get("from", ""), dst=d.get("to", ""), time=int(d.get("time", 0)))

    def to_json(self) -> dict[str, Any]:
        return {"from": self.src, "to": self.dst, "time": self.time}


@dataclass
class FailureSpec:
    """Bounds and concrete faults of one fault-injection execution.

    Reference: faultinjectors/data-types.go:19-26.
    """

    eot: int = 0
    eff: int = 0
    max_crashes: int = 0
    nodes: list[str] | None = None
    crashes: list[CrashFailure] | None = None
    omissions: list[MessageLoss] | None = None

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "FailureSpec":
        return cls(
            eot=int(d.get("eot", 0)),
            eff=int(d.get("eff", 0)),
            max_crashes=int(d.get("maxCrashes", 0)),
            nodes=list(d["nodes"]) if d.get("nodes") is not None else None,
            crashes=[CrashFailure.from_json(c) for c in d["crashes"]]
            if d.get("crashes") is not None
            else None,
            omissions=[MessageLoss.from_json(o) for o in d["omissions"]]
            if d.get("omissions") is not None
            else None,
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "eot": self.eot,
            "eff": self.eff,
            "maxCrashes": self.max_crashes,
            "nodes": self.nodes,
            "crashes": [c.to_json() for c in self.crashes] if self.crashes is not None else None,
            "omissions": [o.to_json() for o in self.omissions]
            if self.omissions is not None
            else None,
        }


@dataclass
class Model:
    """Final database state of one run: table name -> rows of strings.

    Reference: faultinjectors/data-types.go:29-31.  The last column of each row
    of tables 'pre'/'post' is the timestep at which the condition held
    (faultinjectors/molly.go:38-48).
    """

    tables: dict[str, list[list[str]]] = field(default_factory=dict)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Model":
        return cls(tables={k: [list(r) for r in v] for k, v in d.get("tables", {}).items()})

    def to_json(self) -> dict[str, Any]:
        return {"tables": self.tables}


@dataclass
class Message:
    """One message observed during a run.

    Reference: faultinjectors/data-types.go:34-40.
    """

    content: str = ""
    send_node: str = ""
    recv_node: str = ""
    send_time: int = 0
    recv_time: int = 0

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Message":
        return cls(
            content=d.get("table", ""),
            send_node=d.get("from", ""),
            recv_node=d.get("to", ""),
            send_time=int(d.get("sendTime", 0)),
            recv_time=int(d.get("receiveTime", 0)),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "table": self.content,
            "from": self.send_node,
            "to": self.recv_node,
            "sendTime": self.send_time,
            "receiveTime": self.recv_time,
        }


@dataclass
class Goal:
    """A derived fact (tuple) in a provenance graph.

    Reference: faultinjectors/data-types.go:43-51.
    """

    id: str = ""
    label: str = ""
    table: str = ""
    time: str = ""
    cond_holds: bool = False
    sender: str = ""
    receiver: str = ""

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Goal":
        return cls(
            id=d.get("id", ""),
            label=d.get("label", ""),
            table=d.get("table", ""),
            time=str(d.get("time", "")),
            cond_holds=bool(d.get("conditionHolds", False)),
            sender=d.get("sender", ""),
            receiver=d.get("receiver", ""),
        )

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "id": self.id,
            "label": self.label,
            "table": self.table,
            "time": self.time,
        }
        if self.cond_holds:
            out["conditionHolds"] = self.cond_holds
        if self.sender:
            out["sender"] = self.sender
        if self.receiver:
            out["receiver"] = self.receiver
        return out


@dataclass
class Rule:
    """A rule firing in a provenance graph.

    Reference: faultinjectors/data-types.go:54-59.  type is one of
    "" (deductive), "async" (network), "next" (timer/persistence), plus the
    synthetic "collapsed" type produced by chain contraction
    (graphing/preprocessing.go:279).
    """

    id: str = ""
    label: str = ""
    table: str = ""
    type: str = ""

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Rule":
        return cls(
            id=d.get("id", ""),
            label=d.get("label", ""),
            table=d.get("table", ""),
            type=d.get("type", ""),
        )

    def to_json(self) -> dict[str, Any]:
        return {"id": self.id, "label": self.label, "table": self.table, "type": self.type}


@dataclass
class Edge:
    """A directed provenance edge (goal->rule or rule->goal).

    Reference: faultinjectors/data-types.go:62-65.
    """

    src: str = ""
    dst: str = ""

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Edge":
        return cls(src=d.get("from", ""), dst=d.get("to", ""))

    def to_json(self) -> dict[str, Any]:
        return {"from": self.src, "to": self.dst}


@dataclass
class ProvData:
    """One provenance graph: goals, rules, and directed edges.

    Reference: faultinjectors/data-types.go:68-72.
    """

    goals: list[Goal] = field(default_factory=list)
    rules: list[Rule] = field(default_factory=list)
    edges: list[Edge] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ProvData":
        return cls(
            goals=[Goal.from_json(g) for g in d.get("goals", [])],
            rules=[Rule.from_json(r) for r in d.get("rules", [])],
            edges=[Edge.from_json(e) for e in d.get("edges", [])],
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "goals": [g.to_json() for g in self.goals],
            "rules": [r.to_json() for r in self.rules],
            "edges": [e.to_json() for e in self.edges],
        }


@dataclass
class MissingEvent:
    """A frontier rule of the differential-provenance graph together with the
    goals it would have derived — the events whose absence (transitively)
    explains the invariant violation.

    Reference: faultinjectors/data-types.go:75-78.  The Go struct has no JSON
    tags, so Go marshals it with capitalized field names ("Rule", "Goals");
    we keep that for debugging.json report parity.
    """

    rule: Rule | None = None
    goals: list[Goal] = field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {
            "Rule": self.rule.to_json() if self.rule is not None else None,
            "Goals": [g.to_json() for g in self.goals],
        }


@dataclass
class RunData:
    """Everything known about one fault-injection run.

    Reference: faultinjectors/data-types.go:81-98 ('Run').
    """

    iteration: int = 0
    status: str = ""
    failure_spec: FailureSpec | None = None
    model: Model | None = None
    messages: list[Message] = field(default_factory=list)
    pre_prov: ProvData | None = None
    time_pre_holds: dict[str, bool] = field(default_factory=dict)
    post_prov: ProvData | None = None
    time_post_holds: dict[str, bool] = field(default_factory=dict)
    recommendation: list[str] = field(default_factory=list)
    corrections: list[str] = field(default_factory=list)
    missing_events: list[MissingEvent] = field(default_factory=list)
    inter_proto: list[str] = field(default_factory=list)
    inter_proto_missing: list[str] = field(default_factory=list)
    union_proto: list[str] = field(default_factory=list)
    union_proto_missing: list[str] = field(default_factory=list)

    @property
    def succeeded(self) -> bool:
        # Success is the exact string "success" (faultinjectors/molly.go:53).
        return self.status == "success"

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "RunData":
        return cls(
            iteration=int(d.get("iteration", 0)),
            status=d.get("status", ""),
            failure_spec=FailureSpec.from_json(d["failureSpec"])
            if d.get("failureSpec") is not None
            else None,
            model=Model.from_json(d["model"]) if d.get("model") is not None else None,
            messages=[Message.from_json(m) for m in d.get("messages") or []],
        )

    def to_json(self) -> dict[str, Any]:
        """Serialize in the debugging.json schema the report frontend reads.

        Mirrors Go's encoding/json output for the reference Run struct
        (faultinjectors/data-types.go:81-98): omitempty fields are dropped
        when empty.
        """
        out: dict[str, Any] = {
            "iteration": self.iteration,
            "status": self.status,
            "failureSpec": self.failure_spec.to_json() if self.failure_spec else None,
            "model": self.model.to_json() if self.model else None,
            "messages": [m.to_json() for m in self.messages],
        }
        if self.pre_prov is not None:
            out["preProv"] = self.pre_prov.to_json()
        if self.time_pre_holds:
            out["timePreHolds"] = self.time_pre_holds
        if self.post_prov is not None:
            out["postProv"] = self.post_prov.to_json()
        if self.time_post_holds:
            out["timePostHolds"] = self.time_post_holds
        if self.recommendation:
            out["recommendation"] = self.recommendation
        if self.corrections:
            out["corrections"] = self.corrections
        if self.missing_events:
            out["missingEvents"] = [m.to_json() for m in self.missing_events]
        if self.inter_proto:
            out["interProto"] = self.inter_proto
        if self.inter_proto_missing:
            out["interProtoMissing"] = self.inter_proto_missing
        if self.union_proto:
            out["unionProto"] = self.union_proto
        if self.union_proto_missing:
            out["unionProtoMissing"] = self.union_proto_missing
        return out
