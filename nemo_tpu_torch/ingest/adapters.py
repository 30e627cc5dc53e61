"""Fault-injector ingest adapters: the seam every corpus comes in through.

A copy of the JAX package's ``ingest/adapters.py``.  A
:class:`FaultInjector` enumerates a sweep directory's runs and loads them
into the same :class:`~nemo_tpu_torch.ingest.molly.MollyOutput` every later
layer reads (corpus store, map and reduce, result cache, report), so
nothing below this seam depends on the injector.  Two ship:

  * :class:`MollyInjector`: ``runs.json`` plus per-run provenance files
    (ingest/molly.py); ``native_capable``, the C++ engine parses it.
  * :class:`TraceJsonInjector`: one ``trace.json`` document per sweep, with
    Jepsen-style message histories and neutral provenance graphs (schema
    below).

``--injector`` / ``NEMO_INJECTOR`` names one (``molly``, ``trace-json``) or
``auto`` (default), which sniffs the layout (``runs.json`` -> molly,
``trace.json`` -> trace-json).

The trace-JSON schema (``<dir>/trace.json``)::

    {
      "format": "nemo-trace-v1",
      "name": "optional sweep name",
      "spec": {"eot": 6, "eff": 4, "max_crashes": 1, "nodes": ["C","a","b"]},
      "runs": [
        {
          "id": 0,
          "outcome": "ok" | "violation",      # or an explicit "status"
          "faults": {"omissions": [{"from":"a","to":"b","at":3}],
                     "crashes":   [{"node":"a","at":3}]},
          "history": [{"op": "send", "table": "request", "from": "C",
                       "to": "a", "at": 1, "delivered_at": 2}, ...],
          "holds": {"pre": [4,5,6], "post": [5,6]},  # invariant timesteps
          "tables": {...},          # raw model tables (wins over holds)
          "provenance": {
            "pre":  {"nodes": [{"id":"n0","kind":"fact","table":"pre",
                                "label":"pre(foo)","time":6},
                               {"id":"n1","kind":"rule","table":"acked",
                                "rule_type":"async"}, ...],
                     "deps": [["n0","n1"], ...]},
            "post": {...}
          }
        }, ...
      ]
    }

``outcome: "ok"`` maps to the status ``"success"`` (molly.go:52-57);
``holds`` timesteps become one-column model rows whose last column is the
timestep (molly.go:38-48); node ids are namespaced
``run_<id>_{pre,post}_<origID>`` as Molly's are (molly.go:92-107).  The
layout ships no spacetime DOT files: the hazard figures use
``MollyOutput.spacetime_dot_text``'s synthesis from each run's messages.
"""

from __future__ import annotations

import json
import os

from nemo_tpu_torch import obs

from .datatypes import (
    CrashFailure,
    Edge,
    FailureSpec,
    Goal,
    Message,
    MessageLoss,
    Model,
    ProvData,
    Rule,
    RunData,
)
from .molly import MollyOutput, _namespace_prov, attach_run_metadata, load_molly_output, quarantine_record

_log = obs.log.get_logger("nemo.ingest")

TRACE_FILE = "trace.json"
TRACE_FORMAT = "nemo-trace-v1"


class FaultInjector:
    """One fault-injector front end: how a sweep directory's runs are
    enumerated and parsed.  The classmethods (sniff, count_runs,
    poll_token, materialize_prefix, index_runs) are what the watcher, the
    replay and the store's append consult, so they stay
    injector-agnostic too."""

    #: The ``--injector`` / ``NEMO_INJECTOR`` name.
    name: str = ""
    #: The file that identifies the layout and whose stat signals growth.
    index_file: str = ""
    #: Whether the C++ engine (ingest/native.py) parses this layout.
    native_capable: bool = False

    @classmethod
    def sniff(cls, corpus_dir: str) -> bool:
        return os.path.isfile(os.path.join(corpus_dir, cls.index_file))

    def load(self, corpus_dir: str, quarantine: bool | None = None) -> MollyOutput:
        raise NotImplementedError

    @classmethod
    def count_runs(cls, corpus_dir: str) -> int:
        """The run count from the index alone, no provenance parsed."""
        raise NotImplementedError

    @classmethod
    def poll_token(cls, corpus_dir: str) -> tuple:
        """The watcher's change signature: the directory's mtime and the
        index file's (size, mtime).  Parses nothing."""
        try:
            dir_m = os.stat(corpus_dir).st_mtime_ns
        except OSError:
            dir_m = -1
        try:
            st = os.stat(os.path.join(corpus_dir, cls.index_file))
            idx = (st.st_size, st.st_mtime_ns)
        except OSError:
            idx = (-1, -1)
        return (dir_m, *idx)

    @classmethod
    def materialize_prefix(cls, src_dir: str, dst_dir: str, n_runs: int) -> None:
        """Write the first ``n_runs`` runs of a finished sweep into
        ``dst_dir``, leaving the runs already there untouched: one
        generation of a replay."""
        raise NotImplementedError

    @classmethod
    def index_runs(cls, corpus_dir: str):
        """For a layout whose whole sweep lives in its index file:
        ``(n_entries, parse, head)``, ``parse(pos) -> RunData`` (raises on a
        malformed entry) and ``head(pos) -> (iteration, success)``.  The
        store's index append packs only the entries past those it holds.
        None: the layout grows by per-run files (Molly)."""
        return None


class MollyInjector(FaultInjector):
    """The Molly front end (ingest/molly.py:load_molly_output)."""

    name = "molly"
    index_file = "runs.json"
    native_capable = True

    def load(self, corpus_dir: str, quarantine: bool | None = None) -> MollyOutput:
        return load_molly_output(corpus_dir, quarantine=quarantine)

    @classmethod
    def count_runs(cls, corpus_dir: str) -> int:
        with open(os.path.join(corpus_dir, "runs.json"), encoding="utf-8") as fh:
            return len(json.load(fh))

    @classmethod
    def materialize_prefix(cls, src_dir: str, dst_dir: str, n_runs: int) -> None:
        from nemo_tpu_torch.models.synth import grow_corpus_dir

        grow_corpus_dir(src_dir, dst_dir, n_runs)


def _trace_prov(graph: dict) -> ProvData:
    """A neutral ``{"nodes", "deps"}`` graph -> ProvData with the producer's
    node ids; a dep naming an undeclared node raises (the caller
    quarantines the run)."""
    prov = ProvData()
    known: set[str] = set()
    for n in graph.get("nodes") or []:
        nid = str(n["id"])
        known.add(nid)
        kind = n.get("kind", "fact")
        if kind == "rule":
            prov.rules.append(
                Rule(id=nid, label=n.get("label", n.get("table", "")), table=n.get("table", ""),
                     type=n.get("rule_type", ""))
            )
        elif kind == "fact":
            prov.goals.append(
                Goal(id=nid, label=n.get("label", ""), table=n.get("table", ""), time=str(n.get("time", "")),
                     sender=n.get("sender", ""), receiver=n.get("receiver", ""))
            )
        else:
            raise ValueError(f"trace node {nid!r} has unknown kind {kind!r}")
    for dep in graph.get("deps") or []:
        src, dst = str(dep[0]), str(dep[1])
        if src not in known or dst not in known:
            raise ValueError(f"trace dep {dep!r} names an undeclared node")
        prov.edges.append(Edge(src=src, dst=dst))
    return prov


def _holds_rows(holds) -> list[list[str]]:
    """A ``holds`` entry -> model-table rows whose last column is the
    timestep: an int becomes a one-column row, a list passes through."""
    return [[str(c) for c in h] if isinstance(h, (list, tuple)) else [str(h)] for h in holds or []]


def _trace_status(raw: dict) -> str:
    status = raw.get("status")
    if status is None:
        status = "success" if raw.get("outcome", "ok") == "ok" else "fail"
    return status


def _trace_run(spec: dict, raw: dict) -> RunData:
    """One trace run entry -> RunData, provenance attached and namespaced."""
    iteration = int(raw["id"])
    faults = raw.get("faults") or {}
    fs = FailureSpec(
        eot=int(spec.get("eot", 0)),
        eff=int(spec.get("eff", 0)),
        max_crashes=int(spec.get("max_crashes", 0)),
        nodes=list(spec["nodes"]) if spec.get("nodes") is not None else None,
        crashes=[CrashFailure(node=c["node"], time=int(c["at"])) for c in faults.get("crashes") or []],
        omissions=[MessageLoss(src=o["from"], dst=o["to"], time=int(o["at"])) for o in faults.get("omissions") or []],
    )
    if raw.get("tables") is not None:
        tables = {k: [list(r) for r in v] for k, v in raw["tables"].items()}
    else:
        holds = raw.get("holds") or {}
        tables = {"pre": _holds_rows(holds.get("pre")), "post": _holds_rows(holds.get("post"))}
    messages = [
        Message(content=ev.get("table", ""), send_node=ev.get("from", ""), recv_node=ev.get("to", ""),
                send_time=int(ev.get("at", 0)), recv_time=int(ev.get("delivered_at", 0)))
        for ev in raw.get("history") or []
        if ev.get("op") == "send"
    ]
    run = RunData(iteration=iteration, status=_trace_status(raw), failure_spec=fs, model=Model(tables=tables),
                  messages=messages)
    prov = raw.get("provenance") or {}
    for cond, attr in (("pre", "pre_prov"), ("post", "post_prov")):
        p = _trace_prov(prov.get(cond) or {})
        _namespace_prov(p, iteration, cond)
        setattr(run, attr, p)
    return run


def _read_trace(corpus_dir: str) -> dict:
    with open(os.path.join(corpus_dir, TRACE_FILE), encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"{TRACE_FILE} must be a JSON object")
    return doc


class TraceJsonInjector(FaultInjector):
    """The trace-JSON front end: one ``trace.json`` carries the whole sweep
    (schema in the module docstring).  A run entry that fails to convert is
    quarantined as a Molly run's malformed file is; a document that fails
    to parse raises."""

    name = "trace-json"
    index_file = TRACE_FILE

    def load(self, corpus_dir: str, quarantine: bool | None = None) -> MollyOutput:
        from nemo_tpu_torch.utils.env import quarantine_enabled

        if quarantine is None:
            quarantine = quarantine_enabled()
        doc = _read_trace(corpus_dir)
        out = MollyOutput(run_name=os.path.basename(os.path.normpath(corpus_dir)), output_dir=corpus_dir,
                          ships_spacetime_dots=False)
        spec = doc.get("spec") or {}
        for i, raw in enumerate(doc.get("runs") or []):
            try:
                run = _trace_run(spec, raw)
            except Exception as ex:
                if not quarantine:
                    raise
                rid = raw.get("id") if isinstance(raw, dict) else None
                rec = quarantine_record(i, rid if isinstance(rid, int) else None, TRACE_FILE, ex)
                out.quarantined.append(rec)
                obs.metrics.inc("ingest.quarantined")
                _log.warning("ingest.quarantined", corpus=corpus_dir, position=rec["position"], file=rec["file"],
                             error=rec["error"])
                continue
            out.runs.append(run)
            attach_run_metadata(out, run)
        if not out.runs:
            raise RuntimeError(
                f"trace corpus {corpus_dir} has no loadable runs"
                + (f" ({len(out.quarantined)} quarantined; first: {out.quarantined[0]['error']})"
                   if out.quarantined else "")
            )
        return out

    @classmethod
    def count_runs(cls, corpus_dir: str) -> int:
        return len(_read_trace(corpus_dir).get("runs") or [])

    @classmethod
    def materialize_prefix(cls, src_dir: str, dst_dir: str, n_runs: int) -> None:
        doc = _read_trace(src_dir)
        doc["runs"] = (doc.get("runs") or [])[:n_runs]
        os.makedirs(dst_dir, exist_ok=True)
        with open(os.path.join(dst_dir, TRACE_FILE), "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)

    @classmethod
    def index_runs(cls, corpus_dir: str):
        doc = _read_trace(corpus_dir)
        spec = doc.get("spec") or {}
        raws = doc.get("runs") or []

        def parse(pos: int) -> RunData:
            return _trace_run(spec, raws[pos])

        def head(pos: int) -> tuple[int, bool]:
            return int(raws[pos]["id"]), _trace_status(raws[pos]) == "success"

        return len(raws), parse, head


#: Sniff order: molly first (a directory with both index files is Molly's).
INJECTORS: dict[str, type[FaultInjector]] = {
    MollyInjector.name: MollyInjector,
    TraceJsonInjector.name: TraceJsonInjector,
}


def injector_arg(arg: str | None = None) -> str:
    """The configured injector name: ``arg`` (the CLI's), else
    ``NEMO_INJECTOR``, else ``auto``.  An unknown name raises."""
    val = (arg or os.environ.get("NEMO_INJECTOR") or "auto").strip().lower()
    if val not in ("auto", *INJECTORS):
        raise ValueError(f"unknown injector {val!r} (expected auto, " + ", ".join(INJECTORS) + ")")
    return val


def resolve_injector(corpus_dir: str, arg: str | None = None) -> FaultInjector:
    """The adapter for ``corpus_dir``: ``auto`` sniffs the layout, an
    explicit name is trusted (its load fails on a wrong layout)."""
    name = injector_arg(arg)
    if name == "auto":
        for cand in INJECTORS.values():
            if cand.sniff(corpus_dir):
                name = cand.name
                break
        else:
            raise ValueError(
                f"cannot sniff a fault-injector layout in {corpus_dir}: expected one of "
                + ", ".join(f"{c.index_file} ({c.name})" for c in INJECTORS.values())
                + "; pin one with --injector / NEMO_INJECTOR"
            )
    obs.metrics.inc(f"ingest.injector.{name}")
    return INJECTORS[name]()


def load_output(corpus_dir: str, arg: str | None = None) -> MollyOutput:
    """The object loader through the seam: resolve, then load."""
    return resolve_injector(corpus_dir, arg).load(corpus_dir)


# ---------------------------------------------------------------------------
# Molly -> trace-JSON (the fixtures of the trace-JSON tests and the smoke)
# ---------------------------------------------------------------------------


def _strip_ns(prov: ProvData, iteration: int, cond: str) -> dict:
    """Namespaced ProvData -> a neutral trace graph, the ``run_<iter>_<cond>_``
    prefixes taken off."""
    prefix = f"run_{iteration}_{cond}_"

    def bare(nid: str) -> str:
        return nid[len(prefix):] if nid.startswith(prefix) else nid

    nodes: list[dict] = []
    for g in prov.goals:
        n: dict = {"id": bare(g.id), "kind": "fact", "table": g.table, "label": g.label, "time": g.time}
        if g.sender:
            n["sender"] = g.sender
        if g.receiver:
            n["receiver"] = g.receiver
        nodes.append(n)
    for r in prov.rules:
        n = {"id": bare(r.id), "kind": "rule", "table": r.table, "label": r.label}
        if r.type:
            n["rule_type"] = r.type
        nodes.append(n)
    return {"nodes": nodes, "deps": [[bare(e.src), bare(e.dst)] for e in prov.edges]}


def molly_to_trace(src_dir: str, dst_dir: str) -> str:
    """Convert a Molly sweep directory into the trace-JSON layout at
    ``dst_dir``.  Statuses, failure specs, model tables, message histories
    and provenance graphs survive the round trip exactly; the spacetime DOTs
    are dropped (the trace layout synthesizes them from the messages, byte
    for byte the generators' own for generated corpora)."""
    molly = load_molly_output(src_dir)
    spec0 = molly.runs[0].failure_spec
    runs = []
    for run in molly.runs:
        fs = run.failure_spec
        entry: dict = {
            "id": run.iteration,
            "outcome": "ok" if run.succeeded else "violation",
            "faults": {
                "omissions": [{"from": o.src, "to": o.dst, "at": o.time} for o in (fs.omissions if fs else None) or []],
                "crashes": [{"node": c.node, "at": c.time} for c in (fs.crashes if fs else None) or []],
            },
            "history": [
                {"op": "send", "table": m.content, "from": m.send_node, "to": m.recv_node, "at": m.send_time,
                 "delivered_at": m.recv_time}
                for m in run.messages
            ],
            "tables": run.model.tables if run.model else {},
            "provenance": {
                "pre": _strip_ns(run.pre_prov, run.iteration, "pre"),
                "post": _strip_ns(run.post_prov, run.iteration, "post"),
            },
        }
        if run.status not in ("success", "fail"):
            entry["status"] = run.status
        runs.append(entry)
    doc = {
        "format": TRACE_FORMAT,
        "name": molly.run_name,
        "spec": {
            "eot": spec0.eot if spec0 else 0,
            "eff": spec0.eff if spec0 else 0,
            "max_crashes": spec0.max_crashes if spec0 else 0,
            "nodes": spec0.nodes if spec0 else [],
        },
        "runs": runs,
    }
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, TRACE_FILE), "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
    return dst_dir
