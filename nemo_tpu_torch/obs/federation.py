"""Fleet metrics federation: N replica snapshots -> one exposition page.

A copy of the JAX package's ``obs/federation.py``.  The router polls every
replica's Health RPC and keeps the metrics snapshot each answer carries
(serve/router.py); this module renders them as the one Prometheus page the
router serves on its ``/metrics``:

* **per-replica series**: every replica sample again, with a
  ``{replica="<name>"}`` label (the replica's ``host:port`` or loopback
  name; the registry itself has no labels);
* **fleet rollups** under ``nemo_fleet_``: counters summed, histogram
  buckets merged over the union of the replicas' le ladders (each
  replica's cumulative count carried forward, so the merged series never
  decreases), gauges as ``{agg="max"}`` and ``{agg="min"}`` (a summed gauge
  is rarely true; the envelope is what alerting wants);
* **liveness**: ``nemo_fleet_backend_up{replica=...} 0|1`` and the
  ``nemo_fleet_backends_up`` / ``nemo_fleet_backends_total`` counts;
* the router's **own registry** (its RPC counters, the autoscale gauge),
  unlabeled, as a replica would serve it.

Every sample goes through ``promexp.render_prometheus`` and
``promexp.parse_prometheus_text``, the surface the tests hold conformant.
"""

from __future__ import annotations

from .promexp import parse_prometheus_text, render_prometheus

__all__ = ["federate", "fleet_name"]

_PREFIX = "nemo_"
_FLEET = "nemo_fleet_"


def fleet_name(name: str) -> str:
    """A replica's family name -> its fleet rollup's."""
    if name.startswith(_PREFIX):
        return _FLEET + name[len(_PREFIX):]
    return _FLEET + name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _le_key(le: str) -> float:
    return float(le.replace("+Inf", "inf"))


class _Page:
    """Samples grouped by family, rendered as one page.  Of two samples of
    one (name, labels), the first stays (as render_prometheus does)."""

    def __init__(self) -> None:
        self._fams: dict[str, dict] = {}
        self._order: list[str] = []
        self._seen: set[tuple] = set()

    def add(self, family: str, typ: str | None, name: str, labels: dict, value) -> None:
        key = (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        if key in self._seen:
            return
        self._seen.add(key)
        fam = self._fams.get(family)
        if fam is None:
            fam = self._fams[family] = {"type": typ, "samples": []}
            self._order.append(family)
        elif fam["type"] is None:
            fam["type"] = typ
        fam["samples"].append((name, labels, value))

    def render(self) -> str:
        lines: list[str] = []
        for family in sorted(self._order):
            fam = self._fams[family]
            if fam["type"]:
                lines.append(f"# HELP {family} nemo fleet federation")
                lines.append(f"# TYPE {family} {fam['type']}")
            for name, labels, value in fam["samples"]:
                if isinstance(value, float) and value != value:  # NaN
                    continue
                v = int(value) if float(value) == int(value) and abs(value) < 1e15 else repr(float(value))
                lines.append(f"{name}{_fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"


def federate(replica_snaps: dict[str, dict], up: dict[str, bool] | None = None,
             own_snapshot: dict | None = None) -> str:
    """The federated fleet page.

    ``replica_snaps``: replica name -> its registry ``snapshot()`` (as the
    Health RPC's ``nemo-metrics-bin`` carries it; {} for a replica that has
    not answered).  ``up``: replica name -> liveness (default: has a
    snapshot).  ``own_snapshot``: the caller's registry (default the
    process's, what the router wants)."""
    page = _Page()
    up = dict(up) if up is not None else {r: bool(s) for r, s in replica_snaps.items()}

    # The caller's own series, unlabeled: a fleet of one scrapes as a bare
    # sidecar does.
    own = parse_prometheus_text(render_prometheus(own_snapshot))
    for family, fam in own.items():
        for name, labels, value in fam["samples"]:
            page.add(family, fam["type"], name, labels, value)

    counters: dict[str, float] = {}
    gauges: dict[str, list] = {}
    hists: dict[str, list] = {}

    for target in sorted(replica_snaps):
        snap = replica_snaps[target] or {}
        if not snap:
            continue
        fams = parse_prometheus_text(render_prometheus(snap))
        for family, fam in fams.items():
            typ = fam["type"]
            hist_acc = None
            if typ == "histogram":
                hist_acc = {"les": {}, "sum": 0.0, "count": 0.0}
                hists.setdefault(family, []).append(hist_acc)
            for name, labels, value in fam["samples"]:
                page.add(family, typ, name, {**labels, "replica": target}, value)
                if typ == "counter":
                    counters[family] = counters.get(family, 0.0) + value
                elif typ == "gauge":
                    gauges.setdefault(family, []).append(value)
                elif hist_acc is not None:
                    if name.endswith("_bucket"):
                        hist_acc["les"][labels.get("le", "+Inf")] = value
                    elif name.endswith("_sum"):
                        hist_acc["sum"] = value
                    elif name.endswith("_count"):
                        hist_acc["count"] = value

    for family in sorted(counters):
        fname = fleet_name(family)
        page.add(fname, "counter", fname, {}, counters[family])
    for family in sorted(gauges):
        fname = fleet_name(family)
        vals = gauges[family]
        page.add(fname, "gauge", fname, {"agg": "max"}, max(vals))
        page.add(fname, "gauge", fname, {"agg": "min"}, min(vals))
    for family in sorted(hists):
        fname = fleet_name(family)
        accs = hists[family]
        union = sorted({le for a in accs for le in a["les"]}, key=_le_key)
        for le in union:
            if le == "+Inf":
                continue
            total = 0.0
            for a in accs:
                cum = 0.0
                for known in sorted(a["les"], key=_le_key):
                    if _le_key(known) <= _le_key(le):
                        cum = a["les"][known]
                    else:
                        break
                total += cum
            page.add(fname, "histogram", fname + "_bucket", {"le": le}, total)
        total_count = sum(a["count"] for a in accs)
        page.add(fname, "histogram", fname + "_bucket", {"le": "+Inf"}, total_count)
        page.add(fname, "histogram", fname + "_sum", {}, sum(a["sum"] for a in accs))
        page.add(fname, "histogram", fname + "_count", {}, total_count)

    n_up = 0
    for target in sorted(up):
        alive = 1 if up[target] else 0
        n_up += alive
        page.add("nemo_fleet_backend_up", "gauge", "nemo_fleet_backend_up", {"replica": target}, alive)
    page.add("nemo_fleet_backends_up", "gauge", "nemo_fleet_backends_up", {}, n_up)
    page.add("nemo_fleet_backends_total", "gauge", "nemo_fleet_backends_total", {}, len(up))
    return page.render()
