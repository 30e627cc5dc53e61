"""The benchmark's arithmetic: the card's published peaks, the least time of
a kernel launch counted from its logical problem, rates and percentiles.

The counts belong to the benchmark, never to a kernel's own layout, so a
later kernel that packs bits or skips work reads a higher share, not one
past 100 %."""

from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM, dense: HBM bytes per second, and 32-bit
#: operations per second outside the tensor cores (the nearest listed rate
#: for the word ORs of a boolean closure or a reach wave).
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12

#: Bytes of one edge endpoint in the port's corpus planes (int32 ``edge_src``
#: and ``edge_dst``).
EDGE_ENDPOINT_BYTES = 4


def k1_least(b: int, v: int) -> dict:
    """The least time of one closure launch over a [B, V, V] boolean plane:
    its input and its output at one bit an entry, against the HBM rate; and
    one 32-bit word operation for each output word, against the integer
    rate.  Returns both bounds in seconds and which one binds."""
    bits = b * v * v
    return _bound(bytes_=2 * bits / 8, ops=bits / 32)


def k2_least(b: int, v: int, e: int, shared: bool, masked_edges: int) -> dict:
    """The least time of one reach-wave launch: the [B, V] state in and out
    at one bit a node, the edge mask at one bit an edge, and both endpoints
    of each live (masked) edge at the corpus planes' width; one word
    operation for each output word and one for each live edge."""
    rows = 1 if shared else b
    live = masked_edges
    bytes_ = 2 * b * v / 8 + rows * e / 8 + live * 2 * EDGE_ENDPOINT_BYTES
    return _bound(bytes_=bytes_, ops=b * v / 32 + live)


def _bound(bytes_: float, ops: float) -> dict:
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, ops / PEAK_INT32_OPS_S
    return {"s": max(t_bytes, t_ops), "bytes_s": t_bytes, "ops_s": t_ops,
            "binds": "bytes" if t_bytes >= t_ops else "operations"}


def rate(work: float, window_s: float) -> float:
    """Work completed in a window over its wall."""
    return work / window_s


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank, of at least one value."""
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(-(-q * len(xs) // 100)) - 1))
    return xs[k]


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def phase_ms_per_krun(records: list[dict], phases: tuple[str, ...]) -> float | None:
    """Milliseconds of the named report phases (each report's telemetry
    ``timings``), summed over the window's reports, per 1,000 runs."""
    runs = sum(r["runs"] for r in records if "timings" in r)
    if not runs:
        return None
    s = sum(r["timings"].get(p, 0.0) for r in records if "timings" in r for p in phases)
    return s * 1e3 / (runs / 1e3)


def idle_share(trace: dict | None, window_s: float) -> float | None:
    """Per cent of the window in which no operation ran on the device."""
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / window_s)


def roofline_share(trace: dict | None, kernel: str) -> float | None:
    """Per cent: the summed least time of every launch of ``kernel`` in the
    window over its summed device time; None where it did not launch."""
    if trace is None or not trace["launches"][kernel] or not trace["kernel_s"][kernel]:
        return None
    if kernel == "k1":
        least = sum(k1_least(b, v)["s"] for b, v in trace["launches"]["k1"])
    else:
        least = sum(k2_least(b, v, e, shared, int(mask.sum()))["s"]
                    for b, v, e, shared, mask in trace["launches"]["k2"])
    return 100.0 * least / trace["kernel_s"][kernel]
