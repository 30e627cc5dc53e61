"""The segment-streamed map: a corpus the store holds in several segments
flows through the backend one segment at a time, behind a prefetch.

Port of the JAX package's ``analysis/stream.py``.  Instead of mapping the
corpus in one sweep, the store's segments go through one at a time:

  * a background thread stages segment k+1: it builds the segment's
    row-subset view (gathered from the per-segment maps), initializes a
    backend clone (``TorchBackend.stream_clone``), plans the fused buckets
    and, on the card, sends the device-lane buckets' arrays up on a side
    stream (``TorchBackend.stage_fused_inputs``);
  * while segment k's dispatches run on the consuming thread.

A residency budget (``STREAM_SEGMENTS``, 2) keeps at most that many
segments resident: peak memory is O(segment + reduce state), not
O(corpus).  Each segment's partial goes to the k-ary tree reduce
(analysis/delta.py:TreeReducer) and, where the result cache takes it, is
published as a checkpoint as soon as its segment is mapped.

Byte parity: a run's artifacts do not depend on which runs share its batch,
and the reduce does not depend on the order of its partials, so a streamed
report is byte-equal to the in-memory one.

Knob: ``NEMO_STREAM`` off (default) | on/1 | auto.  auto streams any
store-served corpus with two or more segments to map on a backend that
clones; on is the same, logged when the run cannot stream; off maps the
segments one after the other on the consuming thread.  The JAX package
defaults to auto.  The port defaults to off because, on an H100 host, the
streamed map of a three-segment corpus measured slower than the serial map
of the same segments, and its memory bound was not measured (PERF.md).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

from nemo_tpu_torch import obs

_log = obs.log.get_logger("nemo.stream")

_SENTINEL = object()

#: The residency budget: segments resident at once, one analysing and one
#: staging (the JAX package's NEMO_STREAM_SEGMENTS default; the port reads
#: no knob for it).
STREAM_SEGMENTS = 2


def stream_env() -> str:
    """``NEMO_STREAM``: off (default) | on | auto (1/0 accepted); raises on
    junk."""
    from nemo_tpu_torch.utils.env import env_choice

    got = env_choice("NEMO_STREAM", "off", ("auto", "on", "1", "off", "0"))
    return {"1": "on", "0": "off"}.get(got, got)


def use_streaming(molly, backend, to_map, legacy: bool = False) -> bool:
    """Whether this run's map streams segment by segment: it needs a backend
    with the per-run hooks (``legacy`` False), a packed corpus (the
    row-subset views are array gathers), a backend that clones itself
    (``stream_clone``) and two or more segments to map (a single segment is
    its own bounded working set).  ``on`` where the run cannot
    stream logs it and maps in memory: the knob changes only the shape of
    the execution, never the bytes."""
    mode = stream_env()
    if mode == "off":
        return False
    capable = (
        not legacy
        and len(to_map) >= 2
        and getattr(molly, "native_corpus", None) is not None
        and backend.stream_clone() is not None
    )
    if mode == "on" and not capable:
        obs.metrics.inc("stream.unstreamable")
        _log.warning(
            "stream.unstreamable",
            detail="NEMO_STREAM=on but this run cannot stream (an object-loader corpus, a backend that does not "
            "clone, or <2 segments to map); mapping in memory",
            segments_to_map=len(to_map),
        )
    return capable


def stream_peak_rss_bytes() -> int:
    """The process's peak RSS in bytes (ru_maxrss is KB on Linux)."""
    import resource
    import sys

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(peak * (1 if sys.platform == "darwin" else 1024))


def note_segment_done(stats: dict) -> None:
    """Record the process's peak RSS after a segment's map in ``stats``
    (``peak_rss_bytes``) and as the ``mem.stream_peak_rss`` gauge: the
    working set must stay bounded as segments flow through."""
    stats["peak_rss_bytes"] = stream_peak_rss_bytes()
    obs.metrics.gauge("mem.stream_peak_rss", stats["peak_rss_bytes"])


@dataclass
class StagedGroup:
    """One staged map group: the row-subset view, its own-run set and the
    segment's backend (init_graph_db'd, fused inputs staged)."""

    group: list
    view: object
    own_set: set
    backend: object
    stage_s: float = 0.0
    staged_bytes: int = 0
    #: the caller's own backend rides here on the serial path, and release()
    #: must not drop it
    shared_backend: bool = field(default=False)
    #: the residency slot (the budget's semaphore); None on the serial and
    #: inline paths
    _slot: object = field(default=None, repr=False)

    def release(self) -> None:
        """Drop the segment's arrays as soon as its map is done (the caller
        close_db'd the backend) and return the residency slot: the budget
        counts a segment as resident until exactly here."""
        self.view = None
        self.own_set = None
        if not self.shared_backend:
            self.backend = None
        slot, self._slot = self._slot, None
        if slot is not None:
            slot.release()


def stream_groups(map_groups, build_view, backend, timer):
    """Generator of :class:`StagedGroup` with the prefetch.

    ``build_view(group) -> (molly_view, own_set)`` runs on the staging side.
    A background thread stages ahead of the consumer under a residency
    budget of ``STREAM_SEGMENTS`` segments: a slot is held from before a
    segment's staging starts until ``StagedGroup.release()``.  The staging
    thread does host work and queues copies on its own stream; it never
    synchronizes the device.  On a one-core host the thread is skipped and
    staging runs inline.  The consumer's waits are the ``stream_wait``
    phase of ``timer`` and ``stream.prefetch_stall_s``; each staging is an
    ``analysis:stream_prefetch`` span on the thread that runs it (the side
    stream's copies are in no host span)."""
    from nemo_tpu_torch.utils import effective_cpu_count

    def stage(group) -> StagedGroup:
        t0 = time.perf_counter()
        with obs.span("analysis:stream_prefetch", segments=len(group), runs=sum(s.n_runs for s in group)):
            view, own_set = build_view(group)
            seg_backend = backend.stream_clone()
            seg_backend.init_graph_db("", view)
            plan = seg_backend.stage_fused_inputs()
        dt = time.perf_counter() - t0
        staged_bytes = int(plan["staged_bytes"])
        obs.metrics.observe("stream.stage_s", dt)
        obs.metrics.inc("stream.segments_staged")
        if staged_bytes:
            obs.metrics.inc("stream.staged_bytes", staged_bytes)
        return StagedGroup(group=group, view=view, own_set=own_set, backend=seg_backend, stage_s=dt,
                           staged_bytes=staged_bytes)

    threaded = effective_cpu_count() >= 2
    obs.metrics.gauge("stream.threaded", int(threaded))
    if not threaded:
        obs.metrics.gauge("stream.segments_inflight", 1)
        for group in map_groups:
            yield stage(group)
        obs.metrics.gauge("stream.segments_inflight", 0)
        return

    q: queue.Queue = queue.Queue()
    stop = threading.Event()
    slots = threading.Semaphore(STREAM_SEGMENTS)

    def producer() -> None:
        try:
            for group in map_groups:
                while not slots.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    slots.release()
                    return
                staged = stage(group)
                staged._slot = slots
                q.put(staged)
            q.put(_SENTINEL)
        except BaseException as ex:  # re-raised on the consuming thread
            q.put(ex)

    th = threading.Thread(target=producer, daemon=True, name="nemo-stream-prefetch")
    th.start()
    try:
        while True:
            t0 = time.perf_counter()
            with timer.phase("stream_wait"):
                item = q.get()
            obs.metrics.inc("stream.prefetch_stall_s", time.perf_counter() - t0)
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            # Staged ahead, and the one just handed over.
            obs.metrics.gauge("stream.segments_inflight", q.qsize() + 1)
            yield item
        obs.metrics.gauge("stream.segments_inflight", 0)
    finally:
        stop.set()
        th.join(timeout=60)
