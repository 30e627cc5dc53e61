"""The live watch loop: detect, debounce, re-analyse, publish, push.

A copy of the JAX package's ``watch/watcher.py``.  One :class:`Watcher`
owns one sweep directory.  Each cycle:

  1. **Detect**: the injector's ``poll_token`` (ingest/adapters.py: the
     directory's mtime and the index file's stat; parses nothing) is polled
     every ``poll_s``, with the stats of the files the last cycle
     quarantined, so a repair re-arms the loop even when the index is
     untouched.
  2. **Debounce**: the token must hold still for ``debounce_s`` before the
     analysis starts; what is still half-written then is quarantined, and
     re-ingested when repaired (the store's GROWN append).
  3. **Analyse**: ``run_debug`` into a new generation directory, on a
     backend ``make_backend()`` builds on this thread for this cycle.  With
     the corpus store and the result cache on, the store appends only the
     new runs as a segment and the cached partials serve the others, so an
     update maps O(new runs).
  4. **Publish**: the live report name under ``results_root`` is a symlink,
     replaced atomically (``os.replace`` of a fresh link) by one to the new
     generation; the generation before stays for readers mid-walk and goes
     one flip later.
  5. **Push**: every subscriber queue gets one ``report_update`` event: the
     update's ordinal, new and total runs, the evidence that the update was
     incremental (``delta.runs_mapped``, ``delta.segments_cached`` and the
     ``kernel.dispatches.*`` sum, each the obs counters' delta around the
     cycle's ``watch:cycle`` span) and the changed report files as
     ``{relpath: sha256[:12]}``; the ``watch.*`` metrics record it too.

A cycle that fails is logged with its traceback, counted
(``watch.cycle_failed``), handed to the flight recorder (a no-op unless
one is armed), pushed as ``watch_error`` and retried at the next poll, as
the JAX package's is; the next cycle
builds its backend again on the same device (a kernel that fails to build
or launch raises inside the cycle, and nothing falls back to another
device).
"""

from __future__ import annotations

import hashlib
import os
import queue as _queue
import shutil
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field

from nemo_tpu_torch import obs

_log = obs.log.get_logger("nemo.watch")

#: Cap on the changed files an event lists: it is a notification, not the
#: report.
_MAX_CHANGED = 256


@dataclass
class WatchConfig:
    """Watch-loop settings; ``poll_s`` and ``debounce_s`` default to
    ``NEMO_WATCH_POLL_S`` (0.5) and ``NEMO_WATCH_DEBOUNCE_S`` (0.25), a junk
    value warning and taking the default."""

    poll_s: float | None = None
    debounce_s: float | None = None
    #: Stop after this many published updates; 0 runs until stopped.
    max_updates: int = 0
    figures: str = "all"
    #: The injector's name (``--injector``); None sniffs.
    injector: str | None = None
    #: How long to wait for the first sniffable corpus before raising.
    initial_wait_s: float = 300.0
    #: More keyword arguments of run_debug (corpus_cache, result_cache, ...).
    run_debug_kwargs: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        from nemo_tpu_torch.utils.env import env_float

        if self.poll_s is None:
            self.poll_s = env_float("NEMO_WATCH_POLL_S", 0.5, minimum=0.01)
        if self.debounce_s is None:
            self.debounce_s = env_float("NEMO_WATCH_DEBOUNCE_S", 0.25)


class Watcher:
    """Tail one sweep directory (see the module docstring).
    ``make_backend()`` builds one backend per cycle, on the watcher's
    thread; every subscriber queue receives every event."""

    def __init__(self, corpus_dir: str, results_root: str, make_backend, config: WatchConfig | None = None) -> None:
        self.corpus_dir = os.path.abspath(corpus_dir)
        self.results_root = os.path.abspath(results_root)
        self.make_backend = make_backend
        self.config = config or WatchConfig()
        self.updates = 0
        self.report_dir: str | None = None  # the live (symlink) path
        self._stop = threading.Event()
        self._subs: list[_queue.SimpleQueue] = []
        self._subs_lock = threading.Lock()
        self._digests: dict[str, str] = {}
        self._runs_total = 0
        self._gen_dirs: list[str] = []  # generation roots, oldest first
        self._quarantine_files: list[str] = []

    def subscribe(self) -> _queue.SimpleQueue:
        q: _queue.SimpleQueue = _queue.SimpleQueue()
        with self._subs_lock:
            self._subs.append(q)
        return q

    def _push(self, event: dict) -> None:
        with self._subs_lock:
            subs = list(self._subs)
        for q in subs:
            q.put(event)

    def stop(self) -> None:
        self._stop.set()

    def _injector(self):
        from nemo_tpu_torch.ingest import adapters

        return adapters.resolve_injector(self.corpus_dir, self.config.injector)

    def _qstats(self) -> tuple:
        """The stats of every file the last cycle quarantined."""
        out = []
        for path in self._quarantine_files:
            try:
                st = os.stat(path)
                out.append((path, st.st_size, st.st_mtime_ns))
            except OSError:
                out.append((path, -1, -1))
        return tuple(out)

    def _token(self, injector) -> tuple:
        """The change signature: the injector's poll token, then (always
        last, see run) the quarantined files' stats."""
        return (*injector.poll_token(self.corpus_dir), self._qstats())

    def run(self) -> int:
        """Watch until stopped or ``max_updates`` are published; returns the
        updates.  Raises on an unknown injector name at once, and when no
        layout sniffs within ``initial_wait_s``; a cycle's failure is
        logged, pushed as a ``watch_error`` event and retried at the next
        poll."""
        from nemo_tpu_torch.ingest import adapters

        cfg = self.config
        adapters.injector_arg(cfg.injector)
        deadline = time.monotonic() + cfg.initial_wait_s
        injector = None
        while injector is None and not self._stop.is_set():
            try:
                injector = self._injector()
            except ValueError:
                # The sweep may not have written its index yet.
                if time.monotonic() > deadline:
                    raise
                self._stop.wait(cfg.poll_s)
        if injector is None:
            return self.updates
        _log.info("watch.start", corpus=self.corpus_dir, injector=injector.name, poll_s=cfg.poll_s,
                  debounce_s=cfg.debounce_s)
        last = None  # the token of the last analysed state
        while not self._stop.is_set():
            token = self._token(injector)
            if token == last:
                if cfg.max_updates and self.updates >= cfg.max_updates:
                    break
                self._stop.wait(cfg.poll_s)
                continue
            while not self._stop.is_set():
                self._stop.wait(cfg.debounce_s)
                settled = self._token(injector)
                if settled == token:
                    break
                token = settled
            if self._stop.is_set():
                break
            try:
                self._cycle(injector)
            except Exception as ex:
                detail = f"{type(ex).__name__}: {ex}"
                obs.metrics.inc("watch.cycle_failed")
                _log.warning("watch.cycle_failed", corpus=self.corpus_dir, error=detail,
                             traceback=traceback.format_exc())
                obs.flight.trigger("watch_cycle_failed", corpus=self.corpus_dir, error=detail)
                self._push({"event": "watch_error", "dir": self.corpus_dir, "detail": detail})
                # The token is not recorded: the next poll retries this state.
                self._stop.wait(cfg.poll_s)
                continue
            # The pre-cycle poll token (an index write during the analysis
            # triggers another cycle) with the post-cycle quarantine stats
            # (the cycle just changed which files are watched; the old list
            # would read as a change and spin a duplicate cycle).
            last = (*token[:-1], self._qstats())
            if cfg.max_updates and self.updates >= cfg.max_updates:
                break
        _log.info("watch.stop", corpus=self.corpus_dir, updates=self.updates)
        return self.updates

    def _cycle(self, injector) -> None:
        from nemo_tpu_torch.analysis.delta import kernel_dispatch_count
        from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug

        cfg = self.config
        name = os.path.basename(os.path.normpath(self.corpus_dir))
        gen = os.path.join(self.results_root, ".watch", f"{name}-gen-{self.updates:06d}-{uuid.uuid4().hex[:6]}")
        t0 = time.perf_counter()
        before = obs.metrics.snapshot()["counters"]
        with obs.span("watch:cycle", dir=name, update=self.updates, injector=injector.name):
            result = run_debug(self.corpus_dir, gen, self.make_backend(), figures=cfg.figures, report_name=name,
                               injector=cfg.injector, **cfg.run_debug_kwargs)
        after = obs.metrics.snapshot()["counters"]
        latency = time.perf_counter() - t0

        molly = result.molly
        runs_total = len(molly.runs)
        quarantined = list(molly.quarantined or ())
        self._quarantine_files = [
            os.path.join(self.corpus_dir, rec["file"])
            for rec in quarantined
            if rec.get("file") and rec["file"] != injector.index_file
        ]
        new_runs = max(0, runs_total - self._runs_total)
        self._runs_total = runs_total
        # The evidence that the update was incremental: the counters'
        # deltas around the cycle.
        def delta_of(key: str) -> int:
            return int(after.get(key, 0)) - int(before.get(key, 0))

        runs_mapped = delta_of("delta.runs_mapped")
        segments_cached = delta_of("delta.segments_cached")
        dispatches = kernel_dispatch_count(after) - kernel_dispatch_count(before)

        tree = report_tree_bytes(result.report_dir)
        digests = {p: hashlib.sha256(b).hexdigest()[:12] for p, b in tree.items()}
        changed = sorted(p for p, h in digests.items() if self._digests.get(p) != h)
        removed = sorted(p for p in self._digests if p not in digests)
        self._digests = digests

        live = self._publish(result.report_dir, gen, name)
        self.updates += 1
        obs.metrics.inc("watch.updates")
        obs.metrics.inc("watch.new_runs", new_runs)
        obs.metrics.observe("watch.update_latency_s", latency)
        obs.metrics.gauge("watch.runs_total", runs_total)
        event = {
            "event": "report_update",
            "dir": self.corpus_dir,
            "update": self.updates,
            "runs_total": runs_total,
            "new_runs": new_runs,
            "quarantined": len(quarantined),
            "runs_mapped": runs_mapped,
            "segments_cached": segments_cached,
            "kernel_dispatches": dispatches,
            "update_latency_s": round(latency, 4),
            "report_dir": live,
            "changed_total": len(changed),
            "removed": removed[:_MAX_CHANGED],
            "sections": {p: digests[p] for p in changed[:_MAX_CHANGED]},
        }
        _log.info("watch.update", corpus=self.corpus_dir, update=self.updates, runs_total=runs_total,
                  new_runs=new_runs, runs_mapped=runs_mapped, dispatches=dispatches, changed=len(changed),
                  seconds=round(latency, 3))
        self._push(event)

    def _publish(self, gen_report_dir: str, gen_root: str, name: str) -> str:
        """Point ``results_root/<name>`` at the new generation by replacing
        the symlink atomically; keep the generation before for readers
        mid-walk and remove older ones.  A real directory under the live
        name (a one-shot report) is moved aside once, logged."""
        live = os.path.join(self.results_root, name)
        os.makedirs(self.results_root, exist_ok=True)
        if os.path.lexists(live) and not os.path.islink(live):
            aside = f"{live}.pre-watch-{uuid.uuid4().hex[:6]}"
            os.rename(live, aside)
            _log.warning("watch.rotated_existing_report", report=live, moved_to=aside)
        tmp_link = f"{live}.link-{uuid.uuid4().hex[:6]}"
        os.symlink(gen_report_dir, tmp_link)
        os.replace(tmp_link, live)
        self._gen_dirs.append(gen_root)
        while len(self._gen_dirs) > 2:
            shutil.rmtree(self._gen_dirs.pop(0), ignore_errors=True)
        self.report_dir = live
        return live
