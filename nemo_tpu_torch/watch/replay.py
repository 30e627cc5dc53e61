"""Replay a finished corpus into a watched directory: the deterministic
stand-in for a sweep that is still running.

A copy of the JAX package's ``watch/replay.py``.  ``replay_corpus`` writes
``generations`` growing prefixes of the source corpus into the destination
(through the injector's ``materialize_prefix``, so Molly and trace-JSON
sweeps both replay), ``interval_s`` apart.  The CLI's ``--watch --replay
SRC`` drives a Watcher with it.
"""

from __future__ import annotations

import math
import os
import threading
import time

from nemo_tpu_torch import obs

_log = obs.log.get_logger("nemo.watch")


def replay_plan(n_runs: int, generations: int) -> list[int]:
    """The prefix sizes of ``generations`` even cuts of ``n_runs``, the last
    the whole corpus; fewer runs than generations give one-run steps."""
    generations = max(1, min(generations, n_runs))
    return [max(1, math.ceil(n_runs * (g + 1) / generations)) for g in range(generations)]


def replay_corpus(src_dir: str, dst_dir: str, generations: int = 3, interval_s: float = 1.0,
                  injector: str | None = None, stop: threading.Event | None = None) -> int:
    """Replay ``src_dir`` into ``dst_dir`` in ``generations`` steps: the
    first at once, each later one ``interval_s`` after the one before;
    ``stop`` ends it between generations.  Returns the generations
    written."""
    from nemo_tpu_torch.ingest import adapters

    inj = adapters.resolve_injector(src_dir, injector)
    total = inj.count_runs(src_dir)
    plan = replay_plan(total, generations)
    os.makedirs(dst_dir, exist_ok=True)
    _log.info("watch.replay_start", src=src_dir, dst=dst_dir, runs=total, generations=len(plan),
              interval_s=interval_s)
    written = 0
    for g, n in enumerate(plan):
        if stop is not None and stop.is_set():
            break
        if g:
            if stop is not None:
                if stop.wait(interval_s):
                    break
            else:
                time.sleep(interval_s)
        inj.materialize_prefix(src_dir, dst_dir, n)
        written += 1
        _log.info("watch.replay_generation", dst=dst_dir, generation=g + 1, runs=n)
    return written


def start_replay(src_dir: str, dst_dir: str, generations: int = 3, interval_s: float = 1.0,
                 injector: str | None = None) -> tuple[threading.Thread, threading.Event]:
    """replay_corpus on a daemon thread; returns (the thread, its stop
    event)."""
    stop = threading.Event()
    th = threading.Thread(target=replay_corpus, args=(src_dir, dst_dir, generations, interval_s, injector, stop),
                          daemon=True, name="nemo-watch-replay")
    th.start()
    return th, stop
