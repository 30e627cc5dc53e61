"""Shared utility helpers."""

from __future__ import annotations

import os


def effective_cpu_count() -> int:
    """Cores this process may run on: the scheduling affinity set where the
    platform exposes it (containers pin processes to a subset of
    os.cpu_count()), else os.cpu_count().  The prefetch threads
    (analysis/pipeline.py:run_debug_dirs, analysis/stream.py) run only with
    two or more: on one core a producer thread cannot overlap its consumer,
    and the hand-offs are pure overhead."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # platforms without affinity
        return os.cpu_count() or 1
