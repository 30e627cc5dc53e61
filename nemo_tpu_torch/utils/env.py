"""Environment knobs read by the port's ingest, corpus store, result cache,
streamed map, reduce and watch loop: a trimmed copy of the JAX package's
``utils/env.py``.

A junk value of a flag or a number warns and falls back to the default:
these knobs gate caches, degraded operation and the shape of the execution,
never which algorithm analyzes the corpus.  An enumerated knob
(``env_choice``) raises on junk, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import os

from nemo_tpu_torch.obs import log as obs_log

_log = obs_log.get_logger("nemo.env")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@contextlib.contextmanager
def env_override(updates: dict[str, str]):
    """Set each variable for the body, then restore the environment: a CLI
    flag that travels as its env var, as the JAX package's do, without
    outliving the call (``main()`` may run many times in one process).
    Subprocesses started inside the body inherit the values."""
    saved = {k: os.environ.get(k) for k in updates}
    os.environ.update(updates)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob accepting 1/true/yes/on and 0/false/no/off."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    _log.warning("env.bad_value", name=name, value=raw, detail="is not a recognized boolean", using=default)
    return default


def env_int(name: str, default: int, minimum: int = 0) -> int:
    """Integer knob, at least ``minimum``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        n = int(raw)
    except ValueError:
        _log.warning("env.bad_value", name=name, value=raw, detail="is not an integer", using=default)
        return default
    if n < minimum:
        _log.warning("env.bad_value", name=name, value=raw, detail=f"must be >= {minimum}", using=default)
        return default
    return n


def env_float(name: str, default: float, minimum: float = 0.0) -> float:
    """Float knob, at least ``minimum``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        _log.warning("env.bad_value", name=name, value=raw, detail="is not a number", using=default)
        return default
    if v < minimum:
        _log.warning("env.bad_value", name=name, value=raw, detail=f"must be >= {minimum}", using=default)
        return default
    return v


def env_choice(name: str, default: str, choices: tuple) -> str:
    """Enumerated knob; raises on a value outside ``choices``."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw not in choices:
        raise ValueError(f"{name}={raw!r} (expected one of {', '.join(choices)})")
    return raw


def quarantine_enabled() -> bool:
    """``NEMO_QUARANTINE`` (default on): a malformed run is quarantined
    (the report's "Degraded runs") instead of failing the whole corpus."""
    return env_flag("NEMO_QUARANTINE", True)


def cache_root(arg: str | None, env_name: str, leaf: str) -> str | None:
    """Root of one of the port's caches: an explicit argument wins (``off``,
    ``0``, ``none``, ``false`` or empty disables -> None), else the
    environment variable ``env_name`` (same spellings), else
    ``~/.cache/nemo_tpu_torch/<leaf>`` — the port's own default roots, apart
    from the JAX package's."""
    raw = arg if arg is not None else os.environ.get(env_name)
    if raw is not None:
        raw = raw.strip()
        if raw.lower() in ("", "0", "off", "none", "false"):
            return None
        return os.path.expanduser(raw)
    return os.path.join(os.path.expanduser("~"), ".cache", "nemo_tpu_torch", leaf)


# ---------------------------------------------------------------------------
# the scheduler's degraded-operation knobs (parallel/sched.py)
# ---------------------------------------------------------------------------


def sched_env() -> str:
    """``NEMO_SCHED``: ``off`` (the default; the JAX package's is ``auto``)
    drains every job list in order on the caller's thread, each job on its
    routed lane; ``auto`` schedules a list of more than one job on one
    worker thread per lane; ``on`` schedules every list.  Raises on junk, as
    the JAX package's does: a typo resolving to a default would change the
    execution's concurrency in exactly the dimension the caller pinned."""
    v = os.environ.get("NEMO_SCHED", "off").strip().lower()
    if v == "auto":
        return "auto"
    if v in _TRUE:
        return "on"
    if v in _FALSE:
        return "off"
    raise ValueError(f"NEMO_SCHED={v!r} (expected auto, on, or off)")


def dispatch_timeout_s() -> float:
    """``NEMO_DISPATCH_TIMEOUT_S`` (default 0, off): the deadline of one
    device-lane job under the scheduler.  Past it the job's thread is
    abandoned (a launch cannot be cancelled), the breaker counts a failure
    and the job fails over to the host lane, recorded."""
    return env_float("NEMO_DISPATCH_TIMEOUT_S", 0.0)


def breaker_failures() -> int:
    """``NEMO_BREAKER_FAILURES`` (default 3): consecutive device-lane
    failures that open the device's circuit breaker."""
    return env_int("NEMO_BREAKER_FAILURES", 3, minimum=1)


def breaker_cooldown_s() -> float:
    """``NEMO_BREAKER_COOLDOWN_S`` (default 30): how long an open breaker
    plans the device's jobs to the host before one half-open probe."""
    return env_float("NEMO_BREAKER_COOLDOWN_S", 30.0)


def failover_backoff_s() -> float:
    """``NEMO_FAILOVER_BACKOFF_S`` (default 0.05): base of the jittered
    backoff slept before a failed device job runs again on the host."""
    return env_float("NEMO_FAILOVER_BACKOFF_S", 0.05)
