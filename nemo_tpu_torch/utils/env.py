"""Environment knobs read by the port's ingest, corpus store, result cache,
streamed map, reduce and watch loop: a trimmed copy of the JAX package's
``utils/env.py``.

A junk value of a flag or a number warns and falls back to the default:
these knobs gate caches, degraded operation and the shape of the execution,
never which algorithm analyzes the corpus.  An enumerated knob
(``env_choice``) raises on junk, as the JAX package's does.
"""

from __future__ import annotations

import os

from nemo_tpu_torch.obs import log as obs_log

_log = obs_log.get_logger("nemo.env")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


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
