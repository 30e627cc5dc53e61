"""The chaos fault injector: a copy of the JAX package's ``utils/chaos.py``.

Nemo debugs distributed protocols under injected faults; this module points
the same discipline at Nemo itself.  Faults are armed by the ``NEMO_CHAOS``
env var, a ``;``-separated list of modes, and fire at named injection
points in the production code.  With ``NEMO_CHAOS`` unset every hook is
one env lookup and a compare, so the hooks stay in the hot paths, as the
obs spans do.  ``NEMO_CHAOS`` is a harness knob, not a routing knob: it
stays an env var, as in the reference.

Modes (``name`` or ``name:arg``):

  ``fail_dispatch:N``        the first N dispatches through
                             ``TorchExecutor.run`` raise
                             :class:`ChaosFault`, which the scheduler
                             classifies as a lane failure
  ``wedge_dispatch:N``       the first N dispatches sleep far past any
                             deadline (``NEMO_DISPATCH_TIMEOUT_S``
                             abandons them)
  ``kill_after_segments:N``  SIGKILL this process right after the Nth
                             segment checkpoint is published: no cleanup
                             handler runs, as after a real OOM kill
  ``kill_in_store_publish``  SIGKILL inside the corpus store's populate,
                             after the shard bytes are written and before
                             the rename publishes them: the tmp directory
                             and the lock file are all that is left
  ``slow_io:S``              sleep S seconds at ``on_slow_io`` (the
                             reference calls it from no production path,
                             and neither does the port)

The budgets are process-global and count down: ``fail_dispatch:2`` means
the first 2 matching calls in this process, which makes an injected
schedule deterministic; ``reset()`` forgets them.  The helpers below
(``corrupt_run_file``, ``corrupt_rcache_entry``) corrupt state on disk
before a run instead of injecting at a point in time.

Every fired injection logs a ``chaos.injected`` warning on the
``nemo.chaos`` logger and counts ``chaos.injected.<point>``, so a chaos
run's telemetry says what was injected.

On the card an injected dispatch fault is raised, never moved to the host
(parallel/sched.py: a card-keyed scheduler counts a lane failure and
raises it); on the CPU the scheduler fails it over as the reference does.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import log as obs_log

_log = obs_log.get_logger("nemo.chaos")


class ChaosFault(RuntimeError):
    """An injected fault.  A RuntimeError, as the device errors it stands
    in for are; ``sched.is_lane_failure`` counts it as the lane's."""


_lock = threading.Lock()
#: mode -> remaining budget (int) or parameter (float); None = chaos off.
_spec: dict[str, float] | None = None
_spec_env: str | None = object()  # sentinel: not yet parsed


def _parse(env: str) -> dict[str, float]:
    spec: dict[str, float] = {}
    for part in env.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, arg = part.partition(":")
        name = name.strip().lower()
        try:
            val = float(arg) if arg else 1.0
        except ValueError:
            _log.warning("chaos.bad_mode", mode=part, detail="argument not a number")
            continue
        spec[name] = val
    return spec


def _active() -> dict[str, float] | None:
    """The parsed NEMO_CHAOS spec, parsed again when the env changes
    (tests set it per case; a deployment sets it once at launch)."""
    global _spec, _spec_env
    env = os.environ.get("NEMO_CHAOS") or None
    if env == _spec_env:
        return _spec
    with _lock:
        _spec_env = env
        _spec = _parse(env) if env else None
    return _spec


def reset() -> None:
    """Forget the consumed budgets (tests)."""
    global _spec, _spec_env
    with _lock:
        _spec = None
        _spec_env = object()


def _consume(spec: dict, mode: str) -> bool:
    """Take one unit of a counted mode's budget, atomically."""
    with _lock:
        left = spec.get(mode, 0)
        if left <= 0:
            return False
        spec[mode] = left - 1
    return True


def _fired(point: str, **ctx) -> None:
    obs.metrics.inc(f"chaos.injected.{point}")
    _log.warning("chaos.injected", point=point, **ctx)


# ---------------------------------------------------------------------------
# injection points
# ---------------------------------------------------------------------------


def on_device_dispatch(verb: str) -> None:
    """Hook at the top of every dispatch (backend/torch_backend.py:
    ``TorchExecutor.run``).  May raise ChaosFault (``fail_dispatch``) or
    sleep past any deadline (``wedge_dispatch``)."""
    spec = _active()
    if not spec:
        return
    if "fail_dispatch" in spec and _consume(spec, "fail_dispatch"):
        _fired("fail_dispatch", verb=verb)
        raise ChaosFault(f"injected device dispatch failure (verb={verb})")
    if "wedge_dispatch" in spec and _consume(spec, "wedge_dispatch"):
        _fired("wedge_dispatch", verb=verb)
        # Far past any NEMO_DISPATCH_TIMEOUT_S; the scheduler abandons
        # this thread, a daemon, to its sleep.
        time.sleep(3600.0)


def on_segment_published(n_published: int) -> None:
    """Hook after the pipeline publishes one segment checkpoint
    (analysis/pipeline.py's map loop).  ``kill_after_segments:N`` SIGKILLs
    the process once N checkpoints are on disk: no atexit, no finally."""
    spec = _active()
    if not spec:
        return
    n = spec.get("kill_after_segments")
    if n is not None and n_published >= n:
        _fired("kill_after_segments", published=n_published)
        os.kill(os.getpid(), signal.SIGKILL)


def on_store_publish() -> None:
    """Hook inside the store's populate, after the shard bytes are written
    and before the rename publishes them (store/__init__.py:_put_traced)."""
    spec = _active()
    if not spec:
        return
    if "kill_in_store_publish" in spec and _consume(spec, "kill_in_store_publish"):
        _fired("kill_in_store_publish")
        os.kill(os.getpid(), signal.SIGKILL)


def on_slow_io(point: str) -> None:
    """``slow_io:S`` sleeps S seconds, a degraded network filesystem.  The
    IO point is logged as ``where`` (the reference passes it as ``point``,
    which collides with ``_fired``'s own and raises TypeError when armed)."""
    spec = _active()
    if not spec:
        return
    s = spec.get("slow_io")
    if s:
        _fired("slow_io", where=point, seconds=s)
        time.sleep(s)


# ---------------------------------------------------------------------------
# on-disk corruption helpers (for harnesses; not injection points)
# ---------------------------------------------------------------------------


def corrupt_run_file(corpus_dir: str, position: int, kind: str = "truncate") -> str:
    """Corrupt one run's post-provenance JSON in place; returns the file
    name.  ``truncate`` cuts the file mid-token, ``garbage`` replaces it
    with bytes that are not JSON: both are parse failures that quarantine."""
    name = f"run_{position}_post_provenance.json"
    path = os.path.join(corpus_dir, name)
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        if kind == "garbage":
            fh.write(b"\xff\xfenot json{{{")
        else:
            fh.write(data[: max(1, len(data) // 2)])
    return name


def corrupt_rcache_entry(cache_root: str, kind: str = "partial") -> str | None:
    """Flip the first byte of the first ``<kind>/`` entry's first payload
    file under a result-cache root; returns the entry directory, or None
    when there is none.  The next lookup must find the entry stale and
    recompute."""
    kdir = os.path.join(cache_root, kind)
    try:
        entries = sorted(d for d in os.listdir(kdir) if ".tmp-" not in d)
    except OSError:
        return None
    if not entries:
        return None
    d = os.path.join(kdir, entries[0])
    for dirpath, _, files in os.walk(d):
        for f in files:
            if f == "entry.json":
                continue
            p = os.path.join(dirpath, f)
            with open(p, "r+b") as fh:
                fh.seek(0)
                first = fh.read(1)
                fh.seek(0)
                fh.write(bytes([first[0] ^ 0xFF]) if first else b"\xff")
            return d
    # An entry with no payload file: corrupt its entry.json.
    with open(os.path.join(d, "entry.json"), "ab") as fh:
        fh.write(b"garbage")
    return d
