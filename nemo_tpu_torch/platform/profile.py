"""The persistent platform profile: measured routing constants and their
precedence.

A port of the JAX package's ``platform/profile.py``.  One JSON document
per platform fingerprint (platform/fingerprint.py), under
``~/.cache/nemo_tpu_torch/platform/profile-<key>.json`` (``NEMO_PROFILE_DIR``
relocates it; the JAX package's profiles live elsewhere, so the two never
share one).  It holds the calibrator's fitted constants (platform/
calibrate.py), the probe measurements they were fitted from and, in its
``ewma`` field, the scheduler's per-(verb, V, E) walls of earlier sessions
on the same platform (``warm_start`` seeds a session's lane models from
them; ``fold_back_session`` merges the session's back at exit).

Every consumer resolves each constant by one precedence rule, recorded per
constant so telemetry can show where a number came from:

    explicit argument  -> ``arg``      (a TorchBackend constructor knob or
                                        an explicit query_host_work; the
                                        port reads no routing env var)
    measured profile   -> ``measured`` (``profile_value``)
    neither            -> ``seeded``   (``CONSTANTS``, the reference's seeds)

``NEMO_PROFILE`` gates the subsystem: ``auto`` loads the fingerprint's
profile and calibrates once when none exists, ``off`` neither loads nor
calibrates (every constant resolves arg/seeded), ``force`` recalibrates
once per process even over an existing profile.  The CLI's
``--profile-mode`` sets it for one run (``mode_override``).  The default
is ``off`` (the reference's is ``auto``): on the H100 no measured profile
has yet changed a route of the bench families for the better, so the
seeded routes stay until a chip run shows a gain.  A fingerprint
change misses the keyed file and calibrates; a corrupt or mismatched file
falls back to seeded constants with ``profile.stale`` counted (a storage
fault is no reason to burn a calibration nobody asked for).  A probe that
fails raises out of ``ensure_calibrated``: a failed launch on the card is
never hidden behind seeded constants.

Unlike the reference's one profile per process, profiles are cached per
file (per fingerprint and profile directory), so cpu and cuda backends in
one process each route by their own device's profile.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import tempfile
import threading
import time

from nemo_tpu_torch import obs
from nemo_tpu_torch.obs import log as _obs_log
from nemo_tpu_torch.utils.env import env_choice, env_float

from .fingerprint import clear_fingerprints, fingerprint_key, platform_fingerprint

_log = _obs_log.get_logger("nemo.platform")

#: Bump when the profile document schema changes incompatibly; a mismatch
#: reads as corrupt (seeded fallback + profile.stale), never as measured.
PROFILE_ABI_VERSION = 1

#: The mode when neither ``NEMO_PROFILE`` nor ``--profile-mode`` names one.
DEFAULT_MODE = "off"

#: constant name -> (the argument that overrides it, seeded value, group).
#: The names, seeds and groups are the JAX package's; its env vars become
#: the TorchBackend constructor knobs (``sparse_device_mem_bytes`` in
#: bytes, the constant in MB).  sched_device_fixed's seed is derived
#: (budget x unit spread, query/engine.py:derived_query_host_work), hence
#: None.
CONSTANTS: dict[str, tuple[str | None, float | None, str]] = {
    "analysis_host_work": ("analysis_host_work", 100000, "routing"),
    "synth_host_work": ("synth_host_work", 100000, "routing"),
    "diff_host_work": ("diff_host_work", 2000000, "routing"),
    "sparse_device_mem_mb": ("sparse_device_mem_bytes", 256.0, "routing"),
    "sparse_device_density": ("sparse_device_density", 1.0 / 256.0, "routing"),
    "sched_host_unit": (None, 1e-6, "sched"),
    "sched_device_unit": (None, 5e-8, "sched"),
    "sched_sparse_device_unit": (None, 2.5e-7, "sched"),
    "sched_device_fixed": (None, None, "sched"),
    "sched_flops_per_s": (None, 5e9, "pricing"),
}

#: name -> seeded value: what every constant resolves to with no argument
#: and no profile.
SEEDED = {name: seeded for name, (_arg, seeded, _group) in CONSTANTS.items()}

#: Encoded profile.source.<group> gauge values.
_SOURCE_CODE = {"seeded": 0, "measured": 1, "arg": 2}

_MODES = ("auto", "off", "force")
_MODE_OVERRIDE: list[str | None] = [None]


def profile_mode() -> str:
    """The mode: ``--profile-mode`` while ``mode_override`` holds it, else
    ``NEMO_PROFILE``, else DEFAULT_MODE."""
    return _MODE_OVERRIDE[0] or env_choice("NEMO_PROFILE", DEFAULT_MODE, _MODES)


@contextlib.contextmanager
def mode_override(mode: str | None):
    """Set the mode for the body (None: leave it to the env)."""
    if mode is not None and mode not in _MODES:
        raise ValueError(f"profile mode {mode!r} (expected one of {', '.join(_MODES)})")
    prev, _MODE_OVERRIDE[0] = _MODE_OVERRIDE[0], mode
    try:
        yield
    finally:
        _MODE_OVERRIDE[0] = prev


def profile_budget_s() -> float:
    """``NEMO_PROFILE_BUDGET_S`` (default 8): wall budget of one
    calibration after the build.  Probes check the deadline between steps
    and keep a partial fit (unfitted constants stay seeded)."""
    return env_float("NEMO_PROFILE_BUDGET_S", 8.0, minimum=0.5)


def profile_dir() -> str:
    return os.environ.get("NEMO_PROFILE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "nemo_tpu_torch", "platform")


def profile_path(key: str) -> str:
    return os.path.join(profile_dir(), f"profile-{key}.json")


class PlatformProfile:
    """In-memory view of one profile document (the JSON schema, 1:1)."""

    def __init__(
        self,
        fingerprint: dict,
        constants: dict | None = None,
        probes: dict | None = None,
        ewma: dict | None = None,
        calibration_wall_s: float = 0.0,
        created: float | None = None,
        updated: float | None = None,
    ) -> None:
        self.fingerprint = dict(fingerprint)
        self.key = fingerprint_key(self.fingerprint)
        #: name -> {"value": float, "measured": bool}; measured=False
        #: entries record a constant that stayed seeded.
        self.constants = dict(constants or {})
        #: raw probe measurements the fit came from
        self.probes = dict(probes or {})
        self.ewma = {lane: dict(d) for lane, d in (ewma or {}).items()}
        self.calibration_wall_s = float(calibration_wall_s)
        self.created = float(created if created is not None else time.time())
        self.updated = float(updated if updated is not None else self.created)

    def measured_value(self, name: str) -> float | None:
        rec = self.constants.get(name)
        if rec and rec.get("measured") and rec.get("value") is not None:
            return float(rec["value"])
        return None

    def set_constant(self, name: str, value: float, measured: bool = True) -> None:
        self.constants[name] = {"value": float(value), "measured": bool(measured)}

    def age_s(self) -> float:
        return max(time.time() - self.updated, 0.0)

    def to_doc(self) -> dict:
        return {
            "abi": PROFILE_ABI_VERSION,
            "fingerprint": self.fingerprint,
            "key": self.key,
            "constants": self.constants,
            "probes": self.probes,
            "ewma": self.ewma,
            "calibration_wall_s": self.calibration_wall_s,
            "created": self.created,
            "updated": self.updated,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "PlatformProfile":
        if doc.get("abi") != PROFILE_ABI_VERSION:
            raise ValueError(f"profile ABI {doc.get('abi')!r} != {PROFILE_ABI_VERSION}")
        prof = cls(
            doc["fingerprint"],
            constants=doc.get("constants"),
            probes=doc.get("probes"),
            ewma=doc.get("ewma"),
            calibration_wall_s=doc.get("calibration_wall_s", 0.0),
            created=doc.get("created"),
            updated=doc.get("updated"),
        )
        if doc.get("key") != prof.key:
            raise ValueError(f"profile key {doc.get('key')!r} does not match its own fingerprint ({prof.key})")
        return prof

    def save(self) -> str:
        """Atomic write (tmp + rename): a crashed process never leaves a
        half-written profile for the next one to read as corrupt."""
        path = profile_path(self.key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".profile-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(self.to_doc(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


# ---------------------------------------------------------------------------
# the process's loaded profiles, one per profile file
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: profile path -> the loaded profile, or None (no file yet, or corrupt).
_ACTIVE: dict[str, PlatformProfile | None] = {}
#: paths this process calibrated (force recalibrates once a process).
_CALIBRATED: set[str] = set()
#: paths whose file was present but unreadable: the corruption latch that
#: keeps a storage fault on seeded constants (``force`` still calibrates).
_CORRUPT: set[str] = set()
#: (device, args) of the last resolve_constants: what the flight recorder
#: reports (telemetry_section() with no device); it has no backend at hand.
_LAST: dict = {}
#: scheduler device key -> the profile file its session models were
#: warm-started from: the one file fold_back_session may write its walls to
_FOLD_PATHS: dict[str, str] = {}
#: whether fold_back_session is registered to run at exit
_FOLD_BACK_REGISTERED = [False]


def reset_active_profile() -> None:
    """Forget the loaded profiles, the latches, the last resolution and the
    cached fingerprints (tests)."""
    with _LOCK:
        _ACTIVE.clear()
        _CALIBRATED.clear()
        _CORRUPT.clear()
        _LAST.clear()
        _FOLD_PATHS.clear()
    clear_fingerprints()


def _load(fp: dict, path: str) -> PlatformProfile | None:
    """The profile file at ``path``, or None when missing.  A present but
    unreadable or mismatched file is the corruption case: latched,
    ``profile.stale`` counted, a warning logged, None returned."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        prof = PlatformProfile.from_doc(doc)
        if prof.fingerprint != fp:
            raise ValueError("embedded fingerprint does not match this platform")
        return prof
    except (OSError, ValueError, KeyError, TypeError) as ex:
        _CORRUPT.add(path)
        obs.metrics.inc("profile.stale")
        _log.warning("profile.stale", path=path, error=str(ex), action="seeded defaults")
        return None


def _locate(device) -> tuple[dict, str]:
    """``device``'s fingerprint and its profile file."""
    fp = platform_fingerprint(device)
    return fp, profile_path(fingerprint_key(fp))


def active_profile(device=None) -> PlatformProfile | None:
    """The loaded profile of ``device``'s fingerprint, or None (mode off, no
    file yet, or a corrupt file).  Loads each file at most once a process;
    never calibrates (``ensure_calibrated`` does, from the backend's
    setup)."""
    if profile_mode() == "off":
        return None
    return _active(*_locate(device))


def _active(fp: dict, path: str) -> PlatformProfile | None:
    with _LOCK:
        if path not in _ACTIVE:
            prof = _ACTIVE[path] = _load(fp, path)
            if prof is not None:
                obs.metrics.inc("profile.loaded")
            _record_metrics_locked(prof)
        return _ACTIVE[path]


def ensure_calibrated(device=None, force: bool = False) -> PlatformProfile | None:
    """The calibration trigger (TorchBackend.init_graph_db, the CLI's
    ``--calibrate``): under ``auto`` with no profile on disk, run one
    bounded probe suite on ``device`` and persist it; ``force`` (the mode
    or the keyword) recalibrates once a process even over an existing
    file; ``off`` does nothing.  A corrupt file stays seeded unless
    forced.  A failed calibration counts ``profile.error`` and raises."""
    mode = profile_mode()
    if mode == "off":
        return None
    force = force or mode == "force"
    fp, path = _locate(device)
    prof = _active(fp, path)
    with _LOCK:
        want = (prof is None and path not in _CORRUPT) or (force and path not in _CALIBRATED)
        if not want:
            return prof
        _CALIBRATED.add(path)
    _log.warning("profile.calibrating", fingerprint=fp,
                 reason="forced" if force else "no profile for this fingerprint", budget_s=profile_budget_s())
    try:
        from .calibrate import run_calibration

        new = run_calibration(device)
        new.save()
    except Exception as ex:
        obs.metrics.inc("profile.error")
        _log.warning("profile.calibration_failed", error=str(ex), action="raised")
        raise
    obs.metrics.inc("profile.calibrated")
    with _LOCK:
        _ACTIVE[path] = new
        _CORRUPT.discard(path)
        _record_metrics_locked(new)
    return new


def profile_value(name: str, device=None) -> float | None:
    """The measured value of one constant on ``device``'s profile, or None
    when the profile is off or absent or the constant stayed seeded."""
    prof = active_profile(device)
    return None if prof is None else prof.measured_value(name)


def _constant_rows(prof: PlatformProfile | None, args: dict | None) -> list[dict]:
    rows = []
    for name, (arg, seeded, group) in CONSTANTS.items():
        measured = None if prof is None else prof.measured_value(name)
        given = (args or {}).get(name)
        if given is not None:
            source, value = "arg", given
        elif measured is not None:
            source, value = "measured", measured
        else:
            source, value = "seeded", seeded
        rows.append({"name": name, "arg": arg, "group": group, "source": source, "value": value,
                     "measured": measured})
    return rows


def resolve_constants(device, args: dict | None = None) -> dict:
    """name -> value of every constant on ``device``, arg > measured >
    seeded (``args``: name -> the explicit value, in the constant's unit).
    Recorded as the last resolution, which ``telemetry_section()`` reports
    when it is given no device (the flight recorder)."""
    rows = _constant_rows(active_profile(device), args)
    with _LOCK:
        _LAST.update(device=device, args=dict(args or {}))
    return {r["name"]: r["value"] for r in rows}


def constant_sources(device, args: dict | None = None) -> list[dict]:
    """Per-constant resolution table on ``device`` with the explicit
    ``args``: the resolved value, its source (arg > measured > seeded), and
    the measured record even when an argument wins (overriding must not
    suppress the measurement)."""
    return _constant_rows(active_profile(device), args)


def _record_metrics_locked(prof: PlatformProfile | None) -> None:
    """profile.source.<group> / profile.age_s / profile.calibration_s
    gauges of a profile just loaded or calibrated."""
    groups: dict[str, int] = {}
    for row in _constant_rows(prof, None):
        code = _SOURCE_CODE[row["source"]]
        groups[row["group"]] = max(groups.get(row["group"], 0), code)
    for group, code in groups.items():
        obs.metrics.gauge(f"profile.source.{group}", code)
    if prof is not None:
        obs.metrics.gauge("profile.age_s", prof.age_s())
        obs.metrics.gauge("profile.calibration_s", prof.calibration_wall_s)


def telemetry_section(device=None, args: dict | None = None) -> dict:
    """The ``platform_profile`` section of telemetry.json (``device`` and
    ``args``: the report's backend's) and of flight-recorder bundles (no
    device: the process's last resolution, else every constant seeded):
    the mode, the constant table and, with a profile, its fingerprint,
    key, calibration wall and age."""
    if device is None:
        with _LOCK:
            device, args = _LAST.get("device"), _LAST.get("args")
    prof = None if device is None else active_profile(device)
    sect: dict = {"mode": profile_mode(), "constants": _constant_rows(prof, args)}
    if prof is not None:
        sect.update(
            fingerprint=prof.fingerprint,
            key=prof.key,
            calibration_wall_s=round(prof.calibration_wall_s, 4),
            age_s=round(prof.age_s(), 1),
            ewma_classes={lane: len(d) for lane, d in prof.ewma.items()},
        )
    return sect


# ---------------------------------------------------------------------------
# the scheduler's memory across sessions: warm start and fold-back
# ---------------------------------------------------------------------------


def _ewma_key(verb: str, v: int, e: int) -> str:
    return f"{verb}|{v}|{e}"


def _ewma_unkey(key: str) -> tuple[str, int, int] | None:
    parts = key.split("|")
    if len(parts) != 3:
        return None
    try:
        return parts[0], int(parts[1]), int(parts[2])
    except ValueError:
        return None


def warm_start(models: dict, device) -> None:
    """Seed a session's fresh lane models (parallel/sched.py:session_models)
    with the per-(verb, V, E) walls ``device``'s profile holds from earlier
    sessions, and register ``fold_back_session`` for exit.  Nothing without
    a profile (the mode is off, or none was made)."""
    from nemo_tpu_torch.parallel.sched import device_key

    if profile_mode() == "off":
        return
    fp, path = _locate(device)
    prof = _active(fp, path)
    if prof is None:
        return
    loaded = 0
    for lane, model in models.items():
        for key, per_row in prof.ewma.get(lane, {}).items():
            parsed = _ewma_unkey(key)
            if parsed is not None and per_row > 0:
                model.per_row[parsed] = float(per_row)
                loaded += 1
    if loaded:
        obs.metrics.inc("profile.ewma_warm_start", loaded)
    with _LOCK:
        if not _FOLD_BACK_REGISTERED[0]:
            atexit.register(fold_back_session)
            _FOLD_BACK_REGISTERED[0] = True
        _FOLD_PATHS[device_key(device)] = path


def fold_back_session() -> None:
    """Merge every device's measured per-(verb, V, E) walls
    (parallel/sched.py's session models) into the profile its models were
    warm-started from, half old and half new, and rewrite each changed
    file atomically.  A device whose models no profile warm-started folds
    nothing, so a cpu drain never reaches the card's file.  Registered at
    exit by ``warm_start``; a failure counts ``profile.fold_back_error``,
    logs a warning and raises."""
    import sys

    sch = sys.modules.get("nemo_tpu_torch.parallel.sched")
    if sch is None:
        return
    try:
        with sch._STATE_LOCK:
            sessions = {key: {lane: dict(m.per_row) for lane, m in models.items()}
                        for key, models in sch._SESSION_MODELS.items()}
        for key, lanes in sessions.items():
            with _LOCK:
                prof = _ACTIVE.get(_FOLD_PATHS.get(key, ""))
            if prof is None:
                continue
            folded = 0
            for lane, per_row in lanes.items():
                table = prof.ewma.setdefault(lane, {})
                for (verb, v, e), wall in per_row.items():
                    k = _ewma_key(verb, v, e)
                    old = table.get(k)
                    table[k] = float(wall) if old is None else 0.5 * float(old) + 0.5 * float(wall)
                    folded += 1
            if folded:
                prof.updated = time.time()
                prof.save()
                obs.metrics.inc("profile.fold_back", folded)
    except Exception as ex:
        obs.metrics.inc("profile.fold_back_error")
        _log.warning("profile.fold_back_failed", error=f"{type(ex).__name__}: {ex}", action="raised")
        raise
