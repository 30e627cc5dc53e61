"""The bounded probe suite: measure the platform, fit the constants.

A port of the JAX package's ``platform/calibrate.py``, with its probes at
its sizes and its fit.  ``run_calibration`` first builds every native
library (utils/prewarm.py:build_all; the wall is recorded as the probe
``build_wall_s`` and left out of the budget, so nvcc's first build never
passes for the cold dispatch), then, within ``NEMO_PROFILE_BUDGET_S``:

* ``transfer``: a host->device copy of 4 MB, the warm median (recorded,
  not fitted);
* ``fused``: the fused verb through ``TorchExecutor(device).run`` at two
  batch widths of the stress signature (utils/prewarm.py:stress_signature),
  each closed by a synchronize: one cold dispatch, then up to 3 warm ones.
  On the card it launches K1;
* ``sparse_host``: the host engine (ops/sparse_host.py:
  sparse_analysis_step) on the arrays of the wider fused probe.

The fit, as the reference's: ``sched_host_unit`` is the host wall over its
work (B x (V + E)), ``sched_device_unit`` the slope of the two warm device
walls and ``sched_device_fixed`` their intercept; ``analysis_host_work``
and ``synth_host_work`` are where the two lines cross, clamped to
[1,000, 10^8], ``diff_host_work`` 20x that (the seeded ratio) and
``sched_sparse_device_unit`` 5x the device unit.  ``sparse_device_mem_mb``
is 25 % of the card's memory, seeded on the CPU; ``sparse_device_density``
stays seeded, as does ``sched_flops_per_s`` (the cost table records no
FLOPs; the reference's under ``NEMO_COST_ANALYSIS=0``).

One departure: on the card a device slope at or above the host unit is
not a crossover.  There the fused probe's wall is host dispatch with a few
microseconds of K1 in it, so the slope between the two widths is noise,
and the reference's formula would turn such noise into the 10^8 clamp
that sends every bucket to the host for good.  The fused and host probes
then run again, up to ``_FIT_ATTEMPTS`` rounds in all (the rejected walls
kept under the probe ``rejected_fits``); when no round is sound the slope
stays seeded and unmeasured and the narrow width gives the intercept: the
reference's fit when only one width ran.  A card whose host unit is not
above even the seeded slope raises, and nothing is saved.  On the CPU the
plain dense step really is slower a unit than the host engine, and the
clamp is the fit.

Every probe runs under a ``profile:probe.<name>`` span; the deadline is
checked between steps, and running out keeps the partial fit.  A probe
that fails raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nemo_tpu_torch import obs
from nemo_tpu_torch.device import resolve_device
from nemo_tpu_torch.obs import log as _obs_log

from .fingerprint import platform_fingerprint
from .profile import PlatformProfile, profile_budget_s

_log = _obs_log.get_logger("nemo.platform")

#: Probe-corpus runs and the two fused batch widths; warm repetitions;
#: the transfer probe's megabytes (the reference's sizes).
_PROBE_RUNS = 8
_PROBE_WIDTHS = (8, 32)
_WARM_REPS = 3
_TRANSFER_MB = 4
#: Fused/host probe rounds on the card before the slope stays seeded.
_FIT_ATTEMPTS = 3
#: The seeded device slope (s a work unit): the reference's one-width fit.
_SEEDED_DEVICE_UNIT = 5e-8


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_build(prof: PlatformProfile, device: torch.device) -> None:
    """The build of every native library, before the budget's clock."""
    from nemo_tpu_torch.utils.prewarm import build_all

    with obs.span("profile:probe.build"):
        prof.probes["build_wall_s"] = build_all(device)


def _probe_transfer(prof: PlatformProfile, device: torch.device) -> None:
    """Host->device bandwidth of a 4 MB copy, warm median (on the CPU a
    host copy).  Recorded, not fitted: the upload is inside the fused
    probe's walls."""
    buf = torch.zeros(_TRANSFER_MB * 1024 * 1024 // 4, dtype=torch.float32)
    walls = []
    with obs.span("profile:probe.transfer", mb=_TRANSFER_MB):
        for _ in range(_WARM_REPS):
            t0 = time.perf_counter()
            buf.to(device, copy=True)
            _sync(device)
            walls.append(time.perf_counter() - t0)
    prof.probes["transfer_bytes_per_s"] = buf.numel() * 4 / max(_median(walls), 1e-9)


def _probe_fused(b_pad: int, deadline: float, device: torch.device) -> dict | None:
    """One fused probe at batch width ``b_pad``: the stress signature through
    TorchExecutor, each dispatch closed by a synchronize.  Returns {b, v, e,
    work, cold_s, warm_s, arrays}, or None when the deadline passed before
    this width started."""
    if time.perf_counter() >= deadline:
        return None
    from nemo_tpu_torch.backend.torch_backend import TorchExecutor
    from nemo_tpu_torch.models.case_studies import CASE_STUDIES
    from nemo_tpu_torch.utils.prewarm import fused_arrays, stress_signature

    family = sorted(CASE_STUDIES)[0]
    pre_p, post_p, static = stress_signature(family, _PROBE_RUNS, b_pad)
    arrays = fused_arrays(pre_p, post_p)
    v, e = int(static["v"]), int(np.asarray(pre_p.edge_src).shape[1])
    ex = TorchExecutor(device)

    def dispatch() -> float:
        obs.metrics.inc("profile.probe.dispatches")
        t0 = time.perf_counter()
        ex.run("fused", arrays, static, rows=_PROBE_RUNS)
        _sync(device)
        return time.perf_counter() - t0

    with obs.span("profile:probe.fused", b=b_pad, v=v, e=e):
        cold = dispatch()
        warm = []
        for _ in range(_WARM_REPS):
            if time.perf_counter() >= deadline:
                break
            warm.append(dispatch())
    return {
        "b": b_pad,
        "v": v,
        "e": e,
        "work": b_pad * (v + e),
        "cold_s": cold,
        "warm_s": _median(warm) if warm else cold,
        "arrays": (pre_p, post_p, static),
    }


def _probe_host(fused_probe: dict) -> dict:
    """The host engine's wall on the arrays of the widest fused probe: the
    same work units for the crossover fit."""
    from nemo_tpu_torch.ops.sparse_host import sparse_analysis_step

    pre_p, post_p, static = fused_probe["arrays"]
    walls = []
    with obs.span("profile:probe.sparse_host", b=fused_probe["b"]):
        for _ in range(_WARM_REPS):
            t0 = time.perf_counter()
            sparse_analysis_step(
                pre_p,
                post_p,
                v=int(static["v"]),
                pre_tid=int(static["pre_tid"]),
                post_tid=int(static["post_tid"]),
                num_tables=int(static["num_tables"]),
                comp_linear=bool(static.get("comp_linear", False)),
            )
            walls.append(time.perf_counter() - t0)
    return {"work": fused_probe["work"], "wall_s": _median(walls)}


def _device_mem_mb(device: torch.device) -> float | None:
    """25 % of the card's memory (the dense route's watermark headroom);
    None on the CPU, where the device memory is host RAM and the seeded
    watermark stands."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory * 0.25 / 1e6


def run_calibration(device=None) -> PlatformProfile:
    """Build, run the probe suite on ``device`` and return the fitted
    (unsaved) profile."""
    device = resolve_device(device)
    prof = PlatformProfile(platform_fingerprint(device))
    _probe_build(prof, device)
    budget = profile_budget_s()
    t_start = time.perf_counter()
    deadline = t_start + budget

    _probe_transfer(prof, device)

    rejected = []
    for attempt in range(1, _FIT_ATTEMPTS + 1):
        points = []
        for b_pad in _PROBE_WIDTHS:
            p = _probe_fused(b_pad, deadline, device)
            if p is None:
                break
            points.append(p)
        if not points:
            raise RuntimeError(f"calibration budget ({budget:.1f}s) expired before the fused probes of fit "
                               f"{attempt} completed")
        host = _probe_host(points[-1])
        fused = [{k: v for k, v in p.items() if k != "arrays"} for p in points]

        host_unit = host["wall_s"] / max(host["work"], 1)
        slope_measured = len(points) >= 2
        if slope_measured:
            dw = points[-1]["work"] - points[0]["work"]
            device_unit = max((points[-1]["warm_s"] - points[0]["warm_s"]) / max(dw, 1), 1e-12)
        else:
            # One width within the budget: the seeded slope, the intercept
            # from the one point.
            device_unit = _SEEDED_DEVICE_UNIT
        if device.type != "cuda" or device_unit < host_unit:
            break
        rejected.append({"fused": fused, "sparse_host": host, "device_unit": device_unit, "host_unit": host_unit})
        _log.warning("profile.fit_rejected", attempt=attempt, device_unit=device_unit, host_unit=host_unit)
    else:
        slope_measured, device_unit = False, _SEEDED_DEVICE_UNIT
        if device_unit >= host_unit:
            raise RuntimeError(f"degenerate fit on {device}: the host unit {host_unit} is not above the seeded "
                               f"device slope; nothing saved")
    if rejected:
        prof.probes["rejected_fits"] = rejected

    prof.probes["fused"] = fused
    prof.probes["sparse_host"] = host
    prof.probes["compile_wall_s"] = max(p["cold_s"] - p["warm_s"] for p in points)

    device_fixed = max(points[0]["warm_s"] - device_unit * points[0]["work"], 1e-6)
    crossover = device_fixed / max(host_unit - device_unit, 1e-12)
    analysis_work = int(min(max(crossover, 1_000), 100_000_000))

    prof.set_constant("sched_host_unit", host_unit)
    prof.set_constant("sched_device_unit", device_unit, measured=slope_measured)
    prof.set_constant("sched_device_fixed", device_fixed)
    prof.set_constant("sched_sparse_device_unit", device_unit * 5)
    prof.set_constant("analysis_host_work", analysis_work)
    prof.set_constant("synth_host_work", analysis_work)
    prof.set_constant("diff_host_work", min(analysis_work * 20, 2_000_000_000))

    mem_mb = _device_mem_mb(device)
    if mem_mb is not None:
        prof.set_constant("sparse_device_mem_mb", mem_mb)
    else:
        prof.set_constant("sparse_device_mem_mb", 256.0, measured=False)
    prof.set_constant("sparse_device_density", 1.0 / 256.0, measured=False)

    prof.calibration_wall_s = time.perf_counter() - t_start
    obs.metrics.gauge("profile.calibration_s", prof.calibration_wall_s)
    _log.info(
        "profile.calibrated",
        wall_s=round(prof.calibration_wall_s, 3),
        build_wall_s=round(prof.probes["build_wall_s"], 3),
        host_unit=host_unit,
        device_unit=device_unit,
        device_fixed=device_fixed,
        analysis_host_work=analysis_work,
        points=len(points),
    )
    return prof
