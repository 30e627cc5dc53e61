"""The port's scheduler (nemo_tpu_torch/parallel/sched.py) against the JAX
package's, on the CPU.

The same fake jobs go through both packages' schedulers: the lane models'
predict/observe sequences float for float, ``default_models`` from the same
constants, ``plan`` with and without an open breaker, the breaker's state
machine under a patched ``time.monotonic`` and ``run(serial=True)``'s
decision records, walls aside.  Then the port alone, threaded: results land
by index, only unpinned jobs are stolen, a forced pin never fails over, a
lane failure is out of memory or a deadline and nothing else (a kernel's
own error propagates), on a card-keyed scheduler a lane failure or an open
breaker raises and nothing reaches the host, an abandoned dispatch records
no route and its late error is raised by the next run, cpu and cuda never
share models or a breaker, the
profile's warm start and fold-back keep each device's walls in its own
file, and the counters the lanes share lose no update.
"""

import json
import random
import sys
import threading
import time

import pytest
import torch

from nemo_tpu import obs as jax_obs
from nemo_tpu.parallel import sched as jax_sched
from nemo_tpu.platform import profile as jax_pp
from nemo_tpu_torch import obs
from nemo_tpu_torch.kernels.build import BuildError, KernelError, count_launch
from nemo_tpu_torch.parallel import sched
from nemo_tpu_torch.platform import profile as pp
from nemo_tpu_torch.utils.backoff import FAILOVER_POLICY, BackoffPolicy
from nemo_tpu_torch.utils.env import sched_env

SIDES = {"port": sched, "jax": jax_sched}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """No failover pause, both packages' scheduler state forgotten, the
    JAX side's NEMO_SCHED_* constants unset (the port reads none)."""
    monkeypatch.setenv("NEMO_FAILOVER_BACKOFF_S", "0")
    for name in ("NEMO_SCHED_HOST_UNIT", "NEMO_SCHED_DEVICE_UNIT", "NEMO_SCHED_DEVICE_FIXED",
                 "NEMO_SCHED_SPARSE_DEVICE_UNIT", "NEMO_ANALYSIS_HOST_WORK", "NEMO_DISPATCH_TIMEOUT_S"):
        monkeypatch.delenv(name, raising=False)
    sched.reset_session_models()
    sched.reset_device_breaker()
    jax_sched.reset_session_models()
    jax_sched.reset_device_breaker()
    yield
    sched.reset_session_models()
    sched.reset_device_breaker()
    jax_sched.reset_session_models()
    jax_sched.reset_device_breaker()


def _delta(mod, fn):
    before = mod.metrics.snapshot()
    out = fn()
    return out, mod.Metrics.delta(mod.metrics.snapshot(), before)["counters"]


def _lane_failure(side: str) -> BaseException:
    """Each package's out-of-memory failure of the device lane."""
    if side == "port":
        return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    class XlaRuntimeError(RuntimeError):
        pass

    return XlaRuntimeError("RESOURCE_EXHAUSTED: out of memory")


def _job(mod, side, index, rows=4, v=16, e=16, pinned=None, reason="sched", lanes=("device", "host"), log=None,
         fail_on_device=0, body=None, source="pipeline"):
    """A fake job: records (index, lane, reason, stolen), fails its first
    ``fail_on_device`` device-side runs with the lane's failure."""
    state = {"device": 0}

    def execute(lane, rec_reason, stolen):
        if log is not None:
            with threading.Lock():
                log.append((index, lane, rec_reason, stolen))
        if body is not None:
            body(lane)
        if lane != "host":
            state["device"] += 1
            if state["device"] <= fail_on_device:
                raise _lane_failure(side)
        return {"index": index, "lane": lane}

    return mod.Job(index=index, verb="fused", rows=rows, v=v, e=e, work=rows * (v + e), execute=execute,
                   pinned=pinned, reason=reason, lanes=lanes, source=source)


def _models(mod, host_unit=1e-6, device_fixed=0.1, device_unit=5e-8, sparse_unit=None):
    out = {"device": mod.LaneModel(device_fixed, device_unit), "host": mod.LaneModel(0.0, host_unit)}
    if sparse_unit is not None:
        out["sparse_device"] = mod.LaneModel(device_fixed, sparse_unit)
    return out


def _sched(mod, models, breaker=None):
    s = mod.HeterogeneousScheduler(models, device="cpu") if mod is sched else mod.HeterogeneousScheduler(models)
    s.breaker = breaker if breaker is not None else mod.CircuitBreaker(failures=99, cooldown_s=1000)
    return s


#: Job shapes (rows, v, e) on both sides of the seeded crossover.
SHAPES = [(10, 50, 50), (4000, 64, 256), (300, 128, 200), (1, 16, 16), (2000, 32, 32)]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.5, 0.25])
def test_lane_model_predict_observe_matches_jax(alpha):
    """The same observations in the same order: every prediction and the
    model's state equal, float for float."""
    rng = random.Random(7)
    models = {side: mod.LaneModel(0.004, 3e-7, alpha=alpha) for side, mod in SIDES.items()}
    seq = [(rng.choice(SHAPES), rng.uniform(1e-4, 0.2)) for _ in range(40)]
    got = {}
    for side, mod in SIDES.items():
        out = []
        for (rows, v, e), wall in seq:
            job = _job(mod, side, 0, rows, v, e)
            out.append(models[side].predict(job))
            models[side].observe(job, wall)
            out.append(models[side].predict(job))
        got[side] = (out, models[side].unit_s, dict(models[side].per_row))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("budget", [None, 0, 1000, 250_000])
def test_default_models_match_jax(budget):
    port = sched.default_models("cpu", budget)
    jax = jax_sched.default_models(budget)
    assert set(port) == set(jax) == set(sched.LANES)
    for lane in port:
        assert (port[lane].fixed_s, port[lane].unit_s) == (jax[lane].fixed_s, jax[lane].unit_s)


def test_default_models_match_jax_under_one_measured_profile(tmp_path, monkeypatch):
    """The same measured constants in each package's own profile file."""
    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path))
    consts = {"analysis_host_work": 40_000.0, "sched_host_unit": 3e-7, "sched_device_unit": 2e-8,
              "sched_device_fixed": 0.004, "sched_sparse_device_unit": 1e-7}
    for mod, fp in ((pp, pp.platform_fingerprint("cpu")), (jax_pp, jax_pp.platform_fingerprint())):
        mod.reset_active_profile()
        prof = mod.PlatformProfile(fp)
        for k, v in consts.items():
            prof.set_constant(k, v)
        prof.save()
    try:
        for budget in (None, 5000):
            port, jax = sched.default_models("cpu", budget), jax_sched.default_models(budget)
            for lane in port:
                assert (port[lane].fixed_s, port[lane].unit_s) == (jax[lane].fixed_s, jax[lane].unit_s)
    finally:
        pp.reset_active_profile()
        jax_pp.reset_active_profile()


def _plan_jobs(mod, side):
    jobs = [_job(mod, side, i, *shape) for i, shape in enumerate(SHAPES)]
    jobs += [
        _job(mod, side, 5, pinned="device", reason="forced"),
        _job(mod, side, 6, 4000, 64, 256, pinned="host", reason="forced"),
        _job(mod, side, 7, 4000, 64, 256, pinned="sparse_device", reason="mem", lanes=sched.LANES),
        _job(mod, side, 8, 3000, 64, 64, lanes=sched.LANES),
        _job(mod, side, 9, 1, 4096, 8192, pinned="sparse_device", reason="giant_impl"),
    ]
    return jobs


@pytest.mark.parametrize("breaker_open", [False, True])
def test_plan_matches_jax(breaker_open):
    """Plans of every kind of job: the cost model's, the pins', and with
    the breaker open its short circuit to the host (never for a forced
    pin)."""
    got = {}
    for side, mod in SIDES.items():
        br = mod.CircuitBreaker(failures=1, cooldown_s=1000)
        if breaker_open:
            br.record_failure()
        s = _sched(mod, _models(mod, sparse_unit=2.5e-7), br)
        got[side] = [s.plan(job) for job in _plan_jobs(mod, side)]
    assert got["port"] == got["jax"]
    lanes = [lane for lane, _reason, _preds in got["port"]]
    if breaker_open:
        assert lanes[5] == "device" and lanes[7] == lanes[9] == "host"
    else:
        assert lanes[:2] == ["host", "device"] and lanes[7] == "sparse_device"


def test_breaker_state_machine_matches_jax(monkeypatch):
    """One script of failures, successes, probes and clock steps on both
    breakers under one patched clock: the same answers, states and
    sched.breaker.* counts."""
    clock = [1000.0]
    for mod in (sched, jax_sched):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    script = ["allow", "fail", "allow", "fail", "peek", "allow", ("tick", 4.0), "peek", "allow", "allow",
              "fail", "allow", ("tick", 5.0), "allow", "allow", ("tick", 5.0), "allow", "ok", "allow", "fail",
              "fail", "fail", "peek", ("tick", 5.0), "peek", "allow", "ok", "ok"]
    got = {}
    for side, mod in SIDES.items():
        clock[0] = 1000.0
        br = mod.CircuitBreaker(failures=2, cooldown_s=5.0)
        trace = []

        def play(br=br, trace=trace):
            for step in script:
                if isinstance(step, tuple):
                    clock[0] += step[1]
                elif step == "fail":
                    br.record_failure()
                elif step == "ok":
                    br.record_success()
                else:
                    trace.append(getattr(br, step)())
                trace.append(br.state)

        _, counts = _delta(obs if side == "port" else jax_obs, play)
        got[side] = (trace, {k: v for k, v in counts.items() if k.startswith("sched.breaker.")})
    assert got["port"] == got["jax"]
    assert got["port"][1]["sched.breaker.trip"] >= 2 and got["port"][1]["sched.breaker.close"] >= 1


def _serial_records(side, mod):
    """run(serial=True) over planned, pinned, failing-over and
    breaker-routed jobs; the decision records without their walls."""
    models = _models(mod, sparse_unit=2.5e-7)
    br = mod.CircuitBreaker(failures=2, cooldown_s=1000)
    s = _sched(mod, models, br)
    jobs = _plan_jobs(mod, side)
    jobs[1] = _job(mod, side, 1, 4000, 64, 256, fail_on_device=1)  # fails over
    jobs[7] = _job(mod, side, 7, 4000, 64, 256, pinned="sparse_device", reason="mem", lanes=sched.LANES,
                   fail_on_device=1)  # fails over: the breaker trips
    log = []
    for j in jobs:
        inner = j.execute
        j.execute = lambda lane, reason, stolen, inner=inner, i=j.index: (log.append((i, lane, reason)),
                                                                           inner(lane, reason, stolen))[1]
    res = s.run(jobs, serial=True)
    # Two failures in a row open the breaker; the next unpinned device job
    # plans to the host (fresh models each time: learned ones price by the
    # walls measured).
    res += _sched(mod, _models(mod), br).run(
        [_job(mod, side, i, 4000, 64, 256, fail_on_device=1) for i in range(2)], serial=True)
    res += _sched(mod, _models(mod), br).run([_job(mod, side, 0, 4000, 64, 256)], serial=True)
    snap = sched.sched_snapshot("cpu") if mod is sched else jax_sched.sched_snapshot()
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in snap], log, res, s.failovers


def test_serial_decision_records_match_jax():
    port = _serial_records("port", sched)
    jax = _serial_records("jax", jax_sched)
    assert port == jax
    records = port[0]
    assert [r["failed_over"] for r in records].count(True) == 4
    assert records[-1]["reason"] == "breaker" and records[-1]["lane"] == "host"


def test_serial_counters_match_jax():
    got = {}
    for side, mod in SIDES.items():
        _, counts = _delta(obs if side == "port" else jax_obs, lambda side=side, mod=mod: _serial_records(side, mod))
        got[side] = {k: v for k, v in counts.items() if k.startswith(("analysis.sched.", "sched.breaker."))}
    assert got["port"] == got["jax"]
    assert got["port"]["analysis.sched.failover"] == 4 and got["port"]["sched.breaker.trip"] == 1


# ---------------------------------------------------------------------------
# the port, threaded
# ---------------------------------------------------------------------------


def test_results_land_by_index_and_idle_lane_steals():
    log = []
    jobs = [_job(sched, "port", i, rows=10, body=lambda lane: time.sleep(0.05), log=log) for i in range(10)]
    s = _sched(sched, _models(sched))
    res = s.run(jobs)
    assert [r["index"] for r in res] == list(range(10))
    assert s.steals["device"] >= 1, log
    assert all(reason == "steal" for _, _, reason, stolen in log if stolen)


def test_only_unpinned_jobs_are_stolen():
    log = []
    slow = lambda lane: time.sleep(0.02)  # noqa: E731
    jobs = [_job(sched, "port", i, rows=10, pinned="host", reason="mem", body=slow, log=log) for i in range(4)]
    jobs += [_job(sched, "port", 4 + i, rows=10, body=slow, log=log) for i in range(4)]
    s = _sched(sched, _models(sched))
    res = s.run(jobs)
    assert [r["index"] for r in res] == list(range(8))
    assert all(lane == "host" and not stolen for i, lane, _, stolen in log if i < 4)
    assert sum(s.steals.values()) == sum(1 for *_, stolen in log if stolen)


def test_three_lanes_and_job_lanes():
    models = {"device": sched.LaneModel(0.1, 5e-8), "sparse_device": sched.LaneModel(0.0, 1e-7),
              "host": sched.LaneModel(0.0, 1e-6)}
    s = _sched(sched, models)
    three = _job(sched, "port", 0, rows=500_000 // 32, lanes=sched.LANES)
    two = _job(sched, "port", 1, rows=500_000 // 32)
    assert s.plan(three)[0] == "sparse_device" and s.plan(two)[0] == "device"
    res = s.run([three, two])
    assert res[1]["lane"] in ("device", "host")


def test_forced_pin_never_fails_over():
    s = _sched(sched, _models(sched))
    job = _job(sched, "port", 0, pinned="device", reason="forced", fail_on_device=1)
    other = _job(sched, "port", 1, rows=10)
    _, counts = _delta(obs, lambda: pytest.raises(torch.cuda.OutOfMemoryError, s.run, [job, other]))
    assert counts.get("sched.breaker.failures") == 1 and not counts.get("analysis.sched.failover")


def test_lane_failure_fails_over_recorded_threaded():
    s = _sched(sched, _models(sched))
    jobs = [_job(sched, "port", i, rows=4000, v=64, e=256, fail_on_device=1) for i in range(3)]
    jobs.append(_job(sched, "port", 3, rows=10))
    res, counts = _delta(obs, lambda: s.run(jobs))
    assert [r["index"] for r in res] == [0, 1, 2, 3]
    failed = [r for r in sched.sched_snapshot("cpu") if r["failed_over"]]
    assert counts["analysis.sched.failover"] == len(failed) >= 1
    assert all((r["lane"], r["reason"]) == ("host", "failover") for r in failed)


def test_kernel_error_propagates_never_runs_on_host():
    """A kernel's own error (even CUDA's "out of memory" string for
    cudaErrorMemoryAllocation) is not a lane failure: it propagates and the
    host lane never sees the job."""
    lanes = []

    def execute(lane, reason, stolen):
        lanes.append(lane)
        raise KernelError("closure kernel failed: out of memory (cudaError 2)")

    job = sched.Job(index=0, verb="fused", rows=1, v=16, e=16, work=32, execute=execute, pinned="device",
                    reason="mem")
    s = _sched(sched, _models(sched))
    _, counts = _delta(obs, lambda: pytest.raises(KernelError, s.run, [job]))
    assert lanes == ["device"] and not counts.get("analysis.sched.failover")
    assert not counts.get("sched.breaker.failures")


@pytest.mark.parametrize("ex,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB"), True),
    (MemoryError(), True),
    (sched.DispatchTimeout("late"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 8.00 MiB"), True),
    (KernelError("closure kernel failed: out of memory (cudaError 2)"), False),
    (KernelError("edge_wave kernel failed: invalid argument (cudaError 1)"), False),
    (BuildError("g++ failed for nemo_native.cpp (rc 1):\ncc1plus: out of memory allocating 65536 bytes"), False),
    (RuntimeError("CUDA error: out of memory\nCUDA kernel errors might be asynchronously reported"), False),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (ValueError("out of memory"), False),
    (KeyError("device"), False),
])
def test_is_lane_failure(ex, want):
    assert sched.is_lane_failure(ex) is want


def test_accelerator_error_is_not_a_lane_failure():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        pytest.skip("this torch has no AcceleratorError")
    assert not sched.is_lane_failure(accel("CUDA error: out of memory"))


def test_dispatch_deadline_fails_over(monkeypatch):
    monkeypatch.setenv("NEMO_DISPATCH_TIMEOUT_S", "0.05")
    s = _sched(sched, _models(sched))
    job = _job(sched, "port", 0, rows=4000, v=64, e=256,
               body=lambda lane: time.sleep(0.5) if lane != "host" else None)
    res, counts = _delta(obs, lambda: s.run([job], serial=True))
    assert res[0]["lane"] == "host"
    assert counts["watchdog.dispatch_timeout"] == 1 and counts["analysis.sched.failover"] == 1
    assert counts["analysis.sched.lane_failure.device"] == 1


def _breaker_drain(side: str, cooldown_s: float, n: int, sleep_s: float):
    """Host-planned jobs drained threaded under an open breaker: the
    scheduler, its decision records and the breaker's counters."""
    mod = SIDES[side]
    s = _sched(mod, _models(mod), mod.CircuitBreaker(failures=1, cooldown_s=cooldown_s))
    s.breaker.record_failure()
    jobs = [_job(mod, side, i, rows=10, body=lambda lane: time.sleep(sleep_s)) for i in range(n)]
    res, counts = _delta(obs if side == "port" else jax_obs, lambda: s.run(jobs))
    assert [r["index"] for r in res] == list(range(n))
    snap = sched.sched_snapshot("cpu") if side == "port" else jax_sched.sched_snapshot()
    return s, snap[-n:], {k: v for k, v in counts.items() if k.startswith("sched.breaker.")}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_open_breaker_steals_nothing_before_its_cooldown(side):
    """A cooldown longer than the drain: the idle device worker waits,
    steals nothing and takes no probe."""
    s, records, counts = _breaker_drain(side, 1000.0, 8, 0.02)
    assert s.dispatched["device"] == 0 and s.breaker.state == s.breaker.OPEN
    assert "sched.breaker.probe" not in counts and all(r["lane"] == "host" for r in records)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_open_breaker_waits_then_probes(side):
    """Host jobs that outlast a short cooldown: the device worker's first
    steal after it is the one half-open probe, recorded on the device lane
    with reason ``steal``; its success closes the breaker."""
    s, records, counts = _breaker_drain(side, 0.2, 10, 0.1)
    device = [r for r in records if r["lane"] == "device"]
    assert s.breaker.state == s.breaker.CLOSED
    assert counts.get("sched.breaker.probe") == 1 and counts.get("sched.breaker.close") == 1
    assert device and all((r["reason"], r["stolen"], r["planned"]) == ("steal", True, "host") for r in device)


def _card_sched(breaker=None):
    """A scheduler keyed to the card (the key needs no card; the fake jobs
    launch nothing)."""
    s = sched.HeterogeneousScheduler(_models(sched), device="cuda")
    s.breaker = breaker if breaker is not None else sched.CircuitBreaker(failures=99, cooldown_s=1000)
    return s


@pytest.mark.parametrize("serial", [True, False])
def test_on_the_card_a_lane_failure_raises_and_never_reaches_the_host(serial):
    """On the card an out-of-memory error is counted for the breaker and
    raised: the job never runs again on the host, not even an unpinned
    one."""
    log = []
    s = _card_sched()
    assert s.on_card and not _sched(sched, _models(sched)).on_card
    jobs = [_job(sched, "port", 0, rows=4000, v=64, e=256, fail_on_device=1, log=log)]
    jobs.append(_job(sched, "port", 1, rows=10, body=lambda lane: time.sleep(0.05), log=log))
    _, counts = _delta(obs, lambda: pytest.raises(torch.cuda.OutOfMemoryError, s.run, jobs, serial=serial))
    assert [(i, lane) for i, lane, *_ in log if i == 0] == [(0, "device")]
    assert counts["analysis.sched.lane_failure.device"] == counts["sched.breaker.failures"] == 1
    assert not counts.get("analysis.sched.failover") and s.failovers == 0
    assert not any(r["failed_over"] for r in sched.sched_snapshot("cuda"))


def test_on_the_card_an_open_breaker_fails_fast_then_one_run_probes(monkeypatch):
    """An open breaker refuses a run that plans work to the card before
    any job runs (BreakerOpen, a short circuit), lets a host-only run
    through, and after its cooldown lets one run through as the probe:
    every job of it on the card, and its success closes the breaker."""
    clock = [1000.0]
    monkeypatch.setattr(sched.time, "monotonic", lambda: clock[0])
    s = _card_sched(sched.CircuitBreaker(failures=1, cooldown_s=5.0))
    s.breaker.record_failure()
    log = []
    device_jobs = lambda: [_job(sched, "port", i, rows=4000, v=64, e=256, log=log) for i in range(3)]  # noqa: E731
    _, counts = _delta(obs, lambda: pytest.raises(sched.BreakerOpen, s.run, device_jobs(), serial=True))
    assert log == [] and counts["sched.breaker.short_circuit"] == 1 and "analysis.sched.jobs" not in counts
    res = s.run([_job(sched, "port", 0, rows=10, log=log)], serial=True)
    assert res[0]["lane"] == "host" and s.breaker.state == s.breaker.OPEN
    clock[0] += 5.0
    log.clear()
    res, counts = _delta(obs, lambda: s.run(device_jobs(), serial=True))
    assert [r["lane"] for r in res] == ["device"] * 3 and [lane for _, lane, *_ in log] == ["device"] * 3
    assert counts["sched.breaker.probe"] == counts["sched.breaker.close"] == 1
    assert s.breaker.state == s.breaker.CLOSED


def _wait_for_dispatch_threads() -> None:
    for th in threading.enumerate():
        if th.name.startswith("nemo-sched-dispatch-"):
            th.join(timeout=30)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_abandoned_dispatch_records_no_route(device, monkeypatch):
    """A dispatch past the deadline is abandoned (DispatchTimeout): on the
    card it is raised, on the CPU the job fails over to the host.  Either
    way the abandoned dispatch, which later finishes, records no route."""
    monkeypatch.setenv("NEMO_DISPATCH_TIMEOUT_S", "0.05")
    routes = []

    def execute(lane, reason, stolen):
        if lane != "host":
            time.sleep(0.3)
        if sched.claim_dispatch():
            routes.append((lane, reason))
        return lane

    job = sched.Job(index=0, verb="fused", rows=4000, v=64, e=256, work=4000 * 320, execute=execute)
    s = _card_sched() if device == "cuda" else _sched(sched, _models(sched))
    before = obs.metrics.snapshot()
    if device == "cuda":
        with pytest.raises(sched.DispatchTimeout):
            s.run([job], serial=True)
    else:
        assert s.run([job], serial=True) == ["host"]
    _wait_for_dispatch_threads()
    counts = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert routes == ([] if device == "cuda" else [("host", "failover")])
    assert counts["watchdog.dispatch_timeout"] == counts["analysis.sched.lane_failure.device"] == 1
    assert counts.get("analysis.sched.failover", 0) == (device == "cpu")
    assert "analysis.sched.abandoned_error" not in counts


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_abandoned_dispatch_error_is_raised_by_the_next_run(device, monkeypatch):
    """An abandoned dispatch that raises later (a kernel's own error) is
    logged, counted and raised by the device's next run, once."""
    monkeypatch.setenv("NEMO_DISPATCH_TIMEOUT_S", "0.05")

    def execute(lane, reason, stolen):
        if lane != "host":
            time.sleep(0.3)
            raise KernelError("closure kernel failed: an illegal memory access was encountered (cudaError 700)")
        return lane

    job = sched.Job(index=0, verb="fused", rows=4000, v=64, e=256, work=4000 * 320, execute=execute)
    s = _card_sched() if device == "cuda" else _sched(sched, _models(sched))
    before = obs.metrics.snapshot()
    try:
        s.run([job], serial=True)
    except sched.DispatchTimeout:
        assert device == "cuda"
    _wait_for_dispatch_threads()
    ran = []
    ok = _job(sched, "port", 0, rows=10, log=ran)
    with pytest.raises(KernelError, match="illegal memory access"):
        s.run([ok], serial=True)
    assert ran == []
    counts = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert counts["analysis.sched.abandoned_error"] == 1
    assert s.run([ok], serial=True)[0]["lane"] == "host"


def test_a_claimed_dispatch_is_waited_for_not_abandoned(monkeypatch):
    """A dispatch that claimed its result before the deadline has done its
    work: the scheduler waits for it instead of abandoning it."""
    monkeypatch.setenv("NEMO_DISPATCH_TIMEOUT_S", "0.05")

    def execute(lane, reason, stolen):
        assert sched.claim_dispatch()
        time.sleep(0.2)
        return lane

    job = sched.Job(index=0, verb="fused", rows=4000, v=64, e=256, work=4000 * 320, execute=execute)
    _, counts = _delta(obs, lambda: _card_sched().run([job], serial=True))
    assert "watchdog.dispatch_timeout" not in counts and counts["analysis.sched.dispatch.device"] == 1


def test_cpu_and_cuda_never_share_state():
    """Models, breakers and decision tables are keyed by device (no card
    is needed: the key does not resolve it)."""
    assert sched.device_key("cpu") == "cpu" and sched.device_key("cuda") == sched.device_key(None)
    assert sched.session_models("cpu") is sched.session_models("cpu")
    assert sched.session_models("cpu") is not sched.session_models("cuda")
    cpu_br, cuda_br = sched.device_breaker("cpu"), sched.device_breaker("cuda")
    assert cpu_br is not cuda_br
    for _ in range(cpu_br.failures):
        cpu_br.record_failure()
    assert cpu_br.state == cpu_br.OPEN and cuda_br.state == cuda_br.CLOSED
    s = sched.HeterogeneousScheduler(device="cpu")
    assert s.breaker is cpu_br and s.models is sched.session_models("cpu")
    s.breaker = sched.CircuitBreaker(failures=99, cooldown_s=1000)
    s.run([_job(sched, "port", 0, rows=4000, v=64, e=256)], serial=True)
    cuda_walls = sched.session_models("cuda")["device"].per_row
    assert sched.sched_snapshot("cpu") and not sched.sched_snapshot("cuda") and not cuda_walls
    assert s.models["device"].per_row  # the cpu model learned


def test_first_dispatch_once_per_verb_and_device():
    assert sched.first_dispatch("test-verb", "cpu")
    assert not sched.first_dispatch("test-verb", "cpu")
    assert sched.first_dispatch("test-verb", "cuda")


def test_sched_env(monkeypatch):
    monkeypatch.delenv("NEMO_SCHED", raising=False)
    assert sched_env() == "off" and sched.sched_env is sched_env
    for raw, want in (("auto", "auto"), ("on", "on"), ("1", "on"), ("0", "off"), ("OFF", "off")):
        monkeypatch.setenv("NEMO_SCHED", raw)
        assert sched_env() == want == jax_sched.sched_env()
    monkeypatch.setenv("NEMO_SCHED", "bogus")
    with pytest.raises(ValueError):
        sched_env()


def test_backoff_matches_jax():
    from nemo_tpu.utils.backoff import FAILOVER_POLICY as JAX_FAILOVER
    from nemo_tpu.utils.backoff import BackoffPolicy as JaxPolicy

    assert vars(FAILOVER_POLICY) == vars(JAX_FAILOVER)
    for policy, jpolicy in ((FAILOVER_POLICY, JAX_FAILOVER), (BackoffPolicy(budget_s=3.0), JaxPolicy(budget_s=3.0))):
        a, b = policy.session(random.Random(3)), jpolicy.session(random.Random(3))
        seq = [(a.delay(), b.delay()) for _ in range(12)] + [(a.delay(0.5), b.delay(0.5))]
        assert all(x == y for x, y in seq) and seq[-2][0] is None


def test_warm_start_and_fold_back_per_device(tmp_path, monkeypatch):
    """A cpu profile's ewma seeds the cpu session's models (the JAX
    package's key format); at fold-back the cpu walls merge into that file
    and nowhere else; a cuda session (no profile warm-started it) folds
    nothing."""
    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path))
    pp.reset_active_profile()
    prof = pp.PlatformProfile(pp.platform_fingerprint("cpu"))
    key = jax_pp._ewma_key("fused", 16, 16)
    assert key == pp._ewma_key("fused", 16, 16)
    prof.ewma = {"host": {key: 2e-5, "junk": 1.0}}
    path = prof.save()
    try:
        _, counts = _delta(obs, lambda: sched.session_models("cpu"))
        models = sched.session_models("cpu")
        assert models["host"].per_row == {("fused", 16, 16): 2e-5}
        assert counts["profile.ewma_warm_start"] == 1
        # A card's session (no profile warm-started it): never folded.
        sched._SESSION_MODELS[sched.device_key("cuda")] = {"device": sched.LaneModel(0.1, 5e-8)}
        sched._SESSION_MODELS[sched.device_key("cuda")]["device"].per_row[("fused", 64, 64)] = 1.0
        models["device"].observe(_job(sched, "port", 0, rows=8, v=32, e=32), 0.5)
        _, counts = _delta(obs, pp.fold_back_session)
        with open(path) as fh:
            doc = json.load(fh)
        assert doc["ewma"]["host"][key] == 2e-5
        assert set(doc["ewma"]["device"]) == {"fused|32|32"}
        assert counts["profile.fold_back"] == 2
        files = sorted(p.name for p in tmp_path.iterdir())
        assert files == [path.rsplit("/", 1)[-1]]
    finally:
        pp.reset_active_profile()


def test_failed_fold_back_is_counted_and_raised(tmp_path, monkeypatch):
    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path))
    pp.reset_active_profile()
    pp.PlatformProfile(pp.platform_fingerprint("cpu")).save()
    try:
        sched.session_models("cpu")["host"].per_row[("fused", 16, 16)] = 1e-5

        def broken_save(self):
            raise OSError("disk full")

        monkeypatch.setattr(pp.PlatformProfile, "save", broken_save)
        before = obs.metrics.snapshot()
        with pytest.raises(OSError, match="disk full"):
            pp.fold_back_session()
        counts = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
        assert counts["profile.fold_back_error"] == 1
    finally:
        pp.reset_active_profile()


def test_shared_counters_lose_no_update():
    """Eight threads bumping the counters the lanes share, with a short
    switch interval: every increment lands."""
    from nemo_tpu_torch.backend.torch_backend import TorchExecutor

    def wrapper():
        pass

    wrapper.launches = 0
    ex = TorchExecutor("cpu")
    n, threads = 2000, 8

    def bump():
        for _ in range(n):
            count_launch(wrapper)
            ex.count_host("sparse_fused")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert wrapper.launches == ex.host_runs["sparse_fused"] == n * threads
