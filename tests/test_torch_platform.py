"""The port's platform profile (nemo_tpu_torch/platform, utils/prewarm.py)
against the JAX package's, on the CPU.  No tolerance: exact equality.

* the fingerprint's keys and key, and its change with the device type,
  the torch version and the analysis ABI;
* the invalidation matrix of tests/test_profile.py on the port: first
  contact calibrates once then loads, a fingerprint change recalibrates, a
  corrupt file stays seeded and ``force`` recalibrates, one cached profile
  per fingerprint, an argument wins without suppressing the measurement,
  ``off`` (the default) leaves every budget at its seed, a failed probe
  raises;
* the fit: both packages' ``run_calibration`` with their probes replaced
  by the same walls give the same constants; on a (faked) card a device
  slope at or above the host unit is probed again, and when no round is
  sound the slope stays seeded: the JAX package's one-width fit;
* under one measured profile (the same constants in each package's own
  profile file), equal route records (the JAX side under
  ``NEMO_ANALYSIS_IMPL=crossover``, as tests/test_torch_routes.py runs it)
  and equal report trees, on a family and a synthetic corpus; the derived
  query crossover picks the JAX scheduler's lane at the crossover and one
  unit on either side;
* telemetry.json's ``platform_profile`` section, the report's own
  backend's also on a report-cache hit; one real calibration on
  the CPU (the plain K1) inside its budget, then a warm load with no probe
  dispatch; ``--calibrate`` and ``--profile-mode`` in the port's CLI;
  ``stress_signature`` equal to the JAX package's, value for value, and
  the prewarm CLI.

The JAX side keeps its dense step sharded (the suite's default), and each
test resets both packages' loaded profiles before and after itself.
"""

import json
import os

import numpy as np
import pytest
import torch

import nemo_tpu.platform.calibrate as jax_cal
from nemo_tpu.analysis.pipeline import report_tree_bytes as jax_tree
from nemo_tpu.analysis.pipeline import run_debug as jax_run_debug
from nemo_tpu.analysis.synth import synth_impl_env
from nemo_tpu.backend.jax_backend import JaxBackend
from nemo_tpu.ingest.molly import load_molly_output as jax_load
from nemo_tpu.parallel.sched import HeterogeneousScheduler, Job, default_models
from nemo_tpu.platform import profile as jax_pp
from nemo_tpu.report.writer import Reporter as JaxReporter
from nemo_tpu.utils.prewarm import stress_signature as jax_stress_signature
from nemo_tpu_torch import cli, obs
from nemo_tpu_torch.analysis import delta
from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
from nemo_tpu_torch.backend.torch_backend import TorchBackend
from nemo_tpu_torch.ingest.molly import load_molly_output as port_load
from nemo_tpu_torch.models.case_studies import CASE_STUDIES, write_case_study
from nemo_tpu_torch.models.synth import SynthSpec, write_corpus
from nemo_tpu_torch.platform import calibrate as cal
from nemo_tpu_torch.platform import fingerprint as fpmod
from nemo_tpu_torch.platform import profile as pp
from nemo_tpu_torch.query.engine import QUERY_HOST_WORK, derived_query_host_work, query_lane
from nemo_tpu_torch.utils import prewarm

#: The budgets TorchBackend ran on before the profile: the seeds.
SEEDED_KNOBS = {"analysis_host_work": 100_000, "diff_host_work": 2_000_000, "synth_host_work": 100_000,
                "sparse_device_mem_bytes": 256_000_000, "sparse_device_density": 1.0 / 256.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def prof_env(tmp_path, monkeypatch):
    """NEMO_PROFILE=auto with a throwaway profile directory; both packages'
    loaded profiles reset around the test (the suite runs with off)."""
    monkeypatch.setenv("NEMO_PROFILE", "auto")
    monkeypatch.setenv("NEMO_PROFILE_DIR", str(tmp_path / "plat"))
    pp.reset_active_profile()
    jax_pp.reset_active_profile()
    yield tmp_path
    pp.reset_active_profile()
    jax_pp.reset_active_profile()


@pytest.fixture()
def jax_device_auto(monkeypatch):
    """The JAX side's device-backend routing, serial (tests/test_torch_routes.py)."""
    for name, value in (("NEMO_ANALYSIS_IMPL", "crossover"), ("NEMO_GIANT_IMPL", "sparse_device"),
                        ("NEMO_SCHED", "off")):
        monkeypatch.setenv(name, value)
    for name in ("NEMO_ANALYSIS_HOST_WORK", "NEMO_DIFF_HOST_WORK", "NEMO_SYNTH_HOST_WORK", "NEMO_SYNTH_IMPL",
                 "NEMO_SPARSE_DEVICE_MEM_MB", "NEMO_SPARSE_DEVICE_DENSITY", "NEMO_GIANT_V",
                 "NEMO_SCHED_HOST_UNIT", "NEMO_SCHED_DEVICE_UNIT", "NEMO_SCHED_SPARSE_DEVICE_UNIT",
                 "NEMO_SCHED_DEVICE_FIXED"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(JaxBackend, "_resolve_synth_impl", lambda self: synth_impl_env())


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("platform"))
    return {
        "family": write_case_study("ZK-1270-racing-sent-flag", 12, 0, root),
        "mix": write_corpus(SynthSpec(n_runs=60, seed=6, eot=20, name="mix"), root),
    }


def _fake_profile(mod, fp: dict, **consts):
    prof = mod.PlatformProfile(fp)
    prof.calibration_wall_s = 0.01
    for name, val in consts.items():
        prof.set_constant(name, val)
    return prof


def _save_both(**consts) -> None:
    """The same measured constants in each package's own profile file."""
    _fake_profile(pp, pp.platform_fingerprint("cpu"), **consts).save()
    _fake_profile(jax_pp, jax_pp.platform_fingerprint(), **consts).save()


def _fake_calibration(monkeypatch, **consts) -> list:
    """Replace the port's probe suite with an instant fit."""
    calls = []

    def fake(device=None):
        calls.append(1)
        prof = _fake_profile(pp, pp.platform_fingerprint(device), **consts)
        prof.probes["build_wall_s"] = 0.0
        return prof

    monkeypatch.setattr(cal, "run_calibration", fake)
    return calls


def _counters(fn):
    before = obs.metrics.snapshot()
    out = fn()
    return out, obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------


def test_fingerprint_keys_and_key(monkeypatch):
    fp = pp.platform_fingerprint("cpu")
    assert sorted(fp) == ["analysis_abi", "cuda_version", "device_count", "device_kind", "kernels", "platform",
                          "torch_version"]
    assert (fp["platform"], fp["device_kind"], fp["device_count"]) == ("cpu", "cpu", 1)
    assert fp["torch_version"] == torch.__version__ and fp["cuda_version"] == torch.version.cuda
    assert fp["analysis_abi"] == delta.ANALYSIS_ABI_VERSION
    from nemo_tpu_torch.kernels import build

    assert fp["kernels"] == {n: build.library_path(n).stem.rsplit("_", 1)[1] for n in build.SOURCES}
    key = fpmod.fingerprint_key(fp)
    assert len(key) == 16 and key == fpmod.fingerprint_key(dict(reversed(list(fp.items()))))
    # The reference's key function, on the same dict, gives the same key.
    from nemo_tpu.platform.fingerprint import fingerprint_key as jax_key

    assert jax_key(fp) == key

    # Cached a process: a copy of one computation until cleared.
    assert pp.platform_fingerprint("cpu") == fp and pp.platform_fingerprint("cpu") is not fp

    keys = {key}
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")
    assert pp.platform_fingerprint("cpu") == fp
    fpmod.clear_fingerprints()
    keys.add(fpmod.fingerprint_key(pp.platform_fingerprint("cpu")))
    monkeypatch.setattr(delta, "ANALYSIS_ABI_VERSION", delta.ANALYSIS_ABI_VERSION + 1)
    fpmod.clear_fingerprints()
    keys.add(fpmod.fingerprint_key(pp.platform_fingerprint("cpu")))
    # A card (faked): another platform, its name and count.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda_fp = pp.platform_fingerprint("cuda")
    assert (cuda_fp["platform"], cuda_fp["device_kind"]) == ("cuda", "NVIDIA H100 80GB HBM3")
    keys.add(fpmod.fingerprint_key(cuda_fp))
    assert len(keys) == 4
    fpmod.clear_fingerprints()


# ---------------------------------------------------------------------------
# the invalidation matrix
# ---------------------------------------------------------------------------


def test_first_contact_calibrates_once_then_loads(prof_env, monkeypatch):
    calls = _fake_calibration(monkeypatch, analysis_host_work=12345.0)
    prof, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert prof is not None and calls == [1] and os.path.isfile(pp.profile_path(prof.key))
    assert c.get("profile.calibrated") == 1
    assert pp.profile_value("analysis_host_work", "cpu") == 12345.0
    # Another process (the globals reset) loads the file: no calibration.
    pp.reset_active_profile()
    again, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert again.key == prof.key and calls == [1]
    assert c.get("profile.loaded") == 1 and not c.get("profile.calibrated")


def test_fingerprint_change_recalibrates(prof_env, monkeypatch):
    calls = _fake_calibration(monkeypatch, analysis_host_work=12345.0)
    key_a = pp.ensure_calibrated("cpu").key
    fp_b = dict(pp.platform_fingerprint("cpu"), torch_version="0.0.0-other")
    monkeypatch.setattr(pp, "platform_fingerprint", lambda device=None: fp_b)
    monkeypatch.setattr(cal, "run_calibration", lambda device=None: (calls.append(1), _fake_profile(pp, fp_b))[1])
    prof_b, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert calls == [1, 1] and prof_b.key != key_a
    assert os.path.isfile(pp.profile_path(prof_b.key)) and c.get("profile.calibrated") == 1


def test_one_profile_per_fingerprint(prof_env, monkeypatch):
    """Two devices' fingerprints in one process each keep their own profile
    (the reference keeps one a process)."""
    fps = {"cpu": pp.platform_fingerprint("cpu")}
    fps["card"] = dict(fps["cpu"], platform="cuda", device_kind="a card")
    monkeypatch.setattr(pp, "platform_fingerprint", lambda device=None: fps[device])
    _fake_profile(pp, fps["cpu"], analysis_host_work=111.0).save()
    _fake_profile(pp, fps["card"], analysis_host_work=222.0).save()
    assert pp.profile_value("analysis_host_work", "cpu") == 111.0
    assert pp.profile_value("analysis_host_work", "card") == 222.0
    assert pp.profile_value("analysis_host_work", "cpu") == 111.0


def test_corrupt_profile_stays_seeded_and_force_recalibrates(prof_env, monkeypatch):
    calls = _fake_calibration(monkeypatch, analysis_host_work=12345.0)
    key = pp.ensure_calibrated("cpu").key
    with open(pp.profile_path(key), "w", encoding="utf-8") as f:
        f.write("{ not json")
    pp.reset_active_profile()
    prof, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert prof is None and calls == [1] and c.get("profile.stale") == 1 and not c.get("profile.calibrated")
    assert pp.profile_value("analysis_host_work", "cpu") is None
    # A schema bump reads as corrupt too.
    doc = _fake_profile(pp, pp.platform_fingerprint("cpu"), analysis_host_work=1.0).to_doc()
    doc["abi"] = pp.PROFILE_ABI_VERSION + 1
    with open(pp.profile_path(key), "w", encoding="utf-8") as f:
        json.dump(doc, f)
    pp.reset_active_profile()
    assert pp.active_profile("cpu") is None and calls == [1]
    # force calibrates over it, once a process.
    forced, c = _counters(lambda: pp.ensure_calibrated("cpu", force=True))
    assert forced.measured_value("analysis_host_work") == 12345.0 and calls == [1, 1]
    assert c.get("profile.calibrated") == 1
    assert pp.ensure_calibrated("cpu", force=True) is forced and calls == [1, 1]
    monkeypatch.setenv("NEMO_PROFILE", "force")
    pp.reset_active_profile()
    pp.ensure_calibrated("cpu")
    assert calls == [1, 1, 1]


def test_argument_wins_without_suppressing_the_measurement(prof_env, monkeypatch, corpora):
    _fake_calibration(monkeypatch, analysis_host_work=12345.0, sparse_device_mem_mb=64.0)
    b = TorchBackend(device="cpu")
    b.init_graph_db("", port_load(corpora["family"]))
    assert (b.analysis_host_work, b.sparse_device_mem_bytes) == (12345, 64_000_000)
    assert b.diff_host_work == SEEDED_KNOBS["diff_host_work"]
    b = TorchBackend(device="cpu", analysis_host_work=777, sparse_device_mem_bytes=1000)
    b.init_graph_db("", port_load(corpora["family"]))
    assert (b.analysis_host_work, b.sparse_device_mem_bytes) == (777, 1000)
    rows = {r["name"]: r for r in pp.constant_sources("cpu", b.profile_args())}
    assert (rows["analysis_host_work"]["source"], rows["analysis_host_work"]["value"]) == ("arg", 777)
    assert rows["analysis_host_work"]["measured"] == 12345.0
    assert (rows["sparse_device_mem_mb"]["source"], rows["sparse_device_mem_mb"]["measured"]) == ("arg", 64.0)
    assert rows["diff_host_work"]["source"] == "seeded"
    # The stream clone passes on what was given, not what was resolved.
    clone = b.stream_clone()
    clone.init_graph_db("", port_load(corpora["family"]))
    assert (clone.analysis_host_work, clone.sparse_device_mem_bytes, clone.synth_host_work) == (777, 1000, 100_000)


def test_off_leaves_every_budget_seeded(prof_env, monkeypatch, corpora):
    calls = _fake_calibration(monkeypatch, analysis_host_work=12345.0, diff_host_work=5.0, synth_host_work=6.0,
                              sparse_device_mem_mb=1.0, sparse_device_density=0.5, sched_host_unit=1e-3)
    pp.ensure_calibrated("cpu")
    pp.reset_active_profile()
    monkeypatch.setenv("NEMO_PROFILE", "off")
    b = TorchBackend(device="cpu")
    _, c = _counters(lambda: b.init_graph_db("", port_load(corpora["family"])))
    assert {k: getattr(b, k) for k in SEEDED_KNOBS} == SEEDED_KNOBS
    assert type(b.analysis_host_work) is int and type(b.sparse_device_density) is float
    assert derived_query_host_work("cpu") == QUERY_HOST_WORK == 126_667
    assert calls == [1] and pp.active_profile("cpu") is None
    assert not any(k.startswith("profile.") for k in c)
    assert pp.telemetry_section()["mode"] == "off"
    assert {r["source"] for r in pp.constant_sources("cpu")} == {"seeded"}
    # Neither NEMO_PROFILE nor --profile-mode: off as well.
    monkeypatch.delenv("NEMO_PROFILE")
    assert pp.profile_mode() == pp.DEFAULT_MODE == "off"
    b = TorchBackend(device="cpu")
    _, c = _counters(lambda: b.init_graph_db("", port_load(corpora["family"])))
    assert {k: getattr(b, k) for k in SEEDED_KNOBS} == SEEDED_KNOBS and calls == [1]
    assert not any(k.startswith("profile.") for k in c)


def test_failed_probe_raises(prof_env, monkeypatch, corpora):
    def broken(device=None):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(cal, "run_calibration", broken)
    before = obs.metrics.snapshot()
    with pytest.raises(RuntimeError, match="launch failed"):
        pp.ensure_calibrated("cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        TorchBackend(device="cpu").init_graph_db("", port_load(corpora["family"]))
    c = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    assert c.get("profile.error") == 2 and not c.get("profile.calibrated")
    assert not (prof_env / "plat").exists()


# ---------------------------------------------------------------------------
# the fit against the JAX package's
# ---------------------------------------------------------------------------

FIT_CASES = {
    "two_widths": ([0.004, 0.0052], 0.003, 20000.0),
    "flat_device": ([0.006, 0.0055], 0.0021, None),
    "one_width": ([0.009], 0.0009, 81000.0),
    "host_faster_than_device_slope": ([0.001, 0.9], 1e-9, None),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax(monkeypatch, case):
    warm, host_wall, mem_mb = FIT_CASES[case]

    def fake_fused(b_pad, deadline, *device):
        i = cal._PROBE_WIDTHS.index(b_pad)
        if i >= len(warm):
            return None
        return {"b": b_pad, "v": 64, "e": 256, "work": b_pad * 320, "cold_s": 0.5 + i, "warm_s": warm[i],
                "arrays": None}

    host = {"work": cal._PROBE_WIDTHS[len(warm) - 1] * 320, "wall_s": host_wall}
    monkeypatch.setattr(jax_cal, "_probe_transfer", lambda prof: None)
    monkeypatch.setattr(jax_cal, "_probe_fused", fake_fused)
    monkeypatch.setattr(jax_cal, "_probe_host", lambda p: dict(host))
    monkeypatch.setattr(jax_cal, "_flops_rate", lambda p: None)
    monkeypatch.setattr(jax_cal, "_device_mem_mb", lambda: mem_mb)
    monkeypatch.setattr(cal, "_probe_build", lambda prof, dev: prof.probes.update(build_wall_s=0.0))
    monkeypatch.setattr(cal, "_probe_transfer", lambda prof, dev: None)
    monkeypatch.setattr(cal, "_probe_fused", fake_fused)
    monkeypatch.setattr(cal, "_probe_host", lambda p: dict(host))
    monkeypatch.setattr(cal, "_device_mem_mb", lambda dev: mem_mb)
    assert (cal._PROBE_RUNS, cal._PROBE_WIDTHS, cal._WARM_REPS, cal._TRANSFER_MB) == (
        jax_cal._PROBE_RUNS, jax_cal._PROBE_WIDTHS, jax_cal._WARM_REPS, jax_cal._TRANSFER_MB)
    mine, theirs = cal.run_calibration("cpu"), jax_cal.run_calibration()
    assert mine.constants == theirs.constants
    assert {k: v for k, v in mine.probes.items() if k != "build_wall_s"} == theirs.probes
    assert set(mine.constants) == set(pp.CONSTANTS) - {"sched_flops_per_s"}


#: Rounds of (warm walls at B=8 and 32, host wall) the faked card's
#: probes give: a slope of 3.9e-7 s a unit against a host unit of 9.8e-8
#: is degenerate; 1.3e-8 is sound.  The last case's host unit (3.9e-8) is
#: not above even the seeded slope.
DEGENERATE_ROUNDS = {
    "sound_on_the_second_round": [([0.006, 0.009], 0.001), ([0.006, 0.0061], 0.001)],
    "never_sound": [([0.006, 0.009], 0.001), ([0.006, 0.0092], 0.001), ([0.0061, 0.0094], 0.001)],
    "host_below_the_seeded_slope": [([0.006, 0.009], 0.0004)] * 3,
}


@pytest.mark.parametrize("case", sorted(DEGENERATE_ROUNDS))
def test_degenerate_fit_on_the_card_is_probed_again(prof_env, monkeypatch, case):
    """On a card a device slope at or above the host unit is noise, not a
    crossover: the probes run again.  A sound round is fitted as the JAX
    package fits its walls; when none of three is, the slope stays seeded
    and the narrow width gives the intercept, as the JAX package fits one
    width; a host unit not above the seeded slope raises, nothing saved."""
    rounds = DEGENERATE_ROUNDS[case]
    at = [-1]

    def fake_fused(b_pad, deadline, *device):
        i = cal._PROBE_WIDTHS.index(b_pad)
        at[0] += i == 0
        return {"b": b_pad, "v": 64, "e": 256, "work": b_pad * 320, "cold_s": 0.5, "warm_s": rounds[at[0]][0][i],
                "arrays": None}

    def fake_host(p):
        return {"work": p["work"], "wall_s": rounds[at[0]][1]}

    card_fp = dict(pp.platform_fingerprint("cpu"), platform="cuda", device_kind="a card")
    monkeypatch.setattr(cal, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(cal, "platform_fingerprint", lambda device=None: card_fp)
    monkeypatch.setattr(cal, "_probe_build", lambda prof, dev: prof.probes.update(build_wall_s=0.0))
    monkeypatch.setattr(cal, "_probe_transfer", lambda prof, dev: None)
    monkeypatch.setattr(cal, "_probe_fused", fake_fused)
    monkeypatch.setattr(cal, "_probe_host", fake_host)
    monkeypatch.setattr(cal, "_device_mem_mb", lambda dev: 20000.0)
    if case == "host_below_the_seeded_slope":
        with pytest.raises(RuntimeError, match="degenerate fit"):
            _counters(lambda: pp.ensure_calibrated("cpu"))
        assert at[0] == cal._FIT_ATTEMPTS - 1 and not (prof_env / "plat").exists()
        return
    prof = cal.run_calibration("cpu")
    n_rejected = len(rounds) - 1 if case == "sound_on_the_second_round" else len(rounds)
    assert at[0] == len(rounds) - 1 and len(prof.probes["rejected_fits"]) == n_rejected
    for rej, (warm, _) in zip(prof.probes["rejected_fits"], rounds):
        assert rej["device_unit"] >= rej["host_unit"] and [p["warm_s"] for p in rej["fused"]] == warm
    assert [p["warm_s"] for p in prof.probes["fused"]] == rounds[-1][0]
    # The fit is the reference's on the last round's walls: both widths of
    # a sound round, else the narrow width alone with the host unit kept.
    (warm, host_wall), at[0] = rounds[-1], -1
    widths = 2 if case == "sound_on_the_second_round" else 1
    host_work = cal._PROBE_WIDTHS[widths - 1] * 320
    monkeypatch.setattr(jax_cal, "_probe_transfer", lambda prof: None)
    monkeypatch.setattr(jax_cal, "_probe_fused", lambda b_pad, deadline: None if cal._PROBE_WIDTHS.index(
        b_pad) >= widths else fake_fused(b_pad, deadline) | {"warm_s": warm[cal._PROBE_WIDTHS.index(b_pad)]})
    monkeypatch.setattr(jax_cal, "_probe_host", lambda p: {"work": host_work,
                                                           "wall_s": host_wall * host_work / (32 * 320)})
    monkeypatch.setattr(jax_cal, "_flops_rate", lambda p: None)
    monkeypatch.setattr(jax_cal, "_device_mem_mb", lambda: 20000.0)
    assert prof.constants == jax_cal.run_calibration().constants
    assert prof.constants["sched_device_unit"]["measured"] is (widths == 2)
    assert 1_000 < prof.measured_value("analysis_host_work") < 100_000_000
    if case == "never_sound":
        at[0] = -1
        saved, c = _counters(lambda: pp.ensure_calibrated("cpu"))
        assert c.get("profile.calibrated") == 1 and os.path.isfile(pp.profile_path(saved.key))


def test_constants_table_matches_jax():
    assert {n: (seed, group) for n, (_, seed, group) in pp.CONSTANTS.items()} == {
        n: (seed, group) for n, (_, seed, group) in jax_pp.CONSTANTS.items()}
    assert pp.PROFILE_ABI_VERSION == jax_pp.PROFILE_ABI_VERSION
    assert pp.SEEDED["analysis_host_work"] == SEEDED_KNOBS["analysis_host_work"]


# ---------------------------------------------------------------------------
# routes, reports and the query crossover under one measured profile
# ---------------------------------------------------------------------------


def _drive(backend, molly) -> list[dict]:
    backend.init_graph_db("", molly)
    backend.load_raw_provenance()
    backend.simplify_prov(molly.get_runs_iters())
    failed = molly.get_failed_runs_iters()
    if failed and molly.get_success_runs_iters():
        backend.create_naive_diff_prov(False, failed, None, dot_iters=[])
    backend.synth_candidates(molly.get_runs_iters())
    return list(backend.analysis_routes)


def _measured_budgets(corpus: str) -> dict:
    """Budgets between the corpus's bucket works and at its diff's work, so
    that the measured routes differ from the seeded ones on both sides."""
    with pp.mode_override("off"):
        seeded = _drive(TorchBackend(device="cpu", diff_host_work=0), port_load(corpus))
    works = sorted(r["work"] for r in seeded if r["verb"] == "fused")
    (diff_work,) = [r["work"] for r in seeded if r["verb"] == "diff"]
    mid = float(works[len(works) // 2]) if len(works) > 1 else float(works[0] - 1)
    return {"analysis_host_work": mid, "synth_host_work": mid, "diff_host_work": float(diff_work - 1),
            "sparse_device_mem_mb": 300.0, "sparse_device_density": 1.0 / 512.0}


@pytest.mark.parametrize("corpus", ["family", "mix"])
def test_routes_and_report_under_one_measured_profile_match_jax(prof_env, jax_device_auto, corpora, corpus,
                                                                tmp_path):
    consts = _measured_budgets(corpora[corpus])
    _save_both(**consts)
    port = _drive(TorchBackend(device="cpu"), port_load(corpora[corpus]))
    jax = _drive(JaxBackend(), jax_load(corpora[corpus]))
    assert port == jax
    assert ("diff", "dense") in {(r["verb"], r["route"]) for r in port}
    with pp.mode_override("off"):
        seeded = _drive(TorchBackend(device="cpu"), port_load(corpora[corpus]))
    assert seeded != port
    res = run_debug(corpora[corpus], str(tmp_path / "port"), TorchBackend(device="cpu"), figures="all")
    jres = jax_run_debug(corpora[corpus], str(tmp_path / "jax"), JaxBackend(), reporter=JaxReporter(), figures="all",
                         ingest="python", corpus_cache="off", result_cache="off")
    got, want = report_tree_bytes(res.report_dir), jax_tree(jres.report_dir)
    assert sorted(got) == sorted(want) and [k for k in want if got[k] != want[k]] == []
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        sect = json.load(fh)["platform_profile"]
    rows = {r["name"]: r for r in sect["constants"]}
    assert sect["mode"] == "auto" and sect["key"] == fpmod.fingerprint_key(pp.platform_fingerprint("cpu"))
    assert rows["analysis_host_work"] == {"name": "analysis_host_work", "arg": "analysis_host_work", "group": "routing",
                                          "source": "measured", "value": consts["analysis_host_work"],
                                          "measured": consts["analysis_host_work"]}
    assert rows["sched_flops_per_s"]["source"] == "seeded"


def _jax_plan_lane(work: int) -> str:
    job = Job(index=0, verb="query", rows=1, v=16, e=16, work=work, execute=lambda *a: {},
              lanes=("sparse_device", "host"), source="query")
    return HeterogeneousScheduler(models=default_models()).plan(job)[0]


QUERY_PROFILES = {
    "seeded": {},
    "measured_fixed": {"sched_host_unit": 3.1e-7, "sched_device_unit": 1e-12, "sched_sparse_device_unit": 5e-12,
                       "sched_device_fixed": 0.0047},
    "derived_fixed": {"sched_host_unit": 4.2e-7, "analysis_host_work": 31234.0},
    "units_only": {"sched_host_unit": 7e-7, "sched_device_unit": 3e-8, "sched_sparse_device_unit": 1.5e-7},
    "never_crosses": {"sched_host_unit": 2.2e-7, "analysis_host_work": 31234.0},
}


@pytest.mark.parametrize("name", sorted(QUERY_PROFILES))
def test_derived_query_crossover_matches_the_jax_scheduler(prof_env, jax_device_auto, name):
    _save_both(**QUERY_PROFILES[name])
    cross = derived_query_host_work("cpu")
    if not QUERY_PROFILES[name]:
        assert cross == QUERY_HOST_WORK
    if name == "never_crosses":  # host 2.2e-7 a unit against sparse_device's 2.5e-7
        assert cross == 2**63 - 1 and {_jax_plan_lane(w) for w in (1, 10**6, 10**12)} == {"host"}
        return
    assert 1 < cross < 10**9
    for work in (cross - 1, cross, cross + 1):
        assert query_lane(work, cross) == _jax_plan_lane(work), (work, cross)
    assert (query_lane(cross - 1, cross), query_lane(cross, cross)) == ("host", "sparse_device")


def test_query_follows_the_measured_crossover(prof_env, corpora):
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus
    from nemo_tpu_torch.query.lang import parse_query

    q = parse_query("from pre match goal[holds=false] -*-> @rule[type=async] count by table")
    molly = ingest_corpus(corpora["family"], "off")
    seeded_routes, routes = [], []
    with pp.mode_override("off"):
        seeded = execute_query(q, molly, device="cpu", use_cache=False, routes=seeded_routes)
    _save_both(sched_host_unit=1e-3, sched_device_fixed=1e-6)  # crossover 1
    measured = execute_query(q, molly, device="cpu", use_cache=False, routes=routes)
    assert {r["lane"] for r in seeded_routes} == {"host"} and {r["lane"] for r in routes} == {"sparse_device"}
    assert {k: v for k, v in measured.items() if k != "stats"} == {k: v for k, v in seeded.items() if k != "stats"}


# ---------------------------------------------------------------------------
# a real calibration, the CLI, prewarm
# ---------------------------------------------------------------------------


def test_real_calibration_on_the_cpu_is_bounded_then_loads(prof_env):
    prof, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert prof is not None and prof.calibration_wall_s < pp.profile_budget_s() + 2.0
    assert c.get("profile.calibrated") == 1 and c.get("profile.probe.dispatches", 0) >= 2
    assert c.get("kernel.dispatches.fused") == c["profile.probe.dispatches"]
    for name in ("sched_host_unit", "sched_device_unit", "sched_device_fixed", "analysis_host_work",
                 "diff_host_work", "synth_host_work"):
        assert prof.measured_value(name) is not None, name
    assert prof.measured_value("sparse_device_mem_mb") is None  # seeded on the CPU
    assert [p["b"] for p in prof.probes["fused"]] == [8, 32] and prof.probes["build_wall_s"] >= 0
    pp.reset_active_profile()
    again, c = _counters(lambda: pp.ensure_calibrated("cpu"))
    assert again.key == prof.key and again.constants == prof.constants
    assert c.get("profile.loaded") == 1 and not c.get("profile.probe.dispatches")
    assert not any(k.startswith("kernel.dispatches") for k in c)


def test_cli_calibrate_and_profile_mode(prof_env, monkeypatch, capsys, corpora):
    calls = _fake_calibration(monkeypatch, analysis_host_work=4321.0)
    assert cli.main(["--calibrate", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "calibrated in" in out and "analysis_host_work = 4321.0 [measured]" in out
    assert "diff_host_work = 2000000 [seeded]" in out
    assert cli.main(["--calibrate", "--device", "cpu", "--profile-mode", "off"]) == 2
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])
    # --profile-mode off: the report routes on the seeded budgets.
    res_dir = str(prof_env / "R")
    for mode, value, source in (("off", 100000, "seeded"), ("auto", 4321.0, "measured")):
        assert cli.main(["-faultInjOut", corpora["family"], "--device", "cpu", "--results-dir", res_dir,
                         "--figures", "none", "--corpus-cache", "off", "--result-cache", "off",
                         "--profile-mode", mode]) == 0
        with open(os.path.join(res_dir, "ZK-1270-racing-sent-flag", "telemetry.json"), encoding="utf-8") as fh:
            sect = json.load(fh)["platform_profile"]
        row = {r["name"]: r for r in sect["constants"]}["analysis_host_work"]
        assert (sect["mode"], row["value"], row["source"]) == (mode, value, source)
    assert pp.profile_mode() == "auto"
    # Neither NEMO_PROFILE nor --profile-mode: --calibrate still calibrates.
    monkeypatch.delenv("NEMO_PROFILE")
    pp.reset_active_profile()
    n = len(calls)
    assert cli.main(["--calibrate", "--device", "cpu"]) == 0 and len(calls) == n + 1
    assert "analysis_host_work = 4321.0 [measured]" in capsys.readouterr().out
    assert pp.profile_mode() == "off"


def test_telemetry_is_the_reports_own_backends_on_a_cache_hit(prof_env, corpora, tmp_path):
    """A report-cache hit never initializes its backend; its telemetry.json
    still names the constants of that backend's device and arguments, not
    those of whichever backend resolved last in the process."""
    _save_both(analysis_host_work=999.0)
    kw = {"figures": "none", "corpus_cache": str(tmp_path / "cc"), "result_cache": str(tmp_path / "rc")}
    run_debug(corpora["family"], str(tmp_path / "a"), TorchBackend(device="cpu"), **kw)
    for root, arg, want in (("b", None, (999.0, "measured")), ("c", 321, (321, "arg"))):
        # Another backend resolves, with an argument, in between.
        TorchBackend(device="cpu", analysis_host_work=555).init_graph_db("", port_load(corpora["family"]))
        res = run_debug(corpora["family"], str(tmp_path / root), TorchBackend(device="cpu", analysis_host_work=arg),
                        **kw)
        assert res.result_cache["state"] == "report_hit"
        with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
            rows = {r["name"]: r for r in json.load(fh)["platform_profile"]["constants"]}
        assert (rows["analysis_host_work"]["value"], rows["analysis_host_work"]["source"]) == want
        assert rows["analysis_host_work"]["measured"] == 999.0


def test_stress_signature_matches_jax(monkeypatch):
    monkeypatch.setenv("NEMO_NARROW_XFER", "0")
    for name in sorted(CASE_STUDIES)[:2]:
        pre, post, static = prewarm.stress_signature(name, 8, 32)
        jpre, jpost, jstatic = jax_stress_signature(name, 8, 32)
        assert static == {k: v for k, v in jstatic.items() if k != "pack_out"}
        for mine, theirs in ((pre, jpre), (post, jpost)):
            for f in mine.FIELDS:
                a, b = np.asarray(getattr(mine, f)), np.asarray(getattr(theirs, f))
                assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), (name, f)
    with pytest.raises(ValueError):
        prewarm.stress_signature(sorted(CASE_STUDIES)[0], 64, 32)


def test_prewarm_cli_on_the_cpu(capsys):
    assert prewarm.main(["--device", "cpu", "--runs-per-family", "16", "--probe-runs", "8"]) == 0
    out = capsys.readouterr().out
    assert all(f"  {name}: fused step at B=16" in out for name in CASE_STUDIES)
    assert "prewarm done" in out


def test_flight_bundle_embeds_the_profile(prof_env, tmp_path, corpora):
    from nemo_tpu_torch.obs import flight

    _save_both(analysis_host_work=999.0)
    TorchBackend(device="cpu").init_graph_db("", port_load(corpora["family"]))
    path = flight.FlightRecorder(str(tmp_path / "fr")).trigger("manual")
    with open(path, encoding="utf-8") as fh:
        sect = json.load(fh)["otherData"]["platform_profile"]
    assert {r["name"]: r["value"] for r in sect["constants"]}["analysis_host_work"] == 999.0
    assert sect["key"] == fpmod.fingerprint_key(pp.platform_fingerprint("cpu"))
