"""The benchmark's arithmetic on hand-built inputs: the roofline counts, the
rates and percentiles, the spread, and the reading of a device trace."""

import json

import pytest

from portbench import devtrace, yardstick


def test_k1_least_counts_bits_and_bytes_bind():
    b, v = 2048, 64
    least = yardstick.k1_least(b, v)
    assert least["bytes_s"] == pytest.approx(2 * b * v * v / 8 / 3.35e12)
    assert least["ops_s"] == pytest.approx(b * v * v / 32 / 67e12)
    assert least["binds"] == "bytes" and least["s"] == least["bytes_s"]


def test_k2_least_counts_live_edges_at_the_planes_width():
    least = yardstick.k2_least(b=4, v=256, e=512, shared=False, masked_edges=1000)
    assert least["bytes_s"] == pytest.approx((2 * 4 * 256 / 8 + 4 * 512 / 8 + 1000 * 8) / 3.35e12)
    shared = yardstick.k2_least(b=4, v=256, e=512, shared=True, masked_edges=1000)
    assert shared["bytes_s"] < least["bytes_s"]


def test_roofline_share_of_a_hand_built_trace():
    import torch

    trace = {"kernel_s": {"k1": 2e-5, "k2": 0.0}, "launches": {"k1": [(2048, 64)] * 2, "k2": []}}
    want = 100 * 2 * yardstick.k1_least(2048, 64)["s"] / 2e-5
    assert yardstick.roofline_share(trace, "k1") == pytest.approx(want)
    assert yardstick.roofline_share(trace, "k2") is None
    mask = torch.tensor([True, False, True])
    trace = {"kernel_s": {"k2": 1e-6}, "launches": {"k2": [(1, 16, 3, True, mask)]}}
    assert yardstick.roofline_share(trace, "k2") == pytest.approx(
        100 * yardstick.k2_least(1, 16, 3, True, 2)["s"] / 1e-6)


def test_rates_and_percentiles():
    assert yardstick.rate(10200, 8.5) == pytest.approx(1200.0)
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 90) == 90 and yardstick.percentile(xs, 100) == 100
    assert yardstick.percentile(list(reversed(xs)), 90) == 90
    assert yardstick.percentile([5.0], 90) == 5.0


def test_phase_metrics_sum_each_reports_phases():
    recs = [{"runs": 1000, "timings": {"ingest": 0.5, "init": 0.01}},
            {"runs": 1000, "timings": {"ingest": 0.7, "init": 0.03}}]
    assert yardstick.phase_ms_per_krun(recs, ("ingest",)) == pytest.approx(600.0)
    assert yardstick.phase_ms_per_krun(recs, ("ingest", "init")) == pytest.approx(620.0)
    assert yardstick.phase_ms_per_krun([{"queries": 1}], ("ingest",)) is None


def test_union_and_idle_share():
    assert yardstick.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.idle_share({"busy_s": 0.25}, 1.0) == pytest.approx(75.0)
    assert yardstick.idle_share(None, 1.0) is None


def test_kernel_names():
    assert devtrace.kernel_of("closure_block_kernel(unsigned char const*, unsigned char*, int, int)") == "k1"
    assert devtrace.kernel_of("void square_kernel(unsigned int const*, unsigned int*, int, long long)") == "k1"
    assert devtrace.kernel_of("edge_wave_worklist_warp(unsigned char const*, int const*)") == "k2"
    assert devtrace.kernel_of("void at::native::vectorized_elementwise_kernel<4, pack_kernel>(int)") is None
    assert devtrace.kernel_of("unpack_kernel(unsigned int const*, unsigned char*, int, long long)") == "k1"


def test_summary_of_a_hand_built_capture(tmp_path):
    cap = devtrace.Capture(str(tmp_path))
    cap.launches = {"k1": [(2, 64)], "k2": []}
    events = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW_LABEL, "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "report:a", "ts": 1000, "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "phase:ingest", "ts": 1000, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "closure_block_kernel(unsigned char const*)", "ts": 1500, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void at::native::fill(int)", "ts": 1550, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 900, "dur": 200},
    ]
    with open(cap.path, "w") as f:
        json.dump({"traceEvents": events}, f)
    s = cap.summary()
    assert s["busy_s"] == pytest.approx((100 + 150) / 1e6)
    assert s["kernel_s"]["k1"] == pytest.approx(100 / 1e6)
    assert s["breakdown"]["idle_gaps"][0] == ["phase:ingest", pytest.approx(400 / 1e6)]
    assert [g[0] for g in s["breakdown"]["idle_gaps"]] == ["phase:ingest", "report:a"]
    assert devtrace._label_at([], 1.0) == "harness"


def test_mangled_kernel_names():
    assert devtrace.kernel_of("_Z20closure_block_kernelPKhPhii") == "k1"
    assert devtrace.kernel_of("_Z24edge_wave_worklist_blockPKhPKiS2_S0_Phiiiiii") == "k2"
    assert devtrace.kernel_of("_ZN2at6native18elementwise_kernelILi128ELi2EEEviT1_") is None


def test_names_in_anonymous_namespaces():
    assert devtrace.kernel_of("(anonymous namespace)::closure_block_kernel(unsigned char const*, int)") == "k1"
    assert devtrace.kernel_of("void (anonymous namespace)::edge_wave_kernel<true>(unsigned char const*)") == "k2"
