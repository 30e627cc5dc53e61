"""Chip smoke test of the PyTorch/CUDA port (nemo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  Phases,
each fatal (non-zero exit, no result line) on failure:

  1. print the card's name and power limit (nvidia-smi); exit if
     torch.cuda.is_available() is False;
  2. build every CUDA kernel of the port from csrc/ (nvcc, sm_90a), one
     nvcc per source, all at once, and beside them the host ingest engine
     (csrc/host/nemo_native.cpp, g++);
  3. hold the closure kernel (K1) against its plain PyTorch version on the
     card, bit for bit, at the main path's shapes and on the edge cases of
     nemo_tpu_torch/kernels/cases.py under every launch plan that takes
     them, and time it (device time by CUDA event pairs, every plan in
     turns, hot and cold L2) beside the plain version and a bf16 torch.bmm
     squaring chain (the library yardstick, which the port never calls);
  4. hold the edge-wave kernel (K2) against its plain version, bit for bit,
     at the sparse path's shapes, n_steps 1-4 and the fix point, on cyclic
     graphs, padding rows, an all-false mask, a shared edge list, a
     10,000-node chain and the edge cases of kernels/cases.py under every
     plan, and time it (every plan in turns: the worklist against the
     waves) beside the plain version, a torch.sparse CSR block-diagonal
     matrix-vector product (the yardstick) and the launch floor (an empty
     kernel timed the same way);
  Phases 5-6 run their reports on the device lanes (DEVICE_LANES: no
  host-lane budget), the routes these reports took before the host lane
  was ported, so that their launches and plan variants stay comparable; a
  giant good run's diff goes to the host lane whatever the budgets, first
  in the JAX package's diff order.
  5. drive the dense main path — the debugging report (analysis/pipeline.py
     run_debug over TorchBackend) of all six case-study families at 1,700
     runs each (seed 0), figures sample:8, and of ZK-1270 with every
     figure — with the kernels' launch counts zeroed just before each
     report and read just after; check every report tree on cuda (native
     ingest, caches off) equals, byte for byte, the same report on the cpu
     (the families' through the Python loader), check from the recorded
     launches that each took the expected plan variant, and profile each
     family's report through the package's own capture
     (run_debug(profile_dir=...); device busy share; K1's device time,
     launches and kernel functions, which must show those variants where
     the profiler saw the device);
  5b. drive the host ingest paths, each report with the launch counts
     zeroed just before and read just after: every family through the legs
     (the Python loader, on the first PYTHON_LEG_FAMILIES families; the
     native engine cold, populating a fresh
     corpus store; a warm store hit; a whole-report result-cache hit, which
     must launch neither kernel), each report equal to the cpu report and
     each leg's ingest wall (the store populate and the cache lookup and
     publish apart), report wall and runs/s printed (a JSON line
     {"ingest_legs": [...]}); then ZK-1270 grown by 200 runs under
     figures=failed, whose report must map only the new segment and equal
     a from-scratch report; then the same growth from 400 runs through
     the CLI's defaults (figures=all, both caches on, fresh roots): each of the two
     reports beside the same corpus's report with both caches off, the
     grown one mapping only the new segment and equal to its from-scratch
     report (a JSON line {"cli_grown": {...}}), and the host's cost of one
     file operation of each kind the report and the result cache make
     (write, stat, link, rename; {"host_file_ops_ms": {...}});
  6. drive the reports that take the sparse tier, each with the launch
     counts zeroed just before and read just after: (a) two giant-V
     corpora (every giant run on sparse_fused; a giant good run's diff on
     the host lane, no K2 launch from it; giant10k without figures,
     sd_giantv with every figure), (b) a long-horizon sweep of 1,700 runs whose
     buckets split between the dense and the sparse tier (both kernels
     launch), each report equal to the cpu one, and (c) ZK-1270 forced
     onto the sparse tier, whose report must equal the dense one; each
     with its plan variants checked and profiled as in phase 5;
  6d. the six families' and giant10k's reports on the default routes (the
     JAX package's host-lane budgets: the families' diffs and giant10k's go
     to the host lane, no K2 launch from the latter), each equal to the cpu
     report, with their route records ({"default_routes": ...}); then
     both lanes timed at every shape the defaults route ({"lanes": [...]}:
     the families' and giant10k's diffs, grown ZK-1270's new-segment
     buckets, a family's synth bucket), each lane's output equal to the
     other's, the device lane's checked call counted (giant10k's diff
     there is the only shared-list K2 launch at its shape);
  6e. run_debug_dirs over the six families, prefetch off, then on: the
     total wall, each corpus's ingest on the critical path, the prefetched
     parses' walls and the shared render drain ({"run_debug_dirs": [...]}),
     every report equal to the cpu report;
  6f. ZK-1270 in the corpus store in three appends, reported (figures
     none, fresh result caches) streamed and in memory, each with three
     checkpoints, equal to each other and to the cpu report, then again as
     a whole-report hit with no launch ({"stream": {...}}: staged_bytes,
     peak RSS, checkpoints, walls);
  6g. every way a corpus comes in, on the default routes unless named,
     each report with the launch counts zeroed before and read after and
     equal to the same report on the cpu: (a) the five adversarial
     families (deep chains, wide fan-out, near-duplicates, vocabulary
     growth, cycles) at bench.py's size, on the default routes, the device
     lanes and the sparse_device tier forced (K2 must launch), each
     family's wall and bucket routes printed; (b) a family converted to
     trace-JSON, cold into the store and as a warm store hit, then a
     1,500-run prefix grown to 1,700 inside its one document, which must
     map exactly the 200 new runs and equal its from-scratch report; (c) a
     family with three provenance files truncated: stored with its
     quarantine records, a warm whole-report hit with its quarantine.json,
     then one file repaired, which must map exactly 1 run under another
     report key; (d) the watch loop: bench.py's watch tier and a family
     replayed into a watched directory, each update mapping exactly its
     new runs, the last published tree equal to a one-shot report; (e)
     --save-corpus through the CLI, the file loading back equal
     ({"corpora": {...}});
  6h. the ad-hoc query engine on cuda, each call with the launch counts
     zeroed before and read after, every document (its stats aside) equal
     to the same query's cpu document: bench.py's query over the six
     families through the corpus store phase 5b left, cold and then warm
     (a hit that runs no bucket and launches nothing), each bucket on the
     lane of the rule (query_lane) and K2 launched once per sparse_device
     bucket; the same query with the device lane forced (K2 on every
     bucket) and with the host lane forced (no launch); on one family the
     per-run oracle's document; the four verbs as query programs on both
     lanes, each equal to the native verb over TorchBackend("cuda"), none
     launching K2; ZK-1270 grown by 200 runs, mapping only the new
     segment; the CLI's query in a subprocess (a bad query exits 2); POST
     /query through the report server on port 0, on the device lane
     ({"query": {...}});
  6i. observability on the card (nemo_tpu_torch/obs): ZK-1270's report
     (1,700 runs, sample:8, native ingest, caches off) with tracing off,
     then on (both walls); then traced and profiled through
     run_debug(profile_dir=...), on the device lanes (K1) and forced onto
     the sparse tier (K2): each report equal to the cpu report, the trace
     holding the phase:* and kernel:<verb> spans, one kernel span per
     executor dispatch, the kernel.dispatches.* deltas equal to the
     executor's counts, the wrappers' launches equal to the LaunchLog's,
     and the capture showing the kernel's functions launched under its
     nemo:<verb> label; the CLI in a subprocess with --trace, --metrics-out
     (parsed by the port's own parser), --timings and --profile; the cost
     of a disabled span() on this host; the device busy share of bench.py's
     query on ZK-1270 with the device lane forced (the smoke's own
     torch.profiler capture) ({"obs": {...}}); and every counted report's
     device peak, mem.device_peak_bytes of its telemetry.json, the
     allocator's peak reset by the smoke just before each report
     ({"memory": {...}});
  6j. the measured platform profile (nemo_tpu_torch/platform), in a fresh
     profile directory, the profile on (NEMO_PROFILE=auto; phases 5-6i
     run with it off, the default): the first TorchBackend("cuda")
     calibrates exactly once (profile.calibrated 1, probe dispatches, K1
     launched as the LaunchLog counts it) to a sound fit (a device slope
     below the host unit, a budget inside its clamps); after the loaded profiles are forgotten a new
     backend loads it (profile.loaded 1, no probe dispatch, no launch);
     the six families' default-route reports under the seeded and the
     measured constants in turns (seeded, measured, measured, seeded), each
     tree equal to phase 5's, both route lists printed; bench.py's query
     over the families on the measured crossover, each document equal to
     the seeded one, K2 once a device bucket; a truncated profile stays
     seeded (profile.stale 1, no calibration); under off every constant is
     seeded; --calibrate (its fit sound too) and prewarm in subprocesses
     ({"platform_profile":
     {...}}: fingerprint, constants with their source, probes, calibration
     and build walls, the families' walls seeded and measured, routes
     changed);
  6k. the cost-model scheduler (nemo_tpu_torch/parallel/sched.py), each
     report and query with the launch counts zeroed before and read after:
     (a) NEMO_SCHED off and on in turns (off, on, on, off) over the sweep,
     ZK-1270 grown by 200 runs in a store of two segments, the five
     adversarial families (default routes) and bench.py's query over the
     six families, each tree equal to its cpu tree and each query document
     to the off turn's; the walls of each mode, and per on turn each lane's
     jobs, steals and planned lanes from the decision table; the verdict
     of the bar for NEMO_SCHED=auto (on beats off on the sweep and the
     query by more than either mode's spread, slower nowhere); (b) one
     real fused bucket made into a Job on the card's scheduler: a real
     out-of-memory on its device execution is raised out of the run,
     counted, the host never running it, NEMO_BREAKER_FAILURES times; the
     breaker trips (a flight bundle), refuses the next run (BreakerOpen)
     and after the cooldown lets one run through as the half-open probe,
     which launches K1, equals the device output and closes it; the
     closure wrapper's own error (its library faked to fail) propagates;
     (c) a job waiting on a spin kernel past NEMO_DISPATCH_TIMEOUT_S ends
     in DispatchTimeout, its abandoned dispatch records no route, and an
     abandoned dispatch that raises later has its error raised by the next
     run; (d) no phase but these injected legs (and 6l's) moves
     analysis.sched.failover, analysis.sched.lane_failure.device,
     analysis.sched.abandoned_error or
     sched.breaker.trip ({"sched": {...}});
  6l. the chaos harness (nemo_tpu_torch/utils/chaos.py), each report with
     the launch counts zeroed before and read after: (a) ZK-1270 (1,700
     runs, sample:8, device lanes) under NEMO_SCHED=on with a breaker that
     trips at the first failure: fail_dispatch:1 ends the report in
     ChaosFault, counted, the breaker tripped (a flight bundle), nothing
     failed over to the host; the next report is refused (BreakerOpen);
     after the breaker's reset a report launches K1 and equals phase 5's;
     under NEMO_SCHED=off the fault propagates; (b) wedge_dispatch:1 under
     NEMO_DISPATCH_TIMEOUT_S=2 ends in DispatchTimeout with no route
     recorded, and the next report is equal; (c) ZK-1270 in a store of
     three segments, in memory and streamed: a child on cuda is SIGKILLed
     after its first segment checkpoint (rc -9, nothing built), the resume
     maps the two other segments and equals an uninterrupted cuda report
     and the cpu report (walls under bench.py's chaos_tier names, what the
     kill left); (d) the CLI in a child SIGKILLed inside the store's
     publish, then the CLI again, which populates the store and writes the
     cpu tree; (e) the cost of an unarmed hook beside a disabled span();
     (f) no phase but 6k's and 6l's injected legs moves chaos.injected.*,
     analysis.sched.lane_failure.device, analysis.sched.abandoned_error or
     sched.breaker.trip ({"chaos": {...}});
  7. time each kernel at every shape those analyses launched it at (a
     LaunchLog records the shapes, the launches by analysis and the first
     inputs): every plan's device time in turns (SHAPE_ROUNDS rounds, the
     spread printed), the wrapper's call time, the plain version, the
     library yardstick, the bound (for K1, the word ORs these inputs need
     up to each graph's fix point).

Each report logs its wall, runs/s, which ingest served it, the result
cache's part, phase walls, figures against unique renders and bytes.  Every
report names its cache roots (off, or fresh roots under .smoke/), so no
report reads another's store or cached result.  Before the card's line, a JSON object {"shapes": [...]}
holds phase 7's
rows; the line before the last is a JSON object with one record per kernel;
the last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores (the nearest listed rate for the
#: kernels' 32-bit integer and bit operations).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_OPS_S = 67e12

#: Cycles of the spin kernel that device_ms queues its calls behind (about
#: 10 ms at the H100's clock; lengthened where the host needs longer).
SPIN_CYCLES = 20_000_000
#: Rounds of turns (each every plan in order, then in reverse) at every
#: shape the analyses launch a kernel at.
SHAPE_ROUNDS = 3

FAMILY_RUNS = 1700
SEED = 0
#: (B, V) shapes of the closure check; (2048, 64) is the main path's
#: prototype closure (1,700 runs padded to a power of two).
CLOSURE_SHAPES = [
    (1700, 32), (1700, 64), (2048, 64), (64, 128), (8, 256), (7, 50),
    (3, 960), (3, 992), (2, 1024), (1, 4096),
]
TIMED_SHAPE = (1700, 64, 32)  # (B, V, max_len)
#: (B, V, E) shapes of the edge-wave check: a case-study bucket forced
#: sparse, the sweep's mem-routed bucket (also the timed shape) and its
#: largest dense bucket.
EDGE_WAVE_SHAPES = [(2048, 64, 256), (1024, 256, 256), (128, 512, 512)]
EDGE_WAVE_TIMED = (1024, 256, 256)
EDGE_WAVE_STEPS = (1, 2, 3, 4, None)
#: The giant graph of the chain check: a 10,000-node chain in V = E = 16384.
CHAIN_V, CHAIN_NODES = 16384, 10000
GIANT_V = 4096  # TorchBackend's default giant threshold
#: The sparse path's corpora, (name, n_runs, seed, eot) of the port's
#: SynthSpec: the JAX package's giant10k_spec (largest graph 10,503 nodes)
#: and bench.py's sd_giantv (5,708), then a long-horizon sweep at the main
#: path's run count whose buckets split between the two tiers.
GIANT_SPECS = (("giant10k", 2, 2, 3000), ("sd_giantv", 3, 3, 4800))
SWEEP_SPEC = ("sweep", FAMILY_RUNS, 6, 80)
#: Figure policy of the reports (bench.py's end-to-end policy); ZK-1270 is
#: also reported with every figure, and the giant corpora as listed.
REPORT_FIGURES = "sample:8"
#: Runs the grown ZK-1270 sweep of phase 5b appends to its first ones.
INGEST_GROWN_RUNS = 200
GIANT_FIGURES = {"giant10k": "none", "sd_giantv": "all"}
#: The backend knobs that keep every bucket, diff and synth pass off the
#: host lane: the routes phases 5-6 took before the host lane was ported,
#: kept so that their launches and plan variants stay comparable.  The
#: route phases (6d-6f) run the defaults.
DEVICE_LANES = dict(analysis_host_work=0, diff_host_work=0, synth_host_work=0)
#: The streamed corpus of phase 6f: ZK-1270 put in the store in three
#: appends of these run counts (each segment holds enough runs for a dense
#: bucket, whose inputs the streamed map stages on the card).
STREAM_APPENDS = (600, 1200, FAMILY_RUNS)
#: Phase 6f's figures: none (with failed, their writes took most of the
#: phase's wall; every check of the phase holds without them).
STREAM_FIGURES = "none"
#: Phase 5b's CLI legs: ZK-1270's first CLI_FIRST_RUNS runs, then
#: INGEST_GROWN_RUNS more, every figure written (a smaller depth than the
#: other legs': the four legs' figure writes dominated the phase's wall).
CLI_FIRST_RUNS = 400
#: Calls per lane at each routed shape of phase 6d.
LANE_ITERS = 3
#: Families that phase 5b also reports through the Python loader (the other
#: legs take all six): kept so that the smoke ends well inside its time
#: limit on the card's slower hosts.
PYTHON_LEG_FAMILIES = 2
#: Phase 6g's adversarial families: bench.py's adversarial tier (96 runs,
#: seed 13, figures none, caches off), on these lanes: (name, TorchBackend
#: knobs, default routes).
ADV_RUNS, ADV_SEED = 96, 13
ADV_LANES = (
    ("default", {}, True),
    ("device_lanes", {}, False),
    ("sparse_device", {"analysis_impl": "sparse_device"}, False),
)
#: Phase 6g's corpora: the family of each leg, the trace-JSON sweep's first
#: generation, the quarantined positions, the watch legs' replays
#: (bench.py's watch tier: SynthSpec(n_runs=240, seed=31) in 6
#: generations; a family in 4).
TRACE_FAMILY = "CA-2083-hinted-handoff"
QUARANTINE_FAMILY = "MR-2995-failed-after-expiry"
QUARANTINE_POSITIONS = (17, 800, 1601)
WATCH_FAMILY = "pb_asynchronous"
SAVE_FAMILY = "CA-2434-bootstrap-synchronization"
WATCH_TIER = (240, 31, 6)
WATCH_FAMILY_GENERATIONS = 4
#: Figures of the legs that need per-segment partials (a sample:N selection
#: depends on the whole run list, so it has none, and every update would
#: map every run).
PARTIAL_FIGURES = "none"
#: Phase 6h: bench.py's query tier (bench.py:575-581), three patterns with
#: one -*-> hop, into its capture step: the forward reach only, so one K2
#: launch a bucket on the sparse_device lane.
QUERY_TEXT = ("from pre match goal[holds=true] -> @rule match goal[holds=false] -*-> @rule[type=async] "
              "match @goal -> rule -> goal count by table")
#: The family whose query documents are also held against the per-run
#: oracle, the CLI's and the report server's.
QUERY_FAMILY = "ZK-1270-racing-sent-flag"
#: A query the CLI must reject with exit code 2.
QUERY_BAD = "match wat"
#: A host-lane budget no bucket reaches.
QUERY_HOST_ONLY = 10**18
#: Phase 6k: the modes in turns, and the breaker's knobs of its failover
#: leg (two failures trip it; a short cooldown; no failover pause).
SCHED_TURNS = ("off", "on", "on", "off")
SCHED_BREAKER = {"NEMO_BREAKER_FAILURES": "2", "NEMO_BREAKER_COOLDOWN_S": "1.0", "NEMO_FAILOVER_BACKOFF_S": "0"}
#: The series that only phase 6k's and 6l's injected legs may move, in any
#: phase (with every chaos.injected.<point>).
FAILOVER_SERIES = ("analysis.sched.failover", "analysis.sched.lane_failure.device", "sched.breaker.trip",
                   "analysis.sched.abandoned_error")
#: Phase 6l: ZK-1270's store appends (as phase 5b grows it), the figures of
#: the killed sweep (sample:N publishes no segment partial), the breaker of
#: the fail_dispatch leg and the wedge leg's deadline.
CHAOS_APPENDS = (FAMILY_RUNS - INGEST_GROWN_RUNS, FAMILY_RUNS - INGEST_GROWN_RUNS // 2, FAMILY_RUNS)
CHAOS_FIGURES = "none"
CHAOS_BREAKER = {"NEMO_BREAKER_FAILURES": "1", "NEMO_BREAKER_COOLDOWN_S": "3600"}
CHAOS_TIMEOUT_S = "2"


def log(msg: str) -> None:
    print(msg, flush=True)


def _lanes(default_routes: bool, backend_kw: dict) -> dict:
    """TorchBackend knobs: the defaults, or the device lanes (DEVICE_LANES)
    under ``backend_kw``."""
    return dict(backend_kw) if default_routes else {**DEVICE_LANES, **backend_kw}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of fn() over iters calls in a row, by CUDA events
    around the loop: for a small kernel, the host's time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_device_ms(fn, iters: int = 20) -> float:
    """Device time of fn() with a cold L2: a 64 MB buffer (more than the
    H100's 50 MB L2) is written before every call; the write's own device
    time, measured alone, is taken off."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.fill_(1)
        fn()

    return device_ms(flushed, iters) - device_ms(lambda: flush.fill_(1), iters)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of fn() over iters calls in a row, by CUDA
    events around the loop, with the loop queued behind a spin kernel
    (torch.cuda._sleep): the device runs the calls back to back, and the
    host's time per call (some 25 us of Python and ctypes, more than a small
    kernel's run) falls inside the spin instead of between the calls.  The
    spin is lengthened until it outlasts the host's enqueueing; a call that
    still outlasts it (one that waits for the device) is said to be
    host-bound."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin_start.record()
        torch.cuda._sleep(spin)
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        if spin_start.elapsed_time(start) > host_ms:
            return ms
        spin *= 4
    log(f"device_ms: the host's enqueueing ({host_ms:.3f} ms) outlasted the spin; the time is host-bound")
    return ms


def time_in_turns(run, plans: dict, iters: int = 20, warmup: int = 3, rounds: int = 1) -> dict[str, list[float]]:
    """Device ms (device_ms) of run(plan) for every plan, timed in turns:
    each round times every plan once in the given order (the wrapper's
    choice first), then once in the reverse order.  Returns each plan's
    2 x rounds turns."""
    turns = {k: [] for k in plans}
    for _ in range(rounds):
        for order in (list(plans), list(plans)[::-1]):
            for k in order:
                turns[k].append(device_ms(lambda: run(plans[k]), iters, warmup))
    return turns


def means(turns: dict[str, list[float]]) -> dict[str, float]:
    return {k: sum(v) / len(v) for k, v in turns.items()}


def fmt_ms(times: dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())


def fmt_turns(turns: dict[str, list[float]]) -> str:
    """Each plan's mean device ms and, in brackets, its fastest and slowest
    turn: the spread within the call that a gap between plans must exceed."""
    return ", ".join(f"{k} {sum(v) / len(v):.4f} ms [{min(v):.4f}-{max(v):.4f}]" for k, v in turns.items())


def closure_bmm_bf16(adj: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Library yardstick: the closure as a chain of bf16 torch.bmm calls."""
    v = adj.shape[-1]
    r = (adj | torch.eye(v, dtype=torch.bool, device=adj.device)).to(torch.bfloat16)
    for _ in range(n_steps):
        r = (torch.bmm(r, r) > 0.5).to(torch.bfloat16)
    return r > 0.5


def closure_ops(adj: torch.Tensor, n_steps: int) -> int:
    """The operations the closure needs on these inputs, as bit rows: a
    squaring ORs, for every set bit (i, k) of R, row k's words into row i,
    and each graph needs the squarings up to its fix point (the one that
    finds R*R = R included) or n_steps, whichever comes first.  Counted by
    running the chain on the card, a graph dropping out at its fix point."""
    a3 = adj if adj.ndim == 3 else adj[None]
    v = a3.shape[-1]
    words = (v + 31) // 32
    r = a3 | torch.eye(v, dtype=torch.bool, device=adj.device)
    active = torch.ones(a3.shape[0], dtype=torch.bool, device=adj.device)
    ops = 0
    for _ in range(n_steps):
        ops += int(r[active].sum()) * words
        f = r.to(torch.float32)
        nxt = torch.bmm(f, f) > 0.5
        active &= (nxt != r).flatten(1).any(1)
        r = nxt
        if not bool(active.any()):
            break
    return ops


def closure_bounds(adj: torch.Tensor, n_steps: int) -> dict[str, float]:
    """The two bounds (ms) of the closure of adj: one read of the bool input
    and one write of the output over the HBM rate, and the word ORs
    closure_ops counts over the float32 rate outside the tensor cores (the
    nearest listed rate for 32-bit integer operations).  The larger is the
    bound."""
    return {"bytes": 2 * adj.numel() / PEAK_BYTES_S * 1e3,
            "operations": closure_ops(adj, n_steps) / PEAK_FP32_OPS_S * 1e3}


def check_closure(closure_mod) -> dict:
    """Phase 3: K1 against closure_plain on the card, then timings."""
    from nemo_tpu_torch.kernels import cases as kcases

    closure, closure_plain, closure_steps = (
        closure_mod.closure, closure_mod.closure_plain, closure_mod.closure_steps,
    )
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    max_err = 0

    def compare(name, adj, max_len=None):
        nonlocal max_err
        got = closure(adj, max_len=max_len)
        torch.cuda.synchronize()
        want = closure_plain(adj, max_len=max_len)
        torch.cuda.synchronize()
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max().item())
        max_err = max(max_err, err)
        if got.shape != adj.shape or got.dtype != torch.bool or err != 0:
            raise AssertionError(f"closure {name}: kernel != closure_plain (max err {err})")
        log(f"closure {name}: bit-identical ({int(got.sum())} reachable pairs)")

    for b, v in CLOSURE_SHAPES:
        adj = torch.from_numpy(rng.random((b, v, v)) < 2.0 / v).to(dev)
        compare(f"[{b},{v},{v}]", adj)
        compare(f"[{b},{v},{v}] max_len=32", adj, max_len=32)
    compare("2-D [64,64]", torch.from_numpy(rng.random((64, 64)) < 2.0 / 64).to(dev))
    v = 64
    chain = torch.zeros(v, v, dtype=torch.bool, device=dev)
    chain[torch.arange(v - 1), torch.arange(1, v)] = True
    compare("chain V-1", chain)
    full = closure(chain)
    if not torch.equal(full, torch.ones(v, v, dtype=torch.bool, device=dev).triu()):
        raise AssertionError("closure of the chain is not the upper triangle")
    # Cyclic graphs whose true depth exceeds max_len: the squaring count is
    # cut short, and the kernel must still match the chain of squarings.
    perm = rng.permutation(v)
    cyc = np.zeros((v, v), dtype=bool)
    cyc[perm, np.roll(perm, -1)] = True
    cyc |= rng.random((v, v)) < 0.5 / v
    compare("cyclic max_len=4", torch.from_numpy(cyc).to(dev), max_len=4)
    compare("cyclic batch max_len=3",
            torch.from_numpy(rng.random((32, 128, 128)) < 1.5 / 128).to(dev), max_len=3)
    # Every variant that takes each edge case's shape, bit for bit.
    n_runs = 0
    for name, adj_np, max_len in kcases.closure_cases(SEED):
        adj = torch.from_numpy(adj_np).to(dev)
        want = closure_plain(adj, max_len=max_len)
        for variant, plan in closure_mod.closure_plans(adj.shape[0] if adj.ndim == 3 else 1, adj.shape[-1]).items():
            got = closure_mod.launch_plan(adj, plan, max_len)
            torch.cuda.synchronize()
            err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max().item())
            max_err = max(max_err, err)
            if got.shape != adj.shape or err != 0:
                raise AssertionError(f"closure {name} plan {variant}: kernel != closure_plain (max err {err})")
            n_runs += 1
    log(f"closure edge cases: {len(kcases.closure_cases(SEED))} cases, {n_runs} (case, plan) runs bit-identical")

    b, v, max_len = TIMED_SHAPE
    adj = torch.from_numpy(rng.random((b, v, v)) < 2.0 / v).to(dev)
    n_steps = closure_steps(v, max_len)
    launches_before = closure.launches
    plans = closure_mod.closure_plans(b, v)
    by_plan = means(time_in_turns(lambda plan: closure_mod.launch_plan(adj, plan, max_len), plans))
    ms = by_plan[closure_mod.closure_plan(b, v).variant]
    call_ms = time_ms(lambda: closure(adj, max_len=max_len))
    cold_ms = cold_device_ms(lambda: closure(adj, max_len=max_len))
    closure.launches = launches_before  # timing launches are not main-path launches
    plain_ms = time_ms(lambda: closure_plain(adj, max_len=max_len))
    library_ms = time_ms(lambda: closure_bmm_bf16(adj, n_steps))
    if not torch.equal(closure_bmm_bf16(adj, n_steps), closure_plain(adj, max_len=max_len)):
        raise AssertionError("bf16 bmm yardstick disagrees with closure_plain")
    bounds = closure_bounds(adj, n_steps)
    bound_by = max(bounds, key=bounds.get)
    bound_ms = bounds[bound_by]
    log(f"closure timing [{b},{v},{v}] max_len={max_len} ({n_steps} squarings): kernel {ms:.4f} ms device "
        f"(by plan in turns: {fmt_ms(by_plan)}; cold L2 {cold_ms:.4f} ms); wrapper call by CUDA events "
        f"{call_ms:.4f} ms; plain {plain_ms:.4f} ms, bf16 bmm chain {library_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}; bytes {bounds['bytes']:.6f} ms, operations "
        f"{bounds['operations']:.6f} ms)")
    return {
        "name": "closure",
        "route": "cuda",
        "source": "nemo_tpu_torch/csrc/closure.cu",
        "replaces": "nemo_tpu/ops/pallas_kernels.py:180",
        "launches": None,  # filled in from the main path's run
        "max_abs_err": float(max_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def wave_inputs(rng, b: int, v: int, e: int, shared: bool = False) -> list[torch.Tensor]:
    """K2 inputs on the card: random edges plus a cycle through half the
    nodes, 20 % masked out, a sparse start state; the last eighth of the
    rows are padding (no state, and an all-false mask unless ``shared``,
    one [E] list for every row)."""
    shape = (e,) if shared else (b, e)
    src = rng.integers(0, v, shape).astype(np.int32)
    dst = rng.integers(0, v, shape).astype(np.int32)
    ring = rng.permutation(v)[: min(v, e) // 2]
    src[..., : len(ring)], dst[..., : len(ring)] = ring, np.roll(ring, -1)
    mask = rng.random(shape) < 0.8
    state = rng.random((b, v)) < 2.0 / v
    pad = b - b // 8
    state[pad:] = False
    if not shared:
        mask[pad:] = False
    return [torch.from_numpy(a).to("cuda") for a in (state, src, dst, mask)]


def chain_inputs(rng) -> list[torch.Tensor]:
    """One run of V = E = 16384 holding a 10,000-node chain, its edges in
    shuffled order, the state its first node."""
    perm = rng.permutation(CHAIN_V)
    order = rng.permutation(CHAIN_NODES - 1)
    src = np.zeros((1, CHAIN_V), dtype=np.int32)
    dst = np.zeros((1, CHAIN_V), dtype=np.int32)
    src[0, : CHAIN_NODES - 1] = perm[: CHAIN_NODES - 1][order]
    dst[0, : CHAIN_NODES - 1] = perm[1:CHAIN_NODES][order]
    mask = np.zeros((1, CHAIN_V), dtype=bool)
    mask[0, : CHAIN_NODES - 1] = True
    state = np.zeros((1, CHAIN_V), dtype=bool)
    state[0, perm[0]] = True
    return [torch.from_numpy(a).to("cuda") for a in (state, src, dst, mask)]


def csr_waves(state, src, dst, mask):
    """Library yardstick for K2: the runs' edges as one block-diagonal
    torch.sparse CSR matrix; returns waves(n) = n products with the state
    as a column, thresholded and ORed into it."""
    step, x0 = csr_step(state, src, dst, mask)
    b, v = state.shape

    def waves(n: int) -> torch.Tensor:
        x = x0
        for _ in range(n):
            x = step(x)
        return x.reshape(b, v) > 0

    return waves


def csr_step(state, src, dst, mask):
    """(step, x0) of the CSR yardstick: x0 the state as a float32 column,
    step(x) one product with the block-diagonal adjacency, ORed into x."""
    b, v = state.shape
    e = src.shape[-1]
    base = torch.arange(b, device=state.device)[:, None] * v
    keep = mask.expand(b, e)
    rows = (base + dst.long().expand(b, e))[keep]
    cols = (base + src.long().expand(b, e))[keep]
    vals = torch.ones(len(rows), dtype=torch.float32, device=state.device)
    adj = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (b * v, b * v))
    adj = adj.coalesce().to_sparse_csr()
    x0 = state.reshape(b * v, 1).to(torch.float32)
    return (lambda x: ((adj @ x) + x > 0).to(torch.float32)), x0


def check_edge_wave(ew_mod) -> dict:
    """Phase 4: K2 against edge_wave_plain on the card, then timings."""
    from nemo_tpu_torch.kernels import cases as kcases

    edge_wave, plain = ew_mod.edge_wave, ew_mod.edge_wave_plain
    rng = np.random.default_rng(SEED)
    launches_before = edge_wave.launches
    max_err = 0

    def compare(name, args, n_steps):
        nonlocal max_err
        got = edge_wave(*args, n_steps)
        torch.cuda.synchronize()
        want = plain(*args, n_steps)
        err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max().item())
        max_err = max(max_err, err)
        if got.shape != want.shape or got.dtype != torch.bool or err != 0:
            raise AssertionError(f"edge_wave {name} n_steps={n_steps}: kernel != plain (max err {err})")
        return got

    cases = [(f"[{b},{v}] E={e}", wave_inputs(rng, b, v, e)) for b, v, e in EDGE_WAVE_SHAPES]
    cases.append(("shared [E] list [1024,256] E=256", wave_inputs(rng, 1024, 256, 256, shared=True)))
    for name, args in cases:
        for n_steps in EDGE_WAVE_STEPS:
            got = compare(name, args, n_steps)
        log(f"edge_wave {name}: bit-identical at n_steps {EDGE_WAVE_STEPS} "
            f"({int(args[0].sum())} -> {int(got.sum())} nodes at the fix point)")
    args = wave_inputs(rng, 64, 64, 256)
    args[3] = torch.zeros_like(args[3])
    for n_steps in (1, None):
        if not torch.equal(compare("all-false mask", args, n_steps), args[0]):
            raise AssertionError("edge_wave with an all-false mask moved the state")
    log("edge_wave all-false mask [64,64] E=256: bit-identical, state unchanged")
    # Every variant that takes each edge case's shape, at the fix point and
    # at finite n_steps, bit for bit.
    n_runs = 0
    for name, arrays in kcases.edge_wave_cases(SEED):
        args = [torch.from_numpy(a).to("cuda") for a in arrays]
        b, v = args[0].shape
        for n_steps in (None, 1, 3):
            want = plain(*kcases.in_range(*args), n_steps)
            for variant, plan in ew_mod.edge_wave_plans(b, v, args[1].shape[-1], n_steps).items():
                got = ew_mod.launch_plan(plan, *args, n_steps)
                torch.cuda.synchronize()
                err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max().item())
                max_err = max(max_err, err)
                if err != 0:
                    raise AssertionError(f"edge_wave {name} plan {variant} n_steps={n_steps}: kernel != plain")
                n_runs += 1
    log(f"edge_wave edge cases: {len(kcases.edge_wave_cases(SEED))} cases, {n_runs} (case, plan, n_steps) "
        f"runs bit-identical")
    lib = ew_mod._lib()
    for v, e, warps in ((1, 0, 1), (256, 256, 1), (100, 301, 8), (16384, 16384, 8)):
        if lib.nemo_edge_wave_run_bytes(v, e, warps) != ew_mod.worklist_run_bytes(v, e, warps):
            raise AssertionError(f"edge_wave: the wrapper's shared-memory layout differs from the source's at {v, e}")

    chain = chain_inputs(rng)
    for n_steps in EDGE_WAVE_STEPS:
        got = compare("chain", chain, n_steps)
        if int(got.sum()) != (CHAIN_NODES if n_steps is None else n_steps + 1):
            raise AssertionError(f"edge_wave chain n_steps={n_steps}: {int(got.sum())} nodes reached")
    chain_plans = ew_mod.edge_wave_plans(1, CHAIN_V, CHAIN_V, None)
    chain_ms = means(time_in_turns(lambda plan: ew_mod.launch_plan(plan, *chain, None), chain_plans, iters=5,
                                   warmup=1))
    chain_plain_ms = time_ms(lambda: plain(*chain, None), iters=1, warmup=0)
    log(f"edge_wave chain of {CHAIN_NODES} nodes in V=E={CHAIN_V}: bit-identical at n_steps "
        f"{EDGE_WAVE_STEPS}; fix point by plan in turns (device): {fmt_ms(chain_ms)} (wrapper: "
        f"{ew_mod.edge_wave_plan(1, CHAIN_V, CHAIN_V, None).variant}), plain {chain_plain_ms:.4f} ms, "
        f"{(CHAIN_NODES - 1) / 1e3 / chain_ms[ew_mod.edge_wave_plan(1, CHAIN_V, CHAIN_V, None).variant]:.3f} "
        f"hops per us")

    b, v, e = EDGE_WAVE_TIMED
    args = wave_inputs(rng, b, v, e)
    final = plain(*args, None)
    waves = wave_levels(*args)
    yardstick = csr_waves(*args)
    if not torch.equal(yardstick(waves), final):
        raise AssertionError("torch.sparse CSR yardstick disagrees with edge_wave_plain")
    by_plan = means(time_in_turns(lambda plan: ew_mod.launch_plan(plan, *args, None),
                                  ew_mod.edge_wave_plans(b, v, e, None)))
    ms = by_plan[ew_mod.edge_wave_plan(b, v, e, None).variant]
    call_ms = time_ms(lambda: edge_wave(*args, None))
    edge_wave.launches = launches_before  # check and timing launches are not main-path launches
    plain_ms = time_ms(lambda: plain(*args, None))
    library_ms = time_ms(lambda: yardstick(waves))
    n_edges = int(args[3].sum())
    # One read of the state and the edge planes (int32 src and dst, bool
    # mask), one write of the output; a work-efficient traversal tests each
    # masked edge's source and ORs into its destination once.
    bytes_moved = 2 * b * v + 9 * b * e
    ops = 2 * n_edges
    bound_s = {"bytes": bytes_moved / PEAK_BYTES_S, "operations": ops / PEAK_FP32_OPS_S}
    bound_by = max(bound_s, key=bound_s.get)
    # The floor under every small kernel: one launch of a kernel that does
    # nothing, timed the same way.
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    log(f"launch floor: an empty kernel takes {floor_ms:.4f} ms device per call, back to back")
    log(f"edge_wave timing [{b},{v}] E={e} to the fix point ({waves} waves, {n_edges} masked edges): "
        f"kernel {ms:.4f} ms device (by plan in turns: {fmt_ms(by_plan)}); wrapper call by CUDA events "
        f"{call_ms:.4f} ms; plain {plain_ms:.4f} ms, torch.sparse CSR waves {library_ms:.4f} ms, "
        f"bound {bound_s[bound_by] * 1e3:.5f} ms ({bound_by})")
    return {
        "name": "edge_wave",
        "route": "cuda",
        "source": "nemo_tpu_torch/csrc/edge_wave.cu",
        "replaces": "nemo_tpu/ops/pallas_kernels.py:142",
        "launches": None,  # filled in from the main path's runs
        "max_abs_err": float(max_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s[bound_by] * 1e3,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


#: Kernel functions of K1 and K2 by the names the profiler shows; a name is
#: matched by the first function it contains (unpack_kernel before pack_kernel).
KERNEL_FUNCTIONS = {
    "closure": ("closure_warp_kernel", "closure_block_kernel", "unpack_kernel", "pack_kernel",
                "square_kernel"),
    "edge_wave": ("edge_wave_worklist_warp", "edge_wave_worklist_block", "edge_wave_kernel"),
}


class LaunchLog:
    """The shapes at which the analyses launch K1 and K2.  Proxies in place
    of the names the ops modules call (``ops.adjacency._closure_kernel``,
    ``ops.sparse_device.edge_wave``) forward every call to the wrapper and,
    for CUDA inputs during a counted analysis (``label`` set), count it by
    shape and analysis and keep a copy of the first inputs at each shape."""

    def __init__(self):
        import threading

        self.label = None
        self.shapes = {}  # (kernel, key) -> {"args", "kw", "launches": {label: n}}
        self._restore = []
        # The scheduler's lanes (phase 6k) launch from two threads at once.
        self._lock = threading.Lock()

    def install(self, closure_fn, edge_wave_fn, closure_steps) -> None:
        import nemo_tpu_torch.ops.adjacency as adjacency
        import nemo_tpu_torch.ops.sparse_device as sparse_device

        def closure_key(adj, max_len=None):
            v = adj.shape[-1]
            return (adj.shape[0] if adj.ndim == 3 else 1, v, closure_steps(v, max_len))

        def wave_key(state, src, dst, mask, n_steps=None):
            return (state.shape[0], state.shape[1], src.shape[-1], src.ndim == 1, n_steps)

        for mod, attr, name, fn, key_of in (
            (adjacency, "_closure_kernel", "closure", closure_fn, closure_key),
            (sparse_device, "edge_wave", "edge_wave", edge_wave_fn, wave_key),
        ):
            self._restore.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self._proxy(name, fn, key_of))

    def uninstall(self) -> None:
        for mod, attr, fn in self._restore:
            setattr(mod, attr, fn)
        self._restore = []

    def _proxy(self, name, fn, key_of):
        def proxy(*args, **kw):
            label = self.label
            if label is not None and args[0].is_cuda:
                with self._lock:
                    rec = self.shapes.setdefault((name, key_of(*args, **kw)), {"launches": {}})
                    if "args" not in rec:
                        rec["args"] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                        rec["kw"] = dict(kw)
                    rec["launches"][label] = rec["launches"].get(label, 0) + 1
            return fn(*args, **kw)

        return proxy

    def launches(self, kernel: str) -> int:
        with self._lock:
            return sum(sum(r["launches"].values()) for (k, _), r in self.shapes.items() if k == kernel)


def wave_levels(state, src, dst, mask) -> int:
    """Synchronous waves to the fix point, the last one finding nothing
    new (the CSR yardstick's count), by stepping the yardstick itself."""
    step, x = csr_step(state, src, dst, mask)
    n = 0
    while True:
        nxt = step(x)
        n += 1
        if torch.equal(nxt, x):
            return n
        x = nxt


def time_closure_shape(closure_mod, key, rec) -> dict:
    """K1 at one shape the analyses launch it at: every plan's device time in
    turns, the wrapper's call time, the plain chain, the bf16 bmm chain
    (call and device time), the bounds (closure_bounds)."""
    b, v, n_steps = key
    adj = rec["args"][0].contiguous()
    max_len = rec["kw"].get("max_len", rec["args"][1] if len(rec["args"]) > 1 else None)
    plans = closure_mod.closure_plans(b, v)
    turns = time_in_turns(lambda plan: closure_mod.launch_plan(adj, plan, max_len), plans, rounds=SHAPE_ROUNDS)
    call_ms = time_ms(lambda: closure_mod.closure(adj, max_len=max_len))
    plain_ms = time_ms(lambda: closure_mod.closure_plain(adj, max_len=max_len), iters=5, warmup=1)
    adj3 = adj if adj.ndim == 3 else adj[None]
    library_ms = time_ms(lambda: closure_bmm_bf16(adj3, n_steps), iters=5, warmup=1)
    library_device_ms = device_ms(lambda: closure_bmm_bf16(adj3, n_steps), iters=5, warmup=1)
    bounds = closure_bounds(adj, n_steps)
    bound_by = max(bounds, key=bounds.get)
    return {"kernel": "closure", "shape": {"B": b, "V": v, "squarings": n_steps},
            "plan": closure_mod.closure_plan(b, v).variant, "ms_by_plan": means(turns), "turns_by_plan": turns,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "bounds_ms": bounds, "launches": rec["launches"]}


def time_wave_shape(ew_mod, key, rec) -> dict:
    """K2 at one shape the analyses launch it at (to the fix point): every
    plan's device time in turns (the waves variants run it in place), the
    wrapper's call time, the plain waves, the torch.sparse CSR yardstick,
    the byte and operation bounds and the synchronous wave count (the
    longest chain of dependent hops + 1)."""
    b, v, e, shared, n_steps = key
    state, src, dst, mask = rec["args"][:4]
    plans = ew_mod.edge_wave_plans(b, v, e, n_steps)
    turns = time_in_turns(lambda plan: ew_mod.launch_plan(plan, state, src, dst, mask, n_steps), plans,
                          iters=10, warmup=2, rounds=SHAPE_ROUNDS)
    final = ew_mod.edge_wave_plain(state, src, dst, mask, n_steps)
    plain_ms = time_ms(lambda: ew_mod.edge_wave_plain(state, src, dst, mask, n_steps), iters=1, warmup=0)
    waves = wave_levels(state, src, dst, mask)
    yardstick = csr_waves(state, src, dst, mask)
    if not torch.equal(yardstick(waves), final):
        raise AssertionError(f"edge_wave shape {key}: the CSR yardstick disagrees with the plain waves")
    library_ms = time_ms(lambda: yardstick(waves), iters=1, warmup=1)
    library_device_ms = device_ms(lambda: yardstick(waves), iters=1, warmup=0)
    call_ms = time_ms(lambda: ew_mod.edge_wave(state, src, dst, mask, n_steps), iters=10, warmup=2)
    n_edges = int(mask.sum()) * (b if shared else 1)
    bytes_moved = 2 * b * v + 9 * (1 if shared else b) * e
    bounds = {"bytes": bytes_moved / PEAK_BYTES_S * 1e3, "operations": 2 * n_edges / PEAK_FP32_OPS_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return {"kernel": "edge_wave", "shape": {"B": b, "V": v, "E": e, "shared": shared},
            "plan": ew_mod.edge_wave_plan(b, v, e, n_steps).variant, "ms_by_plan": means(turns),
            "turns_by_plan": turns, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "bounds_ms": bounds, "waves": waves, "masked_edges": n_edges, "launches": rec["launches"]}


def shape_timings(launch_log: LaunchLog, closure_mod, ew_mod) -> list[dict]:
    """Phase 7: each kernel timed at every shape the analyses launched it
    at, beside its bound; one log line per shape."""
    rows = []
    for (kernel, key), rec in launch_log.shapes.items():
        row = (time_closure_shape(closure_mod, key, rec) if kernel == "closure"
               else time_wave_shape(ew_mod, key, rec))
        rows.append(row)
        chosen = row["ms_by_plan"][row["plan"]]
        log(f"shape {kernel} {row['shape']}: {sum(row['launches'].values())} launches {row['launches']}; "
            f"{row['plan']} {chosen:.4f} ms ({chosen / row['bound_ms']:.1f}x its bound "
            f"{row['bound_ms']:.5f} ms, {row['bound_by']}; bytes {row['bounds_ms']['bytes']:.6f} ms, operations "
            f"{row['bounds_ms']['operations']:.6f} ms); device ms by plan in turns, mean [fastest-slowest of "
            f"{2 * SHAPE_ROUNDS}] {fmt_turns(row['turns_by_plan'])}; wrapper call {row['call_ms']:.4f} ms; "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms (CUDA events around the whole "
            f"call: device plus host; device {row['library_device_ms']:.4f} ms)"
            + (f"; {row['waves']} synchronous waves, {row['masked_edges']} masked edges"
               if kernel == "edge_wave" else ""))
    closure_mod.closure.launches = ew_mod.edge_wave.launches = 0  # timing launches are not main-path launches
    return rows


LAUNCH_LOG = LaunchLog()


#: label -> [the device peak (mem.device_peak_bytes) of each counted report,
#: the allocator's peak reset just before it; the bytes in use at that
#: reset, which the peak includes (tensors the smoke keeps, such as the
#: LaunchLog's inputs)].
MEM_PEAKS: dict[str, list[int]] = {}


def report_counted(label: str, cd: str, kernels, out_root: str, figures: str, report_name: str,
                   ingest: str = "auto", corpus_cache: str = "off", result_cache: str = "off",
                   default_routes: bool = False, profile_dir: str | None = None, **backend_kw):
    """One debugging report on cuda through run_debug, with every kernel's
    launch count set to 0 just before and read just after; the corpus store
    and the result cache are off unless roots are given.  The backend takes
    the device lanes (DEVICE_LANES) unless ``default_routes``.  Returns (the
    DebugResult, the backend, the report tree's bytes, launches by kernel
    name) and logs the report wall, runs/s, which ingest served it, every
    phase wall, the figures against their unique renders, the report's
    bytes, the routes and the plain fix-point loops' iterations.  The
    allocator's peak is reset just before, so the memory section of its
    telemetry.json reads this report's device peak, over what was in use
    before it (MEM_PEAKS).
    ``profile_dir`` goes to run_debug (the package's profiler capture)."""
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.ops.sparse_device import LOOP_STATS

    backend = TorchBackend(device="cuda", **_lanes(default_routes, backend_kw))
    LOOP_STATS.clear()
    for k in kernels:
        k.launches = 0
    LAUNCH_LOG.label = label
    torch.cuda.reset_peak_memory_stats()
    in_use = torch.cuda.memory_allocated()
    t = time.perf_counter()
    try:
        res = run_debug(cd, out_root, backend, figures=figures, report_name=report_name, ingest=ingest,
                        corpus_cache=corpus_cache, result_cache=result_cache, profile_dir=profile_dir)
    finally:
        LAUNCH_LOG.label = None
    wall = time.perf_counter() - t
    with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as fh:
        MEM_PEAKS[label] = [json.load(fh)["memory"]["device_peak_bytes"], in_use]
    counts = {k.__name__: k.launches for k in kernels}
    tree = report_tree_bytes(res.report_dir)
    runs = len(res.molly.runs)
    fs = res.figure_stats or {"figures": 0, "unique_figures": 0, "render_s": 0, "render_wall_s": 0}
    routes = [(r["verb"], r["route"], r["rows"], r["v"], r["e"], r["work"], r["reason"])
              for r in backend.analysis_routes]
    loops = {n: (r["calls"], r["iters"], round(r["wall_s"], 4)) for n, r in LOOP_STATS.items()}
    log(f"{label}: {runs} runs, {len(res.molly.failed_runs_iters)} failed, figures={figures}, report wall "
        f"{wall:.3f} s, {runs / wall:.1f} runs/s; ingest {res.ingest}, result cache {res.result_cache}; phase wall "
        f"{json.dumps({k: round(v, 4) for k, v in res.timings.items()})}; figures {fs['figures']} written from "
        f"{fs['unique_figures']} unique renders (render {fs['render_s']} s, drain wall {fs['render_wall_s']} s); "
        f"report {sum(map(len, tree.values()))} bytes in {len(tree)} files; launches {counts}, dispatches "
        f"{backend.executor.dispatches}, host-lane runs {backend.executor.host_runs}, routes (verb, route, rows, v, "
        f"e, work, reason) {routes}, plain fix-point loops (calls, iters, wall s) {loops}; device peak "
        f"{MEM_PEAKS[label][0]} bytes ({in_use} in use before)"
        + (f"; stream {res.stream}" if res.stream else ""))
    res.report_wall_s = wall
    return res, backend, tree, counts


def check_report_cpu_equal(label: str, cd: str, tree: dict, out_root: str, figures: str, report_name: str,
                           ingest: str = "auto", default_routes: bool = False, **backend_kw) -> None:
    """The same report on the CPU, caches off, the same routes, must have the
    same bytes, file for file."""
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    t = time.perf_counter()
    res = run_debug(cd, out_root, TorchBackend(device="cpu", **_lanes(default_routes, backend_kw)), figures=figures,
                    report_name=report_name, ingest=ingest, corpus_cache="off", result_cache="off")
    cpu_tree = report_tree_bytes(res.report_dir)
    log(f"{label} on cpu: {time.perf_counter() - t:.3f} s")
    if cpu_tree != tree:
        differ = sorted(set(cpu_tree) ^ set(tree)) + sorted(k for k in tree if cpu_tree.get(k, tree[k]) != tree[k])
        raise AssertionError(f"{label}: the cuda report differs from the cpu report in {differ[:10]}")
    log(f"{label}: cuda report equals the cpu report ({len(tree)} files, {sum(map(len, tree.values()))} bytes)")
    shutil.rmtree(res.report_dir)


def check_report_content(label: str, res, protos: bool = False) -> None:
    """What the report must say: every failed run's missing events (when a
    good run exists), a recommendation for every run and, with ``protos``,
    the prototypes."""
    runs = res.molly.runs
    failed = [r for r in runs if r.iteration in set(res.molly.failed_runs_iters)]
    if failed and res.molly.success_runs_iters and not any(r.missing_events for r in failed):
        raise AssertionError(f"{label}: failed runs but no missing events")
    if protos and (not runs[0].inter_proto or not runs[0].union_proto):
        raise AssertionError(f"{label}: empty prototypes")
    if not all(r.recommendation for r in runs):
        raise AssertionError(f"{label}: a run without a recommendation")


def main_path(work: str, kernels) -> tuple[dict, dict, dict]:
    """Phase 5: the debugging report of all six families on cuda.  Returns
    the launches by kernel over the run, the families' directories and
    their report trees (sample:8), each equal to the cpu report."""
    from nemo_tpu_torch.analysis.pipeline import run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.models.case_studies import write_all_case_studies, write_case_study

    t0 = time.perf_counter()
    dirs = write_all_case_studies(FAMILY_RUNS, SEED, work)
    log(f"generated {len(dirs)} families x {FAMILY_RUNS} runs in {time.perf_counter() - t0:.2f} s")
    # Warm-up on a small corpus: CUDA context, cuBLAS handles, the loaded
    # kernel library and the report's host code (hazard DOTs, PGraphs, the
    # renderer and writer).  Not part of the timed main path.
    warm = write_case_study("pb_asynchronous", 12, SEED, os.path.join(work, "warm"))
    run_debug(warm, os.path.join(work, "reports", "warm"), TorchBackend(device="cuda"), figures=REPORT_FIGURES,
              corpus_cache="off", result_cache="off")
    cuda_root, cpu_root = os.path.join(work, "reports", "cuda"), os.path.join(work, "reports", "cpu")

    launches = {k.__name__: 0 for k in kernels}
    trees = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    for name, cd in dirs.items():
        res, _backend, trees[name], counts = report_counted(
            f"report {name}", cd, kernels, cuda_root, REPORT_FIGURES, name)
        add(counts)
        if len(res.molly.runs) != FAMILY_RUNS or counts["closure"] <= 0:
            raise AssertionError(f"{name}: {len(res.molly.runs)} runs reported, {counts['closure']} closure launches")
        check_report_content(name, res, protos=True)
    zk = "ZK-1270-racing-sent-flag"
    label = f"report {zk} figures=all"
    res, _backend, tree, counts = report_counted(label, dirs[zk], kernels, cuda_root, "all", f"{zk}-all")
    add(counts)
    if counts["closure"] <= 0:
        raise AssertionError(f"{label}: closure never launched")
    check_report_content(label, res, protos=True)
    shutil.rmtree(res.report_dir)
    check_report_cpu_equal(label, dirs[zk], tree, cpu_root, "all", f"{zk}-all")
    del tree

    for name, cd in dirs.items():
        # The cuda reports read the corpus through the native engine, the
        # cpu report through the Python loader.
        check_report_cpu_equal(f"report {name}", cd, trees[name], cpu_root, REPORT_FIGURES, name, ingest="python")
        # The bucket closure (2,048 graphs) takes the block variant, the
        # [V,V] diff closure the warp variant.
        expect_variants(f"report {name}", "closure", {"block", "warp"},
                        profile_family(cd, cuda_root, REPORT_FIGURES))
    return launches, dirs, trees


def ingest_path(work: str, kernels, dirs: dict, trees: dict) -> dict:
    """Phase 5b: the host ingest paths.  Each family (1,700 runs,
    sample:8) is reported on cuda by each leg, into its own report root,
    with the corpus store and the result cache under fresh roots of this
    phase: the Python loader (caches off; the first PYTHON_LEG_FAMILIES
    families only), the native engine cold
    (populating the store), a warm store hit (populating the result cache)
    and a whole-report result-cache hit, which must launch neither kernel.
    Every leg's report must equal the family's cpu report (trees).  Then
    ZK-1270 grows by INGEST_GROWN_RUNS runs under figures=failed: the
    report of the grown directory must map only the new segment and equal
    a from-scratch report.  Returns the launches by kernel over the
    phase."""
    from nemo_tpu_torch.models.synth import grow_corpus_dir

    launches = {k.__name__: 0 for k in kernels}
    root = os.path.join(work, "ingest")
    cc, rc = os.path.join(root, "corpus-cache"), os.path.join(root, "result-cache")
    legs = (
        ("python", dict(ingest="python")),
        ("native cold", dict(ingest="native", corpus_cache=cc)),
        ("warm store", dict(ingest="native", corpus_cache=cc, result_cache=rc)),
        ("rcache hit", dict(ingest="native", corpus_cache=cc, result_cache=rc)),
    )
    want_ingest = {"python": "python", "native cold": "native", "warm store": "store_hit", "rcache hit": "store_hit"}
    table = []
    for name, cd in dirs.items():
        row = {"family": name}
        for leg, kw in legs:
            if leg == "python" and name not in list(dirs)[:PYTHON_LEG_FAMILIES]:
                continue
            label = f"ingest {leg} {name}"
            res, _backend, tree, counts = report_counted(
                label, cd, kernels, os.path.join(root, "reports", leg.replace(" ", "-")), REPORT_FIGURES, name, **kw)
            for k, n in counts.items():
                launches[k] += n
            if res.ingest != want_ingest[leg]:
                raise AssertionError(f"{label}: served by {res.ingest}, expected {want_ingest[leg]}")
            hit = res.result_cache.get("state") == "report_hit"
            if hit != (leg == "rcache hit") or (hit and any(counts.values())):
                raise AssertionError(f"{label}: result cache {res.result_cache}, launches {counts}")
            if tree != trees[name]:
                differ = sorted(k for k in set(tree) | set(trees[name]) if tree.get(k) != trees[name].get(k))
                raise AssertionError(f"{label}: the report differs from the cpu report in {differ[:10]}")
            ph = res.timings
            row[leg] = {"ingest_s": round(ph["ingest"], 4), "store_populate_s": round(ph.get("store_populate", 0), 4),
                        "cache_s": round(ph.get("cache_lookup", 0) + ph.get("cache_publish", 0), 4),
                        "report_s": round(res.report_wall_s, 4),
                        "runs_per_s": round(len(res.molly.runs) / res.report_wall_s, 1), "launches": counts}
            shutil.rmtree(res.report_dir)
        log(f"ingest legs {name}: {json.dumps(row)}; every leg equals the cpu report")
        table.append(row)
    print(json.dumps({"ingest_legs": table}))

    # The grown sweep: ZK-1270's first runs, then INGEST_GROWN_RUNS more.
    zk = "ZK-1270-racing-sent-flag"
    grown = os.path.join(root, "grown", zk)
    gcc, grc = os.path.join(root, "grown-corpus-cache"), os.path.join(root, "grown-result-cache")
    n_old = FAMILY_RUNS - INGEST_GROWN_RUNS
    grow_corpus_dir(dirs[zk], grown, n_old)
    res, _backend, _tree, counts = report_counted(
        f"ingest grown {zk} first {n_old} runs", grown, kernels, os.path.join(root, "reports", "grown0"), "failed",
        zk, ingest="native", corpus_cache=gcc, result_cache=grc)
    for k, n in counts.items():
        launches[k] += n
    shutil.rmtree(res.report_dir)
    grow_corpus_dir(dirs[zk], grown, FAMILY_RUNS)
    label = f"ingest grown {zk} +{INGEST_GROWN_RUNS} runs"
    res, backend, tree, counts = report_counted(
        label, grown, kernels, os.path.join(root, "reports", "grown1"), "failed", zk, ingest="native",
        corpus_cache=gcc, result_cache=grc)
    for k, n in counts.items():
        launches[k] += n
    want = {"state": "computed", "segments_cached": 1, "segments_mapped": 1, "runs_cached": n_old,
            "runs_mapped": INGEST_GROWN_RUNS}
    if res.ingest != "store_grown" or res.result_cache != want:
        raise AssertionError(f"{label}: ingest {res.ingest}, result cache {res.result_cache}, expected {want}")
    mapped_rows = sum(r["rows"] for r in backend.analysis_routes if r["verb"] in ("fused", "giant"))
    if mapped_rows > INGEST_GROWN_RUNS + 1:  # the new runs, and the good run as context
        raise AssertionError(f"{label}: {mapped_rows} runs analysed, expected the {INGEST_GROWN_RUNS} new ones")
    shutil.rmtree(res.report_dir)
    scratch, _b, scratch_tree, counts = report_counted(
        f"ingest grown {zk} from scratch", grown, kernels, os.path.join(root, "reports", "scratch"), "failed", zk)
    for k, n in counts.items():
        launches[k] += n
    if tree != scratch_tree:
        differ = sorted(k for k in set(tree) | set(scratch_tree) if tree.get(k) != scratch_tree.get(k))
        raise AssertionError(f"{label}: the merged report differs from the from-scratch report in {differ[:10]}")
    log(f"{label}: mapped only the new segment ({mapped_rows} runs analysed); the merged report equals the "
        f"from-scratch report ({len(tree)} files)")
    shutil.rmtree(scratch.report_dir)
    for k, n in cli_grown(os.path.join(root, "cli"), kernels, dirs[zk]).items():
        launches[k] += n
    host_file_ops(os.path.join(root, "file-ops"))
    for entry in os.listdir(root):
        if entry != "corpus-cache":  # phase 6h queries the families through this store
            shutil.rmtree(os.path.join(root, entry))
    return launches


def host_file_ops(root: str, n: int = 2000) -> dict:
    """Milliseconds per file of each operation the report writer and the
    result cache make, over ``n`` files of 2 KB (the size of a small
    figure): create and write, stat, hardlink, rename."""
    src, dst, mv = (os.path.join(root, d) for d in ("src", "dst", "mv"))
    for d in (src, dst, mv):
        os.makedirs(d)
    names = [f"run_{i}_pre_prov.dot" for i in range(n)]
    payload = b"x" * 2048
    ops = {
        "write": lambda f: open(os.path.join(src, f), "wb").write(payload),
        "stat": lambda f: os.stat(os.path.join(src, f)),
        "link": lambda f: os.link(os.path.join(src, f), os.path.join(dst, f)),
        "rename": lambda f: os.rename(os.path.join(dst, f), os.path.join(mv, f)),
    }
    out = {}
    for op, fn in ops.items():
        t = time.perf_counter()
        for f in names:
            fn(f)
        out[op] = round((time.perf_counter() - t) * 1e3 / n, 4)
    shutil.rmtree(root)
    log(f"host file operations, ms per file over {n} files: {out}")
    print(json.dumps({"host_file_ops_ms": out}))
    return out


def cli_report(label: str, argv: list[str], kernels, report_dir: str):
    """One report through the CLI's entry point (nemo_tpu_torch.cli.main),
    its backend on the device lanes (DEVICE_LANES), with every kernel's
    launch count set to 0 just before and read just after.  Returns (the wall, the report's telemetry.json, its tree,
    launches by kernel name)."""
    import functools

    from nemo_tpu_torch import cli
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes

    for k in kernels:
        k.launches = 0
    LAUNCH_LOG.label = label
    backend_cls = cli.TorchBackend
    # The CLI's backend on the device lanes, like the other reports of 5b.
    cli.TorchBackend = functools.partial(backend_cls, **DEVICE_LANES)
    t = time.perf_counter()
    try:
        if cli.main(argv) != 0:
            raise AssertionError(f"{label}: the CLI failed")
    finally:
        cli.TorchBackend = backend_cls
        LAUNCH_LOG.label = None
    wall = time.perf_counter() - t
    counts = {k.__name__: k.launches for k in kernels}
    with open(os.path.join(report_dir, "telemetry.json"), encoding="utf-8") as fh:
        tel = json.load(fh)
    tree = report_tree_bytes(report_dir)
    log(f"{label}: report wall {wall:.3f} s; ingest {tel['ingest']}, result cache {tel['result_cache']}; phase "
        f"wall {json.dumps(tel['timings'])}; report {len(tree)} files; launches {counts}")
    return wall, tel, tree, counts


def cli_grown(root: str, kernels, zk_dir: str) -> dict:
    """Phase 5b's CLI leg: ZK-1270's first CLI_FIRST_RUNS runs, then
    INGEST_GROWN_RUNS more, through the CLI's defaults (figures=all, ingest auto) with both
    caches on under fresh roots, each beside the report of the same
    directory with both caches off.  The grown report must map only the
    new segment and equal its from-scratch report.  Returns the launches
    by kernel."""
    from nemo_tpu_torch.models.synth import grow_corpus_dir

    zk = os.path.basename(zk_dir)
    grown = os.path.join(root, "corpus", zk)
    caches_on = ["--corpus-cache", os.path.join(root, "cc"), "--result-cache", os.path.join(root, "rc")]
    caches_off = ["--corpus-cache", "off", "--result-cache", "off"]
    launches = {k.__name__: 0 for k in kernels}
    out, trees = {}, {}
    n_old, n_new = CLI_FIRST_RUNS, CLI_FIRST_RUNS + INGEST_GROWN_RUNS
    for leg, n_runs, caches in (("off_first", n_old, caches_off), ("on_first", n_old, caches_on),
                                ("on_grown", n_new, caches_on), ("off_grown", n_new, caches_off)):
        grow_corpus_dir(zk_dir, grown, n_runs)
        results = os.path.join(root, "reports", leg)
        wall, tel, trees[leg], counts = cli_report(
            f"cli {leg} {zk} {n_runs} runs", ["-faultInjOut", grown, "--results-dir", results, *caches],
            kernels, os.path.join(results, zk))
        for k, n in counts.items():
            launches[k] += n
        ph = tel["timings"]
        out[leg] = {"runs": n_runs, "report_s": round(wall, 4), "ingest": tel["ingest"],
                    "result_cache": tel["result_cache"],
                    "cache_s": round(ph.get("cache_lookup", 0) + ph.get("cache_publish", 0), 4),
                    "phases": tel["timings"], "launches": counts}
        shutil.rmtree(results)
    want = {"state": "computed", "segments_cached": 1, "segments_mapped": 1, "runs_cached": n_old,
            "runs_mapped": INGEST_GROWN_RUNS}
    if out["on_grown"]["ingest"] != "store_grown" or out["on_grown"]["result_cache"] != want:
        raise AssertionError(f"cli on_grown {zk}: {out['on_grown']}, expected {want}")
    for a, b in (("on_first", "off_first"), ("on_grown", "off_grown")):
        if trees[a] != trees[b]:
            differ = sorted(k for k in set(trees[a]) | set(trees[b]) if trees[a].get(k) != trees[b].get(k))
            raise AssertionError(f"cli {a} {zk}: the report differs from the caches-off report in {differ[:10]}")
    log(f"cli {zk}: with the caches on, each report equals the caches-off report ({len(trees['on_grown'])} files)")
    print(json.dumps({"cli_grown": out}))
    return launches


def sparse_path(work: str, kernels, zk_dir: str, zk_dense_tree: dict) -> tuple[dict, dict, tuple]:
    """Phase 6: the reports that take the sparse-CSR device tier on cuda.
    Returns the launches by kernel over them, the giant corpora's
    directories by name and the sweep's (directory, report tree), the tree
    equal to the cpu report."""
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    launches = {k.__name__: 0 for k in kernels}
    cuda_root, cpu_root = os.path.join(work, "reports", "cuda"), os.path.join(work, "reports", "cpu")

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) Giant-V corpora on the device lanes: every run above GIANT_V nodes
    # leaves the buckets for its own sparse_fused dispatch (the buckets left
    # hold only runs of at most GIANT_V nodes, as their V bucket shows), and
    # a giant good run's diff goes to the host lane, first in the JAX
    # package's diff order, whatever the budgets: no K2 launch comes from it.
    host_giant_diffs = 0
    giant_dirs = []
    for name, n_runs, seed, eot in GIANT_SPECS:
        t = time.perf_counter()
        cd = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, eot=eot, name=name), work)
        log(f"generated {name} in {time.perf_counter() - t:.2f} s")
        giant_dirs.append(cd)
        figures = GIANT_FIGURES[name]
        res, backend, tree, counts = report_counted(f"report {name}", cd, kernels, cuda_root, figures, name)
        add(counts)
        routes, dispatches, runs = backend.analysis_routes, backend.executor.dispatches, len(res.molly.runs)
        fused = [r for r in routes if r["verb"] == "fused"]
        giants = [r for r in routes if r["verb"] == "giant"]
        (diff,) = [r for r in routes if r["verb"] == "diff"]
        n_sparse = len(giants) + sum(r["route"] == "sparse_device" for r in fused)
        if (
            not giants
            or any(r["route"] != "sparse_device" or r["rows"] != 1 for r in giants)
            or any(r["v"] > GIANT_V for r in fused)
            or sum(r["rows"] for r in fused) + len(giants) != runs
            or dispatches.get("sparse_fused", 0) != n_sparse
        ):
            raise AssertionError(f"{name}: giant runs not each on sparse_fused: {routes}")
        if diff["v"] > GIANT_V:  # the good run's node count
            shared = [key for (k, key), rec in LAUNCH_LOG.shapes.items()
                      if k == "edge_wave" and key[3] and f"report {name}" in rec["launches"]]
            if ((diff["route"], diff["reason"]) != ("sparse", "giant") or "sparse_diff" in dispatches
                    or backend.executor.host_runs.get("sparse_diff") != 1 or shared):
                raise AssertionError(f"{name}: a giant good run's diff not on the host lane: {diff}, "
                                     f"shared-list K2 launches {shared}")
            host_giant_diffs += 1
        if counts["edge_wave"] <= 0:
            raise AssertionError(f"{name}: edge_wave never launched")
        if figures == "all" and not any("diff_post_prov-diff" in k for k in tree):
            raise AssertionError(f"{name}: no diff overlay in the report")
        check_report_content(name, res)
        check_report_cpu_equal(f"report {name}", cd, tree, cpu_root, figures, name)
    if not host_giant_diffs:
        raise AssertionError("no giant corpus had a giant good run")
    for cd in giant_dirs:
        name = os.path.basename(cd)
        label, profile = f"report {name}", profile_family(cd, cuda_root, GIANT_FIGURES[name])
        expect_variants(label, "edge_wave", {"worklist_block"}, profile)
        if launched_variants(label, "closure"):  # sd_giantv's V = 2,048 diff closure
            expect_variants(label, "closure", {"global"}, profile)

    # (b) The long-horizon sweep on the auto route: some buckets past the
    # dense memory watermark go sparse by "mem", the others stay dense, so
    # both kernels launch in one report.
    name, n_runs, seed, eot = SWEEP_SPEC
    t = time.perf_counter()
    cd = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, eot=eot, name=name), work)
    log(f"generated {name} in {time.perf_counter() - t:.2f} s")
    res, backend, tree, counts = report_counted(f"report {name}", cd, kernels, cuda_root, REPORT_FIGURES, name)
    add(counts)
    split = {(r["route"], r["reason"]) for r in backend.analysis_routes if r["verb"] == "fused"}
    if ("sparse_device", "mem") not in split or not any(route == "dense" for route, _ in split):
        raise AssertionError(f"{name}: buckets did not split between the tiers: {backend.analysis_routes}")
    if len(res.molly.runs) != n_runs or min(counts.values()) <= 0:
        raise AssertionError(f"{name}: {len(res.molly.runs)} runs, launches {counts}")
    check_report_content(name, res)
    check_report_cpu_equal(f"report {name}", cd, tree, cpu_root, REPORT_FIGURES, name)
    profile = profile_family(cd, cuda_root, REPORT_FIGURES)
    # The mem-routed V = 256 bucket (1,024 runs, all resident at once) takes
    # the staged waves, the diff's shared V = 512 list the warp worklist;
    # the dense buckets are batches, on the block variant.
    expect_variants(f"report {name}", "edge_wave", {"waves_staged", "worklist_warp"}, profile)
    expect_variants(f"report {name}", "closure", {"block"}, profile)
    sweep = (cd, tree)

    # (c) ZK-1270 forced onto the sparse tier: the report equals the dense
    # one of the main path byte for byte, and no dense kernel runs.
    label = "report ZK-1270 forced sparse_device"
    res, backend, tree, counts = report_counted(label, zk_dir, kernels, cuda_root, REPORT_FIGURES,
                                                "ZK-1270-sparse_device", analysis_impl="sparse_device")
    add(counts)
    if counts["closure"] != 0 or counts["edge_wave"] <= 0:
        raise AssertionError(f"ZK-1270 forced sparse: launches {counts}")
    if {r["route"] for r in backend.analysis_routes} != {"sparse_device"}:
        raise AssertionError(f"ZK-1270 forced sparse: routes {backend.analysis_routes}")
    if tree != zk_dense_tree:
        raise AssertionError("ZK-1270: the forced-sparse report differs from the dense one")
    log("ZK-1270: the forced-sparse report equals the dense report byte for byte")
    # The buckets (2,048 runs, two rounds of wave CTAs) take the warp
    # worklist, the diff's shared V = 32 list the staged waves.
    expect_variants(label, "edge_wave", {"worklist_warp", "waves_staged"},
                    profile_family(zk_dir, cuda_root, REPORT_FIGURES, analysis_impl="sparse_device"))
    return launches, {os.path.basename(cd): cd for cd in giant_dirs}, sweep


def lane_ms(fn, iters: int = LANE_ITERS) -> float:
    """Wall ms per call of one lane, the card synchronized after each: the
    host lane's numpy, or a device lane's executor call (upload, kernels,
    the copy of its outputs back)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def _same_lane_outputs(label: str, host: dict, dev: dict, keys, rows: int) -> None:
    for k in keys:
        a, b = host[k], dev[k]
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if not np.array_equal(a[:rows], b[:rows]):
            raise AssertionError(f"lanes {label}: the host lane's {k} differs from the device lane's")


def _lane_backend(molly):
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    tb = TorchBackend(device="cuda")
    tb.init_graph_db("", molly)
    return tb


def route_lanes(kernels, dirs: dict, giant_dirs: dict) -> tuple[list[dict], dict]:
    """Phase 6d's lane timings: at every shape the default routes send to
    one lane or the other, both lanes on the same inputs, in one call, each
    checked equal to the other: the families' diffs (host against the dense
    diff), giant10k's diff (host against sparse_diff, the shared-list K2
    launches no report makes since the giant diff takes the host lane), the
    buckets of grown ZK-1270's new segment (the host step against the dense
    fused step) and one family's synth bucket (host against synth_ext).
    The device lane's checked call at each shape is counted like a report
    (the launch counts zeroed just before, read just after, the LaunchLog
    labelled), so phase 7 times its kernels at these shapes; the timing
    loops' launches are not.  Returns the rows and the counted launches by
    kernel."""
    from nemo_tpu_torch.analysis import delta
    from nemo_tpu_torch.backend.torch_backend import _verb_arrays
    from nemo_tpu_torch.graphs.packed import bucket_size
    from nemo_tpu_torch.ingest.native import load_molly_output_packed
    from nemo_tpu_torch.ops.sparse_host import sparse_analysis_step, synth_ext_host

    rows_out = []
    launches = {k.__name__: 0 for k in kernels}

    def counted(label, fn):
        for k in kernels:
            k.launches = 0
        LAUNCH_LOG.label = label
        try:
            out = fn()
        finally:
            LAUNCH_LOG.label = None
        for k in kernels:
            launches[k.__name__] += k.launches
        log(f"{label}: launches {({k.__name__: k.launches for k in kernels})}")
        return out

    def add(label, route, work, shape, host_fn, dev_fn, dev_lane, iters=LANE_ITERS):
        row = {"shape": label, "default_route": route, "work": int(work), **shape, "iters": iters,
               "host_ms": lane_ms(host_fn, iters), f"{dev_lane}_ms": lane_ms(dev_fn, iters)}
        rows_out.append(row)
        log(f"lanes {label}: {json.dumps(row)}")

    diff_keys = ("node_keep", "frontier_rule", "missing_goal")
    for name, cd in list(dirs.items()) + [("giant10k", giant_dirs["giant10k"])]:
        molly = load_molly_output_packed(cd)
        tb = _lane_backend(molly)
        failed = molly.get_failed_runs_iters()
        _g, good, gb, bits = tb._diff_batch(failed)
        n = len(failed)
        route, reason, work = tb._diff_route(good.n_nodes, len(good.edges), n, bits.shape[0], gb.v)
        dev_route = "sparse_device" if name == "giant10k" else "dense"
        host = tb._diff_dispatch("sparse", good, gb, bits, n)
        dev = counted(f"lanes diff {name}", lambda: tb._diff_dispatch(dev_route, good, gb, bits, n))
        _same_lane_outputs(f"diff {name}", host, dev, diff_keys, n)
        if name == "giant10k":  # the shared-list worklist of a giant good run's device-lane diff
            expect_variants(f"lanes diff {name}", "edge_wave", {"worklist_block"}, {})
        else:  # the [V,V] diff closure of the families' device-lane reports
            expect_variants(f"lanes diff {name}", "closure", {"warp"}, {})
        add(f"diff {name}", f"{route}/{reason}", work,
            {"F": n, "V": gb.v, "good_nodes": good.n_nodes, "good_edges": len(good.edges)},
            lambda: tb._diff_dispatch("sparse", good, gb, bits, n),
            lambda: tb._diff_dispatch(dev_route, good, gb, bits, n), dev_route,
            iters=2 if name == "giant10k" else LANE_ITERS)
        tb.close_db()

    # Grown ZK-1270's new segment, as the grown report maps it: its last
    # INGEST_GROWN_RUNS runs and the good run as context.
    zk = "ZK-1270-racing-sent-flag"
    molly = load_molly_output_packed(dirs[zk])
    good = delta.choose_good_run(molly)
    pos = {r.iteration: i for i, r in enumerate(molly.runs)}
    rows = sorted(set(range(FAMILY_RUNS - INGEST_GROWN_RUNS, FAMILY_RUNS)) | {pos[good]})
    tb = _lane_backend(delta.subset_molly(molly, rows))
    plan = tb._plan_fused_inputs()
    summary = ("pre_holds", "post_holds", "pre_alive", "post_alive", "pre_type", "post_type", "proto_bits",
               "proto_min_depth", "proto_present")
    for pre_b, post_b in plan["batches"]:
        b = len(pre_b.run_ids)
        route, reason, work = tb._analysis_route(b, pre_b.v, pre_b.e, pre_b.is_goal.shape[0])
        linear = all(tb._lin_by_iter[i] for i in pre_b.run_ids)
        params = dict(v=pre_b.v, max_depth=bucket_size(max(pre_b.max_depth, post_b.max_depth), plan["min_d"]),
                      comp_linear=int(linear), num_labels=8, with_diff=0, **plan["tids"])

        def host_fn(pre_b=pre_b, post_b=post_b, linear=linear):
            return sparse_analysis_step(pre_b, post_b, v=pre_b.v, comp_linear=linear, **plan["tids"])

        def dev_fn(pre_b=pre_b, post_b=post_b, params=params):
            return tb.executor.run("fused", _verb_arrays(pre_b, post_b), params, rows=len(pre_b.run_ids))

        _same_lane_outputs(f"fused grown {zk} ({b}, {pre_b.v}, {pre_b.e})", host_fn(),
                           counted(f"lanes fused grown {zk} ({b}, {pre_b.v}, {pre_b.e})", dev_fn), summary, b)
        add(f"fused grown {zk} new segment", f"{route}/{reason}", work, {"B": b, "V": pre_b.v, "E": pre_b.e},
            host_fn, dev_fn, "dense")
    tb.close_db()

    # One family's synth bucket (1,700 runs: past the synth budget).
    tb = _lane_backend(molly)
    pre_b, _post_b, res = tb._fused()[0]
    b = len(pre_b.run_ids)
    holds = np.asarray(res["pre_holds"])
    nt = int(np.asarray(res["proto_bits"]).shape[1])
    arrays = {f: getattr(pre_b, f) for f in ("edge_src", "edge_dst", "edge_mask", "is_goal", "node_mask",
                                             "type_id", "table_id")}
    arrays["holds"] = holds
    route, reason, work = tb._synth_route(b, pre_b.v, pre_b.e)
    host = {"ext_bits": synth_ext_host(pre_b, holds, nt)}
    dev = counted(f"lanes synth {zk}",
                  lambda: tb.executor.run("synth_ext", arrays, {"v": pre_b.v, "num_tables": nt}, rows=b))
    _same_lane_outputs(f"synth {zk}", host, dev, ("ext_bits",), b)
    add(f"synth {zk}", f"{route}/{reason}", work, {"B": b, "V": pre_b.v, "E": pre_b.e},
        lambda: synth_ext_host(pre_b, holds, nt),
        lambda: tb.executor.run("synth_ext", arrays, {"v": pre_b.v, "num_tables": nt}, rows=b), "sparse_device")
    tb.close_db()
    return rows_out, launches


def routes_path(work: str, kernels, dirs: dict, trees: dict, giant_dirs: dict) -> dict:
    """Phase 6d: the six families' reports on the default routes (the host
    budgets of the JAX package), each into a fresh root with the launch
    counts zeroed just before and read just after, each equal to the
    family's cpu report (``trees``, the cuda reports of phase 5 that equal
    it); then giant10k on the default routes, its diff on the host lane by
    "giant" with no K2 launch from it, equal to its cpu report; their route
    records as a JSON line {"default_routes": {...}}.  Returns the launches
    by kernel."""
    launches = {k.__name__: 0 for k in kernels}
    root = os.path.join(work, "routes")
    table = {}
    for name, cd in dirs.items():
        label = f"routes {name}"
        res, backend, tree, counts = report_counted(label, cd, kernels, root, REPORT_FIGURES, name,
                                                    default_routes=True)
        for k, n in counts.items():
            launches[k] += n
        if tree != trees[name]:
            differ = sorted(k for k in set(tree) | set(trees[name]) if tree.get(k) != trees[name].get(k))
            raise AssertionError(f"{label}: the default-route report differs from the cpu report in {differ[:10]}")
        (diff,) = [r for r in backend.analysis_routes if r["verb"] == "diff"]
        if (diff["route"], diff["reason"]) != ("sparse", "crossover"):
            raise AssertionError(f"{label}: the families' diff is not on the host lane: {diff}")
        # The bucket closure only: the diff no longer launches the warp variant.
        expect_variants(label, "closure", {"block"}, {})
        table[name] = backend.analysis_routes
        shutil.rmtree(res.report_dir)
    name = "giant10k"
    label = f"routes {name}"
    res, backend, tree, counts = report_counted(label, giant_dirs[name], kernels, root, GIANT_FIGURES[name], name,
                                                default_routes=True)
    for k, n in counts.items():
        launches[k] += n
    (diff,) = [r for r in backend.analysis_routes if r["verb"] == "diff"]
    shared = [key for (k, key), rec in LAUNCH_LOG.shapes.items() if k == "edge_wave" and key[3] and label in rec["launches"]]
    if (diff["route"], diff["reason"]) != ("sparse", "giant") or shared or counts["edge_wave"] <= 0:
        raise AssertionError(f"{label}: diff {diff}, shared-list K2 launches {shared}, launches {counts}")
    check_report_cpu_equal(label, giant_dirs[name], tree, os.path.join(root, "cpu"), GIANT_FIGURES[name], name,
                           default_routes=True)
    table[name] = backend.analysis_routes
    shutil.rmtree(res.report_dir)
    print(json.dumps({"default_routes": table}))
    return launches


def dirs_path(work: str, kernels, dirs: dict, trees: dict) -> dict:
    """Phase 6e: run_debug_dirs over the six families (native ingest, caches
    off, default routes), prefetch off, then on, in one call, each with
    the launch counts zeroed before and read after, every report equal to
    its cpu report (``trees``).  Prints the total wall, each corpus's
    ``ingest`` on the critical path, the prefetched parses' walls on the
    worker thread and the shared scheduler's drain wall
    ({"run_debug_dirs": [...]}).  Returns the launches by kernel."""
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug_dirs
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    launches = {k.__name__: 0 for k in kernels}
    rows = []
    for i, prefetch in enumerate((False, True)):
        label = f"dirs prefetch {'on' if prefetch else 'off'} #{i}"
        out_root = os.path.join(work, "dirs", str(i))
        for k in kernels:
            k.launches = 0
        LAUNCH_LOG.label = label
        t = time.perf_counter()
        try:
            results = run_debug_dirs(list(dirs.values()), out_root, lambda: TorchBackend(device="cuda"),
                                     prefetch=prefetch, figures=REPORT_FIGURES, ingest="native", corpus_cache="off",
                                     result_cache="off")
        finally:
            LAUNCH_LOG.label = None
        wall = time.perf_counter() - t
        counts = {k.__name__: k.launches for k in kernels}
        for k, n in counts.items():
            launches[k] += n
        for r in results:
            name = os.path.basename(r.report_dir)
            if report_tree_bytes(r.report_dir) != trees[name]:
                raise AssertionError(f"{label}: the report of {name} differs from the cpu report")
        row = {"prefetch": prefetch, "wall_s": round(wall, 4),
               "ingest_s": {os.path.basename(r.report_dir): round(r.timings["ingest"], 4) for r in results},
               "ingest_prefetch_s": {os.path.basename(r.report_dir): round(r.timings["ingest_prefetch"], 4)
                                     for r in results if "ingest_prefetch" in r.timings},
               "drain_wall_s": results[0].figure_stats["drain_wall_s"], "launches": counts}
        rows.append(row)
        log(f"{label}: {json.dumps(row)}; every report equals the cpu report")
        shutil.rmtree(out_root)
    print(json.dumps({"run_debug_dirs": rows}))
    return launches


def stream_path(work: str, kernels, zk_dir: str) -> dict:
    """Phase 6f: ZK-1270 put in the corpus store in three appends
    (STREAM_APPENDS runs), then reported on the default routes with
    STREAM_FIGURES and a fresh result cache, streamed (NEMO_STREAM=on) and
    in memory (off), each mapping the three segments and publishing three
    checkpoints; the two reports equal each other and the cpu report; then
    the streamed one again as a whole-report hit with no launch.  Prints
    staged_bytes, the peak RSS and the checkpoints ({"stream": {...}}).
    Returns the launches by kernel."""
    from nemo_tpu_torch.analysis import delta, pipeline
    from nemo_tpu_torch.models.synth import grow_corpus_dir
    from nemo_tpu_torch.store import resolve_store

    launches = {k.__name__: 0 for k in kernels}
    root = os.path.join(work, "stream")
    zk = os.path.basename(zk_dir)
    d, cc = os.path.join(root, "corpus", zk), os.path.join(root, "corpus-cache")
    store = resolve_store(cc)
    for n in STREAM_APPENDS:
        grow_corpus_dir(zk_dir, d, n)
        molly, _kind, snap = pipeline._ingest(d, True, store)
        if snap is not None:
            pipeline._populate(store, d, molly, snap)
    segs = [s.n_runs for s in delta.corpus_segments(store.load_packed(d))]
    if len(segs) != len(STREAM_APPENDS):
        raise AssertionError(f"stream {zk}: the store holds segments {segs}")
    out, trees = {"segments": segs}, {}
    saved = os.environ.get("NEMO_STREAM")
    try:
        for mode in ("on", "off"):
            os.environ["NEMO_STREAM"] = mode
            label = f"stream {mode} {zk}"
            res, _backend, trees[mode], counts = report_counted(
                label, d, kernels, os.path.join(root, "reports", mode), STREAM_FIGURES, zk, ingest="native",
                corpus_cache=cc, result_cache=os.path.join(root, f"rc-{mode}"), default_routes=True)
            for k, n in counts.items():
                launches[k] += n
            st = res.stream
            if (st.get("streamed") != (mode == "on") or st.get("segments_mapped") != len(segs)
                    or st.get("checkpoints") != len(segs) or (mode == "on") != (st.get("staged_bytes", 0) > 0)):
                raise AssertionError(f"{label}: stream record {st}")
            out[mode] = {"report_s": round(res.report_wall_s, 4), "phases": {k: round(v, 4) for k, v in
                                                                              res.timings.items()},
                         "stream": st, "result_cache": res.result_cache, "launches": counts}
            shutil.rmtree(res.report_dir)
        os.environ["NEMO_STREAM"] = "on"
        label = f"stream hit {zk}"
        res, _backend, hit_tree, counts = report_counted(
            label, d, kernels, os.path.join(root, "reports", "hit"), STREAM_FIGURES, zk, ingest="native",
            corpus_cache=cc, result_cache=os.path.join(root, "rc-on"), default_routes=True)
        if res.result_cache != {"state": "report_hit"} or any(counts.values()) or hit_tree != trees["on"]:
            raise AssertionError(f"{label}: result cache {res.result_cache}, launches {counts}")
        out["hit"] = {"report_s": round(res.report_wall_s, 4), "launches": counts}
    finally:
        if saved is None:
            os.environ.pop("NEMO_STREAM", None)
        else:
            os.environ["NEMO_STREAM"] = saved
    if trees["on"] != trees["off"]:
        raise AssertionError(f"stream {zk}: the streamed report differs from the in-memory one")
    check_report_cpu_equal(f"stream {zk}", d, trees["on"], os.path.join(root, "cpu"), STREAM_FIGURES, zk,
                           ingest="python", default_routes=True)
    print(json.dumps({"stream": out}))
    shutil.rmtree(root)
    return launches


def _cpu_tree(cd: str, out_root: str, figures: str, name: str, default_routes: bool = True, **run_kw) -> dict:
    """The report tree of ``cd`` on the cpu, the same routes, the given
    cache roots (default off)."""
    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    run_kw = {"corpus_cache": "off", "result_cache": "off", **run_kw}
    res = run_debug(cd, out_root, TorchBackend(device="cpu", **_lanes(default_routes, {})), figures=figures,
                    report_name=name, **run_kw)
    tree = report_tree_bytes(res.report_dir)
    shutil.rmtree(res.report_dir)
    return tree


def _same_tree(label: str, got: dict, want: dict, what: str) -> None:
    if got != want:
        differ = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"{label}: the report differs from {what} in {differ[:10]}")


def _bucket_routes(backend) -> list:
    return [(r["verb"], r["route"], r["rows"], r["v"], r["reason"]) for r in backend.analysis_routes]


def adversarial_leg(root: str, kernels, add) -> dict:
    """Phase 6g (a): the five adversarial families, each on ADV_LANES, each
    report equal to the cpu report on the same lanes; K2 must launch on the
    forced sparse_device reports."""
    from nemo_tpu_torch.models.synth import ADVERSARIAL_FAMILIES, adversarial_spec, write_corpus

    out = {}
    for fam in ADVERSARIAL_FAMILIES:
        cd = write_corpus(adversarial_spec(fam, n_runs=ADV_RUNS, seed=ADV_SEED), os.path.join(root, "corpora"))
        row = {}
        for lane, kw, default_routes in ADV_LANES:
            label = f"adversarial {fam} {lane}"
            res, backend, tree, counts = report_counted(label, cd, kernels, os.path.join(root, "cuda"), "none",
                                                        f"{fam}-{lane}", default_routes=default_routes, **kw)
            add(counts)
            if lane == "sparse_device" and counts["edge_wave"] <= 0:
                raise AssertionError(f"{label}: edge_wave never launched")
            check_report_content(label, res)
            check_report_cpu_equal(label, cd, tree, os.path.join(root, "cpu"), "none", f"{fam}-{lane}",
                                   default_routes=default_routes, **kw)
            variants = {k: launched_variants(label, k) for k in ("closure", "edge_wave")}
            row[lane] = {"wall_s": round(res.report_wall_s, 4), "launches": counts, "variants": variants,
                         "routes": _bucket_routes(backend)}
            log(f"{label}: wall {res.report_wall_s:.3f} s, launches {counts}, plan variants {variants}")
            shutil.rmtree(res.report_dir)
        out[fam] = row
    out["plans_checked"] = adversarial_plans()
    return out


def adversarial_plans() -> int:
    """Every launch plan of K1 and K2 (not only the one the wrapper takes:
    the worklist traversals, K1's variants that stop at the fix point) on
    the inputs the adversarial reports launched them with, each equal to
    the plain version.  These check launches are not main-path launches.
    Returns the plans checked."""
    from nemo_tpu_torch.kernels import closure as closure_mod
    from nemo_tpu_torch.kernels import edge_wave as ew_mod

    before = closure_mod.closure.launches, ew_mod.edge_wave.launches
    checked = 0
    for (kernel, key), rec in LAUNCH_LOG.shapes.items():
        if not any(label.startswith("adversarial") for label in rec["launches"]):
            continue
        args = rec["args"]
        if kernel == "closure":
            adj = args[0].contiguous()
            max_len = rec["kw"].get("max_len", args[1] if len(args) > 1 else None)
            want = closure_mod.closure_plain(adj, max_len=max_len)
            plans = closure_mod.closure_plans(key[0], key[1])
            got = {v: closure_mod.launch_plan(adj, plan, max_len) for v, plan in plans.items()}
        else:
            state, src, dst, mask = args[:4]
            n_steps = key[4]
            want = ew_mod.edge_wave_plain(state, src, dst, mask, n_steps)
            plans = ew_mod.edge_wave_plans(key[0], key[1], key[2], n_steps)
            got = {v: ew_mod.launch_plan(plan, state, src, dst, mask, n_steps) for v, plan in plans.items()}
        bad = sorted(v for v, out in got.items() if not torch.equal(out, want))
        if bad:
            raise AssertionError(f"{kernel} {key}: plans {bad} differ from the plain version on adversarial inputs")
        checked += len(got)
        log(f"adversarial inputs {kernel} {key}: plans {sorted(got)} equal the plain version")
    closure_mod.closure.launches, ew_mod.edge_wave.launches = before
    return checked


def trace_leg(root: str, kernels, add, src_dir: str) -> dict:
    """Phase 6g (b): a family in the trace-JSON layout (molly_to_trace),
    sample:8, cold into a fresh store and then a warm store hit, both equal
    to the cpu report; then its first 1,500 runs grown to 1,700 inside the
    one document: the grown report must be a store append mapping exactly
    the new runs and equal its from-scratch report and the cpu report."""
    from nemo_tpu_torch.ingest.adapters import TraceJsonInjector, molly_to_trace

    fam = os.path.basename(src_dir)
    t = time.perf_counter()
    trace = molly_to_trace(src_dir, os.path.join(root, "trace", fam))
    out = {"convert_s": round(time.perf_counter() - t, 4)}
    cc = os.path.join(root, "trace-cc")
    want = _cpu_tree(trace, os.path.join(root, "cpu"), REPORT_FIGURES, fam)
    for leg, kind in (("cold", "python"), ("warm", "store_hit")):
        label = f"trace {leg} {fam}"
        res, _b, tree, counts = report_counted(label, trace, kernels, os.path.join(root, "cuda", leg), REPORT_FIGURES,
                                               fam, corpus_cache=cc, default_routes=True)
        add(counts)
        if res.ingest != kind:
            raise AssertionError(f"{label}: served by {res.ingest}, expected {kind}")
        _same_tree(label, tree, want, "the cpu report")
        out[leg] = {"wall_s": round(res.report_wall_s, 4), "ingest_s": round(res.timings["ingest"], 4),
                    "store_populate_s": round(res.timings.get("store_populate", 0), 4), "launches": counts}
        shutil.rmtree(res.report_dir)
    live = os.path.join(root, "trace-live", fam)
    gcc, grc = os.path.join(root, "trace-grown-cc"), os.path.join(root, "trace-grown-rc")
    n_old = FAMILY_RUNS - INGEST_GROWN_RUNS
    for n in (n_old, FAMILY_RUNS):
        TraceJsonInjector.materialize_prefix(trace, live, n)
        label = f"trace grown {fam} {n} runs"
        res, _b, tree, grown_counts = report_counted(label, live, kernels, os.path.join(root, "cuda", f"g{n}"),
                                                     PARTIAL_FIGURES, fam, corpus_cache=gcc, result_cache=grc,
                                                     default_routes=True)
        add(grown_counts)
        shutil.rmtree(res.report_dir)
    want_rc = {"state": "computed", "segments_cached": 1, "segments_mapped": 1, "runs_cached": n_old,
               "runs_mapped": INGEST_GROWN_RUNS}
    if res.ingest != "store_grown" or res.result_cache != want_rc:
        raise AssertionError(f"{label}: ingest {res.ingest}, result cache {res.result_cache}, expected {want_rc}")
    scratch, _b, scratch_tree, counts = report_counted(f"trace grown {fam} from scratch", live, kernels,
                                                       os.path.join(root, "cuda", "scratch"), PARTIAL_FIGURES, fam,
                                                       default_routes=True)
    add(counts)
    shutil.rmtree(scratch.report_dir)
    _same_tree(label, tree, scratch_tree, "the from-scratch report")
    _same_tree(label, tree, _cpu_tree(live, os.path.join(root, "cpu"), PARTIAL_FIGURES, fam), "the cpu report")
    out["grown"] = {"wall_s": round(res.report_wall_s, 4), "scratch_wall_s": round(scratch.report_wall_s, 4),
                    "ingest_s": round(res.timings["ingest"], 4), "result_cache": res.result_cache,
                    "launches": grown_counts}
    log(f"trace {fam}: {json.dumps(out)}; every report equals the cpu report, the grown one its from-scratch report")
    return out


def quarantine_leg(root: str, kernels, add, src_dir: str) -> dict:
    """Phase 6g (c): a family with the post provenance files of
    QUARANTINE_POSITIONS truncated, reported with a fresh store and result
    cache: cold (stored with its quarantine records), warm (a whole-report
    hit, no launch, quarantine.json there), then with one file repaired (a
    store append of that run alone: exactly 1 run mapped, another report
    key); the same sequence on the cpu with its own caches gives the same
    trees."""
    from nemo_tpu_torch.analysis import delta
    from nemo_tpu_torch.store import CorpusStore

    fam = os.path.basename(src_dir)
    d = os.path.join(root, "quarantine", fam)
    shutil.copytree(src_dir, d)
    for pos in QUARANTINE_POSITIONS:
        path = os.path.join(d, f"run_{pos}_post_provenance.json")
        with open(path, "rb") as fh:
            body = fh.read()
        with open(path, "wb") as fh:
            fh.write(body[: len(body) // 2])
    cc, rc = os.path.join(root, "q-cc"), os.path.join(root, "q-rc")
    cpu_caches = {"corpus_cache": os.path.join(root, "q-cpu-cc"), "result_cache": os.path.join(root, "q-cpu-rc")}
    out, trees, keys = {}, {}, {}
    for leg in ("cold", "warm", "repaired"):
        if leg == "repaired":
            name = f"run_{QUARANTINE_POSITIONS[0]}_post_provenance.json"
            shutil.copy2(os.path.join(src_dir, name), os.path.join(d, name))
        label = f"quarantine {leg} {fam}"
        res, _b, tree, counts = report_counted(label, d, kernels, os.path.join(root, "cuda", f"q-{leg}"),
                                               PARTIAL_FIGURES, fam, corpus_cache=cc, result_cache=rc,
                                               default_routes=True)
        add(counts)
        shutil.rmtree(res.report_dir)
        trees[leg], keys[leg] = tree, delta.report_cache_key(res.molly, PARTIAL_FIGURES)
        left = QUARANTINE_POSITIONS[1:] if leg == "repaired" else QUARANTINE_POSITIONS
        if [q["position"] for q in json.loads(tree.get("quarantine.json", b"[]"))] != list(left):
            raise AssertionError(f"{label}: quarantine.json lists {tree.get('quarantine.json', b'')[:200]!r}")
        with open(os.path.join(CorpusStore(cc).store_dir(d), "header.json"), encoding="utf-8") as fh:
            stored = [q["position"] for q in json.load(fh).get("quarantined", [])]
        if stored != list(left):
            raise AssertionError(f"{label}: the store header lists quarantined positions {stored}")
        n_healthy = FAMILY_RUNS - len(QUARANTINE_POSITIONS)
        want = {"cold": ("python_quarantine_fallback", {"state": "computed", "segments_cached": 0,
                                                        "segments_mapped": 1, "runs_cached": 0,
                                                        "runs_mapped": n_healthy}),
                "warm": ("store_hit", {"state": "report_hit"}),
                "repaired": ("store_grown", {"state": "computed", "segments_cached": 1, "segments_mapped": 1,
                                             "runs_cached": n_healthy, "runs_mapped": 1})}[leg]
        if (res.ingest, res.result_cache) != want:
            raise AssertionError(f"{label}: ingest {res.ingest}, result cache {res.result_cache}, expected {want}")
        if leg == "warm" and any(counts.values()):
            raise AssertionError(f"{label}: a report-cache hit launched {counts}")
        if leg != "warm":
            _same_tree(label, tree, _cpu_tree(d, os.path.join(root, "cpu"), PARTIAL_FIGURES, fam, **cpu_caches),
                       "the cpu report")
        out[leg] = {"wall_s": round(res.report_wall_s, 4), "ingest": res.ingest, "result_cache": res.result_cache,
                    "quarantined": stored, "launches": counts}
    _same_tree("quarantine warm", trees["warm"], trees["cold"], "the cold report")
    if keys["repaired"] == keys["warm"] or None in keys.values():
        raise AssertionError(f"quarantine {fam}: report keys {keys}")
    log(f"quarantine {fam}: {json.dumps(out)}; every report equals the cpu report, the warm one the cold one")
    return out


def watch_leg(label: str, root: str, kernels, add, src_dir: str, generations: int, figures: str,
              check_generation=None, **backend_kw) -> dict:
    """Phase 6g (d): a Watcher (watch/watcher.py) tails an empty directory
    while ``src_dir`` is replayed into it generation by generation (the
    next written after the previous update is published), with fresh
    caches, each cycle on a TorchBackend on cuda with ``backend_kw`` built
    on the watcher's thread; the launch counts are zeroed before the first
    generation and read after the last.  Each update must map exactly its
    new runs; a failed cycle fails the phase.  ``check_generation(n,
    tree)`` holds each published tree.  Returns the updates, the watched
    directory and the last tree."""
    import threading

    from nemo_tpu_torch.analysis.pipeline import report_tree_bytes
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.ingest.adapters import MollyInjector
    from nemo_tpu_torch.watch import WatchConfig, Watcher, replay_plan

    name = os.path.basename(src_dir)
    live = os.path.join(root, label, name)
    os.makedirs(live)
    plan = replay_plan(MollyInjector.count_runs(src_dir), generations)
    cfg = WatchConfig(poll_s=0.05, debounce_s=0.05, max_updates=len(plan), figures=figures,
                      run_debug_kwargs={"corpus_cache": os.path.join(root, label + "-cc"),
                                        "result_cache": os.path.join(root, label + "-rc")})
    watcher = Watcher(live, os.path.join(root, label + "-results"),
                      lambda: TorchBackend(device="cuda", **backend_kw), cfg)
    q = watcher.subscribe()
    for k in kernels:
        k.launches = 0
    LAUNCH_LOG.label = label
    th = threading.Thread(target=watcher.run, name="smoke-watch", daemon=True)
    th.start()
    updates, tree = [], None
    t0 = time.perf_counter()
    try:
        for n in plan:
            MollyInjector.materialize_prefix(src_dir, live, n)
            ev = q.get(timeout=600)
            if ev["event"] != "report_update":
                raise AssertionError(f"{label}: {ev}")
            row = {k: ev[k] for k in ("update", "runs_total", "new_runs", "runs_mapped", "segments_cached",
                                      "kernel_dispatches", "update_latency_s", "changed_total")}
            with open(os.path.join(ev["report_dir"], "telemetry.json"), encoding="utf-8") as fh:
                row["phases"] = {k: round(v, 4) for k, v in json.load(fh)["timings"].items()}
            log(f"{label} update: {json.dumps(row)}")
            if ev["runs_total"] != n or ev["runs_mapped"] != ev["new_runs"]:
                raise AssertionError(f"{label}: update {row} after {n} runs was not incremental")
            tree = report_tree_bytes(ev["report_dir"])
            if check_generation is not None:
                check_generation(n, tree)
            updates.append(row)
    finally:
        wall = time.perf_counter() - t0
        watcher.stop()
        th.join(timeout=120)
        LAUNCH_LOG.label = None
    if th.is_alive():
        raise AssertionError(f"{label}: the watcher did not stop")
    counts = {k.__name__: k.launches for k in kernels}
    add(counts)
    lat = sorted(u["update_latency_s"] for u in updates)
    out = {"runs": plan[-1], "generations": len(plan), "wall_s": round(wall, 4), "launches": counts,
           "update_latency_s": {"p50": lat[len(lat) // 2], "max": lat[-1]}, "updates": updates}
    log(f"{label}: {len(plan)} updates in {wall:.3f} s, latency p50 {lat[len(lat) // 2]} s max {lat[-1]} s, "
        f"launches {counts}")
    return out, live, tree


def corpora_path(work: str, kernels, dirs: dict, trees: dict) -> dict:
    """Phase 6g: every way a corpus comes in (see the module docstring):
    the adversarial families, a trace-JSON sweep, quarantine, the watch
    loop and --save-corpus, each report equal to the cpu report.  Prints
    {"corpora": {...}}.  Returns the launches by kernel."""
    from nemo_tpu_torch.graphs.corpus import load_corpus, pack_corpus
    from nemo_tpu_torch.ingest.adapters import MollyInjector
    from nemo_tpu_torch.ingest.molly import load_molly_output
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    root = os.path.join(work, "corpora")
    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    out = {}
    t = time.perf_counter()
    out["adversarial"] = adversarial_leg(os.path.join(root, "adv"), kernels, add)
    out["adversarial_s"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["trace"] = trace_leg(os.path.join(root, "trace"), kernels, add, dirs[TRACE_FAMILY])
    out["trace_s"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    out["quarantine"] = quarantine_leg(os.path.join(root, "quarantine"), kernels, add, dirs[QUARANTINE_FAMILY])
    out["quarantine_s"] = round(time.perf_counter() - t, 3)

    # (d) The watch loop: bench.py's watch tier on the default routes, each
    # generation against the cpu report of the same prefix; then a family on
    # the device lanes, so that the watcher's thread launches the kernels
    # (on the default routes its 425-run segments take the host lane), its
    # last published tree against a one-shot report on cuda and on the cpu.
    t = time.perf_counter()
    wroot = os.path.join(root, "watch")
    n_runs, seed, gens = WATCH_TIER
    src = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, name="watch_src"), os.path.join(wroot, "src"))

    def same_as_cpu(n, tree):
        prefix = os.path.join(wroot, "prefix", str(n), "watch_src")
        MollyInjector.materialize_prefix(src, prefix, n)
        _same_tree(f"watch tier {n} runs", tree, _cpu_tree(prefix, os.path.join(wroot, "cpu"), PARTIAL_FIGURES,
                                                            "watch_src"), "the cpu report")

    out["watch_tier"], _live, _tree = watch_leg("watch-tier", wroot, kernels, add, src, gens, PARTIAL_FIGURES,
                                                same_as_cpu)
    out["watch_family"], live, tree = watch_leg("watch-family", wroot, kernels, add, dirs[WATCH_FAMILY],
                                                WATCH_FAMILY_GENERATIONS, PARTIAL_FIGURES, **DEVICE_LANES)
    if out["watch_family"]["launches"]["closure"] < WATCH_FAMILY_GENERATIONS:
        raise AssertionError(f"watch family: the watcher's cycles launched {out['watch_family']['launches']}")
    name = os.path.basename(live)
    once, _b, once_tree, counts = report_counted(f"watch family one-shot {name}", live, kernels,
                                                 os.path.join(wroot, "once"), PARTIAL_FIGURES, name,
                                                 default_routes=True)
    add(counts)
    shutil.rmtree(once.report_dir)
    _same_tree("watch family", tree, once_tree, "the one-shot report")
    _same_tree("watch family", tree, _cpu_tree(live, os.path.join(wroot, "cpu"), PARTIAL_FIGURES, name),
               "the cpu report")
    out["watch_family"]["one_shot_s"] = round(once.report_wall_s, 4)
    out["watch_s"] = round(time.perf_counter() - t, 3)
    log(f"watch {name}: the last published tree equals the one-shot report on cuda and on the cpu")

    # (e) --save-corpus through the CLI on cuda.
    t = time.perf_counter()
    cd = dirs[SAVE_FAMILY]
    path = os.path.join(root, "corpus.npz")
    results = os.path.join(root, "save-corpus")
    wall, tel, tree, counts = cli_report(
        f"cli --save-corpus {SAVE_FAMILY}",
        ["-faultInjOut", cd, "--results-dir", results, "--figures", REPORT_FIGURES, "--save-corpus", path,
         "--corpus-cache", "off", "--result-cache", "off"], kernels, os.path.join(results, SAVE_FAMILY))
    add(counts)
    _same_tree("cli --save-corpus", tree, trees[SAVE_FAMILY], "the cpu report")
    loaded, want = load_corpus(path), pack_corpus(load_molly_output(cd))
    if (loaded.run_ids, loaded.statuses) != (want.run_ids, want.statuses) or any(
        getattr(loaded.vocab, p).strings != getattr(want.vocab, p).strings for p in ("tables", "labels", "times")
    ) or sorted(loaded.graphs) != sorted(want.graphs):
        raise AssertionError("cli --save-corpus: the saved corpus differs from the packed corpus")
    for key, g in want.graphs.items():
        h = loaded.graphs[key]
        if (g.n_goals, g.n_nodes, g.node_ids) != (h.n_goals, h.n_nodes, h.node_ids) or not all(
            np.array_equal(getattr(g, c), getattr(h, c)) for c in ("table_id", "label_id", "time_id", "type_id",
                                                                   "edges")
        ):
            raise AssertionError(f"cli --save-corpus: graph {key} differs")
    out["save_corpus"] = {"wall_s": round(wall, 4), "save_corpus_s": tel["timings"].get("save_corpus"),
                          "bytes": os.path.getsize(path), "graphs": len(want.graphs), "launches": counts}
    out["save_corpus_s"] = round(time.perf_counter() - t, 3)
    log(f"cli --save-corpus {SAVE_FAMILY}: {json.dumps(out['save_corpus'])}; the file loads back equal")
    print(json.dumps({"corpora": out}))
    shutil.rmtree(root)
    return launches


def counted_call(label: str, kernels, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after, its launches recorded under ``label`` in the
    LaunchLog.  Returns (its result, launches by kernel name, wall s)."""
    for k in kernels:
        k.launches = 0
    LAUNCH_LOG.label = label
    t = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        LAUNCH_LOG.label = None
    return out, {k.__name__: k.launches for k in kernels}, time.perf_counter() - t


def _doc_bytes(doc: dict) -> str:
    """A query document without its stats, as bench.py compares them."""
    return json.dumps({k: v for k, v in doc.items() if k != "stats"}, sort_keys=True)


def _post_query(port: int, body: dict) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", data=json.dumps(body).encode("utf-8"),
                                 method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as ex:
        return ex.code, json.loads(ex.read())


def query_path(work: str, kernels, dirs: dict, corpus_cache: str) -> dict:
    """Phase 6h: the ad-hoc query engine on cuda (see the module docstring).
    Every document must equal the cpu document.  Prints {"query": {...}}.
    Returns the launches by kernel."""
    from http.server import ThreadingHTTPServer
    from threading import Thread

    from nemo_tpu_torch import cli
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.models.synth import grow_corpus_dir
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus, oracle_query, query_lane
    from nemo_tpu_torch.query.lang import parse_query
    from nemo_tpu_torch.query.verbs import VERB_QUERIES, native_verb_result, run_verb

    root = os.path.join(work, "query")
    rc = os.path.join(root, "result-cache")
    q = parse_query(QUERY_TEXT)
    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    def run(label, molly, routes=None, **kw):
        doc, counts, wall = counted_call(label, kernels,
                                         lambda: execute_query(q, molly, device="cuda", routes=routes, **kw))
        add(counts)
        return doc, counts, wall

    def routes_of(routes):
        return [(r["rows"], r["v"], r["e"], r["work"], r["lane"]) for r in routes]

    out, cpu_docs = {"query": QUERY_TEXT, "families": {}}, {}
    for name, cd in dirs.items():
        t = time.perf_counter()
        molly = ingest_corpus(cd, corpus_cache)
        row = {"runs": len(molly.runs), "ingest": getattr(molly, "store_state", None),
               "ingest_s": round(time.perf_counter() - t, 4)}
        if row["ingest"] != "hit":
            raise AssertionError(f"query {name}: the corpus store of phase 5b did not serve it ({row['ingest']})")
        t = time.perf_counter()
        want = cpu_docs[name] = _doc_bytes(execute_query(q, molly, device="cpu", use_cache=False))
        row["cpu_s"] = round(time.perf_counter() - t, 4)
        # (1) cold, then warm, on the lane rule's routes.
        for leg, stats in (("cold", {"cache": "miss", "segments_mapped": 1}),
                           ("warm", {"cache": "hit", "segments_mapped": 0})):
            label, routes = f"query {leg} {name}", []
            doc, counts, wall = run(label, molly, routes, result_cache=rc)
            if doc["stats"] != stats or _doc_bytes(doc) != want:
                raise AssertionError(f"{label}: stats {doc['stats']} (want {stats}), or the document differs from "
                                     f"the cpu document")
            if any(r["lane"] != query_lane(r["work"]) for r in routes):
                raise AssertionError(f"{label}: a bucket off the lane rule: {routes}")
            device_buckets = sum(r["lane"] == "sparse_device" for r in routes)
            if counts["edge_wave"] != device_buckets or counts["closure"] or (leg == "warm" and routes):
                raise AssertionError(f"{label}: launches {counts} over routes {routes}")
            row[leg] = {"wall_s": round(wall, 4), "launches": counts, "routes": routes_of(routes)}
        # (2) each lane forced.
        for lane, host_work, want_lane in (("device", 0, "sparse_device"), ("host", QUERY_HOST_ONLY, "host")):
            label, routes = f"query {lane} lane {name}", []
            doc, counts, wall = run(label, molly, routes, use_cache=False, query_host_work=host_work)
            n_k2 = len(routes) if lane == "device" else 0
            if _doc_bytes(doc) != want or {r["lane"] for r in routes} != {want_lane} or counts != {
                    "closure": 0, "edge_wave": n_k2}:
                raise AssertionError(f"{label}: launches {counts} over routes {routes}, or the document differs")
            row[f"{lane}_lane"] = {"wall_s": round(wall, 4), "launches": counts, "routes": routes_of(routes)}
        if name == QUERY_FAMILY:
            t = time.perf_counter()
            if _doc_bytes(oracle_query(q, molly)) != want:
                raise AssertionError(f"query {name}: the per-run oracle's document differs")
            row["oracle_s"] = round(time.perf_counter() - t, 4)
        # (3) the four verbs as query programs, on both lanes, against the
        # native verbs over TorchBackend("cuda") (their fused step launches K1).
        backend = TorchBackend(device="cuda")
        backend.init_graph_db("", molly)
        row["verbs"] = {}
        for verb in VERB_QUERIES:
            native, ncounts, nwall = counted_call(f"query native verb {name}", kernels,
                                                  lambda: native_verb_result(verb, backend))
            add(ncounts)
            rec = {"native_s": round(nwall, 4), "native_launches": ncounts}
            for lane, host_work in (("default", None), ("device", 0)):
                label = f"query verb {verb} {lane} {name}"
                kw = {} if host_work is None else {"query_host_work": host_work}
                doc, counts, wall = counted_call(label, kernels, lambda: run_verb(verb, molly, device="cuda",
                                                                                 use_cache=False, **kw))
                add(counts)
                if json.dumps(doc["runs"], sort_keys=True) != json.dumps(native, sort_keys=True) or counts[
                        "edge_wave"]:
                    raise AssertionError(f"{label}: differs from the native verb, or launched K2 {counts}")
                rec[f"{lane}_s"] = round(wall, 4)
            row["verbs"][verb] = rec
        backend.close_db()
        log(f"query {name}: {json.dumps(row)}")
        out["families"][name] = row

    # (4) ZK-1270 grown by INGEST_GROWN_RUNS: only the new segment maps.
    zk = QUERY_FAMILY
    grown = os.path.join(root, "grown", zk)
    gcc, grc = os.path.join(root, "grown-corpus-cache"), os.path.join(root, "grown-result-cache")
    n_old = FAMILY_RUNS - INGEST_GROWN_RUNS
    grow_corpus_dir(dirs[zk], grown, n_old)
    doc, counts, first_wall = run(f"query grown {zk} first {n_old}", ingest_corpus(grown, gcc), result_cache=grc)
    grow_corpus_dir(dirs[zk], grown, FAMILY_RUNS)
    molly = ingest_corpus(grown, gcc)
    label, routes = f"query grown {zk} +{INGEST_GROWN_RUNS}", []
    doc, counts, wall = run(label, molly, routes, result_cache=grc)
    scratch = _doc_bytes(execute_query(q, ingest_corpus(grown, "off"), device="cpu", use_cache=False))
    rows = sum(r["rows"] for r in routes)
    if doc["stats"] != {"cache": "miss", "segments_mapped": 1} or rows > INGEST_GROWN_RUNS or _doc_bytes(
            doc) != scratch or getattr(molly, "store_state", None) != "grown":
        raise AssertionError(f"{label}: stats {doc['stats']}, {rows} rows mapped, or differs from scratch")
    out["grown"] = {"first_s": round(first_wall, 4), "grown_s": round(wall, 4), "rows_mapped": rows,
                    "launches": counts}
    log(f"{label}: mapped only the new segment ({rows} rows); the document equals the from-scratch document")

    # (5) the CLI in a subprocess (the device defaults to cuda).
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    base = [sys.executable, "-m", "nemo_tpu_torch.cli", "query"]
    t = time.perf_counter()
    good = subprocess.run(base + [QUERY_TEXT, "-faultInjOut", dirs[zk], "--corpus-cache", corpus_cache,
                                  "--result-cache", "off"], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=300)
    cli_s = time.perf_counter() - t
    if good.returncode != 0 or _doc_bytes(json.loads(good.stdout)) != cpu_docs[zk]:
        raise AssertionError(f"cli query: rc {good.returncode}, stderr {good.stderr[-2000:]}")
    bad = subprocess.run(base + [QUERY_BAD, "-faultInjOut", dirs[zk]], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    if bad.returncode != 2 or "query error: unknown step kind 'wat'" not in bad.stderr:
        raise AssertionError(f"cli bad query: rc {bad.returncode}, stderr {bad.stderr[-2000:]}")
    out["cli"] = {"wall_s": round(cli_s, 4), "bad_rc": bad.returncode}
    log(f"cli query {zk}: the document equals the cpu document ({cli_s:.2f} s with the interpreter's start); "
        f"{QUERY_BAD!r} exits 2")

    # (6) POST /query through the report server, on the device lane, the
    # corpus resolved as --watch --serve resolves it (store-warm ingest).
    handler = cli.query_http_handler(root, cli.watch_molly_resolver(dirs[zk], None, corpus_cache), device="cuda",
                                     result_cache="off", query_host_work=0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    serving = Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        (status, doc), counts, wall = counted_call("query served", kernels,
                                                   lambda: _post_query(httpd.server_address[1], {"query": QUERY_TEXT}))
        bad_status, bad_doc = _post_query(httpd.server_address[1], {"query": QUERY_BAD})
    finally:
        httpd.shutdown()
        httpd.server_close()
        serving.join()
    add(counts)
    if status != 200 or _doc_bytes(doc) != cpu_docs[zk] or counts["edge_wave"] <= 0 or bad_status != 400:
        raise AssertionError(f"POST /query: status {status}, launches {counts}, bad query {bad_status} {bad_doc}")
    out["serve"] = {"wall_s": round(wall, 4), "launches": counts}
    log(f"POST /query {zk}: status 200, the document equals the cpu document, launches {counts}; bad text 400")
    print(json.dumps({"query": out}))
    shutil.rmtree(root)
    return launches


def label_launches(label: str, kernel: str) -> int:
    """The launches of ``kernel`` the LaunchLog recorded under ``label``."""
    return sum(r["launches"].get(label, 0) for (k, _), r in LAUNCH_LOG.shapes.items() if k == kernel)


def _span_names(trace_path: str) -> list[str]:
    with open(trace_path, encoding="utf-8") as fh:
        return [e["name"] for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]


def obs_path(work: str, kernels, dirs: dict, zk_tree: dict, corpus_cache: str) -> dict:
    """Phase 6i: observability on the card (see the module docstring).
    Prints {"obs": {...}} and {"memory": {...}}.  Returns the launches by
    kernel."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.obs import promexp
    from nemo_tpu_torch.obs import trace as obs_trace
    from nemo_tpu_torch.query.engine import execute_query, ingest_corpus
    from nemo_tpu_torch.query.lang import parse_query

    zk = QUERY_FAMILY
    root = os.path.join(work, "obs")
    cuda_root = os.path.join(root, "reports")
    launches = {k.__name__: 0 for k in kernels}
    out: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) The same report with tracing off, then on: both walls.
    walls = {}
    for mode in ("off", "on"):
        trace = os.path.join(root, f"walls-{mode}.json")
        if mode == "on":
            obs_trace.start_trace(trace)
        try:
            res, _, tree, counts = report_counted(f"obs {zk} tracing {mode}", dirs[zk], kernels, cuda_root,
                                                  REPORT_FIGURES, f"{zk}-{mode}")
        finally:
            obs_trace.finish()
        add(counts)
        if tree != zk_tree:
            raise AssertionError(f"obs {zk} tracing {mode}: the report differs from the cpu report")
        walls[mode] = {"report_s": round(res.report_wall_s, 4),
                       "phases_s": {k: round(v, 4) for k, v in res.timings.items()}}
    out["tracing_walls"] = walls
    log(f"obs {zk}: report wall tracing off {walls['off']['report_s']} s, on {walls['on']['report_s']} s")

    # (b) Traced and profiled through run_debug(profile_dir=...): K1 on the
    # device lanes, then K2 with ZK-1270 forced onto the sparse tier.
    legs = (("k1", "closure", ("fused", "diff"), {}),
            ("k2", "edge_wave", ("sparse_fused", "sparse_diff"), {"analysis_impl": "sparse_device"}))
    for leg, kernel, verbs, kw in legs:
        label = f"obs {zk} traced and profiled ({kernel})"
        trace, pdir = os.path.join(root, f"{leg}.json"), os.path.join(root, f"profile-{leg}")
        before = obs.metrics.snapshot()
        obs_trace.start_trace(trace)
        try:
            res, backend, tree, counts = report_counted(label, dirs[zk], kernels, cuda_root, REPORT_FIGURES,
                                                        f"{zk}-{leg}", profile_dir=pdir, **kw)
        finally:
            obs_trace.finish()
        add(counts)
        delta = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
        if tree != zk_tree:
            raise AssertionError(f"{label}: the report differs from the cpu report")
        names = _span_names(trace)
        want = {"phase:ingest", "phase:load_raw_provenance", "phase:diff_prov", "phase:report"} | {
            f"kernel:{v}" for v in verbs}
        if not want <= set(names):
            raise AssertionError(f"{label}: the trace lacks {sorted(want - set(names))}")
        ex = backend.executor
        spans = {v: names.count(f"kernel:{v}") for v in ex.dispatches}
        got = {k[len("kernel.dispatches."):]: v for k, v in delta.items() if k.startswith("kernel.dispatches.")}
        if spans != ex.dispatches or got != {**ex.dispatches, **ex.host_runs}:
            raise AssertionError(f"{label}: spans {spans}, counters {got}, executor {ex.dispatches} "
                                 f"{ex.host_runs}")
        if counts[kernel] <= 0 or label_launches(label, kernel) != counts[kernel]:
            raise AssertionError(f"{label}: {counts[kernel]} {kernel} launches, the launch log "
                                 f"{label_launches(label, kernel)}")
        events = profile_events(pdir)
        under = labelled_kernels(events, f"nemo:{verbs[0]}")
        if not any(f in n for n in under for f in KERNEL_FUNCTIONS[kernel]):
            raise AssertionError(f"{label}: no {kernel} kernel function under nemo:{verbs[0]} in the capture: "
                                 f"{sorted(under)[:8]}")
        busy_us = sum(e.get("dur", 0) for e in events if e.get("cat") in DEVICE_CATS)
        out[leg] = {"report_s": round(res.report_wall_s, 4), "spans": spans, "launches": counts,
                    "under_label": sorted(n[:60] for n in under), "device_busy_ms": round(busy_us / 1e3, 4),
                    "device_busy_share": round(busy_us / 1e6 / res.report_wall_s, 6)}
        log(f"{label}: trace {len(names)} spans {spans}, counters equal the executor, launches {counts} equal the "
            f"launch log; under nemo:{verbs[0]} the capture shows {sorted(under)}; device busy "
            f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / res.report_wall_s:.2f} % of the report wall)")

    # (c) The CLI in a subprocess with every obs flag (default routes).
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    trace, metrics, pdir = (os.path.join(root, n) for n in ("cli.json", "cli.prom", "cli-profile"))
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "nemo_tpu_torch.cli", "-faultInjOut", dirs[zk], "--results-dir",
                          os.path.join(root, "cli"), "--figures", REPORT_FIGURES, "--corpus-cache", "off",
                          "--result-cache", "off", "--trace", trace, "--metrics-out", metrics, "--timings",
                          "--profile", pdir], cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t
    if cli.returncode != 0:
        raise AssertionError(f"cli with obs flags: rc {cli.returncode}, stderr {cli.stderr[-2000:]}")
    names = set(_span_names(trace))
    with open(metrics, encoding="utf-8") as fh:
        fams = promexp.parse_prometheus_text(fh.read())
    under = labelled_kernels(profile_events(pdir), "nemo:fused")
    timed = [line for line in cli.stdout.splitlines() if line.rstrip().endswith(" ms")]
    if (not {"phase:ingest", "phase:report", "kernel:fused"} <= names
            or fams["nemo_kernel_dispatches_fused_total"]["samples"][0][2] < 1
            or not any(f in n for n in under for f in KERNEL_FUNCTIONS["closure"]) or len(timed) < 5):
        raise AssertionError(f"cli with obs flags: spans {sorted(names)[:20]}, metric families {len(fams)}, "
                             f"under nemo:fused {sorted(under)}, timing lines {timed}")
    out["cli"] = {"wall_s": round(cli_s, 4), "metric_families": len(fams), "spans": len(names)}
    log(f"cli with --trace --metrics-out --timings --profile: {cli_s:.2f} s with the interpreter's start; "
        f"{len(fams)} metric families parse, the trace has phase and kernel spans, the capture K1 under nemo:fused")

    # (d) The cost of a disabled span() on this host.
    n = 1_000_000
    t = time.perf_counter()
    for _ in range(n):
        with obs.span("off", k=1):
            pass
    spans_s = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        pass
    bare_s = time.perf_counter() - t
    out["disabled_span_ns"] = round((spans_s - bare_s) / n * 1e9, 2)
    log(f"a disabled span() costs {out['disabled_span_ns']} ns on this host")

    # (e) The device busy share of bench.py's query on ZK-1270, the device
    # lane forced; neither package's query has a profile_dir.
    from torch.profiler import ProfilerActivity, profile

    molly = ingest_corpus(dirs[zk], corpus_cache)
    q = parse_query(QUERY_TEXT)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        doc, counts, wall = counted_call(f"obs query {zk}", kernels, lambda: execute_query(
            q, molly, device="cuda", use_cache=False, query_host_work=0))
    add(counts)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if counts["edge_wave"] <= 0:
        raise AssertionError(f"obs query {zk}: launches {counts}")
    out["query"] = {"wall_s": round(wall, 4), "device_busy_ms": round(busy_us / 1e3, 4),
                    "device_busy_share": round(busy_us / 1e6 / wall, 6) if busy_us else None, "launches": counts}
    log(f"obs query {zk} (device lane forced): wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e6 / wall:.2f} % of the wall), launches {counts}")
    print(json.dumps({"obs": out}))
    print(json.dumps({"memory": {"device_peak_bytes_and_in_use_before": MEM_PEAKS}}))
    shutil.rmtree(root)
    return launches


def platform_path(work: str, kernels, dirs: dict, trees: dict, corpus_cache: str) -> dict:
    """Phase 6j: the measured platform profile on the card (see the module
    docstring), in a fresh profile directory under ``work``.  Every report
    must equal the family's tree of phase 5 and every query document the
    seeded one.  Prints {"platform_profile": {...}}.  Returns the launches
    by kernel."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.platform import profile as pp
    from nemo_tpu_torch.query.engine import QUERY_HOST_WORK, derived_query_host_work, execute_query, ingest_corpus
    from nemo_tpu_torch.query.lang import parse_query

    root = os.path.join(work, "platform")
    pdir = os.path.join(root, "profiles")
    os.environ.update(NEMO_PROFILE="auto", NEMO_PROFILE_DIR=pdir)
    pp.reset_active_profile()
    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    def counters(fn):
        before = obs.metrics.snapshot()
        out = fn()
        return out, obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]

    first = sorted(dirs)[0]
    molly = ingest_corpus(dirs[first], corpus_cache)

    def first_contact(label):
        """A new backend on the card and its init_graph_db, counted; returns
        (the backend, launches, wall, counter deltas)."""
        backend = TorchBackend(device="cuda")
        (_, counts, wall), c = counters(lambda: counted_call(label, kernels,
                                                             lambda: backend.init_graph_db("", molly)))
        return backend, counts, wall, c

    try:
        # (a) Cold: the first backend on the card calibrates, once.
        label = "platform calibration"
        _, counts, wall, c = first_contact(label)
        add(counts)
        prof = pp.active_profile("cuda")
        if (c.get("profile.calibrated") != 1 or not c.get("profile.probe.dispatches") or counts["closure"] <= 0
                or counts["closure"] != label_launches(label, "closure") or prof is None):
            raise AssertionError(f"{label}: counters {c}, launches {counts}")
        _sound_fit(label, {r["name"]: r["value"] for r in pp.constant_sources("cuda")})
        out = {"fingerprint": prof.fingerprint, "key": prof.key, "constants": pp.constant_sources("cuda"),
               "probes": prof.probes, "calibration_wall_s": round(prof.calibration_wall_s, 4),
               "build_wall_s": round(prof.probes["build_wall_s"], 4), "cold_init_s": round(wall, 4),
               "cold_launches": counts, "probe_dispatches": c["profile.probe.dispatches"]}
        log(f"{label}: {c['profile.probe.dispatches']} probe dispatches, launches {counts}, calibration "
            f"{prof.calibration_wall_s:.3f} s after a {prof.probes['build_wall_s']:.3f} s build; init_graph_db "
            f"{wall:.3f} s; constants {[(r['name'], r['value'], r['source']) for r in out['constants']]}")

        # (b) Warm: another process (the loaded profiles forgotten) loads it.
        pp.reset_active_profile()
        backend, counts, wall, c = first_contact("platform warm")
        if c.get("profile.loaded") != 1 or c.get("profile.probe.dispatches") or c.get("profile.calibrated") or any(
                counts.values()):
            raise AssertionError(f"platform warm: counters {c}, launches {counts}")
        out["warm_init_s"] = round(wall, 4)
        measured_budget = {k: getattr(backend, k) for k in ("analysis_host_work", "diff_host_work",
                                                           "synth_host_work", "sparse_device_mem_bytes")}

        # (c) The families' default-route reports, seeded and measured, in
        # turns (seeded, measured, measured, seeded), each tree equal to
        # phase 5's.
        walls = {name: {"seeded": [], "measured": []} for name in dirs}
        routes = {}
        for name, cd in dirs.items():
            for mode in ("seeded", "measured", "measured", "seeded"):
                with pp.mode_override("off" if mode == "seeded" else None):
                    label = f"platform {mode} {name}"
                    res, backend, tree, counts = report_counted(label, cd, kernels, os.path.join(root, "reports"),
                                                                REPORT_FIGURES, name, default_routes=True)
                add(counts)
                _same_tree(label, tree, trees[name], "the family's report of phase 5")
                walls[name][mode].append(round(res.report_wall_s, 4))
                routes.setdefault(name, {})[mode] = [(r["verb"], r["route"], r["rows"], r["v"], r["e"], r["work"],
                                                      r["reason"]) for r in backend.analysis_routes]
                shutil.rmtree(res.report_dir)
        sums = {mode: round(sum(sum(w[mode]) for w in walls.values()), 4) for mode in ("seeded", "measured")}
        changed = {name: sum(a != b for a, b in zip(r["seeded"], r["measured"])) for name, r in routes.items()}
        for name, r in routes.items():
            log(f"platform routes {name}: seeded {r['seeded']}; measured {r['measured']}")
        out.update(family_walls=walls, wall_sums=sums, measured_over_seeded=round(sums["measured"] / sums["seeded"], 4),
                   routes_changed=changed, measured_budgets=measured_budget)
        log(f"platform reports: seeded {sums['seeded']} s, measured {sums['measured']} s over "
            f"{2 * len(dirs)} reports each; routes changed {changed}")

        # (d) The families' queries on the measured crossover, each document
        # equal to the seeded one.
        q = parse_query(QUERY_TEXT)
        crossover = derived_query_host_work("cuda")
        out["query"] = {"crossover": crossover, "families": {}}
        for name, cd in dirs.items():
            qm = ingest_corpus(cd, corpus_cache)
            with pp.mode_override("off"):
                seeded, s_counts, s_wall = counted_call(f"platform query seeded {name}", kernels, lambda: execute_query(
                    q, qm, device="cuda", use_cache=False))
            qroutes = []
            doc, counts, q_wall = counted_call(f"platform query measured {name}", kernels, lambda: execute_query(
                q, qm, device="cuda", use_cache=False, routes=qroutes))
            add(s_counts)
            add(counts)
            device_buckets = sum(r["lane"] == "sparse_device" for r in qroutes)
            if _doc_bytes(doc) != _doc_bytes(seeded) or counts["edge_wave"] != device_buckets or any(
                    r["lane"] != ("host" if r["work"] < crossover else "sparse_device") for r in qroutes):
                raise AssertionError(f"platform query {name}: launches {counts} over routes {qroutes}, or the "
                                     f"document differs from the seeded one")
            out["query"]["families"][name] = {"seeded_s": round(s_wall, 4), "measured_s": round(q_wall, 4),
                                              "device_buckets": device_buckets, "buckets": len(qroutes),
                                              "launches": counts}
        log(f"platform queries on the measured crossover {crossover}: {json.dumps(out['query'])}")

        # (e) Corrupt: a truncated file stays seeded, with profile.stale, and
        # calibrates nothing.
        path = pp.profile_path(prof.key)
        with open(path, "r+", encoding="utf-8") as fh:
            fh.truncate(os.path.getsize(path) // 2)
        pp.reset_active_profile()
        backend, counts, _, c = first_contact("platform corrupt")
        seeded_knobs = {"analysis_host_work": 100_000, "diff_host_work": 2_000_000, "synth_host_work": 100_000,
                        "sparse_device_mem_bytes": 256_000_000}
        if (c.get("profile.stale") != 1 or c.get("profile.calibrated") or any(counts.values())
                or {k: getattr(backend, k) for k in seeded_knobs} != seeded_knobs):
            raise AssertionError(f"platform corrupt: counters {c}, launches {counts}")

        # (f) Off: every constant seeded.
        with pp.mode_override("off"):
            backend = TorchBackend(device="cuda")
            backend.init_graph_db("", molly)
            if ({k: getattr(backend, k) for k in seeded_knobs} != seeded_knobs
                    or {r["source"] for r in pp.constant_sources("cuda")} != {"seeded"}
                    or derived_query_host_work("cuda") != QUERY_HOST_WORK):
                raise AssertionError("platform off: a constant did not resolve seeded")
        log("platform corrupt: seeded, profile.stale 1, no calibration; off: every constant seeded")

        # (g) The CLI's --calibrate and prewarm, each in a subprocess.
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        for leg, argv in (("calibrate", ["nemo_tpu_torch.cli", "--calibrate"]),
                          ("prewarm", ["nemo_tpu_torch.utils.prewarm"])):
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *argv], cwd=repo, env=env, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0 or ("analysis_host_work =" if leg == "calibrate" else "prewarm done") not in (
                    proc.stdout):
                raise AssertionError(f"{leg}: rc {proc.returncode}, stderr {proc.stderr[-2000:]}")
            if leg == "calibrate":
                table = {m[1]: float(m[2]) for m in re.finditer(r"^\s*(\w+) = (\S+) \[\w+\]$", proc.stdout, re.M)}
                _sound_fit(leg, table)
                out["calibrate_cli_constants"] = table
                out["calibrate_cli_rejected_rounds"] = int(next(iter(re.findall(
                    r"^\s*(\d+) probe round\(s\) rejected", proc.stdout, re.M)), 0))
            out[f"{leg}_cli_s"] = round(time.perf_counter() - t, 4)
            log(f"{leg} in a subprocess ({out[f'{leg}_cli_s']:.2f} s with the interpreter's start):\n"
                + proc.stdout.rstrip())
    finally:
        os.environ["NEMO_PROFILE"] = "off"
        os.environ.pop("NEMO_PROFILE_DIR", None)
        pp.reset_active_profile()
    print(json.dumps({"platform_profile": out}))
    shutil.rmtree(root)
    return launches


def _sched_summary(records: list[dict]) -> dict:
    """Per lane: the jobs it ran, its steals and the lanes they were
    planned for, from decision-table records."""
    out: dict = {}
    for r in records:
        row = out.setdefault(r["lane"], {"dispatches": 0, "steals": 0, "planned": {}})
        row["dispatches"] += 1
        row["steals"] += int(r["stolen"])
        row["planned"][r["planned"]] = row["planned"].get(r["planned"], 0) + 1
    return out


def sched_turns(root: str, kernels, add, legs: list, mollys: dict) -> dict:
    """Phase 6k (a): every report leg and bench.py's query over the
    families under NEMO_SCHED off and on in turns (SCHED_TURNS).  Each
    report's tree must equal its cpu tree, each query document the off
    turn's; an off turn runs no scheduler job.  Returns the walls by mode
    and leg, and each on turn's decision summary."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.parallel import sched
    from nemo_tpu_torch.query.engine import execute_query
    from nemo_tpu_torch.query.lang import parse_query

    q = parse_query(QUERY_TEXT)
    walls: dict = {"off": {}, "on": {}}
    turns, docs = [], {}
    for turn, mode in enumerate(SCHED_TURNS):
        os.environ["NEMO_SCHED"] = mode
        before = obs.metrics.snapshot()
        for leg, cd, want, figures, name, kw in legs:
            label = f"sched {mode} {turn} {leg}"
            res, _backend, tree, counts = report_counted(label, cd, kernels, os.path.join(root, "reports", str(turn)),
                                                         figures, name, default_routes=True, **kw)
            add(counts)
            _same_tree(label, tree, want, "the cpu report")
            walls[mode].setdefault(leg, []).append(round(res.report_wall_s, 4))
            shutil.rmtree(res.report_dir)
        wall = 0.0
        for name, molly in mollys.items():
            label = f"sched {mode} {turn} query {name}"
            doc, counts, w = counted_call(label, kernels, lambda: execute_query(q, molly, device="cuda",
                                                                                   use_cache=False))
            add(counts)
            wall += w
            got = _doc_bytes(doc)
            if docs.setdefault(name, got) != got:
                raise AssertionError(f"{label}: the document differs from the serial one")
        walls[mode].setdefault("query", []).append(round(wall, 4))
        counters = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
        n_jobs = counters.get("analysis.sched.jobs", 0)
        if (mode == "off") != (n_jobs == 0) or any(counters.get(k) for k in FAILOVER_SERIES):
            raise AssertionError(f"sched turn {turn} ({mode}): {n_jobs} scheduler jobs, counters "
                                 f"{ {k: counters.get(k) for k in FAILOVER_SERIES} }")
        row = {"turn": turn, "mode": mode, "jobs": n_jobs}
        if n_jobs:
            row["lanes"] = _sched_summary(sched.sched_snapshot("cuda")[-n_jobs:])
        turns.append(row)
        log(f"sched turn {turn} {mode}: walls {json.dumps({k: v[-1] for k, v in walls[mode].items()})}; {row}")
    return {"walls": walls, "turns": turns}


def sched_verdict(walls: dict) -> dict:
    """The bar for NEMO_SCHED=auto as the default: on beats off on the
    sweep and on the query by more than the larger spread of either mode,
    and is slower on no timed leg.  Returns the means, spreads and the
    verdict of this run."""
    out = {"mean_s": {}, "spread_s": {}, "slower_on": []}
    for mode in ("off", "on"):
        out["mean_s"][mode] = {k: round(sum(v) / len(v), 4) for k, v in walls[mode].items()}
        out["spread_s"][mode] = {k: round(max(v) - min(v), 4) for k, v in walls[mode].items()}
    off, on = out["mean_s"]["off"], out["mean_s"]["on"]
    out["slower_on"] = sorted(k for k in off if on[k] > off[k])
    gains = {k: off[k] - on[k] > max(out["spread_s"]["off"][k], out["spread_s"]["on"][k]) for k in ("sweep", "query")}
    out["gains_beyond_spread"] = gains
    out["meets_bar"] = all(gains.values()) and not out["slower_on"]
    return out


def sched_failover(root: str, kernels, add, zk_dir: str, corpus_cache: str) -> dict:
    """Phase 6k (b), (c): one real fused bucket of ZK-1270 (device lanes)
    made into a Job, drained by the card's scheduler.  (b) Its device
    execution hits a real out-of-memory (an allocation past the card)
    NEMO_BREAKER_FAILURES times: each time the error is raised out of
    ``run``, counted (analysis.sched.lane_failure.device), the host never
    running the job and no route recorded; the breaker trips once with a
    flight bundle; the next run is refused before any job runs
    (BreakerOpen); after the cooldown one run is the half-open probe: it
    launches K1, its output equals the device output and the breaker
    closes.  A job whose device execution raises the closure wrapper's own
    error (its library faked to return cudaErrorMemoryAllocation)
    propagates and leaves the breaker closed.  (c) With
    NEMO_DISPATCH_TIMEOUT_S below a spin kernel's wall, a job waiting on
    the spin ends in DispatchTimeout (watchdog.dispatch_timeout), and the
    abandoned dispatch, which finishes its spin and its launches, records
    no route; the next run goes through.  A second abandoned dispatch that
    raises after its spin is counted (analysis.sched.abandoned_error) and
    its error raised by the next run.  Returns the record and the counters
    these legs moved."""
    import glob
    import threading

    from nemo_tpu_torch import obs
    from nemo_tpu_torch.backend.torch_backend import TorchBackend, _gather_rows, _to_host
    from nemo_tpu_torch.kernels import closure as closure_mod
    from nemo_tpu_torch.kernels.build import KernelError
    from nemo_tpu_torch.parallel import sched
    from nemo_tpu_torch.query.engine import ingest_corpus

    backend = TorchBackend(device="cuda", **DEVICE_LANES)
    backend.init_graph_db("", ingest_corpus(zk_dir, corpus_cache))
    plan = backend._plan_fused_inputs()
    pre_b, post_b = plan["batches"][0]
    rows = len(pre_b.run_ids)
    executor_run = backend.executor.run

    def bucket_job(fault=None):
        """The bucket's Job; ``fault()`` runs before each device dispatch."""
        jobs, routes = [], []
        backend._fused_job(jobs, routes, plan, 0, pre_b, post_b, True)
        if fault is not None:
            def run(verb, arrays, params, rows=None):
                fault()
                return executor_run(verb, arrays, params, rows=rows)

            backend.executor.run = run
        return jobs[0]

    def out_of_memory():
        torch.empty(1 << 50, dtype=torch.uint8, device="cuda")  # raises torch.cuda.OutOfMemoryError

    def host_view(res: dict) -> dict:
        keys = ("pre_holds", "post_holds", "proto_bits", "proto_min_depth", "proto_present", "pre_alive",
                "post_alive", "pre_type", "post_type", "pre_adj_clean", "post_adj_clean")
        return {k: _to_host(_gather_rows(res[k], list(range(rows)))) for k in keys}

    def same_output(label, got, want) -> None:
        bad = sorted(k for k in want if not np.array_equal(got[k], want[k]))
        if bad:
            raise AssertionError(f"{label}: the probe's output differs from the device's in {bad}")

    def drain(job):
        return sched.HeterogeneousScheduler(sched.default_models("cuda", 0), device="cuda").run([job], serial=True)[0]

    def join_abandoned():
        for th in threading.enumerate():
            if th.name.startswith("nemo-sched-dispatch-"):
                th.join(timeout=60)

    def scheduled(label: str, job, raises=None, counted: bool = True):
        """``job`` drained; with ``raises``, the error type it must end in
        (returned in place of the result), the host never running it and
        no route recorded."""
        n_routes, host_runs = len(backend.analysis_routes), dict(backend.executor.host_runs)

        def fn():
            try:
                return drain(job)
            except BaseException as ex:
                if raises is None or not isinstance(ex, raises):
                    raise
                return ex
            finally:
                join_abandoned()  # an abandoned dispatch's launches count here
                backend.executor.run = executor_run

        if counted:
            res, counts, _wall = counted_call(label, kernels, fn)
            add(counts)
        else:
            res, counts = fn(), None
        if raises is not None:
            if not isinstance(res, raises):
                raise AssertionError(f"{label}: ran to {type(res).__name__}, not {raises.__name__}")
            if len(backend.analysis_routes) != n_routes or backend.executor.host_runs != host_runs:
                raise AssertionError(f"{label}: route records {backend.analysis_routes[n_routes:]}, host runs "
                                     f"{backend.executor.host_runs} (before {host_runs})")
        return res, counts

    def moved(d0) -> dict:
        return obs.Metrics.delta(obs.metrics.snapshot(), d0)["counters"]

    saved = {k: os.environ.get(k) for k in (*SCHED_BREAKER, "NEMO_DISPATCH_TIMEOUT_S")}
    os.environ.update(SCHED_BREAKER)
    sched.reset_device_breaker("cuda")
    flight_dir = os.path.join(root, "flight")
    prev_flight = obs.flight.recorder()
    obs.flight.arm(flight_dir)
    before = obs.metrics.snapshot()
    out: dict = {}
    try:
        ref, counts, _wall = counted_call("sched bucket on the device", kernels,
                                          lambda: bucket_job().execute("device", "sched", False))
        add(counts)
        want = host_view(ref[2])
        failures = int(SCHED_BREAKER["NEMO_BREAKER_FAILURES"])
        for i in range(failures):
            label = f"sched lane failure {i}"
            d0 = obs.metrics.snapshot()
            _ex, counts = scheduled(label, bucket_job(out_of_memory), raises=torch.cuda.OutOfMemoryError)
            dl = moved(d0)
            if counts["closure"] or dl.get("analysis.sched.lane_failure.device") != 1 or dl.get(
                    "analysis.sched.failover"):
                raise AssertionError(f"{label}: launches {counts}, counters {dl}")
        breaker = sched.device_breaker("cuda")
        bundles = glob.glob(os.path.join(flight_dir, "flightrec-breaker_trip-*.json"))
        if breaker.state != breaker.OPEN or len(bundles) != 1:
            raise AssertionError(f"breaker {breaker.state} after {failures} failures, bundles {bundles}")
        _ex, counts = scheduled("sched breaker open", bucket_job(), raises=sched.BreakerOpen)
        if counts["closure"]:
            raise AssertionError(f"sched breaker open: launches {counts}")
        time.sleep(float(SCHED_BREAKER["NEMO_BREAKER_COOLDOWN_S"]))
        res, counts = scheduled("sched half-open probe", bucket_job())
        rec = sched.sched_snapshot("cuda")[-1]
        if (rec["lane"], breaker.state) != ("device", breaker.CLOSED) or counts["closure"] <= 0:
            raise AssertionError(f"sched half-open probe: decision {rec}, breaker {breaker.state}, launches {counts}")
        same_output("sched half-open probe", host_view(res[2]), want)
        out["probe_launches"] = counts

        # The wrapper's own error: the closure library returns
        # cudaErrorMemoryAllocation, whose string reads "out of memory".
        class FailingLib:
            _nemo_bound = True

            def nemo_closure(self, *args):
                return 2

            def nemo_cuda_error_string(self, rc):
                return b"out of memory"

        real_lib = closure_mod._lib
        closure_mod._lib = FailingLib
        for k in kernels:
            k.launches = 0
        try:
            ex, _ = scheduled("sched kernel error", bucket_job(), raises=KernelError, counted=False)
        finally:
            closure_mod._lib = real_lib
        out["kernel_error"] = str(ex)
        if any(k.launches for k in kernels) or breaker.state != breaker.CLOSED:
            raise AssertionError(f"sched kernel error: breaker {breaker.state}")

        # (c) The dispatch deadline, below the spin's wall.
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        spin_s = time.perf_counter() - t
        os.environ["NEMO_DISPATCH_TIMEOUT_S"] = str(spin_s / 4)

        def spin():
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()

        d0 = obs.metrics.snapshot()
        _ex, counts = scheduled("sched deadline", bucket_job(spin), raises=sched.DispatchTimeout)
        dl = moved(d0)
        if (dl.get("watchdog.dispatch_timeout"), dl.get("analysis.sched.lane_failure.device")) != (1, 1) or (
                counts["closure"] <= 0):
            raise AssertionError(f"sched deadline: counters {dl}, launches {counts}")
        out.update(spin_s=round(spin_s, 6), timeout_s=round(spin_s / 4, 6), deadline_launches=counts)
        os.environ["NEMO_DISPATCH_TIMEOUT_S"] = "0"  # a bucket's dispatch outlasts the spin's deadline
        res, _ = scheduled("sched after the deadline", bucket_job())
        same_output("sched after the deadline", host_view(res[2]), want)
        os.environ["NEMO_DISPATCH_TIMEOUT_S"] = str(spin_s / 4)

        def spin_then_fail():
            spin()
            raise KernelError("closure kernel failed: injected after the deadline")

        scheduled("sched abandoned error", bucket_job(spin_then_fail), raises=sched.DispatchTimeout)
        os.environ["NEMO_DISPATCH_TIMEOUT_S"] = "0"
        ex, _ = scheduled("sched abandoned error raised", bucket_job(), raises=KernelError)
        if "injected after the deadline" not in str(ex) or breaker.state != breaker.CLOSED:
            raise AssertionError(f"sched abandoned error: raised {ex!r}, breaker {breaker.state}")
        out["abandoned_error"] = str(ex)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        sched.reset_device_breaker("cuda")
        obs.flight.disarm()
        if prev_flight is not None:
            obs.flight.arm(prev_flight.out_dir)
    counters = moved(before)
    moved_series = {k: v for k, v in counters.items() if k.startswith(("analysis.sched.", "sched.breaker.",
                                                                       "watchdog.", "flight.dumps."))}
    want_moved = {"sched.breaker.trip": 1, "sched.breaker.probe": 1, "sched.breaker.close": 1,
                  "sched.breaker.short_circuit": 1, "analysis.sched.lane_failure.device": failures + 2,
                  "analysis.sched.abandoned_error": 1, "analysis.sched.failover": None,
                  "watchdog.dispatch_timeout": 2, "flight.dumps.breaker_trip": 1,
                  "flight.dumps.dispatch_watchdog": 1}  # a second bundle waits out the per-reason cooldown
    if any(moved_series.get(k) != v for k, v in want_moved.items()):
        raise AssertionError(f"sched failover legs: counters {moved_series}, expected {want_moved}")
    out["counters"] = moved_series
    log(f"sched failover legs: {json.dumps(out)}")
    return out


def sched_path(work: str, kernels, dirs: dict, trees: dict, sweep: tuple, corpus_cache: str) -> tuple[dict, dict]:
    """Phase 6k: the cost-model scheduler on cuda (see the module
    docstring).  Prints {"sched": {...}}.  Returns the launches by kernel
    and the counters its injected legs moved."""
    from nemo_tpu_torch.analysis import pipeline
    from nemo_tpu_torch.models.synth import ADVERSARIAL_FAMILIES, adversarial_spec, grow_corpus_dir, write_corpus
    from nemo_tpu_torch.query.engine import ingest_corpus
    from nemo_tpu_torch.store import resolve_store

    root = os.path.join(work, "sched")
    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # The legs of (a): the sweep; ZK-1270 grown by INGEST_GROWN_RUNS runs in
    # a corpus store of two segments (the same runs as the family: its tree
    # is phase 5's); the adversarial families, each beside its cpu tree.
    zk = "ZK-1270-racing-sent-flag"
    grown, gcc = os.path.join(root, "grown", zk), os.path.join(root, "grown-corpus-cache")
    store = resolve_store(gcc)
    for n in (FAMILY_RUNS - INGEST_GROWN_RUNS, FAMILY_RUNS):
        grow_corpus_dir(dirs[zk], grown, n)
        molly, _kind, snap = pipeline._ingest(grown, True, store)
        if snap is not None:
            pipeline._populate(store, grown, molly, snap)
    legs = [("sweep", sweep[0], sweep[1], REPORT_FIGURES, os.path.basename(sweep[0]), {}),
            ("grown", grown, trees[zk], REPORT_FIGURES, zk, {"ingest": "native", "corpus_cache": gcc})]
    for fam in ADVERSARIAL_FAMILIES:
        cd = write_corpus(adversarial_spec(fam, n_runs=ADV_RUNS, seed=ADV_SEED), os.path.join(root, "adversarial"))
        legs.append((f"adversarial {fam}", cd, _cpu_tree(cd, os.path.join(root, "cpu"), "none", fam), "none", fam, {}))
    mollys = {name: ingest_corpus(cd, corpus_cache) for name, cd in dirs.items()}

    saved = os.environ.get("NEMO_SCHED")
    try:
        out = sched_turns(root, kernels, add, legs, mollys)
    finally:
        if saved is None:
            os.environ.pop("NEMO_SCHED", None)
        else:
            os.environ["NEMO_SCHED"] = saved
    out["verdict"] = sched_verdict(out["walls"])
    failover = sched_failover(root, kernels, add, dirs[zk], corpus_cache)
    out["failover"] = failover
    out["launches"] = launches
    print(json.dumps({"sched": out}))
    shutil.rmtree(root)
    return launches, failover["counters"]


def _env_set(updates: dict) -> dict:
    """Set (a value) or unset (None) each variable; returns the old values."""
    saved = {k: os.environ.get(k) for k in updates}
    for k, v in updates.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved


def chaos_dispatch(root: str, kernels, add, zk_dir: str, zk_tree: dict) -> dict:
    """Phase 6l (a), (b): injected dispatch faults in ZK-1270's report on
    cuda (1,700 runs, sample:8, device lanes, caches off).  (a) Under
    NEMO_SCHED=on and a breaker that trips at the first failure,
    fail_dispatch:1 ends run_debug in ChaosFault: counted (chaos.injected,
    analysis.sched.lane_failure.device), the breaker tripped with a flight
    bundle, nothing failed over and the host lane never ran; the next run
    is refused (BreakerOpen, no launch); after the breaker's reset an
    uninjected run launches K1 and equals phase 5's tree; under
    NEMO_SCHED=off the fault propagates with no scheduler series and no
    host-lane run.  (b) wedge_dispatch:1 under NEMO_DISPATCH_TIMEOUT_S
    ends in DispatchTimeout (watchdog.dispatch_timeout), no route recorded,
    the wedged dispatch left asleep on its daemon thread; the next run
    passes and is equal.  Returns the record."""
    import glob

    from nemo_tpu_torch import obs
    from nemo_tpu_torch.analysis.pipeline import _ingest, run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend
    from nemo_tpu_torch.parallel import sched
    from nemo_tpu_torch.utils import chaos

    zk = os.path.basename(zk_dir)
    # The attempts fail at their first dispatch: they share one ingest.
    molly = _ingest(zk_dir, True, None)[0]

    def attempt(label: str, raises, spec: str | None):
        """ZK-1270's report under NEMO_CHAOS=spec on fresh scheduler
        models; it must end in ``raises``.  Returns (the counters it moved,
        launches by kernel), after checking the host lane never ran."""
        backend = TorchBackend(device="cuda", **DEVICE_LANES)
        sched.reset_session_models("cuda")
        chaos.reset()
        saved = _env_set({"NEMO_CHAOS": spec})

        def fn():
            try:
                run_debug(zk_dir, os.path.join(root, "reports", label), backend, figures=REPORT_FIGURES,
                          report_name=zk, corpus_cache="off", result_cache="off", molly=molly)
            except raises as ex:
                return ex
            raise AssertionError(f"{label}: the report ran to its end, not to {raises.__name__}")

        d0 = obs.metrics.snapshot()
        try:
            ex, counts, wall = counted_call(label, kernels, fn)
        finally:
            _env_set(saved)
            chaos.reset()
        add(counts)
        moved = obs.Metrics.delta(obs.metrics.snapshot(), d0)["counters"]
        if backend.executor.host_runs or backend.analysis_routes:
            raise AssertionError(f"{label}: host-lane runs {backend.executor.host_runs}, routes "
                                 f"{backend.analysis_routes}")
        log(f"{label}: {type(ex).__name__}: {ex}; {wall:.3f} s; launches {counts}; counters "
            f"{ {k: v for k, v in moved.items() if k.startswith(('chaos.', 'analysis.sched.', 'sched.', 'watchdog.'))} }")
        return moved, counts

    def uninjected(label: str) -> dict:
        res, _backend, tree, counts = report_counted(label, zk_dir, kernels, os.path.join(root, "reports", label),
                                                     REPORT_FIGURES, zk)
        add(counts)
        _same_tree(label, tree, zk_tree, "phase 5's report")
        if counts["closure"] <= 0:
            raise AssertionError(f"{label}: K1 never launched")
        shutil.rmtree(res.report_dir)
        return {"report_s": round(res.report_wall_s, 4), "launches": counts}

    out: dict = {}
    flight_dir = os.path.join(root, "flight")
    prev_flight = obs.flight.recorder()
    obs.flight.arm(flight_dir)
    saved = _env_set({"NEMO_SCHED": "on", **CHAOS_BREAKER, "NEMO_DISPATCH_TIMEOUT_S": None})
    sched.reset_device_breaker("cuda")
    try:
        moved, counts = attempt("chaos fail_dispatch", chaos.ChaosFault, "fail_dispatch:1")
        want = {"chaos.injected.fail_dispatch": 1, "analysis.sched.lane_failure.device": 1, "sched.breaker.trip": 1,
                "analysis.sched.failover": None}
        bundles = glob.glob(os.path.join(flight_dir, "flightrec-breaker_trip-*.json"))
        if any(moved.get(k) != v for k, v in want.items()) or len(bundles) != 1:
            raise AssertionError(f"chaos fail_dispatch: counters {moved}, expected {want}; bundles {bundles}")
        out["fail_dispatch"] = {"counters": {k: moved.get(k) for k in want}, "launches": counts}
        moved, counts = attempt("chaos breaker open", sched.BreakerOpen, None)
        if counts["closure"] or moved.get("sched.breaker.short_circuit") != 1:
            raise AssertionError(f"chaos breaker open: launches {counts}, counters {moved}")
        sched.reset_device_breaker("cuda")
        out["after_reset"] = uninjected("chaos after the breaker's reset")
        os.environ["NEMO_SCHED"] = "off"
        moved, counts = attempt("chaos fail_dispatch sched off", chaos.ChaosFault, "fail_dispatch:1")
        if moved.get("chaos.injected.fail_dispatch") != 1 or any(
                k.startswith(("analysis.sched.", "sched.")) for k in moved):
            raise AssertionError(f"chaos fail_dispatch sched off: counters {moved}")
        out["sched_off"] = {"launches": counts}

        # (b) A wedged dispatch past the deadline; the default breaker
        # threshold, so that the one failure does not trip it.
        os.environ.update(NEMO_SCHED="on", NEMO_DISPATCH_TIMEOUT_S=CHAOS_TIMEOUT_S)
        os.environ.pop("NEMO_BREAKER_FAILURES")
        sched.reset_device_breaker("cuda")
        t = time.perf_counter()
        moved, counts = attempt("chaos wedge_dispatch", sched.DispatchTimeout, "wedge_dispatch:1")
        wedge_s = time.perf_counter() - t
        want = {"chaos.injected.wedge_dispatch": 1, "watchdog.dispatch_timeout": 1,
                "analysis.sched.lane_failure.device": 1, "sched.breaker.trip": None, "analysis.sched.failover": None}
        if any(moved.get(k) != v for k, v in want.items()) or counts["closure"]:
            raise AssertionError(f"chaos wedge_dispatch: counters {moved}, expected {want}; launches {counts}")
        out["wedge_dispatch"] = {"wall_s": round(wedge_s, 4), "timeout_s": float(CHAOS_TIMEOUT_S),
                                 "counters": {k: moved.get(k) for k in want}}
        out["after_wedge"] = uninjected("chaos after the wedge")
    finally:
        _env_set(saved)
        sched.reset_device_breaker("cuda")
        sched.reset_session_models("cuda")
        obs.flight.disarm()
        if prev_flight is not None:
            obs.flight.arm(prev_flight.out_dir)
    return out


def _build_listing() -> dict:
    from nemo_tpu_torch.kernels.build import BUILD_DIR

    return {p.name: p.stat().st_mtime_ns for p in BUILD_DIR.iterdir()}


def _killed_child(label: str, argv: list[str], spec: str) -> tuple[float, str]:
    """``argv`` (a Python child on cuda) under NEMO_CHAOS=spec: it must die
    by SIGKILL (rc -9) without printing COMPLETED and build nothing (it
    loads the libraries the smoke built).  Returns (its wall, its stderr's
    tail)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    before = _build_listing()
    env = dict(os.environ, NEMO_CHAOS=spec, PYTHONPATH=repo)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], env=env, cwd=repo, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    if proc.returncode != -9 or "COMPLETED" in proc.stdout:
        raise AssertionError(f"{label}: rc {proc.returncode}, not SIGKILL; stderr {proc.stderr[-2000:]}")
    if _build_listing() != before:
        raise AssertionError(f"{label}: the child built a library ({sorted(set(_build_listing()) - set(before))})")
    log(f"{label}: killed (rc -9) after {wall:.3f} s with the interpreter's start, nothing built")
    return wall, proc.stderr[-500:]


def chaos_kills(root: str, kernels, add, zk_dir: str) -> dict:
    """Phase 6l (c), (d): real SIGKILLs on cuda.  (c) ZK-1270 in a store of
    three segments (CHAOS_APPENDS), figures CHAOS_FIGURES, device lanes:
    in memory and streamed, a child dies after its first segment
    checkpoint (kill_after_segments:1); the resume in this process maps
    exactly the two other segments (K1 launched only at their sizes) and
    its tree equals an uninterrupted cuda report with caches off and the
    cpu report; the walls under bench.py's chaos_tier names and what the
    kill left beside the results directory.  (d) The CLI in a child dies
    inside the store's publish (kill_in_store_publish): tmp wreckage, no
    header, a miss; the CLI again on cuda populates the store and writes
    the cpu tree.  Returns the record."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.analysis import delta, pipeline
    from nemo_tpu_torch.models.synth import grow_corpus_dir
    from nemo_tpu_torch.store import CorpusStore, resolve_store

    zk = os.path.basename(zk_dir)
    d, cc = os.path.join(root, "corpus", zk), os.path.join(root, "corpus-cache")
    store = resolve_store(cc)
    for n in CHAOS_APPENDS:
        grow_corpus_dir(zk_dir, d, n)
        molly, _kind, snap = pipeline._ingest(d, True, store)
        if snap is not None:
            pipeline._populate(store, d, molly, snap)
    segs = [s.n_runs for s in delta.corpus_segments(store.load_packed(d))]
    if len(segs) != len(CHAOS_APPENDS):
        raise AssertionError(f"chaos {zk}: the store holds segments {segs}")
    res, _backend, scratch, counts = report_counted(f"chaos scratch {zk}", d, kernels, os.path.join(root, "scratch"),
                                                    CHAOS_FIGURES, zk, ingest="native")
    add(counts)
    scratch_s = res.report_wall_s
    cpu = _cpu_tree(d, os.path.join(root, "cpu"), CHAOS_FIGURES, zk, default_routes=False, ingest="native")
    _same_tree(f"chaos scratch {zk}", scratch, cpu, "the cpu report")
    out: dict = {"segments": segs, "scratch_s": round(scratch_s, 4)}

    def kill_code(results: str, rc: str) -> str:
        return ("from nemo_tpu_torch.analysis.pipeline import run_debug\n"
                "from nemo_tpu_torch.backend.torch_backend import TorchBackend\n"
                f"run_debug({d!r}, {results!r}, TorchBackend('cuda', **{DEVICE_LANES!r}), figures={CHAOS_FIGURES!r}, "
                f"report_name={zk!r}, ingest='native', corpus_cache={cc!r}, result_cache={rc!r})\n"
                "print('COMPLETED')\n")

    saved = os.environ.get("NEMO_STREAM")
    try:
        for mode in ("off", "on"):
            os.environ["NEMO_STREAM"] = mode
            label = f"chaos kill_after_segments:1 stream {mode}"
            results, rc = os.path.join(root, "reports", mode), os.path.join(root, f"rc-{mode}")
            child_s, _err = _killed_child(label, ["-c", kill_code(results, rc)], "kill_after_segments:1")
            left = sorted(os.listdir(results)) if os.path.isdir(results) else []
            label = f"chaos resume stream {mode}"
            res, _backend, tree, counts = report_counted(label, d, kernels, results, CHAOS_FIGURES, zk,
                                                         ingest="native", corpus_cache=cc, result_cache=rc)
            add(counts)
            rcd = res.result_cache
            sizes = sorted({key[0] for (k, key), r in LAUNCH_LOG.shapes.items() if k == "closure"
                            and label in r["launches"]})
            if (rcd.get("segments_cached"), rcd.get("segments_mapped")) != (1, 2) or counts["closure"] <= 0 or (
                    max(sizes) >= segs[0]):
                raise AssertionError(f"{label}: result cache {rcd}, K1 launches {counts['closure']} at batch sizes "
                                     f"{sizes} (segments {segs})")
            _same_tree(label, tree, scratch, "the uninterrupted report")
            if any(".stage-" in k or ".ckpt-" in k for k in tree):
                raise AssertionError(f"{label}: a staging directory in the report")
            out[mode] = {"child_s": round(child_s, 4), "resume_s": round(res.report_wall_s, 4),
                         "scratch_s": round(scratch_s, 4),
                         "recovery_overhead": round(res.report_wall_s / scratch_s, 4),
                         "resumed_segments_cached": rcd["segments_cached"],
                         "resumed_segments_mapped": rcd["segments_mapped"], "k1_batch_sizes": sizes,
                         "launches": counts, "left_by_the_kill": left,
                         "left_files": {n: len(os.listdir(os.path.join(results, n))) for n in left
                                        if os.path.isdir(os.path.join(results, n))}}
            log(f"{label}: {json.dumps(out[mode])}")
    finally:
        if saved is None:
            os.environ.pop("NEMO_STREAM", None)
        else:
            os.environ["NEMO_STREAM"] = saved

    # (d) The store's publish killed in the CLI; then the CLI again.
    pcc, results = os.path.join(root, "publish-cache"), os.path.join(root, "reports", "publish")
    argv = ["-faultInjOut", d, "--device", "cuda", "--results-dir", results, "--figures", CHAOS_FIGURES,
            "--corpus-cache", pcc, "--result-cache", "off"]
    child_s, _err = _killed_child("chaos kill_in_store_publish", ["-m", "nemo_tpu_torch.cli", *argv],
                                  "kill_in_store_publish")
    pstore = CorpusStore(pcc)
    final = pstore.store_dir(d)
    wreck = sorted(n for n in os.listdir(pcc) if ".npack.tmp-" in n)
    if os.path.exists(os.path.join(final, "header.json")) or not wreck or pstore.probe(d) != "miss":
        raise AssertionError(f"chaos kill_in_store_publish: {sorted(os.listdir(pcc))} left, probe {pstore.probe(d)}")
    d0 = obs.metrics.snapshot()
    wall, tel, tree, counts = cli_report("chaos publish rerun", argv, kernels, os.path.join(results, zk))
    add(counts)
    moved = obs.Metrics.delta(obs.metrics.snapshot(), d0)["counters"]
    if moved.get("store.populate") != 1 or pstore.probe(d) != "hit" or counts["closure"] <= 0:
        raise AssertionError(f"chaos publish rerun: counters {moved}, probe {pstore.probe(d)}, launches {counts}")
    _same_tree("chaos publish rerun", tree, cpu, "the cpu report")
    out["store_publish"] = {"child_s": round(child_s, 4), "wreckage": wreck, "rerun_s": round(wall, 4),
                            "ingest": tel["ingest"], "launches": counts}
    log(f"chaos store publish: {json.dumps(out['store_publish'])}")
    return out


def chaos_path(work: str, kernels, dirs: dict, trees: dict) -> tuple[dict, dict]:
    """Phase 6l: the chaos harness (nemo_tpu_torch/utils/chaos.py) on cuda
    (see the module docstring).  Prints {"chaos": {...}}.  Returns the
    launches by kernel and the counters its injected legs moved."""
    from nemo_tpu_torch import obs
    from nemo_tpu_torch.utils import chaos

    root = os.path.join(work, "chaos")
    zk = "ZK-1270-racing-sent-flag"
    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    before = obs.metrics.snapshot()
    out = chaos_dispatch(root, kernels, add, dirs[zk], trees[zk])
    injected = obs.Metrics.delta(obs.metrics.snapshot(), before)["counters"]
    out.update(chaos_kills(root, kernels, add, dirs[zk]))

    # (e) The cost of an unarmed hook beside a disabled span(), on this host.
    os.environ.pop("NEMO_CHAOS", None)
    chaos.reset()
    n = 300_000
    hook = chaos.on_device_dispatch
    walls = {}
    t = time.perf_counter()
    for _ in range(n):
        hook("fused")
    walls["hook"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        with obs.span("off", k=1):
            pass
    walls["span"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        pass
    walls["bare"] = time.perf_counter() - t
    out["unarmed_hook_ns"] = round((walls["hook"] - walls["bare"]) / n * 1e9, 2)
    out["disabled_span_ns"] = round((walls["span"] - walls["bare"]) / n * 1e9, 2)
    log(f"an unarmed chaos hook costs {out['unarmed_hook_ns']} ns, a disabled span() {out['disabled_span_ns']} ns "
        f"on this host")
    out["launches"] = launches
    print(json.dumps({"chaos": out}))
    shutil.rmtree(root)
    series = {k: v for k, v in injected.items() if k in FAILOVER_SERIES or k.startswith("chaos.injected.")}
    return launches, series


def _sound_fit(label: str, table: dict) -> None:
    """Fail unless a calibration on the card resolved (``table``: name ->
    value) a device slope, measured or seeded, below the measured host unit
    and an analysis budget inside the fit's clamps (1,000 and 10^8,
    exclusive): a clamped budget would send every bucket to one lane."""
    unit, host, budget = (table.get(k) for k in ("sched_device_unit", "sched_host_unit", "analysis_host_work"))
    if None in (unit, host, budget) or not (unit < host and 1_000 < budget < 100_000_000):
        raise AssertionError(f"{label}: degenerate fit (device unit {unit}, host unit {host}, "
                             f"analysis_host_work {budget})")


def profile_events(profile_dir: str) -> list[dict]:
    """The events of the one Chrome trace the package's profiler capture
    (run_debug(profile_dir=...), the CLI's --profile) wrote into
    ``profile_dir``."""
    (path,) = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir) if f.endswith(".pt.trace.json")]
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["traceEvents"]


#: Device activity in a capture's Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def labelled_kernels(events: list[dict], label: str) -> set[str]:
    """Names of the device kernels whose launch (a CUDA runtime or driver
    call, linked by its correlation id) lies inside a CPU range named
    ``label`` (a ``nemo:<verb>`` record_function) on the same thread."""
    ranges = [(e["tid"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("name") == label and e.get("cat") != "gpu_user_annotation"]
    launched = {
        e["args"]["correlation"] for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
        and any(t == e["tid"] and a <= e["ts"] <= b for t, a, b in ranges)
    }
    return {e["name"] for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched}


def profile_family(cd: str, out_root: str, figures: str, **kw) -> dict[str, dict[str, tuple[float, int]]]:
    """Device busy time of one corpus's report, from the package's own
    torch.profiler capture (run_debug(profile_dir=...): the map, where
    every kernel launches): the sum of device activity against the wall of
    the whole report, the largest items, and K1's and K2's device time,
    launches and kernel functions.  Returns {kernel: {function: (device
    ms, launches)}}."""
    import tempfile

    from nemo_tpu_torch.analysis.pipeline import run_debug
    from nemo_tpu_torch.backend.torch_backend import TorchBackend

    pdir = tempfile.mkdtemp(prefix="profile-", dir=out_root)
    t = time.perf_counter()
    res = run_debug(cd, out_root, TorchBackend(device="cuda", **_lanes(False, kw)), figures=figures,
                    report_name="profile-" + os.path.basename(cd), corpus_cache="off", result_cache="off",
                    profile_dir=pdir)
    wall = time.perf_counter() - t
    shutil.rmtree(res.report_dir)
    events = [e for e in profile_events(pdir) if e.get("cat") in DEVICE_CATS]
    shutil.rmtree(pdir)
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e.get("dur", 0)
        acc[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    label = os.path.basename(cd) + (f" {kw}" if kw else "")
    if not busy_us:
        log(f"profile {label}: the capture recorded no device time (device busy share not measured)")
        return {}
    log(f"profile {label}: wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e6 / wall:.2f} % of the wall), {len(by_name)} kernel names")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    found = {}
    for kernel, functions in KERNEL_FUNCTIONS.items():
        for name, (us, n) in by_name.items():
            fn = next((f for f in functions if f in name), None)
            if fn is not None:
                ms, m = found.setdefault(kernel, {}).get(fn, (0.0, 0))
                found[kernel][fn] = (ms + us / 1e3, m + n)
        per_fn = found.get(kernel, {})
        log(f"  {kernel}: device {sum(ms for ms, _ in per_fn.values()):.4f} ms over "
            f"{sum(n for _, n in per_fn.values())} launches; functions "
            f"{ {f: (round(ms, 4), n) for f, (ms, n) in per_fn.items()} }")
    return found


#: The kernel function each launch-plan variant runs, as KERNEL_FUNCTIONS
#: names it.
VARIANT_FUNCTIONS = {
    "closure": {"warp": "closure_warp_kernel", "block": "closure_block_kernel", "global": "square_kernel"},
    "edge_wave": {"worklist_warp": "edge_wave_worklist_warp", "worklist_block": "edge_wave_worklist_block",
                  "waves_staged": "edge_wave_kernel", "waves_streamed": "edge_wave_kernel"},
}


def plan_of(kernel: str, key: tuple):
    """The launch plan the wrapper of ``kernel`` takes at a LaunchLog key."""
    if kernel == "closure":
        from nemo_tpu_torch.kernels.closure import closure_plan

        b, v, _squarings = key
        return closure_plan(b, v)
    from nemo_tpu_torch.kernels.edge_wave import edge_wave_plan

    b, v, e, _shared, n_steps = key
    return edge_wave_plan(b, v, e, n_steps)


def launched_variants(label: str, kernel: str) -> dict[str, int]:
    """{variant: launches} of ``kernel`` in the counted analysis ``label``:
    every launch the LaunchLog recorded, by the variant of the plan the
    wrapper takes at its shape."""
    found = {}
    for (k, key), rec in LAUNCH_LOG.shapes.items():
        if k == kernel and label in rec["launches"]:
            variant = plan_of(kernel, key).variant
            found[variant] = found.get(variant, 0) + rec["launches"][label]
    return found


def expect_variants(label: str, kernel: str, want: set[str], profile: dict) -> None:
    """The counted analysis ``label`` launched ``kernel`` by exactly the
    variants ``want``, as its launches show (launched_variants).  Where the
    profile of the same corpus saw the device, it must show each variant's
    kernel function too; an empty profile is logged and checks nothing."""
    got = launched_variants(label, kernel)
    if set(got) != want:
        raise AssertionError(f"{label}: {kernel} launched by variants {got}, expected {sorted(want)}")
    functions = {VARIANT_FUNCTIONS[kernel][v] for v in want}
    if not profile:
        log(f"{label}: {kernel} variants {got} by the launches; no profile with device time, so the kernel "
            f"functions were not checked against one")
        return
    missing = functions - set(profile.get(kernel, {}))
    if missing:
        raise AssertionError(f"{label}: the profile shows no {sorted(missing)} for {kernel}: {profile.get(kernel)}")
    log(f"{label}: {kernel} variants {got} by the launches, functions {sorted(functions)} in the profile")


def main() -> int:
    # Phases 5-6i route on the seeded constants whatever NEMO_PROFILE the
    # environment holds; phase 6j turns the profile on in a directory of its
    # own.  Subprocesses inherit the setting.
    os.environ["NEMO_PROFILE"] = "off"
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 2
    from nemo_tpu_torch.kernels import build as kbuild
    from nemo_tpu_torch.kernels import closure as closure_mod
    from nemo_tpu_torch.kernels import edge_wave as edge_wave_mod

    card = gpu_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    from nemo_tpu_torch.ingest.native import NATIVE

    t = time.perf_counter()
    # The host ingest engine (g++) builds beside the kernels (nvcc).
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(NATIVE.load)
        reports = kbuild.build()
        host.result()
    log(f"built {', '.join(kbuild.SOURCES)} and the host ingest engine in {time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    records = [check_closure(closure_mod), check_edge_wave(edge_wave_mod)]
    kernels = (closure_mod.closure, edge_wave_mod.edge_wave)

    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    LAUNCH_LOG.install(closure_mod.closure, edge_wave_mod.edge_wave, closure_mod.closure_steps)
    try:
        t = time.perf_counter()
        dense, dirs, trees = main_path(work, kernels)
        log(f"phase 5 wall {time.perf_counter() - t:.1f} s")
        zk = "ZK-1270-racing-sent-flag"
        t = time.perf_counter()
        ingest = ingest_path(work, kernels, dirs, trees)
        log(f"phase 5b wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        sparse, giant_dirs, sweep = sparse_path(work, kernels, dirs[zk], trees[zk])
        log(f"phase 6 wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        routes = routes_path(work, kernels, dirs, trees, giant_dirs)
        lane_rows, lanes = route_lanes(kernels, dirs, giant_dirs)
        print(json.dumps({"lanes": lane_rows}))
        log(f"phase 6d wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        several = dirs_path(work, kernels, dirs, trees)
        log(f"phase 6e wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        streamed = stream_path(work, kernels, dirs[zk])
        log(f"phase 6f wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        corpora = corpora_path(work, kernels, dirs, trees)
        log(f"phase 6g wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        query = query_path(work, kernels, dirs, os.path.join(work, "ingest", "corpus-cache"))
        log(f"phase 6h wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        observed = obs_path(work, kernels, dirs, trees[zk], os.path.join(work, "ingest", "corpus-cache"))
        log(f"phase 6i wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        platform = platform_path(work, kernels, dirs, trees, os.path.join(work, "ingest", "corpus-cache"))
        log(f"phase 6j wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        scheduled, injected = sched_path(work, kernels, dirs, trees, sweep,
                                         os.path.join(work, "ingest", "corpus-cache"))
        log(f"phase 6k wall {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        chaotic, chaos_injected = chaos_path(work, kernels, dirs, trees)
        log(f"phase 6l wall {time.perf_counter() - t:.1f} s")
    finally:
        LAUNCH_LOG.uninstall()
        shutil.rmtree(work, ignore_errors=True)
    log(f"launches on the dense main path {dense}, on the ingest paths {ingest}, on the sparse path {sparse}, "
        f"on the default routes {routes}, on the lanes' device calls {lanes}, through run_debug_dirs {several}, "
        f"on the streamed map {streamed}, on the corpora of phase 6g {corpora}, on the query path {query}, "
        f"observed {observed}, on the platform path {platform}, through the scheduler {scheduled}, under "
        f"chaos {chaotic}")
    from nemo_tpu_torch import obs

    # (6k d, 6l f) No phase but 6k's and 6l's injected legs failed a job
    # over, tripped the breaker or fired a chaos point: the process's
    # counters equal those legs' deltas.
    total = obs.metrics.snapshot()["counters"]
    names = set(FAILOVER_SERIES) | {k for k in (*total, *chaos_injected) if k.startswith("chaos.injected.")}
    stray = {k: (total.get(k, 0), injected.get(k, 0) + chaos_injected.get(k, 0)) for k in sorted(names)
             if total.get(k, 0) != injected.get(k, 0) + chaos_injected.get(k, 0)}
    if stray:
        raise AssertionError(f"a failover, breaker trip or chaos point outside the injected legs of 6k and 6l: "
                             f"{stray}")
    for record in records:
        record["launches"] = sum(part[record["name"]] for part in (
            dense, ingest, sparse, routes, lanes, several, streamed, corpora, query, observed, platform, scheduled,
            chaotic))
        if LAUNCH_LOG.launches(record["name"]) != record["launches"]:
            raise AssertionError(f"{record['name']}: the launch log counts {LAUNCH_LOG.launches(record['name'])} "
                                 f"launches, the wrapper {record['launches']}")
    shapes = shape_timings(LAUNCH_LOG, closure_mod, edge_wave_mod)

    print(json.dumps({"shapes": shapes}))
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
