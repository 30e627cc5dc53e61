"""Chip smoke test of the PyTorch/CUDA port (nemo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card.  Phases,
each fatal (non-zero exit, no result line) on failure:

  1. print the card's name and power limit (nvidia-smi); exit if
     torch.cuda.is_available() is False;
  2. build every CUDA kernel of the port from csrc/ (nvcc, sm_90a), one
     nvcc per source, all at once;
  3. hold the closure kernel (K1) against its plain PyTorch version on the
     card, bit for bit, at the main path's shapes and a set of edge cases,
     and time it (with a hot and with a cold L2) beside the plain version
     and a bf16 torch.bmm squaring chain (the library yardstick, which the
     port never calls);
  4. hold the edge-wave kernel (K2) against its plain version, bit for bit,
     at the sparse path's shapes, n_steps 1-4 and the fix point, on cyclic
     graphs, padding rows, an all-false mask, a shared edge list and a
     10,000-node chain, and time it beside the plain version and a
     torch.sparse CSR block-diagonal matrix-vector product (the yardstick);
  5. drive the dense main path — TorchBackend over all six case-study
     families at 1,700 runs each (seed 0) — with the kernels' launch counts
     zeroed just before and read just after, and check the ZK-1270 analysis
     document on cuda equals the port's cpu document;
  6. drive the sparse path, each analysis with the launch counts zeroed
     just before and read just after: (a) two giant-V corpora on the auto
     route (every giant run on sparse_fused; a giant good run's diff on
     sparse_diff), (b) a long-horizon sweep of 1,700 runs whose buckets
     split between the dense and the sparse tier (both kernels launch),
     each document equal to the cpu one, and (c) ZK-1270 forced onto the
     sparse tier, whose document must equal the dense one.

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8
#: tensor-core operations/s and float32 operations/s outside the tensor
#: cores (the nearest listed rate for K2's scalar bit operations).
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_FP32_OPS_S = 67e12

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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
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


def time_ms_cold_l2(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() with a cold L2: a 64 MB buffer (more than
    the H100's 50 MB L2) is written before every call, outside the timed
    span."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    spans = []
    for i in range(warmup + iters):
        flush.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans[warmup:]) / iters


def closure_bmm_bf16(adj: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Library yardstick: the closure as a chain of bf16 torch.bmm calls."""
    v = adj.shape[-1]
    r = (adj | torch.eye(v, dtype=torch.bool, device=adj.device)).to(torch.bfloat16)
    for _ in range(n_steps):
        r = (torch.bmm(r, r) > 0.5).to(torch.bfloat16)
    return r > 0.5


def check_closure(closure_mod) -> dict:
    """Phase 3: K1 against closure_plain on the card, then timings."""
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

    b, v, max_len = TIMED_SHAPE
    adj = torch.from_numpy(rng.random((b, v, v)) < 2.0 / v).to(dev)
    n_steps = closure_steps(v, max_len)
    launches_before = closure.launches
    ms = time_ms(lambda: closure(adj, max_len=max_len))
    cold_ms = time_ms_cold_l2(lambda: closure(adj, max_len=max_len))
    closure.launches = launches_before  # timing launches are not main-path launches
    plain_ms = time_ms(lambda: closure_plain(adj, max_len=max_len))
    library_ms = time_ms(lambda: closure_bmm_bf16(adj, n_steps))
    if not torch.equal(closure_bmm_bf16(adj, n_steps), closure_plain(adj, max_len=max_len)):
        raise AssertionError("bf16 bmm yardstick disagrees with closure_plain")
    bytes_moved = 2 * b * v * v  # one read of the bool input, one write of the output
    ops = n_steps * 2 * b * v ** 3  # multiply-adds of the squaring chain, as int8 MMA ops
    bound_s = {"bytes": bytes_moved / PEAK_BYTES_S, "operations": ops / PEAK_INT8_OPS_S}
    bound_by = max(bound_s, key=bound_s.get)
    log(f"closure timing [{b},{v},{v}] max_len={max_len} ({n_steps} squarings): kernel {ms:.4f} ms "
        f"(cold L2 {cold_ms:.4f} ms), plain {plain_ms:.4f} ms, bf16 bmm chain {library_ms:.4f} ms, "
        f"bound {bound_s[bound_by] * 1e3:.5f} ms ({bound_by})")
    return {
        "name": "closure",
        "route": "cuda",
        "source": "nemo_tpu_torch/csrc/closure.cu",
        "replaces": "nemo_tpu/ops/pallas_kernels.py:180",
        "launches": None,  # filled in from the main path's run
        "max_abs_err": float(max_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s[bound_by] * 1e3,
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

    def waves(n: int) -> torch.Tensor:
        x = x0
        for _ in range(n):
            x = ((adj @ x) + x > 0).to(torch.float32)
        return x.reshape(b, v) > 0

    return waves


def check_edge_wave(ew_mod) -> dict:
    """Phase 4: K2 against edge_wave_plain on the card, then timings."""
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
    chain = chain_inputs(rng)
    for n_steps in EDGE_WAVE_STEPS:
        got = compare("chain", chain, n_steps)
        if int(got.sum()) != (CHAIN_NODES if n_steps is None else n_steps + 1):
            raise AssertionError(f"edge_wave chain n_steps={n_steps}: {int(got.sum())} nodes reached")
    chain_ms = time_ms(lambda: edge_wave(*chain, None), iters=3, warmup=1)
    chain_plain_ms = time_ms(lambda: plain(*chain, None), iters=1, warmup=0)
    log(f"edge_wave chain of {CHAIN_NODES} nodes in V=E={CHAIN_V}: bit-identical at n_steps "
        f"{EDGE_WAVE_STEPS}; fix point kernel {chain_ms:.4f} ms, plain {chain_plain_ms:.4f} ms")

    b, v, e = EDGE_WAVE_TIMED
    args = wave_inputs(rng, b, v, e)
    final = plain(*args, None)
    waves = 1  # the kernel's last wave finds nothing new
    cur = args[0]
    while not torch.equal(cur, final):
        cur = plain(cur, *args[1:], 1)
        waves += 1
    yardstick = csr_waves(*args)
    if not torch.equal(yardstick(waves), final):
        raise AssertionError("torch.sparse CSR yardstick disagrees with edge_wave_plain")
    ms = time_ms(lambda: edge_wave(*args, None))
    edge_wave.launches = launches_before  # check and timing launches are not main-path launches
    plain_ms = time_ms(lambda: plain(*args, None))
    library_ms = time_ms(lambda: yardstick(waves))
    n_edges = int(args[3].sum())
    # One read of the state and the edge planes (int32 src and dst, bool
    # mask), one write of the output; per wave, a bit test of each masked
    # edge's source and an OR into its destination.
    bytes_moved = 2 * b * v + 9 * b * e
    ops = waves * 2 * n_edges
    bound_s = {"bytes": bytes_moved / PEAK_BYTES_S, "operations": ops / PEAK_FP32_OPS_S}
    bound_by = max(bound_s, key=bound_s.get)
    log(f"edge_wave timing [{b},{v}] E={e} to the fix point ({waves} waves, {n_edges} masked edges): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse CSR waves {library_ms:.4f} ms, "
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


def strip_run_facts(doc: dict) -> dict:
    """The analysis document without the facts of the run itself."""
    return {k: v for k, v in doc.items() if k not in ("device", "timings_s", "dispatch_wall_s")}


def analyze_counted(label: str, cd: str, kernels, **kw) -> tuple[dict, float, dict]:
    """One analysis on cuda through the CLI's entry point, with every
    kernel's launch count set to 0 just before and read just after.
    Returns (document, host wall s, launches by kernel name) and logs the
    routes, the phase walls and the plain fix-point loops' iterations."""
    from nemo_tpu_torch.cli import analyze
    from nemo_tpu_torch.ops.sparse_device import LOOP_STATS

    LOOP_STATS.clear()
    for k in kernels:
        k.launches = 0
    t = time.perf_counter()
    doc = analyze(cd, device="cuda", **kw)
    wall = time.perf_counter() - t
    counts = {k.__name__: k.launches for k in kernels}
    routes = [(r["verb"], r["route"], r["rows"], r["v"], r["e"], r["reason"]) for r in doc["routes"]]
    loops = {n: (r["calls"], r["iters"], round(r["wall_s"], 4)) for n, r in LOOP_STATS.items()}
    log(f"{label}: {doc['runs']} runs, {len(doc['failed_iters'])} failed, wall {wall:.3f} s, "
        f"{doc['runs'] / wall:.1f} runs/s, launches {counts}, dispatches {doc['dispatches']}, "
        f"routes (verb, route, rows, v, e, reason) {routes}, "
        f"plain fix-point loops (calls, iters, wall s) {loops}, "
        f"phase wall {json.dumps({k: round(v, 4) for k, v in doc['timings_s'].items()})}, "
        f"dispatch wall {json.dumps({k: round(v, 4) for k, v in doc['dispatch_wall_s'].items()})}")
    return doc, wall, counts


def check_cpu_equal(label: str, cd: str, doc: dict, **kw) -> None:
    """The same analysis on the CPU must give the same document."""
    from nemo_tpu_torch.cli import analyze

    t = time.perf_counter()
    cpu_doc = analyze(cd, device="cpu", **kw)
    log(f"{label} on cpu: {time.perf_counter() - t:.3f} s")
    if strip_run_facts(cpu_doc) != strip_run_facts(doc):
        diff = [k for k in cpu_doc if cpu_doc[k] != doc.get(k)]
        raise AssertionError(f"{label}: cuda document differs from cpu document in {diff}")
    log(f"{label}: cuda analysis document equals the cpu document "
        f"({sum(len(v) for v in cpu_doc['missing_events'].values())} missing events)")


def main_path(work: str, kernels) -> tuple[dict, str, dict]:
    """Phase 5: all six families through TorchBackend on cuda.  Returns the
    launches by kernel over the run, and ZK-1270's directory and document."""
    from nemo_tpu_torch.cli import analyze
    from nemo_tpu_torch.models.case_studies import write_all_case_studies, write_case_study

    t0 = time.perf_counter()
    dirs = write_all_case_studies(FAMILY_RUNS, SEED, work)
    log(f"generated {len(dirs)} families x {FAMILY_RUNS} runs in {time.perf_counter() - t0:.2f} s")
    # Warm-up on a small corpus: CUDA context, cuBLAS handles, the loaded
    # kernel library.  Not part of the timed main path.
    warm = write_case_study("pb_asynchronous", 12, SEED, os.path.join(work, "warm"))
    analyze(warm, device="cuda")

    launches = {k.__name__: 0 for k in kernels}
    docs = {}
    for name, cd in dirs.items():
        doc, _wall, counts = analyze_counted(f"main path {name}", cd, kernels)
        docs[name] = doc
        for k, n in counts.items():
            launches[k] += n
        if doc["runs"] != FAMILY_RUNS or counts["closure"] <= 0:
            raise AssertionError(f"{name}: {doc['runs']} runs analyzed, {counts['closure']} closure launches")
        if doc["failed_iters"] and not any(doc["missing_events"].values()):
            raise AssertionError(f"{name}: failed runs but no missing events")
        if not doc["inter_proto"] or not doc["union_proto"]:
            raise AssertionError(f"{name}: empty prototypes")

    zk = "ZK-1270-racing-sent-flag"
    check_cpu_equal(zk, dirs[zk], docs[zk])
    profile_family(dirs[zk])
    return launches, dirs[zk], docs[zk]


def sparse_path(work: str, kernels, zk_dir: str, zk_dense_doc: dict) -> dict:
    """Phase 6: the sparse-CSR device tier through TorchBackend on cuda.
    Returns the launches by kernel over its analyses."""
    from nemo_tpu_torch.models.synth import SynthSpec, write_corpus

    launches = {k.__name__: 0 for k in kernels}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) Giant-V corpora on the auto route: every run above GIANT_V nodes
    # leaves the buckets for its own sparse_fused dispatch (the buckets left
    # hold only runs of at most GIANT_V nodes, as their V bucket shows), and
    # a giant good run's diff goes to sparse_diff.
    sparse_diffs = 0
    giant_dirs = []
    for name, n_runs, seed, eot in GIANT_SPECS:
        t = time.perf_counter()
        cd = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, eot=eot, name=name), work)
        log(f"generated {name} in {time.perf_counter() - t:.2f} s")
        giant_dirs.append(cd)
        doc, _wall, counts = analyze_counted(f"sparse path {name}", cd, kernels)
        add(counts)
        fused = [r for r in doc["routes"] if r["verb"] == "fused"]
        giants = [r for r in doc["routes"] if r["verb"] == "giant"]
        (diff,) = [r for r in doc["routes"] if r["verb"] == "diff"]
        n_sparse = len(giants) + sum(r["route"] == "sparse_device" for r in fused)
        if (
            not giants
            or any(r["route"] != "sparse_device" or r["rows"] != 1 for r in giants)
            or any(r["v"] > GIANT_V for r in fused)
            or sum(r["rows"] for r in fused) + len(giants) != doc["runs"]
            or doc["dispatches"].get("sparse_fused", 0) != n_sparse
        ):
            raise AssertionError(f"{name}: giant runs not each on sparse_fused: {doc['routes']}")
        if diff["v"] > GIANT_V:  # the good run's node count
            if (diff["route"], diff["reason"]) != ("sparse_device", "giant") or doc["dispatches"].get(
                "sparse_diff"
            ) != 1:
                raise AssertionError(f"{name}: a giant good run's diff not on sparse_diff: {diff}")
            sparse_diffs += 1
        if counts["edge_wave"] <= 0:
            raise AssertionError(f"{name}: edge_wave never launched")
        check_cpu_equal(name, cd, doc)
    if not sparse_diffs:
        raise AssertionError("no giant corpus drove sparse_diff")
    profile_family(giant_dirs[0])

    # (b) The long-horizon sweep on the auto route: some buckets past the
    # dense memory watermark go sparse by "mem", the others stay dense, so
    # both kernels launch in one analysis.
    name, n_runs, seed, eot = SWEEP_SPEC
    t = time.perf_counter()
    cd = write_corpus(SynthSpec(n_runs=n_runs, seed=seed, eot=eot, name=name), work)
    log(f"generated {name} in {time.perf_counter() - t:.2f} s")
    doc, _wall, counts = analyze_counted(f"sparse path {name}", cd, kernels)
    add(counts)
    split = {(r["route"], r["reason"]) for r in doc["routes"] if r["verb"] == "fused"}
    if ("sparse_device", "mem") not in split or not any(route == "dense" for route, _ in split):
        raise AssertionError(f"{name}: buckets did not split between the tiers: {doc['routes']}")
    if doc["runs"] != n_runs or min(counts.values()) <= 0:
        raise AssertionError(f"{name}: {doc['runs']} runs, launches {counts}")
    check_cpu_equal(name, cd, doc)
    profile_family(cd)

    # (c) ZK-1270 forced onto the sparse tier: the document equals the dense
    # one of the main path, and no dense kernel runs.
    doc, _wall, counts = analyze_counted(
        "sparse path ZK-1270 forced sparse_device", zk_dir, kernels, analysis_impl="sparse_device"
    )
    add(counts)
    if counts["closure"] != 0 or counts["edge_wave"] <= 0:
        raise AssertionError(f"ZK-1270 forced sparse: launches {counts}")
    if {r["route"] for r in doc["routes"]} != {"sparse_device"}:
        raise AssertionError(f"ZK-1270 forced sparse: routes {doc['routes']}")
    facts = ("routes", "dispatches")
    if {k: v for k, v in strip_run_facts(doc).items() if k not in facts} != {
        k: v for k, v in strip_run_facts(zk_dense_doc).items() if k not in facts
    }:
        raise AssertionError("ZK-1270: the sparse document differs from the dense one")
    log("ZK-1270: the forced-sparse document equals the dense document")
    return launches


def profile_family(cd: str) -> None:
    """Device busy time of one corpus's analysis, by torch.profiler: the
    sum of kernel times on the card against the wall of the whole run."""
    from torch.profiler import ProfilerActivity, profile

    from nemo_tpu_torch.cli import analyze

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        analyze(cd, device="cuda")
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if not busy_us:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return
    log(f"profile {os.path.basename(cd)}: wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e6 / wall:.2f} % of the wall), {len(events)} kernel names")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
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

    t = time.perf_counter()
    reports = kbuild.build()
    log(f"built {', '.join(kbuild.SOURCES)} in {time.perf_counter() - t:.2f} s")
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
    try:
        dense, zk_dir, zk_doc = main_path(work, kernels)
        sparse = sparse_path(work, kernels, zk_dir, zk_doc)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"launches on the dense main path {dense}, on the sparse path {sparse}")
    for record in records:
        record["launches"] = dense[record["name"]] + sparse[record["name"]]

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
