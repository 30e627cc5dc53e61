"""Prewarm: build every native library, then run each family's stress-scale
fused step once.

    python -m nemo_tpu_torch.utils.prewarm [--device cuda|cpu]
        [--runs-per-family N] [--probe-runs N]

A port of the JAX package's ``utils/prewarm.py``.  The port has no jit, so
what a first report would otherwise pay is the build: the nvcc kernels
(kernels/build.py) and the g++ ingest and report engines (utils/cbuild.py).  Prewarm
builds them all at once, then dispatches one fused step per case-study
family at the stress signature through ``TorchExecutor``, which creates
the CUDA context and cuBLAS handles and fills the caching allocator.  It
prints each family's wall.  ``--device cpu`` skips nvcc (the CPU runs the
plain versions); ``cuda`` without a card raises.

The signature's corpus-dependent statics (table ids, table-count bucket,
depth bucket) come from a small generated corpus of the family: its
generator draws every run from one protocol template, so they do not
depend on the corpus size.  The batch-axis dims are floors: the run axis
pads to ``b_pad``, V/E/table/depth to the stress floors of the fused
dispatch.  Unlike the reference, the planes keep their packed dtypes: the
port does not narrow its uploads.  The sidecar's chunk signature comes
with the sidecar.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time


def stress_signature(name: str, n_probe: int, b_pad: int):
    """(pre, post, static) of the stress-scale fused dispatch of family
    ``name``: numpy BatchArrays padded to ``b_pad`` runs, V >= 64,
    E >= 256, a table bucket >= 32, 8 labels, a depth bucket >= 32 and no
    diff tail, from an ``n_probe``-run corpus through the native engine."""
    import numpy as np

    from nemo_tpu_torch.graphs.packed import bucket_size
    from nemo_tpu_torch.ingest.native import corpus_step_static, ingest_native
    from nemo_tpu_torch.models.case_studies import write_case_study
    from nemo_tpu_torch.models.pipeline_model import BatchArrays

    if b_pad < n_probe:
        raise ValueError(f"run-axis pad {b_pad} smaller than the probe corpus ({n_probe} runs); "
                         "raise --runs-per-family or lower --probe-runs")
    with tempfile.TemporaryDirectory(prefix="nemo_prewarm_") as tmp:
        c = ingest_native(write_case_study(name, n_runs=n_probe, seed=11, out_dir=tmp), with_node_ids=False)
    static = corpus_step_static(c)
    v = max(64, static["v"])
    e = max(256, int(c.pre.edge_src.shape[1]))
    static = dict(
        static,
        v=v,
        num_tables=bucket_size(static["num_tables"], 32),
        num_labels=8,
        max_depth=bucket_size(static["max_depth"], 32),
        with_diff=0,
    )

    def grow(a, cols, fill):
        src = np.asarray(a)
        out = np.full((b_pad, cols), fill, dtype=src.dtype)
        out[: src.shape[0], : src.shape[1]] = src[:, : min(cols, src.shape[1])]
        return out

    def pad(batch) -> BatchArrays:
        return BatchArrays(
            edge_src=grow(batch.edge_src, e, 0),
            edge_dst=grow(batch.edge_dst, e, 0),
            edge_mask=grow(batch.edge_mask, e, False),
            is_goal=grow(batch.is_goal, v, False),
            table_id=grow(batch.table_id, v, -1),
            label_id=grow(batch.label_id, v, -1),
            type_id=grow(batch.type_id, v, 0),
            node_mask=grow(batch.node_mask, v, False),
        )

    return pad(c.pre), pad(c.post), static


def build_all(device) -> float:
    """Build the g++ ingest and report engines and, on cuda, every nvcc
    kernel, all at once (each a no-op when its library is built).  Returns
    the wall."""
    from concurrent.futures import ThreadPoolExecutor

    from nemo_tpu_torch.device import resolve_device
    from nemo_tpu_torch.ingest.native import NATIVE
    from nemo_tpu_torch.kernels import build as kbuild
    from nemo_tpu_torch.report.native import REPORT

    dev = resolve_device(device)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        engines = [pool.submit(lib.load) for lib in (NATIVE, REPORT)]
        if dev.type == "cuda":
            kbuild.build()
        for engine in engines:
            engine.result()
    return time.perf_counter() - t0


def fused_arrays(pre, post) -> dict:
    """The fused verb's named inputs of one (pre, post) signature."""
    from nemo_tpu_torch.models.pipeline_model import BatchArrays

    return {f"{cond}_{f}": getattr(b, f) for cond, b in (("pre", pre), ("post", post)) for f in BatchArrays.FIELDS}


def prewarm_family(name: str, n_probe: int, b_pad: int, device) -> float:
    """One fused dispatch of the family's stress signature on ``device``,
    through ``TorchExecutor``; returns its wall (the corpus generation and
    packing left out), the device synchronized."""
    import torch

    from nemo_tpu_torch.backend.torch_backend import TorchExecutor

    pre, post, static = stress_signature(name, n_probe, b_pad)
    ex = TorchExecutor(device)
    t0 = time.perf_counter()
    ex.run("fused", fused_arrays(pre, post), static, rows=n_probe)
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> int:
    from nemo_tpu_torch.graphs.packed import bucket_size
    from nemo_tpu_torch.models.case_studies import CASE_STUDIES

    p = argparse.ArgumentParser(prog="python -m nemo_tpu_torch.utils.prewarm", description=__doc__.splitlines()[0])
    p.add_argument("--runs-per-family", type=int, default=1700,
                   help="stress scale; the run axis pads to its power-of-two bucket (default 1700 -> 2048)")
    p.add_argument("--probe-runs", type=int, default=64,
                   help="size of the small corpus each family's statics come from")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    built = build_all(args.device)
    print(f"built the native libraries for {args.device} in {built:.2f} s", flush=True)
    b_pad = bucket_size(args.runs_per_family, 8)
    total = 0.0
    for name in sorted(CASE_STUDIES):
        dt = prewarm_family(name, args.probe_runs, b_pad, args.device)
        total += dt
        print(f"  {name}: fused step at B={b_pad} in {dt:.4f} s", flush=True)
    print(f"prewarm done in {built + total:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
