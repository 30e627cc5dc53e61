"""The traced run's instruments: a ``torch.profiler`` capture of the whole
window (CPU and CUDA activity), ``phase:<name>`` labels on the program's
phase timer, and a record of the logical shape of every launch of the two
hand-written kernels, taken where the program's ops call them
(``ops.adjacency._closure_kernel``, ``ops.sparse_device.edge_wave``).
Nothing here runs in an untraced run."""

from __future__ import annotations

import contextlib
import json
import os
import re

from portbench.yardstick import union_s

#: The device functions of each kernel, as the profiler names them.
KERNEL_FUNCTIONS = {
    "k1": ("closure_warp_kernel", "closure_block_kernel", "pack_kernel", "square_kernel", "unpack_kernel"),
    "k2": ("edge_wave_kernel", "edge_wave_worklist_block", "edge_wave_worklist_warp"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_LABEL = "portbench:window"
_FUNC = re.compile(r"(?:void\s+)?([A-Za-z_]\w*)\s*(?:<|\()")
_MANGLED = re.compile(r"_ZN?(\d+)")
#: Leading namespaces of a demangled name: ``(anonymous namespace)::``, ``ns::``.
_QUALIFIERS = re.compile(r"^(?:void\s+)?(?:(?:\(anonymous namespace\)|[A-Za-z_]\w*)::)+")


def function_of(name: str) -> str:
    """The kernel's function name, from a demangled signature or an
    Itanium-mangled symbol (``_Z20closure_block_kernelPKhPhii``)."""
    m = _MANGLED.match(name)
    if m:
        start = m.end()
        return name[start : start + int(m.group(1))]
    m = _FUNC.match(_QUALIFIERS.sub("", name))
    return m.group(1) if m else name


def kernel_of(name: str) -> str | None:
    fn = function_of(name)
    for k, fns in KERNEL_FUNCTIONS.items():
        if fn in fns:
            return k
    return None


class Capture:
    """Context manager around the traced window."""

    def __init__(self, workdir: str) -> None:
        self.path = os.path.join(workdir, "window.pt.trace.json")
        self.launches: dict[str, list] = {"k1": [], "k2": []}
        self._restore: list = []
        self._prof = None
        self._window = None

    def __enter__(self) -> "Capture":
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        import nemo_tpu_torch.ops.adjacency as adjacency
        import nemo_tpu_torch.ops.sparse_device as sparse_device
        from nemo_tpu_torch.utils.timing import PhaseTimer

        def k1(adj, max_len=None):
            if adj.is_cuda:
                self.launches["k1"].append((adj.shape[0] if adj.ndim == 3 else 1, adj.shape[-1]))
            return fn_k1(adj, max_len=max_len)

        def k2(state, src, dst, mask, n_steps=None):
            if state.is_cuda:
                # The mask is kept, and its live edges counted once the
                # window has closed: a count here would wait for the card.
                self.launches["k2"].append((state.shape[0], state.shape[1], src.shape[-1], src.ndim == 1, mask))
            return fn_k2(state, src, dst, mask, n_steps)

        phase = PhaseTimer.phase

        @contextlib.contextmanager
        def labelled_phase(timer, name):
            with record_function(f"phase:{name}"), phase(timer, name):
                yield

        fn_k1, fn_k2 = adjacency._closure_kernel, sparse_device.edge_wave
        for mod, attr, fn in ((adjacency, "_closure_kernel", k1), (sparse_device, "edge_wave", k2),
                              (PhaseTimer, "phase", labelled_phase)):
            self._restore.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._window = record_function(WINDOW_LABEL)
        self._window.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        for mod, attr, fn in reversed(self._restore):
            setattr(mod, attr, fn)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def summary(self) -> dict:
        """What the capture saw inside the window: the device-busy union, each
        kernel's device seconds and launches, every launch's logical shape,
        the device operations that took most time and the longest idle gaps
        by the host label they fell under.  Deletes the trace file."""
        with open(self.path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        win = next(e for e in events if e.get("name") == WINDOW_LABEL and e.get("ph") == "X")
        w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        busy: list[tuple[float, float]] = []
        by_name: dict[str, float] = {}
        kernel_us = {k: 0.0 for k in KERNEL_FUNCTIONS}
        labels: list[tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                s0, s1 = max(s, w0), min(s + d, w1)
                if s1 <= s0:
                    continue
                busy.append((s0, s1))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (s1 - s0)
                k = kernel_of(e["name"])
                if k is not None:
                    kernel_us[k] += s1 - s0
            elif e.get("cat") == "user_annotation" and e.get("name") != WINDOW_LABEL:
                labels.append((s, s + d, e["name"]))
        busy_us = union_s(busy)
        gaps = []
        prev = w0
        for s, e in _merged(busy) + [(w1, w1)]:
            if s > prev:
                gaps.append((s - prev, _label_at(labels, (s + prev) / 2)))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        functions: dict[str, list] = {}
        for name, us in by_name.items():
            k = kernel_of(name)
            if k is not None:
                functions.setdefault(k, []).append([function_of(name), us / 1e6])
        return {
            "busy_s": busy_us / 1e6,
            "functions": functions,
            "trace_window_s": (w1 - w0) / 1e6,
            "kernel_s": {k: us / 1e6 for k, us in kernel_us.items()},
            "launches": self.launches,
            "breakdown": {"device_ops": [[n, us / 1e6] for n, us in top_ops],
                          "idle_gaps": [[label, us / 1e6] for us, label in gaps[:10]]},
        }


def _merged(intervals):
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _label_at(labels, t: float) -> str:
    """The innermost (shortest) host label open at time t."""
    best = None
    for s, e, name in labels:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "harness"
