"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``; ``None`` means ``cuda``.  A
request for ``cuda`` on a machine without a usable card raises — the port
never carries on silently on the CPU.  The CPU is taken only when the caller
asks for it (the tests do).

Importing this module installs the ``obs`` profiler hook: while a
``torch.profiler`` capture is running, every ``obs.span`` and every phase
of ``utils/timing.py:PhaseTimer`` puts a ``record_function`` label of its
own name on the capture's timeline (obs/trace.py).
"""

from __future__ import annotations

import torch

from nemo_tpu_torch.obs import trace as _trace

_trace.set_profiler_hook(torch._C._autograd._profiler_enabled, torch.profiler.record_function)


def stream_sync(dev: torch.device | None):
    """A synchronize of ``dev``'s current stream on the card, else None: the
    ``sync`` of a PhaseTimer (utils/timing.py) whose phases cover the device
    work they queued."""
    if dev is None or dev.type != "cuda":
        return None
    return lambda: torch.cuda.current_stream(dev).synchronize()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU.  Any other device type raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
