"""Platform fingerprint: the identity a measured profile is keyed by.

A port of the JAX package's ``platform/fingerprint.py``.  A profile is only
trustworthy on the stack it was measured on, so every constant the
calibrator persists is keyed by what the routing walls depend on: the
device type (cuda or cpu), the card's name, the device count, the torch and
CUDA versions, the analysis ABI, and the build digests of the port's CUDA
kernels (a kernel redesign moves the device walls as surely as new
silicon).  Any change produces another key, so a stale profile is never
loaded: it is simply not found, and the first run on the new stack
calibrates (platform/profile.py:ensure_calibrated).

None of it changes within a process, so each device's fingerprint is
computed once (it reads and hashes the kernel sources) and reused by every
profile lookup; ``clear_fingerprints`` forgets them (tests).
"""

from __future__ import annotations

import hashlib
import json

#: str(device) -> its fingerprint, computed on first use.
_FINGERPRINTS: dict[str, dict] = {}


def clear_fingerprints() -> None:
    _FINGERPRINTS.clear()


def platform_fingerprint(device=None) -> dict:
    """The identity dict of ``device`` (None: cuda, which raises without a
    card), JSON-able; keys are dumped sorted.  A fresh copy of the
    process's cached one."""
    from nemo_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    fp = _FINGERPRINTS.get(str(dev))
    if fp is None:
        fp = _FINGERPRINTS[str(dev)] = _compute(dev)
    return dict(fp, kernels=dict(fp["kernels"]))


def _compute(dev) -> dict:
    import torch

    from nemo_tpu_torch.analysis import delta
    from nemo_tpu_torch.kernels import build

    cuda = dev.type == "cuda"
    return {
        "platform": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "analysis_abi": int(delta.ANALYSIS_ABI_VERSION),
        "kernels": {name: build.source_digest(name) for name in build.SOURCES},
    }


def fingerprint_key(fp: dict) -> str:
    """Short stable content key of a fingerprint dict: the profile file
    name component (profile-<key>.json) and the cross-check stamp inside
    the file."""
    blob = json.dumps(fp, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]
