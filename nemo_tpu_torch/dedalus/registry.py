"""Bundled case-study specs and their recorded fault-injection parameters.

One executable spec per reference case-study family (original formulations;
the reference records its Molly parameters in each file's header comment,
e.g. case-studies/pb_asynchronous.ded:2, MR-3858-hadoop.ded:2)."""

from __future__ import annotations

import os

from .faults import FaultSpec

_SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")

BUNDLED_SPECS: dict[str, FaultSpec] = {
    "pb_asynchronous": FaultSpec(eot=6, eff=4, max_crashes=0),
    "ca_2083_hinted_handoff": FaultSpec(eot=7, eff=4, max_crashes=1),
    "ca_2434_bootstrap_sync": FaultSpec(eot=8, eff=5, max_crashes=0),
    "mr_2995_failed_after_expiry": FaultSpec(eot=8, eff=5, max_crashes=0),
    "mr_3858_hadoop": FaultSpec(eot=6, eff=4, max_crashes=1),
    "zk_1270_racing_flag": FaultSpec(eot=6, eff=3, max_crashes=0),
}


def bundled_spec_path(name: str) -> str:
    return os.path.join(_SPEC_DIR, f"{name}.ded")
