"""Measured platform profiles: a bounded calibration on the device and the
persistent, fingerprint-keyed profile of routing constants it fits, which
replace the seeded ones: argument > measured profile > seeded, recorded
per constant.  platform/profile.py holds the precedence and invalidation
contract, platform/calibrate.py the probe suite."""

from .fingerprint import fingerprint_key, platform_fingerprint
from .profile import (
    PROFILE_ABI_VERSION,
    PlatformProfile,
    active_profile,
    constant_sources,
    ensure_calibrated,
    profile_mode,
    profile_value,
    reset_active_profile,
    resolve_constants,
    telemetry_section,
)

__all__ = [
    "PROFILE_ABI_VERSION",
    "PlatformProfile",
    "active_profile",
    "constant_sources",
    "ensure_calibrated",
    "fingerprint_key",
    "platform_fingerprint",
    "profile_mode",
    "profile_value",
    "reset_active_profile",
    "resolve_constants",
    "telemetry_section",
]
