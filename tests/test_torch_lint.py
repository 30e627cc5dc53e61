"""The port held to the JAX package's lint (tools/lint_no_print.py): no
bare ``print()`` outside the CLI surfaces and the pragma'd log sink, and no
``except Exception: pass`` that hides a failure, such as a card's, behind
a silent fallback.  The sidecar's and the fleet's packages (service/,
serve/ with the router and the autoscaler, obs/ with the federation,
store/ with the shared tier and the lease) are linted on their own too, so
that their files are seen to be in scope."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_passes_the_print_and_silent_except_lint():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "lint_no_print.py"), os.path.join(REPO, "nemo_tpu_torch")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "lint-no-print: ok" in proc.stdout


def test_sidecar_packages_pass_the_lint():
    for sub in ("service", "serve"):
        path = os.path.join(REPO, "nemo_tpu_torch", sub)
        proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "lint_no_print.py"), path],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert "lint-no-print: ok" in proc.stdout


@pytest.mark.parametrize("sub", ["serve", "obs", "store"])
def test_fleet_packages_pass_the_lint(sub):
    """The fleet's modules (serve/router.py, serve/autoscale.py,
    obs/federation.py, store/rcache.py's lease) are each among the files
    the lint read."""
    path = os.path.join(REPO, "nemo_tpu_torch", sub)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "lint_no_print.py"), path],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    n = sum(f.endswith(".py") for _, _, files in os.walk(path) for f in files)
    assert f"lint-no-print: ok ({n} files clean)" in proc.stdout
