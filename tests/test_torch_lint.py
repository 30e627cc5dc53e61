"""The port held to the JAX package's lint (tools/lint_no_print.py): no
bare ``print()`` outside the CLI surfaces and the pragma'd log sink, and no
``except Exception: pass`` that hides a failure, such as a card's, behind
a silent fallback."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_passes_the_print_and_silent_except_lint():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "lint_no_print.py"), os.path.join(REPO, "nemo_tpu_torch")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "lint-no-print: ok" in proc.stdout
