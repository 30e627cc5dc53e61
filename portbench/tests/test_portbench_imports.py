"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``nemo_tpu_torch`` begins with ``nemo_tpu``)."""

import ast
import os

import pytest

from benchutil import REPO

BENCH = os.path.join(REPO, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "nemo_tpu"}


def top_level_imports(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs if f.endswith(".py")
)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_nor_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"nemo_tpu_torch"})


def test_the_check_sees_through_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import nemo_tpu_torch.cli\nfrom nemo_tpu.ops import x\nimport importlib\n"
                 "importlib.import_module('jax.numpy')\n")
    assert top_level_imports(str(p)) == {"nemo_tpu_torch", "nemo_tpu", "importlib", "jax"}
