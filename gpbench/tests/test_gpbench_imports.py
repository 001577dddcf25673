"""Neither the harness nor the reference loads JAX or the JAX package,
and the reference loads nothing of the program: top-level module names
compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
GPBENCH = ROOT / "gpbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "muygpys_tpu"}


def imported_roots(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def loaded_after(modules):
    code = ("import sys, importlib; sys.path.insert(0, %r); "
            "[importlib.import_module(m) for m in %r]; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))"
            % (str(ROOT), modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_sources_import_nothing_forbidden():
    for path in GPBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imported_roots(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (GPBENCH / "reference").glob("*.py"):
        assert "muygpys_torch" not in imported_roots(path), path
    loaded = loaded_after(["gpbench.reference.knn", "gpbench.reference.matern",
                           "gpbench.reference.shear",
                           "gpbench.reference.precision"])
    assert "muygpys_torch" not in loaded and not loaded & FORBIDDEN


def test_harness_and_program_load_no_jax():
    loaded = loaded_after(["gpbench.harness.core", "gpbench.entries.serve",
                           "muygpys_torch.serve", "muygpys_torch.neighbors"])
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
