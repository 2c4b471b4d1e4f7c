"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under benchmark/, and nothing of the program in the reference.
Top-level module names are compared whole: the program's name,
fv3jedi_lm_tpu_torch, begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

JAX = {"jax", "jaxlib", "flax", "fv3jedi_lm_tpu"}
PROGRAM = "fv3jedi_lm_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))
#: the reference and everything it runs
REFERENCE = sorted([BENCH / "reference.py", BENCH / "control.py"]
                   + list((BENCH / "fvref").rglob("*.py")))


def top_level_imports(path):
    """The top-level names of the absolute imports in `path`."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_names():
    assert "fv3jedi_lm_tpu_torch".split(".")[0] not in JAX


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_under_benchmark(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[str(p.relative_to(BENCH)) for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path[:0] = [%r]; import reference, control, "
            "generator, compare; import fvref.physics.moist, "
            "fvref.physics.turbulence; print(sorted({m.split('.')[0] for m "
            "in sys.modules}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO).stdout
    loaded = set(eval(out))
    assert not loaded & (JAX | {PROGRAM})


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness; "
            "harness.Program; import fv3jedi_lm_tpu_torch.lm; "
            "print(harness.forbidden_modules())" % (str(BENCH), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO).stdout
    assert out.strip() == "[]"
