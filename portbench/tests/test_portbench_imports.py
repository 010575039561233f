"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, the generators and the optimizers' reference rules import
nothing of the program (an optimizer's ``build`` imports the port's
optimizer when it is called).  Top-level module names are compared
whole: ``mindrec_tpu_torch`` is not ``mindrec_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mindrec_tpu"}


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


YARDSTICK = sorted(p for d in ("reference", "sources")
                   for p in (HERE / d).rglob("*.py"))


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "mindrec_tpu_torch" not in imported_tops(path)


def _modules(sub: str) -> list[str]:
    return [f"portbench.{sub}.{p.stem}" for p in sorted((HERE / sub).glob("*.py"))
            if p.stem != "__init__"]


def test_reference_side_loads_nothing_of_the_program():
    """Every reference, generator and optimizer module imported in a
    fresh process (the optimizers' ``build`` not called) leaves no
    module of the program behind."""
    mods = _modules("reference") + _modules("sources") + _modules("optimizers")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] == 'mindrec_tpu_torch'))"
            % (str(ROOT), mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_whole_names_compared():
    from portbench.harness import forbidden_modules

    sys.modules.setdefault("mindrec_tpu_torch_x", sys)
    try:
        assert "mindrec_tpu_torch_x" not in forbidden_modules()
    finally:
        sys.modules.pop("mindrec_tpu_torch_x")


def test_a_run_loads_no_jax():
    """The harness, the program and the reference imported in a fresh
    process leave no JAX module behind."""
    mods = _modules("reference") + _modules("sources") + _modules("optimizers")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import importlib\n"
            "import portbench.harness, portbench.program, portbench.control\n"
            "for m in %r: importlib.import_module(m)\n"
            "from portbench.harness import forbidden_modules\n"
            "print(forbidden_modules())" % (str(ROOT), mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
