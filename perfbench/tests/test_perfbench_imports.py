"""No module under perfbench/ imports JAX, its libraries or the JAX
package (top-level names compared whole: the measured package's name
begins with the JAX package's), and the reference imports nothing of the
measured package either."""

import ast

import pytest

from perfbench.core import spec

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "datr_tpu"}
MODULES = sorted(spec.BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(spec.BENCH)) for p in MODULES])
def test_no_jax(path):
    assert not set(_imports(path)) & BANNED


def test_reference_stands_alone():
    for path in (spec.BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert not names & (BANNED | {"datr_torch", "perfbench"}), path


def test_only_program_module_imports_the_port():
    for path in MODULES:
        if "datr_torch" in set(_imports(path)):
            assert path.parent.name in ("core", "tests"), path
            assert path.name in ("program.py", "cell.py") \
                or path.parent.name == "tests", path


def test_banned_check_compares_whole_names():
    import importlib.util
    import sys

    spec_ = importlib.util.spec_from_file_location(
        "perfbench_run", spec.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    probes = ["datr_tpu_probe", "jaxlike", "datr_tpu.sub"]
    for name in probes:
        sys.modules[name] = sys
    try:
        found = run.banned_modules()
        assert "datr_tpu_probe" not in found and "jaxlike" not in found
        assert "datr_tpu" in found
    finally:
        for name in probes:
            del sys.modules[name]
