"""The port stands alone: importing any module of datr_torch, chip_smoke.py,
msda_kernel_bench.py, step_check_states.py or the ranks' module of the
multi-process tests (tests/torch_port_dist_worker.py; without running its
main) loads none of jax,
jaxlib, flax, optax or datr_tpu, nor PIL (the card's machine has none; the
port decodes JPEG and PNG without it, and imports it only inside
`coco.decode_rgb` for other formats and inside `inference.main` to draw).
One subprocess (this test process has
imported jax already) imports the modules one after another and reports,
after each import, which of those packages are loaded; each module is a
case of its own."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "datr_tpu", "PIL")
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "datr_torch").rglob("*.py")) + [
        "chip_smoke", "msda_kernel_bench", "step_check_states",
        "tests.torch_port_dist_worker"]

_PROBE = """
import importlib, json, sys
forbidden = set(sys.argv[1].split(","))
loaded = {}
for name in sys.argv[2:]:
    importlib.import_module(name)
    loaded[name] = sorted(m for m in sys.modules
                          if m.split(".")[0] in forbidden)
print(json.dumps(loaded))
"""


@pytest.fixture(scope="module")
def loaded():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, ",".join(FORBIDDEN), *MODULES],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def test_every_port_module_is_a_case():
    assert "datr_torch.ops.gather" in MODULES and "datr_torch" in MODULES
    assert {"datr_torch.data.png", "datr_torch.inference",
            "datr_torch.tools.serve_bench", "datr_torch.serve",
            "datr_torch.parallel.dist", "datr_torch.parallel.mesh",
            "datr_torch.parallel.pipeline",
            "tests.torch_port_dist_worker"} <= set(MODULES)
    assert len(MODULES) == len(set(MODULES)) > 30


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax(loaded, module):
    assert loaded[module] == [], (
        f"after importing {module}: {loaded[module]} loaded (the first "
        f"module in {MODULES} whose list is not empty imported them)")
