"""The module-name check every run makes, and what the reference imports."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.harness import ROOT, forbidden_modules

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                  "multithreadedgameengine_tpu", "multithreadedgameengine_tpu.ops"])
def test_forbidden_names_fail(name):
    assert forbidden_modules(["torch", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", ["multithreadedgameengine_tpu_torch",
                                  "multithreadedgameengine_tpu_torch.engine", "jaxtyping", "numpy"])
def test_other_names_pass(name):
    assert forbidden_modules(["torch", name]) == []


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_packages(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "multithreadedgameengine_tpu",
                       "multithreadedgameengine_tpu_torch"}


def test_reference_loads_no_package():
    code = ("import sys; import bench_port.reference.boids; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'multithreadedgameengine_tpu', 'multithreadedgameengine_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
