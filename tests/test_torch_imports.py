"""The port stands on PyTorch alone: no file of ``pdecontrol_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX, flax, optax, orbax or the JAX package.

The check reads the sources: a test process may already hold jax in
``sys.modules`` (the suite imports it, and some hosts pre-import it), so
looking at ``sys.modules`` could not prove anything.  The GPU host has no
JAX installed at all."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "pdecontrol_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pdecontrol_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_sources_found():
    assert len(SOURCES) > 20
    assert (PORT / "csrc" / "ks_control_period.cu").exists()
    assert (PORT / "csrc" / "ks_control_period_limb.cu").exists()
    for module in ("ops/pallas_ks_packed.py", "evaluation/bf16_gate.py", "sac/train.py",
                   "utils/checkpoint.py", "utils/asyncviz.py", "utils/waterfall.py",
                   "viz/plots.py", "viz/report.py", "mbrl/agents.py", "ops/burgers.py",
                   "envs/burgers.py", "envs/gym_compat.py", "train/metrics.py",
                   "evaluation/generate.py", "evaluation/evaluate.py",
                   "parallel/distributed.py", "parallel/mesh.py", "parallel/sharded.py",
                   "parallel/dryrun.py", "parallel/dryrun_mp.py", "utils/native.py"):
        assert PORT / module in SOURCES, module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_triton_and_kernel_builds_are_not_done_at_import():
    """Kernels are built inside the function that launches them: importing
    a module never needs nvcc or a card."""
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] == "triton" for n in names), path
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                func = node.value.func
                called = getattr(func, "attr", getattr(func, "id", ""))
                assert called not in ("build", "load"), f"{path} builds at import"
