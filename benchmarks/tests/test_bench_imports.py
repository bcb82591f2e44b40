"""What the benchmark runs imports no JAX and not the JAX package, and its
plain reference imports nothing of the program.

The modules are found from ``benchmarks/`` by following every import
statement (at any depth of a function, and ``importlib.import_module`` of a
literal name) into the repository's own packages, so the port's modules
that a run loads are parsed too.  Names are compared by their top-level
part, whole: ``pdecontrol_tpu_torch`` is not ``pdecontrol_tpu``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
FORBIDDEN = {"jax", "jaxlib", "flax", "pdecontrol_tpu"}
PROGRAM = "pdecontrol_tpu_torch"
LOCAL = ("benchmarks", PROGRAM)


def imported_names(path: Path):
    """Every module name that ``path`` imports, absolute."""
    tree = ast.parse(path.read_text(), str(path))
    package = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def module_file(name: str):
    path = ROOT.joinpath(*name.split("."))
    for candidate in (path.with_suffix(".py"), path / "__init__.py"):
        if candidate.is_file():
            return candidate
    return None


def closure():
    """The benchmark's files and every repository module they reach."""
    todo = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
    seen = {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        names = set(imported_names(path))
        seen[path] = names
        for name in names:
            if name.split(".")[0] in LOCAL:
                parts = name.split(".")
                for i in range(1, len(parts) + 1):
                    f = module_file(".".join(parts[:i]))
                    if f is not None and f not in seen:
                        todo.append(f)
    return seen


def test_the_port_is_reached():
    files = {p.relative_to(ROOT).as_posix() for p in closure()}
    for f in ("pdecontrol_tpu_torch/mbrl/controller.py", "pdecontrol_tpu_torch/ops/pallas_ks.py",
              "pdecontrol_tpu_torch/train/trainer.py", "benchmarks/reference/mbpo.py"):
        assert f in files


@pytest.mark.parametrize("top", sorted(FORBIDDEN))
def test_nothing_run_imports(top):
    bad = sorted(f"{p.relative_to(ROOT)}: {n}" for p, names in closure().items()
                 for n in names if n.split(".")[0] == top)
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    bad = sorted(f"{p.relative_to(ROOT)}: {n}" for p in (BENCH / "reference").rglob("*.py")
                 for n in imported_names(p)
                 if n.split(".")[0] == PROGRAM or n.startswith(("benchmarks.harness",
                                                                "benchmarks.drivers")))
    assert not bad, bad


def test_the_guard_compares_whole_names():
    names = {n.split(".")[0] for n in ("pdecontrol_tpu_torch.mbrl", "pdecontrol_tpu.mbrl", "jaxtyping")}
    assert names & FORBIDDEN == {"pdecontrol_tpu"}
