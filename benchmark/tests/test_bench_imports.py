"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's); the yardstick (reference, generator, work, tracing) imports
nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "damar_tpu"}
YARDSTICK = ("reference.py", "traffic.py", "work.py", "tracing.py")


def top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


def sources():
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    mods = top_level_imports(os.path.join(BENCH, name))
    assert "damar_tpu_torch" not in mods
    assert mods <= {"__future__", "numpy", "torch", "benchmark",
                    "contextlib", "functools", "importlib", "sys",
                    "dataclasses"}, mods


def test_a_run_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.control, "
            "benchmark.entries.sweep, benchmark.entries.pair, "
            "benchmark.faults; import damar_tpu_torch.pipeline.planner, "
            "damar_tpu_torch.pipeline.overlap; "
            "print(benchmark.run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_without_the_program_a_run_exits_nonzero(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "ecoli-k12-clr30x.sweep", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
