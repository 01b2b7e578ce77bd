"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracing_tpu"}

# a fresh process: the harness, the reference and the program, through a
# tiny run of a cell on the CPU; then every loaded module's top-level name
PROBE = r'''
import sys, time
sys.path.insert(0, sys.argv[1])
from benchmark.tests.conftest import tiny_cell
from benchmark.harness import main as M
import benchmark.reference.integrator, benchmark.reference.scene
cell = tiny_cell("cornell_box.preview4", spp=1, pixels=2)
out = M.run_cell(cell, 11, 0.1, False, "cpu", time.perf_counter())
assert out["correct"], out
print(sorted({m.split(".")[0] for m in list(sys.modules)}))
print(M.forbidden_modules())
'''


def test_no_jax_in_the_process():
    out = subprocess.run([sys.executable, "-c", PROBE, str(spec.ROOT)],
                         capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = out.stdout.strip().splitlines()[-2:]
    tops = set(eval(tops))
    assert "pathtracing_tpu_torch" in tops  # the program ran ...
    assert not tops & FORBIDDEN, tops & FORBIDDEN  # ... and loaded no JAX
    assert eval(bad) == []


def test_forbidden_names_compare_whole():
    from benchmark.harness import main as M

    saved = dict(sys.modules)
    try:
        sys.modules["pathtracing_tpu_torch_x"] = sys
        sys.modules["jaxfoo"] = sys
        assert M.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert M.forbidden_modules() == ["jax"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((spec.BENCH_DIR / "reference").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        tops = set(_imports(f))
        assert not tops & (FORBIDDEN | {"pathtracing_tpu_torch", "benchmark"}), (f, tops)


# the system under test: system.py and the modules it finds by name
SYSTEM = ("scenes", "routes", "tables")


def test_only_the_system_module_imports_the_program():
    for f in sorted(spec.BENCH_DIR.rglob("*.py")):
        if "tests" in f.parts or f.name == "system.py" or f.parent.name in SYSTEM:
            continue
        assert "pathtracing_tpu_torch" not in set(_imports(f)), f
        assert not set(_imports(f)) & FORBIDDEN, f
    for f in sorted(spec.BENCH_DIR.rglob("*.py")):
        assert not set(_imports(f)) & FORBIDDEN, f
