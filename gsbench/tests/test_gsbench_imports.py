"""What the benchmark may load: nothing of JAX or the JAX package, by whole
top-level name, anywhere in `gsbench/` or in a run's process; and nothing
of the measured program in the reference."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gsrast_tpu"}
GSBENCH = os.path.join(ROOT, "gsbench")


def _imports(path: str) -> set:
    """Top-level names of every module `path` imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    top = os.path.join(GSBENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & FORBIDDEN for p in _sources()}
    assert not {p: n for p, n in found.items() if n}


def test_the_whole_name_is_compared():
    assert "gsrast_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax_utils".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        assert not {n for n in _imports(p)
                    if n.startswith("gsrast")}, p


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import gsbench.reference.splat, "
                           "gsbench.reference.train")
    assert not {m for m in loaded if m.startswith("gsrast")}


def test_a_run_loads_no_jax():
    """A run's process, driven through set-up, window, trace and check on
    the CPU at a tiny size, holds no forbidden top-level module."""
    code = ("import sys, time; sys.path.insert(0, 'gsbench/tests')\n"
            "from conftest import tiny\n"
            "from gsbench import harness\n"
            "harness.set_caches()\n"
            "out = harness.run(tiny('view-1m-sh3'), 7, 0.2, True, "
            "time.perf_counter(), device='cpu')\n"
            "assert out['correct'], out\n"
            "assert not harness.forbidden_modules()\n")
    loaded = _loaded_after(code)
    assert "gsrast_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
