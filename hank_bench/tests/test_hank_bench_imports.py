"""Nothing the harness runs imports JAX or the JAX package, the reference
imports nothing of the program, and no file of the benchmark reads the
JAX package's old benchmark files. Names are compared by their whole
top-level part: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from hank_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "hank_tpu"}
OLD_FILES = ("bench.py", "BENCH_", "BASELINE.", "scripts/", "MULTICHIP_")


def _sources(*parts):
    return sorted(glob.glob(os.path.join(harness.HERE, *parts, "**", "*.py"), recursive=True))


def _imports(path):
    """Top-level names of every module the file imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "hank_bench", "math", "numpy", "torch"}, path


def test_no_file_reads_the_old_benchmark():
    for path in _sources():
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and path != __file__:
                assert not any(o in node.value for o in OLD_FILES), (path, node.value)


def test_the_harness_loads_no_jax_in_its_process():
    """Import everything a run imports, the program included, and every
    metric reader; then look at sys.modules."""
    code = (
        "import sys, json, glob, os\n"
        "from hank_bench import harness, program, check, tracing, traffic\n"
        "from hank_bench.reference import krusell_smith, hank_two_asset\n"
        "import hank_tpu_torch.solvers.newton, hank_tpu_torch.parallel.ensemble\n"
        "import hank_tpu_torch.solvers.steady_state, hank_tpu_torch.solvers.ss_jacobian\n"
        "bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
