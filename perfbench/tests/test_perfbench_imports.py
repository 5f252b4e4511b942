"""What the benchmark may import: nothing it runs loads `jax`, `jaxlib`,
`flax` or the JAX package `splat_tpu` (top-level names compared whole, so
`splat_tpu_torch` passes); the reference loads nothing of `splat_tpu_torch`;
and nothing reads the JAX package's benchmark files."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "splat_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (relative imports
    are the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _files(where: Path):
    return sorted(p for p in where.rglob("*.py") if "tests" not in p.parts[len(ROOT.parts):])


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _files(PERFBENCH):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _files(PERFBENCH / "reference"):
        names = _imports(path)
        assert not (names & (FORBIDDEN | {"splat_tpu_torch", "perfbench"})), path
        assert names <= {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy",
                         "torch"}, (path, names)


def test_nothing_reads_the_jax_packages_benchmark_files():
    for path in _files(PERFBENCH):
        text = path.read_text()
        for word in ("benchmarks/", "bench.py", "BENCH_", "bench_multichip", "MULTICHIP_",
                     "BASELINE"):
            assert word not in text, (path, word)


def _run(code: str) -> dict:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax():
    """Every module a run loads, in the process that prints the result: a
    traced run of the benchmark's cell at a tiny size on the CPU, and the
    view traffic's program imports."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'perfbench/tests')\n"
        "from tiny import run_tiny\n"
        "run_tiny('phone_mbrs.train', trace=True)\n"
        "import perfbench.traffic.view, splat_tpu_torch.cli.render_video\n"
        "from perfbench import run\n"
        "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
        "    run.load_reader(m['name'])\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(),\n"
        "                  'program': 'splat_tpu_torch' in sys.modules}))\n")
    out = _run(code)
    assert out == {"forbidden": [], "program": True}


def test_the_forbidden_check_compares_whole_names():
    code = (
        "import json, sys, types\n"
        "from perfbench import run\n"
        "sys.modules['splat_tpu_torch_x'] = types.ModuleType('splat_tpu_torch_x')\n"
        "a = run.forbidden_modules()\n"
        "sys.modules['splat_tpu.ops'] = types.ModuleType('splat_tpu.ops')\n"
        "print(json.dumps([a, run.forbidden_modules()]))\n")
    assert _run(code) == [[], ["splat_tpu"]]


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import perfbench.reference.model, perfbench.reference.train\n"
        "import perfbench.reference.compositor, perfbench.reference.ssim\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('splat_tpu_torch', 'splat_tpu', 'jax'))))\n")
    assert _run(code) == []
