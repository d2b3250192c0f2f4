"""No module of the benchmark loads JAX or the JAX package, and the plain
references load nothing of the program: top-level module names compared
whole (``repro_torch`` begins with ``repro`` and is not it)."""
import ast
import json
import subprocess
import sys

from bench.harness import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _roots(path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _loaded_after_importing(paths) -> set:
    """Top-level names in ``sys.modules`` of a fresh interpreter that has
    executed each of ``paths``."""
    code = (
        "import sys, json, importlib.util\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for i, p in enumerate({[str(p) for p in paths]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'm{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_import_no_jax_nor_jax_package():
    for path in MODULES:
        assert not _roots(path) & FORBIDDEN, path


def test_every_module_imports_without_jax():
    loaded = _loaded_after_importing(
        [p for p in MODULES if p.name not in ("run.py", "calibrate.py")])
    assert not loaded & FORBIDDEN
    assert "bench" in loaded and "torch" in loaded


def test_a_cell_run_loads_no_jax():
    """The harness with the program built and driven (a tiny run on the
    CPU) leaves no JAX module behind."""
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, "
        f"{str(BENCH / 'tests')!r}]\n"
        "import torch, tiny\n"
        "from bench import harness\n"
        "harness.run_cell(tiny.bench_json(), 'resnet18.search', 5, 0.5,"
        " False, torch.device('cpu'), time.perf_counter(),"
        " conf=tiny.conf('resnet18'), traffic=tiny.traffic('search'))\n"
        "print(json.dumps(harness.loaded_forbidden()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_references_load_nothing_of_the_program():
    refs = sorted((BENCH / "reference").glob("*.py"))
    assert {p.name for p in refs} >= {"fault.py", "cost.py", "resnet18.py",
                                      "olmo-1b.py"}
    for path in refs:
        assert "repro_torch" not in _roots(path), path
    loaded = _loaded_after_importing(refs)
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN
