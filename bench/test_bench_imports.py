"""What the benchmark imports: never JAX or the JAX package, compared by
whole top-level names (the program's ``repro_torch`` begins with the JAX
package's ``repro``), model families (``bench/blocks/``) included; the
reference, and every reference a family names, imports nothing of the
program."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = spec.BENCH_DIR


def imported_top_levels(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_of_bench_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = imported_top_levels(path)
        assert tops <= {"__future__", "contextlib", "math", "torch",
                        "numpy"}, (path, tops)


BLOCKS = sorted((BENCH / "blocks").glob("*.py"))


def test_every_family_is_scanned():
    assert BLOCKS and set(BLOCKS) <= set(SOURCES)


@pytest.mark.parametrize("path", BLOCKS, ids=lambda p: p.stem)
def test_family_reference_imports_nothing_of_the_program(path):
    fam = spec.load_module(path, "bench_block_")
    ref = spec.reference_path(fam.REFERENCE)
    assert ref.is_file(), ref
    tops = imported_top_levels(ref)
    assert tops <= {"__future__", "contextlib", "math", "torch",
                    "numpy"}, (ref, tops)


def test_run_refuses_forbidden_top_level_names_only():
    import importlib.util
    mod_spec = importlib.util.spec_from_file_location("bench_run",
                                                      BENCH / "run.py")
    run = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(run)
    probes = ("repro_torch_probe", "jaxlib_probe", "repro.probe")
    try:
        for name in probes:
            sys.modules[name] = object()
        found = run.forbidden_modules()
        assert "repro_torch_probe" not in found
        assert "jaxlib_probe" not in found
        assert "repro.probe" in found
    finally:
        for name in probes:
            sys.modules.pop(name, None)


def test_harness_loads_no_jax_in_a_run_process():
    """Import every module a run imports, the program's serving stack
    with it, in a fresh process, and list what is loaded."""
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "import bench.core.cell, bench.core.judge, bench.core.trace\n"
            "import repro_torch.serving.server, "
            "repro_torch.serving.telemetry\n"
            "from bench.core import spec\n"
            "for p in (spec.BENCH_DIR / 'configs').glob('*.json'):\n"
            "    cfg = json.loads(p.read_text())\n"
            "    spec.family(cfg).program_config(cfg['model'], p.stem)\n"
            "bad = sorted({m for m in sys.modules "
            "if m.split('.')[0] in %r})\n"
            "print(bad)\n") % (str(spec.ROOT), str(spec.ROOT / "src"),
                               sorted(FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "granite-short-open", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
