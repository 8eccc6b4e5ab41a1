"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: an AST scan of ``benchmark/``
comparing each imported module's top-level name whole."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "niceslam_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_bench_no_module_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_bench_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(f))
        assert "niceslam_tpu_torch" not in names and not names & FORBIDDEN, f


def test_bench_the_scan_compares_whole_names():
    src = "import niceslam_tpu_torch.slam\nfrom jax.numpy import x\nimport jaxlib_like\n"
    tmp = BENCH / "tests" / "_scan_probe.py"
    try:
        tmp.write_text(src)
        assert set(_imports(tmp)) == {"niceslam_tpu_torch", "jax", "jaxlib_like"}
    finally:
        tmp.unlink()


def test_bench_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    from benchmark.harness import drive

    monkeypatch.setitem(sys.modules, "niceslam_tpu_torch_probe", types.ModuleType("x"))
    assert drive.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "niceslam_tpu.ops", types.ModuleType("x"))
    assert drive.forbidden_modules() == ["niceslam_tpu"]
