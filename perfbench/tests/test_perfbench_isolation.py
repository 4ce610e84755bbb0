"""No module under perfbench/ imports JAX, flax or the JAX package, and
the yardstick (``perfbench/lib/``) imports nothing of the program;
names are compared by their whole top-level part, since the program's
own name begins with the JAX package's."""
import ast
import glob
import os

from perfbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "vcf2prot_tpu"}
PROGRAM = "vcf2prot_tpu_torch"


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources(*parts):
    return sorted(glob.glob(os.path.join(run.HERE, *parts, "**", "*.py"),
                            recursive=True))


def test_top_level_names_are_compared_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "vcf2prot_tpu.downstream".split(".")[0] in FORBIDDEN


def test_nothing_under_perfbench_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_yardstick_imports_nothing_of_the_program():
    files = _sources("lib")
    assert any(p.endswith("reference.py") for p in files)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] != PROGRAM, (path, name)


def test_the_harness_refuses_a_loaded_jax(monkeypatch):
    import sys
    import types

    assert run.forbidden_modules() == set()
    monkeypatch.setitem(sys.modules, "vcf2prot_tpu.x",
                        types.ModuleType("vcf2prot_tpu.x"))
    assert run.forbidden_modules() == {"vcf2prot_tpu"}
