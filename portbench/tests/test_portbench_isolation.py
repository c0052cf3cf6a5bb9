"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (foodrec_tpu_torch is not foodrec_tpu), and
the plain references import nothing of the program."""

import ast
import os
import subprocess
import sys
import types

from portbench import harness

JAX = {"jax", "jaxlib", "flax", "foodrec_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    top = os.path.join(harness.PKG, sub)
    for d, _, files in os.walk(top):
        if ".cache" in d or "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.partition(".")[0] for m in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)


def test_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {m.partition(".")[0] for m in _imports(path)}
        assert "foodrec_tpu_torch" not in tops, path
    code = ("import sys; from portbench import harness; "
            "[harness.load_module(f) for f in sys.argv[1:]]; "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    files = list(_sources("reference"))
    out = subprocess.run([sys.executable, "-c", code, *files],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "foodrec_tpu_torch" not in out and "'jax'" not in out


def test_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "foodrec_tpu_torch.fake",
                        types.ModuleType("foodrec_tpu_torch.fake"))
    assert "foodrec_tpu" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "foodrec_tpu.fake",
                        types.ModuleType("foodrec_tpu.fake"))
    assert "foodrec_tpu" in harness.foreign_modules()


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "lightgcn-foodcom-topk", "--seed", "3", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
