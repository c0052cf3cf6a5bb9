"""PyTorch port isolation: `foodrec_tpu_torch` and chip_smoke.py import
neither JAX nor the JAX package, so the port runs where JAX is absent."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import foodrec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    foodrec_tpu_torch.__path__, "foodrec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "foodrec_tpu" or m.startswith("foodrec_tpu."))
entry_points = {"foodrec_tpu_torch.entry", "foodrec_tpu_torch.multichip",
                "foodrec_tpu_torch.runner"}
print(len(names), int(entry_points <= set(names)), bad)
"""

# the offline pipeline's modules: numpy tables, a torch k-means; pandas
# only inside the ingr_map.pkl read, the extractors' libraries only when
# called without injected models
_PIPELINE = ("foodrec_tpu_torch.data.preprocess",
             "foodrec_tpu_torch.data.preprocess_cli",
             "foodrec_tpu_torch.data.kmeans",
             "foodrec_tpu_torch.data.scrapers")
_IMPORT_PIPELINE = """
import importlib, sys
for name in %r:
    importlib.import_module(name)
heavy = ("pandas", "sklearn", "transformers", "torchvision", "jax", "jaxlib",
         "foodrec_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in heavy))
""" % (_PIPELINE,)


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=2)
    assert int(out[0]) >= 15, out  # every module of the slice was imported
    assert out[1] == "1", out  # the entry points among them
    assert out[2].strip() == "[]", out


def test_pipeline_modules_load_no_pandas_sklearn_or_model_libraries():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PIPELINE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]", out


def test_no_source_imports_jax_or_the_jax_package():
    """Import statements and dynamic imports only: the sources do name the
    JAX package's files in prose, e.g. the TPU kernel a CUDA kernel replaces."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|foodrec_tpu)\b"
        r"|import jax\b"
        r"|(import_module|__import__)\(\s*[\"'](jax|jaxlib|foodrec_tpu)\b",
        re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "foodrec_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 15
    for path in files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not pattern.search(text), path
