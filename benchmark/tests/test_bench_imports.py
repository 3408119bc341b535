"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference loads nothing of the port."""

import subprocess
import sys

from benchmark.harness import forbidden_modules
from benchmark.tests.conftest import ROOT

PROBE = """
import sys, pkgutil, importlib
sys.path.insert(0, sys.argv[1])
for m in sys.argv[2].split(','):
    importlib.import_module(m)
if sys.argv[3] == 'all':
    import benchmark.metrics as ms
    for i in pkgutil.iter_modules(ms.__path__):
        importlib.import_module('benchmark.metrics.' + i.name)
print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
"""


def loaded(modules, metrics=False):
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT), ",".join(modules),
         "all" if metrics else "-"], capture_output=True, text=True,
        check=True, cwd=ROOT).stdout
    return set(out.split())


def test_the_reference_loads_nothing_of_the_port():
    mods = loaded(["benchmark.reference.compare", "benchmark.reference.model",
                   "benchmark.workcount"])
    assert not mods & {"jax", "jaxlib", "flax", "ufemism2_tpu",
                       "ufemism2_tpu_torch"}, mods


def test_the_harness_loads_no_jax():
    mods = loaded(["benchmark.harness", "benchmark.readings",
                   "ufemism2_tpu_torch.main.region",
                   "ufemism2_tpu_torch.mesh.operators"], metrics=True)
    assert "ufemism2_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ufemism2_tpu"}, mods


def test_names_are_compared_whole():
    assert forbidden_modules(["ufemism2_tpu_torch.ops", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["ufemism2_tpu.core.ice", "jax.numpy",
                              "flax"]) == ["flax", "jax", "ufemism2_tpu"]
