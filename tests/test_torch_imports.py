"""The PyTorch port stands alone: no file of `ufemism2_tpu_torch/`, nor
`chip_smoke.py`, imports jax, chex or anything of the JAX package.

An AST walk, not a look at `sys.modules`: the test environment preloads
jax into every process."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "chex", "ufemism2_tpu", "jaxlib", "flax", "optax")
FILES = sorted((ROOT / "ufemism2_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_has_files():
    assert len(FILES) > 30
    for name in ("stack_spmv.cu", "heat_columns.cu"):
        assert (ROOT / "ufemism2_tpu_torch" / "csrc" / name).exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_every_module():
    """Every module of the port imports on a machine without CUDA, nvcc or
    triton (kernels are built only inside the call that launches them)."""
    import importlib
    for p in FILES[:-1]:
        rel = p.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)
