"""The PyTorch port stands alone: no file of `ufemism2_tpu_torch/`, nor
`chip_smoke.py`, imports jax, chex or anything of the JAX package, nor
matplotlib or contourpy, which the card's machine lacks (the port tests
points in polygons itself, mesh/refinement.py points_in_polygon); and
h5py, which the card's machine lacks, is imported only by the reader of
NetCDF4 (HDF5) files, `io/ncio.py NCFile._read_hdf5`, when it opens one.
The one exception to the matplotlib rule: the post-processing tools that
draw (tools/figure.py and the rest of PLOT_TOOLS) import it inside the
functions that draw or contour, as the JAX package's tools do; those
modules import without it.

An AST walk, not a look at `sys.modules`: the test environment preloads
jax into every process."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "chex", "ufemism2_tpu", "jaxlib", "flax", "optax",
             "matplotlib", "contourpy")
FILES = sorted((ROOT / "ufemism2_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


PLOT_TOOLS = tuple(f"ufemism2_tpu_torch/tools/{n}.py" for n in (
    "figure", "figure_3d", "plot_figures", "movie", "analyse_resources"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


def _lazy_import_lines(path):
    """Lines of the imports made inside a function of `path`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.lineno for f in ast.walk(tree)
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            for n in ast.walk(f)
            if isinstance(n, (ast.Import, ast.ImportFrom))}


def test_port_has_files():
    assert len(FILES) > 30
    for name in ("stack_spmv.cu", "heat_columns.cu", "bpa.cu", "laddie.cu"):
        assert (ROOT / "ufemism2_tpu_torch" / "csrc" / name).exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_import(path):
    lazy = _lazy_import_lines(path) \
        if str(path.relative_to(ROOT)) in PLOT_TOOLS else set()
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN
           and not (name == "matplotlib" and line in lazy)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", PLOT_TOOLS)
def test_plot_tools_import_without_matplotlib(rel):
    """The plotting tools import, and Run/the contour-free functions
    work, where matplotlib is absent (the card's machine)."""
    import subprocess
    import sys
    name = rel[:-3].replace("/", ".")
    code = ("import sys; sys.modules['matplotlib'] = None; "
            f"import {name}")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr


def _h5py_imports(path):
    """(enclosing function, line) of every import of h5py in `path`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import) and any(
                    a.name.split(".")[0] == "h5py" for a in child.names):
                out.append((func, child.lineno))
            elif isinstance(child, ast.ImportFrom) and child.module \
                    and child.module.split(".")[0] == "h5py":
                out.append((func, child.lineno))
            walk(child, f)
    walk(tree, None)
    return out


HDF5_READER = ("ufemism2_tpu_torch/io/ncio.py", "_read_hdf5")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_h5py_only_in_the_hdf5_reader(path):
    rel = str(path.relative_to(ROOT))
    found = _h5py_imports(path)
    if rel == HDF5_READER[0]:
        assert found and all(f == HDF5_READER[1] for f, _ in found), found
    else:
        assert not found, f"{rel} imports h5py at {found}"


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
