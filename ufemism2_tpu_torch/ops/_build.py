"""Build of the CUDA sources: csrc/<name>.cu is compiled with nvcc at first
use into its own shared library, build/lib<name>.so beside the package,
with a plain C interface that the bindings load with ctypes."""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("stack_spmv", "heat_columns", "bpa", "laddie")   # csrc/<name>.cu
_built = {}          # name -> path of the library built in this process


def build_kernel(name):
    """The path of build/lib<name>.so, compiled from csrc/<name>.cu at
    first use in this process. Safe to call from several threads for
    different names: the nvcc runs then overlap."""
    if name not in _built:
        exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not Path(exe).exists():
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                               "built")
        _BUILD.mkdir(parents=True, exist_ok=True)
        lib = _BUILD / f"lib{name}.so"
        r = subprocess.run([exe, *_NVCC_FLAGS, "-o", str(lib),
                            str(_CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stdout}"
                               f"{r.stderr}")
        _built[name] = lib
    return _built[name]
