"""Build of the CUDA sources: csrc/<name>.cu is compiled with nvcc at first
use into its own shared library, build/lib<name>.so beside the package,
with a plain C interface that the bindings load with ctypes. A library
that another process built from the same source with the same flags (its
stamp, build/lib<name>.so.sha256, says so) is used as it is."""

from __future__ import annotations

import hashlib
import os
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
        src = _CSRC / f"{name}.cu"
        lib = _BUILD / f"lib{name}.so"
        stamp = Path(f"{lib}.sha256")
        digest = hashlib.sha256(src.read_bytes() + " ".join(
            _NVCC_FLAGS).encode()).hexdigest()
        if not (lib.exists() and stamp.exists()
                and stamp.read_text() == digest):
            exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not Path(exe).exists():
                raise RuntimeError("nvcc not found: the CUDA kernels cannot "
                                   "be built")
            _BUILD.mkdir(parents=True, exist_ok=True)
            # built under a name of this process's own, then renamed into
            # place, so that a process loading the library never sees half
            # of it
            tmp = _BUILD / f"lib{name}.{os.getpid()}.so"
            r = subprocess.run([exe, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stdout}"
                                   f"{r.stderr}")
            os.replace(tmp, lib)
            stamp.write_text(digest)
        _built[name] = lib
    return _built[name]
