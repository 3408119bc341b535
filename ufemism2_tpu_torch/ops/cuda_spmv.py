"""The stack-SpMV kernel: build, binding, wrapper and plain version.

Counterpart of the reference's ops/pallas_spmv.py. The function is

    y[o, r, j] = sum_k vals[o, k, r] * x[cols[k, r], j]

for `n_ops` operators sharing one padded-ELL index table `cols`. Tables
are entry-major (`cols` [K, n_rows] int32, `vals` [n_ops, K, n_rows]) so
that neighbouring rows lie at neighbouring addresses; padded entries
point at column 0 with value 0.

The CUDA source csrc/stack_spmv.cu is compiled with nvcc at first use into
a shared library with a plain C interface (under build/ beside the
package) and loaded with ctypes. `stack_spmv` launches it for every CUDA
tensor; only a CPU tensor takes `stack_spmv_plain`, the same arithmetic in
plain tensor code (the CPU path and the kernel's test oracle).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
N_OPS = (1, 5)       # operator counts the kernel is instantiated for

launches = 0         # kernel launches since the caller last set it to 0
_lib = None


def build_kernel():
    """Compile csrc/stack_spmv.cu into build/libstack_spmv.so; returns the
    library's path."""
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / "libstack_spmv.so"
    res = subprocess.run(
        [exe, *_NVCC_FLAGS, "-o", str(so), str(_CSRC / "stack_spmv.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on stack_spmv.cu:\n{res.stdout}")
    return so


def _library():
    """The compiled kernel, built at first use in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernel()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stack_spmv_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.stack_spmv_f32.restype = i
        lib.stack_spmv_f64.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.stack_spmv_f64.restype = i
        _lib = lib
    return _lib


def _round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def stack_spmv_plain(cols, vals, x, round_x_bf16=False):
    """Plain tensor version of the kernel (same optional x rounding)."""
    if round_x_bf16:
        x = _round_bf16(x)
    xg = x[cols.long()]                       # [K, n_rows(, d)]
    if x.ndim == 1:
        return (vals * xg[None]).sum(dim=1)
    return (vals[..., None] * xg[None]).sum(dim=1)


def stack_spmv(cols, vals, x, round_x_bf16=False):
    """y [n_ops, n_rows(, d)] from cols [K, n_rows], vals [n_ops, K, n_rows]
    and x [n_cols(, d)]. `round_x_bf16` (float32 only) rounds x to bfloat16
    and back before the products."""
    global launches
    if cols.ndim != 2 or vals.ndim != 3 or vals.shape[1:] != cols.shape:
        raise ValueError(f"stack_spmv: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} do not match")
    if x.ndim not in (1, 2):
        raise ValueError("stack_spmv: x must be [n_cols] or [n_cols, d]")
    if x.dtype != vals.dtype:
        raise TypeError(f"stack_spmv: x is {x.dtype}, vals {vals.dtype}")
    if round_x_bf16 and x.dtype != torch.float32:
        raise TypeError("stack_spmv: round_x_bf16 needs float32")
    if not (x.device == vals.device == cols.device):
        raise ValueError("stack_spmv: operands on different devices")
    if x.device.type == "cpu":
        return stack_spmv_plain(cols, vals, x, round_x_bf16)

    if x.device.type != "cuda":
        raise ValueError(f"stack_spmv: unsupported device {x.device}")
    if cols.dtype != torch.int32:
        raise TypeError("stack_spmv: cols must be int32")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stack_spmv: unsupported dtype {x.dtype}")
    n_ops, K, n_rows = vals.shape
    if n_ops not in N_OPS:
        raise ValueError(f"stack_spmv: the kernel is built for n_ops in "
                         f"{N_OPS}, not {n_ops}")
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError("stack_spmv: cols and vals must be contiguous")
    x = x.contiguous()
    d = 1 if x.ndim == 1 else x.shape[1]
    y = torch.empty((n_ops, n_rows) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.float32:
            err = lib.stack_spmv_f32(cols.data_ptr(), vals.data_ptr(),
                                     x.data_ptr(), y.data_ptr(), n_ops,
                                     n_rows, K, d, int(bool(round_x_bf16)),
                                     stream)
        else:
            err = lib.stack_spmv_f64(cols.data_ptr(), vals.data_ptr(),
                                     x.data_ptr(), y.data_ptr(), n_ops,
                                     n_rows, K, d, stream)
    if err != 0:
        raise RuntimeError(f"stack_spmv: kernel launch failed, CUDA error "
                           f"{err}")
    launches += 1
    return y
