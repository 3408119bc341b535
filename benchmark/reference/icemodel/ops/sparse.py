"""Device-resident sparse mesh operators in padded ELL form.

Unstructured-mesh operators have a small bounded number of entries per
row (~vertex degree), so each is stored as padded index/value tables and
applied by the stack-SpMV kernel (ops/cuda_spmv.py): `EllStack` holds
`n_ops` operators over one shared index table, `EllMatrix` is the
`n_ops = 1` case. Tables are entry-major (`cols` [K, n_rows], `vals`
[n_ops, K, n_rows]); padded entries point at column 0 with value 0.

Precision policy (the reference's, ops/sparse.py there): in float32 a
plain apply (`M @ x`, `stack.apply(x)`) rounds the x operand to bfloat16
- the Krylov and physics matvecs - while `exact_matvec` applies a geometry
field at full accuracy. Coefficients are never rounded. In float64
nothing is rounded.

Not ported, because they only serve the TPU's memory system and matrix
unit: `TiledEllMatrix`, `TiledEllStack`, `GroupedTiledEllStack` (128-wide
tile slabs and row-block buckets), `_split_f32` (the bf16 (hi, lo)
coefficient pair) and `_contract` (the einsum modes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from . import resolve_device
from .cuda_spmv import StackOperator


def exact_mv(M, x):
    """Apply a mesh operator to a GEOMETRY FIELD at full accuracy
    (bf16-rounding a 3000 m surface elevation is ~1e-3 absolute slope
    noise, which the time-step controller reads as truncation error)."""
    return M.exact_matvec(x)


@dataclass
class EllStack:
    """`n_ops` sparse operators sharing one sparsity pattern."""

    cols: torch.Tensor      # [K, n_rows] int32 (0 where padded)
    vals: torch.Tensor      # [n_ops, K, n_rows] (0 where padded)
    n_cols: int

    def __post_init__(self):
        # the checks that depend only on the tables, once; `apply` then
        # checks its x and launches
        self.op = StackOperator(self.cols, self.vals)

    @property
    def n_ops(self):
        return self.vals.shape[0]

    @property
    def n_rows(self):
        return self.cols.shape[1]

    @property
    def K(self):
        return self.cols.shape[0]

    def apply(self, x, exact=False):
        """x [n_cols(, d)] -> [n_ops, n_rows(, d)]."""
        if x.shape[0] != self.n_cols:
            raise ValueError(f"operator has {self.n_cols} columns, x has "
                             f"{x.shape[0]} rows")
        rnd = (not exact) and self.vals.dtype == torch.float32
        return self.op(x, rnd)

    def to(self, device):
        return type(self)(self.cols.to(device), self.vals.to(device),
                          self.n_cols)


@dataclass
class EllMatrix(EllStack):
    """One padded-ELL sparse matrix (`vals` is [1, K, n_rows])."""

    def __matmul__(self, x):
        return self.apply(x)[0]

    def exact_matvec(self, x):
        """Full-accuracy apply for geometry fields."""
        return self.apply(x, exact=True)[0]


def _ell_tables(pattern: sp.csr_matrix, mats, K=None):
    """Entry-major ELL tables of `mats` over the row pattern of `pattern`
    (which must contain every matrix's entries)."""
    pattern.sort_indices()
    n_rows, n_cols = pattern.shape
    counts = np.diff(pattern.indptr)
    Kmax = int(counts.max()) if len(counts) and pattern.nnz else 1
    K = K or Kmax
    assert K >= Kmax, "requested ELL width smaller than max row nnz"
    row_of = np.repeat(np.arange(n_rows), counts)
    pos = np.arange(pattern.nnz) - np.repeat(pattern.indptr[:-1], counts)
    cols = np.zeros((K, n_rows), dtype=np.int32)
    cols[pos, row_of] = pattern.indices
    key = row_of.astype(np.int64) * n_cols + pattern.indices
    vals = np.zeros((len(mats), K, n_rows), dtype=np.float64)
    for oi, m in enumerate(mats):
        mc = m.tocoo()
        mk = mc.row.astype(np.int64) * n_cols + mc.col.astype(np.int64)
        at = np.searchsorted(key, mk)        # key is sorted (CSR order)
        np.add.at(vals[oi], (pos[at], row_of[at]), mc.data)
    return cols, vals, n_cols


def ell_from_csr(A: sp.spmatrix, dtype=torch.float64, device="cuda",
                 K: int | None = None) -> EllMatrix:
    """Convert a scipy sparse matrix to a device EllMatrix."""
    device = resolve_device(device)
    A = A.tocsr()
    A.sum_duplicates()
    cols, vals, n_cols = _ell_tables(A, [A], K)
    return EllMatrix(torch.as_tensor(cols, device=device),
                     torch.as_tensor(vals, dtype=dtype, device=device),
                     n_cols)


def ell_stack_from_csr(mats, dtype=torch.float64, device="cuda") -> EllStack:
    """Build a shared-pattern stack from scipy matrices of one shape; the
    index table is the union of their patterns."""
    device = resolve_device(device)
    mats = [m.tocsr() for m in mats]
    U = abs(mats[0])
    for m in mats[1:]:
        U = U + abs(m)
    U = U.tocsr()
    U.sum_duplicates()
    cols, vals, n_cols = _ell_tables(U, mats)
    return EllStack(torch.as_tensor(cols, device=device),
                    torch.as_tensor(vals, dtype=dtype, device=device),
                    n_cols)
