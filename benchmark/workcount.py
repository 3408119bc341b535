"""The yardstick of the roofline metrics: the published peaks of the card
and the work that one operator apply or one column solve needs, counted
from shapes and masks.

Frozen copies of the counts that the port's smoke script uses
(chip_smoke.py: the DIVA bytes of `diva_check`, `bpa_bound`, `heat_bound`),
as corrected in the reviews of the kernels' redesigns. Each input byte is
counted read once and each output byte written once, whatever a kernel
reads again; where the work depends on the data, it is what these inputs
need.
"""

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the dense rates outside
# the tensor cores (the operators and the column solves use none)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


def bound_s(nbytes, flops, dtype):
    """The least time the card can take for the work: the larger of its
    bytes at the peak bandwidth and its operations at the peak rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def diva_work(A):
    """(bytes, flops, dtype) of one apply of the DIVA operator A (the port's
    DivaOperator): the shared index table and the five coefficient tables
    of the stored pattern, u, v, the four per-triangle fields, the row code
    and the boundary rows' neighbour table, the normals of the front rows
    read once; Au, Av written once."""
    S, rows, n = A.stack, A.rows, A.n
    size = S.vals.element_size()
    nnz = int((S.vals != 0).any(dim=0).sum())
    n_bdry = int((~rows.free).sum())
    n_front = int(A.front[0].sum()) if A.front is not None else 0
    nbytes = (nnz * 4 + 5 * nnz * size + 6 * n * size + n
              + n_bdry * 12 + 2 * n_front * size + 2 * n * size)
    flops = 2 * 5 * nnz * 2 + 30 * n
    return nbytes, flops, S.vals.dtype


def bpa_work(A):
    """(bytes, flops, dtype) of one apply of the BPA operator A (the port's
    BpaOperator): the index table and the two coefficient tables, u and v,
    the coefficient fields, the row codes and the neighbour tables of the
    lateral rows read once, Au and Av written once; some 20 K + 80
    operations a row and layer."""
    n, nz, K = A.n, A.nz, A.stack.K
    size = A.stack.vals.element_size()
    n_bdry = int((~A.rows.free).sum())
    nbytes = (K * n * 4 + 2 * K * n * size + 2 * n * nz * size
              + 6 * n * nz * size + 11 * n * size + n + n_bdry * 12
              + 2 * n * nz * size)
    return nbytes, n * nz * (20 * K + 80), A.stack.vals.dtype


def heat_work(args):
    """(bytes, flops, dtype) of one heat_columns call on `args` (its
    operands, as the thermodynamics step passes them).

    Every column reads its thin flag and T_surf and writes its row; a thin
    column reads its Ti_pmp row besides, nothing else. A solved column
    reads Ti, c_dd, c_d2, rhs and Ti_pmp, the masks that decide its
    boundary condition and only the basal values that condition needs;
    only an unstable column reads its T_robin row. Which columns are
    unstable: the plain column solve with a NaN Robin profile is NaN there
    and only there. Operations: the least the kernel's algorithm does on
    this data (a stable column one level of one substep, an unstable one
    five levels)."""
    from .reference.icemodel.ops.cuda_heat import GL_BC, heat_columns_plain
    nV, nz = args[0].shape
    size = args[0].element_size()
    grounded, floating, gl, thin = (args[j].cpu().numpy()
                                    for j in (8, 9, 10, 12))
    robin_nan = torch.full_like(args[13], float("nan"))
    probe, _ = heat_columns_plain(*args[:13], robin_nan, *args[14:])
    unstable = (torch.isnan(probe).any(1) & ~args[12]).cpu().numpy()
    gl_bc = args[16] if len(args) > 16 else "grounded"
    sel = np.where(gl, GL_BC.get(gl_bc, 2),
                   np.where(grounded, 0, np.where(floating, 1, 0)))
    solved = ~thin
    n_masks = nV + solved.sum() + (solved & ~gl).sum() \
        + (solved & ~gl & ~grounded).sum()
    nbytes = int(nV * (size + nz * 8)
                 + thin.sum() * nz * size
                 + solved.sum() * 5 * nz * size
                 + (solved & (sel != 1)).sum() * 8
                 + (solved & (sel != 0)).sum() * size
                 + (solved & (sel == 2)).sum() * size
                 + n_masks + unstable.sum() * nz * 8
                 + 6 * nz * 8 + 4)
    mixed = solved & (sel == 2)
    levels = np.where(unstable, 5, 1)
    per_col = 8 * nz + (5 + np.where(mixed, 12, 7)) * nz * levels
    # the column solves run in float64 whatever the fields' type
    return nbytes, int(per_col[solved].sum()), torch.float64
