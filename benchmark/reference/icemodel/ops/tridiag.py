"""Batched tridiagonal (Thomas) solver and the zeta-grid operator rows.

Counterpart of the reference's ops/tridiag.py (itself the batched
replacement of the per-vertex LAPACK solves of
src/UPSY/basic/math_utilities/tridiagonal_solver.f90). `thomas_batched`
is plain tensor code: a Python loop over the (small) system axis with the
batch on the other axes, the same recurrence and the same order of
operations as the reference's two scans. It is the CPU path of the heat
solve and the oracle of the `heat_columns` kernel (ops/cuda_heat.py),
which runs the same recurrence for one column per thread.
"""

from __future__ import annotations

import numpy as np
import torch


def thomas_batched(ldiag, diag, udiag, b):
    """Solve tridiagonal systems batched over leading axes.

    ldiag: [..., n-1], diag: [..., n], udiag: [..., n-1], b: [..., n]
    Returns x: [..., n] in the type of the diagonal's recurrence (b of a
    narrower type is widened, as the reference's scan carry does). No
    pivoting (the heat-equation systems are diagonally dominant).
    """
    n = diag.shape[-1]
    zeros = torch.zeros_like(diag[..., 0])
    # forward sweep: c'_k = u_k / (d_k - l_{k-1} c'_{k-1})
    #                d'_k = (b_k - l_{k-1} d'_{k-1}) / (d_k - l_{k-1} c'_{k-1})
    cp_prev, dp_prev = zeros, zeros
    cps, dps = [], []
    for k in range(n):
        lk = zeros if k == 0 else ldiag[..., k - 1]
        uk = zeros if k == n - 1 else udiag[..., k]
        denom = diag[..., k] - lk * cp_prev
        denom = torch.where(torch.abs(denom) < 1e-300, 1e-300, denom)
        cp_prev = uk / denom
        dp_prev = (b[..., k] - lk * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    # back substitution: x_k = d'_k - c'_k x_{k+1}
    x_next = zeros
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.stack(xs, dim=-1)


def zeta_tridiag_operators(zeta):
    """Tridiagonal d/dzeta and d2/dzeta2 coefficients on a nonuniform grid.

    Returns a dict of (ldiag [nz-1], diag [nz], udiag [nz-1]) float64
    numpy arrays for both operators (interior rows only; boundary rows
    zero - the boundary-condition rows overwrite them). Reference:
    mesh_zeta.f90 calc_zeta_operators_tridiagonal. The arithmetic runs in
    zeta's own type (float32 zeta gives float32-rounded coefficients
    stored as float64, as in the reference), whatever numpy's scalar
    promotion rules.
    """
    if isinstance(zeta, torch.Tensor):
        zeta = zeta.detach().cpu().numpy()
    zeta = np.asarray(zeta)
    two = zeta.dtype.type(2.0)
    nz = len(zeta)
    l1 = np.zeros(nz - 1)
    d1 = np.zeros(nz)
    u1 = np.zeros(nz - 1)
    l2 = np.zeros(nz - 1)
    d2 = np.zeros(nz)
    u2 = np.zeros(nz - 1)
    for k in range(1, nz - 1):
        dm = zeta[k] - zeta[k - 1]
        dp = zeta[k + 1] - zeta[k]
        l1[k - 1] = -dp / (dm * (dm + dp))
        d1[k] = (dp - dm) / (dm * dp)
        u1[k] = dm / (dp * (dm + dp))
        l2[k - 1] = two / (dm * (dm + dp))
        d2[k] = -two / (dm * dp)
        u2[k] = two / (dp * (dm + dp))
    return {"ddzeta": (l1, d1, u1), "d2dzeta2": (l2, d2, u2)}
