"""Least-squares finite-difference 'shape functions' (Syrakos et al. 2017).

Batched numpy re-derivation of src/UPSY/basic/math_utilities/
shape_functions.f90: for a target point and a set of neighbour points,
weighted-least-squares Taylor fits give the coefficients (shape functions)
that map neighbour values to derivatives at the target.

All routines operate on padded arrays:
  dx, dy:  [N, K] offsets of neighbours (masked by `mask`)
  mask:    [N, K] bool, True where a neighbour exists
and return coefficient arrays of the same shape plus (for 'reg' variants)
the coefficient of the centre point itself.

Distances are normalised per row before solving (scale-invariant; improves
conditioning over the reference's raw-metres formulation without changing
the exact-arithmetic result).
"""

from __future__ import annotations

import numpy as np

Q_WEIGHT = 1.5  # distance weighting exponent (Syrakos et al. 2017)


def _weights(dx, dy, mask):
    d = np.sqrt(dx ** 2 + dy ** 2)
    d = np.where(mask & (d > 0), d, 1.0)
    w = 1.0 / d ** Q_WEIGHT
    return np.where(mask, w, 0.0)


def _solve_batched(ATA, rhs_basis, w2, terms):
    """Solve normal equations and assemble shape functions.

    ATA: [N, P, P]; terms: list of P arrays [N, K] (basis functions at
    neighbours); w2: [N, K] squared weights. Returns list of P coefficient
    arrays [N, K]: row p gives the shape function for derivative p.
    """
    N, P, _ = ATA.shape
    Minv = np.linalg.solve(ATA, np.broadcast_to(np.eye(P), (N, P, P)).copy())
    # coeff_p[n,k] = w2 * sum_q Minv[p,q] * basis_q[n,k]
    basis = np.stack(terms, axis=1)             # [N, P, K]
    coeffs = np.einsum("npq,nqk->npk", Minv, basis) * w2[:, None, :]
    return [coeffs[:, p, :] for p in range(P)]


def _det_ok(ATA):
    """Rows where the normal matrix is comfortably non-singular."""
    det = np.linalg.det(ATA)
    P = ATA.shape[1]
    scale = np.maximum(np.abs(ATA).max(axis=(1, 2)), 1e-300) ** P
    return np.abs(det) > 1e-10 * scale


def shape_functions_2D_reg_1st_order(dx, dy, mask):
    """d/dx, d/dy to 1st order where f IS known at the target.

    Returns (Nfx_i, Nfy_i, Nfx_c, Nfy_c, ok): centre coefficients [N],
    neighbour coefficients [N,K], and per-row success flags.
    """
    s = _norm_scale(dx, dy, mask)
    dxn, dyn = dx / s, dy / s
    w = _weights(dxn, dyn, mask)
    w2 = w ** 2
    m = mask.astype(np.float64)
    bx, by = dxn * m, dyn * m
    ATA = np.empty(dx.shape[:1] + (2, 2))
    ATA[:, 0, 0] = (w2 * bx * bx).sum(-1)
    ATA[:, 0, 1] = (w2 * bx * by).sum(-1)
    ATA[:, 1, 0] = ATA[:, 0, 1]
    ATA[:, 1, 1] = (w2 * by * by).sum(-1)
    ok = _det_ok(ATA)
    ATA[~ok] = np.eye(2)
    Nfx_c, Nfy_c = _solve_batched(ATA, None, w2, [bx, by])
    Nfx_c /= s
    Nfy_c /= s
    Nfx_c *= m
    Nfy_c *= m
    return -Nfx_c.sum(-1), -Nfy_c.sum(-1), Nfx_c, Nfy_c, ok


def shape_functions_2D_reg_2nd_order(dx, dy, mask):
    """d/dx, d/dy, d2/dx2, d2/dxdy, d2/dy2 where f IS known at the target.

    Returns (centre coeffs [N,5], neighbour coeffs [N,5,K], ok).
    """
    s = _norm_scale(dx, dy, mask)
    dxn, dyn = dx / s, dy / s
    w = _weights(dxn, dyn, mask)
    w2 = w ** 2
    m = mask.astype(np.float64)
    terms = [dxn * m, dyn * m, 0.5 * dxn ** 2 * m, dxn * dyn * m,
             0.5 * dyn ** 2 * m]
    N = dx.shape[0]
    ATA = np.empty((N, 5, 5))
    for p in range(5):
        for q in range(5):
            ATA[:, p, q] = (w2 * terms[p] * terms[q]).sum(-1)
    ok = _det_ok(ATA)
    ATA[~ok] = np.eye(5)
    coeffs = _solve_batched(ATA, None, w2, terms)
    # un-normalise: derivative order determines the power of s
    powers = [1, 1, 2, 2, 2]
    coeffs = [c * m / s ** p for c, p in zip(coeffs, powers)]
    centre = np.stack([-c.sum(-1) for c in coeffs], axis=1)
    return centre, np.stack(coeffs, axis=1), ok


def shape_functions_2D_stag_1st_order(dx, dy, mask):
    """map, d/dx, d/dy where f is NOT known at the target (staggered).

    Returns (Nf_c, Nfx_c, Nfy_c, ok), each [N,K].
    """
    s = _norm_scale(dx, dy, mask)
    dxn, dyn = dx / s, dy / s
    w = _weights(dxn, dyn, mask)
    w2 = w ** 2
    m = mask.astype(np.float64)
    terms = [m, dxn * m, dyn * m]
    N = dx.shape[0]
    ATA = np.empty((N, 3, 3))
    for p in range(3):
        for q in range(3):
            ATA[:, p, q] = (w2 * terms[p] * terms[q]).sum(-1)
    ok = _det_ok(ATA)
    ATA[~ok] = np.eye(3)
    Nf_c, Nfx_c, Nfy_c = _solve_batched(ATA, None, w2, terms)
    return Nf_c * m, Nfx_c * m / s, Nfy_c * m / s, ok


def _norm_scale(dx, dy, mask):
    d = np.sqrt(dx ** 2 + dy ** 2)
    d = np.where(mask, d, np.nan)
    s = np.nanmean(d, axis=-1, keepdims=True)
    return np.where(np.isfinite(s) & (s > 0), s, 1.0)


# -- 1-D versions (zeta operators) ------------------------------------------

def shape_functions_1D_reg_2nd_order(dx, mask):
    """1-D d/dx and d2/dx2 where f IS known at the target."""
    d = np.where(mask & (np.abs(dx) > 0), np.abs(dx), 1.0)
    w2 = np.where(mask, 1.0 / d ** Q_WEIGHT, 0.0) ** 2
    m = mask.astype(np.float64)
    t1, t2 = dx * m, 0.5 * dx ** 2 * m
    N = dx.shape[0]
    ATA = np.empty((N, 2, 2))
    ATA[:, 0, 0] = (w2 * t1 * t1).sum(-1)
    ATA[:, 0, 1] = (w2 * t1 * t2).sum(-1)
    ATA[:, 1, 0] = ATA[:, 0, 1]
    ATA[:, 1, 1] = (w2 * t2 * t2).sum(-1)
    Nfx_c, Nfxx_c = _solve_batched(ATA, None, w2, [t1, t2])
    Nfx_c *= m
    Nfxx_c *= m
    return -Nfx_c.sum(-1), -Nfxx_c.sum(-1), Nfx_c, Nfxx_c


def shape_functions_1D_stag_2nd_order(dx, mask):
    """1-D map and d/dx where f is NOT known at the target."""
    d = np.where(mask & (np.abs(dx) > 0), np.abs(dx), 1.0)
    w2 = np.where(mask, 1.0 / d ** Q_WEIGHT, 0.0) ** 2
    m = mask.astype(np.float64)
    t0, t1 = m, dx * m
    N = dx.shape[0]
    ATA = np.empty((N, 2, 2))
    ATA[:, 0, 0] = (w2 * t0 * t0).sum(-1)
    ATA[:, 0, 1] = (w2 * t0 * t1).sum(-1)
    ATA[:, 1, 0] = ATA[:, 0, 1]
    ATA[:, 1, 1] = (w2 * t1 * t1).sum(-1)
    Nf_c, Nfx_c = _solve_batched(ATA, None, w2, [t0, t1])
    return Nf_c * m, Nfx_c * m
