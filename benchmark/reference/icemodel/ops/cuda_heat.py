"""The column-solve kernel of the heat equation: build, binding, wrapper
and plain version.

`heat_columns` does for every vertical column what the reference's
make_heat_solver `solve` does once the coefficient fields are formed
(ufemism2_tpu/core/ice/thermodynamics.py:302-369 on top of
ufemism2_tpu/ops/tridiag.py thomas_batched): the stability ladder of 31
implicit substeps (levels dt, dt/2 x2, ..., dt/16 x16) with the grounded
and/or floating basal boundary condition, the choice of each column's
first stable level, the Robin fallback, the thin-ice surface profile, the
pressure-melting cap and the count of unstable columns.

The CUDA source csrc/heat_columns.cu is compiled with nvcc at first use
into its own shared library under build/ and loaded with ctypes, as
ops/cuda_spmv.py does for stack_spmv. A CUDA tensor always goes to the
kernel; only CPU tensors take `heat_columns_plain`, the reference's code
ported literally (the CPU path and the kernel's oracle: on the card the
two agree to the bit).

Precision: the zeta operator rows are float64, so for float32 fields the
systems are formed and solved in float64, and the result is float64 in
either precision (run_thermodynamics casts it back). In the first substep
of a level the right-hand side and the basal boundary value are float32
arrays in float32 mode; the plain version keeps that by dividing by dt as
a tensor of the operand's type (a Python-scalar divisor would become a
multiplication by its reciprocal on the card) and by writing the
boundary rows into b in place.
"""

from __future__ import annotations


import numpy as np
import torch

from .tridiag import thomas_batched
from ..utils.constants import T0

launches = 0         # heat_columns launches since the caller last set it to 0
# None: the operands as given; the control of the benchmark's comparison
# rounds them through a lower type (compare.rounded_through)
HEAT_ROUND = None
GL_BC = {"grounded": 0, "pmp": 1}    # any other choice: subgrid (2)


def zeta_rows(zops, device):
    """The zeta operator rows of `tridiag.zeta_tridiag_operators` as one
    float64 tensor [6, nz]: l1, d1, u1, l2, d2, u2, the sub- and
    super-diagonal rows padded with a trailing zero."""
    l1, d1, u1 = zops["ddzeta"]
    l2, d2, u2 = zops["d2dzeta2"]
    pad = lambda a: np.concatenate([a, np.zeros(len(d1) - len(a))])
    return torch.as_tensor(np.stack([pad(l1), d1, pad(u1), pad(l2), d2,
                                     pad(u2)]), dtype=torch.float64,
                           device=device)


def _like(x, value):
    """`value` as a 0-dim tensor of x's type and device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def heat_columns_plain(Ti, c_dd, c_d2, rhs, T_surf, q_base, T_base_float,
                       Ti_pmp, grounded, floating, gl_gr, fraction_gr, thin,
                       T_robin, zrows, dt, gl_bc="grounded"):
    """Plain tensor version of the kernel (the reference's solve, from the
    coefficient fields on): (Ti_new [n, nz] float64, n_unstable int32)."""
    nz = Ti.shape[1]
    l1, u1, l2, u2 = (zrows[j, :nz - 1] for j in (0, 2, 3, 5))
    d1, d2 = zrows[1], zrows[4]
    ldiag = c_dd[:, 1:] * l1[None, :] + c_d2[:, 1:] * l2[None, :]
    udiag = c_dd[:, :-1] * u1[None, :] + c_d2[:, :-1] * u2[None, :]
    ldiag[:, nz - 2] = 0.0
    udiag[:, 0] = 0.0

    def solve_columns(T_in, base_is_flux, dt_i):
        """One implicit vertical solve for all columns [n, nz]."""
        diag = 1.0 / dt_i + c_dd * d1[None, :] + c_d2 * d2[None, :]
        b = rhs + T_in / _like(T_in, dt_i)
        # surface BC row: T = min(T_surf, T0)
        diag[:, 0] = 1.0
        b[:, 0] = torch.clamp(T_surf, max=T0)
        # basal BC row
        if base_is_flux:
            T_base_bc = torch.minimum(Ti_pmp[:, nz - 1],
                                      T_in[:, nz - 2] - q_base)
        else:
            T_base_bc = torch.minimum(T_base_float, Ti_pmp[:, nz - 1])
        diag[:, nz - 1] = 1.0
        b[:, nz - 1] = T_base_bc
        return thomas_batched(ldiag, diag, udiag, b)

    def one_solve(T_in, dt_i):
        T_g = solve_columns(T_in, True, dt_i)
        T_f = solve_columns(T_in, False, dt_i)
        if gl_bc == "grounded":
            T_gl = T_g
        elif gl_bc == "pmp":
            T_gl = T_f
        else:  # subgrid
            T_gl = fraction_gr[:, None] * T_g \
                + (1 - fraction_gr[:, None]) * T_f
        return torch.where(gl_gr[:, None], T_gl,
                           torch.where(grounded[:, None], T_g,
                                       torch.where(floating[:, None], T_f,
                                                   T_g)))

    def substep_solution(n_sub, dt_i):
        T = Ti
        for _ in range(n_sub):
            T = one_solve(T, dt_i)
        return T

    # stability ladder: dt, dt/2 x2, dt/4 x4, dt/8 x8, dt/16 x16
    candidates = [substep_solution(2 ** lev, dt * 0.5 ** lev)
                  for lev in range(5)]

    def stable(T):
        return (torch.isfinite(T) & (T >= 180.0) & (T <= T0)).all(dim=1)

    T_out = candidates[-1]
    ok = stable(candidates[-1])
    for T_cand in reversed(candidates[:-1]):
        s = stable(T_cand)
        T_out = torch.where(s[:, None], T_cand, T_out)
        ok = ok | s

    # unstable columns -> Robin solution
    T_out = torch.where(ok[:, None], T_out, T_robin)
    # very thin ice: profile = surface temperature
    T_out = torch.where(thin[:, None], T_surf[:, None], T_out)
    # cap at pressure melting point
    T_out = torch.minimum(T_out, Ti_pmp)
    n_unstable = (~ok & ~thin).sum().to(torch.int32)
    return T_out, n_unstable


def _check(Ti, fields, cols, q_base, masks, T_robin, zrows):
    if Ti.ndim != 2 or Ti.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"heat_columns: Ti must be a float32/float64 "
                        f"[n, nz] tensor, got {Ti.dtype} {tuple(Ti.shape)}")
    n, nz = Ti.shape
    if nz < 3:
        raise ValueError(f"heat_columns: nz {nz} < 3")
    for t, shape, dtype in (
            [(f, (n, nz), Ti.dtype) for f in fields]
            + [(c, (n,), Ti.dtype) for c in cols]
            + [(q_base, (n,), torch.float64),
               (T_robin, (n, nz), torch.float64),
               (zrows, (6, nz), torch.float64)]
            + [(m, (n,), torch.bool) for m in masks]):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"heat_columns: an operand is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != Ti.device:
            raise ValueError("heat_columns: operands on different devices")


def heat_columns(Ti, c_dd, c_d2, rhs, T_surf, q_base, T_base_float, Ti_pmp,
                 grounded, floating, gl_gr, fraction_gr, thin, T_robin, zrows,
                 dt, gl_bc="grounded"):
    """The column solves of one thermodynamics step: (Ti_new [n, nz]
    float64, n_unstable as an int32 tensor).

    Ti, c_dd (d/dzeta coefficient), c_d2 (d2/dzeta2 coefficient), rhs and
    Ti_pmp are [n, nz] and T_surf, T_base_float and fraction_gr [n] in the
    run's type T; q_base [n] (the flux part of the grounded basal row,
    dz_base * Q_base / (dzz_base * Ki_base)) and T_robin [n, nz] are
    float64; grounded, floating, gl_gr and thin are bool masks; zrows is
    `zeta_rows(...)`; dt a Python float; gl_bc the choice_GL_temperature_BC
    value."""
    fields = (Ti, c_dd, c_d2, rhs, Ti_pmp)
    cols = (T_surf, T_base_float, fraction_gr)
    masks = (grounded, floating, gl_gr, thin)
    _check(Ti, fields, cols, q_base, masks, T_robin, zrows)
    if HEAT_ROUND is not None:
        rnd = lambda t: t.to(HEAT_ROUND).to(t.dtype)
        Ti, c_dd, c_d2, rhs, T_surf, T_base_float, Ti_pmp = (
            rnd(t) for t in (Ti, c_dd, c_d2, rhs, T_surf, T_base_float,
                             Ti_pmp))
    return heat_columns_plain(Ti, c_dd, c_d2, rhs, T_surf, q_base,
                              T_base_float, Ti_pmp, grounded, floating,
                              gl_gr, fraction_gr, thin, T_robin, zrows, dt,
                              gl_bc)
