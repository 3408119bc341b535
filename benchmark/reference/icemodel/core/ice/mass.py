"""Conservation of mass: dHi/dt from the upwind flux divergence.

Re-design of src/UFEMISM/ice_dynamics/conservation_of_mass/: the reference
assembles an upwind flux-divergence CSR matrix M_divQ each step and
multiplies it with H (conservation_of_mass_utilities.f90:23). The matrix
has exactly the vertex-connectivity sparsity, so here div(Q) is a stencil:
per-connection upwind fluxes over padded neighbour tables, summed per
Voronoi cell - no assembly.
"""

from __future__ import annotations

import torch

from ...parallel import comm
from ..mesh_data import MeshData, map_b_to_c
from .geometry import ice_surface_elevation, Hi_from_Hb_Hs_and_SL


def _u_perp(md: MeshData, u_vav_b, v_vav_b):
    u_c = map_b_to_c(md, u_vav_b)
    v_c = map_b_to_c(md, v_vav_b)
    u_e = md.ext_E(u_c)[md.VE]    # [nV, K]
    v_e = md.ext_E(v_c)[md.VE]
    return u_e * md.D_x / md.D + v_e * md.D_y / md.D


def calc_divQ_upwind(md: MeshData, Hi, u_vav_b, v_vav_b, fraction_margin):
    """div(Q) [m/yr] on the a-grid via upwind scheme.

    Flux through the shared Voronoi boundary of (vi,vj): L_c * u_perp * H_up,
    H_up = H_vi if u_perp > 0 (outflow) else H_vj; margin gating per
    reference (cells not fully ice-filled don't export ice).
    """
    u_perp = _u_perp(md, u_vav_b, v_vav_b)

    fm_i = fraction_margin[:, None]
    fm_j = torch.where(md.mask_C, md.ext_V(fraction_margin)[md.C], 0.0)
    Hi_j = torch.where(md.mask_C, md.ext_V(Hi)[md.C], 0.0)

    LcA = md.Cw / md.A[:, None]
    out_coeff = torch.where((fm_i >= 1.0) & md.mask_C,
                            LcA * torch.clamp(u_perp, min=0.0), 0.0)
    in_coeff = torch.where((fm_j >= 1.0) & md.mask_C,
                           LcA * torch.clamp(u_perp, max=0.0), 0.0)
    return (out_coeff * Hi[:, None] + in_coeff * Hi_j).sum(dim=1)


def make_bc_masks(C, md: MeshData):
    """Per-border thickness-BC masks from the border fields.
    Returns (bc_zero, bc_inf, has_inf)."""
    borders = {"north": md.border_N, "east": md.border_E,
               "south": md.border_S, "west": md.border_W}
    bc_zero = torch.zeros_like(md.border_N)
    bc_inf = torch.zeros_like(md.border_N)
    has_inf = False
    for side, border in borders.items():
        bc = getattr(C, f"BC_H_{side}")
        if bc == "zero":
            bc_zero = bc_zero | border
        elif bc == "infinite":
            bc_inf = bc_inf | border
            has_inf = True
        else:
            raise ValueError(f"unknown BC_H '{bc}'")
    return bc_zero, bc_inf, has_inf


def apply_ice_thickness_BC_explicit(C, md: MeshData, mask_noice, Hb, SL,
                                    Hi_tplusdt, bc_masks=None):
    """Domain-border thickness BCs (conservation_of_mass_explicit.f90:149).

    'zero': Hi = 0 on that border. 'infinite': Hs set to the mean Hs of
    interior neighbours (or of all neighbours if none interior).
    """
    if bc_masks is None:
        bc_masks = make_bc_masks(C, md)
    bc_zero, bc_inf, has_inf = bc_masks

    Hi_out = torch.where(bc_zero, 0.0, Hi_tplusdt)
    if not has_inf:
        return Hi_out

    Hs = ice_surface_elevation(Hi_out, Hb, SL)
    interior = (md.VBI == 0) & ~mask_noice
    nbr_int = md.ext_V(interior)[md.C] & md.mask_C
    n_int = nbr_int.sum(dim=1)

    # first pass: mean Hs over interior neighbours
    Hs_nbr = torch.where(nbr_int, md.ext_V(Hs)[md.C], 0.0)
    Hs_av1 = Hs_nbr.sum(1) / torch.clamp(n_int, min=1)
    pass1 = bc_inf & (n_int > 0)
    Hs1 = torch.where(pass1, torch.maximum(Hb, Hs_av1), Hs)
    Hi1 = torch.where(pass1, Hi_from_Hb_Hs_and_SL(Hb, Hs1, SL), Hi_out)

    # second pass: border vertices with no interior neighbours use all nbrs
    Hs_all = torch.where(md.mask_C, md.ext_V(Hs1)[md.C], 0.0)
    nC = md.mask_C.sum(dim=1)
    Hs_av2 = Hs_all.sum(1) / torch.clamp(nC, min=1)
    pass2 = bc_inf & (n_int == 0)
    Hs2 = torch.where(pass2, torch.maximum(Hb, Hs_av2), Hs1)
    Hi2 = torch.where(pass2, Hi_from_Hb_Hs_and_SL(Hb, Hs2, SL), Hi1)
    return Hi2


def calc_dHi_dt_explicit(C, md: MeshData, Hi, Hb, SL, u_vav_b, v_vav_b,
                         SMB, BMB, LMB, AMB, fraction_margin, mask_noice,
                         dt, dHi_dt_target, bc_masks=None):
    """Explicit thickness rates (conservation_of_mass_explicit.f90:24).

    Returns (dHi_dt, Hi_tplusdt, divQ). The reference's flux-limited-dt
    clamp is a no-op in practice (its dt_lim formula divides by
    max(dHi_dt, 1e-9) with dHi_dt < 0, yielding huge limits), so dt is
    taken as given.
    """
    divQ = calc_divQ_upwind(md, Hi, u_vav_b, v_vav_b, fraction_margin)
    dHi_dt = (-divQ + fraction_margin * (SMB + BMB - dHi_dt_target) + LMB)
    Hi_tplusdt = torch.clamp(Hi + dHi_dt * dt, min=0.0)
    Hi_tplusdt = apply_ice_thickness_BC_explicit(C, md, mask_noice, Hb, SL,
                                                 Hi_tplusdt, bc_masks)
    Hi_tplusdt = torch.where(mask_noice, 0.0, Hi_tplusdt)
    # effective applied rate after safeties
    dHi_dt = (Hi_tplusdt - Hi) / dt
    return dHi_dt, Hi_tplusdt, divQ


def calc_critical_timestep_adv(C, md: MeshData, Hi, mask_floating,
                               u_vav_b, v_vav_b):
    """Advective CFL timestep over edges (time_step_criteria.f90:80).
    Returns a Python float (time bookkeeping lives on the host, in f64)."""
    u_c = map_b_to_c(md, u_vav_b)
    v_c = map_b_to_c(md, v_vav_b)
    Hi_e = md.ext_V(Hi)[md.EV]     # [nE,2]
    has_ice = (Hi_e > 0.0).all(dim=1)
    if C.do_grounded_only_adv_dt:
        fl_e = md.ext_V(mask_floating)[md.EV]
        has_ice = has_ice & ~fl_e.any(dim=1)
    dt = md.E_len / torch.clamp(torch.abs(u_c) + torch.abs(v_c),
                                min=0.1) * 0.9
    dt = torch.where(has_ice, dt, C.dt_ice_max)
    return min(C.dt_ice_max, float(comm.min_all(dt)))


def make_divQ_operator(md: MeshData, u_vav_b, v_vav_b, fraction_margin,
                       dtype=None):
    """Per-connection upwind coefficients for div(Q) as a linear operator
    in H (the reference's M_divQ matrix, assembly-free). `dtype`
    optionally promotes the coefficient tensors (the semi-implicit solve
    runs in f64 even in f32 performance mode, see
    calc_dHi_dt_semiimplicit).

    Returns (apply(H) -> divQ, u_perp [nV,K], diag [nV]).
    """
    u_perp = _u_perp(md, u_vav_b, v_vav_b)

    fm_i = fraction_margin[:, None]
    fm_j = torch.where(md.mask_C, md.ext_V(fraction_margin)[md.C], 0.0)
    LcA = md.Cw / md.A[:, None]
    if dtype is not None:
        u_perp = u_perp.to(dtype)
        LcA = LcA.to(dtype)
    out_coeff = torch.where((fm_i >= 1.0) & md.mask_C,
                            LcA * torch.clamp(u_perp, min=0.0), 0.0)
    in_coeff = torch.where((fm_j >= 1.0) & md.mask_C,
                           LcA * torch.clamp(u_perp, max=0.0), 0.0)
    diag = out_coeff.sum(dim=1)

    def apply(H):
        Hj = torch.where(md.mask_C, md.ext_V(H)[md.C], 0.0)
        return diag * H + (in_coeff * Hj).sum(dim=1)

    return apply, u_perp, diag


def calc_dHi_dt_semiimplicit(C, md: MeshData, Hi, Hb, SL, u_vav_b, v_vav_b,
                             SMB, BMB, LMB, AMB, fraction_margin, mask_noice,
                             dt, dHi_dt_target, bc_masks=None):
    """Semi-implicit thickness update: solve
    (I + dt fs M_divQ) H(t+dt) = Hi - dt (1-fs) divQ + dt m
    matrix-free with BiCGSTAB (conservation_of_mass_semiimplicit.f90:25;
    the reference uses PETSc with dHi_PETSc_rtol/abstol). Returns
    (dHi_dt, Hi_tplusdt, divQ, n_iter)."""
    from ...ops.krylov import bicgstab

    fs = C.dHi_semiimplicit_fs
    # The thickness solve runs in f64 EVEN IN f32 PERFORMANCE MODE: an
    # f32 solve can only reach ~1e-5 relative residual, i.e. ~0.03 m of
    # solution noise on a 3000 m ice column, which the pc controller
    # reads as truncation error tau ~ zeta*0.03/(6 dt) >= pc_epsilon and
    # pins dt at its noise equilibrium. The continuity stencil is
    # [nV, K~6] elementwise work - negligible next to the b-grid momentum
    # solve - so f64 here costs little and restores the reference's dt
    # trajectory (conservation_of_mass_semiimplicit.f90 solves at
    # dHi_PETSc_rtol=1e-8 in double).
    dtype = torch.float64
    divQ_op, u_perp, diag = make_divQ_operator(md, u_vav_b, v_vav_b,
                                               fraction_margin, dtype=dtype)
    Hi64 = Hi.to(dtype)
    divQ = divQ_op(Hi64)

    m_dt = torch.maximum(-Hi64, dt * (fraction_margin.to(dtype)
                                      * (SMB + BMB - dHi_dt_target) + LMB))
    b = Hi64 - dt * (1.0 - fs) * divQ + m_dt

    def A(H):
        return H + dt * fs * divQ_op(H)

    M_pre = 1.0 / (1.0 + dt * fs * diag)
    res = bicgstab(A, b, x0=Hi64, M=lambda r: M_pre * r,
                   rtol=C.dHi_PETSc_rtol, abstol=C.dHi_PETSc_abstol)
    Hi_tplusdt = torch.clamp(res.x, min=0.0).to(Hi.dtype)
    Hi_tplusdt = apply_ice_thickness_BC_explicit(C, md, mask_noice, Hb, SL,
                                                 Hi_tplusdt, bc_masks)
    Hi_tplusdt = torch.where(mask_noice, 0.0, Hi_tplusdt)
    dHi_dt = (Hi_tplusdt - Hi) / dt
    # divQ returns in the FIELD dtype: it feeds the f32 state
    return dHi_dt, Hi_tplusdt, divQ.to(Hi.dtype), res.n_iter


def calc_dHi_dt(C, md: MeshData, Hi, Hb, SL, u_vav_b, v_vav_b,
                SMB, BMB, LMB, AMB, fraction_margin, mask_noice,
                dt, dHi_dt_target, bc_masks=None):
    """Dispatch on choice_ice_integration_method
    (conservation_of_mass_main.f90:65-81). `dt` is a Python float.
    Returns (dHi_dt, Hi_tplusdt, divQ, n_solver_its)."""
    choice = C.choice_ice_integration_method
    if choice == "none":
        z = torch.zeros_like(Hi)
        return z, Hi, z, 0
    if choice == "explicit":
        dHdt, Hnew, divQ = calc_dHi_dt_explicit(
            C, md, Hi, Hb, SL, u_vav_b, v_vav_b, SMB, BMB, LMB, AMB,
            fraction_margin, mask_noice, dt, dHi_dt_target, bc_masks)
        return dHdt, Hnew, divQ, 0
    if choice == "semi-implicit":
        return calc_dHi_dt_semiimplicit(
            C, md, Hi, Hb, SL, u_vav_b, v_vav_b, SMB, BMB, LMB, AMB,
            fraction_margin, mask_noice, dt, dHi_dt_target, bc_masks)
    raise ValueError(f"unknown choice_ice_integration_method '{choice}'")
