"""Hybrid DIVA/BPA stress balance, matrix-free.

Counterpart of the reference's core/ice/hybrid.py (itself a re-design of
src/UFEMISM/ice_dynamics/conservation_of_momentum/hybrid_DIVA_BPA/
hybrid_DIVA_BPA_main.f90): one merged system whose unknowns are the
vertically averaged velocities (u, v) [nTri] on DIVA triangles and the 3-D
velocities (u3, v3) [nTri, nz] on BPA triangles, with transition rows
coupling the two at the interface (solve_hybrid_DIVA_BPA_linearised,
:658-1000):

  vav row, DIVA tri       : DIVA stiffness (M2 stencil on vav u, v)
  vav row, BPA-halo tri   : -u_vav + SUM_k w_k u3(k) = 0
  3-D row, BPA tri        : BPA stiffness (3-D operator on u3, v3)
  3-D row, DIVA-halo tri  : u3(k) - w_k u_vav = 0
                            (w from the DIVA vertical structure,
                             Lipscomb 2019 Eqs. 29/33)

applied matrix-free on x = (u_vav, v_vav, u3, v3) and solved by GMRES with
a block-diagonal preconditioner inside one viscosity iteration that forms
both solvers' coefficient fields. The vav rows are one `stack_spmv` launch
of the five-operator M2 stack per component and tensor code; the 3-D rows
are the BPA kernel `bpa_apply` with the hybrid's lateral rows ('infinite'
sides neighbour-mean rows, every other side identity rows) and its basal
friction (beta with the sub-grid friction of the grounding line), then
the transition and identity rows in tensor code.

Solver masks (calc_hybrid_solver_masks_basic, :392-437): 'read_from_file'
(a mask_BPA field on an x/y grid) or 'ROI' (BPA on the triangles whose
circumcentre lies inside a region of interest); the transition masks are each
sub-domain's stencil halo (calc_hybrid_solver_masks_transition,
:1215-1299), three triangle rings dilated on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh_data import MeshData
from ...utils.constants import ice_density, grav
from ...ops.cuda_bpa import BpaOperator
from ...ops.cuda_spmv import DivaRows
from ...ops.krylov import gmres
from ...mesh.zeta import integrate_from_base_up, vertical_average
from .bpa import (BpaGeometry, krylov_preconditioner, limit_speed,
                  register_bpa_static, relax_step, viscosity_3d)
from .masks import determine_masks
from .rheology import calc_ice_rheology_glen
from .subgrid import (calc_grounded_fractions, calc_effective_thickness,
                      register_bedrock_cdfs)
from .sliding import calc_basal_friction_coefficient
from .ssadiva import make_bc_data, _bed_roughness_fields


def resolve_hybrid_mask(C, mesh, region_name: str) -> np.ndarray:
    """mask_BPA_b [nTri] from choice_hybrid_DIVA_BPA_mask_<region>: a
    'read_from_file' mask_BPA field ([y, x] or [x, y]) taken at each
    triangle's circumcentre from the grid cell that np.searchsorted finds
    (the reference's lookup), or 'ROI'."""
    key = f"choice_hybrid_DIVA_BPA_mask_{region_name}"
    choice = getattr(C, key)
    if choice == "read_from_file":
        from ...io.ncio import NCFile, find_field
        fname = getattr(C, f"filename_hybrid_DIVA_BPA_mask_{region_name}")
        with NCFile(fname) as nc:
            x = find_field(nc, "x")
            y = find_field(nc, "y")
            m = find_field(nc, "mask_BPA")
        if m.shape == (len(y), len(x)):
            m = m.T
        cc = mesh.Tricc
        xi = np.clip(np.searchsorted(x, cc[:, 0]), 0, len(x) - 1)
        yi = np.clip(np.searchsorted(y, cc[:, 1]), 0, len(y) - 1)
        return m[xi, yi] > 0.5
    if choice == "ROI":
        # the triangles whose circumcentre lies in one of the regions of
        # interest
        from ...mesh.refinement import points_in_polygon
        from ...mesh.roi_polygons import calc_roi_polygon
        mask = np.zeros(mesh.nTri, bool)
        for roi in (r for r in C.choice_regions_of_interest.split(",")
                    if r):
            mask |= points_in_polygon(mesh.Tricc,
                                      calc_roi_polygon(roi.strip()))
        return mask
    raise ValueError(f"unknown {key} '{choice}'")


def _dilate(mask: np.ndarray, TriC: np.ndarray, n: int) -> np.ndarray:
    """n-ring triangle-adjacency dilation (host-side)."""
    out = mask.copy()
    ok = TriC >= 0
    for _ in range(n):
        nbr = np.where(ok, out[np.maximum(TriC, 0)], False)
        out = out | nbr.any(axis=1)
    return out


def hybrid_tables(C, mesh, md: MeshData, mask_BPA_b):
    """The hybrid's static tables of one mask on md's device: the four row
    masks, the DIVA lateral row classification (make_bc_data) packed for
    the kernel, the M2 d2/dxdy diagonal and the vertical-average weights;
    BPA's own tables (register_bpa_static) go into md.extras."""
    register_bpa_static(C, mesh, md)
    mask_BPA = np.asarray(mask_BPA_b, bool)
    mask_DIVA = ~mask_BPA
    # transition = each side's stencil halo into the other; the M2/LSQ
    # stencils span <= 2 triangle rings, +1 ring of margin for the
    # viscosity a<->b maps
    halo_of_BPA = _dilate(mask_BPA, mesh.TriC, 3) & mask_DIVA
    halo_of_DIVA = _dilate(mask_DIVA, mesh.TriC, 3) & mask_BPA
    bc = make_bc_data(C, mesh)
    dev, dt = md.device, md.A.dtype
    b = lambda a: torch.as_tensor(a, device=dev)
    zeta = np.asarray(mesh.zeta)
    # vertical-average weights (zeta_stag, the reference's dzeta weights
    # in the transition rows)
    zs = 0.5 * (zeta[1:] + zeta[:-1])
    w_vav = np.empty(len(zeta))
    w_vav[0] = zs[0]
    w_vav[-1] = 1.0 - zs[-1]
    w_vav[1:-1] = zs[1:] - zs[:-1]
    return {
        "DIVA": b(mask_DIVA), "vav_from_BPA": b(halo_of_DIVA),
        "BPA": b(mask_BPA), "3D_from_DIVA": b(halo_of_BPA),
        "rows": DivaRows(md.TriC, md.mask_TriC, b(bc.free), b(bc.inf_u),
                         b(bc.inf_v)),
        "d_dxy": torch.as_tensor(mesh.operators.M2_d2dxdy_b_b.diagonal(),
                                 dtype=dt, device=dev),
        "w_vav": torch.as_tensor(w_vav, dtype=dt, device=dev),
    }


@dataclass
class _HybridCarry:
    u: torch.Tensor          # [nTri] vav
    v: torch.Tensor
    u3: torch.Tensor         # [nTri, nz]
    v3: torch.Tensor
    u_base: torch.Tensor     # [nTri] basal velocities (sliding law input)
    v_base: torch.Tensor
    tau_bx: torch.Tensor
    tau_by: torch.Tensor
    eta_3D_b: torch.Tensor
    relax: float
    eps_sq0: float
    L2: float
    n_diverg: int
    it: int
    n_axb: int
    done: bool


def make_solve_hybrid(C, md: MeshData, mask_BPA_b: np.ndarray,
                      bedrock_cdfs=None):
    """Build solve(md, Hi, Hs, Hb, SL, Ti, s) -> (u_vav_b, v_vav_b, u_3D_b,
    v_3D_b, n_visc_its, n_Axb_its) for the hybrid DIVA/BPA."""
    precond_kind = C.tpu_stress_balance_precond
    precond_deg = int(C.tpu_stress_balance_precond_degree)
    krylov_restart = int(C.tpu_stress_balance_krylov_restart)
    n_glen = C.Glens_flow_law_exponent
    no_sliding = C.choice_sliding_law == "no_sliding"
    mesh = md._host_mesh
    zeta_h = np.asarray(mesh.zeta)
    dzeta = float(zeta_h[1] - zeta_h[0])
    tab = hybrid_tables(C, mesh, md, mask_BPA_b)
    register_bedrock_cdfs(md, bedrock_cdfs)

    def solve(md, Hi, Hs, Hb, SL, Ti, s):
        zeta, nz, nTri = md.zeta, md.nz, md.nTri
        dtype, dev = md.A.dtype, md.device
        m_DIVA, m_BPA = tab["DIVA"], tab["BPA"]
        m_vav_from_BPA = tab["vav_from_BPA"]
        m_3D_from_DIVA = tab["3D_from_DIVA"]
        rows = tab["rows"]
        bc_free, bc_inf_u, bc_inf_v = rows.free, rows.inf_u, rows.inf_v
        w_vav = tab["w_vav"]
        n_nbr = md.mask_TriC.sum(dim=1).to(dtype)
        d_ddx, d_ddy = md.x("bpa_d_ddx"), md.x("bpa_d_ddy")
        d_dxx, d_dyy = md.x("bpa_d_dxx"), md.x("bpa_d_dyy")
        d_dxy = tab["d_dxy"]

        def nbr_mean_residual_2d(x):
            s_ = torch.where(md.mask_TriC, x[md.TriC], 0.0).sum(dim=1)
            return s_ - n_nbr * x

        masks = determine_masks(md, Hi, Hb, SL)
        A_flow = calc_ice_rheology_glen(C, md, Hi, Hs, Ti,
                                        masks["mask_grounded_ice"],
                                        masks["mask_floating_ice"])
        fraction_gr, fraction_gr_b = calc_grounded_fractions(
            C, md, Hi, Hb, SL, masks["mask_floating_ice"], dHb=s.dHb)
        Hi_eff, _ = calc_effective_thickness(md, Hi, Hb, SL)
        Hs_slope = torch.sqrt(md.M_ddx_a_a.exact_matvec(Hs) ** 2
                              + md.M_ddy_a_a.exact_matvec(Hs) ** 2)
        bed_roughness = _bed_roughness_fields(C, md, s.bed_roughness)
        Hi_reg = torch.clamp(Hi, min=0.1)
        geo = BpaGeometry(md, Hi, Hs, dzeta)
        Hi_b = geo.Hi_b
        tau_dx = -ice_density * grav * Hi_b * geo.dh_dx_b    # DIVA rows
        tau_dy = -ice_density * grav * Hi_b * geo.dh_dy_b
        Q_fac = geo.Q_fac

        b_u = torch.where(m_DIVA & bc_free, -tau_dx, 0.0)
        b_v = torch.where(m_DIVA & bc_free, -tau_dy, 0.0)
        bpa_free = (m_BPA & bc_free)[:, None]
        b_u3 = torch.where(bpa_free, geo.tau_dx[:, None] * -1.0, 0.0) \
            .expand(nTri, nz).contiguous()
        b_v3 = torch.where(bpa_free, geo.tau_dy[:, None] * -1.0, 0.0) \
            .expand(nTri, nz).contiguous()
        if no_sliding:
            b_u3[:, nz - 1] = 0.0
            b_v3[:, nz - 1] = 0.0
        b_all = (b_u, b_v, b_u3, b_v3)
        rtol = C.stress_balance_PETSc_rtol
        if dtype == torch.float32:
            rtol = max(rtol, 1e-5)
        zz = zeta.expand(md.nV, nz)

        def body(c: _HybridCarry) -> _HybridCarry:
            # == DIVA coefficients (from the vav field) =================
            du_dx_a = md.M_ddx_b_a @ c.u
            du_dy_a = md.M_ddy_b_a @ c.u
            dv_dx_a = md.M_ddx_b_a @ c.v
            dv_dy_a = md.M_ddy_b_a @ c.v
            eta_reg = torch.clamp(c.eta_3D_b, min=C.visc_eff_min)
            du_dz_a = md.M_map_b_a @ (c.tau_bx[:, None] * zeta[None, :]
                                      / eta_reg)
            dv_dz_a = md.M_map_b_a @ (c.tau_by[:, None] * zeta[None, :]
                                      / eta_reg)
            A_min = 1e-18
            eta_max = 0.5 * A_min ** (-1.0 / n_glen) * \
                c.eps_sq0 ** ((1.0 - n_glen) / (2.0 * n_glen))
            eps_sq_D = (du_dx_a ** 2 + dv_dy_a ** 2 + du_dx_a * dv_dy_a
                        + 0.25 * (du_dy_a + dv_dx_a) ** 2)[:, None] \
                + 0.25 * (du_dz_a ** 2 + dv_dz_a ** 2) + c.eps_sq0
            eta_3D_aD = torch.clamp(
                0.5 * A_flow ** (-1.0 / n_glen)
                * eps_sq_D ** ((1.0 - n_glen) / (2.0 * n_glen)),
                C.visc_eff_min, eta_max)
            eta_3D_bD = md.M_map_a_b @ eta_3D_aD
            N_a = vertical_average(zeta, eta_3D_aD, axis=-1) * Hi_reg
            N_b = md.M_map_a_b @ N_a
            dN_dx_b = md.M_ddx_a_b @ N_a
            dN_dy_b = md.M_ddy_a_b @ N_a
            F1_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                zz, zeta[None, :] / eta_3D_aD, axis=-1)
            F2_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                zz, zeta[None, :] ** 2 / eta_3D_aD, axis=-1)
            F1_3D_b = md.M_map_a_b @ F1_3D_a
            F2_a1 = F2_3D_a[:, 0].contiguous()
            F2_b1 = md.M_map_a_b @ F2_a1

            # sliding from the basal velocities (DIVA: the u/(1+beta F2)
            # estimate carried from the previous iteration; BPA: the
            # bottom layer)
            u_base_a = md.M_map_b_a @ torch.where(m_BPA, c.u3[:, nz - 1],
                                                  c.u_base)
            v_base_a = md.M_map_b_a @ torch.where(m_BPA, c.v3[:, nz - 1],
                                                  c.v_base)
            beta_b_a = calc_basal_friction_coefficient(
                C, md, bed_roughness, u_base_a, v_base_a, Hi, Hi_eff, Hb,
                SL, Hs_slope, fraction_gr, masks)
            if no_sliding:
                beta_eff_a = 1.0 / torch.clamp(F2_a1, min=1e-30)
            else:
                beta_eff_a = beta_b_a / (1.0 + beta_b_a * F2_a1)
            beta_eff_b = md.M_map_a_b @ beta_eff_a
            beta_b_b = md.M_map_a_b @ beta_b_a
            if C.do_GL_subgrid_friction:
                fr = fraction_gr_b ** C.subgrid_friction_exponent_on_B_grid
                beta_eff_b = beta_eff_b * fr
                beta_sub_b = beta_b_b * fr
            else:
                beta_sub_b = beta_b_b

            # the DIVA vertical structure of the transition rows:
            # u3(k) = u_vav (1 + beta_b F1(k)) / (1 + beta_b F2_base)
            if no_sliding:
                w_k = beta_eff_b[:, None] * F1_3D_b
            else:
                w_k = (1.0 + beta_b_b[:, None] * F1_3D_b) \
                    / (1.0 + beta_b_b * F2_b1)[:, None]

            # == BPA coefficients (from the 3-D field, DIVA-filled) =====
            u3f = torch.where(m_BPA[:, None], c.u3, w_k * c.u[:, None])
            v3f = torch.where(m_BPA[:, None], c.v3, w_k * c.v[:, None])
            eta, eta_x, eta_y, eta_z, _ = viscosity_3d(C, geo, A_flow, u3f,
                                                       v3f, c.eps_sq0)
            eta_base = torch.clamp(eta[:, nz - 1], min=C.visc_eff_min)
            A3 = BpaOperator(md.M2_stack.op, rows,
                             geo.coeffs(eta, eta_x, eta_y, eta_z, beta_sub_b,
                                        eta_base),
                             dzeta, no_sliding,
                             round_x_bf16=dtype == torch.float32)

            # == merged operator =========================================
            def A_op(x):
                u, v, u3, v3 = x
                du, dv = md.M2_stack.apply(u), md.M2_stack.apply(v)
                ddx_u, ddy_u, dxx_u, dxy_u, dyy_u = du.unbind(0)
                ddx_v, ddy_v, dxx_v, dxy_v, dyy_v = dv.unbind(0)
                Au = (4 * N_b * dxx_u + 4 * dN_dx_b * ddx_u
                      + N_b * dyy_u + dN_dy_b * ddy_u - beta_eff_b * u
                      + 3 * N_b * dxy_v + 2 * dN_dx_b * ddy_v
                      + dN_dy_b * ddx_v)
                Av = (4 * N_b * dyy_v + 4 * dN_dy_b * ddy_v
                      + N_b * dxx_v + dN_dx_b * ddx_v - beta_eff_b * v
                      + 3 * N_b * dxy_u + 2 * dN_dy_b * ddx_u
                      + dN_dx_b * ddy_u)
                # lateral rows of the vav field
                Au = torch.where(bc_free, Au, torch.where(
                    bc_inf_u, nbr_mean_residual_2d(u), u))
                Av = torch.where(bc_free, Av, torch.where(
                    bc_inf_v, nbr_mean_residual_2d(v), v))
                # transition: vav = vertical mean of u3; inactive: identity
                Au = torch.where(m_DIVA, Au, torch.where(
                    m_vav_from_BPA, -u + u3 @ w_vav, u))
                Av = torch.where(m_DIVA, Av, torch.where(
                    m_vav_from_BPA, -v + v3 @ w_vav, v))
                # the 3-D rows: the BPA operator (its lateral rows the
                # hybrid's), then u3 = w_k u_vav on the transition rows and
                # the identity off both sub-domains
                Bu, Bv = A3((u3, v3))
                Bu = torch.where(m_BPA[:, None], Bu, torch.where(
                    m_3D_from_DIVA[:, None], u3 - w_k * u[:, None], u3))
                Bv = torch.where(m_BPA[:, None], Bv, torch.where(
                    m_3D_from_DIVA[:, None], v3 - w_k * v[:, None], v3))
                return (Au, Av, Bu, Bv)

            # preconditioner: DIVA 2x2 block-Jacobi on vav rows, the BPA
            # vertical-diffusion diagonal on 3-D rows, identity elsewhere
            auu = (4 * N_b * d_dxx + 4 * dN_dx_b * d_ddx
                   + N_b * d_dyy + dN_dy_b * d_ddy - beta_eff_b)
            auv = 3 * N_b * d_dxy + 2 * dN_dx_b * d_ddy + dN_dy_b * d_ddx
            avu = 3 * N_b * d_dxy + 2 * dN_dy_b * d_ddx + dN_dx_b * d_ddy
            avv = (4 * N_b * d_dyy + 4 * dN_dy_b * d_ddy
                   + N_b * d_dxx + dN_dx_b * d_ddx - beta_eff_b)
            diva_free = m_DIVA & bc_free
            one = torch.ones_like(auu)
            auu = torch.where(diva_free, auu,
                              torch.where(m_DIVA & bc_inf_u, -n_nbr, one))
            avv = torch.where(diva_free, avv,
                              torch.where(m_DIVA & bc_inf_v, -n_nbr, one))
            auv = torch.where(diva_free, auv, 0.0)
            avu = torch.where(diva_free, avu, 0.0)
            det = auu * avv - auv * avu
            det = torch.where(torch.abs(det) < 1e-300, 1e-300, det)
            diag_3D = -(eta * Q_fac[:, None]) \
                - beta_sub_b[:, None] / Hi_b[:, None] - 1.0
            diag_3D = torch.where(bpa_free, diag_3D, 1.0)

            def M_pre(r):
                ru, rv, ru3, rv3 = r
                return ((avv * ru - auv * rv) / det,
                        (-avu * ru + auu * rv) / det,
                        ru3 / diag_3D, rv3 / diag_3D)

            Mp = krylov_preconditioner(precond_kind, A_op, M_pre,
                                       precond_deg, b_all)
            res = gmres(A_op, b_all, x0=(c.u, c.v, c.u3, c.v3), M=Mp,
                        rtol=rtol, abstol=C.stress_balance_PETSc_abstol,
                        restart=krylov_restart)
            u_new, v_new, u3_new, v3_new = res.x

            # limits + relaxation
            u_new, v_new = limit_speed(C, u_new, v_new)
            u3_new, v3_new = limit_speed(C, u3_new, v3_new)
            r_, q_ = c.relax, 1 - c.relax
            u_new, v_new = r_ * u_new + q_ * c.u, r_ * v_new + q_ * c.v
            u3_new = r_ * u3_new + q_ * c.u3
            v3_new = r_ * v3_new + q_ * c.v3

            # basal velocities + stress for the DIVA shear closure
            if no_sliding:
                u_base = torch.zeros_like(u_new)
                v_base = torch.zeros_like(v_new)
            else:
                u_base = u_new / (1.0 + beta_b_b * F2_b1)
                v_base = v_new / (1.0 + beta_b_b * F2_b1)

            m3 = m_BPA[:, None]
            res1 = (((u_new - c.u) ** 2 + (v_new - c.v) ** 2)
                    * m_DIVA).sum() \
                + (((u3_new - c.u3) ** 2 + (v3_new - c.v3) ** 2) * m3).sum()
            res2 = (((u_new + c.u) ** 2 + (v_new + c.v) ** 2)
                    * m_DIVA).sum() \
                + (((u3_new + c.u3) ** 2 + (v3_new + c.v3) ** 2) * m3).sum()
            L2, n_div, relax, eps_sq0, converged = relax_step(C, c, res1,
                                                              res2)
            return _HybridCarry(
                u=u_new, v=v_new, u3=u3_new, v3=v3_new,
                u_base=u_base, v_base=v_base,
                tau_bx=u_new * beta_eff_b, tau_by=v_new * beta_eff_b,
                eta_3D_b=eta_3D_bD, relax=relax, eps_sq0=eps_sq0, L2=L2,
                n_diverg=n_div, it=c.it + 1, n_axb=c.n_axb + res.n_iter,
                done=converged)

        z = torch.zeros(nTri, dtype=dtype, device=dev)
        c = _HybridCarry(
            u=s.u_vav_b, v=s.v_vav_b, u3=s.u_3D_b.contiguous(),
            v3=s.v_3D_b.contiguous(), u_base=z, v_base=z, tau_bx=z,
            tau_by=z,
            eta_3D_b=torch.full((nTri, nz), C.visc_eff_min, dtype=dtype,
                                device=dev),
            relax=float(C.visc_it_relax),
            eps_sq0=float(C.Glens_flow_law_epsilon_sq_0),
            L2=1e9, n_diverg=0, it=0, n_axb=0, done=False)
        while (not c.done) and c.it <= C.visc_it_nit:
            c = body(c)

        # compose the full fields: the DIVA side takes its vertical mean
        # as its profile, the BPA side defines its own vertical mean
        m3 = m_BPA[:, None]
        u3 = torch.where(m3, c.u3, c.u[:, None].expand(nTri, nz))
        v3 = torch.where(m3, c.v3, c.v[:, None].expand(nTri, nz))
        u_vav = torch.where(m_BPA, c.u3 @ w_vav, c.u)
        v_vav = torch.where(m_BPA, c.v3 @ w_vav, c.v)
        return (u_vav, v_vav, u3, v3, c.it, c.n_axb)

    return solve
