"""SSA / DIVA stress balance: matrix-free viscosity iteration + Krylov solve.

Re-design of the reference's SSA/DIVA machinery
(src/UFEMISM/ice_dynamics/conservation_of_momentum/SSA_DIVA/): instead of
assembling a 2nTri x 2nTri CSR stiffness matrix per viscosity iteration and
calling PETSc (solve_linearised_SSA_DIVA_infinite_slab.f90), the linearised
momentum operator

  u-row: 4 N d2u/dx2 + 4 dN/dx du/dx + N d2u/dy2 + dN/dy du/dy - beta_eff u
       + 3 N d2v/dxdy + 2 dN/dx dv/dy + dN/dy dv/dx  = -tau_dx
  v-row: symmetric

is applied matrix-free: one kernel launch (ops/cuda_spmv.py, `diva_apply`)
forms the five M2_* derivatives of u and v, scales them by the
per-triangle fields (N, dN/dx, dN/dy, beta_eff) and writes the boundary
rows; the system is solved by restarted GMRES with a 2x2 block-Jacobi
preconditioner. The viscosity iteration
(DIVA_solver_infinite_slab.f90:52-231) including the adaptive relaxation
rescue ladder is a host loop over device work.

Not ported yet (each raises NotImplementedError where it is chosen): the
ocean-pressure calving-front rows and the block_dense, two_level,
Chebyshev and Neumann preconditioners.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..mesh_data import MeshData, EField, EIndex
from ...parallel import comm
from ...utils.constants import ice_density, grav
from ...mesh.zeta import integrate_from_base_up, vertical_average
from ...ops.cuda_spmv import DivaOperator, DivaRows
from ...ops.krylov import gmres
from .masks import determine_masks
from .rheology import calc_ice_rheology_glen
from .sia import solve_SIA
from .subgrid import (calc_grounded_fractions, calc_effective_thickness,
                      register_bedrock_cdfs)
from .sliding import calc_basal_friction_coefficient, register_sliding_static


# ---------------------------------------------------------------------------
# Host-side static data: triangle border indices + BC row classification
# ---------------------------------------------------------------------------

def calc_TriBI(mesh) -> np.ndarray:
    """Triangle border indices by tracing the domain border
    (mesh_secondary.f90:72 calc_TriBI)."""
    TriBI = np.zeros(mesh.nTri, dtype=np.int32)
    vbi = mesh.VBI
    sw = np.where(vbi == 6)[0]
    assert len(sw) > 0, "no southwest corner vertex"
    vi_sw = int(sw[0])
    vi = vi_sw
    corners = {}
    for _ in range(mesh.nV + 1):
        for t in mesh.iTri[vi][: mesh.niTri[vi]]:
            TriBI[t] = vbi[vi]
        vi = int(mesh.C[vi, mesh.nC[vi] - 1])
        if vbi[vi] in (2, 4, 8):
            corners[vbi[vi]] = vi
        if vi == vi_sw:
            break
    for code, cv in {6: vi_sw, **corners}.items():
        if mesh.niTri[cv] == 1:
            TriBI[mesh.iTri[cv, 0]] = code
    return TriBI


class _BCData(NamedTuple):
    free: np.ndarray       # [nTri] bool: interior rows (solve the PDE)
    zero_u: np.ndarray     # identity rows, rhs 0
    zero_v: np.ndarray
    inf_u: np.ndarray      # mean-of-neighbours rows, rhs 0
    inf_v: np.ndarray
    fix_u: np.ndarray      # identity rows, rhs = weighted copy of prev sol
    fix_v: np.ndarray
    copy_inds: np.ndarray  # [nTri, Kc] source triangles for fixed rows
    copy_w: np.ndarray     # [nTri, Kc] weights (normalised 1/d^2)


def _copy_tables(mesh, rows, targets):
    """For each row triangle, inverse-distance weights over the triangles
    around the vertex whose Voronoi cell contains the target point
    (find_ti_copy_* pattern, mesh_utilities.f90:2623,2681)."""
    from scipy.spatial import cKDTree
    Kc = int(mesh.niTri.max())
    copy_inds = np.zeros((mesh.nTri, Kc), dtype=np.int64)
    copy_w = np.zeros((mesh.nTri, Kc))
    if len(rows) == 0:
        return copy_inds, copy_w
    vtree = cKDTree(mesh.V)      # nearest vertex == containing Voronoi cell
    _, vis = vtree.query(targets)
    for k, (r, vi) in enumerate(zip(rows, vis)):
        ni = mesh.niTri[vi]
        tjs = mesh.iTri[vi, :ni]
        d = np.linalg.norm(mesh.TriGC[tjs] - targets[k], axis=1)
        w = 1.0 / np.maximum(d, 1e-3) ** 2
        copy_inds[r, :ni] = tjs
        copy_w[r, :ni] = w / w.sum()
    return copy_inds, copy_w


def make_bc_data(C, mesh) -> _BCData:
    """Classify border-triangle rows by the configured velocity BCs
    (solve_linearised_SSA_DIVA_infinite_slab.f90:109-134,481-641)."""
    TriBI = calc_TriBI(mesh)
    sides = {"north": (1, 2), "east": (3, 4), "south": (5, 6), "west": (7, 8)}
    nTri = mesh.nTri
    masks = {f"{c}_{t}": np.zeros(nTri, bool)
             for c in ("u", "v") for t in ("zero", "inf", "per", "ice")}
    for side, codes in sides.items():
        on = np.isin(TriBI, codes)
        for comp in ("u", "v"):
            bc = getattr(C, f"BC_{comp}_{side}")
            if bc == "zero":
                masks[f"{comp}_zero"] |= on
            elif bc == "infinite":
                masks[f"{comp}_inf"] |= on
            elif bc == "periodic_ISMIP-HOM":
                masks[f"{comp}_per"] |= on
            elif bc == "infinite_SSA_icestream":
                masks[f"{comp}_ice"] |= on
            else:
                raise ValueError(f"unknown BC_{comp}_{side} '{bc}'")
    free = TriBI == 0

    # fixed-row copy tables (periodic ISMIP-HOM and SSA-icestream rows both
    # copy the previous solution from an interior point)
    fix_u = masks["u_per"] | masks["u_ice"]
    fix_v = masks["v_per"] | masks["v_ice"]
    rows = np.where(fix_u | fix_v)[0]
    gc = mesh.TriGC
    targets = gc[rows].copy()
    per_rows = (masks["u_per"] | masks["v_per"])[rows]
    ice_rows = (masks["u_ice"] | masks["v_ice"])[rows]
    L = C.refgeo_idealised_ISMIP_HOM_L
    # periodic: displace by -+L/2 toward the domain centre
    targets[per_rows, 0] += np.where(gc[rows][per_rows, 0] > 0, -L / 2, L / 2)
    targets[per_rows, 1] += np.where(gc[rows][per_rows, 1] > 0, -L / 2, L / 2)
    # icestream: copy from x = 1/3 or 2/3 across the domain, same y
    x13 = mesh.xmin + (mesh.xmax - mesh.xmin) / 3.0
    x23 = mesh.xmin + (mesh.xmax - mesh.xmin) * 2.0 / 3.0
    targets[ice_rows, 0] = np.where(gc[rows][ice_rows, 0] < 0, x13, x23)
    copy_inds, copy_w = _copy_tables(mesh, rows, targets)

    return _BCData(free, masks["u_zero"], masks["v_zero"],
                   masks["u_inf"], masks["v_inf"],
                   fix_u, fix_v, copy_inds, copy_w)


# ---------------------------------------------------------------------------
# The linearised momentum operator + preconditioner (module level so
# solver experiments can target the real operator; used by the viscosity
# iteration below)
# ---------------------------------------------------------------------------

def make_A(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b):
    """The matrix-free linearised SSA/DIVA momentum operator
    (solve_linearised_SSA_DIVA_infinite_slab.f90 rows): the five-operator
    derivative stack applied to (u, v), scaled by the per-triangle fields,
    BC rows 'infinite' (neighbour mean) or identity. On the card one
    launch of the kernel `diva_apply`, on the CPU its plain version.
    `A((u, v))` gives (Au, Av); `A.flat` is the same on the flat vector
    [u; v], which `gmres` takes when it is there."""
    stack = md.M2_stack
    return DivaOperator(stack.op, md.x("ssa_diva_rows"), N_b, dN_dx_b, dN_dy_b,
                        beta_eff_b,
                        round_x_bf16=stack.vals.dtype == torch.float32)


def make_precond(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b):
    """2x2 block-Jacobi: invert the per-triangle (u,v) diagonal block."""
    bc_free = md.x("ssa_bc_free")
    bc_inf_u = md.x("ssa_bc_inf_u")
    bc_inf_v = md.x("ssa_bc_inf_v")
    n_nbr = md.mask_TriC.sum(dim=1).to(N_b.dtype)
    d_ddx = md.x("ssa_d_ddx")
    d_ddy = md.x("ssa_d_ddy")
    d_dxx = md.x("ssa_d_dxx")
    d_dxy = md.x("ssa_d_dxy")
    d_dyy = md.x("ssa_d_dyy")
    auu = (4 * N_b * d_dxx + 4 * dN_dx_b * d_ddx
           + N_b * d_dyy + dN_dy_b * d_ddy - beta_eff_b)
    auv = 3 * N_b * d_dxy + 2 * dN_dx_b * d_ddy + dN_dy_b * d_ddx
    avu = 3 * N_b * d_dxy + 2 * dN_dy_b * d_ddx + dN_dx_b * d_ddy
    avv = (4 * N_b * d_dyy + 4 * dN_dy_b * d_ddy
           + N_b * d_dxx + dN_dx_b * d_ddx - beta_eff_b)
    # BC rows: diagonal is 1 (zero/periodic) or -n (infinite)
    one = torch.ones_like(auu)
    auu = torch.where(bc_free, auu, torch.where(bc_inf_u, -n_nbr, one))
    avv = torch.where(bc_free, avv, torch.where(bc_inf_v, -n_nbr, one))
    auv = torch.where(bc_free, auv, 0.0)
    avu = torch.where(bc_free, avu, 0.0)
    det = auu * avv - auv * avu
    det = torch.where(torch.abs(det) < 1e-300, 1e-300, det)

    def M(r):
        ru, rv = r
        return ((avv * ru - auv * rv) / det,
                (-avu * ru + auu * rv) / det)
    return M


# ---------------------------------------------------------------------------
# The solver factory
# ---------------------------------------------------------------------------

@dataclass
class _ViscCarry:
    u: torch.Tensor
    v: torch.Tensor
    u_base: torch.Tensor
    v_base: torch.Tensor
    tau_bx: torch.Tensor
    tau_by: torch.Tensor
    eta_3D_b: torch.Tensor
    beta_b_a: torch.Tensor      # a-grid friction coefficient
    F1_3D_b: torch.Tensor
    F2_b1: torch.Tensor         # F2 at base on b-grid
    relax: float
    eps_sq0: float
    L2: float
    n_diverg: int
    it: int
    n_axb: int
    done: bool


def register_ssadiva_static(C, mesh, md: MeshData):
    """Register the SSA/DIVA static per-triangle tables (BC row masks and
    the same packed for the operator's kernel, fixed-row copy tables,
    preconditioner diagonals) into md.extras."""
    if "ssa_bc_free" in md.extras:
        return
    precond_choice = getattr(C, "tpu_stress_balance_precond", "")
    if precond_choice not in ("", "block_jacobi"):
        raise NotImplementedError(
            f"tpu_stress_balance_precond '{precond_choice}' is not ported "
            "yet (ported: block_jacobi)")
    bc = make_bc_data(C, mesh)
    dt, dev = md.A.dtype, md.device
    ef = lambda a: EField(torch.as_tensor(a, device=dev), "Tri")
    md.extras.update({
        "ssa_bc_free": ef(bc.free),
        "ssa_bc_zero_u": ef(bc.zero_u), "ssa_bc_zero_v": ef(bc.zero_v),
        "ssa_bc_inf_u": ef(bc.inf_u), "ssa_bc_inf_v": ef(bc.inf_v),
        "ssa_bc_fix_u": ef(bc.fix_u), "ssa_bc_fix_v": ef(bc.fix_v),
        "ssa_copy_inds": EIndex(torch.as_tensor(bc.copy_inds,
                                                dtype=torch.int64,
                                                device=dev), "Tri", "Tri"),
        "ssa_copy_w": EField(torch.as_tensor(bc.copy_w, dtype=dt,
                                             device=dev), "Tri"),
    })
    md.extras["ssa_diva_rows"] = EField(DivaRows(
        md.TriC, md.mask_TriC, md.x("ssa_bc_free"), md.x("ssa_bc_inf_u"),
        md.x("ssa_bc_inf_v")), "Tri")
    ops = mesh.operators
    for name, M in [("ssa_d_ddx", ops.M2_ddx_b_b), ("ssa_d_ddy", ops.M2_ddy_b_b),
                    ("ssa_d_dxx", ops.M2_d2dx2_b_b),
                    ("ssa_d_dxy", ops.M2_d2dxdy_b_b),
                    ("ssa_d_dyy", ops.M2_d2dy2_b_b)]:
        md.extras[name] = EField(torch.as_tensor(M.diagonal(), dtype=dt,
                                                 device=dev), "Tri")
    md.ssa_has_fix = bool(bc.fix_u.any() or bc.fix_v.any())
    register_sliding_static(C, mesh, md)


def make_solve_ssa_diva(C, md: MeshData, choice: str, bedrock_cdfs=None):
    """Build the stress-balance solve function for SSA / DIVA / SIA+SSA.

    Returned fn(md, Hi, Hs, Hb, SL, Ti, s) ->
      (u_vav_b, v_vav_b, u_3D_b, v_3D_b, n_visc_its, n_Axb_its, aux).

    SIA/SSA is the SSA solve with the SIA velocities added to it (the
    reference's 'add' hybrid scheme). All per-entity static data lives in
    md.extras (registered above).
    """
    if choice not in ("SSA", "DIVA", "SIA/SSA"):
        raise ValueError(f"make_solve_ssa_diva: unknown choice '{choice}'")
    is_diva = choice == "DIVA"
    with_sia = choice == "SIA/SSA"
    krylov_restart = int(getattr(C, "tpu_stress_balance_krylov_restart", 60))
    if getattr(C, "BC_ice_front", "infinite_slab") == "ocean_pressure":
        raise NotImplementedError(
            "BC_ice_front 'ocean_pressure' is not ported yet")
    n_glen = C.Glens_flow_law_exponent
    no_sliding = C.choice_sliding_law == "no_sliding"
    if "ssa_bc_free" not in md.extras:
        register_ssadiva_static(C, md._host_mesh, md)
    has_fix = md.ssa_has_fix
    register_bedrock_cdfs(md, bedrock_cdfs)

    if not is_diva and no_sliding:
        # Pure SSA (or the SSA part of SIA/SSA) with no sliding: the SSA
        # velocity is identically zero and the reference skips the solve
        # entirely (SSA_main.f90:125-130). Solving with beta = 0 instead
        # would be a free-slip membrane - unbounded velocities.
        def solve_no_slip(md, Hi, Hs, Hb, SL, Ti, s):
            z_b = torch.zeros(md.nTri, dtype=md.A.dtype, device=md.device)
            z3 = torch.zeros((md.nTri, md.nz), dtype=md.A.dtype,
                             device=md.device)
            u_vav, v_vav, u_3D, v_3D = z_b, z_b, z3, z3
            if with_sia:
                masks = determine_masks(md, Hi, Hb, SL)
                A_flow = calc_ice_rheology_glen(
                    C, md, Hi, Hs, Ti, masks["mask_grounded_ice"],
                    masks["mask_floating_ice"])
                u3s, v3s, _, _, _, uvs, vvs = solve_SIA(C, md, Hi, Hs,
                                                        A_flow)
                u_vav, v_vav = u_vav + uvs, v_vav + vvs
                u_3D, v_3D = u_3D + u3s, v_3D + v3s
            return (u_vav, v_vav, u_3D, v_3D, 0, 0, s.solver_aux())
        return solve_no_slip

    def solve(md, Hi, Hs, Hb, SL, Ti, s):
        zeta = md.zeta
        nz = md.nz
        dtype = md.A.dtype
        dev = md.device
        nTri = md.nTri
        bc_free = md.x("ssa_bc_free")
        bc_fix_u = md.x("ssa_bc_fix_u")
        bc_fix_v = md.x("ssa_bc_fix_v")
        masks = determine_masks(md, Hi, Hb, SL)
        A_flow = calc_ice_rheology_glen(C, md, Hi, Hs, Ti,
                                        masks["mask_grounded_ice"],
                                        masks["mask_floating_ice"])
        fraction_gr, fraction_gr_b = calc_grounded_fractions(
            C, md, Hi, Hb, SL, masks["mask_floating_ice"], dHb=s.dHb)
        Hi_eff, _ = calc_effective_thickness(md, Hi, Hb, SL)
        # geometry gradients at FULL accuracy (ops.sparse.exact_mv:
        # bf16-rounded Hs is ~1e-3 absolute slope noise)
        Hs_slope = torch.sqrt(md.M_ddx_a_a.exact_matvec(Hs) ** 2
                              + md.M_ddy_a_a.exact_matvec(Hs) ** 2)

        # driving stress (SSA_DIVA_utilities.f90:24)
        Hi_b = md.M_map_a_b.exact_matvec(Hi)
        tau_dx_b = (-ice_density * grav * Hi_b
                    * md.M_ddx_a_b.exact_matvec(Hs))
        tau_dy_b = (-ice_density * grav * Hi_b
                    * md.M_ddy_a_b.exact_matvec(Hs))

        bed_roughness = _bed_roughness_fields(C, md, s.bed_roughness)

        Hi_reg = torch.clamp(Hi, min=0.1)
        b_u0 = torch.where(bc_free, -tau_dx_b, 0.0)
        b_v0 = torch.where(bc_free, -tau_dy_b, 0.0)
        # f32 floor: a relative residual below ~100*eps_f32 is not
        # reachable in single precision; the Picard loop tolerates the
        # looser inner solve (inexact-Newton argument)
        rtol = C.stress_balance_PETSc_rtol
        if dtype == torch.float32:
            rtol = max(rtol, 1e-5)

        def body(c: _ViscCarry) -> _ViscCarry:
            # horizontal strain rates on the a-grid
            du_dx_a = md.M_ddx_b_a @ c.u
            du_dy_a = md.M_ddy_b_a @ c.u
            dv_dx_a = md.M_ddx_b_a @ c.v
            dv_dy_a = md.M_ddy_b_a @ c.v

            # vertical shear strain rates (DIVA only; Lipscomb 2019 Eq. 36)
            if is_diva:
                eta_reg = torch.clamp(c.eta_3D_b, min=C.visc_eff_min)
                du_dz_b = c.tau_bx[:, None] * zeta[None, :] / eta_reg
                dv_dz_b = c.tau_by[:, None] * zeta[None, :] / eta_reg
                du_dz_a = md.M_map_b_a @ du_dz_b
                dv_dz_a = md.M_map_b_a @ dv_dz_b
            else:
                du_dz_a = torch.zeros_like(A_flow)
                dv_dz_a = torch.zeros_like(A_flow)

            # effective viscosity (Glen)
            A_min = 1e-18
            eta_max = 0.5 * A_min ** (-1.0 / n_glen) * \
                c.eps_sq0 ** ((1.0 - n_glen) / (2.0 * n_glen))
            eps_sq = (du_dx_a ** 2 + dv_dy_a ** 2 + du_dx_a * dv_dy_a
                      + 0.25 * (du_dy_a + dv_dx_a) ** 2)[:, None] \
                + 0.25 * (du_dz_a ** 2 + dv_dz_a ** 2) + c.eps_sq0
            eta_3D_a = 0.5 * A_flow ** (-1.0 / n_glen) * \
                eps_sq ** ((1.0 - n_glen) / (2.0 * n_glen))
            eta_3D_a = torch.clamp(eta_3D_a, C.visc_eff_min, eta_max)
            eta_3D_b = md.M_map_a_b @ eta_3D_a
            eta_vav_a = vertical_average(zeta, eta_3D_a, axis=-1)
            N_a = eta_vav_a * Hi_reg
            N_b = md.M_map_a_b @ N_a
            dN_dx_b = md.M_ddx_a_b @ N_a
            dN_dy_b = md.M_ddy_a_b @ N_a

            # F-integrals (Lipscomb 2019 Eq. 30) and effective friction
            if is_diva:
                zz = zeta.expand(eta_3D_a.shape)
                F1_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                    zz, zeta[None, :] / eta_3D_a, axis=-1)
                F2_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                    zz, zeta[None, :] ** 2 / eta_3D_a, axis=-1)
                F1_3D_b = md.M_map_a_b @ F1_3D_a
                F2_a1 = F2_3D_a[:, 0].contiguous()
                F2_b1 = md.M_map_a_b @ F2_a1
            else:
                F1_3D_b = c.F1_3D_b
                F2_b1 = torch.zeros_like(N_b)
                F2_a1 = torch.zeros_like(N_a)

            # sliding law -> a-grid friction coefficient
            u_base_a = md.M_map_b_a @ c.u_base
            v_base_a = md.M_map_b_a @ c.v_base
            beta_b_a = calc_basal_friction_coefficient(
                C, md, bed_roughness, u_base_a, v_base_a, Hi, Hi_eff, Hb, SL,
                Hs_slope, fraction_gr, masks)

            if is_diva:
                if no_sliding:
                    beta_eff_a = 1.0 / torch.clamp(F2_a1, min=1e-30)
                else:
                    beta_eff_a = beta_b_a / (1.0 + beta_b_a * F2_a1)
            else:
                beta_eff_a = beta_b_a
            beta_eff_b = md.M_map_a_b @ beta_eff_a
            beta_b_b = md.M_map_a_b @ beta_b_a
            if C.do_GL_subgrid_friction:
                beta_eff_b = beta_eff_b * \
                    fraction_gr_b ** C.subgrid_friction_exponent_on_B_grid

            # linear solve (matrix-free GMRES)
            A = make_A(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b)
            M = make_precond(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b)
            b_u, b_v = b_u0, b_v0
            if has_fix:
                # fixed rows: relaxed weighted copy of the previous solution
                # (find_ti_copy_* BCs)
                copy_inds = md.x("ssa_copy_inds")
                copy_w = md.x("ssa_copy_w")
                u_fix = (copy_w * c.u[copy_inds]).sum(dim=1)
                v_fix = (copy_w * c.v[copy_inds]).sum(dim=1)
                u_fix = C.visc_it_relax * u_fix + (1 - C.visc_it_relax) * c.u
                v_fix = C.visc_it_relax * v_fix + (1 - C.visc_it_relax) * c.v
                b_u = torch.where(bc_fix_u, u_fix, b_u)
                b_v = torch.where(bc_fix_v, v_fix, b_v)
            res = gmres(A, (b_u, b_v), x0=(c.u, c.v), M=M,
                        rtol=rtol,
                        abstol=C.stress_balance_PETSc_abstol,
                        restart=krylov_restart)
            u_new, v_new = res.x

            # velocity limits + relaxation
            speed = torch.sqrt(u_new ** 2 + v_new ** 2)
            lim = torch.where(speed > C.vel_max, C.vel_max / speed, 1.0)
            u_new, v_new = u_new * lim, v_new * lim
            u_new = c.relax * u_new + (1 - c.relax) * c.u
            v_new = c.relax * v_new + (1 - c.relax) * c.v

            # basal velocities + stress
            if is_diva:
                if no_sliding:
                    u_base = torch.zeros_like(u_new)
                    v_base = torch.zeros_like(v_new)
                else:
                    u_base = u_new / (1.0 + beta_b_b * F2_b1)
                    v_base = v_new / (1.0 + beta_b_b * F2_b1)
            else:
                u_base, v_base = u_new, v_new
            tau_bx = u_new * beta_eff_b
            tau_by = v_new * beta_eff_b

            # convergence: L2 norm of change (calc_L2_norm_uv)
            res1 = comm.sum_all((u_new - c.u) ** 2 + (v_new - c.v) ** 2)
            res2 = comm.sum_all((u_new + c.u) ** 2 + (v_new + c.v) ** 2)
            L2 = float(2.0 * res1 / torch.clamp(res2, min=1e-8))

            diverged = L2 > c.L2
            n_div = c.n_diverg + 1 if diverged else 0
            do_rescue = n_div > 2
            relax = c.relax * 0.9 if do_rescue else c.relax
            eps_sq0 = c.eps_sq0 * 1.2 if do_rescue else c.eps_sq0
            n_div = 0 if do_rescue else n_div

            converged = L2 < C.visc_it_norm_dUV_tol
            return _ViscCarry(
                u=u_new, v=v_new, u_base=u_base, v_base=v_base,
                tau_bx=tau_bx, tau_by=tau_by, eta_3D_b=eta_3D_b,
                beta_b_a=beta_b_a, F1_3D_b=F1_3D_b, F2_b1=F2_b1,
                relax=relax, eps_sq0=eps_sq0, L2=L2, n_diverg=n_div,
                it=c.it + 1, n_axb=c.n_axb + res.n_iter, done=converged)

        c = _ViscCarry(
            u=s.u_vav_b, v=s.v_vav_b,
            # warm-start basal velocities from the stored 3-D profile
            # (base layer = u_base by the Lipscomb Eq. 29 reconstruction;
            # the reference keeps DIVA%u_base_b persistent). A zero init
            # makes the sliding law return enormous friction at it 0
            # (beta ~ |u|^(1/m - 1) -> inf), so the first solve of EVERY
            # step collapses the velocity field and the relax=0.2 loop
            # spends ~20 its recovering it.
            u_base=s.u_3D_b[:, -1].contiguous(),
            v_base=s.v_3D_b[:, -1].contiguous(),
            # warm-start the DIVA vertical-shear feedback from the
            # previous step's converged tau_b / eta (the reference keeps
            # these in the persistent DIVA solver state): without it
            # iteration 0 sees du/dz = 0 and the relax=0.2 Picard loop
            # spends ~20 iterations re-converging the feedback EVERY step
            tau_bx=s.visc_tau_bx, tau_by=s.visc_tau_by,
            eta_3D_b=torch.clamp(s.visc_eta_3D_b.to(dtype),
                                 min=C.visc_eff_min),
            beta_b_a=torch.zeros(md.nV, dtype=dtype, device=dev),
            F1_3D_b=torch.zeros((nTri, nz), dtype=dtype, device=dev),
            F2_b1=torch.zeros(nTri, dtype=dtype, device=dev),
            relax=float(C.visc_it_relax),
            eps_sq0=float(C.Glens_flow_law_epsilon_sq_0),
            L2=1e9, n_diverg=0, it=0, n_axb=0, done=False)
        while (not c.done) and c.it <= C.visc_it_nit:
            c = body(c)
        out = c

        # 3-D velocities (Lipscomb 2019 Eq. 29)
        if is_diva:
            beta_b_b = md.M_map_a_b @ out.beta_b_a
            if no_sliding:
                u_3D = out.tau_bx[:, None] * out.F1_3D_b
                v_3D = out.tau_by[:, None] * out.F1_3D_b
            else:
                u_3D = out.u_base[:, None] * (1.0 + beta_b_b[:, None]
                                              * out.F1_3D_b)
                v_3D = out.v_base[:, None] * (1.0 + beta_b_b[:, None]
                                              * out.F1_3D_b)
        else:
            u_3D = out.u[:, None].expand(md.nTri, nz).contiguous()
            v_3D = out.v[:, None].expand(md.nTri, nz).contiguous()

        u_vav, v_vav = out.u, out.v

        if with_sia:
            # hybrid SIA+SSA 'add' scheme (choice_hybrid_SIASSA_scheme)
            u3_sia, v3_sia, _, _, _, uv_sia, vv_sia = solve_SIA(
                C, md, Hi, Hs, A_flow)
            u_vav = u_vav + uv_sia
            v_vav = v_vav + vv_sia
            u_3D = u_3D + u3_sia
            v_3D = v_3D + v3_sia

        aux = {"visc_tau_bx": out.tau_bx, "visc_tau_by": out.tau_by,
               "visc_eta_3D_b": out.eta_3D_b}
        return (u_vav, v_vav, u_3D, v_3D, out.it, out.n_axb, aux)

    return solve


def _bed_roughness_fields(C, md: MeshData, generic=None):
    """Bed roughness fields per sliding law (reference bed_roughness
    model). `generic` is the (possibly nudged) per-vertex roughness
    parameter carried in IceState; when zero/None the uniform config
    values apply."""
    nV = md.nV
    dtype = md.A.dtype
    dev = md.device
    law = C.choice_sliding_law
    beta_sq = {"Weertman": C.slid_Weertman_beta_sq_uniform,
               "Tsai2015": C.slid_Tsai2015_beta_sq_uniform,
               "Schoof2005": C.slid_Schoof2005_beta_sq_uniform,
               }.get(law, C.slid_Weertman_beta_sq_uniform)
    phi = {"Coulomb": C.slid_Coulomb_phi_fric_uniform,
           "Budd": C.slid_Budd_phi_fric_uniform,
           "Zoet-Iverson": C.slid_ZI_phi_fric_uniform,
           }.get(law, C.slid_Budd_phi_fric_uniform)
    alpha_sq = {"Tsai2015": C.slid_Tsai2015_alpha_sq_uniform,
                "Schoof2005": C.slid_Schoof2005_alpha_sq_uniform,
                }.get(law, 0.5)
    full = lambda v: torch.full((nV,), v, dtype=dtype, device=dev)
    beta_sq_f = full(beta_sq)
    phi_f = full(phi)
    if generic is not None:
        use = generic > 0
        if law in ("Weertman", "Tsai2015", "Schoof2005"):
            beta_sq_f = torch.where(use, generic, beta_sq_f)
        else:
            phi_f = torch.where(use, generic, phi_f)
    return {
        "beta_sq": beta_sq_f,
        "till_friction_angle": phi_f,
        "alpha_sq": full(alpha_sq),
    }
