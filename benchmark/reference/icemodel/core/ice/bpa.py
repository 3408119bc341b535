"""BPA (Blatter-Pattyn approximation) 3-D stress balance, matrix-free.

Counterpart of the reference's core/ice/bpa.py (itself a re-design of
src/UFEMISM/ice_dynamics/conservation_of_momentum/BPA/BPA_main.f90): the
3-D momentum operator

  u-row: 4 eta uxx + 4 eta_x ux + eta uyy + eta_y uy + eta uzz + eta_z uz
       + 3 eta vxy + 2 eta_x vy + eta_y vx  = -tau_dx   (tau = rho g grad h)

acts on (u, v) fields [nTri, nz], its physical derivatives composed
matrix-free from the b-grid stencil of the M2 operators, zeta differences
and the dzeta/dx cross terms; the zero-stress surface row and the sliding
base row eliminate their ghost points (BPA_main.f90:648-1165), the lateral
rows are identity ('zero') or neighbour-mean rows (every other choice,
'periodic_ISMIP-HOM' included, as in the reference). One apply is the
kernel `bpa_apply` (ops/cuda_bpa.py, two launches); the vertical-line
preconditioner, the exact per-column tridiagonal of the vertical terms,
the surface and base rows and the horizontal operators' diagonal, is the
kernel `line_thomas` (one launch for both components). The viscosity
iteration with its relaxation rescue is a host loop over device work, as
in ssadiva.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh_data import MeshData, EField
from ...parallel import comm
from ...utils.constants import ice_density, grav
from ...mesh.zeta import vertical_average
from ...ops.cuda_bpa import (BpaCoeffs, BpaOperator, LineThomas,
                             ddzeta_plain, zeta_consts)
from ...ops.cuda_spmv import DivaRows
from ...ops.krylov import (gmres, estimate_lambda_max,
                           make_chebyshev_preconditioner,
                           make_neumann_preconditioner)
from .masks import determine_masks
from .rheology import calc_ice_rheology_glen
from .subgrid import (calc_grounded_fractions, calc_effective_thickness,
                      register_bedrock_cdfs)
from .sliding import calc_basal_friction_coefficient, register_sliding_static
from .ssadiva import calc_TriBI, _bed_roughness_fields


def register_bpa_static(C, mesh, md: MeshData):
    """The BPA's static tables in md.extras: the lateral row tables
    (bpa.py:76-94 of the reference: a side whose BC is 'zero' gives
    identity rows, every other choice neighbour-mean rows) packed for the
    kernel, and the diagonals of the M2 operators that the line
    preconditioner adds (bpa.py:101-107)."""
    if "bpa_rows" in md.extras:
        return
    TriBI = calc_TriBI(mesh)
    sides = {"north": (1, 2), "east": (3, 4), "south": (5, 6), "west": (7, 8)}
    zero = {c: np.zeros(mesh.nTri, bool) for c in ("u", "v")}
    for side, codes in sides.items():
        on = np.isin(TriBI, codes)
        for comp in ("u", "v"):
            if getattr(C, f"BC_{comp}_{side}") == "zero":
                zero[comp] |= on
    dev, dt = md.device, md.A.dtype
    b = lambda a: torch.as_tensor(a, device=dev)
    md.extras["bpa_rows"] = EField(DivaRows(
        md.TriC, md.mask_TriC, b(TriBI == 0), b(~zero["u"]),
        b(~zero["v"])), "Tri")
    ops = mesh.operators
    for name, M in (("bpa_d_ddx", ops.M2_ddx_b_b), ("bpa_d_ddy", ops.M2_ddy_b_b),
                    ("bpa_d_dxx", ops.M2_d2dx2_b_b),
                    ("bpa_d_dyy", ops.M2_d2dy2_b_b)):
        md.extras[name] = EField(torch.as_tensor(M.diagonal(), dtype=dt,
                                                 device=dev), "Tri")
    register_sliding_static(C, mesh, md)


@dataclass
class _BPACarry:
    u: torch.Tensor
    v: torch.Tensor
    relax: float
    eps_sq0: float
    L2: float
    n_diverg: int
    it: int
    n_axb: int
    done: bool


class BpaGeometry:
    """The fields of one solve that depend on the geometry alone (the
    reference's solve before its loop, bpa.py:125-165): zeta gradients,
    slopes, the driving stress, the zeta divisors, and the derivative
    closures ddx, ddy, ddz on [n, nz] fields."""

    def __init__(self, md, Hi, Hs, dzeta):
        zeta = md.zeta
        self.md = md
        self.consts = zeta_consts(dzeta, md.A.dtype, md.device)[1]
        self.dzeta = dzeta
        dz_t = self.consts[0]
        self.Hi_b = torch.clamp(md.M_map_a_b.exact_matvec(Hi), min=0.1)
        self.dh_dx_b = md.M_ddx_a_b.exact_matvec(Hs)
        self.dh_dy_b = md.M_ddy_a_b.exact_matvec(Hs)
        self.db_dx_b = md.M_ddx_a_b.exact_matvec(Hs - Hi)
        self.db_dy_b = md.M_ddy_a_b.exact_matvec(Hs - Hi)
        self.tau_dx = -ice_density * grav * self.dh_dx_b
        self.tau_dy = -ice_density * grav * self.dh_dy_b
        dHi_dx_b = md.M_ddx_a_b.exact_matvec(Hi)
        dHi_dy_b = md.M_ddy_a_b.exact_matvec(Hi)
        Hi_b = self.Hi_b
        self.zz_b = -1.0 / Hi_b                                # dzeta/dz
        self.zx_b = (self.dh_dx_b[:, None] - zeta[None, :]
                     * dHi_dx_b[:, None]) / Hi_b[:, None]      # dzeta/dx
        self.zy_b = (self.dh_dy_b[:, None] - zeta[None, :]
                     * dHi_dy_b[:, None]) / Hi_b[:, None]
        self.zz2 = self.zz_b ** 2
        # (dzeta/dz)^2 * 2/dzeta^2, and the surface row's dzeta / zz
        self.Q_fac = 2.0 / dzeta ** 2 * self.zz2
        self.dzz = dz_t / self.zz_b

    def ddzeta(self, f):
        return ddzeta_plain(f, self.consts[0], self.consts[1])

    def ddx(self, f):
        return self.md.M2_ddx_b_b @ f + self.zx_b * self.ddzeta(f)

    def ddy(self, f):
        return self.md.M2_ddy_b_b @ f + self.zy_b * self.ddzeta(f)

    def ddz(self, f):
        return self.zz_b[:, None] * self.ddzeta(f)

    def base_rows(self, eta, eta_z, beta_b, eta_base):
        """Q, R and beta / eta_base of the sliding base row
        (bpa.py:252-259)."""
        kb = eta.shape[1] - 1
        qb = self.Q_fac * eta[:, kb]
        rb = 2 * eta[:, kb] / self.consts[0] * self.zz_b + eta_z[:, kb]
        return qb, rb, beta_b / eta_base

    def coeffs(self, eta, eta_x, eta_y, eta_z, beta_b, eta_base):
        """The BpaCoeffs of the operator of one viscosity iteration."""
        qb, rb, ratio = self.base_rows(eta, eta_z, beta_b, eta_base)
        return BpaCoeffs(self.zx_b, self.zy_b, eta, eta_x, eta_y, eta_z,
                         self.zz_b, self.zz2, self.dh_dx_b, self.dh_dy_b,
                         self.db_dx_b, self.db_dy_b, self.dzz, self.Q_fac,
                         qb, rb, ratio)

    def line_bands(self, md, eta, eta_x, eta_y, eta_z, beta_b, eta_base,
                   free, no_sliding):
        """(sub, dia, sup) of the vertical-line preconditioner
        (bpa.py:300-323): the vertical diffusion, the surface and base rows
        and the horizontal operators' diagonal; identity on the lateral
        rows."""
        dz_t, two_dz, dz2 = self.consts
        zz_b, Q_fac = self.zz_b, self.Q_fac
        zz2 = (zz_b ** 2 / dz2)[:, None]
        ez_zz = (eta_z * zz_b[:, None]) / two_dz
        H_diag = (4 * eta * md.x("bpa_d_dxx")[:, None]
                  + eta * md.x("bpa_d_dyy")[:, None]
                  + 4 * eta_x * md.x("bpa_d_ddx")[:, None]
                  + eta_y * md.x("bpa_d_ddy")[:, None])
        sub = eta[:, 1:] * zz2 - ez_zz[:, 1:]     # coefficient of u[k-1]
        sup = eta[:, :-1] * zz2 + ez_zz[:, :-1]   # coefficient of u[k+1]
        dia = -2.0 * eta * zz2 + H_diag
        # surface row (k = 0): eta0 * Q_fac * (u1 - u0)
        dia[:, 0] = -eta[:, 0] * Q_fac + H_diag[:, 0]
        sup[:, 0] = eta[:, 0] * Q_fac
        # base row: Q (u[kb-1] - u[kb]) + R beta / eta_base u[kb]
        Qb = Q_fac * eta[:, -1]
        Rb = 2 * eta[:, -1] / dz_t * zz_b + eta_z[:, -1]
        dia[:, -1] = -Qb + Rb * beta_b / eta_base + H_diag[:, -1]
        sub[:, -1] = Qb
        if no_sliding:
            dia[:, -1] = 1.0
            sub[:, -1] = 0.0
        # lateral rows: identity over the whole column
        f = free[:, None]
        return (torch.where(f, sub, 0.0), torch.where(f, dia, 1.0),
                torch.where(f, sup, 0.0))


def viscosity_3d(C, geo: BpaGeometry, A_flow, u3, v3, eps_sq0):
    """The effective viscosity of the 3-D field on the b-grid and its
    derivatives (bpa.py:169-193): (eta, eta_x, eta_y, eta_z, eta_a)."""
    md, n_glen = geo.md, C.Glens_flow_law_exponent
    to_a = lambda f: md.M_map_b_a @ f
    ux_a, uy_a = to_a(geo.ddx(u3)), to_a(geo.ddy(u3))
    vx_a, vy_a = to_a(geo.ddx(v3)), to_a(geo.ddy(v3))
    uz_a, vz_a = to_a(geo.ddz(u3)), to_a(geo.ddz(v3))
    eps_sq = (ux_a ** 2 + vy_a ** 2 + ux_a * vy_a
              + 0.25 * (uy_a + vx_a) ** 2
              + 0.25 * (uz_a ** 2 + vz_a ** 2) + eps_sq0)
    A_min = 1e-18
    eta_max = 0.5 * A_min ** (-1.0 / n_glen) * \
        eps_sq0 ** ((1.0 - n_glen) / (2.0 * n_glen))
    eta_a = 0.5 * A_flow ** (-1.0 / n_glen) * \
        eps_sq ** ((1.0 - n_glen) / (2.0 * n_glen))
    eta_a = torch.clamp(eta_a, C.visc_eff_min, eta_max)
    eta = md.M_map_a_b @ eta_a
    return eta, geo.ddx(eta), geo.ddy(eta), geo.ddz(eta), eta_a


def krylov_preconditioner(kind, A, M, degree, b):
    """The preconditioner of the BPA and hybrid solves (bpa.py:346-354):
    Chebyshev or Neumann acceleration of the base preconditioner M, and M
    alone for every other name, the schema's block_jacobi and
    block_dense and two_level among them, as in the reference."""
    if kind == "chebyshev":
        lam = estimate_lambda_max(lambda w: M(A(w)), b, n_its=10)
        return make_chebyshev_preconditioner(A, M, degree, lam)
    if kind == "neumann":
        return make_neumann_preconditioner(A, M, degree)
    return M


def relax_step(C, c, res1, res2):
    """The viscosity loop's relaxation rescue (bpa.py:367-376): (L2,
    n_diverg, relax, eps_sq0, converged) after an iteration whose change
    and sum have the squared norms res1 and res2."""
    L2 = float(2.0 * res1 / torch.clamp(res2, min=1e-8))
    n_div = c.n_diverg + 1 if L2 > c.L2 else 0
    do_rescue = n_div > 2
    relax = c.relax * 0.9 if do_rescue else c.relax
    eps_sq0 = c.eps_sq0 * 1.2 if do_rescue else c.eps_sq0
    n_div = 0 if do_rescue else n_div
    return L2, n_div, relax, eps_sq0, L2 < C.visc_it_norm_dUV_tol


def limit_speed(C, u, v):
    """(u, v) scaled down where their speed exceeds vel_max."""
    speed = torch.sqrt(u ** 2 + v ** 2)
    lim = torch.where(speed > C.vel_max, C.vel_max / speed, 1.0)
    return u * lim, v * lim


def make_solve_bpa(C, md: MeshData, bedrock_cdfs=None):
    """Build solve(md, Hi, Hs, Hb, SL, Ti, s) -> (u_vav_b, v_vav_b, u_3D_b,
    v_3D_b, n_visc_its, n_Axb_its) for the BPA."""
    precond_kind = C.tpu_stress_balance_precond
    precond_deg = int(C.tpu_stress_balance_precond_degree)
    krylov_restart = int(C.tpu_stress_balance_krylov_restart)
    no_sliding = C.choice_sliding_law == "no_sliding"
    mesh = md._host_mesh
    zeta_h = np.asarray(mesh.zeta)
    dzeta = float(zeta_h[1] - zeta_h[0])
    register_bpa_static(C, mesh, md)
    register_bedrock_cdfs(md, bedrock_cdfs)

    def solve(md, Hi, Hs, Hb, SL, Ti, s):
        dtype, nz = md.A.dtype, md.nz
        rows = md.x("bpa_rows")
        free = rows.free
        masks = determine_masks(md, Hi, Hb, SL)
        A_flow = calc_ice_rheology_glen(C, md, Hi, Hs, Ti,
                                        masks["mask_grounded_ice"],
                                        masks["mask_floating_ice"])
        fraction_gr, fraction_gr_b = calc_grounded_fractions(
            C, md, Hi, Hb, SL, masks["mask_floating_ice"], dHb=s.dHb)
        Hi_eff, _ = calc_effective_thickness(md, Hi, Hb, SL)
        # geometry gradients at full accuracy (ops.sparse.exact_mv)
        Hs_slope = torch.sqrt(md.M_ddx_a_a.exact_matvec(Hs) ** 2
                              + md.M_ddy_a_a.exact_matvec(Hs) ** 2)
        bed_roughness = _bed_roughness_fields(C, md, s.bed_roughness)
        geo = BpaGeometry(md, Hi, Hs, dzeta)

        b_u = torch.where(free[:, None], -geo.tau_dx[:, None], 0.0) \
            .expand(md.nTri, nz).contiguous()
        b_v = torch.where(free[:, None], -geo.tau_dy[:, None], 0.0) \
            .expand(md.nTri, nz).contiguous()
        if no_sliding:
            b_u[:, nz - 1] = 0.0
            b_v[:, nz - 1] = 0.0
        # f32 floor: a relative residual below ~100 eps_f32 is not
        # reachable in single precision
        rtol = C.stress_balance_PETSc_rtol
        if dtype == torch.float32:
            rtol = max(rtol, 1e-5)

        def body(c: _BPACarry) -> _BPACarry:
            eta, eta_x, eta_y, eta_z, _ = viscosity_3d(C, geo, A_flow, c.u,
                                                       c.v, c.eps_sq0)
            # the sliding law on the a-grid from the basal layer
            u_base_a = md.M_map_b_a @ c.u[:, nz - 1].contiguous()
            v_base_a = md.M_map_b_a @ c.v[:, nz - 1].contiguous()
            beta_a = calc_basal_friction_coefficient(
                C, md, bed_roughness, u_base_a, v_base_a, Hi, Hi_eff, Hb,
                SL, Hs_slope, fraction_gr, masks)
            beta_b = md.M_map_a_b @ beta_a
            if C.do_GL_subgrid_friction:
                beta_b = beta_b * \
                    fraction_gr_b ** C.subgrid_friction_exponent_on_B_grid
            eta_base = torch.clamp(eta[:, nz - 1], min=C.visc_eff_min)

            A = BpaOperator(md.M2_stack.op, rows,
                            geo.coeffs(eta, eta_x, eta_y, eta_z, beta_b,
                                       eta_base),
                            dzeta, no_sliding,
                            round_x_bf16=dtype == torch.float32)
            M_pre = LineThomas(*geo.line_bands(md, eta, eta_x, eta_y, eta_z,
                                               beta_b, eta_base, free,
                                               no_sliding))
            Mp = krylov_preconditioner(precond_kind, A, M_pre, precond_deg,
                                       (b_u, b_v))
            res = gmres(A, (b_u, b_v), x0=(c.u, c.v), M=Mp, rtol=rtol,
                        abstol=C.stress_balance_PETSc_abstol,
                        restart=krylov_restart)
            u_new, v_new = limit_speed(C, *res.x)
            u_new = c.relax * u_new + (1 - c.relax) * c.u
            v_new = c.relax * v_new + (1 - c.relax) * c.v

            res1 = comm.sum_all((u_new - c.u) ** 2 + (v_new - c.v) ** 2)
            res2 = comm.sum_all((u_new + c.u) ** 2 + (v_new + c.v) ** 2)
            L2, n_div, relax, eps_sq0, converged = relax_step(
                C, c, res1, res2)
            return _BPACarry(u=u_new, v=v_new, relax=relax, eps_sq0=eps_sq0,
                             L2=L2, n_diverg=n_div, it=c.it + 1,
                             n_axb=c.n_axb + res.n_iter, done=converged)

        c = _BPACarry(u=s.u_3D_b.contiguous(), v=s.v_3D_b.contiguous(),
                      relax=float(C.visc_it_relax),
                      eps_sq0=float(C.Glens_flow_law_epsilon_sq_0),
                      L2=1e9, n_diverg=0, it=0, n_axb=0, done=False)
        while (not c.done) and c.it <= C.visc_it_nit:
            c = body(c)

        u_vav = vertical_average(md.zeta, c.u, axis=-1)
        v_vav = vertical_average(md.zeta, c.v, axis=-1)
        return (u_vav, v_vav, c.u, c.v, c.it, c.n_axb)

    return solve
