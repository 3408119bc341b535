"""3-D thermodynamics: englacial heat equation on the zeta grid.

Counterpart of the reference's core/ice/thermodynamics.py (re-design of
src/UFEMISM/thermodynamics/): the per-vertex implicit vertical solves with
per-vertex time-step halving (thermodynamics_3D_heat_equation.f90:34-50)
over all columns at once. The coefficient fields of the heat equation are
formed here in plain tensor code; the column solves - the stability
ladder dt, dt/2 x2, ..., dt/16 x16 with both basal boundary conditions,
the choice of each column's first stable level and the Robin (1955)
fallback for columns that are stable at none - are one launch of the
hand-written kernel `heat_columns` (ops/cuda_heat.py) on the card, and its
plain version on the host.

Precision follows the reference's dtype flow exactly: the zeta operator
rows and the uniform geothermal flux are float64, so in float32 mode the
tridiagonal systems are formed and solved in float64 from float32 fields
(ops/cuda_heat.py says where each substep rounds), and run_thermodynamics
casts the result back to the run's type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mesh_data import MeshData, EField, EIndex, map_b_to_c
from ...utils.constants import (ice_density, seawater_density, T0,
                                Clausius_Clapeyron_gradient, sec_per_year, pi)
from ...ops.tridiag import zeta_tridiag_operators
from ...ops.cuda_heat import heat_columns, zeta_rows
from .masks import determine_masks
from .subgrid import calc_grounded_fractions_bilin_TAF


def register_thermo_static(md: MeshData):
    """Static per-vertex upwind-sector tables (host build, numpy).

    The upwind-triangle search of calc_upwind_heat_flux needs, per
    (vertex, neighbour-sector c): the sector edge vectors vi->C[c] and
    vi->C[c+1], whether the wrap sector exists, and the triangle spanned
    by (vi, C[c], C[c+1]) (= the triangle left of the directed edge
    vi->C[c], via VE/EV/ETri). All of that is mesh connectivity, so it is
    built once here, in the run's type, and registered in md.extras.
    """
    if md.extras is None or "th_ab_x" in md.extras:
        return
    host = lambda t: t.detach().cpu().numpy()
    V, C, mask_C = host(md.V), host(md.C), host(md.mask_C)
    VBI, VE, EV, ETri = host(md.VBI), host(md.VE), host(md.EV), host(md.ETri)
    nV, K = C.shape
    Cp = np.where(mask_C, C, 0)
    ab_x = np.where(mask_C, V[Cp, 0] - V[:, 0:1], 0.0)
    ab_y = np.where(mask_C, V[Cp, 1] - V[:, 1:2], 0.0)
    nC = mask_C.sum(axis=1)
    ks = np.arange(K)[None, :]
    nxt = np.where(ks + 1 < nC[:, None], ks + 1, 0)
    ac_x = np.take_along_axis(ab_x, nxt, axis=1)
    ac_y = np.take_along_axis(ab_y, nxt, axis=1)
    interior = (VBI == 0)[:, None]
    has_wrap = interior | (ks + 1 < nC[:, None])
    e = VE
    canon_first = EV[e, 0] == np.arange(nV)[:, None]
    tri_left = np.where(canon_first, ETri[e, 0], ETri[e, 1])
    tri_sector = np.maximum(tri_left, 0)
    kw = dict(dtype=md.A.dtype, device=md.device)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), **kw)
    md.extras.update({
        "th_ab_x": EField(f(ab_x), "V"),
        "th_ab_y": EField(f(ab_y), "V"),
        "th_ac_x": EField(f(ac_x), "V"),
        "th_ac_y": EField(f(ac_y), "V"),
        "th_has_wrap": EField(torch.as_tensor(has_wrap, device=md.device),
                              "V"),
        "th_tri_sector": EIndex(torch.as_tensor(
            tri_sector, dtype=torch.int64, device=md.device), "V", "Tri"),
    })


# -- material properties (thermodynamics_utilities.f90) ----------------------

def calc_heat_capacity(C, Ti):
    if C.choice_ice_heat_capacity == "uniform":
        return torch.full_like(Ti, C.uniform_ice_heat_capacity)
    if C.choice_ice_heat_capacity == "Pounder1965":
        return 2115.3 + 7.79293 * (Ti - T0)
    raise ValueError(f"unknown choice_ice_heat_capacity "
                     f"'{C.choice_ice_heat_capacity}'")


def calc_thermal_conductivity(C, Ti):
    if C.choice_ice_thermal_conductivity == "uniform":
        return torch.full_like(Ti, C.uniform_ice_thermal_conductivity)
    if C.choice_ice_thermal_conductivity == "Ritz1987":
        return 3.101e8 * torch.exp(-0.0057 * Ti)
    raise ValueError(f"unknown choice_ice_thermal_conductivity "
                     f"'{C.choice_ice_thermal_conductivity}'")


def calc_pressure_melting_point(md, Hi_eff):
    """Ti_pmp[vi,k] = T0 - CC * Hi_eff * zeta (Huybrechts 1992)."""
    return T0 - Clausius_Clapeyron_gradient * Hi_eff[:, None] \
        * md.zeta[None, :]


def calc_zeta_gradients(md: MeshData, Hi, Hs, dHi_dt, dHs_dt):
    """dzeta/dx, dy, dz, dt on the a-grid x nz (zeta_gradients.f90)."""
    Hi_r = torch.clamp(Hi, min=0.1)
    dHi_dx = md.M_ddx_a_a @ Hi
    dHi_dy = md.M_ddy_a_a @ Hi
    dHs_dx = md.M_ddx_a_a @ Hs
    dHs_dy = md.M_ddy_a_a @ Hs
    z = md.zeta[None, :]
    inv_H = (1.0 / Hi_r)[:, None]
    dzeta_dx = inv_H * (dHs_dx[:, None] - z * dHi_dx[:, None])
    dzeta_dy = inv_H * (dHs_dy[:, None] - z * dHi_dy[:, None])
    dzeta_dz = -inv_H * torch.ones_like(z)
    dzeta_dt = inv_H * (dHs_dt[:, None] - z * dHi_dt[:, None])
    return dzeta_dx, dzeta_dy, dzeta_dz, dzeta_dt


# -- heating terms -----------------------------------------------------------

def calc_strain_heating(C, md: MeshData, masks, A_flow, u_3D_b, v_3D_b, w_3D):
    """Internal (strain) heating Phi [J kg^-1 yr^-1]
    (thermodynamics_utilities.f90:60-84)."""
    n = C.Glens_flow_law_exponent
    du_dx = md.M_ddx_b_a @ u_3D_b
    du_dy = md.M_ddy_b_a @ u_3D_b
    dv_dx = md.M_ddx_b_a @ v_3D_b
    dv_dy = md.M_ddy_b_a @ v_3D_b
    dw_dx = md.M_ddx_a_a @ w_3D
    dw_dy = md.M_ddy_a_a @ w_3D
    # vertical gradients via simple zeta differences (unit spacing, as
    # numpy.gradient)
    dz = torch.gradient(md.zeta)[0]
    du_dz = torch.gradient(md.M_map_b_a @ u_3D_b, dim=1)[0] / dz[None, :]
    dv_dz = torch.gradient(md.M_map_b_a @ v_3D_b, dim=1)[0] / dz[None, :]
    dw_dz = torch.gradient(w_3D, dim=1)[0] / dz[None, :]
    D = torch.sqrt(0.5 * (du_dx ** 2 + dv_dy ** 2 + dw_dz ** 2
                          + 0.5 * (du_dy + dv_dx) ** 2
                          + 0.5 * (du_dz + dw_dx) ** 2
                          + 0.5 * (dv_dz + dw_dy) ** 2))
    Phi = 2.0 * A_flow ** (-1.0 / n) * D ** (1.0 / n + 1.0)
    has_ice = masks["mask_grounded_ice"] | masks["mask_floating_ice"]
    return torch.where(has_ice[:, None], Phi, 0.0)


def calc_frictional_heating(masks, beta_a, uabs_base_a):
    """Frictional heating at the grounded base [J m^-2 yr^-1]."""
    return torch.where(masks["mask_grounded_ice"], beta_a * uabs_base_a ** 2,
                       0.0)


# -- vertical velocities (vertical_velocities.f90:23) ------------------------

def calc_vertical_velocities(C, md: MeshData, masks, Hi, Hib, dHi_dt, dHb_dt,
                             u_3D_b, v_3D_b, u_3D_a, v_3D_a,
                             dzeta_dx, dzeta_dy, dzeta_dz, BMB):
    nz = md.nz
    dHib_dx = md.M_ddx_a_a @ Hib
    dHib_dy = md.M_ddy_a_a @ Hib
    dHib_dt = torch.where(masks["mask_grounded_ice"], dHb_dt,
                          torch.where(masks["mask_floating_ice"],
                                      -dHi_dt * ice_density / seawater_density,
                                      0.0))
    # basal w
    w_base = (u_3D_a[:, nz - 1] * dHib_dx + v_3D_a[:, nz - 1] * dHib_dy
              + dHib_dt + torch.clamp(BMB, max=0.0))

    # u,v on edges, horizontal divergence via Voronoi boundary loop integral
    u_c = map_b_to_c(md, u_3D_b)       # [nE, nz]
    v_c = map_b_to_c(md, v_3D_b)
    u_e = md.ext_E(u_c)[md.VE]         # [nV, K, nz]
    v_e = md.ext_E(v_c)[md.VE]
    nhat_x = (md.D_x / md.D)[..., None]
    nhat_y = (md.D_y / md.D)[..., None]
    dS = md.Cw[..., None]
    un_dS = torch.where(md.mask_C[..., None],
                        (u_e * nhat_x + v_e * nhat_y) * dS, 0.0)
    cint = un_dS.sum(dim=1)            # [nV, nz]
    # staggered means between layers
    cint_s = 0.5 * (cint[:, 1:] + cint[:, :-1])
    grad_uv = cint_s / md.A[:, None]

    dzeta = (md.zeta[1:] - md.zeta[:-1])[None, :]
    du_dzeta = (u_3D_a[:, 1:] - u_3D_a[:, :-1]) / dzeta
    dv_dzeta = (v_3D_a[:, 1:] - v_3D_a[:, :-1]) / dzeta
    zx_s = 0.5 * (dzeta_dx[:, 1:] + dzeta_dx[:, :-1])
    zy_s = 0.5 * (dzeta_dy[:, 1:] + dzeta_dy[:, :-1])
    zz_s = 0.5 * (dzeta_dz[:, 1:] + dzeta_dz[:, :-1])
    dw_dzeta = -1.0 / zz_s * (grad_uv + zx_s * du_dzeta + zy_s * dv_dzeta)

    # integrate upward from the base: w[ks] = w[ks+1] - dzeta * dw_dzeta[ks]
    incr = torch.flip(dzeta * dw_dzeta, (1,))          # from base upward
    w_rev = w_base[:, None] - torch.cat(
        [torch.zeros_like(w_base)[:, None], torch.cumsum(incr, dim=1)], dim=1)
    w = torch.flip(w_rev, (1,))

    has_ice = masks["mask_grounded_ice"] | masks["mask_floating_ice"]
    w = torch.where(has_ice[:, None], w, 0.0)
    # thin ice: horizontal stretching negligible
    w = torch.where((Hi < 10.0)[:, None], w_base[:, None], w)
    w = torch.where(has_ice[:, None], w, 0.0)
    return w


# -- upwind horizontal advection (thermodynamics_utilities.f90:352) ----------

def calc_upwind_heat_flux(md: MeshData, Hi, Ti, u_3D_b, v_3D_b,
                          u_vav_a, v_vav_a):
    """u*dT/dx, v*dT/dy taken from the upwind triangle.

    The upwind triangle is the surrounding triangle whose angular sector
    contains the upwind vector -u_vav; the per-(vertex, sector) geometry
    and triangle table are static mesh connectivity precomputed by
    register_thermo_static."""
    dT_dx_b = md.M_ddx_a_b @ Ti         # [nTri, nz]
    dT_dy_b = md.M_ddy_a_b @ Ti

    ab_x, ab_y = md.x("th_ab_x"), md.x("th_ab_y")
    ac_x, ac_y = md.x("th_ac_x"), md.x("th_ac_y")
    has_wrap = md.x("th_has_wrap")
    ux = -u_vav_a[:, None]
    uy = -v_vav_a[:, None]
    cross_ab_u = ab_x * uy - ab_y * ux
    cross_u_ac = ux * ac_y - uy * ac_x
    sector = (cross_ab_u >= 0) & (cross_u_ac >= 0) & md.mask_C & has_wrap
    # first matching sector (fall back to 0); argmax has no bool kernel
    idx = torch.argmax(sector.to(torch.uint8), dim=1)
    ti_upwind = torch.gather(md.x("th_tri_sector"), 1, idx[:, None])[:, 0]

    u_up = md.ext_Tri(u_3D_b)[ti_upwind]           # [nV, nz]
    v_up = md.ext_Tri(v_3D_b)[ti_upwind]
    ud = u_up * md.ext_Tri(dT_dx_b)[ti_upwind]
    vd = v_up * md.ext_Tri(dT_dy_b)[ti_upwind]
    thin = Hi < 1.0
    return (torch.where(thin[:, None], 0.0, ud),
            torch.where(thin[:, None], 0.0, vd))


# -- Robin analytical solution (thermodynamics_utilities.f90:269) ------------

def robin_solution(C, md, Hi_eff, Ti_pmp, masks, T_surf, SMB, geothermal):
    """Robin (1955) steady-state profile. The constants are Python floats,
    so they take the fields' type, as the reference's weakly typed scalars
    do; the geothermal flux is float64 and widens what it touches."""
    k0, ke, c0 = 9.828, 0.0057, 2127.5
    cond = k0 * sec_per_year * math.exp(-ke * T0)
    diff = cond / (ice_density * c0)
    dTdz_base = -geothermal / cond
    Ts = torch.clamp(T_surf, max=T0)

    zeta = md.zeta[None, :]
    H = Hi_eff[:, None]
    SMBp = torch.clamp(SMB, min=1e-6)[:, None]
    ell = torch.sqrt(2.0 * diff * H / SMBp)
    dist = (1.0 - zeta) * H
    erf1 = torch.special.erf(dist / ell)
    erf2 = torch.special.erf(H / ell)
    Ti_acc = Ts[:, None] + math.sqrt(pi) / 2.0 * ell \
        * dTdz_base[:, None] * (erf1 - erf2)
    Ti_abl = Ts[:, None] + ((T0 - Clausius_Clapeyron_gradient * H)
                            - Ts[:, None]) * zeta
    Ti_flt = Ts[:, None] + zeta * (Ti_pmp[:, -1:] - Ts[:, None])

    Ti = torch.where(masks["mask_grounded_ice"][:, None],
                     torch.where((SMB > 0)[:, None], Ti_acc, Ti_abl),
                     torch.where(masks["mask_floating_ice"][:, None],
                                 Ti_flt, Ts[:, None] * torch.ones_like(zeta)))
    Ti = torch.where((Hi_eff > C.Hi_min_thermo)[:, None], Ti,
                     Ts[:, None] * torch.ones_like(zeta))
    return torch.minimum(Ti, Ti_pmp)


# -- the batched heat-equation solve -----------------------------------------

def make_heat_solver(C, md: MeshData):
    """Build solve_3D_heat_equation(state-like fields, dt) ->
    (Ti_new float64, n_unstable)."""
    zrows = zeta_rows(zeta_tridiag_operators(md.zeta), md.device)
    nz = md.nz
    dz_base = md.zeta[nz - 1] - md.zeta[nz - 2]      # 0-dim, the run's type

    def solve(Ti, u_3D_a, v_3D_a, w_3D, u_dTdx_up, v_dTdy_up, T_surf,
              Ti_pmp, Ki, Cpi, dzx, dzy, dzz, dzt, Phi,
              Q_base_grnd, T_base_float, masks, fraction_gr, Hi_eff, dt,
              SMB, geothermal):
        c_ddzeta = dzt + u_3D_a * dzx + v_3D_a * dzy + w_3D * dzz
        c_d2dzeta2 = -Ki / (ice_density * Cpi) * dzz ** 2
        rhs = -u_dTdx_up - v_dTdy_up + Phi / (ice_density * Cpi)
        # the flux part of the grounded basal row; Ti only enters it after
        # this quotient, so it is the same for every substep (float32 where
        # a file's flux keeps the run's float32 type, then widened as the
        # reference's float64 system widens it)
        q_base = (dz_base * Q_base_grnd
                  / (dzz[:, nz - 1] * Ki[:, nz - 1])).to(torch.float64)
        # float32 where a file's geothermal flux keeps the run's float32
        # type; the JAX package's float64 solution widens it (jnp.where)
        T_robin = robin_solution(C, md, Hi_eff, Ti_pmp, masks, T_surf,
                                 SMB, geothermal).to(torch.float64)
        thin = Hi_eff < C.Hi_min_thermo
        return heat_columns(
            Ti, c_ddzeta, c_d2dzeta2, rhs, T_surf, q_base, T_base_float,
            Ti_pmp, masks["mask_grounded_ice"], masks["mask_floating_ice"],
            masks["mask_gl_gr"], fraction_gr, thin, T_robin, zrows, dt,
            C.choice_GL_temperature_BC)

    return solve


def make_geothermal_flux(C, md: MeshData):
    """Geothermal heat flux [J m^-2 yr^-1] on the a-grid, registered in
    md.extras["geothermal"]: the uniform value in float64 in either
    precision (the reference's default array type), a field read from a
    file in the run's type."""
    if C.choice_geothermal_heat_flux == "uniform":
        ghf = torch.full((md.nV,), C.uniform_geothermal_heat_flux,
                         dtype=torch.float64, device=md.device)
    elif C.choice_geothermal_heat_flux == "read_from_file":
        # the file holds 'hflux' in W m^-2 = J m^-2 s^-1: remapped to the
        # mesh and converted to J m^-2 yr^-1 (geothermal_heat_flux.f90:
        # 50-61), in the run's type as the JAX package has it
        from ...io.input_files import read_field_from_file_2D
        from ...utils.constants import sec_per_year
        ghf = torch.as_tensor(read_field_from_file_2D(
            C.filename_geothermal_heat_flux, "hflux", md._host_mesh),
            dtype=md.A.dtype, device=md.device) * sec_per_year
    else:
        raise ValueError("unknown choice_geothermal_heat_flux "
                         f"'{C.choice_geothermal_heat_flux}'")
    if md.extras is not None:
        md.extras["geothermal"] = EField(ghf, "V")
    return ghf


def run_thermodynamics(C, md: MeshData, s, dt, T_surf_annual, SMB, BMB,
                       heat_solver, geothermal=None):
    """One thermodynamics step: returns (updated Ti in the run's type,
    n_unstable) (thermodynamics_main). `geothermal` defaults to the
    md-registered field."""
    if geothermal is None or md.extras and "geothermal" in md.extras:
        geothermal = md.x("geothermal")

    masks = determine_masks(md, s.Hi, s.Hb, s.SL)
    fraction_gr = calc_grounded_fractions_bilin_TAF(
        md, s.Hi, s.Hb, s.SL, masks["mask_floating_ice"])

    Ti = s.Ti
    Cpi = calc_heat_capacity(C, Ti)
    Ki = calc_thermal_conductivity(C, Ti)
    Hi_eff = s.Hi_eff
    Ti_pmp = calc_pressure_melting_point(md, Hi_eff)

    dHs_dt = s.dHi_dt  # dHs/dt ~ dHi/dt over rigid bed (GIA adds dHb_dt)
    dzx, dzy, dzz, dzt = calc_zeta_gradients(md, s.Hi, s.Hs, s.dHi_dt, dHs_dt)

    u_3D_a = md.M_map_b_a @ s.u_3D_b
    v_3D_a = md.M_map_b_a @ s.v_3D_b
    u_vav_a = md.M_map_b_a @ s.u_vav_b
    v_vav_a = md.M_map_b_a @ s.v_vav_b

    w_3D = calc_vertical_velocities(
        C, md, masks, s.Hi, s.Hib, s.dHi_dt, torch.zeros_like(s.Hi),
        s.u_3D_b, s.v_3D_b, u_3D_a, v_3D_a, dzx, dzy, dzz, BMB)

    u_dTdx_up, v_dTdy_up = calc_upwind_heat_flux(
        md, s.Hi, Ti, s.u_3D_b, s.v_3D_b, u_vav_a, v_vav_a)

    Phi = calc_strain_heating(C, md, masks, s.A_flow, s.u_3D_b, s.v_3D_b,
                              w_3D)
    uabs_base = torch.sqrt(u_3D_a[:, -1] ** 2 + v_3D_a[:, -1] ** 2)
    beta_a = torch.zeros_like(s.Hi)  # frictional heating uses sliding beta
    fric = calc_frictional_heating(masks, beta_a, uabs_base)
    Q_base_grnd = fric + geothermal
    T_base_float = Ti_pmp[:, -1]

    Ti_new, n_unstable = heat_solver(
        Ti, u_3D_a, v_3D_a, w_3D, u_dTdx_up, v_dTdy_up, T_surf_annual,
        Ti_pmp, Ki, Cpi, dzx, dzy, dzz, dzt, Phi,
        Q_base_grnd, T_base_float, masks, fraction_gr, Hi_eff, dt,
        SMB, geothermal)
    # keep the run's type: the float64 solve must not promote the float32
    # Ti carry
    return Ti_new.to(Ti.dtype), n_unstable
