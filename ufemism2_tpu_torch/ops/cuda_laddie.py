"""The LADDIE kernel: build, binding, wrappers and plain version.

`laddie_stage` does one stage of the LADDIE plume's pseudo-time
integration, what the JAX package's make_laddie_step `stage` computes
(ufemism2_tpu/models/laddie.py:373-470: the physics, the thickness, the
momentum and the tracer updates), for the scheme's (old, ref) states, and
the scheme's update after it: the fbrk3 beta-blend of the thickness or
the lfra Robert-Asselin filter. The JAX package runs a leg as one jitted
lax.fori_loop; in eager PyTorch a stage is a few hundred small launches,
here it is two (csrc/laddie.cu: a vertex pass, then a triangle pass).
`laddie_leg` runs a whole leg, n pseudo-steps of `laddie_step`, in one
cooperative launch of the same source (two grid barriers a stage).

`laddie_stage_plain` is the same stage in plain tensor code: the CPU path,
and the kernel's oracle on the card, where the two agree to the bit. For
that its every sum has one order, written out: the ELL rows (`_ell`, the
x operand rounded to bfloat16 in float32 as every `M @ x` of the
reference rounds it) and the neighbour sums (`_rsum`) are added k = 0,
1, ... in turn; the kernel rounds each operation as the tensor operation
does (a tensor divided by a Python scalar is multiplied by its reciprocal
on the card, a Python scalar divided by a tensor is the tensor's
reciprocal times the scalar) and contracts nothing into a fused
multiply-add.

A CUDA tensor always goes to the kernel; only CPU tensors take the plain
version (a leg on CPU tensors is the loop of plain stages, the leg
entry's oracle). The CUDA source is compiled with nvcc at first use into its own
shared library under build/ and loaded with ctypes, as ops/cuda_heat.py
does for heat_columns.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ._build import build_kernel
from .cuda_spmv import _round_bf16
from ..utils.constants import (grav, seawater_density, cp_ice, cp_ocean,
                               L_fusion, freezing_lambda_1, freezing_lambda_2,
                               freezing_lambda_3, Prandtl_number,
                               Schmidt_number)

launches = 0         # stages run since the caller last set it to 0
kernel_launches = 0  # kernel launches: two a laddie_stage, one a laddie_leg
last_leg_grid = 0    # the blocks of the last laddie_leg launch
_lib = None


class LaddieState(NamedTuple):
    H: torch.Tensor     # [nV] layer thickness [m]
    U: torch.Tensor     # [nTri] velocity [m/s]
    V: torch.Tensor
    T: torch.Tensor     # [nV] temperature [deg C]
    S: torch.Tensor     # [nV] salinity [PSU]


class LaddieMasks(NamedTuple):
    a: torch.Tensor       # [nV] shelf (active) vertices
    gr_a: torch.Tensor    # [nV] grounded
    oc_a: torch.Tensor    # [nV] ice-free ocean
    b: torch.Tensor       # [nTri] active triangles
    gl_b: torch.Tensor    # [nTri] grounding-line triangles
    cf_b: torch.Tensor    # [nTri] calving-front triangles


PH_FIELDS = ("melt", "entr", "detr", "gamma_T", "gamma_S", "T_base",
             "T_amb", "S_amb", "drho_amb", "Hdrho_amb")


@dataclass
class LaddieParams:
    """The configuration constants of a stage (Python floats)."""
    jenkins: bool
    alpha: float
    beta_eos: float
    fcor: float
    Cd_top: float
    Cd_mom: float
    tidal: float
    gamma_T: float
    mu: float
    buoy_min: float
    H_min: float
    H_max: float
    visc: float
    v_max: float

    @classmethod
    def from_config(cls, C):
        return cls(jenkins=C.choice_laddie_gamma == "Jenkins1991",
                   alpha=C.uniform_laddie_eos_linear_alpha,
                   beta_eos=C.uniform_laddie_eos_linear_beta,
                   fcor=C.uniform_laddie_coriolis_parameter,
                   Cd_top=C.laddie_drag_coefficient_top,
                   Cd_mom=C.laddie_drag_coefficient_mom,
                   tidal=C.uniform_laddie_tidal_velocity,
                   gamma_T=C.uniform_laddie_gamma_T,
                   mu=C.laddie_Gaspar1988_mu,
                   buoy_min=C.laddie_buoyancy_minimum,
                   H_min=C.laddie_thickness_minimum,
                   H_max=C.laddie_thickness_maximum,
                   visc=C.laddie_viscosity,
                   v_max=C.laddie_velocity_maximum)


class _Ell(NamedTuple):
    cols: torch.Tensor     # [K, n] int32
    idx: torch.Tensor      # [K, n] int64 (the same, for indexing)
    vals: torch.Tensor     # [K, n]


@dataclass
class LaddieTables:
    """The static tables a stage reads, on one mesh (the compact shelf
    mesh on the model's path); the int32 copies with -1 for a missing
    neighbour are the kernel's."""
    nV: int
    nTri: int
    C: torch.Tensor        # [nV, K] int64 neighbour vertices (pad 0)
    mask_C: torch.Tensor   # [nV, K] bool
    VE: torch.Tensor       # [nV, K] int64 edge of each connection (pad 0)
    LcA: torch.Tensor      # [nV, K] Cw / A
    Dx_D: torch.Tensor     # [nV, K] the connection's unit vector: D_x / D
    Dy_D: torch.Tensor
    Tri: torch.Tensor      # [nTri, 3] int64
    EV: torch.Tensor       # [nE, 2] int64
    ETri: torch.Tensor     # [nE, 2] int64 (pad 0)
    mask_ETri: torch.Tensor
    TriC: torch.Tensor     # [nTri, 3] int64 neighbour triangles (pad 0)
    mTriC: torch.Tensor    # [nTri, 3] bool
    TriE: torch.Tensor     # [nTri, 3] int64 edges (pad 0)
    TDx_D: torch.Tensor    # [nTri, 3] TriD_x / TriD
    TDy_D: torch.Tensor
    TriD: torch.Tensor     # [nTri, 3] circumcentre distance
    TriCw: torch.Tensor    # [nTri, 3] shared edge length
    TriA: torch.Tensor     # [nTri]
    nb_border: torch.Tensor  # [nTri] missing neighbours, in the run's type
    M_map_b_a: _Ell
    M_map_a_b: _Ell
    M_ddx_a_b: _Ell
    M_ddy_a_b: _Ell
    k32: dict = None       # the kernel's int32 tables, by name
    desc: object = None    # the kernel's descriptor, its tables filled in
    consts: dict = None    # the kernel's constant arrays, by stage kind


def _ell_of(M):
    cols = M.cols.contiguous()
    return _Ell(cols, cols.long(), M.vals[0].contiguous())


def _ell_len(M: _Ell):
    """Each row's entries up to its last one that is not padding (column 0
    and value +0.0, as ops/sparse.py pads an ELL row), at least 1: past
    them every product of the row is the same (csrc/laddie.cu ell_rows)."""
    real = (M.cols != 0) | (M.vals != 0) | torch.signbit(M.vals)
    k = torch.arange(1, real.shape[0] + 1, device=real.device)[:, None]
    return (k * real).amax(dim=0).clamp(min=1).to(torch.int32).contiguous()


def laddie_tables(md) -> LaddieTables:
    """The stage's tables on md (from its host mesh and its ELL
    operators). The connection and triangle-triangle geometry is formed in
    float64 on the host, as the JAX package forms it, and stored in the
    run's type; the unit vectors D_x / D and the ratios Cw / A are divided
    there once, as tensors of the run's type, the order of the JAX
    package's expressions."""
    mesh = md._host_mesh
    dt, dev = md.A.dtype, md.device
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=dev)
    mask_TriC = mesh.TriC >= 0
    TriCc = np.maximum(mesh.TriC, 0)
    TriD_x = f(np.where(mask_TriC, mesh.Tricc[TriCc, 0]
                        - mesh.Tricc[:, 0:1], 1.0))
    TriD_y = f(np.where(mask_TriC, mesh.Tricc[TriCc, 1]
                        - mesh.Tricc[:, 1:2], 1.0))
    TriD = torch.sqrt(TriD_x ** 2 + TriD_y ** 2)
    TriD = torch.where(TriD < 1e-6, 1.0, TriD)
    TriE = np.maximum(mesh.TriE, 0)
    TriCw = f(np.linalg.norm(mesh.V[mesh.EV[TriE, 0]]
                             - mesh.V[mesh.EV[TriE, 1]], axis=2))
    ells = dict(ba=_ell_of(md.M_map_b_a), ab=_ell_of(md.M_map_a_b),
                dx=_ell_of(md.M_ddx_a_b), dy=_ell_of(md.M_ddy_a_b))
    return LaddieTables(
        nV=md.nV, nTri=md.nTri, C=md.C, mask_C=md.mask_C, VE=md.VE,
        LcA=md.Cw / md.A[:, None], Dx_D=md.D_x / md.D, Dy_D=md.D_y / md.D,
        Tri=md.Tri, EV=md.EV, ETri=md.ETri, mask_ETri=md.mask_ETri,
        TriC=i(TriCc), mTriC=torch.as_tensor(mask_TriC, device=dev),
        TriE=i(TriE), TDx_D=TriD_x / TriD, TDy_D=TriD_y / TriD, TriD=TriD,
        TriCw=TriCw, TriA=md.TriA,
        nb_border=f((~mask_TriC).sum(axis=1)),
        M_map_b_a=ells["ba"], M_map_a_b=ells["ab"], M_ddx_a_b=ells["dx"],
        M_ddy_a_b=ells["dy"],
        # the kernel's: each connection's and each neighbour's triangles
        # and vertices read directly (of edge or triangle 0 where there is
        # none, as the padded tables above)
        k32={name: torch.as_tensor(np.ascontiguousarray(t), dtype=torch.int32,
                                   device=dev)
             for name, t in (("C", mesh.C), ("Tri", mesh.Tri),
                             ("TriC", mesh.TriC),
                             ("VET", mesh.ETri[np.maximum(mesh.VE, 0)]),
                             ("TriET", mesh.ETri[TriE]),
                             ("TriEV", mesh.EV[TriE]),
                             ("TriCV", mesh.Tri[TriCc]))}
        | {f"{pre}_len": _ell_len(M) for pre, M in ells.items()},
        consts={})


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _rsum(x):
    """x [n, K] summed over K, k = 0, 1, ... in turn."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _ell(M: _Ell, x):
    """M @ x, its row entries added k = 0, 1, ... in turn; in float32 the
    x operand rounded to bfloat16 first, as `EllMatrix @` rounds it."""
    if x.dtype == torch.float32:
        x = _round_bf16(x)
    xg = x[M.idx]
    acc = M.vals[0] * xg[0]
    for k in range(1, M.vals.shape[0]):
        acc = acc + M.vals[k] * xg[k]
    return acc


def _b_to_c(tab, u):
    """map_b_to_c: the mean of the (one or two) triangles of each edge."""
    vals = torch.where(tab.mask_ETri, u[tab.ETri], 0.0)
    n = tab.mask_ETri.sum(dim=1)
    return (vals[:, 0] + vals[:, 1]) / torch.clamp(n, min=1)


def _map_a_b(tab, a, H, H_min):
    """Active-masked a -> b mean, floored count, Hmin where none."""
    w = a[tab.Tri].to(H.dtype)
    s = _rsum(H[tab.Tri] * w)
    n = _rsum(w)
    return torch.where(n > 0, s / torch.clamp(n, min=1), H_min)


def _map_a_c(tab, a, H, H_min):
    w = a[tab.EV].to(H.dtype)
    s = _rsum(H[tab.EV] * w)
    n = _rsum(w)
    return torch.where(n > 0, s / torch.clamp(n, min=1), H_min)


def _ambient(fc, H):
    """Ambient T, S at the layer base by depth interpolation (the search
    is side left, as jnp.searchsorted's)."""
    depths = fc["z_ocean"]
    depth_abs = torch.clamp(-(fc["Hib"] - H), min=0.0)
    nd = depths.shape[0]
    idx = torch.clamp(torch.searchsorted(depths, depth_abs) - 1, 0, nd - 2)
    w = torch.clamp((depth_abs - depths[idx])
                    / torch.clamp(depths[idx + 1] - depths[idx], min=1e-9),
                    0.0, 1.0)
    i0, i1 = idx[:, None], (idx + 1)[:, None]
    To, So = fc["T_ocean"], fc["S_ocean"]
    T_amb = To.gather(1, i0)[:, 0] * (1 - w) + To.gather(1, i1)[:, 0] * w
    S_amb = So.gather(1, i0)[:, 0] * (1 - w) + So.gather(1, i1)[:, 0] * w
    return T_amb, S_amb


def _physics(tab, P: LaddieParams, npx, lm, fc):
    """Melt, entrainment, buoyancy (laddie_physics.f90) at the ref state;
    every quantity masked to the active vertices as the JAX package's."""
    Hstar = npx.H
    U_a = _ell(tab.M_map_b_a, npx.U)
    V_a = _ell(tab.M_map_b_a, npx.V)
    u_star = torch.sqrt(P.Cd_top * (U_a ** 2 + V_a ** 2 + P.tidal ** 2))
    if P.jenkins:
        nu0, eps = 1.95e-6, 1e-12
        AA = 2.12 * torch.log(u_star * Hstar / nu0 + eps)
        gamma_T = u_star / (AA + 12.5 * Prandtl_number ** (2 / 3) - 8.68)
        gamma_S = u_star / (AA + 12.5 * Schmidt_number ** (2 / 3) - 8.68)
    else:
        gamma_T = u_star * P.gamma_T
        gamma_S = u_star * P.gamma_T / 35.0
    Hib = fc["Hib"]
    Ctil = cp_ice / cp_ocean
    That = freezing_lambda_2 + freezing_lambda_3 * Hib
    if fc["use_Ti"]:
        L_eff = L_fusion - cp_ice * fc["Ti_base"]
        Chat = cp_ocean / L_eff
    else:
        L_eff = L_fusion
        Chat = cp_ocean / L_fusion
    Bval = Chat * gamma_T * (That - npx.T) + gamma_S * (
        1 + Chat * Ctil * (That + freezing_lambda_1 * npx.S))
    Cval = Chat * gamma_T * gamma_S * (That - npx.T
                                       + freezing_lambda_1 * npx.S)
    disc = Bval ** 2 - 4 * Cval
    melt = torch.where(disc < 0, 0.0,
                       0.5 * (-Bval + torch.sqrt(torch.clamp(disc, min=0.0))))
    Dval = melt * cp_ice - cp_ocean * gamma_T
    T_freeze = (freezing_lambda_1 * npx.S + freezing_lambda_2
                + freezing_lambda_3 * Hib)
    T_base = torch.where(Dval.abs() < 1e-12, T_freeze,
                         (melt * L_eff - cp_ocean * gamma_T * npx.T) / Dval)

    T_amb, S_amb = _ambient(fc, Hstar)
    drho_amb = P.beta_eos * (S_amb - npx.S) - P.alpha * (T_amb - npx.T)
    drho_amb = torch.clamp(drho_amb, min=P.buoy_min / seawater_density)
    Hdrho_amb = Hstar * drho_amb

    # entrainment (Gaspar 1988)
    S_base = (T_base - freezing_lambda_2
              - freezing_lambda_3 * Hib) / freezing_lambda_1
    drho_base = P.beta_eos * (npx.S - S_base) - P.alpha * (npx.T - T_base)
    entr = (2 * P.mu / grav * u_star ** 3
            / (torch.clamp(Hstar, min=1e-3) * drho_amb)
            - drho_base / drho_amb * melt)
    entr = torch.clamp(entr, min=-1e-3)
    detr = -torch.clamp(entr, max=0.0)

    act = lm.a
    ph = dict(melt=melt, entr=entr, detr=detr, gamma_T=gamma_T,
              gamma_S=gamma_S, T_base=T_base, T_amb=T_amb, S_amb=S_amb,
              Hdrho_amb=Hdrho_amb)
    ph = {k: torch.where(act, v, 0.0) for k, v in ph.items()}
    ph["drho_amb"] = torch.where(act, drho_amb, 1e-6)
    return ph


def _u_perp_V(tab, U_c, V_c):
    return U_c[tab.VE] * tab.Dx_D + V_c[tab.VE] * tab.Dy_D


def laddie_stage_plain(tab: LaddieTables, P: LaddieParams, old, ref, lm, fc,
                       dt_i, include_visc, post=None):
    """One stage (compute_H_npx + compute_UV_npx + compute_TS_npx) and the
    scheme's update after it: (state, filtered, ph).

    `post`: None; ("blend", (c1, c2), now_H) for H = c1 * H_new + c2 *
    now_H (fbrk3's first two stages); ("blend3", (c1, c2, c3), now_H) for
    H = c1 * H_new + c2 * old.H + c3 * now_H (its third); ("lfra", nu) for
    the Robert-Asselin filter of the centre level `ref` with `old` and the
    new state, returned as `filtered` (None otherwise)."""
    ph = _physics(tab, P, ref, lm, fc)
    sgd = fc["SGD"]
    a = lm.a

    # -- thickness (laddie_thickness.f90:143, upwind Voronoi divergence) --
    U_c = _b_to_c(tab, ref.U)
    V_c = _b_to_c(tab, ref.V)
    u_perp = _u_perp_V(tab, U_c, V_c)
    nbr_gr = lm.gr_a[tab.C]
    nbr_oc = lm.oc_a[tab.C]
    act_C = tab.mask_C & ~nbr_gr
    up = torch.clamp(u_perp, min=0.0)
    dn = torch.clamp(u_perp, max=0.0)
    H_j = ref.H[tab.C]
    flux = torch.where(act_C, tab.LcA * (up * ref.H[:, None]
                                         + dn * torch.where(nbr_oc, 0.0,
                                                            H_j)), 0.0)
    dQH = torch.where(a, _rsum(flux), 0.0)
    dHdt0 = -dQH + ph["melt"] + ph["entr"] + sgd
    H_guess = old.H + dHdt0 * dt_i
    entr_dmin = torch.clamp(P.H_min - H_guess, min=0.0) / dt_i
    entr = ph["entr"] + torch.clamp(P.H_max - H_guess, max=0.0) / dt_i
    entr = torch.where(entr_dmin > 0, torch.clamp(entr, min=0.0), entr)
    detr = -torch.clamp(entr, max=0.0)
    dHdt = -dQH + ph["melt"] + entr + entr_dmin + sgd
    H_new = torch.where(a, old.H + dHdt * dt_i, old.H)
    H_new_b = _map_a_b(tab, a, H_new, P.H_min)

    # -- momentum (laddie_velocity.f90) --
    Hstar = ref.H
    Hstar_b = _map_a_b(tab, a, Hstar, P.H_min)
    Hdrho_b = _map_a_b(tab, a, ph["Hdrho_amb"], P.H_min)
    detr_b = _ell(tab.M_map_a_b, detr)
    ddrho_dx_b = _ell(tab.M_ddx_a_b, ph["drho_amb"])
    ddrho_dy_b = _ell(tab.M_ddy_a_b, ph["drho_amb"])
    dH_dx_b = _ell(tab.M_ddx_a_b, Hstar)
    dH_dy_b = _ell(tab.M_ddy_a_b, Hstar)
    dHib_dx_b, dHib_dy_b = fc["dHib_dx_b"], fc["dHib_dy_b"]
    edge_tri = lm.cf_b | lm.gl_b
    PGF_x = torch.where(
        edge_tri,
        grav * Hdrho_b * dHib_dx_b - 0.5 * grav * Hstar_b ** 2 * ddrho_dx_b,
        -grav * Hdrho_b * dH_dx_b + grav * Hdrho_b * dHib_dx_b
        - 0.5 * grav * Hstar_b ** 2 * ddrho_dx_b)
    PGF_y = torch.where(
        edge_tri,
        grav * Hdrho_b * dHib_dy_b - 0.5 * grav * Hstar_b ** 2 * ddrho_dy_b,
        -grav * Hdrho_b * dH_dy_b + grav * Hdrho_b * dHib_dy_b
        - 0.5 * grav * Hstar_b ** 2 * ddrho_dy_b)

    # upstream momentum advection (laddie_velocity.f90:282)
    H_ref_b = Hstar_b
    Uc_e, Vc_e = U_c[tab.TriE], V_c[tab.TriE]
    u_perp_b = Uc_e * tab.TDx_D + Vc_e * tab.TDy_D
    act_T = tab.mTriC & ~lm.gl_b[tab.TriC]
    out_f = torch.clamp(u_perp_b, min=0.0)
    in_f = torch.clamp(u_perp_b, max=0.0)
    Hb_j = H_ref_b[tab.TriC]
    TriA = tab.TriA[:, None]
    dU = tab.TriCw * (out_f * H_ref_b[:, None] * ref.U[:, None]
                      + in_f * Hb_j * ref.U[tab.TriC]) / TriA
    dV = tab.TriCw * (out_f * H_ref_b[:, None] * ref.V[:, None]
                      + in_f * Hb_j * ref.V[tab.TriC]) / TriA
    dQU = torch.where(lm.b, _rsum(torch.where(act_T, dU, 0.0)), 0.0)
    dQV = torch.where(lm.b, _rsum(torch.where(act_T, dV, 0.0)), 0.0)

    speed_ref = torch.sqrt(ref.U ** 2 + ref.V ** 2)
    dHUdt = (-dQU + PGF_x
             + P.fcor * Hstar_b * ref.V
             - P.Cd_mom * ref.U * speed_ref
             - detr_b * ref.U)
    dHVdt = (-dQV + PGF_y
             - P.fcor * Hstar_b * ref.U
             - P.Cd_mom * ref.V * speed_ref
             - detr_b * ref.V)
    if include_visc:
        # horizontal viscosity (laddie_velocity.f90:211); ocean-side
        # neighbours are free slip, missing ones no slip
        H_ref_c = _map_a_c(tab, a, ref.H, P.H_min)
        dUn = ref.U[tab.TriC] - ref.U[:, None]
        dVn = ref.V[tab.TriC] - ref.V[:, None]
        dUabs = torch.sqrt(dUn ** 2 + dVn ** 2)
        Ah = P.visc * dUabs * tab.TriCw / 100.0
        Hc = H_ref_c[tab.TriE]
        coef = Ah * Hc / TriA * tab.TriCw / tab.TriD
        act_v = tab.mTriC & ~lm.cf_b[tab.TriC]
        vU = _rsum(torch.where(act_v, coef * dUn, 0.0))
        vV = _rsum(torch.where(act_v, coef * dVn, 0.0))
        vU = vU - ref.U * P.visc * H_ref_b / tab.TriA * tab.nb_border
        vV = vV - ref.V * P.visc * H_ref_b / tab.TriA * tab.nb_border
        dHUdt = dHUdt + torch.where(lm.b, vU, 0.0)
        dHVdt = dHVdt + torch.where(lm.b, vV, 0.0)

    H_old_b = _map_a_b(tab, a, old.H, P.H_min)
    HU = old.U * H_old_b + dHUdt * dt_i
    HV = old.V * H_old_b + dHVdt * dt_i
    Hn_b = torch.clamp(H_new_b, min=1e-3)
    U_new = torch.where(lm.b, HU / Hn_b, 0.0)
    V_new = torch.where(lm.b, HV / Hn_b, 0.0)
    speed = torch.sqrt(U_new ** 2 + V_new ** 2)
    lim = torch.clamp(P.v_max / torch.clamp(speed, min=1e-12), max=1.0)
    U_new = U_new * lim
    V_new = V_new * lim

    # -- tracers (laddie_tracers.f90 compute_divQTS) --
    def div_of(F):
        in_F = torch.where(nbr_oc, 0.0, H_j * F[tab.C])
        fl = torch.where(act_C, tab.LcA * (up * ref.H[:, None] * F[:, None]
                                           + dn * in_F), 0.0)
        return torch.where(a, _rsum(fl), 0.0)
    dQT, dQS = div_of(ref.T), div_of(ref.S)
    entr_p = torch.clamp(entr, min=0.0)
    detr_p = torch.clamp(detr, min=0.0)
    dHTdt = (-dQT + ph["melt"] * ph["T_base"]
             - ph["gamma_T"] * (ref.T - ph["T_base"])
             + entr_p * ph["T_amb"]
             - detr_p * ref.T
             + entr_dmin * ph["T_amb"]
             # SGD water enters at the local freezing point and with zero
             # salinity (laddie_tracers.f90:67,74)
             + sgd * (freezing_lambda_2 + freezing_lambda_3 * fc["Hib"]))
    dHSdt = (-dQS + entr_p * ph["S_amb"] - detr_p * ref.S
             + entr_dmin * ph["S_amb"])
    Hn = torch.clamp(H_new, min=1e-3)
    T_new = torch.where(a, (old.T * old.H + dHTdt * dt_i) / Hn, old.T)
    S_new = torch.where(a, (old.S * old.H + dHSdt * dt_i) / Hn, old.S)

    new = LaddieState(H=H_new, U=U_new, V=V_new, T=T_new, S=S_new)
    if post is None:
        return new, None, ph
    if post[0] == "blend":
        (c1, c2), now_H = post[1], post[2]
        return new._replace(H=c1 * H_new + c2 * now_H), None, ph
    if post[0] == "blend3":
        (c1, c2, c3), now_H = post[1], post[2]
        return new._replace(H=c1 * H_new + c2 * old.H + c3 * now_H), \
            None, ph
    nu = post[1]
    filt = LaddieState(*(c + 0.5 * nu * (p + f - 2.0 * c)
                         for c, p, f in zip(ref, old, new)))
    return new, filt, ph


# ---------------------------------------------------------------------------
# The pseudo-step and the leg
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaddieScheme:
    """A pseudo-step's time scheme (laddie_integration.f90)."""
    kind: str                        # "fbrk3", "euler" or "lfra"
    dt: float                        # [s]
    beta: tuple = (0.0, 0.0, 0.0)    # fbrk3's beta1..3
    nu: float = 0.0                  # lfra's Robert-Asselin nu

    @classmethod
    def from_config(cls, C):
        kind = C.choice_laddie_integration_scheme or "fbrk3"
        if kind not in ("fbrk3", "euler", "lfra"):
            raise ValueError(
                f"unknown choice_laddie_integration_scheme '{kind}'")
        return cls(kind=kind, dt=C.dt_laddie,
                   beta=(C.laddie_fbrk3_beta1, C.laddie_fbrk3_beta2,
                         C.laddie_fbrk3_beta3), nu=C.laddie_lfra_nu)

    def stages(self):
        """A step's stages: [(dt_i, include_visc, post kind, post
        coefficients)]."""
        dt = self.dt
        if self.kind == "fbrk3":
            b1, b2, b3 = self.beta
            return [(dt / 3, False, "blend", (b1, 1 - b1)),
                    (dt / 2, False, "blend", (b2, 1 - b2)),
                    (dt, True, "blend3", (b3, 1 - 2 * b3, b3))]
        if self.kind == "lfra":
            return [(dt, True, "lfra", self.nu)]
        return [(dt, True, None, None)]


def laddie_step(tab, P, sch: LaddieScheme, carry, lm, fc, stage_fn):
    """One pseudo-step ((now, nm1), lm, fc) -> ((now, nm1), ph) of the
    scheme, its stages by `stage_fn` (laddie_stage or its plain version):
    fbrk3 chains now -> np13 -> np12 -> np1, each stage's H blended with the
    step's starting H; lfra takes the tendencies at `now` and steps from
    `nm1` (laddie_integration.f90:171-255), then filters the centre level;
    euler steps from `now`."""
    now, nm1 = carry
    if sch.kind == "fbrk3":
        st = now
        for dt_i, visc, kind, coefs in sch.stages():
            st, _, ph = stage_fn(tab, P, st, st, lm, fc, dt_i, visc,
                                 (kind, coefs, now.H))
        return (st, st), ph
    (dt_i, visc, kind, nu), = sch.stages()
    if kind == "lfra":
        np1, filt, ph = stage_fn(tab, P, nm1, now, lm, fc, dt_i, visc,
                                 ("lfra", nu))
        return (np1, filt), ph
    np1, _, ph = stage_fn(tab, P, now, now, lm, fc, dt_i, visc)
    return (np1, np1), ph


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_K_NAMES = (
    "CD_TOP", "TIDAL2", "GT", "INV35",
    "INV_NU0", "EPS", "212", "KT", "KS", "868",
    "L1", "L2", "L3", "INV_L1",
    "LF", "CPI", "CPO", "CTIL", "CHAT", "CHAT_CTIL",
    "FOUR", "HALF", "DTHR",
    "BETA", "ALPHA", "DRHO_MIN", "ENTR", "HFLOOR", "ENTR_MIN", "DRHO_DEF",
    "DEPTH_FLOOR",
    "HMIN", "HMAX", "DT", "INV_DT",
    "GRAV", "HALF_GRAV", "NEG_GRAV", "FCOR", "CD_MOM", "VISC", "INV100",
    "VMAX", "SPEED_FLOOR",
    "C1", "C2", "C3", "HALF_NU", "TWO")       # csrc/laddie.cu enum K_*
_K_INDEX = {n: j for j, n in enumerate(_K_NAMES)}
_SK_NAMES = ("DT", "INV_DT", "C1", "C2", "C3", "HALF_NU")  # enum SK_*
_POST = {None: 0, "blend": 1, "blend3": 2, "lfra": 3}
_SCHEME = {"fbrk3": 0, "euler": 1, "lfra": 2}
MAX_ND = 4096        # csrc/laddie.cu UF_LADDIE_MAX_ND: z_ocean in shared memory
_PTRS = (
    "C", "VET", "LcA", "Dx_D", "Dy_D", "Tri", "TriC", "TriET", "TriEV",
    "TriCV", "TDx_D", "TDy_D", "TriD", "TriCw", "TriA", "nb_border",
    "ba_cols", "ba_vals", "ab_cols", "ab_vals", "dx_cols", "dx_vals",
    "dy_cols", "dy_vals", "ba_len", "ab_len", "dx_len", "dy_len",
    "a", "gr_a", "oc_a", "b", "gl_b", "cf_b",
    "Hib", "Ti_base", "SGD", "dHib_dx_b", "dHib_dy_b", "z_ocean", "T_ocean",
    "S_ocean",
    "oH", "oU", "oV", "oT", "oS", "rH", "rU", "rV", "rT", "rS", "nowH",
    "Hn", "Hs", "Tn", "Sn", "detr", "ph", "Un", "Vn",
    "fH", "fU", "fV", "fT", "fS")


class _LaddieDesc(ctypes.Structure):     # csrc/laddie.cu::LaddieDesc
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [
        (n, ctypes.c_int) for n in ("nV", "nTri", "Kc", "Kba", "Kab", "Kdx",
                                    "Kdy", "nd", "jenkins", "use_Ti",
                                    "visc", "post")] + [
        ("k", ctypes.c_double * len(_K_NAMES))]


class _StatePtrs(ctypes.Structure):      # csrc/laddie.cu::StatePtrs
    _fields_ = [(n, ctypes.c_void_p) for n in LaddieState._fields]


class _LegDesc(ctypes.Structure):        # csrc/laddie.cu::LegDesc
    _fields_ = [("d", _LaddieDesc), ("init", _StatePtrs),
                ("buf", _StatePtrs * 4), ("Hn", ctypes.c_void_p),
                ("detr", ctypes.c_void_p), ("ph", ctypes.c_void_p),
                ("n_steps", ctypes.c_int), ("scheme", ctypes.c_int),
                ("n_stages", ctypes.c_int), ("visc", ctypes.c_int * 3),
                ("post", ctypes.c_int * 3),
                ("sk", (ctypes.c_double * len(_SK_NAMES)) * 3)]


def load_kernels():
    """The compiled kernel, built at first use in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernel("laddie")))
        for fn in (lib.laddie_stage_f32, lib.laddie_stage_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.laddie_leg_f32, lib.laddie_leg_f64,
                   lib.laddie_leg_floor_f32, lib.laddie_leg_floor_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        for fn in (lib.laddie_lanes_f32, lib.laddie_lanes_f64):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _constants(P: LaddieParams, dt_i, post, dtype):
    """The kernel's constants: each the value the plain version's tensor
    operation uses - a Python scalar rounded to the run's type T (the
    products and quotients of Python scalars formed first in float64, as
    Python forms them), a divisor's reciprocal formed in T."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    inv = lambda s: float(np_t(1) / np_t(s))
    coefs = (0.0, 0.0, 0.0)
    if post is not None and post[0] in ("blend", "blend3"):
        coefs = tuple(post[1]) + (0.0,) * (3 - len(post[1]))
    half_nu = 0.5 * post[1] if post is not None and post[0] == "lfra" \
        else 0.0
    chat = cp_ocean / L_fusion
    ctil = cp_ice / cp_ocean
    k = dict(
        CD_TOP=P.Cd_top, TIDAL2=P.tidal ** 2, GT=P.gamma_T, INV35=inv(35.0),
        INV_NU0=inv(1.95e-6), EPS=1e-12, **{"212": 2.12},
        KT=12.5 * Prandtl_number ** (2 / 3),
        KS=12.5 * Schmidt_number ** (2 / 3), **{"868": 8.68},
        L1=freezing_lambda_1, L2=freezing_lambda_2, L3=freezing_lambda_3,
        INV_L1=inv(freezing_lambda_1),
        LF=L_fusion, CPI=cp_ice, CPO=cp_ocean, CTIL=ctil, CHAT=chat,
        CHAT_CTIL=chat * ctil, FOUR=4.0, HALF=0.5, DTHR=1e-12,
        BETA=P.beta_eos, ALPHA=P.alpha,
        DRHO_MIN=P.buoy_min / seawater_density, ENTR=2 * P.mu / grav,
        HFLOOR=1e-3, ENTR_MIN=-1e-3, DRHO_DEF=1e-6, DEPTH_FLOOR=1e-9,
        HMIN=P.H_min, HMAX=P.H_max, DT=dt_i, INV_DT=inv(dt_i),
        GRAV=grav, HALF_GRAV=0.5 * grav, NEG_GRAV=-grav, FCOR=P.fcor,
        CD_MOM=P.Cd_mom, VISC=P.visc, INV100=inv(100.0), VMAX=P.v_max,
        SPEED_FLOOR=1e-12, C1=coefs[0], C2=coefs[1], C3=coefs[2],
        HALF_NU=half_nu, TWO=2.0)
    return (ctypes.c_double * len(_K_NAMES))(
        *(float(np_t(k[n])) for n in _K_NAMES))


def _stage_constants(tab, P, dt_i, post, dtype):
    """_constants of a stage, kept on the tables by the stage's kind."""
    kind = None if post is None else post[0]
    key = (dt_i, kind, None if kind is None else post[1], dtype)
    k = tab.consts.get(key)
    if k is None:
        k = tab.consts[key] = _constants(P, dt_i, post, dtype)
    return k


def _check(tab, old, ref, lm, fc):
    dt, dev = ref.H.dtype, ref.H.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"laddie_stage: unsupported dtype {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"laddie_stage: unsupported device {dev}")
    nV, nTri = tab.nV, tab.nTri
    nd = fc["z_ocean"].shape[0]
    want = ([(t, (nV,), dt) for t in (old.H, old.T, old.S, ref.H, ref.T,
                                      ref.S, fc["Hib"], fc["Ti_base"],
                                      fc["SGD"])]
            + [(t, (nTri,), dt) for t in (old.U, old.V, ref.U, ref.V,
                                          fc["dHib_dx_b"], fc["dHib_dy_b"])]
            + [(fc["T_ocean"], (nV, nd), dt), (fc["S_ocean"], (nV, nd), dt),
               (fc["z_ocean"], (nd,), dt)]
            + [(t, (nV,), torch.bool) for t in (lm.a, lm.gr_a, lm.oc_a)]
            + [(t, (nTri,), torch.bool) for t in (lm.b, lm.gl_b, lm.cf_b)])
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"laddie_stage: an operand is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != dev:
            raise ValueError("laddie_stage: operands on different devices")
    if nd < 2:
        raise ValueError("laddie_stage: z_ocean needs 2 levels or more")
    if tab.LcA.dtype != dt or tab.LcA.device != dev:
        raise ValueError("laddie_stage: tables of another type or device")
    if dev.type == "cuda" and nd > MAX_ND:
        raise ValueError(f"laddie_stage: z_ocean has {nd} levels, the "
                         f"kernel takes {MAX_ND} at most")


def _static_desc(tab: LaddieTables):
    """The descriptor with the tables' fields filled in, once a mesh."""
    d = _LaddieDesc()
    k32 = tab.k32
    for n in ("C", "VET", "Tri", "TriC", "TriET", "TriEV", "TriCV",
              "ba_len", "ab_len", "dx_len", "dy_len"):
        setattr(d, n, k32[n].data_ptr())
    for n in ("LcA", "Dx_D", "Dy_D", "TDx_D", "TDy_D", "TriD", "TriCw",
              "TriA", "nb_border"):
        t = getattr(tab, n).contiguous()
        setattr(tab, n, t)
        setattr(d, n, t.data_ptr())
    for pre, M in (("ba", tab.M_map_b_a), ("ab", tab.M_map_a_b),
                   ("dx", tab.M_ddx_a_b), ("dy", tab.M_ddy_a_b)):
        setattr(d, pre + "_cols", M.cols.data_ptr())
        setattr(d, pre + "_vals", M.vals.data_ptr())
    d.nV, d.nTri, d.Kc = tab.nV, tab.nTri, tab.C.shape[1]
    d.Kba, d.Kab = tab.M_map_b_a.cols.shape[0], tab.M_map_a_b.cols.shape[0]
    d.Kdx, d.Kdy = tab.M_ddx_a_b.cols.shape[0], tab.M_ddy_a_b.cols.shape[0]
    return d


def _set_ptrs(d, named, keep):
    """Each tensor's address into the descriptor's field of its name (a
    contiguous copy, kept alive in `keep`, where it is not contiguous)."""
    for n, t in named.items():
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        setattr(d, n, t.data_ptr())


def _set_inputs(d, P, lm, fc, keep):
    """The masks, the forcing and their flags into the descriptor."""
    d.jenkins, d.use_Ti = int(P.jenkins), int(bool(fc["use_Ti"]))
    d.nd = fc["z_ocean"].shape[0]
    _set_ptrs(d, dict(a=lm.a, gr_a=lm.gr_a, oc_a=lm.oc_a, b=lm.b,
                      gl_b=lm.gl_b, cf_b=lm.cf_b, Hib=fc["Hib"],
                      Ti_base=fc["Ti_base"], SGD=fc["SGD"],
                      dHib_dx_b=fc["dHib_dx_b"], dHib_dy_b=fc["dHib_dy_b"],
                      z_ocean=fc["z_ocean"], T_ocean=fc["T_ocean"],
                      S_ocean=fc["S_ocean"]), keep)


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def laddie_stage(tab: LaddieTables, P: LaddieParams, old, ref, lm, fc, dt_i,
                 include_visc, post=None):
    """One stage and the scheme's update after it: (state, filtered, ph),
    as `laddie_stage_plain` returns them. On a CUDA tensor the kernel (two
    launches), on a CPU tensor the plain version."""
    global launches, kernel_launches
    _check(tab, old, ref, lm, fc)
    dev = ref.H.device
    if dev.type == "cpu":
        return laddie_stage_plain(tab, P, old, ref, lm, fc, dt_i,
                                  include_visc, post)
    lib = load_kernels()
    dt = ref.H.dtype
    if tab.desc is None:
        tab.desc = _static_desc(tab)
    d = tab.desc
    kind = None if post is None else post[0]
    d.k = _stage_constants(tab, P, dt_i, post, dt)
    d.visc = int(bool(include_visc))
    d.post = _POST[kind]
    keep = []
    _set_inputs(d, P, lm, fc, keep)
    _set_ptrs(d, dict(oH=old.H, oU=old.U, oV=old.V, oT=old.T, oS=old.S,
                      rH=ref.H, rU=ref.U, rV=ref.V, rT=ref.T, rS=ref.S,
                      nowH=post[2] if kind in ("blend", "blend3")
                      else ref.H), keep)
    nV, nTri = tab.nV, tab.nTri
    ev = lambda n: torch.empty(n, dtype=dt, device=dev)
    Hn, Tn, Sn, detr, Un, Vn = ev(nV), ev(nV), ev(nV), ev(nV), ev(nTri), \
        ev(nTri)
    ph = torch.empty((len(PH_FIELDS), nV), dtype=dt, device=dev)
    Hs = ev(nV) if kind in ("blend", "blend3") else Hn
    filt = None
    if kind == "lfra":
        filt = LaddieState(H=ev(nV), U=ev(nTri), V=ev(nTri), T=ev(nV),
                           S=ev(nV))
    for n, t in (("Hn", Hn), ("Hs", Hs), ("Tn", Tn), ("Sn", Sn),
                 ("detr", detr), ("ph", ph), ("Un", Un), ("Vn", Vn)):
        setattr(d, n, t.data_ptr())
    for n, t in zip(("fH", "fU", "fV", "fT", "fS"),
                    filt if filt is not None else (Hn,) * 5):
        setattr(d, n, t.data_ptr())
    fn = lib.laddie_stage_f32 if dt == torch.float32 else lib.laddie_stage_f64
    err = fn(ctypes.addressof(d), _stream(dev))
    if err != 0:
        raise RuntimeError(f"laddie_stage: kernel launch failed, CUDA error "
                           f"{err}")
    launches += 1
    kernel_launches += 2
    del keep
    state = LaddieState(H=Hs, U=Un, V=Vn, T=Tn, S=Sn)
    return state, filt, dict(zip(PH_FIELDS, ph))


def _leg_desc(tab, P, sch, state, lm, fc, n_steps):
    """(the leg's descriptor, its four state sets, its ph, the tensors it
    points to). The state sets, the scratch (H before the blend, detr) and
    ph are one allocation."""
    dt, dev = state.H.dtype, state.H.device
    if tab.desc is None:
        tab.desc = _static_desc(tab)
    g = _LegDesc()
    g.d = tab.desc
    stages = sch.stages()
    for j, (dt_i, visc, kind, coefs) in enumerate(stages):
        k = _stage_constants(tab, P, dt_i,
                             None if kind is None else (kind, coefs), dt)
        if j == 0:
            g.d.k = k
        for q, n in enumerate(_SK_NAMES):
            g.sk[j][q] = k[_K_INDEX[n]]
        g.visc[j], g.post[j] = int(visc), _POST[kind]
    g.n_steps, g.scheme, g.n_stages = n_steps, _SCHEME[sch.kind], len(stages)
    keep = []
    _set_inputs(g.d, P, lm, fc, keep)
    _set_ptrs(g.init, state._asdict(), keep)
    nV, nTri = tab.nV, tab.nTri
    n_set = 3 * nV + 2 * nTri
    flat = torch.empty(4 * n_set + (2 + len(PH_FIELDS)) * nV, dtype=dt,
                       device=dev)
    keep.append(flat)
    sets = []
    for j in range(4):
        H, U, V, T, S = flat[j * n_set:(j + 1) * n_set].split(
            (nV, nTri, nTri, nV, nV))
        sets.append(LaddieState(H=H, U=U, V=V, T=T, S=S))
        _set_ptrs(g.buf[j], sets[j]._asdict(), keep)
    Hn, detr, ph = flat[4 * n_set:].split((nV, nV, len(PH_FIELDS) * nV))
    g.Hn, g.detr, g.ph = Hn.data_ptr(), detr.data_ptr(), ph.data_ptr()
    return g, sets, ph.view(len(PH_FIELDS), nV), keep


def laddie_leg(tab: LaddieTables, P: LaddieParams, sch: LaddieScheme,
               state: LaddieState, lm, fc, n_steps: int):
    """n_steps pseudo-steps of `laddie_step` from (state, state), a leg:
    (state, melt [m s^-1] of the last stage), as the loop of steps returns
    them. On a CUDA tensor one cooperative launch of the kernel (a failed
    launch raises), on a CPU tensor the loop of plain stages."""
    global launches, kernel_launches, last_leg_grid
    _check(tab, state, state, lm, fc)
    if n_steps < 1:
        raise ValueError(f"laddie_leg: n_steps {n_steps} < 1")
    dev = state.H.device
    if dev.type == "cpu":
        carry = (state, state)
        for _ in range(n_steps):
            carry, ph = laddie_step(tab, P, sch, carry, lm, fc,
                                    laddie_stage_plain)
        return carry[0], ph["melt"]
    g, sets, ph, keep = _leg_desc(tab, P, sch, state, lm, fc, n_steps)
    last_leg_grid = _leg_launch("laddie_leg", g, state.H.dtype, dev)
    launches += n_steps * g.n_stages
    kernel_launches += 1
    del keep
    return sets[(n_steps - 1) & 1], ph[0]


def _leg_launch(name, g, dtype, dev):
    """The library's `name`_f32 / _f64 on the leg's descriptor: the grid it
    took."""
    lib = load_kernels()
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    grid = ctypes.c_int(0)
    err = fn(ctypes.addressof(g), _stream(dev), ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"{name}: the cooperative launch failed, CUDA "
                           f"error {err}")
    return grid.value


def leg_barriers(tab, P, sch, state, lm, fc, n_steps):
    """The barriers of `laddie_leg` on these operands alone: an empty
    persistent kernel with two grid barriers a stage, on the leg's grid.
    Returns the grid. For timing; counted nowhere."""
    g, _, _, keep = _leg_desc(tab, P, sch, state, lm, fc, n_steps)
    return _leg_launch("laddie_leg_floor", g, state.H.dtype, state.H.device)


def row_lanes(tab: LaddieTables, fc, dtype):
    """The lanes of a warp each row of the tables takes in the kernel (32,
    4 or 1: the most whose rows fit in one co-resident wave)."""
    if tab.desc is None:
        tab.desc = _static_desc(tab)
    tab.desc.nd = fc["z_ocean"].shape[0]
    fn = load_kernels().laddie_lanes_f32 if dtype == torch.float32 \
        else load_kernels().laddie_lanes_f64
    return fn(ctypes.addressof(tab.desc))
