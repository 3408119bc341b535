"""Salle2025 transient basal hydrology: the Bueler & Van Pelt (2015)
two-layer (water sheet + till) subglacial hydrology model.

Port of the JAX package's core/ice/hydrology_salle2025.py (a re-design of
the reference's src/UFEMISM/basal_hydrology/basal_hydrology_new.f90,
basal_hydrology_leg:34-75, basal_hydrology:79-156 and the calc_* routines
it calls): the coupled W / W_til / P system is integrated in SI seconds
with an adaptive CFL + diffusion sub-step until `basal_hydro_equil_time`
model-years have elapsed; the till effective pressure and yield stress go
back to the sliding laws. The JAX package's lax.while_loop is a Python
loop here with the same test (t < t_goal, at most `max_substeps`) and so
the same count of sub-steps: one host read of t a sub-step, at the
hydrology's coupling cadence.

Physical constants follow the reference/paper values
(basal_hydrology_new.f90: c1=0.5, c2=0.04, A=3.1689e-24 Pa^-3 s^-1,
k=0.001, alpha=1.25, beta=1.5, phi_englacial=0.01, W_r=0.1 m,
m=0.0069 m/yr w.e., Cd=0.001 m/yr, W_max_til=2 m, N0=1000 Pa,
delta=0.02, e0=0.69, Cc=0.12, till friction angle 26.565 deg).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh_data import map_b_to_c
from ...utils.constants import grav, ice_density, sec_per_year, pi

RHO_W = 1000.0
C1_CAVITATION = 0.5          # [m^-1]
C2_CREEP = 0.04
A_SOFTNESS = 3.1689e-24      # [Pa^-3 s^-1]
K_COND = 0.001
ALPHA = 1.25
BETA = 1.5
PHI_ENGLACIAL = 0.01
W_R = 0.1                    # [m] bed roughness scale
M_MELT = 0.0069 * RHO_W / sec_per_year   # [kg m^-2 s^-1]
CD_DRAIN = 0.001 / sec_per_year          # [m s^-1]
W_MAX = 1000.0
W_MAX_TIL = 2.0
N0_TILL = 1000.0             # [Pa]
DELTA_TILL = 0.02
E0_TILL = 0.69
CC_TILL = 0.12
PHI_TILL_DEG = 26.565


@dataclass
class Salle2025State:
    W: torch.Tensor        # [nV] water-sheet thickness [m]
    W_til: torch.Tensor    # [nV] till water thickness [m]
    P: torch.Tensor        # [nV] water pressure [Pa]


def init_salle2025_state(md, dtype=None):
    z = torch.zeros(md.nV, dtype=dtype or md.A.dtype, device=md.device)
    return Salle2025State(W=z, W_til=z.clone(), P=z.clone())


def _min_tri_side(md):
    """The shortest side of each triangle [nTri]."""
    V = md.V
    a, b, c = V[md.Tri[:, 0]], V[md.Tri[:, 1]], V[md.Tri[:, 2]]
    d = torch.stack([torch.linalg.norm(b - a, dim=1),
                     torch.linalg.norm(c - b, dim=1),
                     torch.linalg.norm(a - c, dim=1)])
    return d.min(dim=0).values


def _hydro_step(md, h, Hi, Hb, mask_gr, mask_b, u_base_si, v_base_si,
                dt_max_s, d_min):
    """One adaptive sub-step; returns (new state, dt taken [s])."""
    P_o = ice_density * grav * Hi
    W = torch.clamp(h.W, 0.0, W_MAX)
    W_til = torch.clamp(h.W_til, 0.0, W_MAX_TIL)
    P = torch.minimum(torch.clamp(h.P, min=0.0), P_o)

    # hydraulic potential and its b-grid gradient (calc_R / calc_K)
    R = (Hb + W) * RHO_W * grav + P
    dR_dx = md.M_ddx_a_b @ R
    dR_dy = md.M_ddy_a_b @ R
    W_b = md.M_map_a_b @ W
    grad2 = dR_dx ** 2 + dR_dy ** 2 + 1e-8
    K_b = torch.where(mask_b,
                      K_COND * torch.clamp(W_b, min=0.0) ** (ALPHA - 1.0)
                      * grad2 ** ((BETA - 2.0) / 2.0), 0.0)
    D_b = RHO_W * grav * K_b * torch.clamp(W_b, min=0.0)
    u_b = -K_b * dR_dx
    v_b = -K_b * dR_dy

    # adaptive sub-step (get_basal_hydro_timestep): CFL + diffusion
    dt_cfl = (d_min / (2.0 * (u_b.abs() + v_b.abs()) + 1e-30)).min()
    dt_W = (d_min ** 2 / (8.0 * (D_b + 1e-7))).min()
    dt_P = (2.0 * PHI_ENGLACIAL * d_min ** 2 / (8.0 * (D_b + 1e-7))).min()
    dt = 0.9 * torch.minimum(torch.minimum(dt_cfl, dt_W),
                             torch.minimum(dt_P, dt_max_s))

    # upwind flux divergence over Voronoi boundaries (calc_divQ)
    u_c = map_b_to_c(md, u_b)
    v_c = map_b_to_c(md, v_b)
    u_perp = u_c[md.VE] * md.D_x / md.D + v_c[md.VE] * md.D_y / md.D
    W_j = W[md.C]
    gr_j = mask_gr[md.C]
    LcA = torch.where(md.mask_C, md.Cw / md.A[:, None], 0.0)
    out_flux = LcA * torch.clamp(u_perp, min=0.0) * W[:, None]
    in_flux = torch.where(gr_j, LcA * torch.clamp(u_perp, max=0.0) * W_j,
                          0.0)
    divQ = torch.where(mask_gr, (out_flux + in_flux).sum(dim=1), 0.0)

    # till/water partition of the source (calc_q_til)
    q_til = torch.minimum(W_MAX_TIL - W_til + CD_DRAIN * dt,
                          (M_MELT / RHO_W) * dt)
    q_water = (CD_DRAIN + M_MELT / RHO_W) * dt - q_til

    # opening/closing (calc_opening_rate / calc_closing_rate)
    O_rate = C1_CAVITATION * torch.sqrt(u_base_si ** 2 + v_base_si ** 2) \
        * torch.clamp(W_R - W, min=0.0)
    C_rate = C2_CREEP * A_SOFTNESS * (P_o - P) ** 3 * W

    # pressure update (calc_P_next; no-sliding closure for W=0)
    Z = C_rate - O_rate + q_water / dt
    P_new = P + dt * (RHO_W * grav / PHI_ENGLACIAL) * (-divQ + Z)
    P_new = torch.minimum(torch.clamp(P_new, min=0.0), P_o)
    P_new = torch.where(~mask_gr | ((W <= 0.0) & mask_gr), P_o, P_new)
    P_new = torch.where(Hi <= 0.0, 0.0, P_new)

    # layer thickness updates (calc_W_water_W_til_next)
    W_new = torch.where(mask_gr,
                        torch.clamp(W + q_water - dt * divQ, 0.0, W_MAX), 0.0)
    W_til_new = torch.where(mask_gr,
                            torch.clamp(W_til + q_til, 0.0, W_MAX_TIL), 0.0)
    return Salle2025State(W=W_new, W_til=W_til_new, P=P_new), dt


def run_salle2025_leg(C, md, h, Hi, Hb, mask_grounded_ice, u_base, v_base,
                      max_substeps=2000):
    """Integrate the hydrology to `basal_hydro_equil_time` model-years in
    adaptive sub-steps (basal_hydrology_leg).

    u_base / v_base on the a-grid in m/yr (converted to SI inside).
    Returns (state, till effective pressure N_til [Pa], till yield stress
    tau_c [Pa], number of sub-steps)."""
    mask_b = mask_grounded_ice[md.Tri].any(dim=1)
    u_si = u_base / sec_per_year
    v_si = v_base / sec_per_year
    t_goal = C.basal_hydro_equil_time * sec_per_year
    dt_max = torch.tensor(C.dt_ice_max * sec_per_year, dtype=md.A.dtype,
                          device=md.device)
    d_min = _min_tri_side(md)
    t = torch.zeros((), dtype=md.A.dtype, device=md.device)
    it = 0
    while it < max_substeps and bool(t < t_goal):
        h, dt = _hydro_step(md, h, Hi, Hb, mask_grounded_ice, mask_b, u_si,
                            v_si, torch.minimum(dt_max, t_goal - t), d_min)
        t = t + dt
        it += 1
    N_til, tau_c = salle2025_till_outputs(h, Hi)
    return h, N_til, tau_c, it


def salle2025_till_outputs(h, Hi):
    """Till effective pressure (Bueler & Van Pelt 2015 Eq. 23, with the
    water-layer pressure correction, calc_N_til) and yield stress
    (calc_yield_stress)."""
    P_o = ice_density * grav * Hi
    s = h.W_til / W_MAX_TIL
    N_til = torch.minimum(
        P_o, N0_TILL * (DELTA_TILL * P_o / N0_TILL) ** s
        * 10.0 ** (E0_TILL / CC_TILL * (1.0 - s)))
    N_til = N_til - RHO_W * grav * h.W
    tau_c = math.tan(PHI_TILL_DEG * pi / 180.0) * N_til
    return N_til, tau_c
