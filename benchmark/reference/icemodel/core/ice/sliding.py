"""Sliding laws: basal friction coefficient beta from basal velocity.

Vectorised re-derivation of src/UFEMISM/ice_dynamics/conservation_of_momentum/
sliding_laws.f90: Weertman / Coulomb / Budd / Tsai2015 / Schoof2005 /
Zoet-Iverson / idealised, with grounded-fraction scaling of bed roughness
and the Bueler & Brown (2009) velocity regularisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mesh_data import MeshData, EField
from ...utils.constants import pi
from ..analytical import schoof_icestream
from .hydrology import run_basal_hydrology


def _uabs(C, u_a, v_a):
    return torch.sqrt(C.slid_delta_v ** 2 + u_a ** 2 + v_a ** 2)


def apply_grounded_fractions_to_bed_roughness(C, masks, Hi, Hs_slope,
                                              fraction_gr, bed_roughness):
    """Scale bed roughness by grounded fraction (sliding_laws.f90:568)."""
    if not C.do_subgrid_friction_on_A_grid:
        return bed_roughness
    exponent_hi = torch.log10(torch.clamp(Hi, min=1.0))
    exponent_hs = Hs_slope / 0.005
    exponent_gr = torch.clamp(exponent_hi - exponent_hs, min=0.0)
    w_trans = fraction_gr ** exponent_gr
    weight = torch.ones_like(Hi)
    weight = torch.where(masks["mask_floating_ice"]
                         | masks["mask_icefree_ocean"], 0.0, weight)
    weight = torch.where(masks["mask_grounded_ice"], 1.0, weight)
    trans = (masks["mask_gl_gr"] | masks["mask_cf_gr"] | masks["mask_gl_fl"])
    weight = torch.where(trans, w_trans, weight)
    return bed_roughness * torch.clamp(weight, 0.0, 1.0)


def _extend_till_yield_to_neighbours(md: MeshData, masks, tau_y):
    """Ice-free land vertices next to grounded ice take the min neighbour
    till yield stress (extend_till_yield_stress_to_neighbours)."""
    nbr_gr = md.ext_V(masks["mask_grounded_ice"])[md.C] & md.mask_C
    tau_nbr = torch.where(nbr_gr, md.ext_V(tau_y)[md.C], torch.inf)
    min_nbr = tau_nbr.min(dim=1).values
    use = masks["mask_icefree_land"] & torch.isfinite(min_nbr)
    return torch.where(use, min_nbr, tau_y)


def calc_basal_friction_coefficient(C, md: MeshData, bed_roughness,
                                    u_a, v_a, Hi, Hi_eff, Hb, SL, Hs_slope,
                                    fraction_gr, masks):
    """beta such that tau_b = beta * u (sliding_laws.f90:24).

    bed_roughness: dict with 'beta_sq', 'till_friction_angle', 'alpha_sq'
    tensors on the a-grid.
    """
    choice = C.choice_sliding_law
    uabs = _uabs(C, u_a, v_a)

    if choice == "no_sliding":
        beta = torch.zeros_like(u_a)
        return torch.clamp(beta, max=C.slid_beta_max)

    if choice == "idealised":
        # the static analytic field (tau_y for SSA_icestream, beta
        # otherwise), registered by register_sliding_static
        if md.extras and "slid_ideal" in md.extras:
            arr = md.x("slid_ideal").to(uabs.dtype)
            if C.choice_idealised_sliding_law == "SSA_icestream":
                beta = arr / uabs
            else:
                beta = arr * torch.ones_like(uabs)
            return torch.clamp(beta, max=C.slid_beta_max)
        return torch.clamp(_idealised_sliding(C, md, uabs),
                           max=C.slid_beta_max).to(uabs.dtype)

    if C.choice_basal_hydrology_model == "Salle2025" \
            and md.extras and "hydro_N_eff" in md.extras:
        # the transient till model: the effective pressure of the
        # Salle2025 leg at its own cadence (basal_hydrology_new.f90),
        # registered in md.extras by the region
        N_eff = torch.clamp(md.x("hydro_N_eff").to(Hi_eff.dtype), min=0.0)
    else:
        _, _, N_eff = run_basal_hydrology(
            C, Hi_eff, Hb, SL,
            mask_grounded_ice=masks.get("mask_grounded_ice"))

    if choice == "Weertman":
        rough = apply_grounded_fractions_to_bed_roughness(
            C, masks, Hi, Hs_slope, fraction_gr, bed_roughness["beta_sq"])
        beta = rough * uabs ** (1.0 / C.slid_Weertman_m - 1.0)

    elif choice in ("Coulomb", "Budd", "Zoet-Iverson"):
        rough = apply_grounded_fractions_to_bed_roughness(
            C, masks, Hi, Hs_slope, fraction_gr,
            bed_roughness["till_friction_angle"])
        # NOTE the reference's till yield stress is LINEAR in the till
        # friction angle: tau_y = N * tan(pi/180) * phi_deg, i.e. the
        # small-angle form tan(1 deg)*phi, NOT tan(phi*pi/180) - see
        # sliding_laws.f90:158 (Coulomb), :214 (Budd), :379
        # (Zoet-Iverson), all 'tan(pi / 180._dp) * bed_roughness_applied'.
        tau_y = N_eff * math.tan(pi / 180.0) * rough
        tau_y = _extend_till_yield_to_neighbours(md, masks, tau_y)
        if choice == "Coulomb":
            beta = tau_y / uabs
        elif choice == "Budd":
            beta = (tau_y * uabs ** (C.slid_Budd_q_plastic - 1.0)
                    / (C.slid_Budd_u_threshold ** C.slid_Budd_q_plastic))
        else:  # Zoet-Iverson (2020) Eq. 3
            p = C.slid_ZI_p
            beta = (tau_y * uabs ** (1.0 / p - 1.0)
                    * (uabs + C.slid_ZI_ut) ** (-1.0 / p))

    elif choice == "Tsai2015":
        rough = apply_grounded_fractions_to_bed_roughness(
            C, masks, Hi, Hs_slope, fraction_gr, bed_roughness["beta_sq"])
        # Asay-Davis et al. (2016), Eq. 7
        beta = torch.minimum(bed_roughness["alpha_sq"] * N_eff,
                             rough * uabs ** (1.0 / C.slid_Weertman_m)) / uabs

    elif choice == "Schoof2005":
        rough = apply_grounded_fractions_to_bed_roughness(
            C, masks, Hi, Hs_slope, fraction_gr, bed_roughness["beta_sq"])
        aN = bed_roughness["alpha_sq"] * N_eff
        m = C.slid_Weertman_m
        # Asay-Davis et al. (2016), Eq. 11
        beta = ((rough * uabs ** (1.0 / m) * aN)
                / ((rough ** m * uabs + aN ** m) ** (1.0 / m))) / uabs

    else:
        raise ValueError(f"unknown choice_sliding_law '{choice}'")

    return torch.clamp(beta, max=C.slid_beta_max)


def _idealised_field(C, V):
    """The idealised law's static field on vertices V (host numpy, f64):
    the till yield stress for SSA_icestream, beta otherwise."""
    choice = C.choice_idealised_sliding_law
    if choice == "SSA_icestream":
        _, field = schoof_icestream(
            C.uniform_Glens_flow_factor, C.Glens_flow_law_exponent,
            C.refgeo_idealised_SSA_icestream_Hi,
            C.refgeo_idealised_SSA_icestream_dhdx,
            C.refgeo_idealised_SSA_icestream_L,
            C.refgeo_idealised_SSA_icestream_m, V[:, 1])
        return field
    if choice == "ISMIP-HOM_C":
        L = C.refgeo_idealised_ISMIP_HOM_L
        return 1000.0 + 1000.0 * np.sin(2 * np.pi * V[:, 0] / L) \
            * np.sin(2 * np.pi * V[:, 1] / L)
    if choice == "ISMIP-HOM_D":
        L = C.refgeo_idealised_ISMIP_HOM_L
        return 1000.0 + 1000.0 * np.sin(2 * np.pi * V[:, 0] / L)
    if choice == "ISMIP-HOM_F":
        return np.full(len(V), (C.uniform_Glens_flow_factor * 1000.0) ** -1)
    raise ValueError(f"unknown choice_idealised_sliding_law '{choice}'")


def register_sliding_static(C, mesh, md):
    """Register the idealised-sliding static field into md.extras (host
    side, once per mesh)."""
    if C.choice_sliding_law != "idealised" or "slid_ideal" in md.extras:
        return
    md.extras["slid_ideal"] = EField(torch.as_tensor(
        _idealised_field(C, mesh.V), dtype=md.A.dtype, device=md.device),
        "V")


def _idealised_sliding(C, md: MeshData, uabs):
    """Idealised sliding laws from the analytic field on md.V, for a
    MeshData without the registered table."""
    V = md.V.double().cpu().numpy()
    field = torch.as_tensor(_idealised_field(C, V), dtype=torch.float64,
                            device=uabs.device)
    if C.choice_idealised_sliding_law == "SSA_icestream":
        return field / uabs
    return field * torch.ones_like(uabs)
