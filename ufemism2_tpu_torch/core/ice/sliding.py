"""Sliding laws: basal friction coefficient beta from basal velocity.

Vectorised re-derivation of src/UFEMISM/ice_dynamics/conservation_of_momentum/
sliding_laws.f90. Ported so far: no_sliding and Zoet-Iverson, with
grounded-fraction scaling of bed roughness and the Bueler & Brown (2009)
velocity regularisation. Weertman, Coulomb, Budd, Tsai2015, Schoof2005 and
the idealised laws raise NotImplementedError.
"""

from __future__ import annotations

import math

import torch

from ..mesh_data import MeshData
from ...utils.constants import pi
from .hydrology import run_basal_hydrology

_PORTED_LAWS = ("no_sliding", "Zoet-Iverson")


def _check_law(choice):
    if choice not in _PORTED_LAWS:
        raise NotImplementedError(
            f"choice_sliding_law '{choice}' is not ported yet "
            f"(ported: {', '.join(_PORTED_LAWS)})")


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
    nbr_gr = masks["mask_grounded_ice"][md.C] & md.mask_C
    tau_nbr = torch.where(nbr_gr, tau_y[md.C], torch.inf)
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
    _check_law(choice)
    uabs = _uabs(C, u_a, v_a)

    if choice == "no_sliding":
        beta = torch.zeros_like(u_a)
        return torch.clamp(beta, max=C.slid_beta_max)

    _, _, N_eff = run_basal_hydrology(
        C, Hi_eff, Hb, SL,
        mask_grounded_ice=masks.get("mask_grounded_ice"))

    rough = apply_grounded_fractions_to_bed_roughness(
        C, masks, Hi, Hs_slope, fraction_gr,
        bed_roughness["till_friction_angle"])
    # NOTE the reference's till yield stress is LINEAR in the till
    # friction angle: tau_y = N * tan(pi/180) * phi_deg, i.e. the
    # small-angle form tan(1 deg)*phi, NOT tan(phi*pi/180) - see
    # sliding_laws.f90:379 'tan(pi / 180._dp) * bed_roughness_applied'.
    tau_y = N_eff * math.tan(pi / 180.0) * rough
    tau_y = _extend_till_yield_to_neighbours(md, masks, tau_y)
    # Zoet-Iverson (2020) Eq. 3
    p = C.slid_ZI_p
    beta = (tau_y * uabs ** (1.0 / p - 1.0)
            * (uabs + C.slid_ZI_ut) ** (-1.0 / p))
    return torch.clamp(beta, max=C.slid_beta_max)


def register_sliding_static(C, mesh, md):
    """Register the sliding law's static fields into md.extras. The ported
    laws need none; an unported law is refused here, at set-up."""
    _check_law(C.choice_sliding_law)
