"""Basal hydrology: pore-water / overburden / effective pressure.

Re-derivation of src/UFEMISM/basal_hydrology/basal_hydrology_main.f90:
'none', Martin2011, Leguy2014 and the two error-function effective-pressure
parameterisations. The Salle2025 transient till/water-layer model is not
ported yet.
"""

from __future__ import annotations

import math

import torch

from ...utils.constants import ice_density, seawater_density, grav, pi


def calc_pore_water_pressure_none(Hi_eff):
    return torch.zeros_like(Hi_eff)


def calc_pore_water_fraction_martin2011(C, Hb, SL):
    """Martin et al. (2011) Eq. 12 pore-water scaling factor."""
    return torch.clamp(
        1.0 - (Hb - SL - C.Martin2011_hydro_Hb_min)
        / (C.Martin2011_hydro_Hb_max - C.Martin2011_hydro_Hb_min),
        0.0, 1.0)


def run_basal_hydrology(C, Hi_eff, Hb, SL, mask_grounded_ice=None):
    """Returns (pore_water_pressure, overburden_pressure,
    effective_pressure) (basal_hydrology_main.f90:65-105)."""
    choice = C.choice_basal_hydrology_model
    overburden = ice_density * grav * Hi_eff
    pore = torch.zeros_like(Hi_eff)
    if choice in ("Martin2011", "error_function_Martin2011"):
        # Martin et al. (2011) Eq. 11
        frac = calc_pore_water_fraction_martin2011(C, Hb, SL)
        pore = 0.96 * ice_density * grav * Hi_eff * frac
    elif choice not in ("none", "Leguy2014", "error_function_constant"):
        raise NotImplementedError(
            f"choice_basal_hydrology_model '{choice}' not yet implemented")

    eff = torch.clamp(overburden - pore, min=0.0)
    if choice == "Leguy2014":
        # Leguy et al. (2014): connectivity to the ocean reduces N where
        # the bed is below sea level (basal_hydrology_main.f90:276-314)
        Hi_f = torch.clamp(-seawater_density / ice_density * Hb, min=0.0)
        ratio = torch.clamp(1.0 - Hi_f / torch.clamp(Hi_eff, min=1e-30),
                            0.0, 1.0)
        eff = torch.where(
            Hi_eff > 0.0,
            overburden * ratio ** C.Leguy2014_hydro_connect_exponent, 0.0)
        if mask_grounded_ice is not None:
            eff = torch.where(mask_grounded_ice, eff, 0.0)
    elif choice == "error_function_Martin2011":
        # smooth saturation of N at N_max = max(0, P_o - P_w)
        # (calc_effective_pressure_error_function_M11)
        N_max = eff
        eff = torch.where(
            N_max > 0.0,
            torch.erf(overburden * math.sqrt(pi) / 2.0
                      / torch.clamp(N_max, min=1e-30)) * N_max, 0.0)
    elif choice == "error_function_constant":
        N_max = C.error_function_max_effective_pressure
        eff = torch.erf(overburden * math.sqrt(pi) / 2.0 / N_max) * N_max
    return pore, overburden, eff
