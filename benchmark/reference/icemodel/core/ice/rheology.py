"""Ice rheology: Glen's flow law factor A(T).

Re-derivation of src/UFEMISM/ice_dynamics/rheology/constitutive_equation.f90:
uniform or Huybrechts (1992) Arrhenius temperature-dependent flow factor,
with grounded/floating enhancement factors ('separate' or grounded-fraction
'interp' transition).
"""

from __future__ import annotations

import torch

# Arrhenius parameters (constitutive_equation.f90:94-97, Huybrechts 1992)
_T_SWITCH = 263.15    # [K]
_A_LOW = 1.14e-05     # [Pa^-3 yr^-1]
_A_HIGH = 5.47e+10    # [Pa^-3 yr^-1]
_Q_LOW = 6.0e+04      # [J mol^-1]
_Q_HIGH = 13.9e+04    # [J mol^-1]
_R_GAS = 8.314


def _enh_by_mask(C, Ti, mask_grounded, mask_floating):
    one = torch.ones(mask_grounded.shape, dtype=Ti.dtype, device=Ti.device)
    return torch.where(mask_grounded, C.m_enh_sheet * one,
                       torch.where(mask_floating, C.m_enh_shelf * one, one))


def calc_ice_rheology_glen(C, md, Hi, Hs, Ti, mask_grounded, mask_floating,
                           fraction_gr=None, Hib=None, SL=None):
    """A_flow [nV, nz] in Pa^-n yr^-1."""
    choice = C.choice_ice_rheology_Glen
    if choice == "uniform":
        A0 = C.uniform_Glens_flow_factor
        if md is not None and md.extras and "glen_A_scale" in md.extras:
            # dynamic multiplier: the MISMIP+ flow-factor tuning adjusts
            # it between coupling intervals without rebuilding the step
            # (inversion_utilities.f90 MISMIPplus_adapt_flow_factor)
            A0 = A0 * md.x("glen_A_scale").to(Ti.dtype)
        A = torch.zeros_like(Ti) + A0
    elif choice == "Huybrechts1992":
        A = torch.where(Ti < _T_SWITCH,
                        _A_LOW * torch.exp(-_Q_LOW / (_R_GAS * Ti)),
                        _A_HIGH * torch.exp(-_Q_HIGH / (_R_GAS * Ti)))
    else:
        raise ValueError(f"unknown choice_ice_rheology_Glen '{choice}'")

    # flow enhancement factors
    trans = C.choice_enhancement_factor_transition
    if trans == "separate":
        enh = _enh_by_mask(C, Ti, mask_grounded, mask_floating)
    elif trans == "interp":
        if fraction_gr is None:
            enh = _enh_by_mask(C, Ti, mask_grounded, mask_floating)
        else:
            below_sl = (Hi > 0) & (Hib < SL) if Hib is not None else \
                mask_floating
            enh_i = (fraction_gr * C.m_enh_sheet
                     + (1 - fraction_gr) * C.m_enh_shelf)
            enh = torch.where(below_sl, enh_i,
                              _enh_by_mask(C, Ti, mask_grounded,
                                           mask_floating))
    else:
        raise ValueError(
            f"unknown choice_enhancement_factor_transition '{trans}'")
    return A * enh[:, None]
