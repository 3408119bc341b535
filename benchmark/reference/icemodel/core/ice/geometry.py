"""Basic ice-geometry relations (surface elevation, flotation).

Re-derivation of src/UPSY/basic/math_utilities/ice_geometry_basics.f90.
The torch versions run on the device; *_np variants are host-side numpy
used during mesh building.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.constants import ice_density, seawater_density


def ice_surface_elevation(Hi, Hb, SL):
    """Hs = Hi + max(SL - rho_i/rho_sw * Hi, Hb)."""
    return Hi + torch.maximum(SL - ice_density / seawater_density * Hi, Hb)


def thickness_above_flotation(Hi, Hb, SL):
    """TAF = Hi - max(0, (SL - Hb) * rho_sw/rho_i)."""
    return Hi - torch.clamp((SL - Hb) * (seawater_density / ice_density),
                            min=0.0)


def Hi_from_Hb_Hs_and_SL(Hb, Hs, SL):
    Hi_float = torch.clamp((SL - Hb) * (seawater_density / ice_density),
                           min=0.0)
    Hs_float = Hb + Hi_float
    return torch.where(
        Hs > Hs_float,
        Hs - Hb,
        torch.minimum(Hi_float,
                      (Hs - SL) / (1.0 - ice_density / seawater_density)))


def height_of_water_column_at_ice_front(Hi, Hb, SL):
    return torch.minimum(torch.clamp(SL - Hb, min=0.0),
                         ice_density / seawater_density * Hi)


# ---- numpy variants for host-side mesh building ---------------------------

def ice_surface_elevation_np(Hi, Hb, SL):
    return Hi + np.maximum(SL - ice_density / seawater_density * Hi, Hb)


def thickness_above_flotation_np(Hi, Hb, SL):
    return Hi - np.maximum(0.0, (SL - Hb) * (seawater_density / ice_density))
