"""Integrated ice-sheet scalars: area, volume, VAF, mass fluxes.

Re-design of src/UFEMISM/ice_dynamics/utilities/ice_mass_and_fluxes.f90
(calc_icesheet_volume_and_area:138-183, calc_icesheet_integrated_fluxes
:188-331, calc_ice_transitional_fluxes:333-445): area-weighted reductions
over the vertex axis. Volumes reported in metres sea-level equivalent,
fluxes in Gt/yr (the reference's scalar_output_files.f90 units). Every
value is a 0-d tensor on the fields' device.
"""

from __future__ import annotations

import torch

from ...utils.constants import ice_density, seawater_density, ocean_area
from ..mesh_data import map_b_to_c
from .geometry import thickness_above_flotation


# The reference converts m^3 ice/yr -> "Gt/yr" with a flat 1.0E-9
# (ice_mass_and_fluxes.f90:226-428), i.e. water-equivalent-density
# convention; match it exactly so scalar outputs compare 1:1.
_TO_GT = 1e-9


def _flux_Gt(SMB, A, where):
    return torch.where(where, SMB * A, 0.0).sum() * _TO_GT


def calc_transitional_fluxes(md, Hi, masks, fraction_margin,
                             u_vav_b, v_vav_b):
    """Upwind lateral fluxes through the grounding line, calving fronts
    and ice margins [Gt/yr] (calc_ice_transitional_fluxes:333-445): flux
    across the shared Voronoi boundary (vi, vj) is L_c * u_perp * H_up."""
    u_c = map_b_to_c(md, u_vav_b)
    v_c = map_b_to_c(md, v_vav_b)
    u_e = md.ext_E(u_c)[md.VE]              # [nV, K]
    v_e = md.ext_E(v_c)[md.VE]
    u_perp = u_e * md.D_x / md.D + v_e * md.D_y / md.D

    C = md.C
    valid = md.mask_C
    Hi_vj = md.ext_V(Hi)[C]
    fm_vj = md.ext_V(fraction_margin)[C]

    m_gr = masks["mask_grounded_ice"]
    m_fl_j = md.ext_V(masks["mask_floating_ice"])[C]
    m_ocean_j = md.ext_V(masks["mask_icefree_ocean"])[C]
    m_land_j = md.ext_V(masks["mask_icefree_land"])[C]

    Lc = torch.where(valid, md.Cw, 0.0)
    fm_i = fraction_margin[:, None]

    # grounding line: out of grounded into floating (both flow signs,
    # upwind thickness)
    gl_pair = m_gr[:, None] & m_fl_j & valid
    gl = torch.where(gl_pair & (fm_i >= 1.0) & (u_perp > 0),
                     -Lc * u_perp * Hi[:, None], 0.0) \
        + torch.where(gl_pair & (fm_vj >= 1.0) & (u_perp < 0),
                      -Lc * u_perp * Hi_vj, 0.0)
    gl_flux = gl.sum() * _TO_GT

    def outflux(mask_i, mask_j_nbr):
        pair = mask_i[:, None] & mask_j_nbr & valid & (fm_i > 0)
        return (torch.where(pair, -Lc * torch.clamp(u_perp, min=0.0)
                            * Hi[:, None], 0.0)).sum() * _TO_GT

    return dict(gl_flux=gl_flux,
                cf_gr_flux=outflux(masks["mask_cf_gr"], m_ocean_j),
                cf_fl_flux=outflux(masks["mask_cf_fl"], m_ocean_j),
                margin_land_flux=outflux(masks["mask_margin"], m_land_j),
                margin_ocean_flux=outflux(masks["mask_margin"], m_ocean_j))


def calc_ice_scalars(md, Hi, Hb, SL, fraction_gr, SMB, BMB, LMB,
                     roi_mask=None, masks=None, fraction_margin=None,
                     u_vav_b=None, v_vav_b=None, dHi_dt=None,
                     dHi_dt_target=None, dHi_dt_residual=None):
    """Returns a dict of integrated scalars; roi_mask [nV] restricts the
    reductions to a region of interest (ice_mass_and_fluxes_ROI.f90).
    With masks/velocities provided, also returns the per-zone SMB/BMB
    splits, transitional fluxes, and dV/dt."""
    A = md.A if roi_mask is None else torch.where(roi_mask, md.A, 0.0)
    has_ice = Hi > 0.1
    TAF = thickness_above_flotation(Hi, Hb, SL)

    area = torch.where(has_ice, A, 0.0).sum()
    # m sea-level equivalent
    sle = ice_density / (seawater_density * ocean_area)
    volume = torch.where(has_ice, Hi * A, 0.0).sum() * sle
    volume_af = torch.where(has_ice, torch.clamp(TAF, min=0.0) * A,
                            0.0).sum() * sle

    out = dict(ice_area=area, ice_volume=volume, ice_volume_af=volume_af,
               SMB_total=(SMB * A).sum() * _TO_GT,
               BMB_total=(BMB * A).sum() * _TO_GT,
               LMB_total=(LMB * A).sum() * _TO_GT)

    if masks is not None:
        m_gr = masks["mask_grounded_ice"]
        m_fl = masks["mask_floating_ice"]
        out.update(
            SMB_gr=_flux_Gt(SMB, A, m_gr), SMB_fl=_flux_Gt(SMB, A, m_fl),
            SMB_land=_flux_Gt(SMB, A, masks["mask_icefree_land"]),
            SMB_ocean=_flux_Gt(SMB, A, masks["mask_icefree_ocean"]),
            BMB_gr=_flux_Gt(BMB, A, m_gr), BMB_fl=_flux_Gt(BMB, A, m_fl),
            LMB_gr=_flux_Gt(LMB, A, m_gr), LMB_fl=_flux_Gt(LMB, A, m_fl))
        if dHi_dt is not None:
            out["dV_dt"] = (dHi_dt * A).sum() * _TO_GT        # [Gt/yr]
        if dHi_dt_target is not None:
            amb = -dHi_dt_target - (dHi_dt_residual
                                    if dHi_dt_residual is not None else 0.0)
            out["AMB_total"] = (amb * A).sum() * _TO_GT
        if u_vav_b is not None and fraction_margin is not None \
                and roi_mask is None:
            out.update(calc_transitional_fluxes(
                md, Hi, masks, fraction_margin, u_vav_b, v_vav_b))
    return out
