"""Ice masks (vectorised neighbour-gather version of masks_mod.f90).

Mask type codes follow the reference (model_configuration ... C%type_*):
1 icefree_land, 2 icefree_ocean, 3 grounded_ice, 4 floating_ice,
5 gl_gr, 6 gl_fl, 7 cf_gr, 8 cf_fl, 9 margin, 10 coastline.
"""

from __future__ import annotations

import torch

from ..mesh_data import MeshData
from ...utils.constants import ice_density, seawater_density

TYPE_ICEFREE_LAND = 1
TYPE_ICEFREE_OCEAN = 2
TYPE_GROUNDED_ICE = 3
TYPE_FLOATING_ICE = 4
TYPE_GL_GR = 5
TYPE_GL_FL = 6
TYPE_CF_GR = 7
TYPE_CF_FL = 8
TYPE_MARGIN = 9
TYPE_COASTLINE = 10


def is_floating(Hi, Hb, SL):
    """Flotation criterion (ice_geometry_basics.f90:20)."""
    return Hi < (SL - Hb) * (seawater_density / ice_density)


def _any_nbr(md: MeshData, flag):
    """True where any (real) neighbour satisfies flag [nV]->[nV]."""
    return (md.ext_V(flag)[md.C] & md.mask_C).any(dim=1)


def determine_masks(md: MeshData, Hi, Hb, SL):
    """All ice masks; returns a dict (reference determine_masks,
    masks_mod.f90:25)."""
    floating = is_floating(Hi, Hb, SL)
    has_ice = Hi > 0.0
    m_fl = floating & has_ice
    m_ocean = floating & ~has_ice
    m_gr = ~floating & has_ice
    m_land = ~floating & ~has_ice

    ice = m_gr | m_fl
    m_margin = ice & _any_nbr(md, ~ice)
    m_gl_gr = m_gr & _any_nbr(md, m_fl)
    m_gl_fl = m_fl & _any_nbr(md, m_gr)
    m_cf_gr = m_gr & _any_nbr(md, m_ocean)
    m_cf_fl = m_fl & _any_nbr(md, m_ocean)
    m_coast = m_land & _any_nbr(md, m_ocean)

    # integer mask, later assignments override earlier (reference order)
    mask = torch.zeros(Hi.shape, dtype=torch.int32, device=Hi.device)
    for m, t in [(m_land, TYPE_ICEFREE_LAND), (m_ocean, TYPE_ICEFREE_OCEAN),
                 (m_gr, TYPE_GROUNDED_ICE), (m_fl, TYPE_FLOATING_ICE),
                 (m_margin, TYPE_MARGIN), (m_gl_gr, TYPE_GL_GR),
                 (m_gl_fl, TYPE_GL_FL), (m_cf_gr, TYPE_CF_GR),
                 (m_cf_fl, TYPE_CF_FL), (m_coast, TYPE_COASTLINE)]:
        mask = torch.where(m, t, mask)

    return dict(
        mask=mask,
        mask_icefree_land=m_land, mask_icefree_ocean=m_ocean,
        mask_grounded_ice=m_gr, mask_floating_ice=m_fl,
        mask_margin=m_margin, mask_gl_gr=m_gl_gr, mask_gl_fl=m_gl_fl,
        mask_cf_gr=m_cf_gr, mask_cf_fl=m_cf_fl, mask_coastline=m_coast,
    )


def calc_mask_noice(md: MeshData, choice: str):
    """Static no-ice mask from config choice (masks_mod.f90:389)."""
    V = md.V
    if choice == "none":
        return torch.zeros(md.nV, dtype=torch.bool, device=V.device)
    if choice == "MISMIP_mod":
        return torch.linalg.norm(V, dim=1) > 900e3
    if choice == "MISMIP+":
        return V[:, 0] > 640e3
    if choice == "Thule":
        return torch.linalg.norm(V, dim=1) > 750e3
    raise ValueError(f"unknown choice_mask_noice '{choice}'")
