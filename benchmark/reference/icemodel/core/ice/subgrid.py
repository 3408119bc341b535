"""Sub-grid schemes: effective thickness / margin fraction, grounded fractions.

Vectorised re-design of src/UFEMISM/ice_dynamics/utilities/
subgrid_ice_margin.f90 (calc_effective_thickness) and
subgrid_grounded_fractions_* (bilinear-TAF variant).
"""

from __future__ import annotations

import torch

from ..mesh_data import MeshData, EField
from ...utils.constants import ice_density, seawater_density
from .masks import is_floating
from .geometry import thickness_above_flotation


def calc_effective_thickness(md: MeshData, Hi, Hb, SL):
    """Returns (Hi_eff, fraction_margin) (subgrid_ice_margin.f90:19)."""
    Hi_x = md.ext_V(Hi)
    nbr_Hi = torch.where(md.mask_C, Hi_x[md.C], torch.inf)  # inf: "== 0" False
    m_margin = (Hi > 0.0) & ((nbr_Hi == 0.0).any(dim=1))
    m_float = is_floating(Hi, Hb, SL)

    # defaults
    fraction = torch.where(~m_float | (Hi > 0.0), 1.0, 0.0).to(Hi.dtype)
    Hi_eff = torch.where(~m_float | (Hi > 0.0), Hi, 0.0)

    # max ice thickness among non-margin neighbours (floating margins only)
    nbr_margin = md.ext_V(m_margin)[md.C] & md.mask_C
    nbr_Hi_valid = torch.where(md.mask_C & ~nbr_margin, Hi_x[md.C], 0.0)
    Hi_nbr_max = torch.where(m_float, nbr_Hi_valid.max(dim=1).values, 0.0)

    apply = m_margin & (Hi_nbr_max > Hi)
    Hi_eff = torch.where(apply, Hi_nbr_max, Hi_eff)
    fraction = torch.where(apply, Hi / torch.clamp(Hi_nbr_max, min=1e-30),
                           fraction)
    return Hi_eff, fraction


def calc_grounded_fractions_bilin_TAF(md: MeshData, Hi, Hb, SL, mask_floating):
    """Sub-grid grounded fractions from thickness-above-flotation.

    a-grid: fraction of the Voronoi cell grounded, estimated from the sign
    mix of TAF at the vertex and its neighbours; b-grid: per-triangle from
    its three vertices (reference subgrid_grounded_fractions_bilin_interp).
    """
    TAF = thickness_above_flotation(Hi, Hb, SL)

    # a-grid: per-connection sub-areas grounded where TAF interpolated > 0.
    # Linear interpolation along each connection: fraction of the segment
    # with TAF>0, averaged over connections (lightweight approximation of
    # the bilinear sub-cell integral; exact on fully grounded/floating).
    TAF_n = torch.where(md.mask_C, md.ext_V(TAF)[md.C], 0.0)
    Ti, Tj = TAF[:, None], TAF_n
    denom = torch.where(torch.abs(Ti - Tj) < 1e-30, 1e-30, Ti - Tj)
    lam = torch.clamp(Ti / denom, 0.0, 1.0)   # point where TAF crosses 0
    seg_gr = torch.where(Ti > 0, lam, 1.0 - lam)
    seg_gr = torch.where((Ti > 0) == (Tj > 0),
                         torch.where(Ti > 0, 1.0, 0.0).to(TAF.dtype), seg_gr)
    w = md.mask_C.to(TAF.dtype)
    fraction_gr = (seg_gr * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    # fully grounded/floating cells exactly 1/0
    all_gr = (Ti > 0).squeeze(-1) & ((Tj > 0) | ~md.mask_C).all(dim=1)
    all_fl = (Ti <= 0).squeeze(-1) & ((Tj <= 0) | ~md.mask_C).all(dim=1)
    fraction_gr = torch.where(all_gr, 1.0,
                              torch.where(all_fl, 0.0, fraction_gr))
    return fraction_gr


def calc_grounded_fractions_b_from_a(md: MeshData, Tri, fraction_gr_a):
    """b-grid grounded fraction = mean over the triangle's vertices."""
    return md.ext_V(fraction_gr_a)[Tri].mean(dim=1)


def calc_grounded_fractions_bedrock_cdf(Hi, SL, dHb, cdf):
    """Grounded fraction from the sub-grid bedrock CDF quantiles
    (subgrid_grounded_fractions_bedrock_CDF.f90:22-87, vectorised).

    cdf: [n, nbins] bedrock-elevation quantiles per cell (host-built,
    bedrock_cdf.py). Hb_float is the bedrock depth at which this column
    goes afloat; the grounded fraction is 1 - CDF(Hb_float).
    """
    nbins = cdf.shape[1]
    Hb_float = SL - Hi * ice_density / seawater_density - dHb
    iu = torch.searchsorted(cdf, Hb_float[:, None].contiguous())[:, 0]
    iu = torch.clamp(iu, 1, nbins - 1)
    il = iu - 1
    c_iu = torch.gather(cdf, 1, iu[:, None])[:, 0]
    c_il = torch.gather(cdf, 1, il[:, None])[:, 0]
    wl = torch.clamp((c_iu - Hb_float)
                     / torch.where(c_iu == c_il, 1.0, c_iu - c_il), 0.0, 1.0)
    frac = 1.0 - (il * wl + iu * (1.0 - wl)) / (nbins - 1)
    frac = torch.where(Hb_float <= cdf[:, 0], 1.0,
                       torch.where(Hb_float >= cdf[:, -1], 0.0,
                                   torch.clamp(frac, 0.0, 1.0)))
    return frac


def register_bedrock_cdfs(md: MeshData, pair):
    """Register bedrock-CDF quantile tables (cdf_a [nV,nb], cdf_b
    [nTri,nb], mask_border_b [nTri]) into md.extras."""
    if pair is None or "cdf_a" in md.extras:
        return
    cdf_a, cdf_b, mask_border_b = pair
    md.extras["cdf_a"] = EField(cdf_a, "V")
    md.extras["cdf_b"] = EField(cdf_b, "Tri")
    md.extras["cdf_mask_border_b"] = EField(mask_border_b, "Tri")


def get_bedrock_cdfs(md: MeshData):
    if md.extras and "cdf_a" in md.extras:
        return (md.x("cdf_a"), md.x("cdf_b"), md.x("cdf_mask_border_b"))
    return None


def calc_grounded_fractions(C, md: MeshData, Hi, Hb, SL, mask_floating,
                            dHb=None, bedrock_cdfs=None):
    """Dispatch on choice_subgrid_grounded_fraction
    (subgrid_grounded_fractions_main.f90:34-100). Returns
    (fraction_gr_a, fraction_gr_b). bedrock_cdfs = (cdf_a, cdf_b,
    mask_border_b); defaults to the tables registered in md.extras, or
    the bilinear-TAF fallback when none exist."""
    choice = C.choice_subgrid_grounded_fraction
    if bedrock_cdfs is None:
        bedrock_cdfs = get_bedrock_cdfs(md)
    if bedrock_cdfs is None and "bedrock_CDF" in choice:
        # no raw bedrock grid available (e.g. restarted without refgeo):
        # fall back to the TAF interpolation
        choice = "bilin_interp_TAF"
    if dHb is None:
        dHb = torch.zeros_like(Hi)

    need_taf = "bilin_interp_TAF" in choice
    need_cdf = "bedrock_CDF" in choice

    f_taf_a = f_taf_b = f_cdf_a = f_cdf_b = None
    if need_taf:
        f_taf_a = calc_grounded_fractions_bilin_TAF(md, Hi, Hb, SL,
                                                    mask_floating)
        f_taf_b = calc_grounded_fractions_b_from_a(md, md.Tri, f_taf_a)
    if need_cdf:
        cdf_a, cdf_b, mask_border_b = bedrock_cdfs
        f_cdf_a = calc_grounded_fractions_bedrock_cdf(Hi, SL, dHb, cdf_a)
        Hi_b = md.M_map_a_b @ Hi
        SL_b = md.M_map_a_b @ SL
        dHb_b = md.M_map_a_b @ dHb
        f_cdf_b = calc_grounded_fractions_bedrock_cdf(Hi_b, SL_b, dHb_b,
                                                      cdf_b)
        # domain-border triangles: remapping there is unreliable - grounded
        # iff any corner has TAF > 0 (bedrock_CDF.f90:123-137)
        TAF = thickness_above_flotation(Hi, Hb, SL)
        any_gr = (md.ext_V(TAF)[md.Tri] > 0.0).any(dim=1)
        f_cdf_b = torch.where(mask_border_b,
                              torch.where(any_gr, 1.0, 0.0).to(f_cdf_b.dtype),
                              f_cdf_b)

    if choice == "bilin_interp_TAF":
        return f_taf_a, f_taf_b
    if choice == "bedrock_CDF":
        return f_cdf_a, f_cdf_b
    if choice == "bilin_interp_TAF+bedrock_CDF":
        # a-grid: smallest of the two; b-grid: TAF at the grounding line,
        # CDF inland (subgrid_grounded_fractions_main.f90:63-99)
        f_a = torch.minimum(f_taf_a, f_cdf_a)
        any_fl = md.ext_V(mask_floating)[md.Tri].any(dim=1)
        f_b = torch.where(any_fl, f_taf_b, f_cdf_b)
        return f_a, f_b
    raise ValueError(
        f"unknown choice_subgrid_grounded_fraction '{choice}'")
