"""Ice thickness safeties: alter_ice_thickness + spill-over flux.

Vectorised re-design of src/UFEMISM/ice_dynamics/utilities/
ice_thickness_safeties.f90: sneaky modifications of the predicted thickness
(thin-ice removal, calving thresholds, shelf removal, fixiness/limitness
relaxation toward the reference geometry during spinup) and the
calving-front spill-over flux redistribution.
"""

from __future__ import annotations

import torch

from ..mesh_data import MeshData
from ...utils.constants import ice_density, seawater_density
from .masks import is_floating
from .subgrid import calc_effective_thickness


def _decay_factor(time, t_start, t_end, before_start: bool):
    """Fixiness/limitness decay schedule (ice_thickness_safeties.f90:124);
    `time` is a Python float (host-side f64 time bookkeeping)."""
    if t_start >= t_end:
        return 0.0
    if time <= t_start:
        v = 1.0 if before_start else 0.0
    elif time >= t_end:
        v = 0.0
    else:
        v = 1.0 - (time - t_start) / (t_end - t_start)
    return min(max(v, 0.0), 1.0)


def _by_mask(ref, pairs, default):
    """Nested where over (mask, value) pairs with Python-float values, in
    the dtype of `ref`."""
    out = torch.full_like(ref, default)
    for m, v in reversed(pairs):
        out = torch.where(m, v, out)
    return out


def alter_ice_thickness(C, md: MeshData, masks, Hi_old, Hb, SL, Hi_new,
                        refgeo_Hi, refgeo_Hb, time, Ti_hom=None):
    """Modify the predicted ice thickness (ice_thickness_safeties.f90:26).
    `time` is a Python float."""
    Hi_eff_new, _ = calc_effective_thickness(md, Hi_new, Hb, SL)

    # mask conservation: protect grounded
    if C.do_protect_grounded_mask and time <= C.protect_grounded_mask_t_end:
        prot = masks["mask_grounded_ice"]
        H_float = (SL - Hb) * seawater_density / ice_density + 0.1
        Hi_new = torch.where(prot, torch.maximum(Hi_new, H_float), Hi_new)

    # remove very thin ice
    Hi_new = torch.where(Hi_eff_new < C.Hi_min, 0.0, Hi_new)

    # threshold-thickness calving
    if C.choice_calving_law == "threshold_thickness":
        calve = is_floating(Hi_eff_new, Hb, SL) \
            & (Hi_eff_new < C.calving_threshold_thickness_shelf)
        Hi_new = torch.where(calve, 0.0, Hi_new)

    if C.remove_ice_absent_at_PD:
        Hi_new = torch.where(refgeo_Hi == 0.0, 0.0, Hi_new)

    if C.do_remove_shelves:
        Hi_new = torch.where(is_floating(Hi_eff_new, Hb, SL), 0.0, Hi_new)

    if C.remove_shelves_larger_than_PD:
        Hi_new = torch.where((refgeo_Hi == 0.0) & (refgeo_Hb < 0.0), 0.0,
                             Hi_new)

    if C.continental_shelf_calving:
        Hi_new = torch.where(
            (refgeo_Hi == 0.0) & (refgeo_Hb < C.continental_shelf_min_height),
            0.0, Hi_new)

    # fixiness / limitness schedules: host floats, so they never promote
    # the thickness pipeline out of the field dtype
    fixiness = _decay_factor(time, C.fixiness_t_start, C.fixiness_t_end,
                             C.do_fixiness_before_start)
    limitness = _decay_factor(time, C.limitness_t_start, C.limitness_t_end,
                              C.do_limitness_before_start)

    # modiness
    style = C.modiness_H_style
    zeros = torch.zeros_like(Hi_new)
    if style == "none":
        mod_up = mod_down = zeros
    elif style in ("Ti_hom", "Ti_hom_up", "Ti_hom_down"):
        th = zeros if Ti_hom is None else Ti_hom
        m = 1.0 - torch.exp(th / C.modiness_T_hom_ref)
        mod_up = m if style in ("Ti_hom", "Ti_hom_up") else zeros
        mod_down = m if style in ("Ti_hom", "Ti_hom_down") else zeros
    elif style in ("no_thick_inland", "no_thin_inland"):
        inland = masks["mask_grounded_ice"] & ~masks["mask_gl_gr"]
        m = inland.to(Hi_new.dtype)
        mod_up = m if style == "no_thick_inland" else zeros
        mod_down = m if style == "no_thin_inland" else zeros
    else:
        raise ValueError(f"unknown modiness_H_style '{style}'")
    mod_up = torch.clamp(mod_up, 0.0, 1.0)
    mod_down = torch.clamp(mod_down, 0.0, 1.0)

    # per-mask fix/limit amplitudes
    freeland = masks["mask_icefree_land"]
    freeocean = masks["mask_icefree_ocean"]
    fix_H = _by_mask(Hi_new, [
        (masks["mask_gl_gr"], C.fixiness_H_gl_gr),
        (masks["mask_gl_fl"], C.fixiness_H_gl_fl),
        (masks["mask_grounded_ice"], C.fixiness_H_grounded),
        (masks["mask_floating_ice"], C.fixiness_H_floating)], 0.0)
    fix_H = fix_H * fixiness
    if C.fixiness_H_freeland and fixiness > 0:
        fix_H = torch.where(freeland, 1.0, fix_H)
    if C.fixiness_H_freeocean and fixiness > 0:
        fix_H = torch.where(freeocean, 1.0, fix_H)

    limit_H = _by_mask(Hi_new, [
        (masks["mask_gl_gr"], C.limitness_H_gl_gr),
        (masks["mask_gl_fl"], C.limitness_H_gl_fl),
        (masks["mask_grounded_ice"] | freeland, C.limitness_H_grounded)],
        C.limitness_H_floating)
    limit_H = limit_H * limitness

    Hi_new = Hi_old * fix_H + Hi_new * (1.0 - fix_H)
    Hi_new = torch.minimum(
        Hi_new, refgeo_Hi + (1.0 - mod_up) * limit_H
        + (1.0 - limitness) * (Hi_new - refgeo_Hi))
    Hi_new = torch.maximum(
        Hi_new, refgeo_Hi - (1.0 - mod_down) * limit_H
        - (1.0 - limitness) * (refgeo_Hi - Hi_new))
    return Hi_new


def calc_and_apply_spill_over_flux(C, md: MeshData, masks, Hi_eff, u_perp,
                                   Hi_new, dt):
    """Redistribute overfilled calving-front ice into neighbouring
    ice-free-ocean cells (ice_thickness_safeties.f90:290)."""
    cf = masks["mask_cf_fl"] | masks["mask_cf_gr"]
    ocean = masks["mask_icefree_ocean"]
    w_eps = 1e-2

    # upstream thickness: neighbour with strongest inflow (most negative
    # u_perp); fall back to Hi_eff when no inflow
    u_perp_m = torch.where(md.mask_C, u_perp, torch.inf)
    cm = torch.argmin(u_perp_m, dim=1)
    vj_up = torch.gather(md.C, 1, cm[:, None])[:, 0]
    u_min = torch.gather(u_perp_m, 1, cm[:, None])[:, 0]
    Hi_up_nbr = md.ext_V(Hi_new)[vj_up]
    Hi_ups = torch.where((u_min < 0) & (Hi_up_nbr > 0), Hi_up_nbr, Hi_eff)
    Hi_ups = torch.where(cf, Hi_ups, Hi_eff)

    over = cf & (Hi_new > Hi_ups)
    Q_src = torch.where(over, -(Hi_new - Hi_ups) * md.A / dt, 0.0)

    # weights toward neighbouring ocean cells
    nbr_ocean = md.ext_V(ocean)[md.C] & md.mask_C
    weight = torch.where(nbr_ocean, torch.clamp(u_perp, min=0.0) + w_eps, 0.0)
    wsum = weight.sum(dim=1)
    no_ocean = wsum < w_eps
    Q_src = torch.where(no_ocean, 0.0, Q_src)
    relweight = weight / torch.clamp(wsum, min=w_eps)[:, None]

    # destination: scatter Q_src * relweight to the ocean neighbours.
    # Equivalent gather form: for each ocean cell vi, sum over neighbours
    # vj of Q_src[vj] * relweight[vj, index of vi in C[vj]]; the position
    # table rev_pos is static connectivity precomputed at mesh build.
    vj = md.C                                        # [nV,K]
    rw_from_nbr = torch.gather(md.ext_V(relweight)[vj], 2,
                               md.rev_pos[:, :, None])[:, :, 0]
    q_from_nbr = md.ext_V(Q_src)[vj]
    contrib = torch.where(md.mask_C & (q_from_nbr < -1e-2)
                          & (rw_from_nbr > 1e-6),
                          -q_from_nbr * rw_from_nbr, 0.0)
    Q_dst = torch.where(ocean, contrib.sum(dim=1), 0.0)

    Qspill = (Q_src + Q_dst) / md.A
    return Hi_new + Qspill * dt, Qspill
