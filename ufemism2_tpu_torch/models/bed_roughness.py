"""Bed roughness and its nudging (basal friction inversion).

Re-design of src/UFEMISM/bed_roughness/: the generic bed roughness field
(the sliding law's own parameter) and the three nudging methods that
invert it from thickness and velocity misfits during a spin-up (Berends
et al. 2023):
  - H_dHdt_local: CISM-style local relaxation with Laplacian smoothing
  - H_dHdt_flowline: half-flowline-averaged misfits
  - H_u_flowline: thickness and velocity misfit along flowlines
Flowlines are traced on the device by repeated upwind hops to the
neighbour best aligned with the flow, where the reference traces
polylines on the host. Each nudging event is a few hundred eager
launches (flowline_average: 11 gathers; gaussian_extrapolate: 20 passes),
acceptable at the reference's cadence of years.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.mesh_data import MeshData


class BedRoughnessState(NamedTuple):
    generic: torch.Tensor    # [nV] the nudged roughness parameter


def _roughness_var_for_law(law: str) -> str:
    """The file variable that holds the generic roughness parameter of a
    sliding law (bed_roughness_main.f90:139-175: Weertman, Tsai and Schoof
    are described by beta_sq, Coulomb, Budd and Zoet-Iverson by
    till_friction_angle)."""
    return ("beta_sq" if law in ("Weertman", "Tsai2015", "Schoof2005")
            else "till_friction_angle")


def initial_bed_roughness(C, md: MeshData, region_name: str = "ANT",
                          Hb=None):
    """The initial generic roughness field: uniform, parameterised
    (Martin2011, MISMIP+) or read_from_file (bed_roughness_main.f90:64-96
    dispatch)."""
    law = C.choice_sliding_law
    choice = getattr(C, "choice_bed_roughness", "uniform")
    kw = dict(dtype=md.A.dtype, device=md.device)

    if choice == "read_from_file":
        fname = getattr(C, f"filename_bed_roughness_{region_name}", "")
        mesh = getattr(md, "_host_mesh", None)
        if not fname or mesh is None:
            raise ValueError("choice_bed_roughness='read_from_file' needs "
                             f"filename_bed_roughness_{region_name} and "
                             "the host mesh")
        from ..io.input_files import read_field_from_file_2D
        field = read_field_from_file_2D(fname, _roughness_var_for_law(law),
                                        mesh)
        return BedRoughnessState(generic=torch.as_tensor(field, **kw))

    if choice == "parameterised":
        sub = C.choice_bed_roughness_parameterised
        if sub == "Martin2011":
            # till friction angle linear in Hb (Martin et al. 2011, Eq. 10)
            if Hb is None:
                raise ValueError("Martin2011 roughness needs Hb")
            w = torch.clamp((torch.as_tensor(Hb, **kw)
                             - C.Martin2011till_phi_Hb_min)
                            / (C.Martin2011till_phi_Hb_max
                               - C.Martin2011till_phi_Hb_min), 0.0, 1.0)
            phi = ((1.0 - w) * C.Martin2011till_phi_min
                   + w * C.Martin2011till_phi_max)
            return BedRoughnessState(generic=phi)
        if sub in ("MISMIPplus", "MISMIP+"):
            # the uniform MISMIP+ alpha^2/beta^2
            # (calc_bed_roughness_MISMIPplus)
            val = (C.slid_Tsai2015_beta_sq_uniform
                   if law == "Tsai2015" else
                   C.slid_Schoof2005_beta_sq_uniform)
            return BedRoughnessState(generic=torch.full((md.nV,), val, **kw))
        raise ValueError(
            f"unknown choice_bed_roughness_parameterised '{sub}'")

    val = {"Weertman": C.slid_Weertman_beta_sq_uniform,
           "Coulomb": C.slid_Coulomb_phi_fric_uniform,
           "Budd": C.slid_Budd_phi_fric_uniform,
           "Tsai2015": C.slid_Tsai2015_beta_sq_uniform,
           "Schoof2005": C.slid_Schoof2005_beta_sq_uniform,
           "Zoet-Iverson": C.slid_ZI_phi_fric_uniform,
           }.get(law, 1.0)
    return BedRoughnessState(generic=torch.full((md.nV,), val, **kw))


def gaussian_extrapolate(md: MeshData, mask_seed, mask_fill, field,
                         n_iter=20):
    """Extrapolate a field from the seed vertices into the fill vertices
    by repeated neighbour averaging (extrapolate_Gaussian,
    nudging_utilities.f90)."""
    have = mask_seed
    f = torch.where(have, field, 0.0)
    w = have.to(field.dtype)
    for _ in range(n_iter):
        w_n = torch.where(md.mask_C, w[md.C], 0.0)
        f_n = torch.where(md.mask_C, f[md.C], 0.0)
        wsum = w_n.sum(dim=1)
        favg = f_n.sum(dim=1) / torch.clamp(wsum, min=1e-12)
        new = mask_fill & (wsum > 0) & (w == 0)
        f = torch.where(new, favg, f)
        w = torch.where(new, 1.0, w)
    return torch.where(mask_seed, field, f)


def smooth_field(md: MeshData, f, n_pass=2, w_smooth=0.5):
    """Neighbour-average smoothing (the reference smooths on the square
    grid with a Gaussian; this is the small-kernel mesh equivalent)."""
    n = md.mask_C.sum(dim=1)
    for _ in range(n_pass):
        f_n = torch.where(md.mask_C, f[md.C], 0.0)
        avg = f_n.sum(dim=1) / torch.clamp(n, min=1)
        f = (1 - w_smooth) * f + w_smooth * avg
    return f


def _first_argmax(x):
    """Index of the first largest entry of each row: the tie rule of
    jnp.argmax, stated explicitly, since torch.argmax does not promise
    which of several equal maxima it returns."""
    best = x.max(dim=1, keepdim=True).values
    k = torch.arange(x.shape[1], device=x.device).expand_as(x)
    return torch.where(x == best, k, x.shape[1]).min(dim=1).values


def _upwind_hop_table(md: MeshData, u_vav_a, v_vav_a, downstream=False):
    """Each vertex's next vertex up- or downstream: the neighbour whose
    direction is best aligned with the flow (+u downstream, -u upstream),
    the first of several equally aligned ones; a vertex whose best
    alignment is 0.2 or less stays put."""
    sgn = 1.0 if downstream else -1.0
    ux = (sgn * u_vav_a)[:, None]
    uy = (sgn * v_vav_a)[:, None]
    norm = torch.sqrt(ux ** 2 + uy ** 2)
    dot = (md.D_x * ux + md.D_y * uy) / (md.D * torch.clamp(norm, min=1e-12))
    dot = torch.where(md.mask_C, dot, -2.0)
    best = _first_argmax(dot)[:, None]
    nxt = torch.gather(md.C, 1, best)[:, 0]
    ok = torch.gather(dot, 1, best)[:, 0] > 0.2
    return torch.where(ok, nxt, torch.arange(md.nV, device=md.device)), ok


def flowline_average(md: MeshData, field, u_vav_a, v_vav_a, Hi,
                     downstream=False, n_hops=12):
    """Distance-weighted average of `field` along the half-flowline from
    each vertex (trace_flowline_* + calc_half_flowline_average; the
    weights fall linearly with the hops)."""
    nxt, ok = _upwind_hop_table(md, u_vav_a, v_vav_a, downstream)
    total = field * 1.0
    wsum = torch.ones_like(field)
    cur = torch.arange(md.nV, device=md.device)
    alive = ok & (Hi > 1.0)
    for h in range(1, n_hops):
        cur = nxt[cur]
        step_ok = alive & (Hi[cur] > 1.0)
        w = max(0.0, 1.0 - h / n_hops)
        total = total + torch.where(step_ok, w * field[cur], 0.0)
        wsum = wsum + step_ok.to(field.dtype) * w    # w or 0, exactly
        alive = step_ok
    return total / wsum


def make_run_bed_roughness_nudging(C, md: MeshData):
    """Returns run(state, masks, br, target_Hs, target_Hi) ->
    BedRoughnessState: one nudging step of dt = bed_roughness_nudging_dt."""
    method = C.choice_bed_roughness_nudging_method
    dt = C.bed_roughness_nudging_dt

    def masks_for_nudging(masks):
        nudge_here = masks["mask_grounded_ice"] & ~masks["mask_gl_gr"] \
            & ~masks["mask_cf_gr"]
        fill = masks["mask_grounded_ice"] | masks["mask_icefree_land"]
        return nudge_here, fill

    def clamp(x):
        return torch.clamp(x, C.generic_bed_roughness_min,
                           C.generic_bed_roughness_max)

    if method == "H_dHdt_local":
        def run(s, masks, br, target_Hs, target_Hi):
            Cb = br.generic
            H0 = C.bednudge_H_dHdt_local_H0
            tau = C.bednudge_H_dHdt_local_tau
            L = C.bednudge_H_dHdt_local_L
            dC_dx_b = md.M_ddx_a_b @ Cb
            dC_dy_b = md.M_ddy_a_b @ Cb
            lap = md.M_ddx_b_a @ dC_dx_b + md.M_ddy_b_a @ dC_dy_b
            dHs_dt = s.dHi_dt       # over a rigid bed
            nudge_here, fill = masks_for_nudging(masks)
            dC_dt = -Cb * ((s.Hs - target_Hs) / (H0 * tau)
                           + 2.0 / H0 * dHs_dt
                           - L ** 2 / tau * lap)
            dC_dt = torch.where(nudge_here, dC_dt, 0.0)
            dC_dt = gaussian_extrapolate(md, nudge_here, fill, dC_dt)
            return BedRoughnessState(generic=clamp(Cb + dt * dC_dt))
        return run

    if method in ("H_dHdt_flowline", "H_u_flowline"):
        def run(s, masks, br, target_Hs, target_Hi, target_uabs=None):
            Cb = br.generic
            u_a = md.M_map_b_a @ s.u_vav_b
            v_a = md.M_map_b_a @ s.v_vav_b
            uabs = torch.sqrt(u_a ** 2 + v_a ** 2)
            deltaHs = s.Hs - target_Hs
            dHs_dt = s.dHi_dt
            nudge_here, fill = masks_for_nudging(masks)

            dH_up = flowline_average(md, deltaHs, u_a, v_a, s.Hi, False)
            dH_dn = flowline_average(md, deltaHs, u_a, v_a, s.Hi, True)
            dHdt_up = flowline_average(md, dHs_dt, u_a, v_a, s.Hi, False)
            dHdt_dn = flowline_average(md, dHs_dt, u_a, v_a, s.Hi, True)

            if method == "H_dHdt_flowline":
                I_tot = ((dH_up - 0.25 * dH_dn)
                         / C.bednudge_H_dHdt_flowline_dH0
                         + (dHdt_up - 0.25 * dHdt_dn)
                         / C.bednudge_H_dHdt_flowline_dHdt0)
                t_scale = C.bednudge_H_dHdt_flowline_t_scale
            else:
                du = uabs - (target_uabs if target_uabs is not None
                             else uabs)
                du_up = flowline_average(md, du, u_a, v_a, s.Hi, False)
                I_tot = ((dH_up - 0.25 * dH_dn)
                         / C.bednudge_H_u_flowline_H0
                         + du_up / C.bednudge_H_u_flowline_u0)
                t_scale = C.bednudge_H_u_flowline_t_scale

            dC_dt = -(I_tot * Cb) / t_scale
            dC_dt = torch.where(nudge_here, dC_dt, 0.0)
            dC_dt = gaussian_extrapolate(md, nudge_here, fill, dC_dt)
            # less on steep slopes, then smoothed (the reference's
            # reduce_dCdt_on_steep_slopes and smooth_dCdt)
            slope = torch.sqrt((md.M_ddx_a_a @ s.Hs) ** 2
                               + (md.M_ddy_a_a @ s.Hs) ** 2)
            dC_dt = dC_dt * torch.clamp(1.0 - slope / 0.03, 0.1, 1.0)
            dC_dt = smooth_field(md, dC_dt,
                                 w_smooth=C.bednudge_H_dHdt_flowline_w_smooth)
            return BedRoughnessState(generic=clamp(Cb + dt * dC_dt))
        return run

    raise ValueError(
        f"unknown choice_bed_roughness_nudging_method '{method}'")


def make_run_bmb_inverted(C, md: MeshData):
    """The BMB inversion: basal melt nudged by the geometry misfit
    (BMB_inverted.f90:24). Returns run(BMB_prev, s, masks, target_Hi,
    target_mask_shelf, time) -> BMB."""
    c_H = -0.003
    c_dHdt = -0.03

    def run(BMB_prev, s, masks, target_Hi, target_mask_shelf, time):
        # the target at the floating calving front: the mean over the
        # neighbours on the shelf off the front
        fl = masks["mask_floating_ice"]
        cf = masks["mask_cf_fl"]
        good = fl & ~cf
        nbr_good = good[md.C] & md.mask_C
        Hn = torch.where(nbr_good, target_Hi[md.C], 0.0)
        n = nbr_good.sum(dim=1)
        Hi_t = torch.where(cf, torch.where(
            n > 0, Hn.sum(dim=1) / torch.clamp(n, min=1), s.Hi), target_Hi)

        if not (C.BMB_inversion_t_start <= time <= C.BMB_inversion_t_end):
            return BMB_prev
        nudgable = target_mask_shelf | fl
        deltaH = s.Hi - Hi_t
        dBMBdt = c_H * deltaH + c_dHdt * s.dHi_dt
        BMB_new = torch.where(nudgable,
                              torch.where(deltaH.abs() > 0,
                                          BMB_prev + C.dt_BMB * dBMBdt, 0.0),
                              0.0)
        return torch.clamp(BMB_new, -C.BMB_maximum_allowed_melt_rate,
                           C.BMB_maximum_allowed_refreezing_rate)
    return run
