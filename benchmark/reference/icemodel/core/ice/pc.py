"""Predictor-corrector ice-thickness time stepping (Robinson et al. 2020).

Re-design of src/UFEMISM/ice_dynamics/time_stepping/
predictor_corrector_scheme.f90:34-326 as a state->state function: the
truncation-error retry loop, the adaptive dt controller (Eq. 33), the
predictor (Eq. 30), the stress-balance solve on the predicted geometry and
the corrector. Field work runs on the device; the time-step control
(dt, eta, the retry decision) is host-side float64 arithmetic, whatever
the field dtype.
"""

from __future__ import annotations

import torch

from ...parallel import comm
from ..mesh_data import MeshData, EField
from .geometry import ice_surface_elevation, thickness_above_flotation
from .masks import determine_masks, calc_mask_noice
from .rheology import calc_ice_rheology_glen
from .sia import solve_SIA
from .subgrid import (calc_effective_thickness, calc_grounded_fractions,
                      register_bedrock_cdfs)
from .mass import (calc_dHi_dt, calc_critical_timestep_adv,
                   make_bc_masks, make_divQ_operator)
from .safeties import alter_ice_thickness, calc_and_apply_spill_over_flux
from .state import IceState, PCState


def make_solve_stress_balance(C, md: MeshData, bedrock_cdfs=None):
    """Velocity solver dispatch (conservation_of_momentum_main.f90:37).

    Returns fn(md, Hi, Hs, Hb, SL, Ti, state) ->
      (u_vav_b, v_vav_b, u_3D_b, v_3D_b, n_visc_its, n_Axb_its, aux)
    where aux is a dict of solver warm-start state written back into the
    IceState after the step (the reference keeps the equivalent fields
    in its persistent per-solver types, e.g.
    type_ice_velocity_solver_DIVA).
    """
    choice = C.choice_stress_balance_approximation

    if choice == "none":
        def solve(md, Hi, Hs, Hb, SL, Ti, s):
            z = torch.zeros_like(s.u_vav_b)
            z3 = torch.zeros_like(s.u_3D_b)
            return (z, z, z3, z3, 0, 0, s.solver_aux())
        return solve

    if choice == "SIA":
        def solve(md, Hi, Hs, Hb, SL, Ti, s):
            masks = determine_masks(md, Hi, Hb, SL)
            A_flow = calc_ice_rheology_glen(
                C, md, Hi, Hs, Ti, masks["mask_grounded_ice"],
                masks["mask_floating_ice"])
            u3, v3, _, _, _, uv, vv = solve_SIA(C, md, Hi, Hs, A_flow)
            return (uv, vv, u3, v3, 0, 0, s.solver_aux())
        return solve

    if choice in ("SSA", "DIVA", "SIA/SSA"):
        from .ssadiva import make_solve_ssa_diva
        return make_solve_ssa_diva(C, md, choice, bedrock_cdfs=bedrock_cdfs)

    if choice == "BPA":
        from .bpa import make_solve_bpa
        solve6 = make_solve_bpa(C, md, bedrock_cdfs=bedrock_cdfs)
    elif choice == "hybrid DIVA/BPA":
        from .hybrid import make_solve_hybrid, resolve_hybrid_mask
        # the mask choice keys are per region: the region the config names
        # (_current_region), or else the first whose choice is set
        region = getattr(C, "_current_region", None) or next(
            (r for r in ("ANT", "EAS", "GRL", "NAM")
             if getattr(C, f"choice_hybrid_DIVA_BPA_mask_{r}")), "ANT")
        mask_BPA_b = resolve_hybrid_mask(C, md._host_mesh, region)
        solve6 = make_solve_hybrid(C, md, mask_BPA_b,
                                   bedrock_cdfs=bedrock_cdfs)
    else:
        raise ValueError(f"stress balance '{choice}' not implemented yet")

    def solve(md, Hi, Hs, Hb, SL, Ti, s):
        # no warm-start state of their own: the state's is carried through
        return (*solve6(md, Hi, Hs, Hb, SL, Ti, s), s.solver_aux())
    return solve


def make_pc_step(C, md: MeshData, refgeo_Hi=None, refgeo_Hb=None,
                 bedrock_cdfs=None):
    """Build the PC step: (md, state, dt_max) -> state.

    refgeo_Hi/Hb: present-day reference geometry on the mesh (used by
    alter_ice_thickness fixiness/limitness; zeros disable those paths).
    All per-entity static data rides md.extras.
    """
    eps = C.pc_epsilon
    k_I, k_p = C.pc_k_I, C.pc_k_p
    eta_min = C.pc_eta_min
    dt_min = C.dt_ice_min
    growth = C.pc_max_time_step_increase
    nit_max = C.pc_nit_max

    # register static per-entity fields before building solvers (no-ops
    # when already present)
    register_bedrock_cdfs(md, bedrock_cdfs)
    if "refgeo_Hi" not in md.extras:
        kw = dict(dtype=md.A.dtype, device=md.device)
        z = torch.zeros(md.nV, **kw)
        md.extras["refgeo_Hi"] = EField(
            z if refgeo_Hi is None else torch.as_tensor(refgeo_Hi, **kw), "V")
        md.extras["refgeo_Hb"] = EField(
            z if refgeo_Hb is None else torch.as_tensor(refgeo_Hb, **kw), "V")

    solve_stress_balance = make_solve_stress_balance(C, md)

    def pc_step(md, s: IceState, dt_max,
                SMB=None, BMB=None, LMB=None, AMB=None):
        zerosSMB = torch.zeros_like(s.Hi)
        SMB = zerosSMB if SMB is None else SMB
        BMB = zerosSMB if BMB is None else BMB
        LMB = zerosSMB if LMB is None else LMB

        mask_noice = calc_mask_noice(md, C.choice_mask_noice)
        bc_masks = make_bc_masks(C, md)
        refgeo_Hi = md.x("refgeo_Hi")
        refgeo_Hb = md.x("refgeo_Hb")

        Hb, SL, Ti = s.Hb, s.SL, s.Ti

        # -- new time step (Robinson 2020 Eq. 33) --------------------------
        dt_n = s.pc.dt_np1
        dt = ((eps / s.pc.eta_np1) ** (k_I + k_p)
              * (eps / s.pc.eta_n) ** (-k_p) * dt_n)
        dt = min(dt, float(dt_max))
        dt = min(dt, growth * dt_n)
        dt = max(dt, dt_min)

        # previous state
        Hi_prev = torch.where(mask_noice, 0.0, s.Hi_next)
        dHdt_nm1 = torch.where(mask_noice, 0.0, s.dHi_dt)
        eta_n = s.pc.eta_np1

        masks_prev = determine_masks(md, Hi_prev, Hb, SL)
        dt_crit = calc_critical_timestep_adv(
            C, md, Hi_prev, masks_prev["mask_floating_ice"],
            s.u_vav_b, s.v_vav_b)
        dt = min(dt, dt_crit)

        fraction_gr, fraction_gr_b = calc_grounded_fractions(
            C, md, Hi_prev, Hb, SL, masks_prev["mask_floating_ice"],
            dHb=s.dHb)
        Hi_eff, fraction_margin = calc_effective_thickness(md, Hi_prev, Hb, SL)

        # truncation-error mask: interior grounded, fully grounded, not GL
        tau_mask = (masks_prev["mask_grounded_ice"]
                    & ~masks_prev["mask_gl_gr"] & (fraction_gr == 1.0))

        # retry-loop carry (the accepted attempt's fields)
        it, eta, done = 0, s.pc.eta_np1, False
        Hi_star = Hi_np1 = Hi_prev
        uv, vv, u3, v3, divQ = (s.u_vav_b, s.v_vav_b, s.u_3D_b, s.v_3D_b,
                                s.divQ)
        aux = s.solver_aux()
        n_visc_its = n_Axb_its = 0

        while (not done) and it < nit_max:
            dt_i = dt                        # f64 time bookkeeping (host)
            zeta_t = dt_i / dt_n

            # == predictor (old velocities) ==
            dHdt_n_raw, _, _, nsi1 = calc_dHi_dt(
                C, md, Hi_prev, Hb, SL, s.u_vav_b, s.v_vav_b,
                SMB, BMB, LMB, None, fraction_margin, mask_noice,
                dt_i, s.dHi_dt_target, bc_masks)
            Hi_star = Hi_prev + dt_i * ((1 + zeta_t / 2) * dHdt_n_raw
                                        - (zeta_t / 2) * dHdt_nm1)
            Hi_star = alter_ice_thickness(C, md, masks_prev, Hi_prev, Hb,
                                          SL, Hi_star, refgeo_Hi, refgeo_Hb,
                                          s.t_Hi_next)
            Hi_star = torch.clamp(torch.where(mask_noice, 0.0, Hi_star),
                                  min=0.0)
            dHdt_n = (((Hi_star - Hi_prev) / dt_i
                       + (zeta_t / 2) * dHdt_nm1) / (1 + zeta_t / 2))

            # == stress balance on predicted geometry ==
            Hs_star = ice_surface_elevation(Hi_star, Hb, SL)
            uv, vv, u3, v3, nvi, nai, aux = solve_stress_balance(
                md, Hi_star, Hs_star, Hb, SL, Ti, s)

            # == corrector (original geometry, new velocities) ==
            dHdt_np1_raw, _, divQ, nsi2 = calc_dHi_dt(
                C, md, Hi_prev, Hb, SL, uv, vv,
                SMB, BMB, LMB, None, fraction_margin, mask_noice,
                dt_i, s.dHi_dt_target, bc_masks)
            Hi_np1 = Hi_prev + (dt_i / 2) * (dHdt_n + dHdt_np1_raw)
            Hi_np1 = alter_ice_thickness(C, md, masks_prev, Hi_prev, Hb,
                                         SL, Hi_np1, refgeo_Hi, refgeo_Hb,
                                         s.t_Hi_next)
            _, u_perp, _ = make_divQ_operator(md, uv, vv, fraction_margin)
            Hi_np1, _ = calc_and_apply_spill_over_flux(
                C, md, masks_prev, Hi_eff, u_perp, Hi_np1, dt_i)
            Hi_np1 = torch.clamp(torch.where(mask_noice, 0.0, Hi_np1),
                                 min=0.0)

            # == truncation error (Eq. 32) ==
            tau = zeta_t * torch.abs(Hi_np1 - Hi_star) \
                / ((3 * zeta_t + 3) * dt_n)
            eta = max(eta_min, float(comm.max_all(
                torch.where(tau_mask, tau, 0.0))))

            ok = eta < eps
            at_min = dt_i <= dt_min
            done = ok or at_min
            if not ok and at_min:
                eta = 0.95 * eps
            if not done:
                dt = max(dt_i * 0.8, dt_min)
            it += 1
            n_visc_its += nvi
            n_Axb_its += nai + nsi1 + nsi2

        # -- finalise: new prediction window -------------------------------
        t_next = s.t_Hi_next + dt
        Hi_next = Hi_np1
        dHi_dt = (Hi_next - Hi_prev) / dt

        return s.replace(
            t_Hi_prev=s.t_Hi_next, t_Hi_next=t_next,
            Hi_prev=Hi_prev, Hi_next=Hi_next,
            dHi_dt=dHi_dt, divQ=divQ,
            u_vav_b=uv, v_vav_b=vv, u_3D_b=u3, v_3D_b=v3,
            **aux,
            fraction_margin=fraction_margin, fraction_gr=fraction_gr,
            fraction_gr_b=fraction_gr_b,
            Hi_eff=Hi_eff,
            mask_noice=mask_noice,
            pc=PCState(dt_n=dt_n, dt_np1=dt,
                       eta_n=eta_n, eta_np1=eta,
                       dHi_dt_Hi_nm1_u_nm1=dHdt_nm1,
                       # per-vertex truncation error of the ACCEPTED
                       # attempt (Eq. 32 with the final dt) - the
                       # reference persists ice%pc%tau_np1 and writes it
                       # as the pc_truncation_error output variable
                       tau_np1=((dt / dt_n) * torch.abs(Hi_np1 - Hi_star)
                                / ((3 * dt / dt_n + 3) * dt_n))),
            dt_ice=dt,
            n_visc_its=s.n_visc_its + n_visc_its,
            n_Axb_its=s.n_Axb_its + n_Axb_its,
            **masks_prev,
        )

    return pc_step


def interpolate_ice_to_time(s: IceState, t):
    """Hi at model time t inside the prediction window + derived geometry
    (ice_dynamics_main.f90:114-121)."""
    if s.t_Hi_next > s.t_Hi_prev:
        w = (t - s.t_Hi_prev) / max(s.t_Hi_next - s.t_Hi_prev, 1e-30)
    else:
        w = 1.0
    w = min(max(w, 0.0), 1.0)
    Hi = (1 - w) * s.Hi_prev + w * s.Hi_next
    Hs = ice_surface_elevation(Hi, s.Hb, s.SL)
    return s.replace(Hi=Hi, Hs=Hs, Hib=Hs - Hi,
                     TAF=thickness_above_flotation(Hi, s.Hb, s.SL))
