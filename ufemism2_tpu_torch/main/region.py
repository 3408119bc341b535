"""Model region: initialise from config, run the outer time loop.

Re-design of src/UFEMISM/main/UFEMISM_main_model.f90: the event-driven
component scheduler (each component keeps its own t_next;
advance_region_time_to_time_of_next_action, :354-435) runs on the host;
the per-step field work (PC ice dynamics, component models) runs on one
device. Mesh building is a host-side event.

This slice covers a fixed mesh built from an idealised geometry, the
stress balances none/SIA/SSA/DIVA/SIA+SSA (with the ocean-pressure
calving front), uniform SMB/BMB/LMB/AMB, the 'none' climate, the 3-D heat
equation with a uniform geothermal flux (fused into the ice-step loop as
the reference's make_pc_multistep does), a fixed sea level, the MISMIP+
flow-factor tuning slot and the scalar half of the output (appended to
`scalars_history`). Every other choice raises NotImplementedError at
construction, naming the choice; so does an output directory, since the
field and NetCDF writers are not ported (ROADMAP A.18).
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core.mesh_data import build_mesh_data, EField
from ..core.ice.state import init_ice_state
from ..core.ice.pc import (make_pc_step, make_solve_stress_balance,
                           interpolate_ice_to_time)
from ..core.ice.masks import determine_masks
from ..core.ice.subgrid import calc_grounded_fractions_bilin_TAF
from ..core.ice.scalars import calc_ice_scalars
from ..core.ice.bedrock_cdf import build_bedrock_cdfs_from_config
from ..core.ice.thermodynamics import (
    register_thermo_static, make_heat_solver, make_geothermal_flux,
    run_thermodynamics, robin_solution, calc_pressure_melting_point)
from ..core.idealised_geometries import calc_idealised_geometry
from ..mesh import Mesh, build_mesh_from_config
from ..ops import resolve_device
from ..models.smb import make_run_smb
from ..models.bmb import make_run_bmb
from ..models.lmb import make_run_lmb
from ..models.amb import make_run_amb
from ..models.climate import make_run_climate
from ..utils.logging_utils import routine


def _require(C, key, allowed, what=None):
    v = getattr(C, key)
    if v not in allowed:
        raise NotImplementedError(
            f"{key} = {v!r} is not ported yet"
            + (f" ({what})" if what else "")
            + f"; ported: {', '.join(repr(a) for a in allowed)}")


def _check_slice(C, name):
    """Refuse, by name, every configuration choice this slice lacks."""
    _require(C, "choice_thermo_model", ("none", "3D_heat_equation"))
    if C.choice_thermo_model == "3D_heat_equation":
        _require(C, "choice_geothermal_heat_flux", ("uniform",),
                 "reading input files")
    _require(C, "allow_mesh_updates", (False,), "remeshing")
    _require(C, f"choice_refgeo_init_{name}", ("idealised",))
    _require(C, f"choice_climate_model_{name}", ("none",))
    _require(C, f"choice_ocean_model_{name}", ("none",))
    _require(C, "choice_GIA_model", ("none",))
    _require(C, "choice_sealevel_model", ("fixed",))
    _require(C, "choice_bed_roughness", ("uniform",))
    _require(C, "do_bed_roughness_nudging", (False,))
    _require(C, "do_target_dHi_dt", (False,))
    _require(C, "choice_tracer_tracking_model", ("none",))
    _require(C, "do_write_checksum_log", (False,))
    _require(C, f"pc_choice_initialise_{name}", ("zero",))
    _require(C, f"choice_initial_velocity_{name}", ("zero",))
    _require(C, "tpu_n_devices", (1,), "multi-device runs")
    _require(C, "tpu_precision", ("f32", "f64"))
    if C.choice_basal_hydrology_model == "Salle2025":
        raise NotImplementedError(
            "choice_basal_hydrology_model 'Salle2025' is not ported yet")


@dataclass
class ModelRegion:
    C: Config
    name: str = "ANT"
    mesh: Optional[Mesh] = None
    time: float = 0.0
    output_dir: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        C = self.C
        _check_slice(C, self.name)
        if self.output_dir is not None:
            raise NotImplementedError(
                "ModelRegion output_dir: the field and NetCDF output files "
                "are not ported yet (ROADMAP A.18); the scalars go to "
                "scalars_history")
        self.device = resolve_device(self.device)
        with routine("initialise_model_region"):
            if self.mesh is None:
                with routine("setup_first_mesh"):
                    self.mesh = build_mesh_from_config(C, self.name)
            dtype = torch.float32 if C.tpu_precision == "f32" \
                else torch.float64
            self.md = build_mesh_data(self.mesh, dtype=dtype,
                                      device=self.device)
            if C.refgeo_idealised_MISMIPplus_tune_A \
                    and C.choice_ice_rheology_Glen == "uniform":
                # dynamic flow-factor multiplier: the MISMIP+ tuning loop
                # (main/program.py mismipplus_adapt_flow_factor) updates
                # it in place between coupling intervals
                self.md.extras["glen_A_scale"] = EField(
                    torch.tensor(1.0, dtype=dtype, device=self.device),
                    "scalar")

            # initial geometry on the mesh vertices
            Hi, Hb, Hs, SL = calc_idealised_geometry(
                self.mesh.V[:, 0], self.mesh.V[:, 1],
                C.choice_refgeo_init_idealised, C)
            Hi = np.where(Hi < C.refgeo_Hi_min, 0.0, Hi)
            # the reference overrides the geometry's SL with the
            # configured fixed value at ice-model initialisation
            # (ice_dynamics_main.f90:238)
            SL = np.full_like(np.asarray(Hi, dtype=np.float64),
                              C.fixed_sealevel)
            self.state = init_ice_state(self.md, Hi, Hb, SL, nz=C.nz,
                                        dt_init=C.dt_ice_min)
            self.time = float(C.start_time_of_run)
            self.state = self.state.replace(t_Hi_prev=self.time,
                                            t_Hi_next=self.time)

            # component models
            self.run_climate = make_run_climate(C, self.md, self.name)
            self.run_smb = make_run_smb(C, self.md, self.name)
            self.run_bmb = make_run_bmb(C, self.md, self.name)
            self.run_lmb = make_run_lmb(C, self.md, self.name)
            self.run_amb = make_run_amb(C, self.md, self.name)

            # present-day reference geometry (for alter_ice_thickness
            # fixiness/limitness)
            pd_choice = getattr(C, f"choice_refgeo_PD_{self.name}")
            if pd_choice == "idealised":
                Hi_PD, Hb_PD, _, _ = calc_idealised_geometry(
                    self.mesh.V[:, 0], self.mesh.V[:, 1],
                    C.choice_refgeo_PD_idealised, C)
                Hi_PD = np.where(Hi_PD < C.refgeo_Hi_min, 0.0, Hi_PD)
            elif pd_choice == "read_from_file" and os.path.exists(
                    getattr(C, f"filename_refgeo_PD_{self.name}")):
                raise NotImplementedError(
                    "choice_refgeo_PD 'read_from_file': reading geometry "
                    "files is not ported yet")
            else:
                # PD file absent (idealised test setups): fall back to the
                # initial geometry as the PD reference.
                Hi_PD, Hb_PD = np.asarray(Hi), np.asarray(Hb)
            self.refgeo_PD = (np.asarray(Hi_PD), np.asarray(Hb_PD))

            # bed roughness: the uniform value of the chosen sliding law
            rough = {"Weertman": C.slid_Weertman_beta_sq_uniform,
                     "Coulomb": C.slid_Coulomb_phi_fric_uniform,
                     "Budd": C.slid_Budd_phi_fric_uniform,
                     "Tsai2015": C.slid_Tsai2015_beta_sq_uniform,
                     "Schoof2005": C.slid_Schoof2005_beta_sq_uniform,
                     "Zoet-Iverson": C.slid_ZI_phi_fric_uniform,
                     }.get(C.choice_sliding_law, 1.0)
            self.state = self.state.replace(
                bed_roughness=torch.full_like(self.state.Hi, rough))

            self._bedrock_cdfs = _build_bedrock_cdfs(C, self.mesh,
                                                     self.name, self.md)
            self.pc_step = make_pc_step(C, self.md, refgeo_Hi=Hi_PD,
                                        refgeo_Hb=Hb_PD,
                                        bedrock_cdfs=self._bedrock_cdfs)

            # thermodynamics: one step per dt_thermodynamics, caught up
            # after every ice step of run_to (the reference fuses it into
            # make_pc_multistep); the next thermodynamics time carries
            # across run_to calls
            self.do_thermo = C.choice_thermo_model == "3D_heat_equation"
            self.t_thermo_next = self.time + C.dt_thermodynamics
            self.thermo_steps = 0
            self.thermo_n_unstable = torch.zeros((), dtype=torch.int64,
                                                 device=self.device)
            if self.do_thermo:
                register_thermo_static(self.md)
                heat = make_heat_solver(C, self.md)
                self._geothermal = make_geothermal_flux(C, self.md)
                dt_th = C.dt_thermodynamics
                self._thermo_step = \
                    lambda md_, s, T_surf, SMB, BMB: run_thermodynamics(
                        C, md_, s, dt_th, T_surf, SMB, BMB, heat)

            self.climate = self.run_climate(self.time, self.state)
            self._T_surf = self.climate["T2m"].mean(dim=1)
            self.SMB = self.run_smb(self.time, self.state)
            m0, fg0 = self._masks_fracs(self.state.Hi, self.state.Hb,
                                        self.state.SL)
            self.BMB = self.run_bmb(self.time, self.state, m0, fg0)
            self.LMB = self.run_lmb(self.time, self.state, m0)
            self.AMB = self.run_amb(self.time, self.state)

            # initialise Ti
            ti_choice = getattr(C,
                                f"choice_initial_ice_temperature_{self.name}")
            if self.do_thermo and ti_choice == "Robin":
                Ti_pmp = calc_pressure_melting_point(self.md,
                                                     self.state.Hi_eff)
                Ti0 = robin_solution(C, self.md, self.state.Hi_eff, Ti_pmp,
                                     m0, self._T_surf, self.SMB,
                                     self._geothermal)
                self.state = self.state.replace(
                    Ti=Ti0.to(self.state.Ti.dtype))
            elif ti_choice == "uniform":
                self.state = self.state.replace(
                    Ti=torch.full_like(
                        self.state.Ti,
                        getattr(C, "uniform_initial_ice_temperature_"
                                + self.name)))

            # initial stress-balance solve so the t=0 state carries real
            # velocities - the reference solves at ice-dynamics
            # initialisation (ice_dynamics_main.f90:1412 +
            # initialise_velocity_solver:389)
            if C.choice_stress_balance_approximation != "none":
                solve0 = make_solve_stress_balance(
                    C, self.md, bedrock_cdfs=self._bedrock_cdfs)
                s0 = self.state
                uv0, vv0, u30, v30, _, _, aux0 = solve0(
                    self.md, s0.Hi, s0.Hs, s0.Hb, s0.SL, s0.Ti, s0)
                self.state = s0.replace(
                    u_vav_b=uv0, v_vav_b=vv0, u_3D_b=u30, v_3D_b=v30,
                    **aux0)
                self._sync()

            # event scheduling (UFEMISM_main_model.f90:598-609); the
            # ocean ('none') and restart events do nothing here but bound
            # the ice windows as the reference's do
            t0 = self.time
            self.t_next = {"climate": t0, "ocean": t0, "SMB": t0, "BMB": t0,
                           "LMB": t0, "output": t0, "output_restart": t0}
            self.dt_comp = {"climate": C.dt_climate, "ocean": C.dt_ocean,
                            "SMB": C.dt_SMB, "BMB": C.dt_BMB,
                            "LMB": C.dt_LMB, "output": C.dt_output,
                            "output_restart": C.dt_output_restart}
            self.n_dt_ice = 0
            self.wallclock = 0.0
            self.scalars_history = []

    def set_sealevel(self, sealevel: float):
        """Apply a (possibly time-varying) global sea level to the region
        (update_sealevel_at_model_time; derived geometry and masks are
        recomputed from SL in the next ice-dynamics step)."""
        self.state = self.state.replace(
            SL=torch.full_like(self.state.SL, sealevel))
        return self

    def write_output(self):
        """The scalar half of the reference's output event: masks,
        grounded fractions, the integrated scalars and the solver
        counters at the region's time, appended to `scalars_history`
        (one host read). The field and NetCDF writes wait for ROADMAP
        A.18."""
        s = interpolate_ice_to_time(self.state, self.time)
        m, fg = self._masks_fracs(s.Hi, s.Hb, s.SL)
        scal = calc_ice_scalars(self.md, s.Hi, s.Hb, s.SL, fg, self.SMB,
                                self.BMB, self.LMB, masks=m,
                                fraction_margin=s.fraction_margin,
                                u_vav_b=s.u_vav_b, v_vav_b=s.v_vav_b,
                                dHi_dt=s.dHi_dt,
                                dHi_dt_target=s.dHi_dt_target)
        values = torch.stack([v.to(torch.float64)
                              for v in scal.values()]).tolist()
        rec = {"time": self.time, **dict(zip(scal, values))}
        rec.update(dt_ice=float(s.dt_ice), n_visc_its=float(s.n_visc_its),
                   n_Axb_its=float(s.n_Axb_its))
        self.scalars_history.append(rec)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _masks_fracs(self, Hi, Hb, SL):
        m = determine_masks(self.md, Hi, Hb, SL)
        fg = calc_grounded_fractions_bilin_TAF(
            self.md, Hi, Hb, SL, m["mask_floating_ice"])
        return m, fg

    # -- the main time loop -------------------------------------------------

    def run_to(self, t_end: float, dt_max: Optional[float] = None,
               verbose: bool = False):
        """Event-driven main loop (run_model_region, :103-190)."""
        C = self.C
        dt_max = dt_max if dt_max is not None else C.dt_ice_max
        t0_wall = _time.perf_counter()

        def step(thermo):
            self.state = self.pc_step(self.md, self.state, dt_max,
                                      SMB=self.SMB, BMB=self.BMB,
                                      LMB=self.LMB)
            self.n_dt_ice += 1
            if thermo:
                self._catch_up_thermo()
            if verbose:
                print(f"  t={self.state.t_Hi_next:12.2f} yr  "
                      f"dt={self.state.dt_ice:8.4f}  "
                      f"steps={self.n_dt_ice}  "
                      f"visc={self.state.n_visc_its}  "
                      f"axb={self.state.n_Axb_its}", flush=True)

        with routine("run_model_region"):
            while self.time < t_end - 1e-9:
                # run components whose t_next has arrived
                self._run_components()

                # ice dynamics: advance the prediction window if due, up
                # to the next event boundary. dt is NOT clamped to land on
                # it: the reference's ice window freely overshoots
                # component events and the region interpolates Hi inside
                # it (ice_dynamics_main.f90:85-121)
                if self.state.t_Hi_next <= self.time + 1e-9:
                    t_stop = min([t_end] + list(self.t_next.values()))
                    if t_stop > self.state.t_Hi_next + 1e-9:
                        step(self.do_thermo)
                        while self.state.t_Hi_next < t_stop - 1e-9:
                            step(self.do_thermo)
                    else:
                        # a single step with no thermodynamics catch-up,
                        # as the reference's run_to takes it
                        step(False)

                # advance region time to next action
                t_candidates = [self.state.t_Hi_next]
                t_candidates += list(self.t_next.values())
                self.time = min(min(t_candidates), t_end)
        self.state = interpolate_ice_to_time(self.state, self.time)
        # fire events due exactly AT t_end
        self._run_components()
        self._sync()
        self.wallclock = _time.perf_counter() - t0_wall
        return self.state

    def _catch_up_thermo(self):
        """Thermodynamics up to the new prediction time: every
        dt_thermodynamics boundary the ice step passed, each on the ice
        interpolated to its time; only Ti is written back."""
        s = self.state
        t_th = self.t_thermo_next
        while t_th <= s.t_Hi_next + 1e-9:
            si = interpolate_ice_to_time(s, t_th)
            Ti_new, n_unstable = self._thermo_step(
                self.md, si, self._T_surf, self.SMB, self.BMB)
            s = s.replace(Ti=Ti_new)
            t_th = t_th + self.C.dt_thermodynamics
            self.thermo_steps += 1
            self.thermo_n_unstable = self.thermo_n_unstable + n_unstable
        self.state = s
        self.t_thermo_next = t_th

    def _run_components(self):
        t = self.time
        eps = 1e-9
        s = interpolate_ice_to_time(self.state, t)
        masks = fg = None

        def need(name):
            return self.t_next[name] <= t + eps

        def bump(name):
            self.t_next[name] = self.t_next[name] + self.dt_comp[name]

        if need("climate"):
            self.climate = self.run_climate(t, s)
            self._T_surf = self.climate["T2m"].mean(dim=1)
            bump("climate")
        if need("SMB"):
            self.SMB = self.run_smb(t, s)
            bump("SMB")
        if need("BMB") or need("LMB"):
            masks, fg = self._masks_fracs(s.Hi, s.Hb, s.SL)
        if need("BMB"):
            self.BMB = self.run_bmb(t, s, masks, fg)
            bump("BMB")
        if need("LMB"):
            self.LMB = self.run_lmb(t, s, masks)
            bump("LMB")
        if need("ocean"):
            bump("ocean")
        if need("output"):
            self.write_output()
            bump("output")
        if need("output_restart"):
            bump("output_restart")


def _build_bedrock_cdfs(C, mesh, region_name, md):
    """Host-side bedrock CDFs + border-triangle mask for the sub-grid
    grounded-fraction scheme; None when the choice doesn't need them
    (initialise_bedrock_CDFs)."""
    if "bedrock_CDF" not in C.choice_subgrid_grounded_fraction:
        return None
    pair = build_bedrock_cdfs_from_config(C, mesh, region_name)
    if pair is None:
        return None
    cdf_a, cdf_b = pair
    mask_border_b = (mesh.TriC < 0).any(axis=1)
    kw = dict(dtype=md.A.dtype, device=md.device)
    return (torch.as_tensor(cdf_a, **kw), torch.as_tensor(cdf_b, **kw),
            torch.as_tensor(mask_border_b, device=md.device))
