"""Model region: initialise from config, run the outer time loop.

Re-design of src/UFEMISM/main/UFEMISM_main_model.f90: the event-driven
component scheduler (each component keeps its own t_next;
advance_region_time_to_time_of_next_action, :354-435) runs on the host;
the per-step field work (PC ice dynamics, component models) runs on one
device. Mesh building, remapping and file output are host-side events.

The port covers a mesh built from an idealised geometry or a geometry
file and the adaptive mesh updates that rebuild it from the evolving
geometry, the stress balances none/SIA/SSA/DIVA/SIA+SSA (with the
ocean-pressure calving front), every ocean model, the SMB, BMB, LMB and
AMB models but those listed below, bed roughness (uniform, parameterised
or read from a file) and its nudging, target thinning rates, every
climate (with insolation and the matrix method), the ELRA bed deformation,
the 3-D heat equation (fused into the ice-step loop as the
reference's make_pc_multistep does), a fixed or prescribed sea level, the
MISMIP+ flow-factor tuning slot, the output (the scalars in
`scalars_history` and, with an output directory, the NetCDF mesh, grid,
scalar, transect, ISMIP and restart files of io/ and models/transects.py),
restarts and the checksum log, the LADDIE sub-shelf melt
(models/laddie.py), the Salle2025 transient hydrology, the Lagrangian
tracers and the regions of interest (their mesh refinement, the
reconstructed SMB, the hybrid's ROI mask and a scalar file each), and
multi-device runs: with tpu_n_devices = P > 1, inside a torch.distributed
process group of world size P, each rank holds the region and run_to
advances the ice dynamics and the fused thermodynamics sharded over the
ranks (parallel/dist.py ShardedModel; the component events run on every
rank on the replicated full state, and rank 0 alone writes files).
Outside such a group it raises by name. What is still missing raises
NotImplementedError at construction, naming the choice: the GIA,
sea-level and initialisation choices `_check_slice` lists.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core.mesh_data import build_mesh_data, EField
from ..core.fields import (host_arrays, device_arrays, remap_leaves,
                           assemble_remapped_state)
from ..core.ice.state import init_ice_state, PCState
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
from ..mesh.creation import build_mesh_from_gridded_geometry
from ..mesh.grids import setup_square_grid
from ..io.input_files import read_field_from_file_2D, read_geometry_onto_mesh
from ..io.output_files import (LINE_FIELDS, MESH_FIELDS_DEFAULT,
                               MeshOutputFile, ScalarOutputFile,
                               GridOutputFile, write_restart_file,
                               restore_state_from_restart,
                               load_restart_host_counters, _state_leaves)
from ..remap import get_map
from ..remap.conservative import build_map_nearest
from ..ops import resolve_device
from ..utils.sanitizer import check_state_for_nan
from ..models.smb import make_run_smb
from ..models.bmb import make_run_bmb
from ..models.lmb import make_run_lmb
from ..models.amb import make_run_amb
from ..models.climate import make_run_climate
from ..models.gia import make_run_gia
from ..models.ocean import make_run_ocean
from ..models.bed_roughness import (BedRoughnessState, initial_bed_roughness,
                                    make_run_bed_roughness_nudging)
from ..models.transects import Transect, TransectOutputFile
from ..models.tracers import PointLocator, make_tracer_stepper
from ..core.ice.hydrology_salle2025 import (init_salle2025_state,
                                            run_salle2025_leg,
                                            Salle2025State)
from ..mesh.refinement import points_in_polygon
from ..mesh.roi_polygons import calc_roi_polygon
from ..utils.constants import ice_density, grav
from ..core.ice.geometry import (ice_surface_elevation,
                                 thickness_above_flotation)
from ..utils.checksum import ChecksumLogger
from ..utils.logging_utils import routine, happy, warning
from ..parallel.sharding import RankGroup
from ..parallel.dist import ShardedModel, check_shardable


_BIG = 9.9e9


def _require(C, key, allowed, what=None):
    v = getattr(C, key)
    if v not in allowed:
        raise NotImplementedError(
            f"{key} = {v!r} is not ported yet"
            + (f" ({what})" if what else "")
            + f"; ported: {', '.join(repr(a) for a in allowed)}")


def _check_slice(C, name):
    """Refuse, by name, every configuration choice the port still lacks."""
    _require(C, "choice_thermo_model", ("none", "3D_heat_equation"))
    _require(C, "choice_GIA_model", ("none", "ELRA"))
    _require(C, "choice_sealevel_model", ("fixed", "prescribed"))
    _require(C, "choice_tracer_tracking_model", ("none", "particles"))
    _require(C, f"pc_choice_initialise_{name}", ("zero", "read_from_file"))
    _require(C, f"choice_initial_velocity_{name}", ("zero",))
    _require(C, "tpu_precision", ("f32", "f64"))


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
        self.device = resolve_device(self.device)
        # a multi-device run: this process is one rank of a process group
        # of world size tpu_n_devices, or the region raises (no fallback
        # to one device); rank 0 alone writes files
        self._n_ranks = int(C.tpu_n_devices)
        self._rank_group = None
        if self._n_ranks > 1:
            check_shardable(C, self._n_ranks)
            self._rank_group = RankGroup.of_world(self._n_ranks, self.device)
            if self._rank_group.rank != 0:
                self.output_dir = None
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
            choice = getattr(C, f"choice_refgeo_init_{self.name}")
            if choice == "idealised":
                Hi, Hb, Hs, SL = calc_idealised_geometry(
                    self.mesh.V[:, 0], self.mesh.V[:, 1],
                    C.choice_refgeo_init_idealised, C)
                Hi = np.where(Hi < C.refgeo_Hi_min, 0.0, Hi)
            elif choice == "read_from_file":
                Hi, Hb, SL = read_geometry_onto_mesh(C, self.name, self.mesh)
            else:
                raise ValueError(f"unknown choice_refgeo_init '{choice}'")
            if C.choice_sealevel_model == "fixed":
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

            # present-day reference geometry (alter_ice_thickness's
            # fixiness/limitness, the targets of the inversions)
            pd_choice = getattr(C, f"choice_refgeo_PD_{self.name}")
            if pd_choice == "idealised":
                Hi_PD, Hb_PD, _, _ = calc_idealised_geometry(
                    self.mesh.V[:, 0], self.mesh.V[:, 1],
                    C.choice_refgeo_PD_idealised, C)
                Hi_PD = np.where(Hi_PD < C.refgeo_Hi_min, 0.0, Hi_PD)
            elif pd_choice == "read_from_file" and os.path.exists(
                    getattr(C, f"filename_refgeo_PD_{self.name}")):
                Hi_PD, Hb_PD, _ = read_geometry_onto_mesh(
                    C, self.name, self.mesh, which="PD")
            else:
                # PD file absent (idealised test setups): fall back to the
                # initial geometry as the PD reference.
                Hi_PD, Hb_PD = np.asarray(Hi), np.asarray(Hb)
            self.refgeo_PD = (np.asarray(Hi_PD), np.asarray(Hb_PD))

            # bed roughness (nudged, where nudging is on, by the
            # bed_roughness event)
            self.bed_roughness_state = initial_bed_roughness(
                C, self.md, region_name=self.name, Hb=Hb)
            self.state = self.state.replace(
                bed_roughness=self.bed_roughness_state.generic)
            self.do_nudging = C.do_bed_roughness_nudging
            self.nudging_events = 0
            self.gia_events = 0

            # thermodynamics: one step per dt_thermodynamics, caught up
            # after every ice step of run_to (the reference fuses it into
            # make_pc_multistep); the next thermodynamics time carries
            # across run_to calls
            self.do_thermo = C.choice_thermo_model == "3D_heat_equation"
            self.t_thermo_next = self.time + C.dt_thermodynamics
            self.thermo_steps = 0
            self.thermo_n_unstable = torch.zeros((), dtype=torch.int64,
                                                 device=self.device)
            self._build_on_mesh()

            self.climate = self.run_climate(self.time, self.state)
            self._T_surf = self.climate["T2m"].mean(dim=1)
            self.ocean = self.run_ocean(self.time, self.state)
            self.SMB = self.run_smb(self.time, self.state,
                                    climate=self.climate)
            m0, fg0 = self._masks_fracs(self.state.Hi, self.state.Hb,
                                        self.state.SL)
            self.BMB = self.run_bmb(self.time, self.state, m0, fg0,
                                    self.ocean)
            self.LMB = self.run_lmb(self.time, self.state, m0)
            self.AMB = self.run_amb(self.time, self.state)

            # target thinning rates from a file (inversion spin-ups;
            # initialise_dHi_dt_target, inversion_utilities.f90:32-90, and
            # the SMB limit of UFEMISM_main_model.f90:1541-1547)
            if C.do_target_dHi_dt:
                self._read_dHi_dt_target()

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

            # Salle2025 transient hydrology: its state and the effective
            # pressure slot the sliding laws read, registered before the
            # initial solve (the JAX package registers it after, so that
            # there a sliding law that reads N_eff cannot start; ROADMAP C)
            if C.choice_basal_hydrology_model == "Salle2025":
                self.hydro_state = init_salle2025_state(self.md)
                self.md.extras["hydro_N_eff"] = EField(
                    ice_density * grav * self.state.Hi, "V")
                self.hydro_substeps = []

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
            # checksum oracle fires on its own cadence (the fastest
            # coupling interval)
            t0 = self.time
            self.t_next = {"climate": t0, "ocean": t0, "SMB": t0, "BMB": t0,
                           "LMB": t0,
                           "GIA": (t0 + C.dt_GIA)
                           if C.choice_GIA_model != "none" else _BIG,
                           "bed_roughness": (t0 + C.bed_roughness_nudging_dt)
                           if self.do_nudging else _BIG,
                           "basal_hydro": t0
                           if C.choice_basal_hydrology_model == "Salle2025"
                           else _BIG,
                           "tracers": (t0 + C.tractrackpart_dt_coupling)
                           if C.choice_tracer_tracking_model == "particles"
                           else _BIG,
                           "output": t0, "output_restart": t0,
                           "checksum": t0 if C.do_write_checksum_log
                           else _BIG}
            self.dt_comp = {"climate": C.dt_climate, "ocean": C.dt_ocean,
                            "SMB": C.dt_SMB, "BMB": C.dt_BMB,
                            "LMB": C.dt_LMB, "GIA": C.dt_GIA,
                            "bed_roughness": C.bed_roughness_nudging_dt,
                            "basal_hydro": C.dt_basal_hydro,
                            "tracers": C.tractrackpart_dt_coupling,
                            "output": C.dt_output,
                            "output_restart": C.dt_output_restart,
                            "checksum": min(C.dt_SMB, C.dt_BMB)}
            # Lagrangian tracers (tracer_tracking_main.f90): the spawn
            # vertices are drawn on the host from a generator seeded with
            # 7, so the card and the host draw the same (the JAX package
            # draws them with jax.random from PRNGKey(7); ROADMAP C)
            if C.choice_tracer_tracking_model == "particles":
                self._build_tracers()
                self.tracer_state = self._tracer_init(self.state, t0)
                self._tracer_gen = torch.Generator().manual_seed(7)

            self.n_dt_ice = 0
            self.n_mesh_updates = 0
            self.remesh_timings = []
            self.t_last_mesh_update = None     # set by the first run_to
            self.wallclock = 0.0
            self.scalars_history = []
            self._outputs_open = False
            self._out_gen = None

            # checksum parity oracle (checksum_mod.f90; call points mirror
            # ice_dynamics_main.f90:153-162)
            self.checksum = ChecksumLogger(
                path=(Path(self.output_dir)
                      / f"checksum_log_{self.name}.jsonl")
                if (self.output_dir and C.do_write_checksum_log) else None,
                enabled=C.do_write_checksum_log)

            # pc-controller warm start from a restart file
            # (predictor_corrector_scheme.f90:417-444 'read_from_file')
            if getattr(C, f"pc_choice_initialise_{self.name}") \
                    == "read_from_file":
                fname = getattr(C, f"filename_pc_initialise_{self.name}")
                _, st = restore_state_from_restart(self.state, fname)
                self.state = self.state.replace(pc=st.pc)

            # multi-device run: the sharded step, built last, from the
            # initialised region (as the JAX package does,
            # ufemism2_tpu/main/region.py:357-362)
            self._dist = None
            if self._rank_group is not None:
                self._dist = ShardedModel(C, self, self._n_ranks,
                                          self._rank_group)

    def _build_on_mesh(self):
        """Everything that holds the mesh's tables or device pointers:
        the component models, the bedrock CDFs, the PC step (with the
        stress-balance solver, its kernels' descriptors and the
        preconditioner), the nudging step and the thermodynamics closures. Built at
        construction and again after every mesh update, so that nothing
        keeps a pointer into a replaced mesh's tensors."""
        C = self.C
        self.run_climate = make_run_climate(C, self.md, self.name,
                                            mesh=self.mesh)
        self.run_ocean = make_run_ocean(C, self.md, self.name,
                                        mesh=self.mesh)
        self.run_smb = make_run_smb(C, self.md, self.name)
        self.run_bmb = make_run_bmb(
            C, self.md, self.name,
            target_geometry=self._bmb_target_geometry)
        self.run_lmb = make_run_lmb(C, self.md, self.name)
        self.run_amb = make_run_amb(C, self.md, self.name)
        self.run_gia = make_run_gia(C, self.md, self.name, self.mesh)
        self._bedrock_cdfs = _build_bedrock_cdfs(C, self.mesh, self.name,
                                                 self.md)
        Hi_PD, Hb_PD = self.refgeo_PD
        self.pc_step = make_pc_step(C, self.md, refgeo_Hi=Hi_PD,
                                    refgeo_Hb=Hb_PD,
                                    bedrock_cdfs=self._bedrock_cdfs)
        if self.do_nudging:
            self._nudge_step = make_run_bed_roughness_nudging(C, self.md)
        if self.do_thermo:
            register_thermo_static(self.md)
            heat = make_heat_solver(C, self.md)
            self._geothermal = make_geothermal_flux(C, self.md)
            dt_th = C.dt_thermodynamics
            self._thermo_step = \
                lambda md_, s, T_surf, SMB, BMB: run_thermodynamics(
                    C, md_, s, dt_th, T_surf, SMB, BMB, heat)

    def _build_tracers(self):
        """The particle tracker's mesh-sized tables and closures."""
        loc = PointLocator(self.mesh, self.device)
        (self._tracer_init, self._tracer_step, self._tracer_spawn,
         self._tracer_to_mesh) = make_tracer_stepper(self.C, self.md, loc)

    def _refresh_forcing(self):
        """The component models' fields at the region's time (after a
        resume or a mesh update). The stateful runners (IMAU-ITM's firn,
        the matrix climate's albedo) advance a year in this call: the JAX
        package refreshes here on purpose, in place of the reference's
        reset of every t_next (ufemism2_tpu/main/region.py:1318-1327, and
        :498-501 on a resume), and the port does the same."""
        t = self.time
        self.climate = self.run_climate(t, self.state)
        self._T_surf = self.climate["T2m"].mean(dim=1)
        self.ocean = self.run_ocean(t, self.state)
        self.SMB = self.run_smb(t, self.state, climate=self.climate)
        m0, fg0 = self._masks_fracs(self.state.Hi, self.state.Hb,
                                    self.state.SL)
        self.BMB = self.run_bmb(t, self.state, m0, fg0, self.ocean)
        self.LMB = self.run_lmb(t, self.state, m0)
        self.AMB = self.run_amb(t, self.state)

    def _read_dHi_dt_target(self):
        """dHi_dt_target from filename_dHi_dt_target_<R> (the timeframe
        timeframe_dHi_dt_target_<R>, or the first), limited by the SMB
        where do_limit_target_dHi_dt_to_SMB; nothing without a file."""
        C = self.C
        fname = getattr(C, f"filename_dHi_dt_target_{self.name}", "")
        if not (fname and os.path.exists(fname)):
            return
        tf = getattr(C, f"timeframe_dHi_dt_target_{self.name}", 1e9)
        tgt = torch.as_tensor(read_field_from_file_2D(
            fname, "dHdt", self.mesh,
            time_to_read=None if tf == 1e9 else tf),
            dtype=self.state.Hi.dtype, device=self.device)
        if C.do_limit_target_dHi_dt_to_SMB:
            tgt = torch.where(
                tgt > 0.0,
                torch.clamp(torch.minimum(tgt, self.SMB), min=0.0), tgt)
        self.state = self.state.replace(dHi_dt_target=tgt)

    def _bmb_target_geometry(self):
        """Target (Hi, shelf mask) of the inverted BMB: the PD reference
        geometry (BMB_inverted.f90:70-96), read at every BMB event, so a
        caller may replace refgeo_PD after construction."""
        kw = dict(dtype=self.md.A.dtype, device=self.device)
        Hi_t = torch.as_tensor(self.refgeo_PD[0], **kw)
        Hb_t = torch.as_tensor(self.refgeo_PD[1], **kw)
        taf = thickness_above_flotation(Hi_t, Hb_t, torch.zeros_like(Hi_t))
        return Hi_t, (taf <= 0.0) & (Hi_t > 0.1)

    def set_sealevel(self, sealevel: float):
        """Apply a (possibly time-varying) global sea level to the region
        (update_sealevel_at_model_time; derived geometry and masks are
        recomputed from SL in the next ice-dynamics step)."""
        self.state = self.state.replace(
            SL=torch.full_like(self.state.SL, sealevel))
        return self

    # -- restart --------------------------------------------------------

    def write_restart(self):
        """Write the restart file at the current model time (every
        output_restart event, and right after a mesh update)."""
        if self.output_dir is not None:
            out = Path(self.output_dir)
            out.mkdir(parents=True, exist_ok=True)
            write_restart_file(out / f"restart_{self.name}_00001.nc",
                               self.mesh, self.state, self.time,
                               host_counters={"n_dt_ice": int(self.n_dt_ice)})

    def resume_from_restart(self, path):
        """Restore the full model state (incl. pc controller) and model
        time from a restart file written by this run or an earlier one on
        the same mesh (the port's or the JAX package's); the active
        component events re-fire at the resumed time."""
        time, state = restore_state_from_restart(self.state, path)
        self.state = state
        self.time = time
        # cumulative host-side stability counters survive the resume
        # (the reference persists pc state + counters,
        # predictor_corrector_scheme.f90:510-620); restarts written
        # before the scheme carry none -> keep the fresh counter.
        self.n_dt_ice = int(load_restart_host_counters(path).get(
            "n_dt_ice", self.n_dt_ice))
        for k in self.t_next:
            # re-fire only the events active in this configuration
            # (inactive ones are parked at _BIG and must stay there)
            if self.t_next[k] < _BIG:
                self.t_next[k] = time
        if self.do_thermo:
            self.t_thermo_next = time + self.C.dt_thermodynamics
        self._refresh_forcing()
        return self

    def _log_checksums(self):
        """Checksum the hot ice fields at checksum-event times (the
        reference's call points, ice_dynamics_main.f90:153-162), on the
        geometry interpolated to the current model time; one host read."""
        s = interpolate_ice_to_time(self.state, self.time)
        names = ("Hi", "Hs", "Hib", "TAF", "dHi_dt",
                 "u_vav_b", "v_vav_b", "Ti")
        vals = host_arrays({n: getattr(s, n) for n in names})
        for n in names:
            self.checksum.log(f"ice.{n}", vals[n], t=self.time)

    # -- output -------------------------------------------------------------

    # choice_output_field_* names the writers can resolve from the model
    # state (main_regional_output.f90's menu; the rest warn)
    _EXTRA_OUTPUT_SUPPORTED = {
        "u_3D", "v_3D", "w_3D", "u_vav", "v_vav", "uabs_vav",
        "u_base", "v_base", "uabs_base",
        "dHi", "Hs_b", "dHs_dx", "dHs_dy",
        "SMB", "BMB", "LMB", "mask",
        "mask_gl_gr", "mask_gl_fl", "mask_cf_gr", "mask_cf_fl",
        "fraction_gr_b", "bed_roughness", "till_friction_angle",
        "pore_water_fraction", "basal_friction_coefficient",
        "TAF", "R_shear", "pc_truncation_error",
        # polyline fields, extracted on the host at output cadence
        # (mesh_output_files.f90 write_grounding_line_to_file ff.)
        "grounding_line", "ice_margin", "calving_front", "coastline",
        "grounded_ice_contour",
    }

    def _requested_output_fields(self):
        """Extra output variables from choice_output_field_01..50
        (model_configuration: every selected name becomes a variable in
        the main mesh + grid output files)."""
        req, unsupported = [], []
        for i in range(1, 51):
            v = getattr(self.C, f"choice_output_field_{i:02d}", "none")
            if not v or v == "none" or v in req \
                    or v in MESH_FIELDS_DEFAULT:
                continue
            if v in self._EXTRA_OUTPUT_SUPPORTED:
                req.append(v)
            else:
                unsupported.append(v)
        if unsupported:
            warning("choice_output_field: not yet writable, skipping {}",
                    unsupported)
        return req

    def _open_outputs(self):
        """Create the output files at the first output event: the mesh
        output of this mesh generation, the scalar series, the gridded
        output and, if asked for, the ISMIP file."""
        if self._outputs_open or self.output_dir is None:
            return
        out = Path(self.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        if self._out_gen is None:
            # mesh output files are numbered per mesh generation
            # (reference: a new main_output_<R>_0000N.nc per mesh
            # update, main_regional_output.f90). A fresh process
            # resuming into an output dir with existing generations
            # starts the next one so prior frames survive the resume.
            existing = [p for p in out.glob(f"main_output_{self.name}_0*.nc")
                        if "_grid" not in p.name]
            self._out_gen = len(existing) + 1
        self._extra_out_fields = self._requested_output_fields()
        out_fields = MESH_FIELDS_DEFAULT + self._extra_out_fields
        self.mesh_out = MeshOutputFile(
            out / f"main_output_{self.name}_{self._out_gen:05d}.nc",
            self.mesh, fields=out_fields)
        self.scalar_out = ScalarOutputFile(
            out / f"scalar_output_{self.name}_00001.nc")
        # gridded main output (grid_output_files.f90; created for every
        # region like the reference, UFEMISM_main_model.f90:664)
        self._out_grid = setup_square_grid(
            self.mesh.xmin, self.mesh.xmax, self.mesh.ymin, self.mesh.ymax,
            getattr(self.C, f"dx_output_grid_{self.name}"))
        self.grid_out = GridOutputFile(
            out / f"main_output_{self.name}_grid.nc", self.mesh,
            self._out_grid, fields=out_fields)
        # transect output files (transects_main.f90), one per
        # '||'-separated transect of transects_<R>
        self.transect_out = []
        for spec in getattr(self.C, f"transects_{self.name}").split("||"):
            if spec.strip():
                tr = Transect.from_config_str(self.mesh, spec.strip())
                self.transect_out.append(TransectOutputFile(
                    out / f"transect_{tr.name}.nc", tr))
        # a scalar file per region of interest (scalar_output_files_ROI.f90)
        self.roi_scalar_out = {}
        self.roi_history = {}
        for roi in (r.strip() for r in
                    self.C.choice_regions_of_interest.split(",")):
            if roi:
                self.roi_scalar_out[roi] = ScalarOutputFile(
                    out / f"scalar_output_{self.name}_{roi}_00001.nc")
                self.roi_history[roi] = []
        self._roi_masks = self._build_roi_masks()
        # ISMIP-standard gridded output (ismip_grid_output_files.f90)
        self.ismip_out = None
        if self.C.do_create_ismip_output:
            from ..io.ismip_output import ISMIPOutput
            self.ismip_out = ISMIPOutput(
                out / f"main_output_{self.name}_grid_ISMIP.nc",
                self._out_grid)
        self._outputs_open = True

    def _rotate_outputs_for_new_mesh(self):
        """Mesh update while outputs are open: rotate the mesh output
        file to the next generation (the reference creates a fresh
        main_output_<R>_0000N.nc per mesh, main_regional_output.f90)
        and rebuild the mesh->target maps of the gridded and transect
        files, which keep their history."""
        if not self._outputs_open:
            return
        self._out_gen += 1
        self.mesh_out = MeshOutputFile(
            Path(self.output_dir)
            / f"main_output_{self.name}_{self._out_gen:05d}.nc",
            self.mesh, fields=MESH_FIELDS_DEFAULT + self._extra_out_fields)
        self.grid_out.update_mesh(self.mesh)
        for tout in self.transect_out:
            tout.tr = Transect(self.mesh, tout.tr.points, tout.tr.name)
        self._roi_masks = self._build_roi_masks()

    def _build_roi_masks(self):
        """The vertices inside each region of interest of the scalar
        files, on the current mesh."""
        return {roi: torch.as_tensor(
            points_in_polygon(self.mesh.V, calc_roi_polygon(roi)),
            device=self.device) for roi in self.roi_scalar_out}

    def _ismip_map(self, f):
        M = get_map(self.mesh, self._out_grid)
        return (M @ np.asarray(f)).reshape(self._out_grid.nx,
                                           self._out_grid.ny).T

    def _output_fields(self, s, m, fg):
        """The mesh output fields at the region's time (the reference's
        default set and the requested extras), as device tensors."""
        C, md, extra = self.C, self.md, self._extra_out_fields
        # surface velocities stay on triangles, like the reference
        # (B_GRID_FIELDS routes them to the ti dim)
        u_sf = s.u_3D_b[:, 0]
        v_sf = s.v_3D_b[:, 0]
        fields = {
            "Hi": s.Hi, "Hb": s.Hb, "Hs": s.Hs, "Hib": s.Hib,
            "SL": s.SL, "dHi_dt": s.dHi_dt,
            "u_vav_b": s.u_vav_b, "v_vav_b": s.v_vav_b,
            "uabs_vav_b": torch.sqrt(s.u_vav_b ** 2 + s.v_vav_b ** 2),
            "divQ": s.divQ, "fraction_gr": fg,
            "Ti_base": s.Ti[:, -1],
            "u_surf": u_sf, "v_surf": v_sf,
            "uabs_surf": torch.sqrt(u_sf ** 2 + v_sf ** 2)}
        if "u_3D" in extra:
            fields["u_3D"] = s.u_3D_b
        if "v_3D" in extra:
            fields["v_3D"] = s.v_3D_b
        if "w_3D" in extra:
            from ..core.ice.thermodynamics import (
                calc_zeta_gradients, calc_vertical_velocities)
            dzx, dzy, dzz, _dzt = calc_zeta_gradients(
                md, s.Hi, s.Hs, s.dHi_dt, s.dHi_dt)
            u3a = md.M_map_b_a @ s.u_3D_b
            v3a = md.M_map_b_a @ s.v_3D_b
            fields["w_3D"] = calc_vertical_velocities(
                C, md, m, s.Hi, s.Hib, s.dHi_dt, torch.zeros_like(s.Hi),
                s.u_3D_b, s.v_3D_b, u3a, v3a, dzx, dzy, dzz, self.BMB)
        if "u_vav" in extra:
            fields["u_vav"] = s.u_vav_b
        if "v_vav" in extra:
            fields["v_vav"] = s.v_vav_b
        if "uabs_vav" in extra:
            fields["uabs_vav"] = torch.sqrt(s.u_vav_b ** 2 + s.v_vav_b ** 2)
        if "u_base" in extra or "v_base" in extra or "uabs_base" in extra:
            ub, vb = s.u_3D_b[:, -1], s.v_3D_b[:, -1]
            fields.update(u_base=ub, v_base=vb,
                          uabs_base=torch.sqrt(ub ** 2 + vb ** 2))
        if "dHi" in extra:
            fields["dHi"] = s.Hi - md.x("refgeo_Hi")
        if "Hs_b" in extra:
            fields["Hs_b"] = md.M_map_a_b @ s.Hs
        if "dHs_dx" in extra:
            fields["dHs_dx"] = md.M_ddx_a_a.exact_matvec(s.Hs)
        if "dHs_dy" in extra:
            fields["dHs_dy"] = md.M_ddy_a_a.exact_matvec(s.Hs)
        for name in ("SMB", "BMB", "LMB"):
            if name in extra:
                fields[name] = getattr(self, name)
        if "mask" in extra:
            fields["mask"] = s.mask.to(s.Hi.dtype)
        for mk in ("mask_gl_gr", "mask_gl_fl", "mask_cf_gr", "mask_cf_fl"):
            if mk in extra:
                fields[mk] = m[mk].to(s.Hi.dtype)
        if "fraction_gr_b" in extra:
            fields["fraction_gr_b"] = s.fraction_gr_b
        if "bed_roughness" in extra or "till_friction_angle" in extra:
            fields["bed_roughness"] = s.bed_roughness
            fields["till_friction_angle"] = s.bed_roughness
        if "pore_water_fraction" in extra:
            from ..core.ice.hydrology import \
                calc_pore_water_fraction_martin2011
            fields["pore_water_fraction"] = \
                calc_pore_water_fraction_martin2011(C, s.Hb, s.SL)
        if "basal_friction_coefficient" in extra:
            from ..core.ice.sliding import calc_basal_friction_coefficient
            from ..core.ice.ssadiva import _bed_roughness_fields
            from ..core.ice.subgrid import calc_effective_thickness
            Hi_eff_o, _fm = calc_effective_thickness(md, s.Hi, s.Hb, s.SL)
            u_base_a = md.M_map_b_a @ s.u_3D_b[:, -1].contiguous()
            v_base_a = md.M_map_b_a @ s.v_3D_b[:, -1].contiguous()
            slope = torch.sqrt(md.M_ddx_a_a.exact_matvec(s.Hs) ** 2
                               + md.M_ddy_a_a.exact_matvec(s.Hs) ** 2)
            fields["basal_friction_coefficient"] = \
                calc_basal_friction_coefficient(
                    C, md, _bed_roughness_fields(C, md, s.bed_roughness),
                    u_base_a, v_base_a, s.Hi, Hi_eff_o, s.Hb, s.SL, slope,
                    fg, m)
        if "TAF" in extra or any(f in LINE_FIELDS for f in extra):
            fields["TAF"] = s.TAF
            fields["mask_grounded_ice"] = \
                m["mask_grounded_ice"].to(s.Hi.dtype)
        if "pc_truncation_error" in extra:
            # mesh_output_files.f90:495: region%ice%pc%tau_np1
            fields["pc_truncation_error"] = s.pc.tau_np1
        if "R_shear" in extra:
            # slide/shear ratio, conservation_of_momentum_main.f90:240:
            # (|u_base| + 0.1) / (|u_surf| + 0.1)
            ub = md.M_map_b_a @ s.u_3D_b[:, -1].contiguous()
            vb = md.M_map_b_a @ s.v_3D_b[:, -1].contiguous()
            us = md.M_map_b_a @ s.u_3D_b[:, 0].contiguous()
            vs = md.M_map_b_a @ s.v_3D_b[:, 0].contiguous()
            fields["R_shear"] = (torch.sqrt(ub ** 2 + vb ** 2) + 0.1) \
                / (torch.sqrt(us ** 2 + vs ** 2) + 0.1)
        return fields

    def write_output(self):
        """The reference's output event at the region's time: masks,
        grounded fractions, the integrated scalars and the solver
        counters, appended to `scalars_history`; with an output
        directory also the mesh fields, written to the mesh, grid,
        scalar (and ISMIP) files. One host read of fields and scalars."""
        s = interpolate_ice_to_time(self.state, self.time)
        m, fg = self._masks_fracs(s.Hi, s.Hb, s.SL)
        scal = calc_ice_scalars(self.md, s.Hi, s.Hb, s.SL, fg, self.SMB,
                                self.BMB, self.LMB, masks=m,
                                fraction_margin=s.fraction_margin,
                                u_vav_b=s.u_vav_b, v_vav_b=s.v_vav_b,
                                dHi_dt=s.dHi_dt,
                                dHi_dt_target=s.dHi_dt_target)
        fields = {}
        if self.output_dir is not None:
            self._open_outputs()
            fields = self._output_fields(s, m, fg)
        host = host_arrays({**{"scalar." + k: v for k, v in scal.items()},
                            **fields})
        scal = {k: float(host.pop("scalar." + k)) for k in scal}
        scal.update(dt_ice=float(s.dt_ice), n_visc_its=int(s.n_visc_its),
                    n_Axb_its=int(s.n_Axb_its))
        self.scalars_history.append(
            {"time": self.time, **{k: float(v) for k, v in scal.items()}})
        if self.output_dir is None:
            return
        fields = host
        for name in (f for f in self._extra_out_fields if f in LINE_FIELDS):
            from ..mesh.contour import calc_mesh_contour, line_output_fields
            dmask, level = line_output_fields(
                name, fields["Hi"], fields["Hb"], fields["SL"],
                fields["TAF"], fields["mask_grounded_ice"] > 0.5)
            fields[name] = calc_mesh_contour(self.mesh, dmask, level)
        self.scalar_out.write(self.time, scal)
        for roi, mask in self._roi_masks.items():
            rs = calc_ice_scalars(self.md, s.Hi, s.Hb, s.SL, None, self.SMB,
                                  self.BMB, self.LMB, roi_mask=mask)
            rs = {k: float(v) for k, v in host_arrays(rs).items()}
            self.roi_scalar_out[roi].write(self.time, rs)
            self.roi_history[roi].append({"time": self.time, **rs})
        self.mesh_out.write(self.time, fields)
        self.grid_out.write(self.time, fields)
        for tout in self.transect_out:
            tout.write(self.time, s)
        if self.ismip_out is not None:
            from ..io.ismip_output import ismip_fields_from_state
            self.ismip_out.write(self.time, ismip_fields_from_state(
                self.md, self._out_grid, self._ismip_map, s, m, fg,
                self.SMB, self.BMB))

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

        if self.t_last_mesh_update is None:
            self.t_last_mesh_update = self.time
        with routine("run_model_region"):
            while self.time < t_end - 1e-9:
                # adaptive mesh update check (UFEMISM_main_model.f90:
                # 103-118)
                if (C.allow_mesh_updates
                        and self.time - self.t_last_mesh_update
                        >= C.dt_mesh_update_min):
                    fit = calc_mesh_fitness_coefficient(C, self.mesh,
                                                        self.state)
                    if fit < C.minimum_mesh_fitness_coefficient:
                        happy("mesh fitness {:.3f} < {:.3f}: updating mesh",
                              fit, C.minimum_mesh_fitness_coefficient)
                        self.update_mesh()
                    self.t_last_mesh_update = self.time

                # run components whose t_next has arrived
                self._run_components()

                # ice dynamics: advance the prediction window if due, up
                # to the next event boundary (and the next mesh-update
                # check). dt is NOT clamped to land on it: the
                # reference's ice window freely overshoots component
                # events and the region interpolates Hi inside it
                # (ice_dynamics_main.f90:85-121)
                if self.state.t_Hi_next <= self.time + 1e-9:
                    t_stop = min([t_end] + list(self.t_next.values()))
                    if C.allow_mesh_updates:
                        t_stop = min(t_stop, self.t_last_mesh_update
                                     + C.dt_mesh_update_min)
                    if self._dist is not None:
                        self._run_sharded(t_stop, dt_max, verbose)
                    elif t_stop > self.state.t_Hi_next + 1e-9:
                        step(self.do_thermo)
                        while self.state.t_Hi_next < t_stop - 1e-9:
                            step(self.do_thermo)
                    else:
                        # a single step with no thermodynamics catch-up,
                        # as the reference's run_to takes it
                        step(False)
                    if C.do_check_for_NaN:
                        # the reference's do_check_for_NaN: scan every
                        # state field after the dispatch and crash naming
                        # the offenders (a sharded dispatch has gathered
                        # the whole state on every rank, so every rank
                        # checks it all and raises alike)
                        check_state_for_nan(self.state,
                                            where=f"t={self.time:.3f}")

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

    def _run_sharded(self, t_stop, dt_max, verbose):
        """The ice steps of one window sharded over the ranks: the state
        and the forcing split into the ranks' blocks, the steps (with the
        thermodynamics fused) up to t_stop, the state gathered back, so
        that the component events run on the full state on every rank.
        As in the single-device loop, a window that the prediction
        already covers takes one step without thermodynamics."""
        D = self._dist
        sd = D.to_dist(self.state)
        SMB, BMB, LMB = (D.pad_field_V(f) for f in (self.SMB, self.BMB,
                                                    self.LMB))
        if t_stop > self.state.t_Hi_next + 1e-9:
            T_surf = D.pad_field_V(self._T_surf) if self.do_thermo else None
            sd, n, t_th, n_th, n_unstable = D.multistep(
                sd, t_stop, dt_max, SMB=SMB, BMB=BMB, LMB=LMB,
                T_surf=T_surf, t_th=self.t_thermo_next)
            if self.do_thermo:
                self.t_thermo_next = t_th
                self.thermo_steps += n_th
                self.thermo_n_unstable = self.thermo_n_unstable + n_unstable
        else:
            sd, n = D.step(sd, dt_max, SMB=SMB, BMB=BMB, LMB=LMB), 1
        self.state = D.from_dist(sd)
        self.n_dt_ice += n
        if verbose:
            print(f"  t={self.state.t_Hi_next:12.2f} yr  "
                  f"dt={self.state.dt_ice:8.4f}  "
                  f"steps={self.n_dt_ice}  "
                  f"visc={self.state.n_visc_its}  "
                  f"axb={self.state.n_Axb_its}  (sharded over "
                  f"{self._n_ranks} ranks)", flush=True)

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

        # the JAX package's order: climate, ocean, SMB, masks, BMB, LMB,
        # the basal hydrology, the tracers, GIA, then the bed-roughness
        # nudging
        if need("climate"):
            self.climate = self.run_climate(t, s)
            self._T_surf = self.climate["T2m"].mean(dim=1)
            bump("climate")
        if need("ocean"):
            self.ocean = self.run_ocean(t, s)
            bump("ocean")
        if need("SMB"):
            self.SMB = self.run_smb(t, s, climate=self.climate)
            bump("SMB")
        if need("BMB") or need("LMB"):
            masks, fg = self._masks_fracs(s.Hi, s.Hb, s.SL)
        if need("BMB"):
            self.BMB = self.run_bmb(t, s, masks, fg, self.ocean)
            bump("BMB")
        if need("LMB"):
            self.LMB = self.run_lmb(t, s, masks)
            bump("LMB")
        if need("basal_hydro"):
            if masks is None:
                masks, fg = self._masks_fracs(s.Hi, s.Hb, s.SL)
            self._run_hydrology(s, masks)
            bump("basal_hydro")
        if need("tracers"):
            self._run_tracers(s, t)
            bump("tracers")
        if need("GIA"):
            # the bed moves by the change of its deformation
            _, dHb = self.run_gia(t, s, self.dt_comp["GIA"])
            self.state = self.state.replace(
                dHb=dHb, Hb=self.state.Hb + (dHb - self.state.dHb))
            self.gia_events += 1
            bump("GIA")
        if need("bed_roughness"):
            if (self.C.bed_roughness_nudging_t_start <= t
                    <= self.C.bed_roughness_nudging_t_end):
                self._nudge_bed_roughness(s, masks)
            bump("bed_roughness")
        if need("checksum"):
            if self.checksum.enabled:
                self._log_checksums()
            bump("checksum")
        if need("output"):
            self.write_output()
            bump("output")
        if need("output_restart"):
            self.write_restart()
            bump("output_restart")

    def _run_hydrology(self, s, masks):
        """One Salle2025 leg on the state at the event's time, with the base
        velocities on the a-grid (the reference's ice%u_base); its till
        effective pressure goes into the slot the sliding laws read."""
        u_base_a = self.md.M_map_b_a @ s.u_3D_b[:, -1].contiguous()
        v_base_a = self.md.M_map_b_a @ s.v_3D_b[:, -1].contiguous()
        self.hydro_state, N_til, _, n_sub = run_salle2025_leg(
            self.C, self.md, self.hydro_state, s.Hi, s.Hb,
            masks["mask_grounded_ice"], u_base_a, v_base_a)
        self.md.extras["hydro_N_eff"].arr = N_til
        self.hydro_substeps.append(n_sub)

    def _spawn_draw(self, n):
        """The vertex indices of a spawn event: n draws from the host
        generator, on the region's device."""
        return torch.randint(0, self.md.nV, (n,),
                             generator=self._tracer_gen).to(self.device)

    def _run_tracers(self, s, t):
        """Spawn at the surface, then one RK2 step of the particles."""
        idx = self._spawn_draw(self.tracer_state.x.shape[0])
        self.tracer_state = self._tracer_spawn(self.tracer_state, s, t, idx)
        self.tracer_state = self._tracer_step(
            self.tracer_state, s, self.dt_comp["tracers"], t)

    def _nudge_bed_roughness(self, s, masks):
        """One nudging step of the bed roughness towards the PD reference
        geometry (the bed_roughness event); the region-held roughness
        state is what is nudged, and it is written into the ice state.
        `s` is the state at the event's time."""
        if masks is None:
            masks = determine_masks(self.md, s.Hi, s.Hb, s.SL)
        kw = dict(dtype=self.md.A.dtype, device=self.device)
        Hi_PD = torch.as_tensor(self.refgeo_PD[0], **kw)
        Hb_PD = torch.as_tensor(self.refgeo_PD[1], **kw)
        tgt_Hs = ice_surface_elevation(Hi_PD, Hb_PD, s.SL)
        self.bed_roughness_state = self._nudge_step(
            s, masks, self.bed_roughness_state, tgt_Hs, Hi_PD)
        self.state = self.state.replace(
            bed_roughness=self.bed_roughness_state.generic)
        self.nudging_events += 1

    # -- adaptive mesh updates (UFEMISM_main_model.f90:1211-1474) -------------

    def update_mesh(self):
        """Create a new mesh fitted to the current geometry and move the
        region onto it (update_mesh, :1211): rasterise the geometry, build
        the mesh, remap the full state (one host read, one upload),
        restart the PC controller at dt_ice_min, rebuild everything that
        holds the mesh's tables, refresh the forcing, rotate the output
        files and write the restart. The wall time of the three parts
        (mesh build, map build, device rebuild) is appended to
        `remesh_timings`."""
        C = self.C
        t_start = _time.perf_counter()
        old_mesh, s = self.mesh, self.state
        self.n_mesh_updates += 1
        old = host_arrays(_state_leaves(s))

        # rasterise the current geometry to a grid for feature extraction
        dx = max(min(C.maximum_resolution_grounding_line,
                     C.maximum_resolution_calving_front) / 2.0,
                 old_mesh.R.min())
        g = setup_square_grid(old_mesh.xmin, old_mesh.xmax,
                              old_mesh.ymin, old_mesh.ymax, dx)
        Mg = get_map(old_mesh, g, method="trilin")
        Hi_g, Hb_g, SL_g = ((Mg @ old[k]).reshape(g.nx, g.ny)
                            for k in ("Hi", "Hb", "SL"))
        new_mesh = build_mesh_from_gridded_geometry(
            C, self.name, g.x, g.y, Hi_g, Hb_g, SL_g)
        t_mesh = _time.perf_counter()

        # the maps of the full state (every field per its metadata -
        # conservative / trilinear / reinit / copy; the reference's
        # remap-everything walk, UFEMISM_main_model.f90:1311-1323); the
        # conservative map builds the new mesh's operators
        M_cons_a = get_map(old_mesh, new_mesh)
        M_tri_a = get_map(old_mesh, new_mesh, method="trilin")
        M_b = build_map_nearest(old_mesh.TriGC, new_mesh.TriGC,
                                old_mesh.nTri)
        moved = remap_leaves(old, (M_cons_a, M_b), (M_tri_a, M_b))
        Hi_PD, Hb_PD = self.refgeo_PD
        self.refgeo_PD = (M_tri_a @ Hi_PD, M_tri_a @ Hb_PD)
        t_maps = _time.perf_counter()

        glen_scale = self.md.extras.get("glen_A_scale")
        old_N_eff = self.md.extras.get("hydro_N_eff")
        self.mesh = new_mesh
        self.md = build_mesh_data(new_mesh, dtype=self.md.A.dtype,
                                  device=self.device)
        if glen_scale is not None:
            self.md.extras["glen_A_scale"] = glen_scale
        leaves = _state_leaves(s)
        init = {"init.Hi": np.maximum(0.0, M_cons_a @ old["Hi"]),
                "init.Hb": M_cons_a @ old["Hb"],
                "init.SL": M_tri_a @ old["SL"]}
        dev = device_arrays(
            {**init, **moved},
            {**{k: self.md.A.dtype for k in init},
             **{k: leaves[k].dtype for k in moved}}, self.device)
        Hi_new = dev["init.Hi"]
        new_state = init_ice_state(self.md, Hi_new, dev["init.Hb"],
                                   dev["init.SL"], nz=C.nz,
                                   dt_init=s.pc.dt_np1)
        new_state = assemble_remapped_state(
            s, new_state, {k: dev[k] for k in moved})
        # reinitialise the PC controller from scratch at dt_ice_min, as
        # the reference does (remap_pc_scheme,
        # predictor_corrector_scheme.f90:645-658)
        pc0 = new_state.pc
        self.state = new_state.replace(
            Hi=Hi_new, Hi_prev=Hi_new, Hi_next=Hi_new,
            t_Hi_prev=s.t_Hi_next, t_Hi_next=s.t_Hi_next,
            dt_ice=float(C.dt_ice_min),
            pc=PCState(dt_n=float(C.dt_ice_min),
                       dt_np1=float(C.dt_ice_min),
                       eta_n=float(C.pc_epsilon),
                       eta_np1=float(C.pc_epsilon),
                       dHi_dt_Hi_nm1_u_nm1=torch.zeros_like(
                           pc0.dHi_dt_Hi_nm1_u_nm1),
                       tau_np1=torch.zeros_like(pc0.tau_np1)))

        # rebuild what holds the mesh, and refresh the forcing on it (the
        # reference resets every component t_next to now instead,
        # UFEMISM_main_model.f90:1326-1335). The stateful runners (the
        # matrix climate's albedo, IMAU-ITM's firn, the nudge2D ocean's
        # offset) take their state over through the trilinear map; the
        # inverted BMB starts again at zero, as the JAX package's does;
        # the nudged roughness and the bed deformation dHb moved with the
        # ice state
        old_runners = (self.run_climate, self.run_ocean, self.run_smb)
        self._build_on_mesh()
        kw = dict(dtype=self.md.A.dtype, device=self.device)

        def remap_tri(a):
            return torch.as_tensor(M_tri_a @ a.double().cpu().numpy(), **kw)
        for new_r, old_r in zip((self.run_climate, self.run_ocean,
                                 self.run_smb), old_runners):
            if (hasattr(new_r, "carry_state_from")
                    and type(new_r) is type(old_r)):
                new_r.carry_state_from(old_r, remap_tri)
        self.bed_roughness_state = BedRoughnessState(
            generic=self.state.bed_roughness)
        # Salle2025: the sheet and till water and the pressure move with
        # the trilinear map, and so does the effective-pressure slot
        # (basal_hydrology_new.f90:1449-1491 remaps them on a mesh update)
        if C.choice_basal_hydrology_model == "Salle2025":
            hs = self.hydro_state
            self.hydro_state = Salle2025State(
                W=torch.clamp(remap_tri(hs.W), min=0.0),
                W_til=torch.clamp(remap_tri(hs.W_til), min=0.0),
                P=remap_tri(hs.P))
            self.md.extras["hydro_N_eff"] = EField(
                remap_tri(old_N_eff.arr), "V")
        # tracers live in physical coordinates and carry over as they are;
        # the point-location tables and the stepper are rebuilt
        if C.choice_tracer_tracking_model == "particles":
            self._build_tracers()
        self._refresh_forcing()
        if self._dist is not None:
            # the halo tables and blocks are the old mesh's
            self._dist = ShardedModel(C, self, self._n_ranks,
                                      self._rank_group)
        self._sync()
        t_device = _time.perf_counter()
        self._rotate_outputs_for_new_mesh()
        self.t_last_mesh_update = self.time
        # the reference recreates its restart file per mesh
        # (output_files.f90:320-321)
        self.write_restart()
        self.remesh_timings.append({"mesh_s": t_mesh - t_start,
                                    "maps_s": t_maps - t_mesh,
                                    "device_s": t_device - t_maps})


def calc_mesh_fitness_coefficient(C, mesh, state):
    """Fraction of grounding-line/calving-front vertices still meeting
    their target resolution (calc_mesh_fitness_coefficient, :1356); one
    host read of the four masks."""
    m = host_arrays({k: getattr(state, k) for k in (
        "mask_gl_gr", "mask_gl_fl", "mask_cf_gr", "mask_cf_fl")})
    gl = m["mask_gl_gr"] | m["mask_gl_fl"]
    cf = m["mask_cf_gr"] | m["mask_cf_fl"]
    R = mesh.R
    tol = C.mesh_resolution_tolerance
    n_tot = int(gl.sum() + cf.sum())
    if n_tot == 0:
        return 1.0
    bad_gl = gl & (R > C.maximum_resolution_grounding_line * tol)
    bad_cf = cf & (R > C.maximum_resolution_calving_front * tol)
    return 1.0 - (int(bad_gl.sum()) + int(bad_cf.sum())) / n_tot


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
