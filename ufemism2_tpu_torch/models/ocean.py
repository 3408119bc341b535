"""Ocean models: 3-D T/S fields and ice-draft properties.

Re-design of src/UFEMISM/ocean/ (ocean_main.f90:92-106 dispatch): none,
idealised (the ISOMIP+ and MISMIP+ WARM/COLD profiles, TANH, LINEAR,
LINEAR_THERMOCLINE), realistic (a snapshot, a snapshot plus a uniform or
a transient deltaT), snapshot plus anomalies, and snapshot+nudge2D, with
the cavity extrapolation of the forcing fields (ocean_extrapolation.f90:
15-222) on the host at set-up.
Vertical axis: the ocean depth grid (0 .. ocean_vertical_grid_max_depth,
spacing dz, ocean_utilities.f90:219-245).
"""

from __future__ import annotations

import numpy as np
import torch

from .bmb import ocean_freezing_point_at_draft
from ..utils.interp import frame_weights


def ocean_depth_axis(C):
    return np.arange(0.0, C.ocean_vertical_grid_max_depth + 1e-9,
                     C.ocean_vertical_grid_dz)


# ---------------------------------------------------------------------------
# Cavity extrapolation (ocean_extrapolation.f90), host-side numpy
# ---------------------------------------------------------------------------

def _gaussian_fill_2d(mesh, d, fillable):
    """Iterative neighbour-average fill of the NaN entries flagged
    fillable [nV, nz] (the reference's extrapolate_Gaussian per layer)."""
    C = mesh.C
    mask_C = C >= 0
    Cs = np.maximum(C, 0)
    d = d.copy()
    for _ in range(64):
        isnan = np.isnan(d)
        todo = isnan & fillable
        if not todo.any():
            break
        nb = d[Cs]                               # [nV, nC_mem, nz]
        valid = (~np.isnan(nb)) & mask_C[:, :, None]
        nbsum = np.where(valid, np.nan_to_num(nb), 0.0).sum(axis=1)
        nbcnt = valid.sum(axis=1)
        avg = nbsum / np.maximum(nbcnt, 1)
        new = todo & (nbcnt > 0)
        d[new] = avg[new]
    return d


def extrapolate_ocean_forcing(mesh, Hi, Hb, SL, z_ocean, d):
    """Fill the 3-D ocean field into cavities, ice and bedrock
    (ocean_extrapolation.f90 extrapolate_ocean_forcing:15-49):
    0. NaN below bedrock; 1. horizontal fill inside cavities;
    2. vertical fill up into the shelf and down into bedrock;
    3. horizontal fill everywhere else."""
    d = np.array(d, dtype=np.float64)
    z = np.asarray(z_ocean)
    # ice draft: floating draft, clamped to the bed where grounded
    Hib = np.maximum(np.asarray(SL) - np.asarray(Hi) * 910.0 / 1028.0,
                     np.asarray(Hb))
    Hb = np.asarray(Hb)

    below_bed = z[None, :] > -Hb[:, None]
    d[below_bed] = np.nan

    in_cavity = (z[None, :] > -Hib[:, None]) & (z[None, :] < -Hb[:, None])
    d = _gaussian_fill_2d(mesh, d, in_cavity)

    for vi in range(d.shape[0]):
        col = d[vi]
        good = np.flatnonzero(~np.isnan(col))
        if len(good) == 0:
            continue
        col[:good[0]] = col[good[0]]
        col[good[-1]:] = col[good[-1]]
        # interior gaps: linear interpolation between bracketing values
        bad = np.isnan(col)
        if bad.any():
            col[bad] = np.interp(z[bad], z[~bad], col[~bad])
        d[vi] = col

    d = _gaussian_fill_2d(mesh, d, np.ones_like(d, dtype=bool))
    return np.nan_to_num(d, nan=0.0)


# ---------------------------------------------------------------------------
# Model factory
# ---------------------------------------------------------------------------

def make_run_ocean(C, md, region_name: str, mesh=None):
    """Returns run(time, state) -> dict(T [nV,nd], S [nV,nd], T_draft,
    S_draft, T_freezing_point, depths)."""
    choice = getattr(C, f"choice_ocean_model_{region_name}")
    nV, dtype, device = md.nV, md.A.dtype, md.device
    depths = torch.as_tensor(ocean_depth_axis(C), dtype=dtype, device=device)
    nd = depths.shape[0]
    rows = torch.arange(nV, device=device)

    def draft_properties(Tf, Sf, s):
        draft = s.Hib
        depth = torch.clamp(s.SL - draft, min=0.0)
        # T and S interpolated to the draft's depth
        idx = torch.clamp(torch.searchsorted(depths, depth) - 1, 0, nd - 2)
        w = (depth - depths[idx]) / (depths[idx + 1] - depths[idx])
        T_draft = Tf[rows, idx] * (1 - w) + Tf[rows, idx + 1] * w
        S_draft = Sf[rows, idx] * (1 - w) + Sf[rows, idx + 1] * w
        Tfp = ocean_freezing_point_at_draft(S_draft, draft)
        return dict(T=Tf, S=Sf, T_draft=T_draft, S_draft=S_draft,
                    T_freezing_point=Tfp, depths=depths)

    if choice == "none":
        Tf = torch.full((nV, nd), -1.9, dtype=dtype, device=device)
        Sf = torch.full((nV, nd), 34.0, dtype=dtype, device=device)
        return lambda time, s: draft_properties(Tf, Sf, s)

    if choice == "idealised":
        Tprof, Sprof = idealised_profiles(C, depths)
        Tf, Sf = (p[None, :].expand(nV, nd) for p in (Tprof, Sprof))
        return lambda time, s: draft_properties(Tf, Sf, s)

    if choice == "GlacialIndex":
        # the JAX package's branch reads filename_glacial_index and the
        # cold snapshot's file name, which the schema does not define, so
        # no configuration reaches it there either
        raise ValueError("choice_ocean_model 'GlacialIndex' needs a "
                         "glacial-index series file, which the "
                         "configuration schema does not name")

    if choice in ("realistic", "snapshot_plus_uniform_deltaT",
                  "deltaT_transient"):
        return _make_run_realistic(C, md, region_name, mesh, choice,
                                   depths, draft_properties)

    if choice == "snapshot+nudge2D":
        return OceanNudge2D(C, md, region_name, mesh, depths,
                            draft_properties)

    if choice == "snapshot_plus_anomalies":
        # baseline snapshot + time-interpolated 3-D T/S anomalies
        # (ocean_snapshot_plus_anomalies.f90:22-70), the anomaly series
        # held on the device
        if mesh is None:
            raise ValueError("ocean snapshot_plus_anomalies needs the "
                             "host mesh")
        from ..io.input_files import load_timeframe_series
        z_ocean = depths.double().cpu().numpy()
        T0f, S0f = _load_snapshot_TS(
            C, mesh, md, region_name,
            C.ocean_snp_p_anml_filename_snapshot, z_ocean)
        fname = C.ocean_snp_p_anml_filename_anomalies
        tt, dT = load_timeframe_series(fname, "temperature_anomaly", mesh,
                                       reader="3D_ocean", z_ocean=z_ocean)
        _, dS = load_timeframe_series(fname, "salinity_anomaly", mesh,
                                      reader="3D_ocean", z_ocean=z_ocean)
        kw = dict(dtype=dtype, device=device)
        tt_d = torch.as_tensor(tt, **kw)
        dT_d = torch.as_tensor(dT, **kw)
        dS_d = torch.as_tensor(dS, **kw)

        def run(time, s):
            i, w = frame_weights(time, tt_d)
            Tf = T0f + (1 - w) * dT_d[i] + w * dT_d[i + 1]
            Sf = S0f + (1 - w) * dS_d[i] + w * dS_d[i + 1]
            return draft_properties(Tf, Sf, s)
        return run

    raise ValueError(f"unknown choice_ocean_model '{choice}'")


def idealised_profiles(C, depths):
    """(T, S) profiles [nd] of choice_ocean_model_idealised on the depth
    axis (ocean_idealised.f90)."""
    from ..utils.constants import (freezing_lambda_1, freezing_lambda_2,
                                   seawater_density)
    sub = C.choice_ocean_model_idealised
    if sub in ("MISMIPplus_WARM", "MISMIPplus_COLD"):
        # ISOMIP+ WARM/COLD profiles (Asay-Davis et al. 2016, Table 4),
        # clipped below 720 m
        T_top, T_bot = (-1.9, 1.0) if sub.endswith("WARM") else (-1.9, -1.9)
        S_top, S_bot = 33.8, 34.7
        frac = torch.clamp(depths / 720.0, 0.0, 1.0)
        return (T_top + (T_bot - T_top) * frac,
                S_top + (S_bot - S_top) * frac)
    if sub == "ISOMIP":
        # the scenario's linear ramp over z1 = 720 m, not clipped below
        # it (ocean_idealised.f90:114-148)
        scen = C.choice_ocean_isomip_scenario
        if scen == "WARM":
            T1, S1 = 1.0, 34.7
        elif scen == "COLD":
            T1, S1 = -1.9, 34.55
        else:
            raise ValueError(
                f"unknown choice_ocean_isomip_scenario '{scen}'")
        T0, S0, z1 = -1.9, 33.8, 720.0
        return (T0 + (T1 - T0) * depths / z1, S0 + (S1 - S0) * depths / z1)
    if sub == "TANH":
        # two layers joined by a tanh thermocline, the salinity from the
        # linear equation of state (ocean_idealised.f90:150-188)
        S0 = 34.0
        Tsurf = freezing_lambda_1 * S0 + freezing_lambda_2
        drho0 = 0.01
        Tprof = Tsurf + (C.ocean_tanh_deep_temperature - Tsurf) * (
            1 + torch.tanh((depths - C.ocean_tanh_thermocline_depth)
                           / C.ocean_tanh_thermocline_scale_depth)) / 2
        Sprof = (S0
                 + C.uniform_laddie_eos_linear_alpha
                 * (Tprof - Tsurf) / C.uniform_laddie_eos_linear_beta
                 + drho0 * torch.sqrt(depths)
                 / (C.uniform_laddie_eos_linear_beta * seawater_density))
        return Tprof, Sprof
    if sub == "LINEAR":
        # a linear ramp from the surface freezing point
        # (ocean_idealised.f90:190-227)
        S0 = 34.5
        Tsurf = freezing_lambda_1 * S0 + freezing_lambda_2
        zr = C.ocean_linear_reference_depth
        return (Tsurf + (C.ocean_linear_deep_temperature - Tsurf)
                * depths / zr,
                S0 + (C.ocean_linear_deep_salinity - S0) * depths / zr)
    if sub == "LINEAR_THERMOCLINE":
        # two layers joined by a linear thermocline (De Rydt et al. 2014;
        # ocean_idealised.f90:229-284)
        zt = C.ocean_lin_therm_thermocline_top
        zb = C.ocean_lin_therm_thermocline_bottom
        T0, T1 = (C.ocean_lin_therm_surf_temperature,
                  C.ocean_lin_therm_deep_temperature)
        S0, S1 = (C.ocean_lin_therm_surf_salinity,
                  C.ocean_lin_therm_deep_salinity)
        w = torch.clamp((depths - zt) / (zb - zt), 0.0, 1.0)
        return T0 + (T1 - T0) * w, S0 + (S1 - S0) * w
    raise ValueError(f"unknown choice_ocean_model_idealised '{sub}'")


def _load_snapshot_TS(C, mesh, md, region_name, fname, z_ocean,
                      extrapolate=True):
    """A T/S ocean snapshot read onto the mesh and extrapolated into the
    cavities, as device tensors (ocean_realistic.f90
    initialise_ocean_model_snapshot:176-226)."""
    from ..io.input_files import read_field_from_file_3D_ocean
    T = read_field_from_file_3D_ocean(fname, "T_ocean", mesh, z_ocean)
    S = read_field_from_file_3D_ocean(fname, "S_ocean", mesh, z_ocean)
    if extrapolate and C.choice_ocean_extrapolation_method \
            == "initialisation":
        Hi, Hb, SL = _init_geometry_for_extrap(C, region_name, mesh)
        T = extrapolate_ocean_forcing(mesh, Hi, Hb, SL, z_ocean, T)
        S = extrapolate_ocean_forcing(mesh, Hi, Hb, SL, z_ocean, S)
    kw = dict(dtype=md.A.dtype, device=md.device)
    return torch.as_tensor(T, **kw), torch.as_tensor(S, **kw)


def _init_geometry_for_extrap(C, region, mesh):
    """The initial geometry's Hi/Hb/SL on the mesh (the cavities of the
    extrapolation)."""
    choice = getattr(C, f"choice_refgeo_init_{region}")
    if choice == "read_from_file":
        from ..io.input_files import read_geometry_onto_mesh
        return read_geometry_onto_mesh(C, region, mesh, which="init")
    from ..core.idealised_geometries import calc_idealised_geometry
    Hi, Hb, Hs, SL = calc_idealised_geometry(
        mesh.V[:, 0], mesh.V[:, 1], C.choice_refgeo_init_idealised, C)
    return Hi, Hb, SL


def _make_run_realistic(C, md, region_name, mesh, choice, depths,
                        draft_properties):
    if mesh is None:
        raise ValueError(f"ocean '{choice}' needs the host mesh for file "
                         "input")
    z_ocean = depths.double().cpu().numpy()

    if choice == "realistic" and C.choice_ocean_model_realistic not in (
            "snapshot", "snapshot_plus_uniform_deltaT", "transient", ""):
        raise ValueError("unknown choice_ocean_model_realistic "
                         f"'{C.choice_ocean_model_realistic}'")

    fname = getattr(C, f"filename_ocean_snapshot_{region_name}")
    T0f, S0f = _load_snapshot_TS(C, mesh, md, region_name, fname, z_ocean)

    if choice in ("realistic", "snapshot_plus_uniform_deltaT") and \
            C.choice_ocean_model_realistic != "transient":
        dT = getattr(C, f"ocean_uniform_deltaT_{region_name}") \
            if (choice == "snapshot_plus_uniform_deltaT"
                or C.choice_ocean_model_realistic
                == "snapshot_plus_uniform_deltaT") else 0.0
        Tf = T0f + dT
        return lambda time, s: draft_properties(Tf, S0f, s)

    # the snapshot plus a uniform deltaT(t) from a series file
    # (ocean_deltaT_transient.f90)
    from ..io.input_files import read_series_from_file
    fname_dT = getattr(C, f"filename_ocean_dT_{region_name}")
    tt, dd = read_series_from_file(fname_dT, "dT_ocean")

    def run(time, s):
        dT = float(np.interp(float(time), tt, dd))
        return draft_properties(T0f + dT, S0f, s)
    return run


class OceanNudge2D:
    """snapshot+nudge2D: a 2-D ocean temperature offset deltaT(x, y)
    nudged so that the modelled shelf thickness tracks the target
    geometry (ocean_snapshot_nudge2D.f90: dT/dt = c_H dH + c_dHdt dH/dt on
    fully floating vertices off the margin, extrapolated outward, clipped
    to +-2 K, added to the snapshot's T). deltaT is host-held state
    carried between calls, and across a mesh update by carry_state_from."""

    C_H = 1e-5
    C_DHDT = 3e-4
    DT_MAX = 2.0

    def __init__(self, C, md, region_name, mesh, depths, draft_properties):
        if mesh is None:
            raise ValueError("ocean snapshot+nudge2D needs the host mesh")
        self.C, self.md = C, md
        self._draft = draft_properties
        kw = dict(dtype=md.A.dtype, device=md.device)
        z_ocean = depths.double().cpu().numpy()
        fname = getattr(C, f"filename_ocean_snapshot_{region_name}")
        self.T0, self.S0 = _load_snapshot_TS(C, mesh, md, region_name,
                                             fname, z_ocean)
        # the target thickness: the initial geometry (else the PD file)
        try:
            Hi_t, _, _ = _init_geometry_for_extrap(C, region_name, mesh)
        except (OSError, KeyError, ValueError):
            from ..io.input_files import read_geometry_onto_mesh
            Hi_t, _, _ = read_geometry_onto_mesh(C, region_name, mesh,
                                                 which="PD")
        self.Hi_target = torch.as_tensor(Hi_t, **kw)
        self.deltaT = torch.zeros(md.nV, **kw)
        self._t_prev = None
        self.t_start = C.BMB_inversion_t_start
        self.t_end = C.BMB_inversion_t_end

    def carry_state_from(self, old, remap):
        """Take the nudged deltaT over from the runner of the previous
        mesh (remap: a host map from the old mesh to this one)."""
        self.deltaT = torch.clamp(remap(old.deltaT), -self.DT_MAX,
                                  self.DT_MAX)
        self._t_prev = old._t_prev

    def __call__(self, time, s):
        t = float(time)
        # nudging inside the inversion window only; outside, the frozen
        # deltaT applies
        if self.t_start <= t <= self.t_end:
            from .bed_roughness import gaussian_extrapolate
            dt = (t - self._t_prev) if self._t_prev is not None \
                else self.C.dt_ocean
            self._t_prev = t
            fully_floating = (s.Hi > 0.1) & (self.md.M_map_b_a
                                             @ s.fraction_gr_b < 0.01)
            seed = fully_floating & ~s.mask_margin
            dTdt = torch.where(seed,
                               self.C_H * (s.Hi - self.Hi_target)
                               + self.C_DHDT * s.dHi_dt, 0.0)
            dT = torch.clamp(self.deltaT + dt * dTdt,
                             -self.DT_MAX, self.DT_MAX)
            dT = gaussian_extrapolate(self.md, seed, ~seed, dT)
            self.deltaT = torch.clamp(dT, -self.DT_MAX, self.DT_MAX)
        return self._draft(self.T0 + self.deltaT[:, None], self.S0, s)
