"""Climate matrix method: interpolation between GCM snapshots by CO2 and
absorbed insolation (Berends et al. 2018).

Re-design of src/UFEMISM/climate/climate_matrix.f90: at set-up, read the
present-day observed climate and the PI, warm and cold GCM snapshots (with
winds), bias-correct warm and cold against (PI - PD_obs), derive each
snapshot's lapse rate (spatially variable for NAM and EAS) and its
reference absorbed insolation I_abs (ten years of the IMAU-ITM albedo
scheme on the snapshot's climate, climate_matrix.f90:738-865). At run
time, interpolate the temperature by w_tot(CO2, I_abs) (Eqs. 1-6, 8-11)
and the precipitation by ice-geometry weights, downscaled by
Clausius-Clapeyron (GRL, ANT; Eqs. 13-14) or by Roe & Lindzen (NAM, EAS;
Eqs. 12, A3-A7).

The runner carries its own IMAU-ITM albedo state, stepped on the climate
it last applied (the reference reads the SMB model's Albedo; the JAX
package does the same as here, which avoids a circular climate-SMB
dependency). Every call advances that state by one year.

The reference's floors of 1e-300 are kept as written: a floor is rounded
to the run's dtype first, so in f32 it is 0, as on the JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import pi, T0, sec_per_year
from ..utils.interp import interp
from .smb import imau_itm_params, imau_itm_step


W_CUTOFF_T = 0.5     # temperature-weight crop (climate_matrix.f90:121)
W_CUTOFF_P = 0.25    # precipitation-weight crop (:320)
TINY = 1e-300        # the reference's floor of precipitation


def floor_at(x, v):
    """max(x, v) with v rounded to x's dtype first (1e-300 is 0 in f32)."""
    return torch.clamp(x, min=float(torch.tensor(v, dtype=x.dtype)))


def _read_snapshot_with_winds(mesh, fname, kw):
    from ..io.input_files import (read_field_from_file_2D,
                                  read_field_from_file_2D_monthly)
    snap = {"Hs": torch.as_tensor(read_field_from_file_2D(fname, "Hs", mesh),
                                  **kw)}
    for key in ("T2m", "Precip"):
        snap[key] = torch.as_tensor(
            read_field_from_file_2D_monthly(fname, key, mesh), **kw)
    for key, names in (("Wind_WE", "Wind_WE||uas"),
                       ("Wind_SN", "Wind_SN||vas")):
        try:
            snap[key] = torch.as_tensor(
                read_field_from_file_2D_monthly(fname, names, mesh), **kw)
        except KeyError:
            snap[key] = torch.zeros_like(snap["T2m"])
    snap["Wind_LR"], snap["Wind_DU"] = rotate_wind_to_model_mesh(
        mesh, snap["Wind_WE"], snap["Wind_SN"])
    return snap


def rotate_wind_to_model_mesh(mesh, wind_WE, wind_SN):
    """Geographic zonal/meridional winds to the model's x/y components
    (climate_model_utilities.f90:287-332)."""
    lambda_M = mesh.proj[0] if mesh.proj is not None else 0.0
    ang = np.deg2rad(np.asarray(mesh.lon) - (lambda_M - 90.0))[:, None]
    kw = dict(dtype=wind_WE.dtype, device=wind_WE.device)
    s = torch.as_tensor(np.sin(ang), **kw)
    c = torch.as_tensor(np.cos(ang), **kw)
    return wind_WE * s + wind_SN * c, -wind_WE * c + wind_SN * s


def _smooth(md, f, n_pass=8):
    """Neighbour-average smoothing in place of the reference's gridded
    Gaussian filter (about 160-200 km)."""
    from .bed_roughness import smooth_field
    return smooth_field(md, f, n_pass=n_pass, w_smooth=0.5)


def _spatially_variable_lapserate(C, md, snap_PI, snap):
    """Berends et al. 2018 Eq. 10 (climate_matrix.f90:587-736)."""
    lam_const = C.climate_matrix_constant_lapserate
    mask = snap["Hs"] > snap_PI["Hs"] + 100.0
    n_non = torch.clamp((~mask).sum() * 12, min=1)
    dT_nonice = torch.where(~mask[:, None], snap["T2m"] - snap_PI["T2m"],
                            0.0).sum() / n_non
    lam_ice = torch.clamp(
        -(snap["T2m"] - (snap_PI["T2m"] + dT_nonice))
        / torch.clamp(snap["Hs"] - snap_PI["Hs"], min=1.0)[:, None],
        0.002, 0.05).mean(dim=1)
    lam_mean_ice = torch.where(mask, lam_ice, 0.0).sum() \
        / torch.clamp(mask.sum(), min=1)
    lam = _smooth(md, torch.where(mask, lam_ice, lam_mean_ice))
    return lam * (lam_const / torch.clamp(lam_mean_ice, min=1e-12))


def _calc_I_abs(C, md, region_name, snap, insol, orbit_time, mask_noice):
    """The reference absorbed insolation: ten years of the IMAU-ITM
    albedo scheme on the snapshot's climate (climate_matrix.f90:738-865).
    Returns (I_abs [nV], Q_TOA [nV, 12])."""
    p = imau_itm_params(C, region_name)
    Q_TOA = insol.at_time(orbit_time)
    kw = dict(dtype=md.A.dtype, device=md.device)
    Hs = snap["Hs"]
    masks = dict(mask_icefree_ocean=Hs == Hs.min(),
                 mask_grounded_ice=(Hs > 100.0)
                 & (snap["T2m"].mean(dim=1) < 0.0),
                 mask_floating_ice=torch.zeros(md.nV, dtype=torch.bool,
                                               device=md.device))
    firn = torch.full((md.nV, 12), C.SMB_IMAUITM_initial_firn_thickness,
                      **kw)
    melt_yr = torch.zeros(md.nV, **kw)
    albedo = None
    for _ in range(10):
        _, aux = imau_itm_step(p, snap["T2m"], snap["Precip"], Q_TOA,
                               masks, mask_noice, firn, melt_yr)
        firn, melt_yr, albedo = (aux["FirnDepth"], aux["MeltPreviousYear"],
                                 aux["Albedo"])
    return (Q_TOA * (1.0 - albedo)).sum(dim=1), Q_TOA


def precipitation_model_roe(T2m, dHs_dx, dHs_dy, wind_LR, wind_DU):
    """Roe (2002) / Roe & Lindzen (2001) orographic precipitation
    (climate_model_utilities.f90:238-285) [m w.e./yr]."""
    e_sat0, c_one, c_two = 611.2, 17.67, 243.5
    a_par, b_par, alpha = 2.5e-11, 5.9e-9, 100.0
    upwind = torch.clamp(wind_LR * dHs_dx + wind_DU * dHs_dy, min=0.0)
    E_sat = e_sat0 * torch.exp(c_one * (T2m - T0) / (c_two + T2m - T0))
    x0 = a_par / b_par + upwind
    err = torch.special.erf(alpha * torch.abs(x0))
    return (b_par * E_sat) * (
        x0 / 2.0 + x0 ** 2 * err / (2.0 * torch.abs(x0))
        + torch.exp(-alpha ** 2 * x0 ** 2) / (2.0 * float(np.sqrt(pi))
                                              * alpha)
    ) * sec_per_year


def adapt_precip_CC(Hs, Hs_ref, T_ref, P_ref, region_name, lapse_const):
    """Clausius-Clapeyron precipitation downscaling
    (climate_model_utilities.f90:110-177)."""
    T_inv_ref = 88.9 + 0.67 * T_ref
    T_inv = 88.9 + 0.67 * (T_ref - lapse_const * (Hs - Hs_ref)[:, None])
    if region_name == "GRL":
        return P_ref * 1.04 ** (T_inv - T_inv_ref)
    return P_ref * (T_inv_ref / T_inv) ** 2 \
        * torch.exp(22.47 * (T0 / T_inv_ref - T0 / T_inv))


def adapt_precip_roe(md, Hs1, T2m1, wLR, wDU, P1, Hs2, T2m2):
    """Roe & Lindzen ratio downscaling (climate_model_utilities.f90:
    178-235); the PD-observed winds serve both states, as in the
    reference."""
    dHs_dx1 = (md.M_ddx_a_a @ Hs1)[:, None]
    dHs_dy1 = (md.M_ddy_a_a @ Hs1)[:, None]
    dHs_dx2 = (md.M_ddx_a_a @ Hs2)[:, None]
    dHs_dy2 = (md.M_ddy_a_a @ Hs2)[:, None]
    P_RL1 = precipitation_model_roe(T2m1, dHs_dx1, dHs_dy1, wLR, wDU)
    P_RL2 = precipitation_model_roe(T2m2, dHs_dx2, dHs_dy2, wLR, wDU)
    ratio = torch.clamp(P_RL2 / floor_at(P_RL1, TINY), 0.01, 2.0)
    return P1 * ratio


class MatrixClimate:
    """run(time, state) of choice_climate_model 'matrix'; `calls` counts
    the calls (each advances the carried albedo state by a year)."""

    def __init__(self, C, md, region_name, mesh):
        if mesh is None:
            raise ValueError("matrix climate needs the host mesh")
        from ..core.ice.masks import calc_mask_noice
        from ..io.input_files import read_series_from_file
        from .insolation import InsolationForcing

        kw = dict(dtype=md.A.dtype, device=md.device)
        self.C, self.md, self.region = C, md, region_name
        self.p_itm = imau_itm_params(C, region_name)
        self.mask_noice = calc_mask_noice(
            md, getattr(C, "choice_mask_noice", "none"))

        self.PD_obs = _read_snapshot_with_winds(
            mesh, C.climate_matrix_filename_PD_obs_climate, kw)
        self.GCM_PI = _read_snapshot_with_winds(
            mesh, C.climate_matrix_filename_climate_snapshot_PI, kw)
        self.warm = _read_snapshot_with_winds(
            mesh, C.climate_matrix_filename_climate_snapshot_warm, kw)
        self.cold = _read_snapshot_with_winds(
            mesh, C.climate_matrix_filename_climate_snapshot_cold, kw)

        # GCM bias against present-day observations (:519-557)
        lam_c = C.climate_matrix_constant_lapserate
        bias_T = (self.GCM_PI["T2m"] + self.GCM_PI["Hs"][:, None] * lam_c) \
            - (self.PD_obs["T2m"] + self.PD_obs["Hs"][:, None] * lam_c)
        bias_P = self.GCM_PI["Precip"] / floor_at(self.PD_obs["Precip"],
                                                  TINY)
        if C.climate_matrix_biascorrect_warm:
            self.warm["T2m"] = self.warm["T2m"] - bias_T
            self.warm["Precip"] = self.warm["Precip"] / bias_P
        if C.climate_matrix_biascorrect_cold:
            self.cold["T2m"] = self.cold["T2m"] - bias_T
            self.cold["Precip"] = self.cold["Precip"] / bias_P

        # lapse rates (:477-488)
        self.warm["lambda"] = torch.full((md.nV,), lam_c, **kw)
        if region_name in ("NAM", "EAS"):
            self.cold["lambda"] = _spatially_variable_lapserate(
                C, md, self.GCM_PI, self.cold)
        else:
            self.cold["lambda"] = torch.full((md.nV,), lam_c, **kw)

        # insolation, and the snapshots' reference absorbed insolation
        self.insol = InsolationForcing(C, mesh, **kw)
        self.warm["I_abs"], _ = _calc_I_abs(
            C, md, region_name, self.warm, self.insol,
            C.climate_matrix_warm_orbit_time, self.mask_noice)
        self.cold["I_abs"], _ = _calc_I_abs(
            C, md, region_name, self.cold, self.insol,
            C.climate_matrix_cold_orbit_time, self.mask_noice)

        if C.choice_matrix_forcing != "CO2_direct":
            raise ValueError("matrix climate requires choice_matrix_forcing"
                             " = 'CO2_direct' (the d18O inversion is not "
                             "in the reference either, climate_matrix.f90:"
                             "144)")
        tt, vv = read_series_from_file(C.filename_CO2_record, "CO2")
        self._co2_t = torch.as_tensor(tt, **kw)
        self._co2_v = torch.as_tensor(vv, **kw)

        # the carried IMAU-ITM albedo state of the modelled I_abs
        self._firn = torch.full((md.nV, 12),
                                C.SMB_IMAUITM_initial_firn_thickness, **kw)
        self._melt_yr = torch.zeros(md.nV, **kw)
        self._albedo = torch.full((md.nV, 12), self.p_itm["albedo_snow"],
                                  **kw)
        self._T2m = self.PD_obs["T2m"]
        self._Precip = self.PD_obs["Precip"]
        self.w_CO2vsice = getattr(C, f"climate_matrix_CO2vsice_{region_name}")
        self.calls = 0

    def carry_state_from(self, old, remap):
        """Take the carried albedo and firn state and the last applied
        climate over from the runner of the previous mesh (`remap` maps
        [nV_old(, k)] to [nV_new(, k)]; the reference remaps the climate
        model's state on a mesh update, UFEMISM_main_model.f90:
        1311-1323)."""
        self._firn = remap(old._firn)
        self._melt_yr = remap(old._melt_yr)
        self._albedo = remap(old._albedo)
        self._T2m = remap(old._T2m)
        self._Precip = remap(old._Precip)
        self.calls = old.calls

    def __call__(self, time, s=None):
        from ..core.ice.masks import determine_masks
        C, md = self.C, self.md
        warm, cold = self.warm, self.cold
        Q_TOA = self.insol.at_time(time)
        CO2 = interp(time, self._co2_t, self._co2_v)
        self.calls += 1

        # advance the carried albedo model a year on the last applied
        # climate (in place of the SMB model's Albedo, see the module doc)
        masks = determine_masks(md, s.Hi, s.Hb, s.SL)
        _, aux = imau_itm_step(self.p_itm, self._T2m, self._Precip, Q_TOA,
                               masks, self.mask_noice, self._firn,
                               self._melt_yr)
        self._firn = aux["FirnDepth"]
        self._melt_yr = aux["MeltPreviousYear"]
        self._albedo = aux["Albedo"]

        # temperature (run_climate_model_matrix_temperature, :100-203)
        dCO2 = C.climate_matrix_high_CO2_level - C.climate_matrix_low_CO2_level
        w_CO2 = torch.clamp((CO2 - C.climate_matrix_low_CO2_level) / dCO2,
                            -W_CUTOFF_T, 1.0 + W_CUTOFF_T)
        I_abs = (Q_TOA * (1.0 - self._albedo)).sum(dim=1)
        denom = warm["I_abs"] - cold["I_abs"]
        w_ins = torch.clamp((I_abs - cold["I_abs"])
                            / torch.where(denom.abs() > 1e-10, denom, 1.0),
                            -W_CUTOFF_T, 1.0 + W_CUTOFF_T)
        d_sum = warm["I_abs"].sum() - cold["I_abs"].sum()
        w_ins_av = torch.clamp((I_abs.sum() - cold["I_abs"].sum())
                               / torch.clamp(d_sum.abs(), min=1e-10)
                               * torch.sign(d_sum),
                               -W_CUTOFF_T, 1.0 + W_CUTOFF_T)
        w_ins_smooth = _smooth(md, w_ins)
        if self.region in ("NAM", "EAS"):
            w_ice = (w_ins + 3.0 * w_ins_smooth + 3.0 * w_ins_av) / 7.0
        else:
            w_ice = (w_ins_smooth + 6.0 * w_ins_av) / 7.0
        w_tot = self.w_CO2vsice * w_CO2 + (1.0 - self.w_CO2vsice) * w_ice

        Hs_GCM = w_tot * warm["Hs"] + (1 - w_tot) * cold["Hs"]
        lam_GCM = w_tot * warm["lambda"] + (1 - w_tot) * cold["lambda"]
        T_ref = w_tot[:, None] * warm["T2m"] \
            + (1 - w_tot)[:, None] * cold["T2m"]
        T2m = T_ref - lam_GCM[:, None] * (s.Hs - Hs_GCM)[:, None]

        # precipitation (run_climate_model_matrix_precipitation, :287):
        # the total-ice-volume weight (Berends 2018 Eq. 12's second term),
        # guarded against identical warm and cold orographies (0/0)
        dHs_sum = cold["Hs"].sum() - warm["Hs"].sum()
        apart = dHs_sum.abs() > 1e-6
        w_tot_p = torch.where(
            apart,
            torch.clamp((s.Hs.sum() - warm["Hs"].sum())
                        / torch.where(apart, dHs_sum, 1.0),
                        -W_CUTOFF_P, 1.0 + W_CUTOFF_P),
            0.5)
        if self.region in ("NAM", "EAS"):
            PI_Hs = self.GCM_PI["Hs"]
            warm_ice = warm["Hs"] >= PI_Hs + 50.0
            cold_ice = cold["Hs"] >= PI_Hs + 50.0
            local = torch.clamp((s.Hs - PI_Hs)
                                / torch.where(cold_ice | warm_ice,
                                              cold["Hs"] - PI_Hs, 1.0)
                                * w_tot_p, -W_CUTOFF_P, 1.0 + W_CUTOFF_P)
            w_cold = torch.where(warm_ice | cold_ice, local,
                                 torch.clamp(w_tot_p, -W_CUTOFF_P,
                                             1.0 + W_CUTOFF_P))
            w_cold = _smooth(md, w_cold * w_tot_p)
        else:
            w_cold = w_tot_p.expand(md.nV).to(T2m.dtype)
        if C.climate_matrix_switch_glacial_index_precip:
            w_cold = (1.0 - torch.clamp(
                (CO2 - C.climate_matrix_low_CO2_level) / dCO2,
                -W_CUTOFF_P, 1.0 + W_CUTOFF_P)).expand(md.nV).to(T2m.dtype)
        w_warm = 1.0 - w_cold

        T_ref_p = w_warm[:, None] * warm["T2m"] + w_cold[:, None] * cold["T2m"]
        P_ref = torch.exp(
            w_warm[:, None] * torch.log(floor_at(warm["Precip"], TINY))
            + w_cold[:, None] * torch.log(floor_at(cold["Precip"], TINY)))
        Hs_ref_p = w_warm * warm["Hs"] + w_cold * cold["Hs"]

        if self.region in ("NAM", "EAS"):
            Precip = adapt_precip_roe(
                md, Hs_ref_p, T_ref_p, self.PD_obs["Wind_LR"],
                self.PD_obs["Wind_DU"], P_ref, s.Hs, T2m)
        else:
            Precip = adapt_precip_CC(s.Hs, Hs_ref_p, T_ref_p, P_ref,
                                     self.region,
                                     C.climate_matrix_constant_lapserate)

        self._T2m, self._Precip = T2m, Precip
        return {"T2m": T2m, "Precip": Precip, "Q_TOA": Q_TOA,
                "Wind_LR": self.PD_obs["Wind_LR"],
                "Wind_DU": self.PD_obs["Wind_DU"]}
