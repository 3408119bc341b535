"""Surface mass balance models.

Re-design of src/UFEMISM/surface_mass_balance/ (SMB_main.f90 dispatch,
SMB_idealised.f90, SMB_prescribed.f90, SMB_IMAU_ITM.f90,
SMB_snapshot_plus_anomalies.f90): uniform, idealised (uniform, EISMINT1
A-F, Halfar_static), prescribed (a field read from a file), IMAU-ITM (the
insolation-temperature-melt model with its firn state) and
snapshot_plus_anomalies. 'reconstructed' raises NotImplementedError: it
needs the Patagonia ROI polygon (ROADMAP A.15, the ROI polygons).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import pi, T0, L_fusion, ice_density, sec_per_year
from ..core.analytical import halfar_dHdt


def make_run_smb(C, md, region_name: str):
    """Returns run(time, state, climate) -> SMB [m ice/yr] on the a-grid."""
    choice = getattr(C, f"choice_SMB_model_{region_name}")
    nV = md.nV
    kw = dict(dtype=md.A.dtype, device=md.device)

    if choice == "uniform":
        val = torch.full((nV,), C.uniform_SMB, **kw)
        return lambda time, s=None, climate=None: val

    if choice == "idealised":
        sub = C.choice_SMB_model_idealised
        V = md._host_mesh.V
        if sub in ("uniform", ""):
            # '' appears in reference configs whose SMB is the uniform
            # accumulation rate
            val = torch.full((nV,), C.uniform_SMB, **kw)
            return lambda time, s=None, climate=None: val
        if sub.startswith("EISMINT1_"):
            d_km = torch.as_tensor(
                np.sqrt(V[:, 0] ** 2 + V[:, 1] ** 2) / 1e3, **kw)
            srate = 1e-2   # [m yr^-1 km^-1], Huybrechts et al. 1996
            exp = sub[-1]

            def run(time, s=None, climate=None):
                if exp in "ABC":
                    if exp == "A":
                        R_el = 450.0
                    elif exp == "B":
                        R_el = 450.0 + 100.0 * np.sin(2 * pi * time / 20e3)
                    else:
                        R_el = 450.0 + 100.0 * np.sin(2 * pi * time / 40e3)
                    return torch.clamp(srate * (R_el - d_km), max=0.5)
                if exp == "D":
                    return torch.full((nV,), 0.3, **kw)
                period = 20e3 if exp == "E" else 40e3
                return torch.full((nV,), 1.0, **kw) * (
                    0.3 + 0.2 * np.sin(2 * pi * time / period))
            return run
        if sub == "Halfar_static":
            # the SMB that cancels the Halfar thinning rate at t = 0, so
            # the dome stays as it is (SMB_idealised.f90:273)
            smb = -halfar_dHdt(C.uniform_Glens_flow_factor,
                               C.Glens_flow_law_exponent,
                               C.refgeo_idealised_Halfar_H0,
                               C.refgeo_idealised_Halfar_R0,
                               V[:, 0], V[:, 1], 0.0)
            val = torch.as_tensor(np.asarray(smb), **kw)
            return lambda time, s=None, climate=None: val
        raise ValueError(f"unknown choice_SMB_model_idealised '{sub}'")

    if choice == "prescribed":
        # a time-constant SMB read from a file (SMB_prescribed.f90)
        mesh = getattr(md, "_host_mesh", None)
        fname = getattr(C, f"filename_SMB_prescribed_{region_name}", "")
        if mesh is None or not fname:
            raise ValueError("prescribed SMB needs filename_SMB_prescribed_"
                             f"{region_name} and the host mesh on md")
        from ..io.input_files import read_field_from_file_2D
        val = torch.as_tensor(read_field_from_file_2D(fname, "SMB", mesh),
                              **kw)
        return lambda time, s=None, climate=None: val

    if choice == "IMAU-ITM":
        return ImauItmSMB(C, md, region_name)

    if choice == "snapshot_plus_anomalies":
        return _make_run_snapshot_plus_anomalies(C, md)

    if choice == "reconstructed":
        raise NotImplementedError(
            "choice_SMB_model 'reconstructed' is not ported yet: it needs "
            "the Patagonia ROI polygon of mesh/roi_polygons.py (ROADMAP "
            "A.15, the ROI polygons)")

    raise NotImplementedError(f"choice_SMB_model '{choice}' not implemented")


def _make_run_snapshot_plus_anomalies(C, md):
    """A baseline SMB snapshot plus an SMB anomaly field interpolated in
    time (SMB_snapshot_plus_anomalies.f90:275-400; ISMIP6 aSMB forcing),
    the anomaly series held on the device."""
    mesh = getattr(md, "_host_mesh", None)
    if mesh is None:
        raise ValueError("SMB snapshot_plus_anomalies needs the host mesh")
    from ..io.input_files import (read_field_from_file_2D,
                                  load_timeframe_series)
    from ..utils.interp import frame_weights
    kw = dict(dtype=md.A.dtype, device=md.device)
    smb0 = torch.as_tensor(read_field_from_file_2D(
        C.SMB_snp_p_anml_filename_snapshot_SMB, "SMB", mesh), **kw)
    tt, dS = load_timeframe_series(C.SMB_snp_p_anml_filename_anomalies,
                                   "SMB_anomaly", mesh, reader="2D")
    tt = torch.as_tensor(tt, **kw)
    dS = torch.as_tensor(dS, **kw)

    def run(time, s=None, climate=None):
        i, w = frame_weights(time, tt)
        return smb0 + (1 - w) * dS[i] + w * dS[i + 1]
    return run


def imau_itm_params(C, region_name):
    return dict(
        c_abl_const=getattr(C, f"SMB_IMAUITM_C_abl_constant_{region_name}"),
        c_abl_Ts=getattr(C, f"SMB_IMAUITM_C_abl_Ts_{region_name}"),
        c_abl_Q=getattr(C, f"SMB_IMAUITM_C_abl_Q_{region_name}"),
        c_refr=getattr(C, f"SMB_IMAUITM_C_refr_{region_name}"),
        albedo_ice=C.SMB_IMAUITM_albedo_ice,
        albedo_snow=C.SMB_IMAUITM_albedo_snow,
        albedo_soil=C.SMB_IMAUITM_albedo_soil,
        albedo_water=C.SMB_IMAUITM_albedo_water,
    )


def imau_itm_step(p, T2m, Precip, Q_TOA, masks, mask_noice,
                  firn_prev, melt_prev_yr):
    """One year of the IMAU insolation-temperature-melt SMB model
    (SMB_IMAU_ITM.f90 run_SMB_model_IMAU_ITM:420-519).

    Inputs: the monthly climate [nV, 12], the ice masks and the carried
    state (FirnDepth [nV, 12] in m snow, MeltPreviousYear [nV] in m w.e.).
    Returns (SMB [m ice/yr], a dict with the new state). The months run in
    order: month m reads month m-1's firn depth, January last year's
    December."""
    water_sfc = (masks["mask_icefree_ocean"]
                 & ~masks["mask_floating_ice"]) | mask_noice
    ice_sfc = masks["mask_grounded_ice"] | masks["mask_floating_ice"]
    albedo_surf = torch.full((T2m.shape[0],), p["albedo_soil"],
                             dtype=T2m.dtype, device=T2m.device)
    albedo_surf = torch.where(water_sfc, p["albedo_water"], albedo_surf)
    albedo_surf = torch.where(ice_sfc, p["albedo_ice"], albedo_surf)

    # snow fraction (ANICE 'realistic' fractions, :469)
    snowfrac = torch.clamp(0.5 * (1.0 - torch.arctan((T2m - T0) / 3.5)
                                  / 1.25664), 0.0, 1.0)
    snowfall = Precip * snowfrac
    rainfall = Precip - snowfall

    a_snow = p["albedo_snow"]
    firn_m = firn_prev[:, -1]
    albedo, melt, firn = [], [], []
    for m in range(12):
        alb = torch.clamp(torch.maximum(
            albedo_surf,
            a_snow - (a_snow - albedo_surf) * torch.exp(-15.0 * firn_m)
            - 0.015 * melt_prev_yr), max=a_snow)
        alb = torch.where(water_sfc, p["albedo_water"], alb)
        # Bintanja et al. (2002) ablation [m w.e./month]
        mlt = torch.clamp((p["c_abl_Ts"] * (T2m[:, m] - T0)
                           + p["c_abl_Q"] * (1.0 - alb) * Q_TOA[:, m]
                           - p["c_abl_const"])
                          * sec_per_year / (L_fusion * 1000.0 * 12.0),
                          min=0.0)
        firn_m = torch.clamp(firn_m + snowfall[:, m] - mlt, 0.0, 10.0)
        albedo.append(alb)
        melt.append(mlt)
        firn.append(firn_m)
    albedo, melt, firn = (torch.stack(a, dim=1)
                          for a in (albedo, melt, firn))

    # yearly refreezing (Janssens & Huybrechts 2000), spread over months
    sup_imp_wat = p["c_refr"] * torch.clamp(T0 - T2m.mean(dim=1), min=0.0)
    liquid_water = rainfall.sum(dim=1) + melt.sum(dim=1)
    refreezing_year = torch.minimum(
        torch.minimum(torch.minimum(sup_imp_wat, liquid_water),
                      Precip.sum(dim=1)),
        0.25 * firn.mean(dim=1))
    # no refreezing where there is no ice at all (the reference's line at
    # :500 uses .or., which zeroes it everywhere; this is its intent, as
    # the JAX package reads it)
    refreezing_year = torch.where(ice_sfc, refreezing_year, 0.0)

    smb_monthly = snowfall + refreezing_year[:, None] / 12.0 - melt
    SMB = smb_monthly.sum(dim=1) * 1000.0 / ice_density   # m w.e. -> m ice
    return SMB, dict(FirnDepth=firn, MeltPreviousYear=melt.sum(dim=1),
                     Albedo=albedo,
                     SMB_monthly=smb_monthly * 1000.0 / ice_density)


class ImauItmSMB:
    """The stateful IMAU-ITM runner: FirnDepth, MeltPreviousYear and
    Albedo carried from call to call (the reference's
    type_SMB_model_IMAU_ITM). Every call is one model year of the scheme,
    so the state advances once per call; `calls` counts them."""

    def __init__(self, C, md, region_name):
        from ..core.ice.masks import calc_mask_noice
        self.p = imau_itm_params(C, region_name)
        self.md = md
        self.mask_noice = calc_mask_noice(
            md, getattr(C, f"choice_mask_noice_{region_name}",
                        getattr(C, "choice_mask_noice", "none")))
        kw = dict(dtype=md.A.dtype, device=md.device)
        nV = md.nV
        init_choice = getattr(C, f"choice_SMB_IMAUITM_init_firn_{region_name}")
        if init_choice == "uniform":
            self.FirnDepth = torch.full(
                (nV, 12), C.SMB_IMAUITM_initial_firn_thickness, **kw)
        elif init_choice == "read_from_file":
            from ..io.input_files import read_field_from_file_2D_monthly
            # the schema names no such file (neither does the JAX
            # package's): the caller's configuration object must carry it
            fname = getattr(C, "filename_SMB_IMAUITM_init_firn_"
                            f"{region_name}", "")
            if not fname:
                raise ValueError("choice_SMB_IMAUITM_init_firn "
                                 "'read_from_file' needs "
                                 f"filename_SMB_IMAUITM_init_firn_"
                                 f"{region_name}")
            self.FirnDepth = torch.as_tensor(read_field_from_file_2D_monthly(
                fname, "FirnDepth", md._host_mesh), **kw)
        else:
            raise ValueError("unknown choice_SMB_IMAUITM_init_firn "
                             f"'{init_choice}'")
        self.MeltPreviousYear = torch.zeros(nV, **kw)
        self.Albedo = torch.full((nV, 12), self.p["albedo_snow"], **kw)
        self.calls = 0

    def carry_state_from(self, old, remap):
        """Take the firn, melt and albedo state over from the runner of
        the previous mesh (remap_SMB_model_IMAU_ITM; `remap` maps
        [nV_old(, k)] to [nV_new(, k)])."""
        self.FirnDepth = remap(old.FirnDepth)
        self.MeltPreviousYear = remap(old.MeltPreviousYear)
        self.Albedo = remap(old.Albedo)
        self.calls = old.calls

    def __call__(self, time, s=None, climate=None):
        from ..core.ice.masks import determine_masks
        if climate is None:
            raise ValueError("IMAU-ITM requires a climate model")
        Q_TOA = climate.get("Q_TOA")
        if Q_TOA is None:
            raise ValueError("IMAU-ITM requires insolation (Q_TOA) from "
                             "the climate model (set "
                             "choice_insolation_forcing)")
        masks = determine_masks(self.md, s.Hi, s.Hb, s.SL)
        SMB, aux = imau_itm_step(self.p, climate["T2m"], climate["Precip"],
                                 Q_TOA, masks, self.mask_noice,
                                 self.FirnDepth, self.MeltPreviousYear)
        self.FirnDepth = aux["FirnDepth"]
        self.MeltPreviousYear = aux["MeltPreviousYear"]
        self.Albedo = aux["Albedo"]
        self.calls += 1
        return SMB
