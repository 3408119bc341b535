"""Climate models: monthly T2m, precipitation (and insolation) on the mesh.

Re-design of src/UFEMISM/climate/ (climate_main.f90:191-206 dispatch):
none, idealised (EISMINT1 A-F, climate_idealised.f90:103-185), realistic
(a snapshot, climate_realistic.f90), snapshot_plus_uniform_deltaT,
snapshot_plus_transient_deltaT (with the lapse-rate and inversion-layer
downscaling and the Clausius-Clapeyron precipitation correction,
climate_model_utilities.f90:445-530), snapshot_plus_anomalies and the
matrix method (models/climate_matrix.py).

Snapshot fields, anomaly series and deltaT series are read at set-up and
held on the device; run(time, state) interpolates them in time there (the
deltaT and anomaly series in the run's dtype, as the JAX package does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import pi, T0
from ..utils.interp import frame_weights, interp


def _icefree_ocean_mask(s):
    """Open ocean (the full mask logic is core/ice/masks.py; the climate
    needs only this)."""
    return (s.Hi <= 0.1) & (s.Hb + s.Hi * (910.0 / 1028.0) < s.SL)


def _downscale(T2m_snap, Precip_snap, Hs_snap, Hs_model, lapse_T,
               deltaT, icefree_ocean):
    """Lapse-rate and inversion-layer Clausius-Clapeyron downscaling
    (climate_model_utilities.f90 apply_geometry_downscaling_corrections;
    Albrecht et al. 2020 Eq. 11, Jouzel & Merlivat 1984)."""
    dT_lapse = (Hs_model - Hs_snap) * (-abs(lapse_T))
    T2m = T2m_snap + deltaT + dT_lapse[:, None]
    T_inv_ref = 88.9 + 0.67 * T2m
    T_inv = 88.9 + 0.67 * (T2m - lapse_T * (Hs_model - Hs_snap)[:, None])
    Precip = Precip_snap * (T_inv_ref / T_inv) ** 2 \
        * torch.exp(22.47 * (T0 / T_inv_ref - T0 / T_inv))
    keep = icefree_ocean[:, None]
    return (torch.where(keep, T2m_snap + deltaT, T2m),
            torch.where(keep, Precip_snap, Precip))


def _load_snapshot(mesh, fname, kw):
    """(Hs, T2m, Precip) device tensors of a climate-snapshot file
    (climate_model_utilities.f90 read_climate_snapshot)."""
    from ..io.input_files import (read_field_from_file_2D,
                                  read_field_from_file_2D_monthly)
    Hs = read_field_from_file_2D(fname, "Hs", mesh)
    T2m = read_field_from_file_2D_monthly(fname, "T2m", mesh)
    Precip = read_field_from_file_2D_monthly(fname, "Precip", mesh)
    return (torch.as_tensor(Hs, **kw), torch.as_tensor(T2m, **kw),
            torch.as_tensor(Precip, **kw))


def make_run_climate(C, md, region_name: str, mesh=None):
    """Returns run(time, state) -> dict(T2m [nV,12], Precip [nV,12], and
    Q_TOA [nV,12] where an insolation source is configured)."""
    choice = getattr(C, f"choice_climate_model_{region_name}")
    kw = dict(dtype=md.A.dtype, device=md.device)

    if choice == "none":
        T2m = torch.full((md.nV, 12), T0 - 20.0, **kw)
        Pr = torch.zeros((md.nV, 12), **kw)
        return lambda time, s=None: {"T2m": T2m, "Precip": Pr}

    if choice == "idealised":
        return _make_run_idealised(C, md)

    if choice in ("realistic", "snapshot_plus_uniform_deltaT",
                  "snapshot_plus_transient_deltaT"):
        return _make_run_snapshot(C, md, region_name, mesh, choice)

    if choice == "snapshot_plus_anomalies":
        return _make_run_snapshot_plus_anomalies(C, md, region_name, mesh)

    if choice == "matrix":
        from .climate_matrix import MatrixClimate
        return MatrixClimate(C, md, region_name, mesh)

    raise ValueError(f"unknown choice_climate_model '{choice}'")


def _make_run_idealised(C, md):
    """EISMINT1 experiments A-F (Huybrechts et al. 1996;
    climate_idealised.f90:103-185)."""
    nV = md.nV
    kw = dict(dtype=md.A.dtype, device=md.device)
    sub = C.choice_climate_model_idealised
    if not sub.startswith("EISMINT1_"):
        raise ValueError(f"unknown choice_climate_model_idealised '{sub}'")
    exp = sub[-1]
    V = md._host_mesh.V
    # distance from the divide in the Chebyshev metric [km] (fixed margin)
    d_km = torch.as_tensor(
        np.maximum(np.abs(V[:, 0]), np.abs(V[:, 1])) / 1e3, **kw)
    cycle = {"B": 20e3, "E": 20e3, "C": 40e3, "F": 40e3}.get(exp)

    def run(time, s=None):
        if exp in "ABC":
            # moving margin (Eq. 11): T = 270 - 0.01 Hs
            Hs = s.Hs if s is not None else torch.zeros(nV, **kw)
            Ts = 270.0 - 0.01 * Hs
        else:
            # fixed margin (Eq. 9)
            Ts = 239.0 + 8.0e-8 * d_km ** 3
        if cycle is not None and time > 0.0:
            Ts = Ts + 10.0 * float(np.sin(2 * pi * time / cycle))
        return {"T2m": Ts[:, None].expand(nV, 12),
                "Precip": torch.zeros((nV, 12), **kw)}
    return run


def _make_run_snapshot(C, md, region_name, mesh, choice):
    """Snapshot-based realistic climates (climate_realistic.f90,
    climate_snapshot_plus_{uniform,transient}_deltaT.f90)."""
    if mesh is None:
        raise ValueError(f"climate '{choice}' needs the host mesh for "
                         "file input")
    kw = dict(dtype=md.A.dtype, device=md.device)

    if choice == "realistic":
        if C.choice_climate_model_realistic not in ("snapshot", ""):
            raise ValueError("unknown choice_climate_model_realistic "
                             f"'{C.choice_climate_model_realistic}'")
        fname = getattr(C, f"filename_climate_snapshot_{region_name}")
    else:
        key = "unif_dT" if choice == "snapshot_plus_uniform_deltaT" \
            else "trans_dT"
        fname = getattr(C, f"filename_climate_snapshot_{key}_{region_name}") \
            or getattr(C, f"filename_climate_snapshot_{region_name}")

    Hs_snap, T2m_snap, Precip_snap = _load_snapshot(mesh, fname, kw)

    do_lapse = getattr(C, f"do_lapse_rate_corrections_{region_name}")
    lapse_T = getattr(C, f"lapse_rate_temp_{region_name}")
    cc_corr = getattr(C, f"precip_CC_correction_{region_name}")

    if choice == "snapshot_plus_uniform_deltaT":
        dT_unif = torch.as_tensor(
            getattr(C, f"uniform_deltaT_{region_name}"), **kw)
        deltaT_fn = lambda t: dT_unif
    elif choice == "snapshot_plus_transient_deltaT":
        from ..io.input_files import read_series_from_file
        tt, dd = read_series_from_file(
            getattr(C, f"filename_atmosphere_dT_{region_name}"),
            "dT_atmosphere")
        tt, dd = torch.as_tensor(tt, **kw), torch.as_tensor(dd, **kw)
        deltaT_fn = lambda t: interp(t, tt, dd)
    else:
        zero = torch.zeros((), **kw)
        deltaT_fn = lambda t: zero

    # insolation, which IMAU-ITM needs
    insol = None
    if getattr(C, f"choice_SMB_model_{region_name}") == "IMAU-ITM":
        if C.choice_insolation_forcing == "none":
            raise ValueError("IMAU-ITM requires choice_insolation_forcing "
                             "!= 'none'")
        from .insolation import InsolationForcing
        insol = InsolationForcing(C, mesh, **kw)

    apply_cc = choice == "snapshot_plus_transient_deltaT"

    def run(time, s=None):
        deltaT = deltaT_fn(time)
        if do_lapse and s is not None:
            T2m, Precip = _downscale(T2m_snap, Precip_snap, Hs_snap, s.Hs,
                                     lapse_T, deltaT,
                                     _icefree_ocean_mask(s))
        else:
            T2m = T2m_snap + deltaT
            Precip = Precip_snap
        if apply_cc:
            # Precip(dT) = Precip cc^dT (apply_precipitation_CC_correction)
            Precip = Precip * cc_corr ** deltaT
        out = {"T2m": T2m, "Precip": Precip}
        if insol is not None:
            out["Q_TOA"] = insol.at_time(time)
        return out
    return run


def _make_run_snapshot_plus_anomalies(C, md, region_name, mesh):
    """A baseline snapshot plus monthly T2m/Precip anomaly fields
    interpolated in time (climate_snapshot_plus_anomalies.f90:63-121;
    ISMIP6-style aST/aPr forcing), the anomaly series held on the
    device."""
    if mesh is None:
        raise ValueError("climate snapshot_plus_anomalies needs the host "
                         "mesh")
    from ..io.input_files import load_timeframe_series
    kw = dict(dtype=md.A.dtype, device=md.device)
    Hs_snap, T2m_snap, Precip_snap = _load_snapshot(
        mesh, getattr(C, "climate_snp_p_anml_filename_snapshot_"
                      f"{region_name}"), kw)
    fname = getattr(C, f"climate_snp_p_anml_filename_anomalies_{region_name}")
    tt, dT = load_timeframe_series(fname, "T2m_anomaly", mesh,
                                   reader="2D_monthly")
    _, dP = load_timeframe_series(fname, "Precip_anomaly", mesh,
                                  reader="2D_monthly")
    tt = torch.as_tensor(tt, **kw)
    dT = torch.as_tensor(dT, **kw)
    dP = torch.as_tensor(dP, **kw)

    def run(time, s=None):
        i, w = frame_weights(time, tt)
        T2m = T2m_snap + (1 - w) * dT[i] + w * dT[i + 1]
        Precip = torch.clamp(Precip_snap + (1 - w) * dP[i] + w * dP[i + 1],
                             min=0.0)
        return {"T2m": T2m, "Precip": Precip}
    return run
