"""Idealised reference-geometry generators (Halfar, MISMIP, ISMIP-HOM, ...).

Vectorised numpy re-derivation of
src/UFEMISM/reference_geometries/idealised_geometries.f90. Each generator
returns (Hi, Hb, Hs, SL) arrays over given (x, y) coordinate arrays.
"""

from __future__ import annotations

import numpy as np

from .analytical import halfar_H, bueler_dome
from .ice.geometry import ice_surface_elevation_np


def calc_idealised_geometry(x, y, choice: str, C):
    """Dispatch on choice_refgeo_*_idealised; x, y broadcastable arrays [m]."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    shp = np.broadcast_shapes(x.shape, y.shape)
    x, y = np.broadcast_to(x, shp).copy(), np.broadcast_to(y, shp).copy()

    if choice == "flatearth":
        Hi = np.zeros(shp)
        Hb = np.zeros(shp)
        SL = np.full(shp, -10000.0)
    elif choice == "slabonaslope":
        Hi = np.full(shp, C.refgeo_idealised_slabonaslope_Hi)
        Hb = C.refgeo_idealised_slabonaslope_dhdx * x
        SL = np.full(shp, -10000.0)
    elif choice == "Halfar":
        Hi = halfar_H(C.uniform_Glens_flow_factor, C.Glens_flow_law_exponent,
                      C.refgeo_idealised_Halfar_H0, C.refgeo_idealised_Halfar_R0,
                      x, y, 0.0)
        Hb = np.zeros(shp)
        SL = np.full(shp, -10000.0)
    elif choice == "Bueler":
        Hi, _ = bueler_dome(C.uniform_Glens_flow_factor,
                            C.Glens_flow_law_exponent,
                            C.refgeo_idealised_Bueler_H0,
                            C.refgeo_idealised_Bueler_R0,
                            C.refgeo_idealised_Bueler_lambda, x, y, 1e-9)
        Hb = np.zeros(shp)
        SL = np.full(shp, -10000.0)
    elif choice == "SSA_icestream":
        Hi = np.full(shp, C.refgeo_idealised_SSA_icestream_Hi)
        Hb = C.refgeo_idealised_SSA_icestream_dhdx * x
        SL = np.full(shp, -10000.0)
    elif choice == "MISMIP_mod":
        r = np.sqrt(x ** 2 + y ** 2)
        Hi = np.where(r > 900e3, 0.0, C.refgeo_idealised_MISMIP_mod_Hi_init)
        Hb = 150.0 - 400.0 * r / 750000.0
        SL = np.zeros(shp)
    elif choice == "ISMIP-HOM_A":
        L = C.refgeo_idealised_ISMIP_HOM_L
        Hs = 2000.0 - x * np.tan(np.deg2rad(0.5))
        Hb = Hs - 1000.0 + 500.0 * np.sin(x * 2 * np.pi / L) * np.sin(y * 2 * np.pi / L)
        return Hs - Hb, Hb, Hs, np.full(shp, -10000.0)
    elif choice == "ISMIP-HOM_B":
        L = C.refgeo_idealised_ISMIP_HOM_L
        Hs = 2000.0 - x * np.tan(np.deg2rad(0.5))
        Hb = Hs - 1000.0 + 500.0 * np.sin(x * 2 * np.pi / L)
        return Hs - Hb, Hb, Hs, np.full(shp, -10000.0)
    elif choice in ("ISMIP-HOM_C", "ISMIP-HOM_D"):
        Hs = 2000.0 - x * np.tan(np.deg2rad(0.1))
        Hb = Hs - 1000.0
        return Hs - Hb, Hb, Hs, np.full(shp, -10000.0)
    elif choice == "ISMIP-HOM_F":
        L = C.refgeo_idealised_ISMIP_HOM_L
        H0, a0, sigma = 1000.0, 100.0, 10000.0
        Hs = 5000.0 - x * np.tan(np.deg2rad(3.0))
        Hb = Hs - H0
        for ii in (-1.0, 0.0, 1.0):
            for jj in (-1.0, 0.0, 1.0):
                Hb = Hb + a0 * np.exp(-((x - ii * L) ** 2 + (y - jj * L) ** 2) / sigma ** 2)
        return Hs - Hb, Hb, Hs, np.full(shp, -10000.0)
    elif choice in ("MISMIP+", "MISMIPplus"):
        B0, B2, B4, B6 = -150.0, -728.8, 343.91, -50.57
        xbar, fc, dc, wc, zbdeep = 300000.0, 4000.0, 500.0, 24000.0, -720.0
        xt = x / xbar
        Bx = B0 + B2 * xt ** 2 + B4 * xt ** 4 + B6 * xt ** 6
        By = (dc / (1 + np.exp(-2 * (y - wc) / fc))
              + dc / (1 + np.exp(2 * (y + wc) / fc)))
        Hi = np.where(x > 640e3, 0.0, C.refgeo_idealised_MISMIPplus_Hi_init)
        Hb = np.maximum(Bx + By, zbdeep)
        SL = np.zeros(shp)
    elif choice == "calvmip_circular":
        R, Bc, Bl, rc = 800e3, 900.0, -2000.0, 0.0
        radius = np.sqrt(x ** 2 + y ** 2)
        Hi = np.zeros(shp)
        Hb = Bc - (Bc - Bl) * (radius - rc) ** 2 / (R - rc) ** 2
        SL = np.zeros(shp)
    elif choice == "calvmip_Thule":
        R, Bc, Bl, Ba, rc = 800e3, 900.0, -2000.0, 1100.0, 600e3
        radius = np.sqrt(x ** 2 + y ** 2)
        theta = np.arctan2(y, x)
        l = R - np.cos(2 * theta) * R / 2
        a = Bc - (Bc - Bl) * (radius - rc) ** 2 / (R - rc) ** 2
        B = Ba * np.cos(3 * np.pi * radius / l) + a
        Hi = np.zeros(shp)
        Hb = B
        SL = np.zeros(shp)
    else:
        raise ValueError(f"unknown choice_refgeo_idealised '{choice}'")

    Hs = ice_surface_elevation_np(Hi, Hb, SL)
    return Hi, Hb, Hs, SL


def generate_idealised_geometry_grid(C, region: str = "ANT", which: str = "init"):
    """Gridded idealised geometry over the region domain.

    Returns (x, y, Hi, Hb, SL) with x [nx], y [ny], fields [nx, ny].
    """
    choice = getattr(C, f"choice_refgeo_{which}_idealised")
    dx = getattr(C, f"dx_refgeo_{which}_idealised")
    xmin, xmax = getattr(C, f"xmin_{region}"), getattr(C, f"xmax_{region}")
    ymin, ymax = getattr(C, f"ymin_{region}"), getattr(C, f"ymax_{region}")
    x = np.arange(xmin, xmax + dx / 2, dx)
    y = np.arange(ymin, ymax + dx / 2, dx)
    X, Y = np.meshgrid(x, y, indexing="ij")
    Hi, Hb, Hs, SL = calc_idealised_geometry(X, Y, choice, C)
    # apply the minimum-thickness threshold used when loading ref geometries
    Hi = np.where(Hi < C.refgeo_Hi_min, 0.0, Hi)
    return x, y, Hi, Hb, SL
