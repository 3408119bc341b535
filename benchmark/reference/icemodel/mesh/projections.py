"""Oblique stereographic projections (lon/lat <-> regional x/y).

Re-design of src/UPSY/basic/math_utilities/projections.f90 (Reerink et
al. 2010 Oblimap equations), vectorised over point arrays. Used to give
meshes and grids their lon/lat secondary data (mesh_secondary.f90) and to
project lon/lat-gridded input data into the regional coordinate system.

Projection parameters per region come from the config (lambda_M_<R>,
phi_M_<R>, beta_stereo_<R>).
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import earth_radius


def oblique_sg_projection(lon, lat, lambda_M_deg, phi_M_deg, beta_deg):
    """Project lon/lat [deg] -> regional x/y [m] (Reerink 2010 Eq. 2.4-2.6).

    lon/lat may be scalars or arrays (broadcast together).
    """
    alpha = np.deg2rad(90.0 - beta_deg)
    phi_P = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lam_P = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lam_M = np.deg2rad(lambda_M_deg)
    phi_M = np.deg2rad(phi_M_deg)

    t = (1.0 + np.cos(alpha)) / (
        1.0 + np.cos(phi_P) * np.cos(phi_M) * np.cos(lam_P - lam_M)
        + np.sin(phi_P) * np.sin(phi_M))
    x = earth_radius * np.cos(phi_P) * np.sin(lam_P - lam_M) * t
    y = earth_radius * (np.sin(phi_P) * np.cos(phi_M)
                        - np.cos(phi_P) * np.sin(phi_M)
                        * np.cos(lam_P - lam_M)) * t
    return x, y


def inverse_oblique_sg_projection(x, y, lambda_M_deg, phi_M_deg, beta_deg):
    """Regional x/y [m] -> lon/lat [deg] (Reerink 2010 Eq. 2.7-2.16).

    Returns lon in [0, 360).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    alpha = np.deg2rad(90.0 - beta_deg)
    lam_M = np.deg2rad(lambda_M_deg)
    phi_M = np.deg2rad(phi_M_deg)
    R = earth_radius

    xp = R * np.cos(alpha) * np.cos(lam_M) * np.cos(phi_M) \
        - np.sin(lam_M) * x - np.cos(lam_M) * np.sin(phi_M) * y
    yp = R * np.cos(alpha) * np.sin(lam_M) * np.cos(phi_M) \
        + np.cos(lam_M) * x - np.sin(lam_M) * np.sin(phi_M) * y
    zp = R * np.cos(alpha) * np.sin(phi_M) + np.cos(phi_M) * y

    a = np.cos(lam_M) * np.cos(phi_M) * xp \
        + np.sin(lam_M) * np.cos(phi_M) * yp + np.sin(phi_M) * zp
    t = (2.0 * R**2 + 2.0 * R * a) / (R**2 + 2.0 * R * a
                                      + xp**2 + yp**2 + zp**2)
    x3 = R * np.cos(lam_M) * np.cos(phi_M) * (t - 1.0) + xp * t
    y3 = R * np.sin(lam_M) * np.cos(phi_M) * (t - 1.0) + yp * t
    z3 = R * np.sin(phi_M) * (t - 1.0) + zp * t

    lon = np.rad2deg(np.arctan2(y3, x3)) % 360.0
    lon = np.where((x3 == 0.0) & (y3 == 0.0), 0.0, lon)
    rxy = np.sqrt(x3**2 + y3**2)
    lat = np.where(rxy > 0.0, np.rad2deg(np.arctan2(z3, rxy)),
                   np.where(z3 > 0.0, 90.0, -90.0))
    return lon, lat


def region_projection_params(C, region_name: str):
    return (getattr(C, f"lambda_M_{region_name}"),
            getattr(C, f"phi_M_{region_name}"),
            getattr(C, f"beta_stereo_{region_name}"))
