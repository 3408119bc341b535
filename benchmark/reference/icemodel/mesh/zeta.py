"""Scaled vertical coordinate (zeta) grids and vertical integration helpers.

Re-derivation of src/UPSY/mesh/mesh_zeta.f90. zeta runs from 0 at the ice
surface to 1 at the base. The grid set-up is host-side numpy; the two
integration helpers work on numpy arrays and on torch tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch


def zeta_regular(nz: int):
    zeta = np.arange(nz, dtype=np.float64) / (nz - 1)
    return zeta, 0.5 * (zeta[:-1] + zeta[1:])


def zeta_irregular_log(nz: int, R: float):
    """Constant ratio between subsequent spacings; surface/base spacing ~ R."""
    if R == 1.0:
        return zeta_regular(nz)
    k = np.arange(1, nz + 1, dtype=np.float64)
    sigma = (k - 1) / (nz - 1)
    zeta = np.empty(nz)
    zeta[nz - k.astype(int)] = 1.0 - (R ** sigma - 1.0) / (R - 1.0)
    sigma_stag = sigma[:-1] + 0.5 / (nz - 1)
    zeta_stag = np.empty(nz - 1)
    zeta_stag[nz - 1 - k[:-1].astype(int)] = 1.0 - (R ** sigma_stag - 1.0) / (R - 1.0)
    return zeta, zeta_stag


_OLD_15 = np.array([0.00, 0.10, 0.20, 0.30, 0.40, 0.50, 0.60, 0.70, 0.80,
                    0.90, 0.925, 0.95, 0.975, 0.99, 1.00])


def zeta_old_15_layer(nz: int):
    assert nz == 15, "old_15_layer_zeta requires nz == 15"
    zeta = _OLD_15.copy()
    return zeta, 0.5 * (zeta[:-1] + zeta[1:])


def setup_zeta_grid(choice: str, nz: int, R: float = 10.0):
    if choice == "regular":
        return zeta_regular(nz)
    if choice == "irregular_log":
        return zeta_irregular_log(nz, R)
    if choice == "old_15_layer_zeta":
        return zeta_old_15_layer(nz)
    raise ValueError(f"unknown choice_zeta_grid '{choice}'")


def integrate_from_base_up(z, f, axis=-1):
    """Cumulative trapezoid integral from the last level (ice base) upward.

    integral[k] = int_{z[nz-1]}^{z[k]} f dz  (per reference
    integrate_from_zeta_is_one_to_zeta_is_zetap). z and f are both numpy
    arrays or both torch tensors and broadcast along `axis`.
    """
    if isinstance(f, np.ndarray):
        z = np.moveaxis(z, axis, -1)
        f = np.moveaxis(f, axis, -1)
        df = 0.5 * (f[..., 1:] + f[..., :-1]) * (z[..., 1:] - z[..., :-1])
        rev = np.cumsum(df[..., ::-1], axis=-1)[..., ::-1]
        out = np.concatenate([-rev, np.zeros_like(f[..., :1])], axis=-1)
        return np.moveaxis(out, -1, axis)
    z = torch.movedim(z, axis, -1)
    f = torch.movedim(f, axis, -1)
    df = 0.5 * (f[..., 1:] + f[..., :-1]) * (z[..., 1:] - z[..., :-1])
    rev = torch.flip(torch.cumsum(torch.flip(df, (-1,)), dim=-1), (-1,))
    out = torch.cat([-rev, torch.zeros_like(f[..., :1])], dim=-1)
    return torch.movedim(out, -1, axis)


def vertical_average(zeta, f, axis=-1):
    """Vertically averaged value of f over the zeta grid (trapezoid)."""
    if isinstance(f, np.ndarray):
        z = np.asarray(zeta)
        f_m = np.moveaxis(f, axis, -1)
    else:
        z = zeta
        f_m = torch.movedim(f, axis, -1)
    w = 0.5 * (f_m[..., 1:] + f_m[..., :-1]) * (z[1:] - z[:-1])
    return w.sum(-1)
