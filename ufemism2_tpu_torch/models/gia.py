"""Glacial isostatic adjustment: none or ELRA (an elastic lithosphere on a
relaxing asthenosphere).

Re-design of src/UFEMISM/glacial_isostatic_adjustment/: the reference
convolves the load with the Kelvin-function Green's function on its square
GIA grid; here, as in the JAX package, the flexural response is solved in
spectral space by a real FFT on a regular grid covering the domain,
sampled to and from the mesh by nearest neighbours (the index tables built
on the host with scipy's cKDTree). The FFT runs in f32 in the f32 mode and
in f64 otherwise (on the card it is cuFFT).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.constants import ice_density, seawater_density, grav


def make_run_gia(C, md, region_name: str, mesh):
    """run(time, state, dt) -> (dHb_dt, dHb) [nV]."""
    choice = C.choice_GIA_model
    kw = dict(dtype=md.A.dtype, device=md.device)

    if choice == "none":
        zero = torch.zeros(md.nV, **kw)
        return lambda time, s, dt: (zero, zero)

    if choice != "ELRA":
        raise NotImplementedError(
            f"choice_GIA_model '{choice}' not implemented")

    from scipy.spatial import cKDTree
    from ..core.ice.geometry import thickness_above_flotation

    # the regular grid covering the domain, and the nearest-neighbour
    # tables mesh -> grid [nx, ny] and grid -> mesh [nV]
    dx = C.dx_GIA
    x = np.arange(mesh.xmin, mesh.xmax + dx / 2, dx)
    y = np.arange(mesh.ymin, mesh.ymax + dx / 2, dx)
    nx, ny = len(x), len(y)
    X, Y = np.meshgrid(x, y, indexing="ij")
    G = np.stack([X.ravel(), Y.ravel()], 1)
    _, g2m = cKDTree(mesh.V).query(G)
    _, m2g = cKDTree(G).query(mesh.V)
    g2m = torch.as_tensor(g2m.reshape(nx, ny), device=md.device)
    m2g = torch.as_tensor(m2g, device=md.device)

    # the flexural response in spectral space:
    # w_eq(k) = -g load(k) / (rho_m g + D k^4)
    tau = C.ELRA_bedrock_relaxation_time
    kx = 2 * np.pi * np.fft.fftfreq(nx, dx)
    ky = 2 * np.pi * np.fft.rfftfreq(ny, dx)
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    k4 = (KX ** 2 + KY ** 2) ** 2
    fft_dtype = torch.float32 if C.tpu_precision == "f32" else torch.float64
    denom = torch.as_tensor(C.ELRA_mantle_density * grav
                            + C.ELRA_lithosphere_flex_rigidity * k4,
                            dtype=fft_dtype, device=md.device)

    def surface_load(Hi, Hb, SL, TAF):
        return torch.where(TAF > 0, ice_density * Hi,
                           torch.where(Hb < SL, -seawater_density * (SL - Hb),
                                       0.0))

    # the load of the GIA-equilibrium geometry (GIA_ELRA.f90
    # initialise_ELRA_reference_load): the bed deforms under the load's
    # anomaly against it only
    Hi_eq, Hb_eq, SL_eq = (torch.as_tensor(np.asarray(a), **kw)
                           for a in _refgeo_GIAeq(C, region_name, mesh))
    load_ref = surface_load(Hi_eq, Hb_eq, SL_eq,
                            thickness_above_flotation(Hi_eq, Hb_eq, SL_eq))

    def run(time, s, dt):
        load_m = surface_load(s.Hi, s.Hb + s.dHb, s.SL, s.TAF)
        load = (load_m - load_ref)[g2m].to(fft_dtype)
        w_eq_hat = -grav * torch.fft.rfft2(load) / denom
        w_eq = torch.fft.irfft2(w_eq_hat, s=(nx, ny))
        dHb_eq = w_eq.reshape(-1)[m2g].to(s.dHb.dtype)
        # relaxation towards the equilibrium deflection
        dHb_dt = (dHb_eq - s.dHb) / tau
        return dHb_dt, s.dHb + dHb_dt * dt
    return run


def _refgeo_GIAeq(C, region_name, mesh):
    """(Hi, Hb, SL) of the GIA-equilibrium reference geometry on the
    mesh's vertices: idealised, read from its file, or, where neither
    resolves, the initial geometry (as the JAX package does for idealised
    set-ups)."""
    from ..core.idealised_geometries import calc_idealised_geometry
    from ..io.input_files import read_geometry_onto_mesh
    choice = getattr(C, f"choice_refgeo_GIAeq_{region_name}",
                     "read_from_file")
    if choice == "idealised":
        sub = C.choice_refgeo_GIAeq_idealised \
            or C.choice_refgeo_init_idealised
        Hi, Hb, _, SL = calc_idealised_geometry(
            mesh.V[:, 0], mesh.V[:, 1], sub, C)
        return np.where(Hi < C.refgeo_Hi_min, 0.0, Hi), Hb, SL
    fname = getattr(C, f"filename_refgeo_GIAeq_{region_name}", "")
    if fname and os.path.exists(fname):
        return read_geometry_onto_mesh(C, region_name, mesh, which="GIAeq")
    if getattr(C, f"choice_refgeo_init_{region_name}") == "idealised":
        Hi, Hb, _, SL = calc_idealised_geometry(
            mesh.V[:, 0], mesh.V[:, 1], C.choice_refgeo_init_idealised, C)
        return np.where(Hi < C.refgeo_Hi_min, 0.0, Hi), Hb, SL
    return read_geometry_onto_mesh(C, region_name, mesh, which="init")
