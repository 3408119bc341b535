"""Surface mass balance models.

Re-design of src/UFEMISM/surface_mass_balance/ (SMB_main.f90 dispatch,
SMB_idealised.f90, SMB_prescribed.f90): uniform, idealised (uniform,
EISMINT1 A-F, Halfar_static) and prescribed (a field read from a file).
IMAU-ITM, snapshot_plus_anomalies and reconstructed raise
NotImplementedError: they wait for the climate chain (ROADMAP A.15).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import pi
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

    raise NotImplementedError(
        f"choice_SMB_model '{choice}' is not ported yet (it waits for the "
        "climate chain, ROADMAP A.15; ported: uniform, idealised, "
        "prescribed)")
