"""Climate models: monthly T2m and precipitation on the mesh.

Re-design of src/UFEMISM/climate/ (climate_main.f90:191-206 dispatch).
Ported so far: 'none' (T2m = T0 - 20 K in every month, no precipitation).
The idealised, snapshot and matrix choices raise NotImplementedError.
"""

from __future__ import annotations

import torch

from ..utils.constants import T0


def make_run_climate(C, md, region_name: str):
    """Returns run(time, state) -> dict(T2m [nV,12], Precip [nV,12])."""
    choice = getattr(C, f"choice_climate_model_{region_name}")
    if choice == "none":
        kw = dict(dtype=md.A.dtype, device=md.device)
        T2m = torch.full((md.nV, 12), T0 - 20.0, **kw)
        Pr = torch.zeros((md.nV, 12), **kw)
        return lambda time, s=None: {"T2m": T2m, "Precip": Pr}
    raise NotImplementedError(
        f"choice_climate_model '{choice}' is not ported yet (ported: none)")
