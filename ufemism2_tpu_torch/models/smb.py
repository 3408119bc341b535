"""Surface mass balance models.

Re-design of src/UFEMISM/surface_mass_balance/ (SMB_main.f90 dispatch).
Ported so far: 'uniform'. The idealised, prescribed, reconstructed and
IMAU-ITM choices raise NotImplementedError.
"""

from __future__ import annotations

import torch


def make_run_smb(C, md, region_name: str):
    """Returns run(time, state) -> SMB [m ice/yr] on the a-grid."""
    choice = getattr(C, f"choice_SMB_model_{region_name}")
    if choice == "uniform":
        val = torch.full((md.nV,), C.uniform_SMB, dtype=md.A.dtype,
                         device=md.device)
        return lambda time, s=None, climate=None: val
    raise NotImplementedError(
        f"choice_SMB_model '{choice}' is not ported yet (ported: uniform)")
