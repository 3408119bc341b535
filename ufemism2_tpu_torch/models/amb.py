"""Artificial mass balance (user-defined corrections).

Re-design of src/UFEMISM/artificial_mass_balance/: 'uniform' (default 0).
"""

from __future__ import annotations

import torch


def make_run_amb(C, md, region_name: str):
    choice = getattr(C, f"choice_AMB_model_{region_name}", "uniform")
    val = torch.zeros(md.nV, dtype=md.A.dtype, device=md.device)
    if choice == "uniform":
        return lambda time, s=None: val
    raise NotImplementedError(f"choice_AMB_model '{choice}' not implemented")
