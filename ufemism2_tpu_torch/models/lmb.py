"""Lateral mass balance (calving-front) models.

Re-design of src/UFEMISM/lateral_mass_balance/ (LMB_main.f90). Ported so
far: 'uniform'; GlacialIndex raises NotImplementedError. LMB applies at
calving-front vertices.
"""

from __future__ import annotations

import torch


def make_run_lmb(C, md, region_name: str):
    choice = getattr(C, f"choice_LMB_model_{region_name}")
    if choice == "uniform":
        def run(time, s, masks):
            cf = masks["mask_cf_fl"] | masks["mask_cf_gr"]
            return torch.where(cf, C.uniform_LMB, 0.0).to(md.A.dtype)
        return run
    raise NotImplementedError(
        f"choice_LMB_model '{choice}' is not ported yet (ported: uniform)")
