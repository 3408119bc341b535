"""Lateral mass balance (calving-front) models.

Re-design of src/UFEMISM/lateral_mass_balance/ (LMB_main.f90): uniform and
GlacialIndex. The LMB applies at calving-front vertices.
"""

from __future__ import annotations

import torch

from ..utils.interp import interp


def make_run_lmb(C, md, region_name: str):
    choice = getattr(C, f"choice_LMB_model_{region_name}")
    dtype = md.A.dtype

    if choice == "uniform":
        def run(time, s, masks):
            cf = masks["mask_cf_fl"] | masks["mask_cf_gr"]
            return torch.where(cf, C.uniform_LMB, 0.0).to(dtype)
        return run

    if choice == "GlacialIndex":
        # LMB(t) = LMB_warm + GI(t) (LMB_cold - LMB_warm) at the calving
        # front (LMB_GlacialIndex.f90:40-66)
        from ..io.input_files import read_series_from_file
        tt, gg = read_series_from_file(
            getattr(C, f"filename_LMB_GI_{region_name}"), "GI")
        kw = dict(dtype=dtype, device=md.device)
        tt, gg = torch.as_tensor(tt, **kw), torch.as_tensor(gg, **kw)
        lmb_warm = getattr(C, f"warm_LMB_{region_name}")
        lmb_cold = getattr(C, f"cold_LMB_{region_name}")

        def run(time, s, masks):
            val = lmb_warm + interp(time, tt, gg) * (lmb_cold - lmb_warm)
            cf = masks["mask_cf_fl"] | masks["mask_cf_gr"]
            return torch.where(cf, val, 0.0).to(dtype)
        return run

    raise NotImplementedError(f"choice_LMB_model '{choice}' not implemented")
