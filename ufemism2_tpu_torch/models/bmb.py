"""Basal mass balance (sub-shelf melt) models.

Re-design of src/UFEMISM/basal_mass_balance/ (BMB_main.f90 dispatch +
Leguy et al. 2021 sub-grid schemes). Ported so far: 'uniform'; the
idealised, parameterised, prescribed, inverted and laddie choices raise
NotImplementedError.
Sign convention: positive BMB = accumulation (refreezing), negative = melt.
"""

from __future__ import annotations

import torch


def apply_bmb_subgrid_scheme(C, masks, fraction_gr, BMB_shelf):
    """FCMP / PMP / NMP grounding-line melt schemes (BMB_main.f90:721)."""
    if C.do_subgrid_BMB_at_grounding_line:
        if C.choice_BMB_subgrid == "FCMP":
            return torch.where(masks["mask_floating_ice"], BMB_shelf, 0.0)
        if C.choice_BMB_subgrid == "PMP":
            gl = masks["mask_floating_ice"] | masks["mask_gl_gr"]
            return torch.where(gl, (1.0 - fraction_gr) * BMB_shelf, 0.0)
        raise ValueError(f"unknown choice_BMB_subgrid "
                         f"'{C.choice_BMB_subgrid}'")
    # NMP
    return torch.where(fraction_gr == 0.0, BMB_shelf, 0.0)


def make_run_bmb(C, md, region_name: str):
    """Returns run(time, state, masks, fraction_gr, ocean) -> BMB [m/yr]."""
    choice = getattr(C, f"choice_BMB_model_{region_name}")
    if choice == "uniform":
        def run(time, s, masks, fraction_gr, ocean=None):
            shelf = torch.full((md.nV,), C.uniform_BMB, dtype=md.A.dtype,
                               device=md.device)
            bmb = apply_bmb_subgrid_scheme(C, masks, fraction_gr, shelf)
            return torch.clamp(bmb, -C.BMB_maximum_allowed_melt_rate,
                               C.BMB_maximum_allowed_refreezing_rate)
        return run
    raise NotImplementedError(
        f"choice_BMB_model '{choice}' is not ported yet (ported: uniform)")
