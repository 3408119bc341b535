"""Basal mass balance (sub-shelf melt) models.

Re-design of src/UFEMISM/basal_mass_balance/ (BMB_main.f90 dispatch and
the Leguy et al. 2021 sub-grid schemes): uniform, idealised (uniform, the
MISMIP+ ice1r melt of Asay-Davis et al. 2016), prescribed and
prescribed_fixed (a field read from a file), parameterised (the quadratic
local melt of Favier et al. 2019) and inverted (nudged towards a target
geometry) and laddie (the plume model of models/laddie.py).
Sign convention: positive BMB = accumulation (refreezing), negative = melt.
"""

from __future__ import annotations

import torch

from ..utils.constants import (seawater_density, ice_density, cp_ocean,
                               L_fusion, freezing_lambda_1, freezing_lambda_2,
                               freezing_lambda_3, sec_per_year)


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


def make_run_bmb(C, md, region_name: str, target_geometry=None):
    """Returns run(time, state, masks, fraction_gr, ocean) -> BMB [m/yr].

    target_geometry: a callable -> (Hi_target [nV], mask_shelf_target
    [nV]) for the 'inverted' choice, called at every BMB event so that a
    caller may replace the target after the region is built (the
    reference reads it from filename_refgeo_PD, BMB_inverted.f90:70-96).
    """
    choice = getattr(C, f"choice_BMB_model_{region_name}")
    nV, dtype, device = md.nV, md.A.dtype, md.device

    def _finalise(masks, fraction_gr, BMB_shelf):
        bmb = apply_bmb_subgrid_scheme(C, masks, fraction_gr, BMB_shelf)
        return torch.clamp(bmb, -C.BMB_maximum_allowed_melt_rate,
                           C.BMB_maximum_allowed_refreezing_rate)

    def _uniform():
        def run(time, s, masks, fraction_gr, ocean=None):
            shelf = torch.full((nV,), C.uniform_BMB, dtype=dtype,
                               device=device)
            return _finalise(masks, fraction_gr, shelf)
        return run

    if choice == "uniform":
        return _uniform()

    if choice in ("prescribed", "prescribed_fixed"):
        # a time-constant sub-shelf melt field read from a file
        # (BMB_prescribed.f90); 'prescribed_fixed' keeps it on the initial
        # mesh in the reference, the same here since the field is read
        # anew on every mesh
        mesh = getattr(md, "_host_mesh", None)
        fname = getattr(C, f"filename_BMB_prescribed_{region_name}")
        if mesh is None or not fname:
            raise ValueError("prescribed BMB needs filename_BMB_prescribed"
                             f"_{region_name} and the host mesh")
        from ..io.input_files import read_field_from_file_2D
        val = torch.as_tensor(read_field_from_file_2D(fname, "BMB", mesh),
                              dtype=dtype, device=device)

        def run(time, s, masks, fraction_gr, ocean=None):
            return _finalise(masks, fraction_gr, val)
        return run

    if choice == "idealised":
        sub = C.choice_BMB_model_idealised
        if sub in ("", "uniform"):
            return _uniform()
        if sub in ("MISMIPplus", "MISMIP+"):   # BMB_idealised.f90:46-48
            # the Asay-Davis et al. (2016) ice1r melt
            def run(time, s, masks, fraction_gr, ocean=None):
                draft = s.Hib
                z0 = -100.0
                cavity = torch.clamp(draft - s.Hb, min=0.0)
                melt = 0.2 * torch.tanh(cavity / 75.0) \
                    * torch.clamp(z0 - draft, min=0.0)
                return _finalise(masks, fraction_gr, -melt)
            return run
        raise ValueError(f"unknown choice_BMB_model_idealised '{sub}'")

    if choice == "parameterised":
        sub = C.choice_BMB_model_parameterised
        if sub == "Favier2019":
            # Favier et al. (2019) quadratic local melt
            gamma = C.BMB_Favier2019_gamma
            coef = (seawater_density * cp_ocean
                    / (ice_density * L_fusion)) ** 2

            def run(time, s, masks, fraction_gr, ocean=None):
                if ocean is None:
                    raise ValueError("Favier2019 BMB needs an ocean model")
                dT = torch.clamp(ocean["T_draft"]
                                 - ocean["T_freezing_point"], min=0.0)
                melt = gamma * sec_per_year * coef * dT ** 2   # [m/yr]
                return _finalise(masks, fraction_gr, -melt)
            return run
        raise NotImplementedError(
            f"choice_BMB_model_parameterised '{sub}' is not ported yet "
            "(ported: Favier2019)")

    if choice == "inverted":
        # the inverted melt is host-held state: it starts at zero, is not
        # in the restart, and starts at zero again when the runner is
        # rebuilt after a mesh update (as the JAX package's)
        from .bed_roughness import make_run_bmb_inverted
        inv = make_run_bmb_inverted(C, md)
        cache = {"BMB": None}

        def run(time, s, masks, fraction_gr, ocean=None):
            if cache["BMB"] is None:
                cache["BMB"] = torch.zeros(nV, dtype=dtype, device=device)
            if target_geometry is not None:
                Hi_t, tgt_shelf = target_geometry()
            else:
                # no target: the current state (a pure dHi_dt damper)
                Hi_t, tgt_shelf = s.Hi, masks["mask_floating_ice"]
            cache["BMB"] = inv(cache["BMB"], s, masks, Hi_t, tgt_shelf,
                               time)
            return cache["BMB"]
        run.cache = cache
        return run

    if choice == "laddie":
        from .laddie import make_run_bmb_laddie
        return make_run_bmb_laddie(C, md, region_name)

    raise NotImplementedError(f"choice_BMB_model '{choice}' is not ported "
                              "yet")


def ocean_freezing_point_at_draft(S_draft, draft):
    """Local freezing point [deg C] (parameters.f90 freezing_lambda_*)."""
    return (freezing_lambda_1 * S_draft + freezing_lambda_2
            + freezing_lambda_3 * draft)
