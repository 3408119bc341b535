"""Standalone LADDIE program.

Port of the JAX package's main/laddie_program.py (a re-design of the
reference's src/LADDIE/main/LADDIE_program.f90 and
src/LADDIE/forcing/laddie_forcing_main.f90 initialise_forcing): build the
mesh from the PD reference geometry, derive the ice masks, assemble the
plume forcing (ice draft and the ambient ocean T/S profiles), then
integrate the one-layer plume to quasi-steady state in legs of dt_output
days, writing laddie_output_fields_mesh.nc and laddie_scalar_output.nc
after each.

Usage:
    python -m ufemism2_tpu_torch laddie <config.cfg> [--output-dir DIR]
        [--device cpu]
"""

from __future__ import annotations

import time as _time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..ops import resolve_device
from ..utils.logging_utils import happy, routine

MESH_FIELDS = ["H_lad", "U_lad", "V_lad", "T_lad", "S_lad", "melt", "entr",
               "detr", "gamma_T", "T_base", "T_amb", "S_amb", "Hib", "Hi",
               "TAF"]
SCALAR_FIELDS = ["melt_mean", "melt_max", "melt_tot_Gt", "entr_tot_Sv",
                 "layer_volume_km3", "T_mean", "T_min", "T_max", "S_mean",
                 "S_min", "S_max"]


def standalone_setup(C, region: str = "ANT", device="cuda"):
    """The standalone plume's set-up (initialise_forcing and
    initialise_laddie_model): (mesh, md, ice state, LADDIE masks, forcing,
    step, initial plume state)."""
    from ..mesh.creation import build_mesh_from_config
    from ..core.mesh_data import build_mesh_data
    from ..core.idealised_geometries import calc_idealised_geometry
    from ..core.ice.masks import determine_masks
    from ..core.ice.state import init_ice_state
    from ..models.ocean import make_run_ocean, ocean_depth_axis
    from ..models.laddie import (laddie_masks, make_laddie_step,
                                 init_laddie_state, make_calc_SGD)

    device = resolve_device(device)
    dtype = torch.float32 if C.tpu_precision == "f32" else torch.float64
    with routine("LADDIE_program/initialise_forcing"):
        mesh = build_mesh_from_config(C, region)
        md = build_mesh_data(mesh, dtype=dtype, device=device)
        choice = getattr(C, f"choice_refgeo_PD_{region}")
        if choice == "idealised" or not Path(
                getattr(C, f"filename_refgeo_PD_{region}", "")).exists():
            sub = (C.choice_refgeo_PD_idealised
                   or C.choice_refgeo_init_idealised)
            Hi, Hb, Hs, SL = calc_idealised_geometry(
                mesh.V[:, 0], mesh.V[:, 1], sub, C)
            Hi = np.where(Hi < C.refgeo_Hi_min, 0.0, Hi)
        else:
            from ..io.input_files import read_geometry_onto_mesh
            Hi, Hb, SL = read_geometry_onto_mesh(C, region, mesh, which="PD")
        state = init_ice_state(md, Hi, Hb, SL, nz=C.nz, dt_init=C.dt_ice_min)
        masks = determine_masks(md, state.Hi, state.Hb, state.SL)
        lm = laddie_masks(md, masks)

    with routine("LADDIE_program/initialise_laddie_model"):
        ocean = make_run_ocean(C, md, region, mesh=mesh)(0.0, state)
        calc_sgd = make_calc_SGD(C, md)
        forcing = {
            "Hib": state.Hib,
            "dHib_dx_b": md.M_ddx_a_b @ state.Hib,
            "dHib_dy_b": md.M_ddy_a_b @ state.Hib,
            "Ti_base": state.Ti[:, 0] - 273.15,   # degC (forcing_main:169)
            "use_Ti": False,
            "z_ocean": torch.as_tensor(ocean_depth_axis(C), dtype=dtype,
                                       device=device),
            "T_ocean": ocean["T"], "S_ocean": ocean["S"],
            "SGD": (torch.zeros(md.nV, dtype=dtype, device=device)
                    if calc_sgd is None else
                    calc_sgd(masks["mask_floating_ice"], masks["mask_gl_fl"],
                             C.start_time_of_run)),
        }
        step_fn = make_laddie_step(C, md)
        lst = init_laddie_state(C, md, lm, forcing)
    return mesh, md, state, lm, forcing, step_fn, lst


def run_laddie_standalone(config_path: str, output_dir: str | None = None,
                          region: str = "ANT", device="cuda"):
    """Run the standalone plume; returns (plume state, melt [m/yr]). The
    run's wall, shelf size and pseudo-steps are in the attribute
    `run_laddie_standalone.last`."""
    from ..models.laddie import leg_steps, run_laddie_leg_with_diag
    from ..io.output_files import MeshOutputFile, ScalarOutputFile
    from ..utils.constants import sec_per_year

    C = load_config(config_path)
    out = Path(output_dir or C.fixed_output_dir or "results_laddie")
    out.mkdir(parents=True, exist_ok=True)
    (out / Path(config_path).name).write_text(Path(config_path).read_text())
    mesh, md, state, lm, forcing, step_fn, lst = standalone_setup(
        C, region, device)

    duration = C.time_duration_laddie_init or C.time_duration_laddie
    shelf = lm.a.cpu().numpy()
    n_shelf = int(shelf.sum())
    happy("LADDIE standalone: {} shelf vertices, integrating {} days ...",
          n_shelf, duration)

    # the reference's laddie_mesh_output.f90 field set (geometry, plume
    # state and melt diagnostics) and laddie_scalar_output.f90's buffers
    mesh_out = MeshOutputFile(str(out / "laddie_output_fields_mesh.nc"),
                              mesh, fields=MESH_FIELDS)
    scal_out = ScalarOutputFile(str(out / "laddie_scalar_output.nc"),
                                fields=SCALAR_FIELDS)

    # output cadence: C%dt_output (days within the standalone run,
    # LADDIE_main_model.f90:200)
    n_legs = max(1, int(np.ceil(duration / max(C.dt_output, 1e-9)))) \
        if C.dt_output and C.dt_output < duration else 1
    leg_days = duration / n_legs
    area = md.A.double().cpu().numpy()
    geo = {k: getattr(state, k).double().cpu().numpy()
           for k in ("Hib", "Hi", "TAF")}
    t0 = _time.perf_counter()
    n_steps = 0
    for i in range(n_legs):
        lst, melt, diag = run_laddie_leg_with_diag(C, md, lst, lm, forcing,
                                                   leg_days, step_fn)
        n_steps += leg_steps(C, leg_days) + 1
        t_days = (i + 1) * leg_days
        # the leg's melt [m/yr] in place of the diagnostic step's [m/s]
        host = {k: v.double().cpu().numpy() for k, v in dict(
            diag, H=lst.H, U=md.M_map_b_a @ lst.U, V=md.M_map_b_a @ lst.V,
            T=lst.T, S=lst.S, melt=melt).items()}
        melt_np = host["melt"]
        mesh_out.write(t_days, {
            "H_lad": host["H"], "U_lad": host["U"], "V_lad": host["V"],
            "T_lad": host["T"], "S_lad": host["S"], "melt": melt_np,
            "entr": host["entr"] * sec_per_year,
            "detr": host["detr"] * sec_per_year,
            "gamma_T": host["gamma_T"], "T_base": host["T_base"],
            "T_amb": host["T_amb"], "S_amb": host["S_amb"], **geo})
        wshelf = area * shelf
        mean_melt = float((melt_np * wshelf).sum()
                          / max(wshelf.sum(), 1e-30))
        T_np, S_np = host["T"][shelf], host["S"][shelf]
        stat = lambda a, f: float(f(a)) if len(a) else 0.0
        scal_out.write(t_days, {
            "melt_mean": mean_melt,
            "melt_max": float(melt_np.max()),
            "melt_tot_Gt": float((melt_np * wshelf).sum() * 917e-12),
            "entr_tot_Sv": float((host["entr"] * wshelf).sum() / 1e6),
            "layer_volume_km3": float((host["H"] * wshelf).sum() / 1e9),
            "T_mean": stat(T_np, np.mean), "T_min": stat(T_np, np.min),
            "T_max": stat(T_np, np.max), "S_mean": stat(S_np, np.mean),
            "S_min": stat(S_np, np.min), "S_max": stat(S_np, np.max)})
        happy("  LADDIE t = {:.1f} d: mean melt {:.3f} m/yr, max {:.3f} m/yr",
              t_days, mean_melt, float(melt_np.max()))
    mesh_out.close()
    scal_out.close()
    wall = _time.perf_counter() - t0
    happy("LADDIE standalone done in {:.1f} s -> {}", wall, str(out))
    run_laddie_standalone.last = dict(
        nV=md.nV, nTri=md.nTri, shelf=n_shelf, legs=n_legs, steps=n_steps,
        wall_s=wall, mean_melt=mean_melt)
    return lst, melt
