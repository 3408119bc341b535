"""ISMIP-standard gridded output files.

Re-design of the reference's ISMIP output writer
(src/UFEMISM/io/main_regional_output/ismip_grid_output_files.f90): one
NetCDF file per region holding the ISMIP6 variable set (CF standard names
lithk/orog/topg/acabf/xvelsurf/... on the regular output grid, yearly
frames, SI units with yr->s flux conversion).

Mesh fields are remapped to the square grid with the conservative
2nd-order map (remap/conservative.py) built once and cached in the Atlas.
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import sec_per_year, ice_density
from .ncio import NCFile

# name -> (standard_name, units, converter tag)
ISMIP_VARS = {
    "lithk": ("land_ice_thickness", "m", None),
    "orog": ("surface_altitude", "m", None),
    "base": ("base_altitude", "m", None),
    "topg": ("bedrock_altitude", "m", None),
    "hfgeoubed": ("upward_geothermal_heat_flux_in_land_ice", "W m-2", None),
    "acabf": ("land_ice_surface_specific_mass_balance_flux",
              "kg m-2 s-1", "flux"),
    "libmassbffl": ("land_ice_basal_specific_mass_balance_flux_floating",
                    "kg m-2 s-1", "flux"),
    "libmassbfgr": ("land_ice_basal_specific_mass_balance_flux_grounded",
                    "kg m-2 s-1", "flux"),
    "dlithkdt": ("tendency_of_land_ice_thickness", "m s-1", "rate"),
    "xvelsurf": ("land_ice_surface_x_velocity", "m s-1", "rate"),
    "yvelsurf": ("land_ice_surface_y_velocity", "m s-1", "rate"),
    "xvelbase": ("land_ice_basal_x_velocity", "m s-1", "rate"),
    "yvelbase": ("land_ice_basal_y_velocity", "m s-1", "rate"),
    "xvelmean": ("land_ice_vertical_mean_x_velocity", "m s-1", "rate"),
    "yvelmean": ("land_ice_vertical_mean_y_velocity", "m s-1", "rate"),
    "litemptop": ("temperature_at_top_of_ice_sheet_model", "K", None),
    "litempbotfl": ("temperature_at_base_of_ice_sheet_model_floating",
                    "K", None),
    "litempbotgr": ("temperature_at_base_of_ice_sheet_model_grounded",
                    "K", None),
    "strbasemag": ("land_ice_basal_drag", "Pa", None),
    "sftgif": ("land_ice_area_fraction", "1", None),
    "sftgrf": ("grounded_ice_sheet_area_fraction", "1", None),
    "sftflf": ("floating_ice_shelf_area_fraction", "1", None),
}


class ISMIPOutput:
    """Writes main_output_grid-style ISMIP files (one var per frame set)."""

    def __init__(self, path, grid, title="UFEMISM2-TPU ISMIP output"):
        self.grid = grid
        self.nc = NCFile(path, "w")
        self.nc.def_dim("x", grid.nx)
        self.nc.def_dim("y", grid.ny)
        self.nc.def_dim("time", None)
        self.nc.def_var("time", ("time",), units="seconds")
        self.nc.def_var("x", ("x",))
        self.nc.put("x", np.asarray(grid.x))
        self.nc.def_var("y", ("y",))
        self.nc.put("y", np.asarray(grid.y))
        for name, (std, units, _) in ISMIP_VARS.items():
            self.nc.def_var(name, ("time", "y", "x"),
                            standard_name=std, units=units)
        self.nc.set_global_attrs(title=title, Conventions="CF-1.7")
        self._it = 0

    def write(self, t_yr: float, fields: dict):
        """fields: ISMIP name -> [ny, nx] array in model units (m, m/yr)."""
        t_s = float(t_yr) * sec_per_year
        first = True
        for name, (_, _, conv) in ISMIP_VARS.items():
            if name not in fields:
                continue
            F = np.asarray(fields[name], dtype=np.float64)
            if conv == "flux":       # m ice eq / yr -> kg m-2 s-1
                F = F * ice_density / sec_per_year
            elif conv == "rate":     # m/yr -> m/s
                F = F / sec_per_year
            self.nc.append(name, F, coord=t_s if first else None)
            first = False
        self._it += 1

    def close(self):
        self.nc.close()


def ismip_fields_from_state(md, grid, map_m2g, s, masks, fg, SMB, BMB,
                            geothermal=None):
    """Assemble the ISMIP variable dict from model state.

    map_m2g: callable mesh-a-field (numpy) -> grid field (from the remap
    Atlas). Velocities live on the b-grid; they are mapped mesh-b ->
    mesh-a first via md.M_map_b_a (a stack_spmv launch on the card),
    matching the reference's map_from_mesh_to_grid chain. The mesh
    fields are read from the device in one transfer."""
    import torch
    from ..core.fields import host_arrays

    gr = masks["mask_grounded_ice"]
    fl = masks["mask_floating_ice"]
    has_ice = gr | fl
    Ti_base = s.Ti[:, -1]
    Ti_surf = s.Ti[:, 0]
    zero = torch.zeros_like(s.Hi)

    def b_to_a(f_b):
        return md.M_map_b_a @ f_b.contiguous()

    mesh_fields = {
        "lithk": s.Hi, "orog": s.Hs, "base": s.Hib, "topg": s.Hb,
        "acabf": SMB,
        "libmassbffl": torch.where(fl, BMB, zero),
        "libmassbfgr": torch.where(gr, BMB, zero),
        "dlithkdt": s.dHi_dt,
        "xvelsurf": b_to_a(s.u_3D_b[:, 0]),
        "yvelsurf": b_to_a(s.v_3D_b[:, 0]),
        "xvelbase": b_to_a(s.u_3D_b[:, -1]),
        "yvelbase": b_to_a(s.v_3D_b[:, -1]),
        "xvelmean": b_to_a(s.u_vav_b),
        "yvelmean": b_to_a(s.v_vav_b),
        "litemptop": torch.where(has_ice, Ti_surf, zero),
        "litempbotfl": torch.where(fl, Ti_base, zero),
        "litempbotgr": torch.where(gr, Ti_base, zero),
        "sftgif": has_ice.to(s.Hi.dtype),
        "sftgrf": fg,
        "sftflf": fl.to(s.Hi.dtype),
    }
    if geothermal is not None:
        mesh_fields["hfgeoubed"] = geothermal
    host = host_arrays(mesh_fields)
    out = {k: np.asarray(map_m2g(v)) for k, v in host.items()}
    # the 2nd-order conservative map can overshoot at the ice margin;
    # thickness and area fractions are clamped to their physical range
    out["lithk"] = np.maximum(0.0, out["lithk"])
    for k in ("sftgif", "sftgrf", "sftflf"):
        out[k] = np.clip(out[k], 0.0, 1.0)
    if geothermal is not None:
        out["hfgeoubed"] = out["hfgeoubed"] / sec_per_year  # J m-2 yr-1
    return out
