"""Mesh creation routines: from config + (idealised or gridded) geometry.

Re-design of src/UFEMISM/mesh_creation/mesh_creation_main.f90 +
mesh_creation_from_reduced_geometry.f90: reduce the ice geometry to
polygons/polylines (sheet/shelf masks, grounding line, calving front, ice
front, coastline), refine the mesh to the per-feature target resolutions,
run Lloyd's algorithm, then build secondary data.
"""

from __future__ import annotations

import numpy as np

from .mesh_types import Mesh, mesh_from_points, renumber_mesh_morton
from .refinement import (LineCriterion, PolygonCriterion, UniformCriterion,
                         points_in_polygon, refine_mesh, lloyds_algorithm)
from .grid_contours import contour_lines


def build_uniform_mesh(xmin, xmax, ymin, ymax, res,
                       alpha_min=0.4363, resolution_tolerance=1.25,
                       nit_lloyd=2, nz=12, choice_zeta_grid="regular",
                       zeta_irregular_log_R=10.0) -> Mesh:
    """Uniform-resolution mesh over a rectangular domain."""
    V = refine_mesh(xmin, xmax, ymin, ymax,
                    [UniformCriterion(res)],
                    alpha_min=alpha_min,
                    resolution_tolerance=resolution_tolerance)
    V = lloyds_algorithm(V, xmin, xmax, ymin, ymax, nit=nit_lloyd,
                         alpha_min=alpha_min)
    m = mesh_from_points(V, xmin, xmax, ymin, ymax, nz=nz,
                         choice_zeta_grid=choice_zeta_grid,
                         zeta_irregular_log_R=zeta_irregular_log_R)
    return renumber_mesh_morton(m)


def _contour_lines(x, y, F, level):
    """Extract iso-contour polylines of gridded field F at `level`.

    Host-side marching squares (mesh/grid_contours.py). Returns list of
    [n,2] arrays. Reference analogue:
    mesh_creation/reduce_ice_geometry.f90 poly/line extraction.
    """
    return contour_lines(x, y, F, level)


def geometry_criteria_from_grid(C, x, y, Hi, Hb, SL=None):
    """Build refinement criteria from a gridded ice geometry.

    Reproduces reduce_gridded_ice_geometry's features: grounded/floating ice
    polygons, grounding line, calving front, ice front, coastline polylines.
    """
    from ..core.ice.geometry import thickness_above_flotation_np

    if SL is None:
        SL = np.zeros_like(Hi)
    TAF = thickness_above_flotation_np(Hi, Hb, SL)
    has_ice = Hi > 0.1
    grounded = has_ice & (TAF > 0)
    floating = has_ice & (TAF <= 0)
    ocean = (~has_ice) & (Hb < SL)

    crits = [UniformCriterion(C.maximum_resolution_uniform)]

    def add_lines(F, level, res, width):
        for line in _contour_lines(x, y, F.astype(np.float64), level):
            crits.append(LineCriterion(line, res, width))

    # polygons via mask contours at 0.5
    for line in _contour_lines(x, y, grounded.astype(np.float64), 0.5):
        crits.append(PolygonCriterion(line, C.maximum_resolution_grounded_ice))
    for line in _contour_lines(x, y, floating.astype(np.float64), 0.5):
        crits.append(PolygonCriterion(line, C.maximum_resolution_floating_ice))

    # grounding line: TAF = 0 inside ice
    TAFm = np.where(has_ice, TAF, np.maximum(TAF, 1.0))
    add_lines(TAFm, 0.0, C.maximum_resolution_grounding_line,
              C.grounding_line_width)
    # calving front: ice-ocean boundary of floating ice
    cf = np.where(floating, 1.0, np.where(ocean, -1.0, 0.0))
    add_lines(cf, 0.0, C.maximum_resolution_calving_front,
              C.calving_front_width)
    # ice front: ice boundary
    add_lines(np.where(has_ice, 1.0, -1.0), 0.0,
              C.maximum_resolution_ice_front, C.ice_front_width)
    # coastline: land-sea boundary outside ice
    coast = np.where(~has_ice & (Hb >= SL), 1.0, -1.0)
    add_lines(coast, 0.0, C.maximum_resolution_coastline, C.coastline_width)

    # regions of interest: tighter resolutions inside the named polygons
    # (mesh_creation_refine_in_ROIs.f90 + mesh_refinement_basic_ROI.f90)
    rois = [r.strip() for r in C.choice_regions_of_interest.split(",")
            if r.strip()]
    if rois:
        from .roi_polygons import calc_roi_polygon

        def add_lines_roi(F, level, res, width, poly):
            for line in _contour_lines(x, y, F.astype(np.float64), level):
                inside = points_in_polygon(line, poly)
                if inside.any():
                    # split into inside segments
                    idx = np.flatnonzero(np.diff(
                        np.r_[False, inside, False].astype(int)))
                    for a, b in zip(idx[::2], idx[1::2]):
                        if b - a >= 2:
                            crits.append(LineCriterion(line[a:b], res,
                                                       width))

        for roi in rois:
            poly = calc_roi_polygon(roi)
            crits.append(PolygonCriterion(poly,
                                          C.ROI_maximum_resolution_uniform))
            add_lines_roi(TAFm, 0.0, C.ROI_maximum_resolution_grounding_line,
                          C.grounding_line_width, poly)
            add_lines_roi(cf, 0.0, C.ROI_maximum_resolution_calving_front,
                          C.calving_front_width, poly)
    return crits


def build_mesh_from_gridded_geometry(C, region: str, x, y, Hi, Hb,
                                     SL=None) -> Mesh:
    """Create the model mesh from a gridded reference geometry (main path)."""
    xmin = getattr(C, f"xmin_{region}")
    xmax = getattr(C, f"xmax_{region}")
    ymin = getattr(C, f"ymin_{region}")
    ymax = getattr(C, f"ymax_{region}")
    crits = geometry_criteria_from_grid(C, x, y, Hi, Hb, SL)
    V = refine_mesh(xmin, xmax, ymin, ymax, crits,
                    alpha_min=C.alpha_min,
                    resolution_tolerance=C.mesh_resolution_tolerance)
    V = lloyds_algorithm(V, xmin, xmax, ymin, ymax,
                         nit=C.nit_Lloyds_algorithm,
                         alpha_min=C.alpha_min)
    m = mesh_from_points(V, xmin, xmax, ymin, ymax, nz=C.nz,
                         choice_zeta_grid=C.choice_zeta_grid,
                         zeta_irregular_log_R=C.zeta_irregular_log_R)
    m = renumber_mesh_morton(m)
    set_mesh_lonlat(m, C, region)
    return m


def set_mesh_lonlat(mesh: Mesh, C, region: str):
    """Attach lon/lat secondary data from the region's projection
    (mesh_secondary.f90 calc_lonlat; inverse Reerink 2010 projection)."""
    from .projections import (inverse_oblique_sg_projection,
                              region_projection_params)
    proj = region_projection_params(C, region)
    lon, lat = inverse_oblique_sg_projection(mesh.V[:, 0], mesh.V[:, 1],
                                             *proj)
    mesh.lon, mesh.lat, mesh.proj = lon, lat, proj


def build_mesh_from_config(C, region: str = "ANT", geometry=None) -> Mesh:
    """Top-level mesh creation from a Config.

    geometry: optional (x, y, Hi, Hb, SL) tuple; if None, read from the
    initial-geometry file (choice_refgeo_init 'read_from_file') or
    generated from the config's idealised reference-geometry choice on a
    square grid at dx_refgeo_init_idealised.
    """
    if geometry is None:
        if getattr(C, f"choice_refgeo_init_{region}") == "read_from_file":
            # realistic path: the mesh fitted to the file's gridded
            # geometry (mesh_creation.f90 create_mesh_from_gridded_geometry)
            from ..io.input_files import read_geometry_grid_raw
            x, y, fields = read_geometry_grid_raw(C, region)
            geometry = (x, y, fields["Hi"], fields["Hb"],
                        fields.get("SL"))
        else:
            from ..core.idealised_geometries import (
                generate_idealised_geometry_grid)
            geometry = generate_idealised_geometry_grid(C, region)
    x, y, Hi, Hb, SL = geometry
    return build_mesh_from_gridded_geometry(C, region, x, y, Hi, Hb, SL)
