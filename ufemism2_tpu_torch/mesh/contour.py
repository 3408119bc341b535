"""Mesh contour extraction for line output fields.

The reference writes grounding-line / calving-front / ice-margin /
coastline / grounded-ice-contour polylines into its mesh output files as
NaN-padded ``(nE, 2)`` arrays in "Matlab contour format": each traced
segment is stored as a header row ``[n_points, NaN]`` followed by
``n_points`` interpolated ``(x, y)`` rows
(src/UPSY/mesh/mesh_contour.f90 calc_mesh_contour;
src/UFEMISM/io/main_regional_output/mesh_output_files.f90
write_grounding_line_to_file ff.).

This is a host-side, output-cadence computation (the reference gathers
to the primary rank and traces serially); the numpy implementation
vectorises the edge-crossing scan and walks only the O(contour-length)
crossing edges.
"""
from __future__ import annotations

import numpy as np

__all__ = ["calc_mesh_contour", "line_output_fields"]


def calc_mesh_contour(mesh, d, level=0.0):
    """NaN-padded (nE, 2) Matlab-format contour of vertex field `d` at
    `level`. NaN vertices suppress crossings (the reference uses NaN
    masking to restrict e.g. the grounding line to ice-covered
    vertices)."""
    nE = mesh.nE
    CC = np.full((nE, 2), np.nan)
    d = np.asarray(d, dtype=np.float64) - level

    EV = np.asarray(mesh.EV[:, :2], dtype=np.int64)       # [nE, 2]
    ETri = np.asarray(mesh.ETri, dtype=np.int64)          # [nE, 2], -1=none
    TriE = np.asarray(mesh.TriE, dtype=np.int64)          # [nTri, 3]
    V = np.asarray(mesh.V, dtype=np.float64)

    di, dj = d[EV[:, 0]], d[EV[:, 1]]
    cross = di * dj < 0.0                                 # NaN -> False

    if not cross.any():
        return CC

    # crossing-edge count per triangle
    nT_cross = np.zeros(mesh.nTri, dtype=np.int64)
    for side in (0, 1):
        t = ETri[cross, side]
        np.add.at(nT_cross, t[t >= 0], 1)

    # end edges: on the domain border, or flanking a triangle in which
    # the contour dead-ends (exactly one crossing edge - NaN truncation)
    EBI = _edge_border_index(mesh)
    single = np.zeros(mesh.nTri + 1, dtype=bool)
    single[:-1] = nT_cross == 1
    is_end = cross & ((EBI > 0)
                      | single[ETri[:, 0]] | single[ETri[:, 1]])

    # interpolated crossing point per crossing edge
    with np.errstate(invalid="ignore", divide="ignore"):
        w = di / (di - dj)
        P = V[EV[:, 0]] + w[:, None] * (V[EV[:, 1]] - V[EV[:, 0]])

    visited = np.zeros(nE, dtype=bool)
    visited[~cross] = True

    def next_edge(ei, ei_prev):
        for t in ETri[ei]:
            if t < 0:
                continue
            for ej in TriE[t]:
                if ej != ei and ej != ei_prev and cross[ej] \
                        and not visited[ej]:
                    return int(ej)
        return -1

    def trace(ei_start):
        path = []
        ei_prev = -1
        ei = int(ei_start)
        for _ in range(nE):
            visited[ei] = True
            path.append(ei)
            ej = next_edge(ei, ei_prev)
            if ej < 0:
                break
            ei_prev, ei = ei, ej
        return path

    n = 0

    def emit(path):
        nonlocal n
        m = len(path)
        if m < 2 or n + m + 1 > nE:
            return
        CC[n] = (float(m), np.nan)
        CC[n + 1:n + m + 1] = P[path]
        n += m + 1

    # linear contours start from end edges, then any remaining crossing
    # edges belong to closed loops
    for ei in np.nonzero(is_end)[0]:
        if not visited[ei]:
            emit(trace(ei))
    for ei in np.nonzero(cross)[0]:
        if not visited[ei]:
            path = trace(ei)
            path.append(path[0])                # close the loop
            emit(path)
    return CC


def _edge_border_index(mesh):
    """Border index per edge (0 = interior), reference EBI semantics
    (an edge is on the border iff it flanks only one triangle)."""
    from .voronoi_mesh import calc_EBI
    try:
        return np.asarray(calc_EBI(mesh))
    except Exception:
        return (np.asarray(mesh.ETri) < 0).any(axis=1).astype(np.int64)


# field construction per line variable: (masked vertex field, level),
# matching mesh_output_files.f90 write_*_to_file
def line_output_fields(name, Hi, Hb, SL, TAF, mask_grounded_ice):
    nan = np.nan
    if name == "grounding_line":
        return np.where(Hi > 0.1, TAF, nan), 0.0
    if name == "calving_front":
        return np.where(TAF < 0.0, Hi, nan), 0.05
    if name == "ice_margin":
        return np.asarray(Hi, dtype=np.float64), 0.05
    if name == "coastline":
        return np.where(Hi > 0.05, nan, SL - Hb), 0.0
    if name == "grounded_ice_contour":
        return np.where(mask_grounded_ice, Hi, 0.0), 0.05
    raise ValueError(f"unknown line output field '{name}'")
