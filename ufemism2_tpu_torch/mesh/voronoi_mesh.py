"""Explicit Voronoi mesh mirror + edge/triangle border secondary data.

The reference ships the full Voronoi tessellation of every mesh in its
output files (mesh_Voronoi.f90: translation tables vi/ti/ei <-> vori,
vertex coordinates, connectivity, per-cell spanning lists) plus the
edge/triangle border indices and edge cell areas (mesh_edges.f90:205,
mesh_secondary.f90 calc_TriBI), and its MATLAB/Python analysis tooling
(read_mesh_from_file + plot_mesh patches) consumes them. This module
reproduces those arrays from our Mesh so the same tooling reads our
files.

All arrays here are 0-based with -1 = none (converted to the
reference's 1-based convention only at the NetCDF write,
io/output_files.py).
"""

from __future__ import annotations

import numpy as np

_N, _NE, _E, _SE, _S, _SW, _W, _NW = 1, 2, 3, 4, 5, 6, 7, 8


def calc_EBI(mesh):
    """Edge border index [nE] (mesh_edges.f90:205 edge_border_index)."""
    vbi_i = mesh.VBI[mesh.EV[:, 0]]
    vbi_j = mesh.VBI[mesh.EV[:, 1]]

    def on(side_set):
        return np.isin(vbi_i, side_set) & np.isin(vbi_j, side_set)

    EBI = np.zeros(mesh.nE, dtype=np.int32)
    EBI[on([_NW, _N, _NE])] = _N
    EBI[on([_NE, _E, _SE])] = _E
    EBI[on([_SE, _S, _SW])] = _S
    EBI[on([_SW, _W, _NW])] = _W
    EBI[(vbi_i == 0) | (vbi_j == 0)] = 0
    return EBI


def calc_TriBI(mesh):
    """Triangle border index [nTri] (mesh_secondary.f90 calc_TriBI):
    every triangle of a border vertex inherits that vertex's VBI along
    a counter-clockwise trace of the border from the SW corner; corner
    vertices with a single triangle override it with the corner code."""
    TriBI = np.zeros(mesh.nTri, dtype=np.int32)
    sw = np.flatnonzero(mesh.VBI == _SW)
    if len(sw) == 0:
        return TriBI
    vi0 = int(sw[0])
    vi = vi0
    for _ in range(mesh.nV):
        for k in range(int(mesh.niTri[vi])):
            TriBI[mesh.iTri[vi, k]] = mesh.VBI[vi]
        # next border vertex counter-clockwise = last connection
        vi = int(mesh.C[vi, mesh.nC[vi] - 1])
        if vi == vi0:
            break
    # corner triangles
    for code in (_SW, _SE, _NE, _NW):
        for vi in np.flatnonzero(mesh.VBI == code):
            if mesh.niTri[vi] == 1:
                TriBI[mesh.iTri[vi, 0]] = code
    return TriBI


def calc_EA(mesh):
    """Edge cell areas [nE] (mesh_edges.f90 calc_edge_areas): the two
    triangles (vi, vj, Tricc(left)) and (vj, vi, Tricc(right)). The sub-
    triangles of a mesh triangle's three edges tile it exactly, so
    sum(EA) == sum(TriA)."""
    def tri_area(p, q, r):
        return 0.5 * np.abs((q[:, 0] - p[:, 0]) * (r[:, 1] - p[:, 1])
                            - (q[:, 1] - p[:, 1]) * (r[:, 0] - p[:, 0]))

    vi = mesh.EV[:, 0]
    vj = mesh.EV[:, 1]
    EA = np.zeros(mesh.nE)
    for side in (0, 1):
        t = mesh.ETri[:, side]
        ok = t >= 0
        cc = mesh.Tricc[np.where(ok, t, 0)]
        EA += np.where(ok, tri_area(mesh.V[vi], mesh.V[vj], cc), 0.0)
    return EA


def corner_vertices(mesh):
    """(vi_SW, vi_SE, vi_NW, vi_NE) — the reference's corner order for
    the translation tables (mesh_Voronoi.f90:121)."""
    out = []
    for code in (_SW, _SE, _NW, _NE):
        idx = np.flatnonzero(mesh.VBI == code)
        out.append(int(idx[0]) if len(idx) else -1)
    return out


def construct_voronoi_mesh(mesh, EBI=None):
    """All Voronoi-mirror arrays (mesh_Voronoi.f90), 0-based, -1=none.

    Returns dict with nVor, vi2vori, ti2vori, ei2vori, vori2vi,
    vori2ti, vori2ei, Vor, VornC, VorC, nVVor, VVor.
    """
    if EBI is None:
        EBI = calc_EBI(mesh)
    corners = corner_vertices(mesh)
    border_edges = np.flatnonzero(EBI > 0)
    nVor = mesh.nTri + len(border_edges) + sum(1 for c in corners if c >= 0)

    vi2vori = np.full(mesh.nV, -1, dtype=np.int64)
    ti2vori = np.arange(mesh.nTri, dtype=np.int64)
    ei2vori = np.full(mesh.nE, -1, dtype=np.int64)
    ei2vori[border_edges] = mesh.nTri + np.arange(len(border_edges))
    n0 = mesh.nTri + len(border_edges)
    cor = [c for c in corners if c >= 0]
    vi2vori[cor] = n0 + np.arange(len(cor))

    vori2vi = np.full(nVor, -1, dtype=np.int64)
    vori2ti = np.full(nVor, -1, dtype=np.int64)
    vori2ei = np.full(nVor, -1, dtype=np.int64)
    vori2ti[:mesh.nTri] = np.arange(mesh.nTri)
    vori2ei[mesh.nTri:n0] = border_edges
    vori2vi[n0:] = cor

    Vor = np.empty((nVor, 2))
    Vor[:mesh.nTri] = mesh.Tricc
    Vor[mesh.nTri:n0] = mesh.E[border_edges]
    Vor[n0:] = mesh.V[cor]

    # --- connectivity -----------------------------------------------------
    VornC = np.zeros(nVor, dtype=np.int64)
    VorC = np.full((nVor, 3), -1, dtype=np.int64)

    # triangle-based: neighbour across edge (n2,n3) = TriC(ti,n1), or
    # the border edge's Voronoi vertex when there is no neighbour
    VornC[:mesh.nTri] = 3
    tj = mesh.TriC                                 # [nTri,3]
    # edge opposite vertex n1 connects Tri(:,n2),Tri(:,n3) = TriE(:, n1)
    e_opp = mesh.TriE
    use_tri = tj >= 0
    VorC[:mesh.nTri] = np.where(use_tri, ti2vori[np.maximum(tj, 0)],
                                ei2vori[np.maximum(e_opp, 0)])

    corner_set = set(cor)
    # edge-based (border edges): [counter-clockwise nbr, triangle,
    # clockwise nbr] along the border
    for ei in border_edges:
        vori = ei2vori[ei]
        vi, vj = mesh.EV[ei, 0], mesh.EV[ei, 1]
        if mesh.C[vi, 0] == vj:
            vi_clock, vi_count = vi, vj
        else:
            vi_clock, vi_count = vj, vi
        ei_clock = mesh.VE[vi_clock, mesh.nC[vi_clock] - 1]
        ei_count = mesh.VE[vi_count, 0]
        ti = mesh.ETri[ei, 0] if mesh.ETri[ei, 0] >= 0 else mesh.ETri[ei, 1]
        VornC[vori] = 3
        VorC[vori, 0] = (vi2vori[vi_count] if vi_count in corner_set
                         else ei2vori[ei_count])
        VorC[vori, 1] = ti2vori[ti]
        VorC[vori, 2] = (vi2vori[vi_clock] if vi_clock in corner_set
                         else ei2vori[ei_clock])

    # vertex-based (the 4 corners): the two adjacent border edges
    for vi in cor:
        vori = vi2vori[vi]
        VornC[vori] = 2
        VorC[vori, 0] = ei2vori[mesh.VE[vi, 0]]
        VorC[vori, 1] = ei2vori[mesh.VE[vi, mesh.nC[vi] - 1]]

    # --- per-vertex Voronoi cells (construct_Voronoi_cells) ---------------
    nC_mem = max(mesh.nC_mem + 3, int(mesh.niTri.max()) + 3)
    nVVor = np.zeros(mesh.nV, dtype=np.int64)
    VVor = np.full((mesh.nV, nC_mem), -1, dtype=np.int64)
    for vi in range(mesh.nV):
        ni = int(mesh.niTri[vi])
        tis = ti2vori[mesh.iTri[vi, :ni]]
        vbi = mesh.VBI[vi]
        if vbi == 0:
            nVVor[vi] = ni
            VVor[vi, :ni] = tis
            continue
        ei_clock = mesh.VE[vi, mesh.nC[vi] - 1]
        ei_count = mesh.VE[vi, 0]
        if vbi in (_N, _E, _S, _W):
            nVVor[vi] = ni + 2
            VVor[vi, 0] = ei2vori[ei_count]
            VVor[vi, 1:ni + 1] = tis
            VVor[vi, ni + 1] = ei2vori[ei_clock]
        else:                                   # corner vertex
            nVVor[vi] = ni + 3
            VVor[vi, 0] = ei2vori[ei_count]
            VVor[vi, 1:ni + 1] = tis
            VVor[vi, ni + 1] = ei2vori[ei_clock]
            VVor[vi, ni + 2] = vi2vori[vi]

    return {"nVor": nVor, "vi2vori": vi2vori, "ti2vori": ti2vori,
            "ei2vori": ei2vori, "vori2vi": vori2vi, "vori2ti": vori2ti,
            "vori2ei": vori2ei, "Vor": Vor, "VornC": VornC, "VorC": VorC,
            "nVVor": nVVor, "VVor": VVor}
