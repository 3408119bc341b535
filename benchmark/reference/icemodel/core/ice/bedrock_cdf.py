"""Sub-grid bedrock cumulative density functions (host-side construction).

Re-design of src/UFEMISM/ice_dynamics/utilities/
bedrock_cumulative_density_functions.f90 (calc_bedrock_CDFs_a/_b): for every
vertex (Voronoi cell) and triangle, collect the raw-grid bedrock elevations
of the overlapping grid cells, sort them, and store nbins quantiles. The
reference finds the overlap through the conservative-remap operator; here
the vertex membership uses the exact Voronoi property (nearest vertex) via
a KD-tree, and triangle membership rasterises each triangle's bounding
box over the regular grid with an edge-side point-in-triangle test. Built
once per mesh on the host (numpy); the interpolation that runs every ice
step is in subgrid.py (device side).
"""

from __future__ import annotations

import numpy as np


def _quantile_cdfs(owner, vals, n_owners, nbins, fallback):
    """Per-owner sorted quantile sampling (vectorised over owners).

    owner: [N] int owner id per sample; vals: [N]; fallback: [n_owners]
    value used for owners with no samples. Returns [n_owners, nbins].
    Reproduces the reference's bin positions: bin i (0-based) sits at
    fractional sorted index (count-1) * i/(nbins-1).
    """
    order = np.lexsort((vals, owner))
    so = owner[order]
    sv = vals[order]
    ids = np.arange(n_owners)
    starts = np.searchsorted(so, ids, side="left")
    ends = np.searchsorted(so, ids, side="right")
    counts = ends - starts

    i = np.arange(nbins)
    isc = (np.maximum(counts, 1)[:, None] - 1) * i[None, :] / (nbins - 1)
    ii0 = np.floor(isc).astype(np.int64)
    ii1 = np.ceil(isc).astype(np.int64)
    w1 = isc - ii0
    hi = max(len(sv) - 1, 0)
    idx0 = np.clip(starts[:, None] + ii0, 0, hi)
    idx1 = np.clip(starts[:, None] + ii1, 0, hi)
    if len(sv) == 0:
        return np.broadcast_to(fallback[:, None], (n_owners, nbins)).copy()
    cdf = (1.0 - w1) * sv[idx0] + w1 * sv[idx1]
    empty = counts == 0
    if empty.any():
        cdf[empty] = fallback[empty, None]
    return cdf


def _edge_side(px, py, s, e, o):
    """Where the points (px, py) lie against the edge s-e of a triangle
    whose third corner is o. The edge runs from its lexicographically
    smaller end (x, then y) to the larger one, so that both triangles of
    an edge evaluate the identical expression. Returns (inside, on, above):
    strictly on the triangle's side, exactly on the edge's line, and
    whether the triangle lies to the left of the directed edge."""
    fwd = (e[:, 0] > s[:, 0]) | ((e[:, 0] == s[:, 0]) & (e[:, 1] > s[:, 1]))
    l = np.where(fwd[:, None], s, e)
    r = np.where(fwd[:, None], e, s)
    ex, ey = r[:, 0] - l[:, 0], r[:, 1] - l[:, 1]
    cz_p = (px - l[:, 0]) * ey - (py - l[:, 1]) * ex
    cz_o = (o[:, 0] - l[:, 0]) * ey - (o[:, 1] - l[:, 1]) * ex
    above = cz_o < 0
    return np.where(above, cz_p < 0, cz_p > 0), cz_p == 0, above


def _claim(P, tid, flat, px, py, own_vertex, own_left, own_right):
    """Record, for candidate pairs (triangle tid, point flat at (px, py)),
    which triangles contain their point, under the tie rule of
    `find_containing_triangles`; updates the three owner arrays."""
    a, b, c = P[tid, 0], P[tid, 1], P[tid, 2]
    hit = np.ones(len(tid), bool)
    left = np.ones(len(tid), bool)
    for s, e, o in ((a, b, c), (b, c, a), (c, a, b)):
        inside, on, above = _edge_side(px, py, s, e, o)
        hit &= inside | on
        left &= inside | above
    at_vertex = ((px == a[:, 0]) & (py == a[:, 1])) \
        | ((px == b[:, 0]) & (py == b[:, 1])) \
        | ((px == c[:, 0]) & (py == c[:, 1]))
    m = hit & at_vertex
    np.minimum.at(own_vertex, flat[m], tid[m])
    m = hit & ~at_vertex & left
    own_left[flat[m]] = tid[m]
    m = hit & ~at_vertex & ~left
    own_right[flat[m]] = tid[m]


_NONE = np.iinfo(np.int64).max


def _owners(n):
    return (np.full(n, _NONE, np.int64), -np.ones(n, np.int64),
            -np.ones(n, np.int64))


def _owner(own_vertex, own_left, own_right):
    owner = np.where(own_left >= 0, own_left, own_right)
    return np.where(own_vertex != _NONE, own_vertex, owner)


def find_containing_triangles(V, Tri, x_grid, y_grid, chunk=4096):
    """Index of the triangle containing each point of the regular grid
    (x_grid [nx], y_grid [ny]; points in 'ij' order, flattened), -1 where
    a point lies in no triangle. Every triangle tests only the grid points
    inside its bounding box, vectorised over chunks of triangles.

    A point on the boundary of several triangles goes to one of them by
    the rule of a trapezoid-map point location (the reference's lookup):
    a point on a mesh vertex to the lowest-numbered triangle around the
    vertex, a point on an edge to the triangle on the left of the edge
    directed from its smaller (x, y) end to its larger one, or to the
    edge's only triangle on the mesh boundary."""
    x_grid = np.asarray(x_grid, np.float64)
    y_grid = np.asarray(y_grid, np.float64)
    nx, ny = len(x_grid), len(y_grid)
    owners = _owners(nx * ny)
    P = V[Tri]                                        # [nTri,3,2]
    i0 = np.searchsorted(x_grid, P[:, :, 0].min(axis=1), side="left")
    i1 = np.searchsorted(x_grid, P[:, :, 0].max(axis=1), side="right")
    j0 = np.searchsorted(y_grid, P[:, :, 1].min(axis=1), side="left")
    j1 = np.searchsorted(y_grid, P[:, :, 1].max(axis=1), side="right")
    ni, nj = i1 - i0, j1 - j0
    n = ni * nj
    for t0 in range(0, len(Tri), chunk):
        ts = np.arange(t0, min(t0 + chunk, len(Tri)))
        ts = ts[n[ts] > 0]
        if len(ts) == 0:
            continue
        nt = n[ts]
        tid = np.repeat(ts, nt)
        within = np.arange(nt.sum()) - np.repeat(np.cumsum(nt) - nt, nt)
        ii = i0[tid] + within // nj[tid]
        jj = j0[tid] + within % nj[tid]
        _claim(P, tid, ii * ny + jj, x_grid[ii], y_grid[jj], *owners)
    return _owner(*owners)


def find_containing_triangles_of_points(V, Tri, pts, chunk=4096):
    """`find_containing_triangles` for arbitrary points [n, 2]: the same
    tie rule, each triangle testing the points inside its bounding box
    (found through a KD-tree of the points)."""
    from scipy.spatial import cKDTree
    pts = np.asarray(pts, np.float64)
    owners = _owners(len(pts))
    if len(pts) == 0:
        return _owner(*owners)
    P = V[Tri]
    lo, hi = P.min(axis=1), P.max(axis=1)
    ctr = 0.5 * (lo + hi)
    rad = 0.5 * np.hypot(hi[:, 0] - lo[:, 0], hi[:, 1] - lo[:, 1])
    rad = rad * (1.0 + 1e-9) + 1e-9 * np.abs(ctr).max()
    tree = cKDTree(pts)
    for t0 in range(0, len(Tri), chunk):
        ts = np.arange(t0, min(t0 + chunk, len(Tri)))
        lists = tree.query_ball_point(ctr[ts], rad[ts])
        nt = np.array([len(l) for l in lists])
        if nt.sum() == 0:
            continue
        tid = np.repeat(ts, nt)
        flat = np.concatenate([np.asarray(l, np.int64) for l in lists])
        px, py = pts[flat, 0], pts[flat, 1]
        box = (px >= lo[tid, 0]) & (px <= hi[tid, 0]) \
            & (py >= lo[tid, 1]) & (py <= hi[tid, 1])
        tid, flat, px, py = tid[box], flat[box], px[box], py[box]
        _claim(P, tid, flat, px, py, *owners)
    return _owner(*owners)


def calc_bedrock_cdfs(mesh, x_grid, y_grid, Hb_grid, nbins: int):
    """(cdf_a [nV,nbins], cdf_b [nTri,nbins]) from the raw bedrock grid.

    x_grid [nx], y_grid [ny], Hb_grid [nx,ny].
    """
    from scipy.spatial import cKDTree

    X, Y = np.meshgrid(x_grid, y_grid, indexing="ij")
    pts = np.column_stack([X.ravel(), Y.ravel()])
    vals = np.asarray(Hb_grid, dtype=np.float64).ravel()

    # vertices: Voronoi cell membership == nearest vertex
    tree = cKDTree(mesh.V)
    owner_v = tree.query(pts, k=1)[1]

    # fallback for cells with no samples: bedrock interpolated at the vertex
    from scipy.interpolate import RegularGridInterpolator
    interp = RegularGridInterpolator(
        (x_grid, y_grid), np.asarray(Hb_grid, np.float64),
        bounds_error=False, fill_value=None)
    Hb_v = interp(mesh.V)
    cdf_a = _quantile_cdfs(owner_v, vals, mesh.nV, nbins, Hb_v)

    # triangles: containing-triangle lookup
    owner_t = find_containing_triangles(mesh.V, mesh.Tri, x_grid, y_grid)
    inside = owner_t >= 0
    Hb_t = interp(mesh.Tricc) if hasattr(mesh, "Tricc") and \
        mesh.Tricc is not None else interp(mesh.V[mesh.Tri].mean(axis=1))
    cdf_b = _quantile_cdfs(owner_t[inside], vals[inside], mesh.nTri, nbins,
                           np.asarray(Hb_t))
    return cdf_a, cdf_b


def build_bedrock_cdfs_from_config(C, mesh, region: str):
    """Raw bedrock grid (idealised generator or geometry file) -> CDFs.
    Returns (cdf_a, cdf_b) or None when no raw grid is available
    (initialise_bedrock_CDFs, bedrock_cumulative_density_functions.f90:64).
    """
    nbins = C.subgrid_bedrock_cdf_nbins
    choice = getattr(C, f"choice_refgeo_init_{region}")
    if choice == "idealised":
        from ..idealised_geometries import generate_idealised_geometry_grid
        x, y, Hi, Hb, SL = generate_idealised_geometry_grid(C, region,
                                                            which="init")
        return calc_bedrock_cdfs(mesh, x, y, Hb, nbins)
    if choice == "read_from_file":
        # the initial-geometry file's bedrock grid; none where the file
        # cannot be read or holds no Hb (as the JAX package has it)
        from ...io.input_files import read_geometry_grid_raw
        try:
            x, y, fields = read_geometry_grid_raw(C, region, which="init")
        except (OSError, KeyError, ValueError):
            return None
        if "Hb" not in fields:
            return None
        return calc_bedrock_cdfs(mesh, x, y, fields["Hb"], nbins)
    return None
