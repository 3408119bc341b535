"""2nd-order conservative remapping between meshes and grids.

Re-design of src/UPSY/mesh/remapping/ (remapping_main.f90 + the
Voronoi/triangle/grid line tracers): the remap weights

  F_dst_i = 1/A_i * sum_j [ A_ij f_j + Jx_ij (df/dx)_j + Jy_ij (df/dy)_j ]

use exact overlap areas A_ij and first moments J_ij of cell
intersections, computed by batched convex clipping (clipping.py) instead
of boundary line integrals - mathematically identical (the reference's
line integrals LI_xdy/LI_mxydx/LI_xydy ARE these moments by Green's
theorem), but vectorised. The final operator is assembled as
M = W0 + Wx @ M_ddx_src + Wy @ M_ddy_src (the reference uses PETSc
MatMatMult, remapping_mesh_to_mesh.f90:2-23).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from .clipping import clip_convex, polygon_areas_centroids


# ---------------------------------------------------------------------------
# Cell polygon extraction
# ---------------------------------------------------------------------------

def mesh_voronoi_polygons(mesh):
    """Padded CCW Voronoi-cell polygons [nV, K, 2] + counts.

    Interior: circumcentres of surrounding triangles (CCW). Border: closed
    with border projections of first/last circumcentre and (corners) the
    domain corner (mesh_utilities.f90 calc_Voronoi_cell_border).
    """
    nV = mesh.nV
    ni = mesh.niTri
    K = int(ni.max()) + 3
    polys = np.zeros((nV, K, 2))
    nv = np.zeros(nV, dtype=np.int64)

    cc = np.clip(mesh.Tricc, [mesh.xmin, mesh.ymin], [mesh.xmax, mesh.ymax])
    # interior cells: straight gather
    gather = cc[np.maximum(mesh.iTri, 0)]
    ks = np.arange(mesh.iTri.shape[1])
    valid = ks[None, :] < ni[:, None]
    interior = mesh.VBI == 0
    polys[:, :mesh.iTri.shape[1]][valid] = gather[valid]
    nv[:] = ni

    # border cells: insert projections (small loop over border vertices)
    border_idx = np.where(~interior)[0]
    tol = 1e-9 * max(mesh.xmax - mesh.xmin, mesh.ymax - mesh.ymin)
    V = mesh.V
    for vi in border_idx:
        n = ni[vi]
        ccs = cc[mesh.iTri[vi, :n]]
        p = V[vi]

        def proj(point, nbr):
            q = V[nbr]
            if abs(p[0] - mesh.xmin) < tol and abs(q[0] - mesh.xmin) < tol:
                return np.array([mesh.xmin, point[1]])
            if abs(p[0] - mesh.xmax) < tol and abs(q[0] - mesh.xmax) < tol:
                return np.array([mesh.xmax, point[1]])
            if abs(p[1] - mesh.ymin) < tol and abs(q[1] - mesh.ymin) < tol:
                return np.array([point[0], mesh.ymin])
            return np.array([point[0], mesh.ymax])

        pts = [proj(ccs[0], mesh.C[vi, 0])] + list(ccs) \
            + [proj(ccs[n - 1], mesh.C[vi, mesh.nC[vi] - 1])]
        vbi = mesh.VBI[vi]
        if vbi in (2, 4, 6, 8):
            cx = mesh.xmax if vbi in (2, 4) else mesh.xmin
            cy = mesh.ymax if vbi in (2, 8) else mesh.ymin
            pts.append(np.array([cx, cy]))
        pts = np.asarray(pts)
        polys[vi, :len(pts)] = pts
        nv[vi] = len(pts)
    return polys, nv


def mesh_triangle_polygons(mesh):
    return mesh.V[mesh.Tri], np.full(mesh.nTri, 3, dtype=np.int64)


def grid_polygons(grid):
    return grid.cell_polygons(), np.full(grid.n, 4, dtype=np.int64)


# ---------------------------------------------------------------------------
# Weight construction
# ---------------------------------------------------------------------------

def _candidate_pairs(src_centres, src_radius, dst_centres, dst_radius):
    """(i_dst, j_src) candidate overlap pairs via KD-tree ball queries."""
    tree = cKDTree(src_centres)
    r = dst_radius + src_radius.max()
    lists = tree.query_ball_point(dst_centres, r)
    i = np.concatenate([np.full(len(l), k, dtype=np.int64)
                        for k, l in enumerate(lists)]) \
        if len(lists) else np.zeros(0, np.int64)
    j = np.concatenate([np.asarray(l, dtype=np.int64) for l in lists]) \
        if len(lists) else np.zeros(0, np.int64)
    return i, j


def _poly_radius(polys, nv, centres):
    ks = np.arange(polys.shape[1])
    valid = ks[None, :] < nv[:, None]
    d = np.linalg.norm(polys - centres[:, None, :], axis=2)
    return np.where(valid, d, 0.0).max(axis=1)


def build_overlap_weights(src_polys, src_nv, dst_polys, dst_nv,
                          chunk=200_000):
    """Exact overlap areas/moments for all candidate pairs.

    Returns (i_dst, j_src, A_ij, cx_ij, cy_ij) filtered to A > 0.
    """
    _, src_ctr = polygon_areas_centroids(src_polys, src_nv)
    _, dst_ctr = polygon_areas_centroids(dst_polys, dst_nv)
    r_src = _poly_radius(src_polys, src_nv, src_ctr)
    r_dst = _poly_radius(dst_polys, dst_nv, dst_ctr)
    ii, jj = _candidate_pairs(src_ctr, r_src, dst_ctr, r_dst)

    # drop pairs that cannot overlap
    d = np.linalg.norm(dst_ctr[ii] - src_ctr[jj], axis=1)
    keep = d <= (r_dst[ii] + r_src[jj])
    ii, jj = ii[keep], jj[keep]

    out_i, out_j, out_A, out_cx, out_cy = [], [], [], [], []
    for s0 in range(0, len(ii), chunk):
        s1 = min(len(ii), s0 + chunk)
        i_c, j_c = ii[s0:s1], jj[s0:s1]
        clipped, nv_c = clip_convex(src_polys[j_c], src_nv[j_c],
                                    dst_polys[i_c], dst_nv[i_c])
        A, ctr = polygon_areas_centroids(clipped, nv_c)
        pos = A > 1e-12 * np.maximum(1.0, np.abs(A).max())
        out_i.append(i_c[pos])
        out_j.append(j_c[pos])
        out_A.append(A[pos])
        out_cx.append(ctr[pos, 0])
        out_cy.append(ctr[pos, 1])
    if not out_i:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z, z, z
    return (np.concatenate(out_i), np.concatenate(out_j),
            np.concatenate(out_A), np.concatenate(out_cx),
            np.concatenate(out_cy))


def build_map_conservative(src_polys, src_nv, src_points,
                           dst_polys, dst_nv,
                           M_ddx_src=None, M_ddy_src=None,
                           second_order=True):
    """Conservative remap operator [n_dst, n_src] (scipy CSR).

    src_points: the locations where source values/gradients live (mesh
    vertices / triangle GCs / grid centres). M_ddx/ddy_src: source
    derivative operators (None -> 1st order).
    """
    n_src = len(src_nv)
    n_dst = len(dst_nv)
    i, j, A, cx, cy = build_overlap_weights(src_polys, src_nv,
                                            dst_polys, dst_nv)
    A_dst = np.zeros(n_dst)
    np.add.at(A_dst, i, A)
    A_dst = np.maximum(A_dst, 1e-300)

    w0 = A / A_dst[i]
    W0 = sp.csr_matrix((w0, (i, j)), shape=(n_dst, n_src))
    if not second_order or M_ddx_src is None:
        return W0

    wx = A * (cx - src_points[j, 0]) / A_dst[i]
    wy = A * (cy - src_points[j, 1]) / A_dst[i]
    Wx = sp.csr_matrix((wx, (i, j)), shape=(n_dst, n_src))
    Wy = sp.csr_matrix((wy, (i, j)), shape=(n_dst, n_src))
    M = (W0 + Wx @ M_ddx_src + Wy @ M_ddy_src).tocsr()
    return M


# ---------------------------------------------------------------------------
# Simple (non-conservative) maps
# ---------------------------------------------------------------------------

def build_map_nearest(src_points, dst_points, n_src):
    tree = cKDTree(src_points)
    _, j = tree.query(dst_points)
    i = np.arange(len(dst_points))
    return sp.csr_matrix((np.ones(len(i)), (i, j)),
                         shape=(len(dst_points), n_src))


def build_map_trilin_mesh_to_points(mesh, dst_points):
    """Barycentric (linear) interpolation from mesh vertices to points.

    The containing triangle is found exactly, with a trapezoid-map point
    locator's tie rule for points on edges and vertices
    (core/ice/bedrock_cdf.py find_containing_triangles_of_points; the
    reference's find_containing_triangle walk, mesh_utilities.f90);
    points outside the triangulation fall back to the nearest triangle's
    clipped barycentric weights."""
    from ..core.ice.bedrock_cdf import find_containing_triangles_of_points
    dst_points = np.asarray(dst_points, dtype=np.float64)
    t0 = find_containing_triangles_of_points(mesh.V, mesh.Tri, dst_points)
    outside = t0 < 0
    if outside.any():
        tree = cKDTree(mesh.TriGC)
        _, t_near = tree.query(dst_points[outside])
        t0 = t0.copy()
        t0[outside] = t_near
    tri = mesh.Tri[t0]
    a = mesh.V[tri[:, 0]]
    b = mesh.V[tri[:, 1]]
    c = mesh.V[tri[:, 2]]
    v0 = b - a
    v1 = c - a
    v2 = dst_points - a
    d00 = (v0 * v0).sum(1)
    d01 = (v0 * v1).sum(1)
    d11 = (v1 * v1).sum(1)
    d20 = (v2 * v0).sum(1)
    d21 = (v2 * v1).sum(1)
    den = np.maximum(d00 * d11 - d01 * d01, 1e-300)
    w1 = (d11 * d20 - d01 * d21) / den
    w2 = (d00 * d21 - d01 * d20) / den
    w0 = 1.0 - w1 - w2
    W = np.clip(np.stack([w0, w1, w2], 1), 0, 1)
    W = W / W.sum(1, keepdims=True)
    i = np.repeat(np.arange(len(dst_points)), 3)
    j = tri.ravel()
    return sp.csr_matrix((W.ravel(), (i, j)),
                         shape=(len(dst_points), mesh.nV))


def remap_vertical_1d(z_src, z_dst, F, conservative=True,
                      mask_src=None, mask_dst=None):
    """1-D vertical (ocean-column) remap.

    2nd-order conservative (reference interpolation.f90
    remap_cons_2nd_order_1D): source/destination points are treated as cell
    centres with boundaries at the midpoints (half-spacing extension at the
    ends); each dst cell averages the piecewise-linear source reconstruction
    (central slopes, one-sided at the boundaries) over the overlap regions,
    normalised by the total overlap; dst cells with no overlapping unmasked
    src cell fall back to nearest-neighbour. F may be [nz_src] or
    [..., nz_src] (batched over leading axes). With conservative=False a
    plain linear interpolation is used.
    """
    z_src = np.asarray(z_src, dtype=np.float64)
    z_dst = np.asarray(z_dst, dtype=np.float64)
    F = np.asarray(F, dtype=np.float64)
    if not conservative:
        return np.interp(z_dst, z_src, F) if F.ndim == 1 else np.stack(
            [np.interp(z_dst, z_src, f) for f in F.reshape(-1, F.shape[-1])]
        ).reshape(F.shape[:-1] + (len(z_dst),))

    nz_src, nz_dst = len(z_src), len(z_dst)
    msrc = (np.ones(nz_src, bool) if mask_src is None
            else np.asarray(mask_src).astype(bool))
    mdst = (np.ones(nz_dst, bool) if mask_dst is None
            else np.asarray(mask_dst).astype(bool))
    if not msrc.any() or not mdst.any():
        return np.zeros(F.shape[:-1] + (nz_dst,), dtype=F.dtype)

    def bounds(z):
        zl = np.empty(len(z))
        zu = np.empty(len(z))
        zl[1:] = 0.5 * (z[:-1] + z[1:])
        zl[0] = z[0] - 0.5 * (z[1] - z[0])
        zu[:-1] = zl[1:]
        zu[-1] = z[-1] + 0.5 * (z[-1] - z[-2])
        return zl, zu

    zl_s, zu_s = bounds(z_src)
    zl_d, zu_d = bounds(z_dst)

    # source slopes: central, one-sided at the ends
    ddz = np.empty(F.shape)
    ddz[..., 1:-1] = (F[..., 2:] - F[..., :-2]) / (z_src[2:] - z_src[:-2])
    ddz[..., 0] = (F[..., 1] - F[..., 0]) / (z_src[1] - z_src[0])
    ddz[..., -1] = (F[..., -1] - F[..., -2]) / (z_src[-1] - z_src[-2])

    # overlap matrix [nz_dst, nz_src]
    z_lo = np.maximum(zl_s[None, :], zl_d[:, None])
    z_hi = np.minimum(zu_s[None, :], zu_d[:, None])
    dz = np.maximum(0.0, z_hi - z_lo) * msrc[None, :]
    z_mid = 0.5 * (z_lo + z_hi)

    # piecewise-linear source value at the overlap midpoint
    d_mid = F[..., None, :] + ddz[..., None, :] * (z_mid - z_src[None, :])
    dz_tot = dz.sum(axis=1)
    d_int = (d_mid * dz).sum(axis=-1)

    out = np.zeros(F.shape[:-1] + (nz_dst,), dtype=F.dtype)
    has = dz_tot > 0
    out[..., has] = d_int[..., has] / dz_tot[has]
    # nearest-neighbour fallback for dst cells with no overlap
    no = mdst & ~has
    if no.any():
        src_idx = np.flatnonzero(msrc)
        near = src_idx[np.argmin(
            np.abs(z_dst[no][:, None] - z_src[src_idx][None, :]), axis=1)]
        out[..., no] = F[..., near]
    out[..., ~mdst] = 0.0
    return out
