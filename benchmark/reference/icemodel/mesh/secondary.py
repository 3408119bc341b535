"""Secondary mesh data: Voronoi cells, areas, connection widths, resolution.

Re-derivation of the reference's mesh_secondary.f90 (Voronoi areas/centres,
connection widths Cw, lengths D) and mesh_utilities.f90 Voronoi-cell
construction, vectorised in numpy. Voronoi cells are clipped to the
rectangular domain (the reference guarantees circumcentres in-domain and
extends border cells to the boundary; calc_Voronoi_cell_border).
"""

from __future__ import annotations

import numpy as np


def clip_polygon_to_rect(poly: np.ndarray, xmin, xmax, ymin, ymax) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon [n,2] to a rectangle."""
    def clip_edge(pts, inside, intersect):
        if len(pts) == 0:
            return pts
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            ci, ni = inside(cur), inside(nxt)
            if ci:
                out.append(cur)
                if not ni:
                    out.append(intersect(cur, nxt))
            elif ni:
                out.append(intersect(cur, nxt))
        return np.array(out) if out else np.zeros((0, 2))

    def ix_x(x0):
        def f(p, q):
            t = (x0 - p[0]) / (q[0] - p[0])
            return np.array([x0, p[1] + t * (q[1] - p[1])])
        return f

    def ix_y(y0):
        def f(p, q):
            t = (y0 - p[1]) / (q[1] - p[1])
            return np.array([p[0] + t * (q[0] - p[0]), y0])
        return f

    poly = clip_edge(poly, lambda p: p[0] >= xmin, ix_x(xmin))
    poly = clip_edge(poly, lambda p: p[0] <= xmax, ix_x(xmax))
    poly = clip_edge(poly, lambda p: p[1] >= ymin, ix_y(ymin))
    poly = clip_edge(poly, lambda p: p[1] <= ymax, ix_y(ymax))
    return poly


def polygon_area_centroid(poly: np.ndarray):
    """Shoelace area + centroid of polygon [n,2]."""
    if len(poly) < 3:
        return 0.0, np.zeros(2)
    x, y = poly[:, 0], poly[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    A = 0.5 * cross.sum()
    if abs(A) < 1e-300:
        return 0.0, poly.mean(axis=0)
    cx = ((x + xn) * cross).sum() / (6 * A)
    cy = ((y + yn) * cross).sum() / (6 * A)
    return abs(A), np.array([cx, cy])


def voronoi_cell_vertices(conn, Tricc, vi, xmin, xmax, ymin, ymax):
    """CCW polygon of the Voronoi cell of vertex vi, clipped to the domain.

    Interior vertex: circumcentres of surrounding triangles (CCW).
    Border vertex: circumcentres + projections onto the border + (for
    corners) the domain corner (reference calc_Voronoi_cell_border).
    Implemented as: circumcentre polygon extended by the vertex's own border
    projections, then rect-clipped (equivalent, and robust).
    """
    V = conn.V
    ni = conn.niTri[vi]
    ccs = Tricc[conn.iTri[vi, :ni]]
    if conn.VBI[vi] == 0:
        return clip_polygon_to_rect(ccs, xmin, xmax, ymin, ymax)

    # Border vertex: iTri is CCW sorted starting after the exterior gap, so
    # C[0] and C[nC-1] are the two border neighbours. Close the cell with
    # the projections of the first/last circumcentre onto the border shared
    # with that neighbour (pushed outward by dx; clipping brings it back),
    # plus the outward corner point for corner vertices
    # (reference calc_Voronoi_cell_border).
    p = V[vi]
    dx = 0.1 * max(xmax - xmin, ymax - ymin)
    tol = 1e-9 * max(xmax - xmin, ymax - ymin)

    def border_proj(point, nbr):
        q = V[nbr]
        # border shared by vi and this neighbour
        if abs(p[0] - xmin) < tol and abs(q[0] - xmin) < tol:
            return np.array([xmin - dx, point[1]])
        if abs(p[0] - xmax) < tol and abs(q[0] - xmax) < tol:
            return np.array([xmax + dx, point[1]])
        if abs(p[1] - ymin) < tol and abs(q[1] - ymin) < tol:
            return np.array([point[0], ymin - dx])
        return np.array([point[0], ymax + dx])

    nC = conn.nC[vi]
    first = border_proj(ccs[0], conn.C[vi, 0])
    last = border_proj(ccs[ni - 1], conn.C[vi, nC - 1])
    pts = [first] + list(ccs) + [last]
    vbi = conn.VBI[vi]
    if vbi in (2, 4, 6, 8):  # corner vertex: add the outward corner point
        cx = xmax + dx if vbi in (2, 4) else xmin - dx
        cy = ymax + dx if vbi in (2, 8) else ymin - dx
        pts.append(np.array([cx, cy]))
    poly = np.asarray(pts)
    return clip_polygon_to_rect(poly, xmin, xmax, ymin, ymax)


def calc_voronoi_areas_centres(conn, Tricc, xmin, xmax, ymin, ymax):
    """Voronoi cell areas A[nV] and geometric centres VorGC[nV,2]."""
    nV = len(conn.V)
    A = np.zeros(nV)
    GC = np.zeros((nV, 2))
    for vi in range(nV):
        poly = voronoi_cell_vertices(conn, Tricc, vi, xmin, xmax, ymin, ymax)
        a, gc = polygon_area_centroid(poly)
        A[vi] = a
        GC[vi] = gc
    return A, GC


def calc_connection_widths(conn, Tricc, xmin, xmax, ymin, ymax):
    """Cw[nV,nC_mem]: length of shared Voronoi boundary per connection.

    The shared Voronoi boundary of edge ei is the segment between the
    circumcentres of its two adjacent triangles (clipped to the domain); for
    border edges, between the one circumcentre and the edge midpoint
    (reference find_shared_Voronoi_boundary).
    """
    nE = conn.nE
    EV, ETri, E = conn.EV, conn.ETri, conn.E
    til = ETri[:, 0]
    tir = ETri[:, 1]
    has_l = til >= 0
    has_r = tir >= 0
    p = np.where(has_l[:, None], Tricc[np.maximum(til, 0)], E)
    q = np.where(has_r[:, None], Tricc[np.maximum(tir, 0)], E)
    # clamp endpoints into the domain (circumcentres should be inside for a
    # well-refined mesh; safety for slivers)
    p = np.clip(p, [xmin, ymin], [xmax, ymax])
    q = np.clip(q, [xmin, ymin], [xmax, ymax])
    Lc_e = np.linalg.norm(p - q, axis=1)

    Cw = np.zeros_like(conn.C, dtype=np.float64)
    valid = conn.VE >= 0
    Cw[valid] = Lc_e[conn.VE[valid]]
    return Cw, Lc_e


def calc_connection_lengths(conn):
    """D_x, D_y, D [nV,nC_mem] between connected vertices."""
    V, C = conn.V, conn.C
    valid = C >= 0
    Cx = np.where(valid, V[np.maximum(C, 0), 0], 0.0)
    Cy = np.where(valid, V[np.maximum(C, 0), 1], 0.0)
    D_x = np.where(valid, Cx - V[:, 0:1], 0.0)
    D_y = np.where(valid, Cy - V[:, 1:2], 0.0)
    D = np.sqrt(D_x ** 2 + D_y ** 2)
    D[~valid] = 1.0  # avoid div-by-zero on padding
    return D_x, D_y, D


def calc_resolution(conn):
    """R[nV]: shortest connection length per vertex (calc_mesh_resolution)."""
    _, _, D = calc_connection_lengths(conn)
    Dm = np.where(conn.C >= 0, D, np.inf)
    return Dm.min(axis=1)


def calc_voronoi_areas_centres_fast(conn, Tricc, xmin, xmax, ymin, ymax):
    """Vectorised exact Voronoi areas/centroids via edge-fan decomposition.

    The Voronoi cell of vertex vi is the fan of triangles
    (vi, p_e, q_e) over its incident Delaunay edges e, where (p_e, q_e) is
    the shared Voronoi boundary segment of e (circumcentres of the two
    adjacent triangles; edge midpoint for border edges). The domain-border
    path through vi contributes zero area, so the fan sum is exact for
    border and corner cells too (assuming in-domain circumcentres, which
    refinement guarantees).
    """
    V = conn.V
    EV, ETri, E = conn.EV, conn.ETri, conn.E
    has_l = ETri[:, 0] >= 0
    has_r = ETri[:, 1] >= 0
    p = np.where(has_l[:, None], Tricc[np.maximum(ETri[:, 0], 0)], E)
    q = np.where(has_r[:, None], Tricc[np.maximum(ETri[:, 1], 0)], E)
    p = np.clip(p, [xmin, ymin], [xmax, ymax])
    q = np.clip(q, [xmin, ymin], [xmax, ymax])

    nV = len(V)
    A = np.zeros(nV)
    Mx = np.zeros(nV)
    My = np.zeros(nV)
    for side in (0, 1):
        vi = EV[:, side]
        a = V[vi]
        cross = np.abs((p[:, 0] - a[:, 0]) * (q[:, 1] - a[:, 1])
                       - (p[:, 1] - a[:, 1]) * (q[:, 0] - a[:, 0])) * 0.5
        cx = (a[:, 0] + p[:, 0] + q[:, 0]) / 3.0
        cy = (a[:, 1] + p[:, 1] + q[:, 1]) / 3.0
        np.add.at(A, vi, cross)
        np.add.at(Mx, vi, cross * cx)
        np.add.at(My, vi, cross * cy)
    Asafe = np.maximum(A, 1e-300)
    GC = np.stack([Mx / Asafe, My / Asafe], axis=1)
    zero = A <= 0
    GC[zero] = V[zero]
    return A, GC
