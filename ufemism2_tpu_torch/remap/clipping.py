"""Batched convex-polygon clipping (vectorised Sutherland-Hodgman).

The geometric engine behind conservative remapping: all remap cell pairs
(Voronoi cells, triangles, grid cells) are convex polygons, so exact
overlap areas and first moments come from convex-convex clipping -
replacing the reference's ~9k LoC of line-tracing integration
(src/UPSY/mesh/remapping/line_tracing_*.f90) with one vectorised kernel.

Polygons are padded [N, K, 2] arrays with vertex counts nv [N]; all
operations broadcast over the pair batch.
"""

from __future__ import annotations

import numpy as np

def _quiet(fn):
    """Padded (invalid) polygon lanes legitimately hold garbage that the
    np.where masks discard; suppress the spurious FP warnings they
    raise."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with np.errstate(invalid="ignore", over="ignore",
                         divide="ignore"):
            return fn(*a, **kw)
    return wrapped


@_quiet
def polygon_areas_centroids(polys: np.ndarray, nv: np.ndarray):
    """Shoelace areas + centroids of padded CCW polygons [N,K,2]."""
    N, K, _ = polys.shape
    ks = np.arange(K)
    valid = ks[None, :] < nv[:, None]
    # next vertex index (wrap at nv)
    nxt = np.where(ks[None, :] + 1 < nv[:, None], ks[None, :] + 1, 0)
    x = polys[..., 0]
    y = polys[..., 1]
    xn = np.take_along_axis(x, nxt, axis=1)
    yn = np.take_along_axis(y, nxt, axis=1)
    cross = np.where(valid, x * yn - xn * y, 0.0)
    A = 0.5 * cross.sum(axis=1)
    Asafe = np.where(np.abs(A) < 1e-300, 1e-300, A)
    cx = np.where(valid, (x + xn) * cross, 0.0).sum(axis=1) / (6 * Asafe)
    cy = np.where(valid, (y + yn) * cross, 0.0).sum(axis=1) / (6 * Asafe)
    ctr = np.stack([cx, cy], axis=1)
    small = np.abs(A) < 1e-300
    if small.any():
        # degenerate: centroid = mean of valid vertices
        w = valid[small][..., None].astype(np.float64)
        pts = np.nan_to_num(polys[small])
        ctr[small] = (pts * w).sum(1) / np.maximum(w.sum(1), 1)
    return A, ctr


@_quiet
def clip_convex(subject: np.ndarray, nv_s: np.ndarray,
                clipper: np.ndarray, nv_c: np.ndarray):
    """Clip convex subject polygons by convex clipper polygons (batched).

    subject: [N,Ks,2] CCW; clipper: [N,Kc,2] CCW. Returns (out [N,Ko,2],
    nv_out [N]) with Ko = Ks + Kc.
    """
    N, Ks, _ = subject.shape
    Kc = clipper.shape[1]
    Ko = Ks + Kc
    out = np.zeros((N, Ko, 2))
    out[:, :Ks] = subject
    nv = nv_s.copy()

    ks = np.arange(Kc)
    for ci in range(Kc):
        active = ci < nv_c
        # clip edge: clipper[ci] -> clipper[(ci+1) % nv_c]
        nxt = np.where(ci + 1 < nv_c, ci + 1, 0)
        e0 = clipper[np.arange(N), ci]
        e1 = clipper[np.arange(N), nxt]
        ex = e1[:, 0] - e0[:, 0]
        ey = e1[:, 1] - e0[:, 1]

        ko = np.arange(Ko)
        valid = ko[None, :] < nv[:, None]
        x = out[..., 0]
        y = out[..., 1]
        # signed distance: positive = inside (left of CCW edge)
        d = ex[:, None] * (y - e0[:, 1][:, None]) \
            - ey[:, None] * (x - e0[:, 0][:, None])
        nxt_k = np.where(ko[None, :] + 1 < nv[:, None], ko[None, :] + 1, 0)
        d_n = np.take_along_axis(d, nxt_k, axis=1)
        x_n = np.take_along_axis(x, nxt_k, axis=1)
        y_n = np.take_along_axis(y, nxt_k, axis=1)

        inside = d >= 0
        inside_n = d_n >= 0

        # each input vertex emits up to 2 output vertices:
        #  - the vertex itself if inside
        #  - the intersection if the edge (v, v_next) crosses the clip line
        denom = d - d_n
        denom = np.where(np.abs(denom) < 1e-300, 1e-300, denom)
        t = d / denom
        ix = x + t * (x_n - x)
        iy = y + t * (y_n - y)

        emit_v = inside & valid
        emit_i = (inside != inside_n) & valid

        # interleave: position 2k = vertex, 2k+1 = intersection
        emits = np.zeros((N, 2 * Ko), dtype=bool)
        emits[:, 0::2] = emit_v
        emits[:, 1::2] = emit_i
        ex_pts = np.zeros((N, 2 * Ko, 2))
        ex_pts[:, 0::2, 0] = x
        ex_pts[:, 0::2, 1] = y
        ex_pts[:, 1::2, 0] = ix
        ex_pts[:, 1::2, 1] = iy

        # compact emitted points to the left (stable)
        idx_sort = np.argsort(~emits, axis=1, kind="stable")
        emits_sorted = np.take_along_axis(emits, idx_sort, axis=1)
        pts_sorted = np.take_along_axis(
            ex_pts, idx_sort[..., None].repeat(2, axis=2), axis=1)
        n_new = emits_sorted.sum(axis=1)
        n_new = np.minimum(n_new, Ko)

        new_out = pts_sorted[:, :Ko]
        # rows where this clip edge is inactive keep previous polygon
        keep = ~active
        new_out[keep] = out[keep]
        n_new[keep] = nv[keep]
        out = new_out
        nv = n_new

    return out, nv


def pad_polygons(poly_list):
    """List of [k,2] arrays -> padded [N,K,2] + nv [N]."""
    K = max((len(p) for p in poly_list), default=1)
    N = len(poly_list)
    out = np.zeros((N, K, 2))
    nv = np.zeros(N, dtype=np.int64)
    for i, p in enumerate(poly_list):
        out[i, :len(p)] = p
        nv[i] = len(p)
    return out, nv
