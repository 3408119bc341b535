"""Iso-contour polylines of a gridded field (marching squares, numpy only).

Mesh creation reduces the gridded ice geometry to polygons and
polylines (grounded/floating masks, grounding line, calving front, ice
front, coastline). This module extracts them without any plotting
library: every grid edge whose end values straddle the level gets one
linearly interpolated crossing point, every grid cell joins its crossings
into one or two segments (saddles are resolved by the cell-centre mean),
and the segments are chained into polylines. Each crossing belongs to at
most two segments, so the chains are simple paths or closed loops.
"""

from __future__ import annotations

import numpy as np


def contour_lines(x, y, F, level):
    """Polylines of F [nx, ny] (on grid lines x [nx], y [ny]) at `level`.

    Returns a list of [n, 2] arrays with n >= 2; a closed loop repeats its
    first point at the end."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    F = np.asarray(F, np.float64)
    nx, ny = F.shape
    if nx < 2 or ny < 2:
        return []
    above = F > level

    # crossing point on every grid edge (NaN where the edge is not crossed)
    def _cross(Fa, Fb, pa, pb):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (level - Fa) / (Fb - Fa)
        return pa + np.clip(t, 0.0, 1.0) * (pb - pa)

    # horizontal edges (i,j)-(i+1,j): id = i*ny + j
    hx = _cross(F[:-1, :], F[1:, :], x[:-1, None], x[1:, None])
    hy = np.broadcast_to(y[None, :], hx.shape)
    n_h = (nx - 1) * ny
    # vertical edges (i,j)-(i,j+1): id = n_h + i*(ny-1) + j
    vy = _cross(F[:, :-1], F[:, 1:], y[None, :-1], y[None, 1:])
    vx = np.broadcast_to(x[:, None], vy.shape)
    px = np.concatenate([hx.ravel(), vx.ravel()])
    py = np.concatenate([hy.ravel(), vy.ravel()])

    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    e_bot = ii * ny + jj
    e_top = ii * ny + jj + 1
    e_lef = n_h + ii * (ny - 1) + jj
    e_rig = n_h + (ii + 1) * (ny - 1) + jj
    a, b = above[:-1, :-1], above[1:, :-1]
    c, d = above[1:, 1:], above[:-1, 1:]
    f_bot, f_rig, f_top, f_lef = a != b, b != c, d != c, a != d
    ncross = (f_bot.astype(int) + f_rig.astype(int)
              + f_top.astype(int) + f_lef.astype(int))

    segs = []
    two = ncross == 2
    if two.any():
        E = np.stack([e_bot[two], e_rig[two], e_top[two], e_lef[two]])
        Fl = np.stack([f_bot[two], f_rig[two], f_top[two], f_lef[two]])
        order = np.argsort(~Fl, axis=0, kind="stable")
        Es = np.take_along_axis(E, order, axis=0)
        segs.append(np.stack([Es[0], Es[1]], axis=1))
    four = ncross == 4
    if four.any():
        centre = 0.25 * (F[:-1, :-1] + F[1:, :-1] + F[1:, 1:] + F[:-1, 1:])
        joined_ac = (centre > level)[four] == a[four]
        eb, er, et, el = e_bot[four], e_rig[four], e_top[four], e_lef[four]
        # a and c joined through the centre: cut off corners b and d;
        # otherwise cut off corners a and c
        s1 = np.where(joined_ac[:, None], np.stack([eb, er], 1),
                      np.stack([eb, el], 1))
        s2 = np.where(joined_ac[:, None], np.stack([et, el], 1),
                      np.stack([er, et], 1))
        segs += [s1, s2]
    if not segs:
        return []
    seg = np.concatenate(segs)

    # chain the segments: nodes are edge ids, each of degree <= 2
    nodes, inv = np.unique(seg.ravel(), return_inverse=True)
    seg = inv.reshape(-1, 2)
    n_nodes = len(nodes)
    nbr = -np.ones((n_nodes, 2), np.int64)
    deg = np.zeros(n_nodes, np.int64)
    for u, v in seg:
        nbr[u, deg[u]] = v
        deg[u] += 1
        nbr[v, deg[v]] = u
        deg[v] += 1
    P = np.stack([px[nodes], py[nodes]], axis=1)
    seen = np.zeros(n_nodes, bool)

    def _walk(start):
        path = [start]
        seen[start] = True
        prev, cur = -1, start
        while True:
            n0, n1 = nbr[cur]
            nxt = n0 if prev < 0 else (n1 if n0 == prev else n0)
            if nxt < 0:
                return path, False
            if nxt == start:
                return path, True
            if seen[nxt]:
                return path, False
            path.append(nxt)
            seen[nxt] = True
            prev, cur = cur, nxt

    lines = []
    for s in np.flatnonzero(deg == 1):          # open chains first
        if not seen[s]:
            path, _ = _walk(s)
            lines.append(P[path])
    for s in range(n_nodes):                    # what is left are loops
        if not seen[s]:
            path, closed = _walk(s)
            if closed:
                path = path + [path[0]]
            lines.append(P[path])
    return [l for l in lines if len(l) >= 2]
