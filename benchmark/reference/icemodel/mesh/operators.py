"""Mesh discretisation matrix operators (host build; device apply in ops/).

Re-design of src/UPSY/mesh/discretisation/mesh_disc_calc_matrix_operators_2D
.f90: builds the map/ddx/ddy operators between the a-grid (vertices), b-grid
(triangles) (and 2nd-order M2_* on the b-grid) from batched least-squares
shape functions. Neighbourhoods are the same as the reference's
(direct mesh neighbours, ring-extended for rows whose normal matrix is
singular or under-determined); assembly is vectorised numpy into scipy CSR,
then converted to padded ELL device arrays by ops/sparse.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .shape_functions import (shape_functions_2D_reg_1st_order,
                              shape_functions_2D_reg_2nd_order,
                              shape_functions_2D_stag_1st_order)


def _pad_gather(idx_lists, pad_to=None):
    """List of per-row index arrays -> padded [N,K] int array with -1 pad."""
    K = pad_to or max((len(l) for l in idx_lists), default=1)
    out = np.full((len(idx_lists), K), -1, dtype=np.int64)
    for i, l in enumerate(idx_lists):
        out[i, :len(l)] = l[:K]
    return out


def _row_unique(idx: np.ndarray, exclude=None) -> np.ndarray:
    """Per-row dedupe of a padded index array [N,K] (-1 = pad), vectorised.

    Keeps first occurrence order not guaranteed; returns sorted-unique rows
    padded with -1. Optionally removes `exclude[n]` from row n.
    """
    big = np.iinfo(np.int64).max
    work = np.where(idx < 0, big, idx)
    if exclude is not None:
        work = np.where(work == exclude[:, None], big, work)
    work = np.sort(work, axis=1)
    dup = np.zeros_like(work, dtype=bool)
    dup[:, 1:] = work[:, 1:] == work[:, :-1]
    work = np.where(dup, big, work)
    work = np.sort(work, axis=1)
    # trim all-pad columns
    ncol = int((work < big).sum(axis=1).max()) if work.size else 1
    work = work[:, :max(ncol, 1)]
    return np.where(work == big, -1, work)


def _csr_from_padded(n_rows, n_cols, cols, vals, centre=None):
    """Assemble scipy CSR from padded cols [N,K], vals [N,K] (+diagonal)."""
    rows = np.broadcast_to(np.arange(n_rows)[:, None], cols.shape)
    m = cols >= 0
    r, c, v = rows[m], cols[m], vals[m]
    if centre is not None:
        r = np.concatenate([r, np.arange(n_rows)])
        c = np.concatenate([c, np.arange(n_rows)])
        v = np.concatenate([v, centre])
    A = sp.csr_matrix((v, (r, c)), shape=(n_rows, n_cols))
    A.sum_duplicates()
    return A


@dataclass
class MeshOperators:
    """All 2-D matrix operators between the mesh grids (scipy CSR)."""
    M_ddx_a_a: sp.csr_matrix
    M_ddy_a_a: sp.csr_matrix
    M_map_a_b: sp.csr_matrix
    M_ddx_a_b: sp.csr_matrix
    M_ddy_a_b: sp.csr_matrix
    M_map_b_a: sp.csr_matrix
    M_ddx_b_a: sp.csr_matrix
    M_ddy_b_a: sp.csr_matrix
    M_ddx_b_b: sp.csr_matrix
    M_ddy_b_b: sp.csr_matrix
    M2_ddx_b_b: sp.csr_matrix
    M2_ddy_b_b: sp.csr_matrix
    M2_d2dx2_b_b: sp.csr_matrix
    M2_d2dxdy_b_b: sp.csr_matrix
    M2_d2dy2_b_b: sp.csr_matrix
    # c-grid (edge) operators
    M_map_a_c: Optional[sp.csr_matrix] = None
    M_map_b_c: Optional[sp.csr_matrix] = None


def _extend_ring_vertices(mesh, nbrs):
    """One ring extension on the a-grid: add neighbours-of-neighbours."""
    C = mesh.C
    K = nbrs.shape[1]
    ext = np.where(nbrs[:, :, None] >= 0,
                   C[np.maximum(nbrs, 0)], -1).reshape(len(nbrs), -1)
    allidx = np.concatenate([nbrs, ext], axis=1)
    return _row_unique(allidx, exclude=np.arange(len(nbrs)))


def _extend_ring_triangles(TriC, nbrs, self_idx):
    ext = np.where(nbrs[:, :, None] >= 0,
                   TriC[np.maximum(nbrs, 0)], -1).reshape(len(nbrs), -1)
    allidx = np.concatenate([nbrs, ext], axis=1)
    return _row_unique(allidx, exclude=self_idx)


def _offsets(targets, sources, nbrs):
    """dx, dy, mask for padded neighbourhoods."""
    mask = nbrs >= 0
    sx = sources[np.maximum(nbrs, 0), 0]
    sy = sources[np.maximum(nbrs, 0), 1]
    dx = np.where(mask, sx - targets[:, 0:1], 0.0)
    dy = np.where(mask, sy - targets[:, 1:2], 0.0)
    return dx, dy, mask


def _retry_extend(mesh, build_fn, nbrs, extend_fn, max_extends=4):
    """Run build_fn on neighbourhoods; ring-extend failed rows until ok."""
    result = build_fn(nbrs)
    ok = result[-1]
    n_ext = 0
    while not ok.all() and n_ext < max_extends:
        n_ext += 1
        ext = extend_fn(nbrs)
        # only failed rows get the extended neighbourhood
        K = max(nbrs.shape[1], ext.shape[1])
        nbrs_p = np.pad(nbrs, ((0, 0), (0, K - nbrs.shape[1])),
                        constant_values=-1)
        ext_p = np.pad(ext, ((0, 0), (0, K - ext.shape[1])),
                       constant_values=-1)
        nbrs = np.where(ok[:, None], nbrs_p, ext_p)
        result = build_fn(nbrs)
        ok = result[-1]
    if not ok.all():
        bad = np.where(~ok)[0]
        raise RuntimeError(f"shape functions singular for rows {bad[:10]}...")
    return result, nbrs


def build_all_matrix_operators(mesh) -> MeshOperators:
    """Build all 2-D operators for a mesh (reference
    calc_all_matrix_operators_mesh, mesh_disc_calc_matrix_operators_2D.f90:26)."""
    V, Tri = mesh.V, mesh.Tri
    # b-grid target points are the triangle geometric centres (reference
    # uses mesh%TriGC, mesh_disc_calc_matrix_operators_2D.f90:266,543)
    TriGC = mesh.TriGC
    nV, nTri = mesh.nV, mesh.nTri

    # ---- a_a: ddx/ddy at vertices from vertex neighbours (reg 1st) --------
    def build_aa(nbrs):
        dx, dy, m = _offsets(V, V, nbrs)
        return shape_functions_2D_reg_1st_order(dx, dy, m)

    (fxi, fyi, fxc, fyc, _), nbrs_aa = _retry_extend(
        mesh, build_aa, mesh.C.copy(), lambda nb: _extend_ring_vertices(mesh, nb))
    M_ddx_a_a = _csr_from_padded(nV, nV, nbrs_aa, fxc, centre=fxi)
    M_ddy_a_a = _csr_from_padded(nV, nV, nbrs_aa, fyc, centre=fyi)

    # ---- a_b: map/ddx/ddy at triangles from their vertices (stag 1st) -----
    def build_ab(nbrs):
        dx, dy, m = _offsets(TriGC, V, nbrs)
        return shape_functions_2D_stag_1st_order(dx, dy, m)

    def extend_ab(nbrs):
        ext = np.where(nbrs[:, :, None] >= 0,
                       mesh.C[np.maximum(nbrs, 0)], -1).reshape(len(nbrs), -1)
        return _row_unique(np.concatenate([nbrs, ext], axis=1))

    (f_ab, fx_ab, fy_ab, _), nbrs_ab = _retry_extend(
        mesh, build_ab, Tri.copy(), extend_ab)
    M_map_a_b = _csr_from_padded(nTri, nV, nbrs_ab, f_ab)
    M_ddx_a_b = _csr_from_padded(nTri, nV, nbrs_ab, fx_ab)
    M_ddy_a_b = _csr_from_padded(nTri, nV, nbrs_ab, fy_ab)

    # ---- b_a: map/ddx/ddy at vertices from surrounding triangles ----------
    def build_ba(nbrs):
        dx, dy, m = _offsets(V, TriGC, nbrs)
        return shape_functions_2D_stag_1st_order(dx, dy, m)

    def extend_ba(nbrs):
        ext = np.where(nbrs[:, :, None] >= 0,
                       mesh.TriC[np.maximum(nbrs, 0)], -1).reshape(len(nbrs), -1)
        return _row_unique(np.concatenate([nbrs, ext], axis=1))

    (f_ba, fx_ba, fy_ba, _), nbrs_ba = _retry_extend(
        mesh, build_ba, mesh.iTri.copy(), extend_ba)
    M_map_b_a = _csr_from_padded(nV, nTri, nbrs_ba, f_ba)
    M_ddx_b_a = _csr_from_padded(nV, nTri, nbrs_ba, fx_ba)
    M_ddy_b_a = _csr_from_padded(nV, nTri, nbrs_ba, fy_ba)

    # ---- b_b: ddx/ddy at triangles from neighbour triangles (reg 1st) -----
    self_tri = np.arange(nTri)

    def build_bb(nbrs):
        dx, dy, m = _offsets(TriGC, TriGC, nbrs)
        return shape_functions_2D_reg_1st_order(dx, dy, m)

    (fxi_b, fyi_b, fxc_b, fyc_b, _), nbrs_bb = _retry_extend(
        mesh, build_bb, mesh.TriC.copy(),
        lambda nb: _extend_ring_triangles(mesh.TriC, nb, self_tri))
    M_ddx_b_b = _csr_from_padded(nTri, nTri, nbrs_bb, fxc_b, centre=fxi_b)
    M_ddy_b_b = _csr_from_padded(nTri, nTri, nbrs_bb, fyc_b, centre=fyi_b)

    # ---- b_b 2nd order: M2 operators (reg 2nd, needs >= 5 neighbours) -----
    nbrs2 = _extend_ring_triangles(mesh.TriC, mesh.TriC.copy(), self_tri)
    # ensure at least 5 neighbours everywhere: extend again where short
    short = (nbrs2 >= 0).sum(1) < 5
    if short.any():
        nbrs2e = _extend_ring_triangles(mesh.TriC, nbrs2, self_tri)
        K = nbrs2e.shape[1]
        nbrs2 = np.where(short[:, None],
                         nbrs2e,
                         np.pad(nbrs2, ((0, 0), (0, K - nbrs2.shape[1])),
                                constant_values=-1))

    def build_bb2(nbrs):
        dx, dy, m = _offsets(TriGC, TriGC, nbrs)
        return shape_functions_2D_reg_2nd_order(dx, dy, m)

    (centre2, coeffs2, _), nbrs_bb2 = _retry_extend(
        mesh, build_bb2, nbrs2,
        lambda nb: _extend_ring_triangles(mesh.TriC, nb, self_tri))
    names = ["M2_ddx_b_b", "M2_ddy_b_b", "M2_d2dx2_b_b", "M2_d2dxdy_b_b",
             "M2_d2dy2_b_b"]
    M2 = {nm: _csr_from_padded(nTri, nTri, nbrs_bb2, coeffs2[:, p, :],
                               centre=centre2[:, p])
          for p, nm in enumerate(names)}

    return MeshOperators(
        M_ddx_a_a=M_ddx_a_a, M_ddy_a_a=M_ddy_a_a,
        M_map_a_b=M_map_a_b, M_ddx_a_b=M_ddx_a_b, M_ddy_a_b=M_ddy_a_b,
        M_map_b_a=M_map_b_a, M_ddx_b_a=M_ddx_b_a, M_ddy_b_a=M_ddy_b_a,
        M_ddx_b_b=M_ddx_b_b, M_ddy_b_b=M_ddy_b_b,
        **M2,
    )
