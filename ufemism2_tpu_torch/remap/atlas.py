"""The remapping Atlas: find-or-create cache of remap operators.

Re-design of src/UPSY/mesh/remapping/remapping_main.f90 (the Atlas,
:23,:60-92): maps are keyed by (src id, dst id, method) and built on
first use; clear_all_maps_involving_this_mesh drops entries when a mesh
dies (apply_maps.f90).
"""

from __future__ import annotations

import itertools
import weakref

import numpy as np

from .conservative import (build_map_conservative, build_map_nearest,
                           build_map_trilin_mesh_to_points,
                           mesh_voronoi_polygons, mesh_triangle_polygons,
                           grid_polygons)


class Atlas:
    _uid_counter = itertools.count(1)

    def __init__(self):
        self._maps = {}

    def _id(self, obj):
        """Monotonic per-object UID. NOT id(obj): CPython reuses
        addresses after GC, so over a long run with mesh updates a new
        Mesh can inherit a dead mesh's id() and silently fetch its
        stale remap matrix (observed as a (1991)x(2013) matmul mismatch
        after about 20 remeshes of a MISMIP_mod run). A weakref
        finaliser purges a dead object's entries, bounding memory like
        the reference's clear_all_maps_involving_this_mesh
        (apply_maps.f90). A Grid is keyed by its axes instead, so that
        the input files on one x/y grid share one map onto a mesh; its
        maps go when their mesh dies."""
        from ..mesh.grids import Grid
        if isinstance(obj, Grid):
            return ("grid", obj.x.tobytes(), obj.y.tobytes(), obj.dx,
                    obj.dy)
        uid = getattr(obj, "_atlas_uid", None)
        if uid is None:
            uid = next(Atlas._uid_counter)
            try:
                object.__setattr__(obj, "_atlas_uid", uid)
            except (AttributeError, TypeError):
                # unweakrefable/frozen objects fall back to id() (grids
                # are plain classes in practice, so this path is cold)
                return id(obj)
            weakref.finalize(obj, self._purge_uid, uid)
        return uid

    def _purge_uid(self, uid):
        self._maps = {k: v for k, v in self._maps.items()
                      if uid not in (k[0], k[1])}

    def clear_all_maps_involving(self, obj):
        self._purge_uid(self._id(obj))

    def get(self, src, dst, method="2nd_order_conservative",
            src_grid_type="vertices"):
        key = (self._id(src), self._id(dst), method, src_grid_type)
        if key not in self._maps:
            self._maps[key] = _create_map(src, dst, method, src_grid_type)
        return self._maps[key]


_GLOBAL_ATLAS = Atlas()


def _polys_of(obj, grid_type="vertices"):
    from ..mesh.mesh_types import Mesh
    from ..mesh.grids import Grid
    if isinstance(obj, Grid):
        p, nv = grid_polygons(obj)
        Dx, Dy = _grid_gradient_operators(obj)
        return p, nv, obj.centres(), Dx, Dy
    if isinstance(obj, Mesh):
        if obj.operators is None:
            # gradient operators are required for the 2nd-order correction
            from ..mesh.operators import build_all_matrix_operators
            obj.operators = build_all_matrix_operators(obj)
        ops = obj.operators
        if grid_type == "vertices":
            p, nv = mesh_voronoi_polygons(obj)
            return p, nv, obj.V, ops.M_ddx_a_a, ops.M_ddy_a_a
        p, nv = mesh_triangle_polygons(obj)
        return p, nv, obj.TriGC, ops.M_ddx_b_b, ops.M_ddy_b_b
    raise TypeError(f"cannot remap from {type(obj)}")


def _grid_gradient_operators(grid):
    """Sparse d/dx, d/dy on the flattened [x-major] grid (central
    differences, one-sided at the borders) for the 2nd-order correction
    of grid-sourced conservative remaps."""
    import scipy.sparse as sp

    nx, ny = grid.nx, grid.ny

    def d1(n, h):
        if n == 1:
            return sp.csr_matrix((1, 1))
        D = sp.lil_matrix((n, n))
        for i in range(n):
            if 0 < i < n - 1:
                D[i, i - 1], D[i, i + 1] = -0.5 / h, 0.5 / h
            elif i == 0:
                D[0, 0], D[0, 1] = -1.0 / h, 1.0 / h
            else:
                D[i, i - 1], D[i, i] = -1.0 / h, 1.0 / h
        return D.tocsr()

    dx = grid.x[1] - grid.x[0] if nx > 1 else 1.0
    dy = grid.y[1] - grid.y[0] if ny > 1 else 1.0
    Ix = sp.identity(nx, format="csr")
    Iy = sp.identity(ny, format="csr")
    Dx = sp.kron(d1(nx, dx), Iy, format="csr")
    Dy = sp.kron(Ix, d1(ny, dy), format="csr")
    return Dx, Dy


def _points_of(obj, grid_type="vertices"):
    from ..mesh.mesh_types import Mesh
    from ..mesh.grids import Grid
    if isinstance(obj, Grid):
        return obj.centres()
    if isinstance(obj, Mesh):
        return obj.V if grid_type == "vertices" else obj.TriGC
    raise TypeError(str(type(obj)))


def _create_map(src, dst, method, src_grid_type):
    if method == "2nd_order_conservative":
        sp_, snv, spts, Dx, Dy = _polys_of(src, src_grid_type)
        dp_, dnv, _, _, _ = _polys_of(dst)
        return build_map_conservative(sp_, snv, spts, dp_, dnv,
                                      M_ddx_src=Dx, M_ddy_src=Dy)
    if method == "1st_order_conservative":
        sp_, snv, spts, _, _ = _polys_of(src, src_grid_type)
        dp_, dnv, _, _, _ = _polys_of(dst)
        return build_map_conservative(sp_, snv, spts, dp_, dnv,
                                      second_order=False)
    if method == "nearest_neighbour":
        spts = _points_of(src, src_grid_type)
        dpts = _points_of(dst)
        return build_map_nearest(spts, dpts, len(spts))
    if method == "trilin":
        from ..mesh.mesh_types import Mesh
        if isinstance(src, Mesh):
            return build_map_trilin_mesh_to_points(src, _points_of(dst))
        # grid source: bilinear handled by nearest for now
        return build_map_nearest(_points_of(src), _points_of(dst),
                                 len(_points_of(src)))
    raise ValueError(f"unknown remap method '{method}'")


def get_map(src, dst, method="2nd_order_conservative",
            src_grid_type="vertices"):
    """Find-or-create a remap operator in the global Atlas."""
    return _GLOBAL_ATLAS.get(src, dst, method, src_grid_type)


def apply_map(M, field):
    """Apply a remap operator to a field [n_src] or [n_src, d]."""
    return M @ np.asarray(field)
