"""The Mesh container: host-side numpy geometry + connectivity + operators.

TPU-native analogue of the reference's type_mesh
(src/UPSY/types/mesh_types.f90:17-284). Immutable after construction; built
once on host, then shipped to device as padded dense arrays (see
ops/operators.py for the ELL operator forms). Grids:

- a-grid: vertices (Voronoi cells)  -> scalar state (Hi, Hb, T, ...)
- b-grid: triangles                 -> velocities (u,v)
- c-grid: edges                     -> fluxes

All indices 0-based with -1 padding (reference is 1-based with 0 = none).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .triangulation import (Connectivity, circumcenters, delaunay_triangulate,
                            triangle_areas)
from .secondary import (calc_connection_lengths, calc_connection_widths,
                        calc_resolution, calc_voronoi_areas_centres_fast)
from .zeta import setup_zeta_grid


@dataclass
class Mesh:
    """Unstructured Voronoi/Delaunay mesh with all secondary data."""

    # domain
    xmin: float
    xmax: float
    ymin: float
    ymax: float

    # primary
    V: np.ndarray          # [nV,2] vertex coordinates
    Tri: np.ndarray        # [nTri,3] triangle vertex indices (CCW)

    # connectivity
    nC: np.ndarray         # [nV] number of vertex neighbours
    C: np.ndarray          # [nV,nC_mem] neighbour vertices, CCW, -1 pad
    niTri: np.ndarray      # [nV]
    iTri: np.ndarray       # [nV,nC_mem] surrounding triangles, CCW
    VBI: np.ndarray        # [nV] border index (0 interior, 1..8 N..NW)
    TriC: np.ndarray       # [nTri,3] neighbour across edge (n,n+1)
    TriE: np.ndarray       # [nTri,3] edge index for edge (n,n+1)
    EV: np.ndarray         # [nE,2] edge vertices
    ETri: np.ndarray       # [nE,2] edge left/right triangles
    E: np.ndarray          # [nE,2] edge midpoints
    VE: np.ndarray         # [nV,nC_mem] edge per connection

    # secondary
    Tricc: np.ndarray      # [nTri,2] circumcenters
    TriA: np.ndarray       # [nTri] triangle areas
    TriGC: np.ndarray      # [nTri,2] triangle geometric centres
    A: np.ndarray          # [nV] Voronoi cell areas
    VorGC: np.ndarray      # [nV,2] Voronoi geometric centres
    R: np.ndarray          # [nV] resolution (shortest connection)
    Cw: np.ndarray         # [nV,nC_mem] shared Voronoi boundary lengths
    Lc_e: np.ndarray       # [nE] shared Voronoi boundary length per edge
    D_x: np.ndarray        # [nV,nC_mem]
    D_y: np.ndarray
    D: np.ndarray

    # vertical grid
    nz: int = 12
    zeta: np.ndarray = field(default=None)
    zeta_stag: np.ndarray = field(default=None)

    # lon/lat secondary data (inverse oblique stereographic projection of
    # V, reference mesh_secondary.f90; None for idealised domains)
    lon: Optional[np.ndarray] = None   # [nV] degrees east in [0,360)
    lat: Optional[np.ndarray] = None   # [nV] degrees north
    proj: Optional[tuple] = None       # (lambda_M, phi_M, beta_stereo)

    # operators (filled by ops/operators.build_all_matrix_operators)
    operators: Optional[Any] = None
    # device-side arrays (filled lazily)
    device: Optional[Any] = None

    @property
    def nV(self) -> int:
        return len(self.V)

    @property
    def nTri(self) -> int:
        return len(self.Tri)

    @property
    def nE(self) -> int:
        return len(self.EV)

    @property
    def nC_mem(self) -> int:
        return self.C.shape[1]

    def summary(self) -> str:
        return (f"Mesh(nV={self.nV}, nTri={self.nTri}, nE={self.nE}, "
                f"res=[{self.R.min():.0f}..{self.R.max():.0f}] m, "
                f"domain=[{self.xmin:.0f},{self.xmax:.0f}]x"
                f"[{self.ymin:.0f},{self.ymax:.0f}])")


def mesh_from_points(V: np.ndarray, xmin, xmax, ymin, ymax,
                     nz: int = 12, choice_zeta_grid: str = "regular",
                     zeta_irregular_log_R: float = 10.0,
                     Tri: np.ndarray | None = None) -> Mesh:
    """Build a full Mesh (connectivity + secondary data) from vertex coords."""
    V = np.asarray(V, dtype=np.float64)
    if Tri is None:
        Tri = delaunay_triangulate(V)
    # order triangles along the vertex ordering (Morton when the vertices
    # are Morton-renumbered): keeps b-grid operator columns local, which
    # the tiled-ELL SpMV depends on
    Tri = Tri[np.argsort(Tri.min(axis=1), kind="stable")]
    conn = Connectivity(V, Tri, xmin, xmax, ymin, ymax)
    Tricc = circumcenters(V, Tri)
    # Keep circumcentres inside the domain (reference crashes otherwise;
    # after proper encroachment-aware refinement this is a no-op clamp).
    Tricc = np.clip(Tricc, [xmin, ymin], [xmax, ymax])
    TriA = triangle_areas(V, Tri)
    TriGC = V[Tri].mean(axis=1)
    A, VorGC = calc_voronoi_areas_centres_fast(conn, Tricc, xmin, xmax, ymin, ymax)
    Cw, Lc_e = calc_connection_widths(conn, Tricc, xmin, xmax, ymin, ymax)
    D_x, D_y, D = calc_connection_lengths(conn)
    zeta, zeta_stag = setup_zeta_grid(choice_zeta_grid, nz, zeta_irregular_log_R)

    return Mesh(
        xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
        V=V, Tri=Tri,
        nC=conn.nC, C=conn.C, niTri=conn.niTri, iTri=conn.iTri,
        VBI=conn.VBI, TriC=conn.TriC, TriE=conn.TriE,
        EV=conn.EV, ETri=conn.ETri, E=conn.E, VE=conn.VE,
        Tricc=Tricc, TriA=TriA, TriGC=TriGC,
        A=A, VorGC=VorGC, R=calc_resolution(conn),
        Cw=Cw, Lc_e=Lc_e, D_x=D_x, D_y=D_y, D=D,
        nz=nz, zeta=zeta, zeta_stag=zeta_stag,
    )


def renumber_mesh_morton(mesh: Mesh) -> Mesh:
    """Renumber vertices/triangles/edges along a Morton space-filling curve.

    The TPU equivalent of the reference's contiguous-domain renumbering
    (mesh_contiguous_domains.f90): spatial locality in the index space makes
    operator rows reference nearby columns, which the tiled-ELL SpMV
    (ops/sparse.py) and multi-chip sharding both depend on.
    """
    def morton_order(P):
        x = P[:, 0] - P[:, 0].min()
        y = P[:, 1] - P[:, 1].min()
        nx = ((x / max(x.max(), 1e-30)) * 65535).astype(np.uint64)
        ny = ((y / max(y.max(), 1e-30)) * 65535).astype(np.uint64)

        def spread(v):
            v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
            v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
            v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
            v = (v | (v << np.uint64(1))) & np.uint64(0x55555555)
            return v
        code = spread(nx) | (spread(ny) << np.uint64(1))
        return np.argsort(code, kind="stable")

    perm_V = morton_order(mesh.V)        # new i = old perm_V[i]
    inv_V = np.empty_like(perm_V)
    inv_V[perm_V] = np.arange(mesh.nV)
    # triangles get renumbered implicitly by re-deriving connectivity
    V_new = mesh.V[perm_V]
    Tri_new = inv_V[mesh.Tri]
    # re-derive everything (cheap; guarantees consistency)
    m = mesh_from_points(V_new, mesh.xmin, mesh.xmax, mesh.ymin, mesh.ymax,
                         nz=mesh.nz, Tri=None)
    m.zeta = mesh.zeta
    m.zeta_stag = mesh.zeta_stag
    return m
