"""Device-resident mesh data: the object every device function reads.

Bridges the host-side Mesh (numpy, ragged) to static-shape tensors on one
device: padded neighbour tables, ELL operators, border masks. This
replaces the reference's type_mesh-with-CSR-members carried through every
subroutine (mesh_types.f90).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.sparse import EllMatrix, EllStack, ell_from_csr, ell_stack_from_csr
from ..parallel.comm import HaloTables, halo_extend


@dataclass
class EField:
    """A static per-entity field registered in MeshData.extras.

    `row` names the entity space ('V' | 'Tri' | 'E') the field lives on."""
    arr: Any
    row: str


@dataclass
class EIndex:
    """A static index table in MeshData.extras: rows in entity space
    `row`, values indexing entity space `col`."""
    arr: Any
    row: str
    col: str


@dataclass
class MeshData:
    # geometry
    V: Any          # [nV,2]
    TriGC: Any      # [nTri,2]
    A: Any          # [nV] Voronoi areas
    TriA: Any       # [nTri]
    R: Any          # [nV] resolution
    zeta: Any       # [nz]
    zeta_stag: Any  # [nz-1]

    # vertex connectivity (padded; pad entries point at 0 with mask False)
    C: Any          # [nV,K] int64 neighbour vertex
    mask_C: Any     # [nV,K] bool
    VE: Any         # [nV,K] int64 edge per connection
    Cw: Any         # [nV,K] shared Voronoi boundary length
    D_x: Any        # [nV,K]
    D_y: Any
    D: Any

    # triangles
    Tri: Any        # [nTri,3] int64 vertex indices

    # edges
    EV: Any         # [nE,2] int64
    ETri: Any       # [nE,2] int64 (pad -> 0)
    mask_ETri: Any  # [nE,2] bool

    # border
    VBI: Any        # [nV] int32
    border_N: Any   # [nV] bool (VBI 1,2)
    border_E: Any   # (3,4)
    border_S: Any   # (5,6)
    border_W: Any   # (7,8)

    # operators (ELL)
    M_ddx_a_a: EllMatrix
    M_ddy_a_a: EllMatrix
    M_map_a_b: EllMatrix
    M_ddx_a_b: EllMatrix
    M_ddy_a_b: EllMatrix
    M_map_b_a: EllMatrix
    M_ddx_b_a: EllMatrix
    M_ddy_b_a: EllMatrix
    M_ddx_b_b: EllMatrix
    M_ddy_b_b: EllMatrix
    M2_ddx_b_b: EllMatrix
    M2_ddy_b_b: EllMatrix
    M2_d2dx2_b_b: EllMatrix
    M2_d2dxdy_b_b: EllMatrix
    M2_d2dy2_b_b: EllMatrix

    # fused 2nd-order operator stack (set in both precisions)
    M2_stack: EllStack = None

    # extra static connectivity (shared by solvers)
    TriC: Any = None        # [nTri,3] int64 neighbour triangles (pad 0)
    mask_TriC: Any = None   # [nTri,3] bool
    E_len: Any = None       # [nE] edge lengths |V[vi]-V[vj]|
    rev_pos: Any = None     # [nV,K] position of vi within C[C[vi,k]]

    # registered static per-entity fields (EField/EIndex), keyed by name;
    # solver factories register their tables here
    extras: Any = None

    # multi-device halo tables per entity space (None on a single device)
    halo_V: Any = None
    halo_Tri: Any = None
    halo_E: Any = None

    # -- halo hooks: on one device an entity space has no halo, so the
    # extended-local view of a field is the field itself; on a rank of a
    # sharded run (parallel/dist.py, halo tables set) they extend the
    # rank's block with its halo, so that gathers through the re-indexed
    # tables stay local
    def ext_V(self, x):
        if self.halo_V is None:
            return x
        return halo_extend(x, self.halo_V)

    def ext_Tri(self, x):
        if self.halo_Tri is None:
            return x
        return halo_extend(x, self.halo_Tri)

    def ext_E(self, x):
        if self.halo_E is None:
            return x
        return halo_extend(x, self.halo_E)

    def x(self, name):
        """Registered extra field/table tensor by name."""
        return self.extras[name].arr

    @property
    def nV(self):
        return self.V.shape[0]

    @property
    def nTri(self):
        return self.TriGC.shape[0]

    @property
    def nE(self):
        return self.EV.shape[0]

    @property
    def nz(self):
        return self.zeta.shape[0]

    @property
    def device(self):
        return self.V.device

    @property
    def dtype(self):
        return self.A.dtype

    def to(self, device):
        """Copy of this MeshData with every tensor on `device`."""
        def mv(v):
            if isinstance(v, (torch.Tensor, EllStack, HaloTables)):
                return v.to(device)
            if isinstance(v, EField):
                return EField(mv(v.arr), v.row)
            if isinstance(v, EIndex):
                return EIndex(mv(v.arr), v.row, v.col)
            if isinstance(v, dict):
                return {k: mv(a) for k, a in v.items()}
            return v
        out = MeshData(**{f.name: mv(getattr(self, f.name))
                          for f in fields(self)})
        for name in ("_host_mesh", "ssa_has_fix"):
            if hasattr(self, name):
                setattr(out, name, getattr(self, name))
        return out


def build_mesh_data(mesh, dtype=torch.float64, device="cuda") -> MeshData:
    """Construct device MeshData from a host Mesh (builds operators if
    absent)."""
    device = resolve_device(device)
    if mesh.operators is None:
        from ..mesh.operators import build_all_matrix_operators
        mesh.operators = build_all_matrix_operators(mesh)
    ops = mesh.operators

    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    # index tables are int64: tensor indexing wants it, and only the ELL
    # tables (int32) reach the kernel
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=device)
    b = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.bool,
                                  device=device)

    mask_C = mesh.C >= 0
    C = np.where(mask_C, mesh.C, 0)
    VE = np.where(mesh.VE >= 0, mesh.VE, 0)
    mask_ETri = mesh.ETri >= 0
    ETri = np.where(mask_ETri, mesh.ETri, 0)
    mask_TriC = mesh.TriC >= 0
    TriC = np.where(mask_TriC, mesh.TriC, 0)
    E_len = np.linalg.norm(mesh.V[mesh.EV[:, 0]] - mesh.V[mesh.EV[:, 1]],
                           axis=1)
    # reverse-connection positions: rev_pos[vi,k] = index of vi within
    # C[C[vi,k]] (valid because mesh connections are symmetric); static
    # connectivity, so computed once here instead of per step on device
    CC = C[C].astype(np.int32)                    # [nV,K,K]
    rev_pos = np.argmax(
        CC == np.arange(mesh.nV, dtype=np.int32)[:, None, None],
        axis=2).astype(np.int64)
    del CC

    vbi = mesh.VBI
    e = lambda A: ell_from_csr(A, dtype=dtype, device=device)

    md = MeshData(
        V=f(mesh.V), TriGC=f(mesh.TriGC), A=f(mesh.A), TriA=f(mesh.TriA),
        R=f(mesh.R), zeta=f(mesh.zeta), zeta_stag=f(mesh.zeta_stag),
        C=i(C), mask_C=b(mask_C), VE=i(VE),
        Cw=f(np.where(mask_C, mesh.Cw, 0.0)),
        D_x=f(mesh.D_x), D_y=f(mesh.D_y), D=f(mesh.D),
        Tri=i(mesh.Tri),
        EV=i(mesh.EV), ETri=i(ETri), mask_ETri=b(mask_ETri),
        VBI=torch.as_tensor(np.asarray(vbi), dtype=torch.int32,
                            device=device),
        border_N=b((vbi == 1) | (vbi == 2)),
        border_E=b((vbi == 3) | (vbi == 4)),
        border_S=b((vbi == 5) | (vbi == 6)),
        border_W=b((vbi == 7) | (vbi == 8)),
        M_ddx_a_a=e(ops.M_ddx_a_a), M_ddy_a_a=e(ops.M_ddy_a_a),
        M_map_a_b=e(ops.M_map_a_b), M_ddx_a_b=e(ops.M_ddx_a_b),
        M_ddy_a_b=e(ops.M_ddy_a_b),
        M_map_b_a=e(ops.M_map_b_a), M_ddx_b_a=e(ops.M_ddx_b_a),
        M_ddy_b_a=e(ops.M_ddy_b_a),
        M_ddx_b_b=e(ops.M_ddx_b_b), M_ddy_b_b=e(ops.M_ddy_b_b),
        M2_ddx_b_b=e(ops.M2_ddx_b_b), M2_ddy_b_b=e(ops.M2_ddy_b_b),
        M2_d2dx2_b_b=e(ops.M2_d2dx2_b_b),
        M2_d2dxdy_b_b=e(ops.M2_d2dxdy_b_b),
        M2_d2dy2_b_b=e(ops.M2_d2dy2_b_b),
        M2_stack=ell_stack_from_csr(
            [ops.M2_ddx_b_b, ops.M2_ddy_b_b, ops.M2_d2dx2_b_b,
             ops.M2_d2dxdy_b_b, ops.M2_d2dy2_b_b], dtype=dtype,
            device=device),
        TriC=i(TriC), mask_TriC=b(mask_TriC),
        E_len=f(E_len), rev_pos=i(rev_pos),
        extras={},
    )
    md._host_mesh = mesh   # kept for solver factories needing host data
    return md


# -- common neighbour-gather helpers ----------------------------------------

def gather_neighbours(md: MeshData, x):
    """x[C] with padding masked to 0; x is [nV] or [nV, d]."""
    g = md.ext_V(x)[md.C]
    m = md.mask_C if g.ndim == 2 else md.mask_C[..., None]
    return torch.where(m, g, 0)


def map_b_to_c(md: MeshData, u_b):
    """b-grid (triangles) -> c-grid (edges) velocity mapping.

    Mean of the two adjacent triangles; one-sided at border edges
    (reference map_velocities_from_b_to_c_2D, map_velocities_to_c_grid.f90:44).
    """
    vals = md.ext_Tri(u_b)[md.ETri]           # [nE,2] or [nE,2,d]
    m = md.mask_ETri
    if vals.ndim == 3:
        m = m[..., None]
    s = torch.where(m, vals, 0).sum(dim=1)
    n = m.sum(dim=1)
    return s / torch.clamp(n, min=1)
