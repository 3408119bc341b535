"""SSA / DIVA stress balance: matrix-free viscosity iteration + Krylov solve.

Re-design of the reference's SSA/DIVA machinery
(src/UFEMISM/ice_dynamics/conservation_of_momentum/SSA_DIVA/): instead of
assembling a 2nTri x 2nTri CSR stiffness matrix per viscosity iteration and
calling PETSc (solve_linearised_SSA_DIVA_infinite_slab.f90), the linearised
momentum operator

  u-row: 4 N d2u/dx2 + 4 dN/dx du/dx + N d2u/dy2 + dN/dy du/dy - beta_eff u
       + 3 N d2v/dxdy + 2 dN/dx dv/dy + dN/dy dv/dx  = -tau_dx
  v-row: symmetric

is applied matrix-free: one kernel launch (ops/cuda_spmv.py, `diva_apply`)
forms the five M2_* derivatives of u and v, scales them by the
per-triangle fields (N, dN/dx, dN/dy, beta_eff) and writes the boundary
rows (with BC_ice_front = 'ocean_pressure' also the calving-front rows and
the identity rows off the ice); the system is solved by restarted GMRES
with a 2x2 block-Jacobi preconditioner, or with Chebyshev or Neumann
polynomial acceleration of it, a dense block-Jacobi over 64-triangle
blocks, or the block-Jacobi plus a Galerkin coarse correction
(tpu_stress_balance_precond). The viscosity iteration
(DIVA_solver_infinite_slab.f90:52-231) including the adaptive relaxation
rescue ladder is a host loop over device work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..mesh_data import MeshData, EField, EIndex
from ...parallel import comm
from ...utils.constants import ice_density, grav, seawater_density
from ...mesh.zeta import integrate_from_base_up, vertical_average
from ...ops.cuda_spmv import DivaOperator, DivaRows
from ...ops.krylov import (gmres, estimate_lambda_max,
                           make_chebyshev_preconditioner,
                           make_neumann_preconditioner)
from .masks import determine_masks
from .rheology import calc_ice_rheology_glen
from .sia import solve_SIA
from .subgrid import (calc_grounded_fractions, calc_effective_thickness,
                      register_bedrock_cdfs)
from .sliding import calc_basal_friction_coefficient, register_sliding_static


# ---------------------------------------------------------------------------
# Host-side static data: triangle border indices + BC row classification
# ---------------------------------------------------------------------------

def calc_TriBI(mesh) -> np.ndarray:
    """Triangle border indices by tracing the domain border
    (mesh_secondary.f90:72 calc_TriBI)."""
    TriBI = np.zeros(mesh.nTri, dtype=np.int32)
    vbi = mesh.VBI
    sw = np.where(vbi == 6)[0]
    assert len(sw) > 0, "no southwest corner vertex"
    vi_sw = int(sw[0])
    vi = vi_sw
    corners = {}
    for _ in range(mesh.nV + 1):
        for t in mesh.iTri[vi][: mesh.niTri[vi]]:
            TriBI[t] = vbi[vi]
        vi = int(mesh.C[vi, mesh.nC[vi] - 1])
        if vbi[vi] in (2, 4, 8):
            corners[vbi[vi]] = vi
        if vi == vi_sw:
            break
    for code, cv in {6: vi_sw, **corners}.items():
        if mesh.niTri[cv] == 1:
            TriBI[mesh.iTri[cv, 0]] = code
    return TriBI


class _BCData(NamedTuple):
    free: np.ndarray       # [nTri] bool: interior rows (solve the PDE)
    zero_u: np.ndarray     # identity rows, rhs 0
    zero_v: np.ndarray
    inf_u: np.ndarray      # mean-of-neighbours rows, rhs 0
    inf_v: np.ndarray
    fix_u: np.ndarray      # identity rows, rhs = weighted copy of prev sol
    fix_v: np.ndarray
    copy_inds: np.ndarray  # [nTri, Kc] source triangles for fixed rows
    copy_w: np.ndarray     # [nTri, Kc] weights (normalised 1/d^2)


def _copy_tables(mesh, rows, targets):
    """For each row triangle, inverse-distance weights over the triangles
    around the vertex whose Voronoi cell contains the target point
    (find_ti_copy_* pattern, mesh_utilities.f90:2623,2681)."""
    from scipy.spatial import cKDTree
    Kc = int(mesh.niTri.max())
    copy_inds = np.zeros((mesh.nTri, Kc), dtype=np.int64)
    copy_w = np.zeros((mesh.nTri, Kc))
    if len(rows) == 0:
        return copy_inds, copy_w
    vtree = cKDTree(mesh.V)      # nearest vertex == containing Voronoi cell
    _, vis = vtree.query(targets)
    for k, (r, vi) in enumerate(zip(rows, vis)):
        ni = mesh.niTri[vi]
        tjs = mesh.iTri[vi, :ni]
        d = np.linalg.norm(mesh.TriGC[tjs] - targets[k], axis=1)
        w = 1.0 / np.maximum(d, 1e-3) ** 2
        copy_inds[r, :ni] = tjs
        copy_w[r, :ni] = w / w.sum()
    return copy_inds, copy_w


def make_bc_data(C, mesh) -> _BCData:
    """Classify border-triangle rows by the configured velocity BCs
    (solve_linearised_SSA_DIVA_infinite_slab.f90:109-134,481-641)."""
    TriBI = calc_TriBI(mesh)
    sides = {"north": (1, 2), "east": (3, 4), "south": (5, 6), "west": (7, 8)}
    nTri = mesh.nTri
    masks = {f"{c}_{t}": np.zeros(nTri, bool)
             for c in ("u", "v") for t in ("zero", "inf", "per", "ice")}
    for side, codes in sides.items():
        on = np.isin(TriBI, codes)
        for comp in ("u", "v"):
            bc = getattr(C, f"BC_{comp}_{side}")
            if bc == "zero":
                masks[f"{comp}_zero"] |= on
            elif bc == "infinite":
                masks[f"{comp}_inf"] |= on
            elif bc == "periodic_ISMIP-HOM":
                masks[f"{comp}_per"] |= on
            elif bc == "infinite_SSA_icestream":
                masks[f"{comp}_ice"] |= on
            else:
                raise ValueError(f"unknown BC_{comp}_{side} '{bc}'")
    free = TriBI == 0

    # fixed-row copy tables (periodic ISMIP-HOM and SSA-icestream rows both
    # copy the previous solution from an interior point)
    fix_u = masks["u_per"] | masks["u_ice"]
    fix_v = masks["v_per"] | masks["v_ice"]
    rows = np.where(fix_u | fix_v)[0]
    gc = mesh.TriGC
    targets = gc[rows].copy()
    per_rows = (masks["u_per"] | masks["v_per"])[rows]
    ice_rows = (masks["u_ice"] | masks["v_ice"])[rows]
    L = C.refgeo_idealised_ISMIP_HOM_L
    # periodic: displace by -+L/2 toward the domain centre
    targets[per_rows, 0] += np.where(gc[rows][per_rows, 0] > 0, -L / 2, L / 2)
    targets[per_rows, 1] += np.where(gc[rows][per_rows, 1] > 0, -L / 2, L / 2)
    # icestream: copy from x = 1/3 or 2/3 across the domain, same y
    x13 = mesh.xmin + (mesh.xmax - mesh.xmin) / 3.0
    x23 = mesh.xmin + (mesh.xmax - mesh.xmin) * 2.0 / 3.0
    targets[ice_rows, 0] = np.where(gc[rows][ice_rows, 0] < 0, x13, x23)
    copy_inds, copy_w = _copy_tables(mesh, rows, targets)

    return _BCData(free, masks["u_zero"], masks["v_zero"],
                   masks["u_inf"], masks["v_inf"],
                   fix_u, fix_v, copy_inds, copy_w)


# ---------------------------------------------------------------------------
# The linearised momentum operator + preconditioner (module level so
# solver experiments can target the real operator; used by the viscosity
# iteration below)
# ---------------------------------------------------------------------------

class FrontData(NamedTuple):
    """The ocean-pressure calving front of one solve (per-triangle)."""
    is_front: torch.Tensor   # ice triangles with an ice-free neighbour
    off: torch.Tensor        # triangles without ice: identity rows
    n_x: torch.Tensor        # outward unit normal
    n_y: torch.Tensor
    tau_ox_b: torch.Tensor   # ocean back pressure, the front rows' rhs
    tau_oy_b: torch.Tensor


def calc_front(md, Hi, Hb, SL, Hi_b):
    """The front of the ice mask Hi > 0.1 (DIVA_solver_ocean_pressure.f90:
    the reference solves on a masked ice-only graph with Neumann
    ocean-back-pressure rows at the calving front; here the same system is
    masked rows on the full mesh). The outward normal points towards the
    mean of the ice-free neighbours' centroids (the graph's border_nhat);
    the back pressure is calc_ocean_back_pressure:660-670 with
    Ho = min(max(SL - Hb, 0), rho_i/rho_sw * Hi)."""
    ice_a = md.ext_V(Hi > 0.1)
    ice_b = ice_a[md.Tri].any(dim=1)
    ice_nbr = md.ext_Tri(ice_b)[md.TriC]
    noice_nbr = (~ice_nbr) & md.mask_TriC
    is_front = ice_b & noice_nbr.any(dim=1)
    off = ~ice_b
    gc_nbr = md.ext_Tri(md.TriGC)[md.TriC]      # [nTri, 3, 2]
    d = torch.where(noice_nbr[:, :, None],
                    gc_nbr - md.TriGC[:, None, :], 0.0).sum(dim=1)
    d_len = torch.sqrt((d ** 2).sum(dim=1))
    nhat = d / torch.clamp(d_len, min=1e-30)[:, None]
    n_x, n_y = nhat[:, 0].contiguous(), nhat[:, 1].contiguous()
    Ho_a = torch.minimum(torch.clamp(SL - Hb, min=0.0),
                         ice_density / seawater_density * Hi)
    Ho_b = md.M_map_a_b @ Ho_a
    tau_mag = (0.5 * ice_density * grav * Hi_b ** 2
               - 0.5 * seawater_density * grav * Ho_b ** 2)
    return FrontData(is_front, off, n_x, n_y, tau_mag * n_x, tau_mag * n_y)


def make_A(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b, front=None):
    """The matrix-free linearised SSA/DIVA momentum operator
    (solve_linearised_SSA_DIVA_infinite_slab.f90 rows): the five-operator
    derivative stack applied to (u, v), scaled by the per-triangle fields,
    BC rows 'infinite' (neighbour mean) or identity; `front` =
    (is_front, off, n_x, n_y) adds the ocean-pressure front rows
    (solve_linearised_SSA_DIVA_ocean_pressure.f90:445-560) and identity
    rows off the ice. On the card one launch of the kernel `diva_apply`,
    on the CPU its plain version. `A((u, v))` gives (Au, Av); `A.flat` is
    the same on the flat vector [u; v], which `gmres` takes when it is
    there. On a rank of a sharded run the stack's columns are the rank's
    extended [own ; halo] triangles, and the operator exchanges the halo
    of (u, v) before each launch."""
    stack = md.M2_stack
    return DivaOperator(stack.op, md.x("ssa_diva_rows"), N_b, dN_dx_b, dN_dy_b,
                        beta_eff_b,
                        round_x_bf16=stack.vals.dtype == torch.float32,
                        front=None if front is None else tuple(front[:4]),
                        n_cols=stack.n_cols,
                        extend=None if md.halo_Tri is None else md.ext_Tri)


def make_precond(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b, front=None):
    """2x2 block-Jacobi: invert the per-triangle (u,v) diagonal block."""
    bc_free = md.x("ssa_bc_free")
    bc_inf_u = md.x("ssa_bc_inf_u")
    bc_inf_v = md.x("ssa_bc_inf_v")
    n_nbr = md.mask_TriC.sum(dim=1).to(N_b.dtype)
    d_ddx = md.x("ssa_d_ddx")
    d_ddy = md.x("ssa_d_ddy")
    d_dxx = md.x("ssa_d_dxx")
    d_dxy = md.x("ssa_d_dxy")
    d_dyy = md.x("ssa_d_dyy")
    auu = (4 * N_b * d_dxx + 4 * dN_dx_b * d_ddx
           + N_b * d_dyy + dN_dy_b * d_ddy - beta_eff_b)
    auv = 3 * N_b * d_dxy + 2 * dN_dx_b * d_ddy + dN_dy_b * d_ddx
    avu = 3 * N_b * d_dxy + 2 * dN_dy_b * d_ddx + dN_dx_b * d_ddy
    avv = (4 * N_b * d_dyy + 4 * dN_dy_b * d_ddy
           + N_b * d_dxx + dN_dx_b * d_ddx - beta_eff_b)
    # BC rows: diagonal is 1 (zero/periodic) or -n (infinite)
    one = torch.ones_like(auu)
    auu = torch.where(bc_free, auu, torch.where(bc_inf_u, -n_nbr, one))
    avv = torch.where(bc_free, avv, torch.where(bc_inf_v, -n_nbr, one))
    auv = torch.where(bc_free, auv, 0.0)
    avu = torch.where(bc_free, avu, 0.0)
    if front is not None:
        is_front, off, n_x, n_y = front[:4]
        auu_f = 4 * N_b * n_x * d_ddx + N_b * n_y * d_ddy
        avv_f = 4 * N_b * n_y * d_ddy + N_b * n_x * d_ddx
        auv_f = 2 * N_b * n_x * d_ddy + N_b * n_y * d_ddx
        avu_f = 2 * N_b * n_y * d_ddx + N_b * n_x * d_ddy
        auu = torch.where(off, 1.0, torch.where(is_front, auu_f, auu))
        avv = torch.where(off, 1.0, torch.where(is_front, avv_f, avv))
        auv = torch.where(off, 0.0, torch.where(is_front, auv_f, auv))
        avu = torch.where(off, 0.0, torch.where(is_front, avu_f, avu))
    det = auu * avv - auv * avu
    det = torch.where(torch.abs(det) < 1e-300, 1e-300, det)

    def M(r):
        ru, rv = r
        return ((avv * ru - auv * rv) / det,
                (-avu * ru + auu * rv) / det)
    return M


BJD_BLOCK = 64     # triangles per dense Jacobi block (128x128 (u,v) system)


def register_bjdense_static(mesh, md: MeshData):
    """Static tables for the dense block-Jacobi preconditioner: for each
    contiguous block of BJD_BLOCK triangles, the in-block entries of the 5
    shared-pattern b-grid operators plus flat scatter indices into the
    [nB, 128, 128] dense (u,v) blocks: exact dense solves on 64-triangle
    subdomains, batch-inverted each viscosity iteration (the strength
    class of PETSc's bjacobi+ILU, petsc_basic.f90)."""
    if "bjd_vals" in md.extras:
        return
    ops = mesh.operators
    mats = [ops.M2_ddx_b_b.tocsr(), ops.M2_ddy_b_b.tocsr(),
            ops.M2_d2dx2_b_b.tocsr(), ops.M2_d2dxdy_b_b.tocsr(),
            ops.M2_d2dy2_b_b.tocsr()]
    nTri = mats[0].shape[0]
    B = BJD_BLOCK
    nB = (nTri + B - 1) // B
    U = (abs(mats[0]) + abs(mats[1]) + abs(mats[2]) + abs(mats[3])
         + abs(mats[4])).tocoo()
    r = U.row.astype(np.int64)
    c = U.col.astype(np.int64)
    sel = (r // B) == (c // B)
    r, c = r[sel], c[sel]
    vals5 = np.zeros((len(r), 5))
    q = r * nTri + c
    for k, m in enumerate(mats):
        mc = m.tocoo()
        key = mc.row.astype(np.int64) * nTri + mc.col.astype(np.int64)
        order = np.argsort(key)
        ks = key[order]
        pos = np.minimum(np.searchsorted(ks, q), len(ks) - 1)
        hit = ks[pos] == q
        vals5[hit, k] = mc.data[order][pos][hit]
    base = (r // B) * (128 * 128) + (2 * (r % B)) * 128 + 2 * (c % B)
    rows_all = np.arange(nB * B, dtype=np.int64)
    diag = ((rows_all // B) * (128 * 128)
            + (2 * (rows_all % B)) * 128 + 2 * (rows_all % B))
    dt, dev = md.A.dtype, md.device
    i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    md.extras.update({
        "bjd_vals": EField(torch.as_tensor(vals5, dtype=dt, device=dev),
                           "BJDnnz"),
        "bjd_rows": EField(i64(r), "BJDnnz"),
        "bjd_base": EField(i64(base), "BJDnnz"),
        "bjd_diag": EField(i64(diag), "BJDrow"),
        "bjd_row_valid": EField(torch.as_tensor(rows_all < nTri,
                                                device=dev), "BJDrow"),
    })


def _pad(a, n, fill):
    """a [len] padded with `fill` to [n]."""
    out = torch.full((n,), fill, dtype=a.dtype, device=a.device)
    out[:a.shape[0]] = a
    return out


def make_precond_dense(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b, front=None):
    """Dense block-Jacobi: assemble the in-block entries of the
    linearised operator (same weights as make_A) into [nB, 128, 128]
    (u,v) blocks, batch-invert, apply as one batched matmul. BC rows keep
    the 2x2 scheme's diagonal approximation."""
    bc_free = md.x("ssa_bc_free")
    bc_inf_u = md.x("ssa_bc_inf_u")
    bc_inf_v = md.x("ssa_bc_inf_v")
    n_nbr = md.mask_TriC.sum(dim=1).to(N_b.dtype)
    v5 = md.x("bjd_vals")
    rsel = md.x("bjd_rows")
    base = md.x("bjd_base")
    diag = md.x("bjd_diag")
    row_valid = md.x("bjd_row_valid")
    nTri = N_b.shape[0]
    B = BJD_BLOCK
    nB = row_valid.shape[0] // B
    nP = nB * B
    dt = N_b.dtype

    Nr = N_b[rsel]
    dxr = dN_dx_b[rsel]
    dyr = dN_dy_b[rsel]
    ddx, ddy, dxx, dxy, dyy = (v5[:, k] for k in range(5))
    e_uu = 4 * Nr * dxx + 4 * dxr * ddx + Nr * dyy + dyr * ddy
    e_uv = 3 * Nr * dxy + 2 * dxr * ddy + dyr * ddx
    e_vu = 3 * Nr * dxy + 2 * dyr * ddx + dxr * ddy
    e_vv = 4 * Nr * dyy + 4 * dyr * ddy + Nr * dxx + dxr * ddx
    if front is not None:
        is_front, off, n_x, n_y = front[:4]
        fr = is_front[rsel]
        nxr, nyr = n_x[rsel], n_y[rsel]
        e_uu = torch.where(fr, 4 * Nr * nxr * ddx + Nr * nyr * ddy, e_uu)
        e_vv = torch.where(fr, 4 * Nr * nyr * ddy + Nr * nxr * ddx, e_vv)
        e_uv = torch.where(fr, 2 * Nr * nxr * ddy + Nr * nyr * ddx, e_uv)
        e_vu = torch.where(fr, 2 * Nr * nyr * ddx + Nr * nxr * ddy, e_vu)
        ok_r = (bc_free | is_front)[rsel] & ~off[rsel]
    else:
        ok_r = bc_free[rsel]
    e_uu = torch.where(ok_r, e_uu, 0.0)
    e_uv = torch.where(ok_r, e_uv, 0.0)
    e_vu = torch.where(ok_r, e_vu, 0.0)
    e_vv = torch.where(ok_r, e_vv, 0.0)

    blocks = torch.zeros(nB * 128 * 128, dtype=dt, device=N_b.device)
    blocks.index_add_(0, base, e_uu)
    blocks.index_add_(0, base + 1, e_uv)
    blocks.index_add_(0, base + 128, e_vu)
    blocks.index_add_(0, base + 129, e_vv)
    # per-row diagonal terms: -beta_eff on free rows (operator diagonals
    # are already in the scatter), BC diagonal on constrained rows,
    # identity on block-padding rows (keeps every column nonsingular)
    freep = _pad(bc_free, nP, False) & row_valid
    if front is not None:
        freep = (_pad(bc_free | is_front, nP, False)
                 & ~_pad(off, nP, True)) & row_valid
    betap = _pad(beta_eff_b.to(dt), nP, 0.0)
    nnbrp = _pad(n_nbr, nP, 1.0)
    one = torch.ones_like(betap)
    d_uu = torch.where(freep, -betap,
                       torch.where(_pad(bc_inf_u, nP, False), -nnbrp, one))
    d_vv = torch.where(freep, -betap,
                       torch.where(_pad(bc_inf_v, nP, False), -nnbrp, one))
    # front rows have no diagonal beta term
    if front is not None:
        frp = _pad(is_front, nP, False) & row_valid
        d_uu = torch.where(frp, 0.0, d_uu)
        d_vv = torch.where(frp, 0.0, d_vv)
    blocks.index_add_(0, diag, d_uu)
    blocks.index_add_(0, diag + 129, d_vv)
    Minv = torch.linalg.inv(blocks.reshape(nB, 128, 128))

    def M(r):
        ru, rv = r
        rp = torch.zeros((nP, 2), dtype=dt, device=ru.device)
        rp[:nTri] = torch.stack([ru, rv], dim=-1)
        yb = torch.bmm(Minv, rp.reshape(nB, 128, 1))
        y = yb.reshape(nP, 2)[:nTri]
        return y[:, 0], y[:, 1]
    return M


C2_BLOCK = 64    # triangles per coarse aggregate (two-level preconditioner)


def register_two_level_static(mesh, md: MeshData):
    """Static tables for the two-level preconditioner: piecewise-constant
    aggregates of C2_BLOCK contiguous triangles, and the block-column
    structure of S_k = M_k @ P for the 5 shared-pattern b-grid operators.
    The Galerkin coarse operator A_c = P^T A P is then assembled on the
    device each viscosity iteration from the same per-row weights as the
    matrix-free apply (make_A), inverted once, and its correction added to
    the 2x2 block-Jacobi: the long-range near-null shelf modes that
    block-local preconditioners cannot reach (PETSc KSP with composite
    preconditioning is the reference's strength class, petsc_basic.f90)."""
    if "c2_bcol" in md.extras:
        return
    import scipy.sparse as sp
    ops = mesh.operators
    mats = [ops.M2_ddx_b_b.tocsr(), ops.M2_ddy_b_b.tocsr(),
            ops.M2_d2dx2_b_b.tocsr(), ops.M2_d2dxdy_b_b.tocsr(),
            ops.M2_d2dy2_b_b.tocsr()]
    nTri = mats[0].shape[0]
    B = C2_BLOCK
    nB = (nTri + B - 1) // B
    blk = np.arange(nTri) // B
    # prolongation columns masked to statically-free rows: the coarse
    # correction is zero on BC rows, so their columns must not enter the
    # Galerkin product (Dirichlet-consistent restriction). The dynamic
    # off-ice mask of the ocean-pressure variant cannot be baked in here;
    # those columns stay and merely soften the preconditioner.
    free = md.x("ssa_bc_free").cpu().numpy()
    P = sp.csr_matrix((free.astype(np.float64), (np.arange(nTri), blk)),
                      shape=(nTri, nB))
    P.eliminate_zeros()
    Sk = [(m @ P).tocsr() for m in mats]
    U = sum(abs(s) for s in Sk).tocsr()
    U.sum_duplicates()
    U.sort_indices()
    counts = np.diff(U.indptr)
    KB = max(int(counts.max()), 1)
    bcol = np.zeros((nTri, KB), np.int64)
    vals5 = np.zeros((nTri, KB, 5))
    row_of = np.repeat(np.arange(nTri), counts)
    pos = np.arange(U.nnz) - np.repeat(U.indptr[:-1], counts)
    bcol[row_of, pos] = U.indices
    valid = np.zeros((nTri, KB), bool)
    valid[row_of, pos] = True
    for k, s in enumerate(Sk):
        sc = s.tocoo()
        # position of (row, col) inside the union row
        key = sc.row.astype(np.int64) * nB + sc.col
        ukey = row_of.astype(np.int64) * nB + bcol[row_of, pos]
        order = np.argsort(ukey)
        loc = np.searchsorted(ukey[order], key)
        vals5[row_of[order][loc], pos[order][loc], k] = sc.data
    dt, dev = md.A.dtype, md.device
    md.extras.update({
        "c2_blk": EField(torch.as_tensor(blk, dtype=torch.int64,
                                         device=dev), "C2row"),
        "c2_bcol": EField(torch.as_tensor(bcol, device=dev), "C2nnz"),
        "c2_vals5": EField(torch.as_tensor(vals5, dtype=dt, device=dev),
                           "C2nnz"),
        "c2_valid": EField(torch.as_tensor(valid, device=dev), "C2nnz"),
    })


def make_precond_two_level(md, N_b, dN_dx_b, dN_dy_b, beta_eff_b, Mbj,
                           front=None):
    """2x2 block-Jacobi `Mbj` (make_precond of the same fields and front)
    + additive piecewise-constant coarse correction:
    z = Mbj(r) + P A_c^{-1} P^T r restricted to free rows. A_c is the
    Galerkin coarse operator assembled from the make_A row weights."""
    bc_free = md.x("ssa_bc_free")
    blk = md.x("c2_blk")
    bcol = md.x("c2_bcol")
    vals5 = md.x("c2_vals5")
    valid = md.x("c2_valid")
    nTri = N_b.shape[0]
    nB = (blk.shape[0] + C2_BLOCK - 1) // C2_BLOCK
    dt, dev = N_b.dtype, N_b.device

    if front is not None:
        is_front, off, n_x, n_y = front[:4]
        ok = (bc_free | is_front) & ~off
    else:
        is_front = torch.zeros(nTri, dtype=torch.bool, device=dev)
        n_x = n_y = torch.zeros(nTri, dtype=dt, device=dev)
        ok = bc_free

    # per-row weights of the 5 operators in each (u,v) coupling
    # (make_A interior rows; front rows use the Neumann weights)
    zero = torch.zeros(nTri, dtype=dt, device=dev)

    def _w(interior, front_w):
        w = torch.where(ok, interior, 0.0)
        if front is not None:
            w = torch.where(is_front & ~off, front_w, w)
        return w
    w_uu = [_w(4 * dN_dx_b, 4 * N_b * n_x), _w(dN_dy_b, N_b * n_y),
            _w(4 * N_b, zero), _w(zero, zero), _w(N_b, zero)]
    w_uv = [_w(dN_dy_b, N_b * n_y), _w(2 * dN_dx_b, 2 * N_b * n_x),
            _w(zero, zero), _w(3 * N_b, zero), _w(zero, zero)]
    w_vu = [_w(2 * dN_dy_b, 2 * N_b * n_y), _w(dN_dx_b, N_b * n_x),
            _w(zero, zero), _w(3 * N_b, zero), _w(zero, zero)]
    w_vv = [_w(dN_dx_b, N_b * n_x), _w(4 * dN_dy_b, 4 * N_b * n_y),
            _w(N_b, zero), _w(zero, zero), _w(4 * N_b, zero)]

    n2 = 2 * nB
    Ac = torch.zeros(n2 * n2, dtype=dt, device=dev)
    base = (2 * blk)[:, None] * n2 + 2 * bcol          # [nTri, KB]
    vm = torch.where(valid, 1.0, 0.0).to(dt)
    for (a, b, ws) in ((0, 0, w_uu), (0, 1, w_uv),
                       (1, 0, w_vu), (1, 1, w_vv)):
        e = sum(ws[k][:, None] * vals5[:, :, k] for k in range(5)) * vm
        Ac.index_add_(0, (base + a * n2 + b).reshape(-1), e.reshape(-1))
    # diagonal beta on free interior rows (front rows carry no beta)
    beta_free = torch.where(bc_free & ~is_front, -beta_eff_b.to(dt), 0.0)
    dsum = torch.zeros(nB, dtype=dt, device=dev).index_add_(0, blk,
                                                             beta_free)
    ar = torch.arange(nB, device=dev)
    diag = (2 * ar) * n2 + 2 * ar
    Ac.index_add_(0, diag, dsum)
    Ac.index_add_(0, diag + n2 + 1, dsum)
    # non-free rows are excluded from the coarse residual/prolongation;
    # keep their aggregates nonsingular with an identity contribution
    nfree = torch.zeros(nB, dtype=dt, device=dev).index_add_(
        0, blk, torch.where(ok, 0.0, 1.0).to(dt))
    Ac.index_add_(0, diag, nfree)
    Ac.index_add_(0, diag + n2 + 1, nfree)
    # a dense inverse (the reference's jnp.linalg.inv): the coarse apply is
    # then one matrix-vector product per application
    Ac_inv = torch.linalg.inv(Ac.reshape(n2, n2))

    def M(r):
        ru, rv = r
        zu, zv = Mbj(r)
        rc = torch.zeros(n2, dtype=dt, device=ru.device)
        rc.index_add_(0, 2 * blk, torch.where(ok, ru, 0.0))
        rc.index_add_(0, 2 * blk + 1, torch.where(ok, rv, 0.0))
        zc = Ac_inv @ rc
        zu = zu + torch.where(ok, zc[2 * blk], 0.0)
        zv = zv + torch.where(ok, zc[2 * blk + 1], 0.0)
        return zu, zv
    return M


def make_preconditioner(kind, md, A, fields, front=None, degree=3, b=None):
    """The preconditioner `kind` (one of PRECONDITIONERS) of the operator
    A = make_A(md, *fields, front=front), fields = (N_b, dN_dx_b, dN_dy_b,
    beta_eff_b). Every kind but block_dense is built on the 2x2
    block-Jacobi: alone, under a Chebyshev (spectrum estimated by power
    iteration from b) or Neumann polynomial of `degree` operator applies -
    on shelf-dominated states (beta_eff -> 0) plain block-Jacobi GMRES
    stagnates - or with a coarse correction (two_level). On a rank of a
    sharded run the dense block-Jacobi and two-level tables are dropped
    (parallel/dist.py), and those two kinds take the 2x2 block-Jacobi, as
    the reference's sharded step does (ssadiva.py:853-860 there)."""
    if kind == "block_dense" and "bjd_vals" in md.extras:
        return make_precond_dense(md, *fields, front=front)
    M = make_precond(md, *fields, front=front)
    if kind == "chebyshev":
        lam = estimate_lambda_max(lambda w: M(A(w)), b, n_its=10)
        return make_chebyshev_preconditioner(A, M, degree, lam)
    if kind == "neumann":
        return make_neumann_preconditioner(A, M, degree)
    if kind == "two_level" and "c2_bcol" in md.extras:
        return make_precond_two_level(md, *fields, M, front=front)
    if kind not in PRECONDITIONERS:
        raise ValueError(f"unknown preconditioner '{kind}'")
    return M


# ---------------------------------------------------------------------------
# The solver factory
# ---------------------------------------------------------------------------

@dataclass
class _ViscCarry:
    u: torch.Tensor
    v: torch.Tensor
    u_base: torch.Tensor
    v_base: torch.Tensor
    tau_bx: torch.Tensor
    tau_by: torch.Tensor
    eta_3D_b: torch.Tensor
    beta_b_a: torch.Tensor      # a-grid friction coefficient
    F1_3D_b: torch.Tensor
    F2_b1: torch.Tensor         # F2 at base on b-grid
    relax: float
    eps_sq0: float
    L2: float
    n_diverg: int
    it: int
    n_axb: int
    done: bool


PRECONDITIONERS = ("block_jacobi", "chebyshev", "neumann", "block_dense",
                   "two_level")


def register_ssadiva_static(C, mesh, md: MeshData):
    """Register the SSA/DIVA static per-triangle tables (BC row masks and
    the same packed for the operator's kernel, fixed-row copy tables,
    preconditioner diagonals, the chosen preconditioner's tables) into
    md.extras."""
    if "ssa_bc_free" in md.extras:
        return
    precond_choice = C.tpu_stress_balance_precond
    if precond_choice not in PRECONDITIONERS:
        raise ValueError(f"unknown tpu_stress_balance_precond "
                         f"'{precond_choice}' (one of "
                         f"{', '.join(PRECONDITIONERS)})")
    bc = make_bc_data(C, mesh)
    dt, dev = md.A.dtype, md.device
    ef = lambda a: EField(torch.as_tensor(a, device=dev), "Tri")
    md.extras.update({
        "ssa_bc_free": ef(bc.free),
        "ssa_bc_zero_u": ef(bc.zero_u), "ssa_bc_zero_v": ef(bc.zero_v),
        "ssa_bc_inf_u": ef(bc.inf_u), "ssa_bc_inf_v": ef(bc.inf_v),
        "ssa_bc_fix_u": ef(bc.fix_u), "ssa_bc_fix_v": ef(bc.fix_v),
        "ssa_copy_inds": EIndex(torch.as_tensor(bc.copy_inds,
                                                dtype=torch.int64,
                                                device=dev), "Tri", "Tri"),
        "ssa_copy_w": EField(torch.as_tensor(bc.copy_w, dtype=dt,
                                             device=dev), "Tri"),
    })
    md.extras["ssa_diva_rows"] = EField(DivaRows(
        md.TriC, md.mask_TriC, md.x("ssa_bc_free"), md.x("ssa_bc_inf_u"),
        md.x("ssa_bc_inf_v")), "Tri")
    ops = mesh.operators
    for name, M in [("ssa_d_ddx", ops.M2_ddx_b_b), ("ssa_d_ddy", ops.M2_ddy_b_b),
                    ("ssa_d_dxx", ops.M2_d2dx2_b_b),
                    ("ssa_d_dxy", ops.M2_d2dxdy_b_b),
                    ("ssa_d_dyy", ops.M2_d2dy2_b_b)]:
        md.extras[name] = EField(torch.as_tensor(M.diagonal(), dtype=dt,
                                                 device=dev), "Tri")
    md.ssa_has_fix = bool(bc.fix_u.any() or bc.fix_v.any())
    if precond_choice == "block_dense":
        register_bjdense_static(mesh, md)
    elif precond_choice == "two_level":
        register_two_level_static(mesh, md)
    register_sliding_static(C, mesh, md)


def make_solve_ssa_diva(C, md: MeshData, choice: str, bedrock_cdfs=None):
    """Build the stress-balance solve function for SSA / DIVA / SIA+SSA.

    Returned fn(md, Hi, Hs, Hb, SL, Ti, s) ->
      (u_vav_b, v_vav_b, u_3D_b, v_3D_b, n_visc_its, n_Axb_its, aux).

    SIA/SSA is the SSA solve with the SIA velocities added to it (the
    reference's 'add' hybrid scheme). All per-entity static data lives in
    md.extras (registered above).
    """
    if choice not in ("SSA", "DIVA", "SIA/SSA"):
        raise ValueError(f"make_solve_ssa_diva: unknown choice '{choice}'")
    is_diva = choice == "DIVA"
    with_sia = choice == "SIA/SSA"
    krylov_restart = int(getattr(C, "tpu_stress_balance_krylov_restart", 60))
    precond_kind = C.tpu_stress_balance_precond
    precond_deg = int(C.tpu_stress_balance_precond_degree)
    ocean_pressure = C.BC_ice_front == "ocean_pressure"
    n_glen = C.Glens_flow_law_exponent
    no_sliding = C.choice_sliding_law == "no_sliding"
    if "ssa_bc_free" not in md.extras:
        register_ssadiva_static(C, md._host_mesh, md)
    has_fix = md.ssa_has_fix
    register_bedrock_cdfs(md, bedrock_cdfs)

    if not is_diva and no_sliding:
        # Pure SSA (or the SSA part of SIA/SSA) with no sliding: the SSA
        # velocity is identically zero and the reference skips the solve
        # entirely (SSA_main.f90:125-130). Solving with beta = 0 instead
        # would be a free-slip membrane - unbounded velocities.
        def solve_no_slip(md, Hi, Hs, Hb, SL, Ti, s):
            z_b = torch.zeros(md.nTri, dtype=md.A.dtype, device=md.device)
            z3 = torch.zeros((md.nTri, md.nz), dtype=md.A.dtype,
                             device=md.device)
            u_vav, v_vav, u_3D, v_3D = z_b, z_b, z3, z3
            if with_sia:
                masks = determine_masks(md, Hi, Hb, SL)
                A_flow = calc_ice_rheology_glen(
                    C, md, Hi, Hs, Ti, masks["mask_grounded_ice"],
                    masks["mask_floating_ice"])
                u3s, v3s, _, _, _, uvs, vvs = solve_SIA(C, md, Hi, Hs,
                                                        A_flow)
                u_vav, v_vav = u_vav + uvs, v_vav + vvs
                u_3D, v_3D = u_3D + u3s, v_3D + v3s
            return (u_vav, v_vav, u_3D, v_3D, 0, 0, s.solver_aux())
        return solve_no_slip

    def solve(md, Hi, Hs, Hb, SL, Ti, s):
        zeta = md.zeta
        nz = md.nz
        dtype = md.A.dtype
        dev = md.device
        nTri = md.nTri
        bc_free = md.x("ssa_bc_free")
        bc_fix_u = md.x("ssa_bc_fix_u")
        bc_fix_v = md.x("ssa_bc_fix_v")
        masks = determine_masks(md, Hi, Hb, SL)
        A_flow = calc_ice_rheology_glen(C, md, Hi, Hs, Ti,
                                        masks["mask_grounded_ice"],
                                        masks["mask_floating_ice"])
        fraction_gr, fraction_gr_b = calc_grounded_fractions(
            C, md, Hi, Hb, SL, masks["mask_floating_ice"], dHb=s.dHb)
        Hi_eff, _ = calc_effective_thickness(md, Hi, Hb, SL)
        # geometry gradients at FULL accuracy (ops.sparse.exact_mv:
        # bf16-rounded Hs is ~1e-3 absolute slope noise)
        Hs_slope = torch.sqrt(md.M_ddx_a_a.exact_matvec(Hs) ** 2
                              + md.M_ddy_a_a.exact_matvec(Hs) ** 2)

        # driving stress (SSA_DIVA_utilities.f90:24)
        Hi_b = md.M_map_a_b.exact_matvec(Hi)
        tau_dx_b = (-ice_density * grav * Hi_b
                    * md.M_ddx_a_b.exact_matvec(Hs))
        tau_dy_b = (-ice_density * grav * Hi_b
                    * md.M_ddy_a_b.exact_matvec(Hs))

        # ocean-pressure variant (BC_ice_front='ocean_pressure'): the
        # front of this solve's ice mask, its normals and back pressure
        front = calc_front(md, Hi, Hb, SL, Hi_b) if ocean_pressure else None

        bed_roughness = _bed_roughness_fields(C, md, s.bed_roughness)

        Hi_reg = torch.clamp(Hi, min=0.1)
        b_u0 = torch.where(bc_free, -tau_dx_b, 0.0)
        b_v0 = torch.where(bc_free, -tau_dy_b, 0.0)
        if front is not None:
            # front rows balance the ocean back pressure; off rows are 0
            b_u0 = torch.where(front.off, 0.0, torch.where(
                front.is_front, front.tau_ox_b, b_u0))
            b_v0 = torch.where(front.off, 0.0, torch.where(
                front.is_front, front.tau_oy_b, b_v0))
        # f32 floor: a relative residual below ~100*eps_f32 is not
        # reachable in single precision; the Picard loop tolerates the
        # looser inner solve (inexact-Newton argument)
        rtol = C.stress_balance_PETSc_rtol
        if dtype == torch.float32:
            rtol = max(rtol, 1e-5)

        def body(c: _ViscCarry) -> _ViscCarry:
            # horizontal strain rates on the a-grid
            du_dx_a = md.M_ddx_b_a @ c.u
            du_dy_a = md.M_ddy_b_a @ c.u
            dv_dx_a = md.M_ddx_b_a @ c.v
            dv_dy_a = md.M_ddy_b_a @ c.v

            # vertical shear strain rates (DIVA only; Lipscomb 2019 Eq. 36)
            if is_diva:
                eta_reg = torch.clamp(c.eta_3D_b, min=C.visc_eff_min)
                du_dz_b = c.tau_bx[:, None] * zeta[None, :] / eta_reg
                dv_dz_b = c.tau_by[:, None] * zeta[None, :] / eta_reg
                du_dz_a = md.M_map_b_a @ du_dz_b
                dv_dz_a = md.M_map_b_a @ dv_dz_b
            else:
                du_dz_a = torch.zeros_like(A_flow)
                dv_dz_a = torch.zeros_like(A_flow)

            # effective viscosity (Glen)
            A_min = 1e-18
            eta_max = 0.5 * A_min ** (-1.0 / n_glen) * \
                c.eps_sq0 ** ((1.0 - n_glen) / (2.0 * n_glen))
            eps_sq = (du_dx_a ** 2 + dv_dy_a ** 2 + du_dx_a * dv_dy_a
                      + 0.25 * (du_dy_a + dv_dx_a) ** 2)[:, None] \
                + 0.25 * (du_dz_a ** 2 + dv_dz_a ** 2) + c.eps_sq0
            eta_3D_a = 0.5 * A_flow ** (-1.0 / n_glen) * \
                eps_sq ** ((1.0 - n_glen) / (2.0 * n_glen))
            eta_3D_a = torch.clamp(eta_3D_a, C.visc_eff_min, eta_max)
            eta_3D_b = md.M_map_a_b @ eta_3D_a
            eta_vav_a = vertical_average(zeta, eta_3D_a, axis=-1)
            N_a = eta_vav_a * Hi_reg
            N_b = md.M_map_a_b @ N_a
            dN_dx_b = md.M_ddx_a_b @ N_a
            dN_dy_b = md.M_ddy_a_b @ N_a

            # F-integrals (Lipscomb 2019 Eq. 30) and effective friction
            if is_diva:
                zz = zeta.expand(eta_3D_a.shape)
                F1_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                    zz, zeta[None, :] / eta_3D_a, axis=-1)
                F2_3D_a = -Hi_reg[:, None] * integrate_from_base_up(
                    zz, zeta[None, :] ** 2 / eta_3D_a, axis=-1)
                F1_3D_b = md.M_map_a_b @ F1_3D_a
                F2_a1 = F2_3D_a[:, 0].contiguous()
                F2_b1 = md.M_map_a_b @ F2_a1
            else:
                F1_3D_b = c.F1_3D_b
                F2_b1 = torch.zeros_like(N_b)
                F2_a1 = torch.zeros_like(N_a)

            # sliding law -> a-grid friction coefficient
            u_base_a = md.M_map_b_a @ c.u_base
            v_base_a = md.M_map_b_a @ c.v_base
            beta_b_a = calc_basal_friction_coefficient(
                C, md, bed_roughness, u_base_a, v_base_a, Hi, Hi_eff, Hb, SL,
                Hs_slope, fraction_gr, masks)

            if is_diva:
                if no_sliding:
                    beta_eff_a = 1.0 / torch.clamp(F2_a1, min=1e-30)
                else:
                    beta_eff_a = beta_b_a / (1.0 + beta_b_a * F2_a1)
            else:
                beta_eff_a = beta_b_a
            beta_eff_b = md.M_map_a_b @ beta_eff_a
            beta_b_b = md.M_map_a_b @ beta_b_a
            if C.do_GL_subgrid_friction:
                beta_eff_b = beta_eff_b * \
                    fraction_gr_b ** C.subgrid_friction_exponent_on_B_grid

            # linear solve (matrix-free GMRES)
            fields = (N_b, dN_dx_b, dN_dy_b, beta_eff_b)
            A = make_A(md, *fields, front=front)
            b_u, b_v = b_u0, b_v0
            if has_fix:
                # fixed rows: relaxed weighted copy of the previous solution
                # (find_ti_copy_* BCs)
                copy_inds = md.x("ssa_copy_inds")
                copy_w = md.x("ssa_copy_w")
                u_fix = (copy_w * md.ext_Tri(c.u)[copy_inds]).sum(dim=1)
                v_fix = (copy_w * md.ext_Tri(c.v)[copy_inds]).sum(dim=1)
                u_fix = C.visc_it_relax * u_fix + (1 - C.visc_it_relax) * c.u
                v_fix = C.visc_it_relax * v_fix + (1 - C.visc_it_relax) * c.v
                b_u = torch.where(bc_fix_u, u_fix, b_u)
                b_v = torch.where(bc_fix_v, v_fix, b_v)
            Mp = make_preconditioner(precond_kind, md, A, fields, front,
                                     precond_deg, (b_u, b_v))
            res = gmres(A, (b_u, b_v), x0=(c.u, c.v), M=Mp,
                        rtol=rtol,
                        abstol=C.stress_balance_PETSc_abstol,
                        restart=krylov_restart)
            u_new, v_new = res.x

            # velocity limits + relaxation
            speed = torch.sqrt(u_new ** 2 + v_new ** 2)
            lim = torch.where(speed > C.vel_max, C.vel_max / speed, 1.0)
            u_new, v_new = u_new * lim, v_new * lim
            u_new = c.relax * u_new + (1 - c.relax) * c.u
            v_new = c.relax * v_new + (1 - c.relax) * c.v

            # basal velocities + stress
            if is_diva:
                if no_sliding:
                    u_base = torch.zeros_like(u_new)
                    v_base = torch.zeros_like(v_new)
                else:
                    u_base = u_new / (1.0 + beta_b_b * F2_b1)
                    v_base = v_new / (1.0 + beta_b_b * F2_b1)
            else:
                u_base, v_base = u_new, v_new
            tau_bx = u_new * beta_eff_b
            tau_by = v_new * beta_eff_b

            # convergence: L2 norm of change (calc_L2_norm_uv)
            res1 = comm.sum_all((u_new - c.u) ** 2 + (v_new - c.v) ** 2)
            res2 = comm.sum_all((u_new + c.u) ** 2 + (v_new + c.v) ** 2)
            L2 = float(2.0 * res1 / torch.clamp(res2, min=1e-8))

            diverged = L2 > c.L2
            n_div = c.n_diverg + 1 if diverged else 0
            do_rescue = n_div > 2
            relax = c.relax * 0.9 if do_rescue else c.relax
            eps_sq0 = c.eps_sq0 * 1.2 if do_rescue else c.eps_sq0
            n_div = 0 if do_rescue else n_div

            converged = L2 < C.visc_it_norm_dUV_tol
            return _ViscCarry(
                u=u_new, v=v_new, u_base=u_base, v_base=v_base,
                tau_bx=tau_bx, tau_by=tau_by, eta_3D_b=eta_3D_b,
                beta_b_a=beta_b_a, F1_3D_b=F1_3D_b, F2_b1=F2_b1,
                relax=relax, eps_sq0=eps_sq0, L2=L2, n_diverg=n_div,
                it=c.it + 1, n_axb=c.n_axb + res.n_iter, done=converged)

        c = _ViscCarry(
            u=s.u_vav_b, v=s.v_vav_b,
            # warm-start basal velocities from the stored 3-D profile
            # (base layer = u_base by the Lipscomb Eq. 29 reconstruction;
            # the reference keeps DIVA%u_base_b persistent). A zero init
            # makes the sliding law return enormous friction at it 0
            # (beta ~ |u|^(1/m - 1) -> inf), so the first solve of EVERY
            # step collapses the velocity field and the relax=0.2 loop
            # spends ~20 its recovering it.
            u_base=s.u_3D_b[:, -1].contiguous(),
            v_base=s.v_3D_b[:, -1].contiguous(),
            # warm-start the DIVA vertical-shear feedback from the
            # previous step's converged tau_b / eta (the reference keeps
            # these in the persistent DIVA solver state): without it
            # iteration 0 sees du/dz = 0 and the relax=0.2 Picard loop
            # spends ~20 iterations re-converging the feedback EVERY step
            tau_bx=s.visc_tau_bx, tau_by=s.visc_tau_by,
            eta_3D_b=torch.clamp(s.visc_eta_3D_b.to(dtype),
                                 min=C.visc_eff_min),
            beta_b_a=torch.zeros(md.nV, dtype=dtype, device=dev),
            F1_3D_b=torch.zeros((nTri, nz), dtype=dtype, device=dev),
            F2_b1=torch.zeros(nTri, dtype=dtype, device=dev),
            relax=float(C.visc_it_relax),
            eps_sq0=float(C.Glens_flow_law_epsilon_sq_0),
            L2=1e9, n_diverg=0, it=0, n_axb=0, done=False)
        while (not c.done) and c.it <= C.visc_it_nit:
            c = body(c)
        out = c

        # 3-D velocities (Lipscomb 2019 Eq. 29)
        if is_diva:
            beta_b_b = md.M_map_a_b @ out.beta_b_a
            if no_sliding:
                u_3D = out.tau_bx[:, None] * out.F1_3D_b
                v_3D = out.tau_by[:, None] * out.F1_3D_b
            else:
                u_3D = out.u_base[:, None] * (1.0 + beta_b_b[:, None]
                                              * out.F1_3D_b)
                v_3D = out.v_base[:, None] * (1.0 + beta_b_b[:, None]
                                              * out.F1_3D_b)
        else:
            u_3D = out.u[:, None].expand(md.nTri, nz).contiguous()
            v_3D = out.v[:, None].expand(md.nTri, nz).contiguous()

        u_vav, v_vav = out.u, out.v

        if with_sia:
            # hybrid SIA+SSA 'add' scheme (choice_hybrid_SIASSA_scheme)
            u3_sia, v3_sia, _, _, _, uv_sia, vv_sia = solve_SIA(
                C, md, Hi, Hs, A_flow)
            u_vav = u_vav + uv_sia
            v_vav = v_vav + vv_sia
            u_3D = u_3D + u3_sia
            v_3D = v_3D + v3_sia

        aux = {"visc_tau_bx": out.tau_bx, "visc_tau_by": out.tau_by,
               "visc_eta_3D_b": out.eta_3D_b}
        return (u_vav, v_vav, u_3D, v_3D, out.it, out.n_axb, aux)

    return solve


def _bed_roughness_fields(C, md: MeshData, generic=None):
    """Bed roughness fields per sliding law (reference bed_roughness
    model). `generic` is the (possibly nudged) per-vertex roughness
    parameter carried in IceState; when zero/None the uniform config
    values apply."""
    nV = md.nV
    dtype = md.A.dtype
    dev = md.device
    law = C.choice_sliding_law
    beta_sq = {"Weertman": C.slid_Weertman_beta_sq_uniform,
               "Tsai2015": C.slid_Tsai2015_beta_sq_uniform,
               "Schoof2005": C.slid_Schoof2005_beta_sq_uniform,
               }.get(law, C.slid_Weertman_beta_sq_uniform)
    phi = {"Coulomb": C.slid_Coulomb_phi_fric_uniform,
           "Budd": C.slid_Budd_phi_fric_uniform,
           "Zoet-Iverson": C.slid_ZI_phi_fric_uniform,
           }.get(law, C.slid_Budd_phi_fric_uniform)
    alpha_sq = {"Tsai2015": C.slid_Tsai2015_alpha_sq_uniform,
                "Schoof2005": C.slid_Schoof2005_alpha_sq_uniform,
                }.get(law, 0.5)
    full = lambda v: torch.full((nV,), v, dtype=dtype, device=dev)
    beta_sq_f = full(beta_sq)
    phi_f = full(phi)
    if generic is not None:
        use = generic > 0
        if law in ("Weertman", "Tsai2015", "Schoof2005"):
            beta_sq_f = torch.where(use, generic, beta_sq_f)
        else:
            phi_f = torch.where(use, generic, phi_f)
    return {
        "beta_sq": beta_sq_f,
        "till_friction_angle": phi_f,
        "alpha_sq": full(alpha_sq),
    }
