"""Explicit halo exchange for sharded mesh fields.

Counterpart of the reference's parallel/halo.py (its re-design of
src/UPSY/basic/mpi_parallelisation/halo_exchange_mod.f90 and
mesh_halo_exchange.f90, where each process owns a contiguous vertex range
and exchanges "border" entries with its neighbours):

- the entities are split into P contiguous, equal-sized blocks (padded);
- on the host, for every rank, the *send set* (the owned entries another
  rank references) and a *recv map* (where each of its halo entries lies
  in the ranks' concatenated send buffers) are built in numpy, the same
  integers as the reference's;
- at run time each rank packs its send buffer, one `all_gather` moves the
  buffers, and a gather builds the extended local vector [x_own ; x_halo];
- sparse operators are re-indexed on the host into this extended local
  column space, so the product on a rank is local: the port's
  `stack_spmv` kernel on the rank's block.

One all_gather of the padded send buffers moves P*Hs values a rank; a 2-D
mesh's halo is about sqrt(nL), far less than the field, and unlike a ring
of point-to-point sends it is right for any partition adjacency.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sparse import EllMatrix
from .comm import HaloTables, halo_extend, rank_ctx


@dataclass
class HaloPlan:
    """Host tables of the halo exchange of a 1-D contiguous partition:
    P blocks of nL rows (P * nL >= n)."""

    send_idx: np.ndarray   # [P, Hs] int32 local rows each rank sends (pad 0)
    send_mask: np.ndarray  # [P, Hs] bool
    recv_map: np.ndarray   # [P, Hh] int32 slots in the flat [P*Hs] buffer
    recv_mask: np.ndarray  # [P, Hh] bool
    n: int                 # true (unpadded) global length
    n_parts: int
    nL: int

    @property
    def Hs(self):
        return self.send_idx.shape[1]

    @property
    def Hh(self):
        return self.recv_map.shape[1]

    def tables(self, rank, device) -> HaloTables:
        """Rank `rank`'s rows as tensors on `device`."""
        t = lambda a, dt: torch.as_tensor(a[rank], dtype=dt, device=device)
        return HaloTables(t(self.send_idx, torch.int64),
                          t(self.send_mask, torch.bool),
                          t(self.recv_map, torch.int64),
                          t(self.recv_mask, torch.bool))


def _refs(col_indices_list):
    rows = np.concatenate([np.asarray(r, dtype=np.int64).ravel()
                           for r, _ in col_indices_list])
    cols = np.concatenate([np.asarray(c, dtype=np.int64).ravel()
                           for _, c in col_indices_list])
    return rows, cols


def build_halo_plan(col_indices_list, n: int, n_parts: int) -> HaloPlan:
    """Build halo tables from the union of operator column references.

    col_indices_list: list of (rows, cols) int arrays of every global
    (row -> col) reference that sharded kernels will make (operator
    structure + neighbour tables). Rows determine the requesting rank,
    cols the owner.
    """
    nL = (n + n_parts - 1) // n_parts
    rows, cols = _refs(col_indices_list)
    p_row = rows // nL
    p_col = cols // nL
    off = p_row != p_col                      # off-rank references
    # per-owner send sets: unique cols requested by someone else
    send_sets = [np.unique(cols[off & (p_col == q)])
                 for q in range(n_parts)]
    Hs = max(1, max(len(s) for s in send_sets))
    send_idx = np.zeros((n_parts, Hs), dtype=np.int32)
    send_mask = np.zeros((n_parts, Hs), dtype=bool)
    for q, s in enumerate(send_sets):
        send_idx[q, :len(s)] = s - q * nL      # local index on owner
        send_mask[q, :len(s)] = True

    # per-requester halo (recv) sets and their slot in the gathered buffer
    recv_sets = [np.unique(cols[off & (p_row == p)])
                 for p in range(n_parts)]
    Hh = max(1, max(len(s) for s in recv_sets))
    recv_map = np.zeros((n_parts, Hh), dtype=np.int32)
    recv_mask = np.zeros((n_parts, Hh), dtype=bool)
    for p, s in enumerate(recv_sets):
        q = s // nL                            # owner of each halo entry
        pos = np.array([np.searchsorted(send_sets[int(qq)], gg)
                        for qq, gg in zip(q, s)], dtype=np.int64) \
            if len(s) else np.zeros(0, dtype=np.int64)
        recv_map[p, :len(s)] = (q * Hs + pos).astype(np.int32)
        recv_mask[p, :len(s)] = True

    return HaloPlan(send_idx, send_mask, recv_map, recv_mask, n, n_parts, nL)


def _halo_sets(col_indices_list, n, n_parts):
    """Host-side: per-rank sorted halo global index sets (for operator
    re-indexing). Must match build_halo_plan's recv ordering."""
    nL = (n + n_parts - 1) // n_parts
    rows, cols = _refs(col_indices_list)
    off = (rows // nL) != (cols // nL)
    return [np.unique(cols[off & (rows // nL == p)])
            for p in range(n_parts)], nL


def halo_exchange(x_local, send_idx, send_mask, recv_map, recv_mask,
                  group):
    """This rank's block x_local [nL(, d)] extended with its halo values
    [nL + Hh(, d)]; the tables are this rank's rows of a HaloPlan, `group`
    the RankGroup of the run."""
    with rank_ctx(group):
        return halo_extend(x_local, HaloTables(send_idx, send_mask,
                                               recv_map, recv_mask))


def _row_major(M):
    """(inds [n_rows, K], vals [n_rows, K]) of a port EllMatrix, or of an
    (inds, vals) pair already row-major."""
    if isinstance(M, EllMatrix):
        return (M.cols.cpu().numpy().T, M.vals[0].cpu().numpy().T)
    return np.asarray(M[0]), np.asarray(M[1])


def shard_ell(M, plan: HaloPlan, col_plan: HaloPlan | None = None,
              halo_sets=None):
    """Re-index a global ELL operator (a port EllMatrix, or row-major
    (inds, vals)) into per-rank extended-local form.

    Returns (inds [P, nLr, K] int32, vals [P, nLr, K], n_cols): column
    indices address [x_own ; x_halo] of length n_cols = nLc + Hh, and the
    row space is padded to P * nLr.
    """
    cp = col_plan or plan
    inds, vals = _row_major(M)
    n_rows, K = inds.shape
    Pn = plan.n_parts
    nLr = (n_rows + Pn - 1) // Pn
    nLc = cp.nL
    if halo_sets is None:
        raise ValueError("halo_sets (from _halo_sets) required")

    inds_p = np.zeros((Pn, nLr, K), dtype=np.int32)
    vals_p = np.zeros((Pn, nLr, K), dtype=vals.dtype)
    for p in range(Pn):
        r0, r1 = p * nLr, min((p + 1) * nLr, n_rows)
        ip = inds[r0:r1]
        vp = vals[r0:r1]
        own = (ip // nLc) == p
        loc = np.where(own, ip - p * nLc, 0)
        hs = halo_sets[p]
        hslot = np.searchsorted(hs, ip)
        hslot = np.clip(hslot, 0, max(len(hs) - 1, 0))
        # entries with vals==0 are padding (index 0, owned by rank 0): for
        # p>0 those become bogus halo lookups; zero them explicitly.
        valid = vp != 0
        ext = np.where(own, loc, nLc + hslot)
        inds_p[p, : r1 - r0] = np.where(valid, ext, 0)
        vals_p[p, : r1 - r0] = np.where(valid, vp, 0)
    return inds_p, vals_p, nLc + cp.Hh


def local_spmv(inds, vals, x_ext):
    """This rank's operator slice (port EllMatrix tables: cols [K, nLr],
    vals [1, K, nLr]) applied to the extended local vector
    [nLc + Hh(, d)], through the stack_spmv kernel (its plain version for
    CPU tensors)."""
    return EllMatrix(inds, vals, x_ext.shape[0]) @ x_ext


def pad_field(x, plan: HaloPlan):
    """Pad a global [n(, d)] field to [P*nL(, d)] for even sharding."""
    n_pad = plan.n_parts * plan.nL
    out = x.new_zeros((n_pad,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def make_sharded_spmv(M: EllMatrix, n_cols: int, group, extra_refs=()):
    """y = M @ x sharded over the ranks of `group` (a RankGroup), called
    on every rank with the same replicated x [n_cols]: this rank takes
    its block, exchanges its halo, applies its extended-local slice with
    the stack_spmv kernel, and the blocks are gathered back into the full
    y [n_rows] on every rank. Returns (apply, plan). Shows the whole
    pipeline on one operator; parallel/dist.py runs the model step on the
    same tables."""
    inds, vals = _row_major(M)
    Pn, rank, dev = group.world, group.rank, group.device
    rows = np.broadcast_to(np.arange(inds.shape[0])[:, None], inds.shape)
    m = vals != 0
    refs = [(rows[m], inds[m])] + list(extra_refs)
    plan = build_halo_plan(refs, n_cols, Pn)
    hs, _ = _halo_sets(refs, n_cols, Pn)
    inds_p, vals_p, _ = shard_ell((inds, vals), plan, halo_sets=hs)
    cols = torch.as_tensor(np.ascontiguousarray(inds_p[rank].T), device=dev)
    v = torch.as_tensor(np.ascontiguousarray(vals_p[rank].T)[None],
                        dtype=M.vals.dtype, device=dev)
    t = plan.tables(rank, dev)
    n_rows = inds.shape[0]

    def apply(x):
        xp = pad_field(x, plan)
        blk = xp[rank * plan.nL:(rank + 1) * plan.nL]
        x_ext = halo_exchange(blk, t.send_idx, t.send_mask, t.recv_map,
                              t.recv_mask, group)
        y = local_spmv(cols, v, x_ext)
        parts = [torch.empty_like(y) for _ in range(Pn)]
        dist.all_gather(parts, y.contiguous(), group=group.group)
        return torch.cat(parts)[:n_rows]

    return apply, plan
