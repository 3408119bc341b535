"""Multi-device runs: the PC ice-dynamics step sharded over P ranks.

Counterpart of the reference's parallel/dist.py (its equivalent of the
distributed-memory layer src/UPSY/basic/mpi_parallelisation/ and
mesh_parallelisation.f90): the three mesh entity spaces (vertices,
triangles, edges) are split into P contiguous equal blocks (padded),
every operator and connectivity table is re-indexed into each rank's
*extended local* column space [owned ; halo], and the halo tables are
built from the union of all cross-block references - the reference's
type_par_arr_info halo ranges, generalised to arbitrary (row space ->
column space) references.

Where the reference runs one program over P devices (shard_map), the port
runs one process a rank (parallel/launch.py; torchrun): each process holds
its own block of the converted MeshData, which has the same field names
as the single-device one, so the physics code (the PC step, the DIVA
viscosity iteration, the Krylov solvers, mass conservation and the
thermodynamics) runs unchanged on it: gathers go through md.ext_V /
ext_Tri / ext_E (one all_gather of the small send buffers), operator
applies through `DistEllMatrix` / `DistEllStack` (the halo exchange, then
the stack_spmv / diva_apply kernel on the rank's block), reductions
through parallel.comm (all_reduce).

Every table is built on the host in numpy, the same integers as the
reference's. The stack of the five M2 operators is the port's own
single-device stack with its columns re-indexed: each row keeps its
entries in the same order, so the sharded apply, gathered, is the
single-device apply to the bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core.mesh_data import MeshData, EField, EIndex
from ..ops.sparse import EllMatrix, EllStack
from ..ops.cuda_spmv import DivaRows
from . import comm
from .halo import HaloPlan
from .sharding import RankGroup

# stress balances whose sharded step holds the single-device one (the
# reference's own tests cover DIVA and SIA; SSA and SIA/SSA are the same
# code path as DIVA). The reference's BPA and hybrid solvers build their
# tables from the full host mesh inside the solver factory, so its sharded
# step cannot run them (ROADMAP C); the port refuses them by name.
SHARDED_STRESS_BALANCES = ("none", "SIA", "SSA", "DIVA", "SIA/SSA")


def check_shardable(C, n_ranks):
    """Refuse, by name, a stress balance the sharded step does not run."""
    choice = C.choice_stress_balance_approximation
    if choice not in SHARDED_STRESS_BALANCES:
        raise NotImplementedError(
            f"choice_stress_balance_approximation = {choice!r} does not run "
            f"sharded (tpu_n_devices = {n_ranks}): the reference's sharded "
            f"step cannot run its solver (ROADMAP C); sharded: "
            f"{', '.join(SHARDED_STRESS_BALANCES)}")


# ---------------------------------------------------------------------------
# Distributed operators
# ---------------------------------------------------------------------------

@dataclass
class DistEllMatrix(EllMatrix):
    """Extended-local ELL operator of one rank: `M @ x` takes the rank's
    block x [nL(, d)], extends it with its halo (the column space's
    tables) and applies the rank's rows [nLr] through the kernel."""

    halo: Any = None    # HaloTables of the column space

    def apply(self, x, exact=False):
        return super().apply(comm.halo_extend(x, self.halo), exact)

    def to(self, device):
        return type(self)(self.cols.to(device), self.vals.to(device),
                          self.n_cols, self.halo.to(device))


@dataclass
class DistEllStack(EllStack):
    """Stack of operators sharing one sparsity pattern and ONE halo
    exchange (the five M2_* b-grid operators of the DIVA hot path)."""

    halo: Any = None

    def apply(self, x, exact=False):
        return super().apply(comm.halo_extend(x, self.halo), exact)

    def to(self, device):
        return type(self)(self.cols.to(device), self.vals.to(device),
                          self.n_cols, self.halo.to(device))


# ---------------------------------------------------------------------------
# Halo-plan construction (host side, numpy)
# ---------------------------------------------------------------------------

class _SpacePlan:
    """Halo plan for one entity space (column side)."""

    def __init__(self, n: int, n_parts: int):
        self.n = n
        self.P = n_parts
        self.nL = (n + n_parts - 1) // n_parts
        self.refs_dev = []   # requesting rank per reference
        self.refs_col = []   # referenced global index

    def add_refs(self, req_dev, cols):
        req_dev = np.asarray(req_dev, np.int64).ravel()
        cols = np.asarray(cols, np.int64).ravel()
        off = req_dev != cols // self.nL
        self.refs_dev.append(req_dev[off])
        self.refs_col.append(cols[off])

    def finalise(self):
        if self.refs_dev:
            dev = np.concatenate(self.refs_dev)
            col = np.concatenate(self.refs_col)
        else:
            dev = np.zeros(0, np.int64)
            col = np.zeros(0, np.int64)
        Pn, nL = self.P, self.nL
        owner = col // nL
        # per-rank sorted halo sets (recv side)
        self.halo_sets = [np.unique(col[dev == p]) for p in range(Pn)]
        # per-owner send sets: union of what any other rank requests
        send_sets = [np.unique(col[owner == q]) for q in range(Pn)]
        Hs = max(1, max((len(s) for s in send_sets), default=1))
        Hh = max(1, max((len(h) for h in self.halo_sets), default=1))
        send_idx = np.zeros((Pn, Hs), np.int32)
        send_mask = np.zeros((Pn, Hs), bool)
        for q, ss in enumerate(send_sets):
            send_idx[q, :len(ss)] = ss - q * nL
            send_mask[q, :len(ss)] = True
        recv_map = np.zeros((Pn, Hh), np.int32)
        recv_mask = np.zeros((Pn, Hh), bool)
        for p, hs in enumerate(self.halo_sets):
            if not len(hs):
                continue
            q = hs // nL
            pos = np.array([np.searchsorted(send_sets[int(qq)], g)
                            for qq, g in zip(q, hs)], np.int64)
            recv_map[p, :len(hs)] = (q * Hs + pos).astype(np.int32)
            recv_mask[p, :len(hs)] = True
        self.Hs, self.Hh = Hs, Hh
        self.plan = HaloPlan(send_idx, send_mask, recv_map, recv_mask,
                             self.n, Pn, nL)

    def reindex(self, row_dev, cols, valid):
        """Global col ids -> extended-local ids for rows on row_dev.

        row_dev: [n_rows] rank of each row; cols/valid: [n_rows, ...]."""
        cols = np.asarray(cols, np.int64)
        rd = np.asarray(row_dev, np.int64).reshape(
            (-1,) + (1,) * (cols.ndim - 1))
        owner = cols // self.nL
        own = owner == rd
        loc = cols - rd * self.nL
        slot = np.zeros_like(cols)
        for p in range(self.P):
            m = np.broadcast_to(rd == p, cols.shape) & ~own & valid
            if m.any():
                slot[m] = np.searchsorted(self.halo_sets[p], cols[m])
        ext = np.where(own, loc, self.nL + slot)
        return np.where(valid, ext, 0).astype(np.int32)


def _pad_rows(a, n_pad, fill=0):
    """Pad the leading axis of a host array to n_pad with fill."""
    a = np.asarray(a)
    if a.shape[0] == n_pad:
        return a
    pad = np.full((n_pad - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# The MeshData conversion
# ---------------------------------------------------------------------------

_OP_SPACES = {
    "M_ddx_a_a": ("V", "V"), "M_ddy_a_a": ("V", "V"),
    "M_map_a_b": ("Tri", "V"), "M_ddx_a_b": ("Tri", "V"),
    "M_ddy_a_b": ("Tri", "V"),
    "M_map_b_a": ("V", "Tri"), "M_ddx_b_a": ("V", "Tri"),
    "M_ddy_b_a": ("V", "Tri"),
    "M_ddx_b_b": ("Tri", "Tri"), "M_ddy_b_b": ("Tri", "Tri"),
    "M2_ddx_b_b": ("Tri", "Tri"), "M2_ddy_b_b": ("Tri", "Tri"),
    "M2_d2dx2_b_b": ("Tri", "Tri"), "M2_d2dxdy_b_b": ("Tri", "Tri"),
    "M2_d2dy2_b_b": ("Tri", "Tri"),
}

# the connectivity tables: (row space, column space, mask field or None)
_TABLES = {
    "C": ("V", "V", "mask_C"), "VE": ("V", "E", "mask_C"),
    "EV": ("E", "V", None), "ETri": ("E", "Tri", "mask_ETri"),
    "Tri": ("Tri", "V", None), "TriC": ("Tri", "Tri", "mask_TriC"),
}

# the per-entity fields with the reference's padding fills (row space,
# fill; None: the median, for the resolution R)
_FIELDS = {
    "V": ("V", 9.9e9), "TriGC": ("Tri", 9.9e9), "A": ("V", 1.0),
    "TriA": ("Tri", 1.0), "R": ("V", None), "mask_C": ("V", False),
    "Cw": ("V", 0.0), "D_x": ("V", 0.0), "D_y": ("V", 0.0),
    "D": ("V", 1.0), "mask_ETri": ("E", False), "VBI": ("V", 0),
    "border_N": ("V", False), "border_E": ("V", False),
    "border_S": ("V", False), "border_W": ("V", False),
    "mask_TriC": ("Tri", False), "E_len": ("E", 1e30),
    "rev_pos": ("V", 0),
}


@dataclass
class DistMD:
    """A single-device MeshData converted for P ranks, on the host: every
    per-entity array padded to P blocks and stored block after block
    (rank p's rows are [p*nL, (p+1)*nL) of its space), tables and
    operator columns re-indexed into the ranks' extended-local spaces.
    `local(rank, device)` is one rank's MeshData."""

    n_parts: int
    spaces: dict            # 'V' | 'Tri' | 'E' -> _SpacePlan
    arrays: dict            # name -> (space, [P*nL, ...] array)
    ops: dict               # name -> (row space, cols [P*nLr, K], vals)
    m2: tuple               # (cols [P*nLt, K], vals [P*nLt, K, 5])
    extras: dict            # name -> (kind, ...)
    md: MeshData            # the single-device source (zeta, dtype, mesh)

    def local(self, rank, device) -> MeshData:
        """Rank `rank`'s block of the mesh data, on `device`."""
        sp = self.spaces
        md0 = self.md
        dev = torch.device(device)

        def blk(space, a):
            nL = sp[space].nL
            return np.ascontiguousarray(a[rank * nL:(rank + 1) * nL])

        def t(space, a):
            return torch.as_tensor(blk(space, a), device=dev)

        halo = {s: sp[s].plan.tables(rank, dev) for s in sp}
        kw = {n: t(s, a) for n, (s, a) in self.arrays.items()}
        for name, (rs, cols, vals) in self.ops.items():
            cs = _OP_SPACES[name][1]
            kw[name] = DistEllMatrix(
                torch.as_tensor(blk(rs, cols).T.copy(), device=dev),
                torch.as_tensor(blk(rs, vals).T.copy()[None], device=dev),
                sp[cs].nL + sp[cs].Hh, halo[cs])
        cols, vals = self.m2
        kw["M2_stack"] = DistEllStack(
            torch.as_tensor(blk("Tri", cols).T.copy(), device=dev),
            torch.as_tensor(np.moveaxis(blk("Tri", vals), (0, 1, 2),
                                        (2, 1, 0)).copy(), device=dev),
            sp["Tri"].nL + sp["Tri"].Hh, halo["Tri"])
        md = MeshData(zeta=md0.zeta.to(dev), zeta_stag=md0.zeta_stag.to(dev),
                      halo_V=halo["V"], halo_Tri=halo["Tri"],
                      halo_E=halo["E"], extras={}, **kw)
        for name, e in self.extras.items():
            kind = e[0]
            if kind == "field":
                md.extras[name] = EField(t(e[1], e[2]), e[1])
            elif kind == "index":
                md.extras[name] = EIndex(t(e[1], e[3]), e[1], e[2])
            elif kind == "rows":
                free, inf_u, inf_v = (t("Tri", a) for a in e[1:])
                md.extras[name] = EField(DivaRows(
                    md.TriC, md.mask_TriC, free, inf_u, inf_v), "Tri")
            else:                       # replicated, shared with the source
                md.extras[name] = e[1]
        md._host_mesh = md0._host_mesh
        if hasattr(md0, "ssa_has_fix"):
            md.ssa_has_fix = md0.ssa_has_fix
        return md


def build_dist_md(mesh, md: MeshData, n_parts: int) -> DistMD:
    """Convert a single-device MeshData (and its registered extras) into
    the block-after-block form of P = n_parts ranks (host numpy)."""
    Pn = n_parts
    spaces = {"V": _SpacePlan(mesh.nV, Pn),
              "Tri": _SpacePlan(mesh.nTri, Pn),
              "E": _SpacePlan(mesh.nE, Pn)}
    dev_of = {s: np.arange(sp.n) // sp.nL for s, sp in spaces.items()}
    n_pad = {s: sp.nL * Pn for s, sp in spaces.items()}

    # -- collect references ---------------------------------------------
    op_arrays = {}
    for name, (rs, cs) in _OP_SPACES.items():
        M = getattr(md, name)
        inds = _host(M.cols).T
        vals = _host(M.vals[0]).T
        m = vals != 0
        op_arrays[name] = (inds, vals, m)
        rd = np.broadcast_to(dev_of[rs][:, None], inds.shape)
        spaces[cs].add_refs(rd[m], inds[m])

    tbls = {}
    for name, (rs, cs, mname) in _TABLES.items():
        tbl = _host(getattr(md, name))
        m = (_host(getattr(md, mname)) if mname is not None
             else np.ones(tbl.shape, bool))
        tbls[name] = (rs, cs, tbl, m)
        rd = np.broadcast_to(dev_of[rs][:, None], tbl.shape)
        spaces[cs].add_refs(rd[m], tbl[m])

    extras = dict(md.extras or {})
    for name, e in extras.items():
        if isinstance(e, EIndex):
            arr = _host(e.arr)
            rd = np.broadcast_to(dev_of[e.row].reshape(
                (-1,) + (1,) * (arr.ndim - 1)), arr.shape)
            spaces[e.col].add_refs(rd, arr)

    for sp in spaces.values():
        sp.finalise()

    # -- tables, fields --------------------------------------------------
    arrays = {}
    for name, (rs, cs, tbl, m) in tbls.items():
        ext = spaces[cs].reindex(dev_of[rs], tbl, m).astype(np.int64)
        arrays[name] = (rs, _pad_rows(ext, n_pad[rs], 0))
    for name, (s, fill) in _FIELDS.items():
        a = _host(getattr(md, name))
        if fill is None:
            fill = float(np.median(a))
        arrays[name] = (s, _pad_rows(a, n_pad[s], fill))

    # -- operators -------------------------------------------------------
    ops = {}
    for name, (rs, cs) in _OP_SPACES.items():
        inds, vals, m = op_arrays[name]
        ext = spaces[cs].reindex(dev_of[rs], inds, m)
        ops[name] = (rs, _pad_rows(ext, n_pad[rs], 0),
                     _pad_rows(vals, n_pad[rs], 0))

    # the five-operator stack: the single-device tables, columns
    # re-indexed, entries in their order (an entry where all five are 0
    # is padding: column 0)
    S = md.M2_stack
    s_inds = _host(S.cols).T                          # [nTri, K]
    s_vals = np.moveaxis(_host(S.vals), (0, 1, 2), (2, 1, 0))  # [nTri, K, 5]
    s_ext = spaces["Tri"].reindex(dev_of["Tri"], s_inds,
                                  (s_vals != 0).any(axis=2))
    m2 = (_pad_rows(s_ext, n_pad["Tri"], 0),
          _pad_rows(s_vals, n_pad["Tri"], 0))

    # -- extras ------------------------------------------------------------
    ex = {}
    for name, e in extras.items():
        if isinstance(e, EIndex):
            arr = _host(e.arr)
            ext = spaces[e.col].reindex(dev_of[e.row], arr,
                                        np.ones(arr.shape, bool))
            ex[name] = ("index", e.row, e.col,
                        _pad_rows(ext.astype(np.int64), n_pad[e.row], 0))
        elif isinstance(e.arr, DivaRows):
            r = e.arr
            ex[name] = ("rows",) + tuple(
                _pad_rows(_host(a), n_pad["Tri"], False)
                for a in (r.free, r.inf_u, r.inf_v))
        elif e.row in spaces:
            a = _host(e.arr)
            fill = False if a.dtype == bool else 0
            ex[name] = ("field", e.row, _pad_rows(a, n_pad[e.row], fill))
        elif e.row == "scalar":
            # a replicated slot (the flow-factor tuning's glen_A_scale):
            # shared, so that what the region writes into it holds here
            ex[name] = ("shared", e)
        # other row spaces (the dense block-Jacobi and two-level tables,
        # rows 'BJDnnz', 'C2nnz', ...) are single-device only: dropped,
        # and the solver takes the 2x2 block-Jacobi (ssadiva)

    return DistMD(Pn, spaces, arrays, ops, m2, ex, md)


# ---------------------------------------------------------------------------
# State conversion + the sharded step
# ---------------------------------------------------------------------------

def _walk(s, fn, path=()):
    """s with fn(path, tensor) applied to every tensor of its (nested)
    dataclass fields; other fields unchanged."""
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = fn(path + (f.name,), v)
        elif dataclasses.is_dataclass(v):
            out[f.name] = _walk(v, fn, path + (f.name,))
    return dataclasses.replace(s, **out)


def _mesh_digest(mesh):
    h = hashlib.sha256()
    for a in (mesh.V, mesh.Tri, mesh.C):
        h.update(np.ascontiguousarray(a).tobytes())
    return int.from_bytes(h.digest()[:7], "little")


class ShardedModel:
    """The PC ice-dynamics step (and the fused thermodynamics) of a region
    sharded over the ranks of a process group; every rank holds the
    region and builds its own ShardedModel from it."""

    def __init__(self, C, region, n_ranks: int, group: RankGroup = None):
        from ..core.ice.pc import make_pc_step
        check_shardable(C, n_ranks)
        self.group = group or RankGroup.of_world(n_ranks, region.device)
        if self.group.world != n_ranks:
            raise RuntimeError(f"tpu_n_devices = {n_ranks} but the rank "
                               f"group has world size {self.group.world}")
        self.region = region
        mesh = region.mesh
        self._check_same_mesh(mesh)
        self.nV, self.nTri = mesh.nV, mesh.nTri
        self.dist_md = build_dist_md(mesh, region.md, n_ranks)
        self.spaces = self.dist_md.spaces
        self.rank = self.group.rank
        self.device = self.group.device
        self.md = self.dist_md.local(self.rank, self.device)
        self._extra_src = {k: e.arr for k, e in (region.md.extras or {})
                           .items() if k in self.md.extras
                           and self.dist_md.extras[k][0] == "field"}
        self.pc_step = make_pc_step(C, self.md)
        self._thermo = None
        if getattr(region, "do_thermo", False):
            from ..core.ice.thermodynamics import (make_heat_solver,
                                                   run_thermodynamics)
            heat = make_heat_solver(C, self.md)
            dt_th = C.dt_thermodynamics
            self._thermo = lambda s, T_surf, SMB, BMB: run_thermodynamics(
                C, self.md, s, dt_th, T_surf, SMB, BMB, heat)
        self.dt_thermodynamics = C.dt_thermodynamics
        self._leaf_space = None

    def _check_same_mesh(self, mesh):
        """Every rank built the same mesh (a remesh is host numpy run on
        every rank; a difference would only show later, as a hang)."""
        d = _mesh_digest(mesh)
        t = torch.tensor([d, -d], dtype=torch.int64, device=self.group.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group.group)
        if int(t[0]) != d or -int(t[1]) != d:
            raise RuntimeError(
                f"rank {self.group.rank}: the ranks built different meshes "
                f"(nV {mesh.nV}); a sharded step needs the same mesh on "
                f"every rank")

    # -- blocks of full fields ---------------------------------------------

    def _block(self, x, space):
        nL = self.spaces[space].nL
        out = x.new_zeros((nL,) + tuple(x.shape[1:]))
        part = x[self.rank * nL:(self.rank + 1) * nL]
        out[:part.shape[0]] = part
        return out

    def _space_of(self, x):
        n = x.shape[0] if x.ndim else -1
        return "V" if n == self.nV else ("Tri" if n == self.nTri else None)

    def pad_field_V(self, x):
        """This rank's block of a full vertex field (SMB, BMB, T_surf)."""
        return self._block(x, "V")

    def _refresh_extras(self):
        """Take over the per-entity extras the region replaced since the
        last call (the Salle2025 effective pressure is rewritten at every
        hydrology event)."""
        src = self.region.md.extras
        for k, old in self._extra_src.items():
            e = src.get(k)
            if e is not None and e.arr is not old:
                sp = self.md.extras[k].row
                self.md.extras[k] = EField(self._block(e.arr, sp), sp)
                self._extra_src[k] = e.arr

    def to_dist(self, state):
        """This rank's blocks of a full (replicated) ice state."""
        self._refresh_extras()
        spaces = {}

        def f(path, x):
            sp = self._space_of(x)
            if sp is None:
                return x
            spaces[path] = sp
            return self._block(x, sp)
        out = _walk(state, f)
        self._leaf_space = spaces
        return out

    def from_dist(self, state_d):
        """The full state, gathered from every rank's blocks (on every
        rank)."""
        spaces = self._leaf_space
        g = self.group
        n = {"V": self.nV, "Tri": self.nTri}

        def f(path, x):
            sp = spaces.get(path)
            if sp is None:
                return x
            wire = x.to(torch.uint8) if x.dtype == torch.bool else x
            parts = [torch.empty_like(wire) for _ in range(g.world)]
            dist.all_gather(parts, wire.contiguous(), group=g.group)
            full = torch.cat(parts)[:n[sp]]
            return full.bool() if x.dtype == torch.bool else full
        return _walk(state_d, f)

    # -- stepping ------------------------------------------------------------

    def _fields(self, SMB, BMB, LMB):
        z = torch.zeros(self.spaces["V"].nL, dtype=self.md.A.dtype,
                        device=self.device)
        return tuple(z if f is None else f for f in (SMB, BMB, LMB))

    def step(self, state_d, dt_max, SMB=None, BMB=None, LMB=None):
        """One sharded PC step; the fields are this rank's blocks."""
        SMB, BMB, LMB = self._fields(SMB, BMB, LMB)
        with comm.rank_ctx(self.group):
            return self.pc_step(self.md, state_d, dt_max, SMB=SMB, BMB=BMB,
                                LMB=LMB)

    def multistep(self, state_d, t_stop, dt_max, SMB=None, BMB=None,
                  LMB=None, T_surf=None, t_th=0.0):
        """Sharded fast-forward: PC steps until the prediction window
        covers t_stop, each followed, when `T_surf` is given, by the
        thermodynamics steps whose times it passed (on the ice
        interpolated to each; the sharded twin of the region's catch-up).
        Every loop condition reads replicated host scalars, so the ranks
        agree on the step count without a collective of their own.
        Returns (state_d, n_steps, t_thermo_next, n_thermo_steps,
        n_unstable columns, summed over ranks)."""
        from ..core.ice.pc import interpolate_ice_to_time
        SMB, BMB, LMB = self._fields(SMB, BMB, LMB)
        thermo = self._thermo if T_surf is not None else None
        s, n, n_th = state_d, 0, 0
        n_unstable = torch.zeros((), dtype=torch.int64, device=self.device)
        with comm.rank_ctx(self.group):
            while s.t_Hi_next < t_stop - 1e-9:
                # overshoot semantics: the ice window extends past t_stop
                # and the region interpolates Hi inside it
                s = self.pc_step(self.md, s, dt_max, SMB=SMB, BMB=BMB,
                                 LMB=LMB)
                n += 1
                if thermo is None:
                    continue
                while t_th <= s.t_Hi_next + 1e-9:
                    si = interpolate_ice_to_time(s, t_th)
                    Ti_new, nu = thermo(si, T_surf, SMB, BMB)
                    s = s.replace(Ti=Ti_new)
                    n_unstable = n_unstable + comm.gsum(nu)
                    t_th = t_th + self.dt_thermodynamics
                    n_th += 1
        return s, n, t_th, n_th, n_unstable

    def halo_stats(self):
        """Per-space halo/occupancy diagnostics: local block sizes,
        halo-slot sizes, and the occupancy of the padded local blocks
        (useful entities / padded size)."""
        out = {}
        for name, sp in self.spaces.items():
            halo_sizes = [int(len(h)) for h in sp.halo_sets]
            out[name] = {
                "n_global": int(sp.n),
                "n_local_padded": int(sp.nL),
                "occupancy": round(sp.n / (sp.nL * sp.P), 4),
                "halo_recv_max": int(sp.Hh),
                "halo_recv_mean": round(float(np.mean(halo_sizes)), 1),
                "halo_frac_of_local": round(sp.Hh / max(sp.nL, 1), 4),
            }
        return out
