"""LADDIE: the one-layer ocean boundary-layer (ice-shelf melt) plume model.

Port of the JAX package's models/laddie.py (a re-design of the
reference's src/LADDIE/, Lambert et al. 2023): the depth-integrated plume
(H, U, V, T, S) under the ice shelf, integrated in pseudo-time with the
3-stage forward-backward Runge-Kutta scheme (laddie_integration.f90:72,
Lilly et al. 2023), forward Euler or leapfrog with the Robert-Asselin
filter, to quasi-steady state each coupling interval. Every field lives
on the mesh gated by the shelf masks; on the model's path the leg runs on
a compact sub-mesh of the shelf and three rings around it.

One stage is `ops/cuda_laddie.py laddie_stage`: the hand-written kernel
on the card (two launches), its plain tensor version on the host. On the
card a whole leg is `laddie_leg`, one cooperative launch of the same
kernel; on the host it is the loop of plain stages.

Physics: 3-equation melt with u*-dependent gamma (laddie_physics.f90:27),
Gaspar (1988) entrainment, linear EOS buoyancy, upstream momentum and
tracer advection (laddie_velocity.f90:282, laddie_tracers.f90), Voronoi
upwind thickness divergence (laddie_thickness.f90:143).

Copied from the JAX package as it is: with the schema's default
laddie_fbrk3_beta1..3 = 0 the fbrk3 blend returns the step's starting
thickness after every stage, so H does not move under fbrk3 (ROADMAP C);
run_laddie_leg returns the last pseudo-step's melt, not a mean.
"""

from __future__ import annotations

import time as _time
from types import SimpleNamespace

import numpy as np
import torch

from ..core.mesh_data import MeshData
from ..ops import cuda_laddie
from ..ops.cuda_laddie import (LaddieState, LaddieMasks, LaddieParams,
                               LaddieScheme, laddie_step, laddie_tables)
from ..utils.constants import sec_per_year

def laddie_masks(md: MeshData, masks):
    """LADDIE masks from the ice masks (laddie_main_utils)."""
    a = masks["mask_floating_ice"]
    gr_a = masks["mask_grounded_ice"] | masks["mask_icefree_land"]
    oc_a = masks["mask_icefree_ocean"]
    tri_a, tri_gr, tri_oc = a[md.Tri], gr_a[md.Tri], oc_a[md.Tri]
    b = tri_a.any(dim=1) & ~tri_gr.all(dim=1) & ~tri_oc.all(dim=1)
    return LaddieMasks(a=a, gr_a=gr_a, oc_a=oc_a, b=b,
                       gl_b=b & tri_gr.any(dim=1), cf_b=b & tri_oc.any(dim=1))


def make_calc_SGD(C, md: MeshData):
    """Subglacial discharge source [m s^-1] on the a-grid, or None when
    choice_laddie_SGD = 'none'.

    Reference semantics (LADDIE_main_model.f90:130-146,
    laddie_physics.f90:182-386, masks_mod.f90:504-605,
    laddie_hydrology.f90):
      'idealised'      - flux spread over floating-GL vertices inside a
                         5 km y-band on the MISMIP+ channel (PC/PW/PE);
      'read_from_file' - same, mask read from a 2-D file (>0 = channel);
      'read_transects' - per-transect flux injected at the FIRST transect
                         vertex on the floating grounding line, either
                         into that single cell or distributed over it and
                         up to two floating-GL neighbours.
    The flux only applies from start_time_of_applying_SGD onward (the
    transect variant has no time gate in the reference).

    Returns calc(mask_a, mask_gl_fl, time[yr]) -> SGD [m s^-1].
    """
    choice = C.choice_laddie_SGD
    if choice == "none":
        return None
    mesh = md._host_mesh
    A = md.A
    dev = md.device
    t_start = C.start_time_of_applying_SGD

    if choice in ("idealised", "read_from_file"):
        if choice == "idealised":
            y0 = {"MISMIPplus_PC": 0.0, "MISMIPplus_PW": 18e3,
                  "MISMIPplus_PE": -18e3}[C.choice_laddie_SGD_idealised]
            m_np = ((mesh.V[:, 1] > y0 - 2500.0)
                    & (mesh.V[:, 1] < y0 + 2500.0))
        else:
            from ..io.input_files import read_field_from_file_2D
            m_np = np.asarray(read_field_from_file_2D(
                C.filename_laddie_mask_SGD, "mask_SGD", mesh)) > 0.0
        mask_SGD = torch.as_tensor(m_np, device=dev)
        flux = C.laddie_SGD_flux

        def calc(mask_a, mask_gl_fl, time):
            cond = mask_a & mask_gl_fl & mask_SGD
            area = torch.where(cond, A, 0.0).sum()
            sgd = torch.where(cond, flux / torch.clamp(area, min=1e-30), 0.0)
            on = (area > 0.0) & bool(time >= t_start)
            return torch.where(on, sgd, 0.0)
        return calc

    if choice == "read_transects":
        from scipy.spatial import cKDTree
        from .transects import parse_transect_str, resample_waypoints
        tree = cKDTree(mesh.V)
        transects = []
        for ts in (t.strip() for t in C.transects_SGD.split("||")
                   if t.strip()):
            # reference strings use ',SF=<flux>' instead of ',dx='
            i = ts.find(",SF=")
            if i < 0:
                raise ValueError(f"invalid SGD transect '{ts}': no SF=")
            sf = float(ts[i + 4:])
            src, name, fname, _ = parse_transect_str(ts[:i] + ",dx=100")
            if src != "read_from_file":
                raise ValueError("SGD transects must be 'file:...' "
                                 "(laddie_hydrology.f90:92)")
            wp = np.atleast_2d(np.loadtxt(
                fname, comments=("!", "#", "&", "/")))[:, :2]
            pts = resample_waypoints(wp, 100.0)
            idx = tree.query(pts)[1]            # containing-vertex proxy
            transects.append((torch.as_tensor(idx, device=dev), sf))
        nbr = torch.as_tensor(np.maximum(mesh.C, 0), device=dev)
        nbr_ok = torch.as_tensor(mesh.C >= 0, device=dev)
        single = C.distribute_SGD == "single_cell"

        def calc(mask_a, mask_gl_fl, time):
            sgd = torch.zeros(md.nV, dtype=A.dtype, device=dev)
            gl = mask_a & mask_gl_fl
            for idx, sf in transects:
                hits = gl[idx]
                has = hits.any()
                vi = idx[torch.argmax(hits.to(torch.int32))].reshape(1)
                if single:
                    add = torch.where(has, sf / A[vi], 0.0)
                    sgd = sgd.index_add(0, vi, add)
                else:
                    # up to two floating-GL neighbours, in C order
                    nb = nbr[vi[0]]
                    fl = gl[nb] & nbr_ok[vi[0]]
                    take = fl & (torch.cumsum(fl.to(torch.int32), 0) <= 2)
                    area = A[vi] + torch.where(take, A[nb], 0.0).sum()
                    w = torch.where(has, sf / area, 0.0)
                    sgd = sgd.index_add(0, vi, w)
                    sgd = sgd.index_add(0, nb, torch.where(take, w, 0.0))
            return sgd
        return calc

    raise ValueError(f"unknown choice_laddie_SGD '{choice}'")


def make_laddie_step(C, md: MeshData, stage_fn=None):
    """One pseudo-time fbrk3 / euler / lfra step on md:
    step((now, nm1), lm, forcing) -> ((now, nm1), ph), melt in ph.
    `stage_fn` is the stage: by default ops/cuda_laddie.py `laddie_stage`,
    or its plain version. The step carries its tables, params and scheme,
    which run_laddie_leg hands to `laddie_leg`."""
    stage_fn = stage_fn or cuda_laddie.laddie_stage
    sch = LaddieScheme.from_config(C)
    tab = laddie_tables(md)
    prm = LaddieParams.from_config(C)

    def step(carry, lm: LaddieMasks, forcing):
        return laddie_step(tab, prm, sch, carry, lm, forcing, stage_fn)

    step.tables, step.params, step.scheme = tab, prm, sch
    return step


def init_laddie_state(C, md: MeshData, lm: LaddieMasks, forcing):
    """Initial plume state (laddie_main: H at its initial thickness, T and
    S ambient at the draft)."""
    dtype, dev = md.A.dtype, md.device
    H0 = torch.full((md.nV,), C.laddie_initial_thickness, dtype=dtype,
                    device=dev)
    depths = forcing["z_ocean"]
    depth = torch.clamp(-forcing["Hib"], min=0.0)
    nd = depths.shape[0]
    idx = torch.clamp(torch.searchsorted(depths, depth) - 1, 0, nd - 2)
    w = torch.clamp((depth - depths[idx])
                    / torch.clamp(depths[idx + 1] - depths[idx], min=1e-9),
                    0, 1)
    i0, i1 = idx[:, None], (idx + 1)[:, None]
    To, So = forcing["T_ocean"], forcing["S_ocean"]
    T0 = To.gather(1, i0)[:, 0] * (1 - w) + To.gather(1, i1)[:, 0] * w \
        + C.laddie_initial_T_offset
    S0 = So.gather(1, i0)[:, 0] * (1 - w) + So.gather(1, i1)[:, 0] * w
    z = torch.zeros(md.nTri, dtype=dtype, device=dev)
    return LaddieState(H=H0, U=z, V=z.clone(), T=T0, S=S0)


def leg_steps(C, duration_days):
    return max(1, int(duration_days * 86400.0 / C.dt_laddie))


def run_laddie_leg(C, md: MeshData, state: LaddieState, lm: LaddieMasks,
                   forcing, duration_days: float, step_fn=None):
    """Integrate the plume for `duration_days` of pseudo-time; returns
    (state, melt [m ice/yr] of the last pseudo-step on the a-grid)."""
    step_fn = step_fn or make_laddie_step(C, md)
    state, melt = cuda_laddie.laddie_leg(
        step_fn.tables, step_fn.params, step_fn.scheme, state, lm, forcing,
        leg_steps(C, duration_days))
    # melt is in m/s of ice; convert to m ice / yr
    return state, melt * sec_per_year


def run_laddie_leg_with_diag(C, md: MeshData, state: LaddieState,
                             lm: LaddieMasks, forcing,
                             duration_days: float, step_fn=None):
    """run_laddie_leg and one more step for the full physics diagnostics
    (laddie_mesh_output.f90's field set)."""
    step_fn = step_fn or make_laddie_step(C, md)
    state, melt = run_laddie_leg(C, md, state, lm, forcing, duration_days,
                                 step_fn)
    _, ph = step_fn((state, state), lm, forcing)
    return state, melt, dict(ph)


# ---------------------------------------------------------------------------
# Active-set compaction (the JAX package's equivalent of the reference's
# LADDIE load-balancing repartitioning, mesh_repartitioning.f90:31-101 and
# LADDIE_main_model.f90:69-84): the shelf and 3 neighbour rings go into a
# compact sub-mesh (entity sets padded to multiples of _PAD_MULT) on the
# host when the shelf changes, the whole leg runs on it, and the melt and
# the plume state scatter back to the full mesh.
# ---------------------------------------------------------------------------

_PAD_MULT = 256


def _ring_expand(C_tbl, keep, n_rings):
    """Expand a vertex mask by n_rings of mesh connectivity (host)."""
    for _ in range(n_rings):
        nb = C_tbl[keep]
        nb = nb[nb >= 0]
        grown = keep.copy()
        grown[nb] = True
        keep = grown
    return keep


def build_compact_laddie_md(md: MeshData, shelf_np):
    """(md_c, (V_keep, nVr), (Tri_keep, nTr), (E_keep, nEr)): a compact
    MeshData of the shelf and 3 rings (every evaluated row's operator
    stencil stays inside), its entity sets padded to _PAD_MULT multiples
    by repeating row 0 (the pad rows' connectivity is -1; scattering back
    skips them)."""
    from ..core.mesh_data import build_mesh_data

    mesh = md._host_mesh
    keep = _ring_expand(mesh.C, shelf_np.astype(bool).copy(), 3)
    V_keep = np.where(keep)[0]
    Tri_keep = np.where(keep[mesh.Tri].all(axis=1))[0]
    E_keep = np.where(keep[mesh.EV].all(axis=1))[0]

    def _pad(idx):
        n_pad = (-len(idx)) % _PAD_MULT
        return np.concatenate([idx, np.repeat(idx[:1], n_pad)]), len(idx)

    V_keep, nVr = _pad(V_keep)
    Tri_keep, nTr = _pad(Tri_keep)
    E_keep, nEr = _pad(E_keep)

    def index_map(n, kept, n_real):
        mp = np.full(n, -1, np.int64)
        mp[kept[:n_real]] = np.arange(n_real)
        return mp
    mapV = index_map(mesh.nV, V_keep, nVr)
    mapT = index_map(mesh.nTri, Tri_keep, nTr)
    mapE = index_map(mesh.nE, E_keep, nEr)

    def remap(tbl, mp):
        return np.where(tbl >= 0, mp[np.maximum(tbl, 0)], -1)

    ops = mesh.operators

    def sl(A, rows, cols):
        return A.tocsr()[rows][:, cols].tocsr()

    rows_cols = {
        "M_ddx_a_a": (V_keep, V_keep), "M_ddy_a_a": (V_keep, V_keep),
        "M_map_a_b": (Tri_keep, V_keep), "M_ddx_a_b": (Tri_keep, V_keep),
        "M_ddy_a_b": (Tri_keep, V_keep), "M_map_b_a": (V_keep, Tri_keep),
        "M_ddx_b_a": (V_keep, Tri_keep), "M_ddy_b_a": (V_keep, Tri_keep),
        "M_ddx_b_b": (Tri_keep, Tri_keep), "M_ddy_b_b": (Tri_keep, Tri_keep),
        "M2_ddx_b_b": (Tri_keep, Tri_keep),
        "M2_ddy_b_b": (Tri_keep, Tri_keep),
        "M2_d2dx2_b_b": (Tri_keep, Tri_keep),
        "M2_d2dxdy_b_b": (Tri_keep, Tri_keep),
        "M2_d2dy2_b_b": (Tri_keep, Tri_keep)}
    lite = SimpleNamespace(
        nV=len(V_keep), nTri=len(Tri_keep), nE=len(E_keep),
        V=mesh.V[V_keep], TriGC=mesh.TriGC[Tri_keep],
        A=mesh.A[V_keep], TriA=mesh.TriA[Tri_keep], R=mesh.R[V_keep],
        zeta=mesh.zeta, zeta_stag=mesh.zeta_stag,
        C=remap(mesh.C[V_keep], mapV), VE=remap(mesh.VE[V_keep], mapE),
        Cw=mesh.Cw[V_keep],
        D_x=mesh.D_x[V_keep], D_y=mesh.D_y[V_keep], D=mesh.D[V_keep],
        Tri=remap(mesh.Tri[Tri_keep], mapV),
        EV=remap(mesh.EV[E_keep], mapV),
        ETri=remap(mesh.ETri[E_keep], mapT),
        TriC=remap(mesh.TriC[Tri_keep], mapT),
        TriE=remap(mesh.TriE[Tri_keep], mapE),
        Tricc=mesh.Tricc[Tri_keep], VBI=mesh.VBI[V_keep],
        operators=SimpleNamespace(**{
            name: sl(getattr(ops, name), r, c)
            for name, (r, c) in rows_cols.items()}))
    # pad rows carry -1 connectivity (fully masked); keep row 0 geometry
    lite.C[np.arange(len(V_keep)) >= nVr] = -1
    lite.VE[np.arange(len(V_keep)) >= nVr] = -1
    lite.TriC[np.arange(len(Tri_keep)) >= nTr] = -1
    md_c = build_mesh_data(lite, dtype=md.A.dtype, device=md.device)
    return md_c, (V_keep, nVr), (Tri_keep, nTr), (E_keep, nEr)


def make_run_bmb_laddie(C, md: MeshData, region_name: str):
    """BMB coupling: run a LADDIE leg each call (BMB_main.f90 'laddie').

    With tpu_laddie_compaction (default on) the leg runs on the compacted
    shelf sub-mesh; the compact MeshData and step are rebuilt only when
    the shelf mask changes (the reference repartitions at the same
    cadence, LADDIE_main_model.f90:69-84). The plume state lives in this
    runner only: a rebuilt runner (after a mesh update) starts again with
    the initial leg, and restart files hold no plume state, as in the JAX
    package. `run.legs` records each leg: pseudo-steps, wall seconds,
    whether it was the initial one, the (compact) mesh's sizes, the
    stages (`laddie_stage_launches`), kernel launches (one a leg on the
    card), the seconds of the compact mesh's rebuild before it (0 when the
    shelf did not change) and the largest change of the plume thickness on
    the real rows."""
    from .ocean import ocean_depth_axis
    from .bmb import apply_bmb_subgrid_scheme
    do_compact = bool(getattr(C, "tpu_laddie_compaction", True))
    step_fn = None if do_compact else make_laddie_step(C, md)
    calc_sgd = make_calc_SGD(C, md)
    kw = dict(dtype=md.A.dtype, device=md.device)
    z_ocean = torch.as_tensor(ocean_depth_axis(C), **kw)
    st = {}
    legs = []

    def _forcing_full(time, s, masks, ocean):
        forcing = {
            "Hib": s.Hib,
            "dHib_dx_b": md.M_ddx_a_b @ s.Hib,
            "dHib_dy_b": md.M_ddy_a_b @ s.Hib,
            # surface-layer ice temperature in degC (the reference
            # converts: laddie_forcing_main.f90:169 'ice%Ti - 273.15')
            "Ti_base": s.Ti[:, 0] - 273.15,
            "use_Ti": C.choice_thermo_model != "none",
            "z_ocean": z_ocean,
            "T_ocean": ocean["T"], "S_ocean": ocean["S"],
            "SGD": (torch.zeros(md.nV, **kw) if calc_sgd is None else
                    calc_sgd(masks["mask_floating_ice"],
                             masks["mask_gl_fl"], time)),
        }
        return forcing

    def _duration():
        if "state" not in st:
            return C.time_duration_laddie_init, True
        return C.time_duration_laddie, False

    def _leg(md_l, state, lm, fc, duration, step, initial, n_real,
             rebuild_s=0.0):
        n0, k0 = cuda_laddie.launches, cuda_laddie.kernel_launches
        t0 = _time.perf_counter()
        out = run_laddie_leg(C, md_l, state, lm, fc, duration, step)
        if md.device.type == "cuda":
            torch.cuda.synchronize(md.device)
        wall = _time.perf_counter() - t0
        legs.append(dict(
            steps=leg_steps(C, duration), initial=initial, wall_s=wall,
            nV=md_l.nV, nTri=md_l.nTri,
            stage_launches=cuda_laddie.launches - n0,
            kernel_launches=cuda_laddie.kernel_launches - k0,
            compact_rebuild_s=rebuild_s,
            dH_max=float((out[0].H[:n_real] - state.H[:n_real]).abs()
                         .max())))
        return out

    def _run_full(time, s, masks, ocean):
        lm = laddie_masks(md, masks)
        forcing = _forcing_full(time, s, masks, ocean)
        duration, initial = _duration()
        if initial:
            st["state"] = init_laddie_state(C, md, lm, forcing)
        st["state"], melt = _leg(md, st["state"], lm, forcing, duration,
                                 step_fn, initial, md.nV)
        return melt

    def _run_compact(time, s, masks, ocean):
        shelf_np = masks["mask_floating_ice"].cpu().numpy()
        key = shelf_np.tobytes()
        rebuild_s = 0.0
        if st.get("compact_key") != key:
            t0 = _time.perf_counter()
            md_c, Vk, Tk, _ = build_compact_laddie_md(md, shelf_np)
            st.update(compact_key=key, md_c=md_c, Vk=Vk, Tk=Tk,
                      step_c=make_laddie_step(C, md_c),
                      iV=torch.as_tensor(Vk[0], device=md.device),
                      iT=torch.as_tensor(Tk[0], device=md.device))
            if md.device.type == "cuda":
                torch.cuda.synchronize(md.device)
            rebuild_s = _time.perf_counter() - t0
        md_c = st["md_c"]
        nVr, nTr = st["Vk"][1], st["Tk"][1]
        iV, iT = st["iV"], st["iT"]
        masks_c = {k: masks[k][iV] for k in
                   ("mask_floating_ice", "mask_grounded_ice",
                    "mask_icefree_land", "mask_icefree_ocean",
                    "mask_gl_fl")}
        lm = laddie_masks(md_c, masks_c)
        forcing = _forcing_full(time, s, masks, ocean)
        fc = dict(forcing)
        for k in ("Hib", "Ti_base", "T_ocean", "S_ocean", "SGD"):
            fc[k] = fc[k][iV].contiguous()
        for k in ("dHib_dx_b", "dHib_dy_b"):
            fc[k] = fc[k][iT].contiguous()
        duration, initial = _duration()
        if initial:
            st["state"] = init_laddie_state(C, md, laddie_masks(md, masks),
                                            forcing)
        full = st["state"]
        st_c = LaddieState(H=full.H[iV], U=full.U[iT], V=full.V[iT],
                           T=full.T[iV], S=full.S[iV])
        st_c, melt_c = _leg(md_c, st_c, lm, fc, duration, st["step_c"],
                            initial, nVr, rebuild_s)
        # scatter the compact plume state and melt back to the full mesh
        iVr, iTr = iV[:nVr], iT[:nTr]

        def put(dst, idx, src):
            out = dst.clone()
            out[idx] = src
            return out
        st["state"] = LaddieState(
            H=put(full.H, iVr, st_c.H[:nVr]), U=put(full.U, iTr, st_c.U[:nTr]),
            V=put(full.V, iTr, st_c.V[:nTr]), T=put(full.T, iVr, st_c.T[:nVr]),
            S=put(full.S, iVr, st_c.S[:nVr]))
        return put(torch.zeros(md.nV, **kw), iVr, melt_c[:nVr])

    def run(time, s, masks, fraction_gr, ocean=None):
        melt = (_run_compact if do_compact else _run_full)(
            time, s, masks, ocean)
        # BMB convention: negative = melt
        bmb = apply_bmb_subgrid_scheme(C, masks, fraction_gr, -melt)
        return torch.clamp(bmb, -C.BMB_maximum_allowed_melt_rate,
                           C.BMB_maximum_allowed_refreezing_rate)

    run.legs = legs
    run.state = st
    return run
