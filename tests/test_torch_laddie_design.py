"""The design of the LADDIE kernel (csrc/laddie.cu), written as plain tensor
code and held to the bit against `laddie_stage_plain` and against the loop
of `laddie_step(..., laddie_stage_plain)`.

The functions below are the kernel's specification. They reorder the
work of the plain version without changing a single rounding:

- a row has L lanes (32 when the rows at 32 lanes fit in one co-resident
  wave of the card, else 1): lane l forms the products of entries l,
  l + L, ... and every lane adds them in order, entry k from lane k % L's
  slot k // L (`lane_sum`); in the triangle pass lane j forms neighbour
  j's terms;
- an ELL row adds its m stored entries (a table of each row's m) in
  order, then, where it has padding (column 0, value +0, as ops/sparse.py
  pads), one addition of the first padding product, which stands for all
  of them: each is the same +-0 or NaN, and x + p + p = x + p
  (`ell_rows`); two rows over the same columns (U_a and V_a; d/dx and
  d/dy of drho and of H) load them once. The compact shelf mesh's padded
  columns make some rows over 100 entries long; past 12 entries (288 with
  32 lanes) a row takes the run-time form, the same sum;
- the Voronoi loop (`voronoi_div`): the connections' vertices and edge
  triangles, then every value, then the sums in order;
- tables built once a mesh give each connection's edge triangles (VET),
  each neighbour's edge triangles and vertices (TriET, TriEV) and
  vertices (TriCV, Tri of each neighbour, of triangle 0 where there is
  none) directly; the triangle pass forms every neighbour's terms and
  keeps by a select the ones the plain version adds (`triangle_pass`);
- the depth search is a bisection (`search_left`), equal to the linear
  "side left" walk for every depth: at a level, between two, above the
  first, below the last, and NaN (0);
- a leg rotates four state sets (`leg_rotation`): fbrk3 writes np13 and
  np12 into sets 2 and 3 and np1 into the set of the ping-pong pair that
  `now` is not in; euler ping-pongs; lfra writes (np1, filtered) into one
  pair while it reads (now, nm1) from the other. No stage writes a set it
  reads, and `now` stays whole until the step's third stage has read it.

The operands: the shelf set-up of tests/test_torch_laddie.py on its 8 km
mesh of 100 km square, built by the port alone (no JAX), and its compact
shelf mesh, the plume state perturbed with seeded noise, in f32 and f64.
"""

import numpy as np
import pytest
import torch

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.core.ice.masks import determine_masks
from ufemism2_tpu_torch.core.ice.state import init_ice_state
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
from ufemism2_tpu_torch.mesh import build_uniform_mesh
from ufemism2_tpu_torch.models import laddie as tl
from ufemism2_tpu_torch.models.ocean import make_run_ocean, ocean_depth_axis
from ufemism2_tpu_torch.ops import cuda_laddie as cl
from ufemism2_tpu_torch.ops.cuda_laddie import LaddieScheme, LaddieState
from ufemism2_tpu_torch.ops.cuda_spmv import _round_bf16
from ufemism2_tpu_torch.utils.constants import (
    grav, seawater_density, cp_ice, cp_ocean, L_fusion, freezing_lambda_1,
    freezing_lambda_2, freezing_lambda_3, Prandtl_number, Schmidt_number)

BASE = dict(dt_laddie=120.0, choice_ocean_model_ANT="idealised",
            choice_ocean_model_idealised="MISMIPplus_WARM")
DTYPES = [torch.float64, torch.float32]
BETA = dict(laddie_fbrk3_beta1=0.5, laddie_fbrk3_beta2=0.5,
            laddie_fbrk3_beta3=0.344)
SCHEMES = {"fbrk3": {}, "fbrk3_beta": BETA,
           "euler": dict(choice_laddie_integration_scheme="euler"),
           "lfra": dict(choice_laddie_integration_scheme="lfra")}


# -- the set-up -----------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return build_uniform_mesh(-50e3, 50e3, -50e3, 50e3, 8e3)


_SETUPS = {}


def setup(mesh, dtype, compact=False):
    """(md, tables, LADDIE masks, forcing, perturbed state, a second
    perturbed state) of the shelf set-up in `dtype`; with `compact` on the
    compact shelf mesh of the model's path (the shelf and 3 rings, padded
    to a multiple of 256 rows by copies of row 0, whose duplicated
    columns make some ELL rows 100 entries and more long)."""
    if (dtype, compact) in _SETUPS:
        return _SETUPS[dtype, compact]
    if compact:
        md, _, lm, fc, s0, s1 = setup(mesh, dtype)
        masks = _SETUPS["masks", dtype]
        mdc, (Vk, _), (Tk, _), _ = tl.build_compact_laddie_md(
            md, masks["mask_floating_ice"].numpy())
        iV, iT = torch.as_tensor(Vk), torch.as_tensor(Tk)
        lmc = tl.laddie_masks(mdc, {k: masks[k][iV] for k in (
            "mask_floating_ice", "mask_grounded_ice", "mask_icefree_land",
            "mask_icefree_ocean")})
        fcc = dict(fc)
        for k in ("Hib", "Ti_base", "T_ocean", "S_ocean", "SGD"):
            fcc[k] = fc[k][iV].contiguous()
        for k in ("dHib_dx_b", "dHib_dy_b"):
            fcc[k] = fc[k][iT].contiguous()
        cut = lambda st: LaddieState(H=st.H[iV], U=st.U[iT], V=st.V[iT],
                                     T=st.T[iV], S=st.S[iV])
        out = (mdc, cl.laddie_tables(mdc), lmc, fcc, cut(s0), cut(s1))
        _SETUPS[dtype, compact] = out
        return out
    C = Config(**BASE)
    md = build_mesh_data(mesh, dtype=dtype, device="cpu")
    x = mesh.V[:, 0]
    Hb = np.where(x < -20e3, 100.0, -600.0)
    Hi = np.where(x < 20e3, np.where(x < -20e3, 500.0, 300.0), 0.0)
    s = init_ice_state(md, Hi, Hb, np.zeros_like(Hi), nz=4, dt_init=0.1)
    masks = determine_masks(md, s.Hi, s.Hb, s.SL)
    _SETUPS["masks", dtype] = masks
    lm = tl.laddie_masks(md, masks)
    oc = make_run_ocean(C, md, "ANT")(0.0, s)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64).to(
        dtype)
    fc = {"Hib": s.Hib.to(dtype), "dHib_dx_b": (md.M_ddx_a_b @ s.Hib),
          "dHib_dy_b": (md.M_ddy_a_b @ s.Hib),
          "Ti_base": f(-18.0 - 3.0 * np.random.default_rng(5).random(
              md.nV)), "use_Ti": False,
          "z_ocean": f(ocean_depth_axis(C)), "T_ocean": oc["T"].to(dtype),
          "S_ocean": oc["S"].to(dtype), "SGD": torch.zeros(md.nV,
                                                           dtype=dtype)}
    fc = {k: v.to(dtype).contiguous() if isinstance(v, torch.Tensor) else v
          for k, v in fc.items()}
    s0 = tl.init_laddie_state(C, md, lm, fc)

    def perturbed(seed):
        rng = np.random.default_rng(seed)
        return LaddieState(
            H=f(10.0 + 5.0 * rng.random(md.nV)),
            U=f(0.05 * rng.standard_normal(md.nTri)),
            V=f(0.05 * rng.standard_normal(md.nTri)),
            T=s0.T + f(0.2 * rng.standard_normal(md.nV)),
            S=s0.S + f(0.1 * rng.standard_normal(md.nV)))
    out = (md, cl.laddie_tables(md), lm, fc, perturbed(0), perturbed(1))
    _SETUPS[dtype, compact] = out
    return out


# -- the kernel's design, row by row as tensors ---------------------------

def lane_sum(terms, m, L, acc=None):
    """The ordered sum of a row's terms formed on L lanes: lane l holds
    terms l, l + L, ... (slot k // L), and every lane adds term k from lane
    k % L's slot, k = 0, 1, ... in turn, while k < m (a per-row width: a
    select); `terms` [k] of [n] tensors."""
    n = len(terms)
    held = [[terms[min(j * L + lane, n - 1)]
             for j in range((n + L - 1) // L)] for lane in range(L)]
    for k in range(n):
        q = held[k % L][k // L]
        on = k < m
        acc = q if k == 0 else (torch.where(on, acc + q, acc)
                                if isinstance(on, torch.Tensor)
                                else (acc + q if on else acc))
    return acc


def ell_rows(M, lens, x, y, L):
    """Rows of the ELL operator M applied to x and to y over one load of
    the columns: each row's m = lens stored entries added in order on L
    lanes, then, where the row has padding (column 0, value +0), one
    addition of its first padding product, which stands for all of them
    (x + p + p = x + p for p = +-0 or NaN)."""
    K = M.cols.shape[0]
    rnd = _round_bf16 if x.dtype == torch.float32 else (lambda t: t)
    cols, m = M.cols.long(), lens.long()
    out = []
    for v in (x, y):
        p = M.vals * rnd(v)[cols]                        # [K, n]
        acc = lane_sum(list(p), m, L)
        tail = p.gather(0, m.clamp(max=K - 1)[None])[0]
        out.append(torch.where(m < K, acc + tail, acc))
    return out


def b_to_c(t0, t1, u):
    """map_b_to_c at edges of triangles (t0, t1), -1 where none: every
    triangle's value loaded (of triangle 0 where none), then selected."""
    v0 = torch.where(t0 >= 0, u[t0.clamp(min=0)], 0.0)
    v1 = torch.where(t1 >= 0, u[t1.clamp(min=0)], 0.0)
    n = (t0 >= 0).long() + (t1 >= 0).long()
    return (v0 + v1) / torch.clamp(n, min=1)


def voronoi_div(tab, ref, lm, L):
    """The upwind divergences of H, HT and HS (before the active mask):
    the connections' indices, their edges' triangles, every value, then
    the sums in order over L lanes, a connection past the row's width left
    out."""
    k32 = tab.k32
    Kc = k32["C"].shape[1]
    ks = list(range(Kc))
    c = [k32["C"][:, e].long() for e in ks]
    t0 = [k32["VET"][:, e, 0].long() for e in ks]
    t1 = [k32["VET"][:, e, 1].long() for e in ks]
    Hr, Tr, Sr = ref.H, ref.T, ref.S
    terms = ([], [], [])
    for j, e in enumerate(ks):
        cc = c[j].clamp(min=0)
        Uc, Vc = b_to_c(t0[j], t1[j], ref.U), b_to_c(t0[j], t1[j], ref.V)
        u_perp = Uc * tab.Dx_D[:, e] + Vc * tab.Dy_D[:, e]
        on = (c[j] >= 0) & ~lm.gr_a[cc]
        oc = lm.oc_a[cc]
        up, dn = torch.clamp(u_perp, min=0.0), torch.clamp(u_perp, max=0.0)
        LcA, H_j = tab.LcA[:, e], ref.H[cc]
        f = (torch.where(on, LcA * (up * Hr + dn * torch.where(oc, 0.0, H_j)),
                         0.0),
             torch.where(on, LcA * (up * Hr * Tr + dn * torch.where(
                 oc, 0.0, H_j * ref.T[cc])), 0.0),
             torch.where(on, LcA * (up * Hr * Sr + dn * torch.where(
                 oc, 0.0, H_j * ref.S[cc])), 0.0))
        for q, t in zip(terms, f):
            q.append(t)
    return tuple(lane_sum(q, Kc, L) for q in terms)


def search_left(z, depth):
    """torch.searchsorted(z, depth) side left, by bisection (z ascending):
    the number of levels below each depth, 0 for NaN."""
    lo = torch.zeros(depth.shape, dtype=torch.long)
    hi = torch.full(depth.shape, z.shape[0], dtype=torch.long)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) >> 1
        below = z[mid.clamp(max=z.shape[0] - 1)] < depth
        lo = torch.where(live & below, mid + 1, lo)
        hi = torch.where(live & ~below, mid, hi)
    return lo


def linear_walk(z, depth):
    """The linear search: the walk past every level below the depth."""
    out = []
    for dv in depth.tolist():
        pos = 0
        while pos < len(z) and float(z[pos]) < dv:
            pos += 1
        out.append(pos)
    return torch.tensor(out)


def vertex_pass(tab, P, old, ref, lm, fc, dt_i, L):
    """The vertex pass: (H_new, detr, ph, dQT, dQS, entr, entr_dmin) of the
    kernel's vertex_row, before the tracers and the scheme's update."""
    Hr, Tr, Sr = ref.H, ref.T, ref.S
    U_a, V_a = ell_rows(tab.M_map_b_a, tab.k32["ba_len"], ref.U, ref.V, L)
    u_star = torch.sqrt(P.Cd_top * (U_a ** 2 + V_a ** 2 + P.tidal ** 2))
    if P.jenkins:
        AA = 2.12 * torch.log(u_star * Hr / 1.95e-6 + 1e-12)
        gamma_T = u_star / (AA + 12.5 * Prandtl_number ** (2 / 3) - 8.68)
        gamma_S = u_star / (AA + 12.5 * Schmidt_number ** (2 / 3) - 8.68)
    else:
        gamma_T = u_star * P.gamma_T
        gamma_S = u_star * P.gamma_T / 35.0
    Hib = fc["Hib"]
    Ctil = cp_ice / cp_ocean
    That = freezing_lambda_2 + freezing_lambda_3 * Hib
    if fc["use_Ti"]:
        L_eff = L_fusion - cp_ice * fc["Ti_base"]
        Chat = cp_ocean / L_eff
    else:
        L_eff, Chat = L_fusion, cp_ocean / L_fusion
    Bval = Chat * gamma_T * (That - Tr) + gamma_S * (
        1 + Chat * Ctil * (That + freezing_lambda_1 * Sr))
    Cval = Chat * gamma_T * gamma_S * (That - Tr + freezing_lambda_1 * Sr)
    disc = Bval ** 2 - 4 * Cval
    melt = torch.where(disc < 0, 0.0,
                       0.5 * (-Bval + torch.sqrt(torch.clamp(disc, min=0.0))))
    Dval = melt * cp_ice - cp_ocean * gamma_T
    T_freeze = freezing_lambda_1 * Sr + freezing_lambda_2 \
        + freezing_lambda_3 * Hib
    T_base = torch.where(Dval.abs() < 1e-12, T_freeze,
                         (melt * L_eff - cp_ocean * gamma_T * Tr) / Dval)

    # the ambient profile at the layer base, by bisection
    z = fc["z_ocean"]
    nd = z.shape[0]
    depth_abs = torch.clamp(-(Hib - Hr), min=0.0)
    idx = torch.clamp(search_left(z, depth_abs) - 1, 0, nd - 2)
    w = torch.clamp((depth_abs - z[idx])
                    / torch.clamp(z[idx + 1] - z[idx], min=1e-9), 0.0, 1.0)
    rows = torch.arange(tab.nV)
    To, So = fc["T_ocean"], fc["S_ocean"]
    T_amb = To[rows, idx] * (1 - w) + To[rows, idx + 1] * w
    S_amb = So[rows, idx] * (1 - w) + So[rows, idx + 1] * w
    drho_amb = P.beta_eos * (S_amb - Sr) - P.alpha * (T_amb - Tr)
    drho_amb = torch.clamp(drho_amb, min=P.buoy_min / seawater_density)
    S_base = (T_base - freezing_lambda_2
              - freezing_lambda_3 * Hib) / freezing_lambda_1
    drho_base = P.beta_eos * (Sr - S_base) - P.alpha * (Tr - T_base)
    entr0 = (2 * P.mu / grav * u_star ** 3
             / (torch.clamp(Hr, min=1e-3) * drho_amb)
             - drho_base / drho_amb * melt)
    entr0 = torch.clamp(entr0, min=-1e-3)
    a = lm.a
    ph = dict(melt=melt, entr=entr0, detr=-torch.clamp(entr0, max=0.0),
              gamma_T=gamma_T, gamma_S=gamma_S, T_base=T_base, T_amb=T_amb,
              S_amb=S_amb, Hdrho_amb=Hr * drho_amb)
    ph = {k: torch.where(a, v, 0.0) for k, v in ph.items()}
    ph["drho_amb"] = torch.where(a, drho_amb, 1e-6)

    dQH, dQT, dQS = (torch.where(a, q, 0.0)
                     for q in voronoi_div(tab, ref, lm, L))
    sgd = fc["SGD"]
    dHdt0 = -dQH + ph["melt"] + ph["entr"] + sgd
    H_guess = old.H + dHdt0 * dt_i
    entr_dmin = torch.clamp(P.H_min - H_guess, min=0.0) / dt_i
    entr = ph["entr"] + torch.clamp(P.H_max - H_guess, max=0.0) / dt_i
    entr = torch.where(entr_dmin > 0, torch.clamp(entr, min=0.0), entr)
    detr = -torch.clamp(entr, max=0.0)
    dHdt = -dQH + ph["melt"] + entr + entr_dmin + sgd
    H_new = torch.where(a, old.H + dHdt * dt_i, old.H)
    return H_new, detr, ph, dQT, dQS, entr, entr_dmin


def mean3(H, v, w, H_min):
    """The active-masked mean of H at the vertices v [n, 3], weights w."""
    s = H[v[:, 0]] * w[:, 0] + H[v[:, 1]] * w[:, 1] + H[v[:, 2]] * w[:, 2]
    n = w[:, 0] + w[:, 1] + w[:, 2]
    return torch.where(n > 0, s / torch.clamp(n, min=1), H_min)


def mean2(H, v, w, H_min):
    """The active-masked a->c mean of H at the edges' vertices v [n, 2]."""
    s = H[v[:, 0]] * w[:, 0] + H[v[:, 1]] * w[:, 1]
    n = w[:, 0] + w[:, 1]
    return torch.where(n > 0, s / torch.clamp(n, min=1), H_min)


def triangle_pass(tab, P, old, ref, lm, fc, dt_i, visc, H_new, detr, ph,
                  L):
    """The triangle pass: (U, V) of the kernel's triangle_row, before the
    lfra filter."""
    k32 = tab.k32
    Tri = k32["Tri"].long()
    w = lm.a[Tri].to(ref.H.dtype)          # the own vertices' weights, once
    H_new_b = mean3(H_new, Tri, w, P.H_min)
    Hstar_b = mean3(ref.H, Tri, w, P.H_min)
    Hdrho_b = mean3(ph["Hdrho_amb"], Tri, w, P.H_min)
    H_old_b = mean3(old.H, Tri, w, P.H_min)
    k32 = tab.k32
    detr_b, _ = ell_rows(tab.M_map_a_b, k32["ab_len"], detr, detr, L)
    ddrho_dx, dH_dx = ell_rows(tab.M_ddx_a_b, k32["dx_len"], ph["drho_amb"],
                               ref.H, L)
    ddrho_dy, dH_dy = ell_rows(tab.M_ddy_a_b, k32["dy_len"], ph["drho_amb"],
                               ref.H, L)
    dHib_dx, dHib_dy = fc["dHib_dx_b"], fc["dHib_dy_b"]
    edge_tri = lm.cf_b | lm.gl_b
    PGF_x = torch.where(
        edge_tri, grav * Hdrho_b * dHib_dx - 0.5 * grav * Hstar_b ** 2
        * ddrho_dx, -grav * Hdrho_b * dH_dx + grav * Hdrho_b * dHib_dx
        - 0.5 * grav * Hstar_b ** 2 * ddrho_dx)
    PGF_y = torch.where(
        edge_tri, grav * Hdrho_b * dHib_dy - 0.5 * grav * Hstar_b ** 2
        * ddrho_dy, -grav * Hdrho_b * dH_dy + grav * Hdrho_b * dHib_dy
        - 0.5 * grav * Hstar_b ** 2 * ddrho_dy)

    Ur, Vr = ref.U, ref.V
    TriA = tab.TriA
    TriCV = k32["TriCV"].long()
    sums = None
    for j in range(3):
        tc = k32["TriC"][:, j].long()
        t = tc.clamp(min=0)
        et = k32["TriET"][:, j].long()
        Uc, Vc = b_to_c(et[:, 0], et[:, 1], Ur), b_to_c(et[:, 0], et[:, 1], Vr)
        u_perp = Uc * tab.TDx_D[:, j] + Vc * tab.TDy_D[:, j]
        out_f = torch.clamp(u_perp, min=0.0)
        in_f = torch.clamp(u_perp, max=0.0)
        vn = TriCV[:, j]
        Hb_j = mean3(ref.H, vn, lm.a[vn].to(ref.H.dtype), P.H_min)
        TCw = tab.TriCw[:, j]
        adv = (tc >= 0) & ~lm.gl_b[t]
        fU = torch.where(adv, TCw * (out_f * Hstar_b * Ur + in_f * Hb_j
                                     * Ur[t]) / TriA, 0.0)
        fV = torch.where(adv, TCw * (out_f * Hstar_b * Vr + in_f * Hb_j
                                     * Vr[t]) / TriA, 0.0)
        zero = torch.zeros_like(fU)
        gU = gV = zero
        if visc:
            ev = k32["TriEV"][:, j].long()
            Hc = mean2(ref.H, ev, lm.a[ev].to(ref.H.dtype), P.H_min)
            dUn, dVn = Ur[t] - Ur, Vr[t] - Vr
            dUabs = torch.sqrt(dUn ** 2 + dVn ** 2)
            Ah = P.visc * dUabs * TCw / 100.0
            coef = Ah * Hc / TriA * TCw / tab.TriD[:, j]
            vis = (tc >= 0) & ~lm.cf_b[t]
            gU = torch.where(vis, coef * dUn, 0.0)
            gV = torch.where(vis, coef * dVn, 0.0)
        terms = (fU, fV, gU, gV)
        sums = terms if sums is None else tuple(
            a + b for a, b in zip(sums, terms))
    dQU, dQV, vU, vV = sums
    dQU = torch.where(lm.b, dQU, 0.0)
    dQV = torch.where(lm.b, dQV, 0.0)
    speed_ref = torch.sqrt(Ur ** 2 + Vr ** 2)
    dHUdt = (-dQU + PGF_x + P.fcor * Hstar_b * Vr
             - P.Cd_mom * Ur * speed_ref - detr_b * Ur)
    dHVdt = (-dQV + PGF_y - P.fcor * Hstar_b * Ur
             - P.Cd_mom * Vr * speed_ref - detr_b * Vr)
    if visc:
        vU = vU - Ur * P.visc * Hstar_b / TriA * tab.nb_border
        vV = vV - Vr * P.visc * Hstar_b / TriA * tab.nb_border
        dHUdt = dHUdt + torch.where(lm.b, vU, 0.0)
        dHVdt = dHVdt + torch.where(lm.b, vV, 0.0)
    HU = old.U * H_old_b + dHUdt * dt_i
    HV = old.V * H_old_b + dHVdt * dt_i
    Hn_b = torch.clamp(H_new_b, min=1e-3)
    U_new = torch.where(lm.b, HU / Hn_b, 0.0)
    V_new = torch.where(lm.b, HV / Hn_b, 0.0)
    speed = torch.sqrt(U_new ** 2 + V_new ** 2)
    lim = torch.clamp(P.v_max / torch.clamp(speed, min=1e-12), max=1.0)
    return U_new * lim, V_new * lim


def design_stage(tab, P, old, ref, lm, fc, dt_i, visc, post, L):
    """A stage as the kernel schedules it: (state, filtered, ph), as
    laddie_stage_plain returns them."""
    H_new, detr, ph, dQT, dQS, entr, entr_dmin = vertex_pass(
        tab, P, old, ref, lm, fc, dt_i, L)
    sgd, a = fc["SGD"], lm.a
    entr_p = torch.clamp(entr, min=0.0)
    detr_p = torch.clamp(detr, min=0.0)
    dHTdt = (-dQT + ph["melt"] * ph["T_base"]
             - ph["gamma_T"] * (ref.T - ph["T_base"]) + entr_p * ph["T_amb"]
             - detr_p * ref.T + entr_dmin * ph["T_amb"]
             + sgd * (freezing_lambda_2 + freezing_lambda_3 * fc["Hib"]))
    dHSdt = (-dQS + entr_p * ph["S_amb"] - detr_p * ref.S
             + entr_dmin * ph["S_amb"])
    Hn = torch.clamp(H_new, min=1e-3)
    T_new = torch.where(a, (old.T * old.H + dHTdt * dt_i) / Hn, old.T)
    S_new = torch.where(a, (old.S * old.H + dHSdt * dt_i) / Hn, old.S)
    U_new, V_new = triangle_pass(tab, P, old, ref, lm, fc, dt_i, visc,
                                 H_new, detr, ph, L)
    new = LaddieState(H=H_new, U=U_new, V=V_new, T=T_new, S=S_new)
    if post is None:
        return new, None, ph
    if post[0] == "blend":
        (c1, c2), now_H = post[1], post[2]
        return new._replace(H=c1 * H_new + c2 * now_H), None, ph
    if post[0] == "blend3":
        (c1, c2, c3), now_H = post[1], post[2]
        return new._replace(H=c1 * H_new + c2 * old.H + c3 * now_H), None, ph
    nu = post[1]
    return new, LaddieState(*(c + 0.5 * nu * (p + f - 2.0 * c)
                              for c, p, f in zip(ref, old, new))), ph


# -- the leg's buffer rotation --------------------------------------------

def leg_rotation(kind, step, st):
    """csrc/laddie.cu leg_stage: the sets a stage reads and writes, by
    name: "in" (the leg's initial state) or 0..3. (old, ref, out, filtered,
    the set of the step's starting H)."""
    prev = "in" if step == 0 else (step - 1) & 1
    nxt = step & 1
    if kind == "fbrk3":
        src = prev if st == 0 else st + 1
        return src, src, (st + 2 if st < 2 else nxt), None, prev
    if kind == "lfra":
        old = "in" if step == 0 else 2 + ((step - 1) & 1)
        return old, prev, nxt, 2 + (step & 1), prev
    return prev, prev, nxt, None, prev


def design_leg(tab, P, sch, state, lm, fc, n_steps, L):
    """A leg as the leg entry runs it: four state sets, rotated; a stage
    writes its vertex pass's fields first, then its triangle pass's from
    the sets as they then are (a set read after it was written in the
    same stage would change the result). (state, melt)."""
    sets = [LaddieState(*(torch.full_like(t, float("nan")) for t in state))
            for _ in range(4)]
    get = lambda j: state if j == "in" else sets[j]
    for step in range(n_steps):
        for st, (dt_i, visc, kind, coefs) in enumerate(sch.stages()):
            o, r, w, f, p = leg_rotation(sch.kind, step, st)
            assert w not in (o, r, p) and f not in (o, r, p, w)
            post = None if kind is None else (
                ("lfra", coefs) if kind == "lfra"
                else (kind, coefs, get(p).H))
            args = (tab, P, get(o), get(r), lm, fc, dt_i, visc, post, L)
            new, filt, ph = design_stage(*args)
            for n in ("H", "T", "S"):           # the vertex pass's fields
                getattr(get(w), n).copy_(getattr(new, n))
                if filt is not None:
                    getattr(get(f), n).copy_(getattr(filt, n))
            new, filt, ph = design_stage(*args)
            for n in ("U", "V"):                # the triangle pass's
                getattr(get(w), n).copy_(getattr(new, n))
                if filt is not None:
                    getattr(get(f), n).copy_(getattr(filt, n))
    return get((n_steps - 1) & 1), ph["melt"]


# -- the tests ------------------------------------------------------------

def same(a, b):
    """Bit-equal (NaN where both are NaN)."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def assert_same_states(a, b):
    for n, x, y in zip(LaddieState._fields, a, b):
        assert same(x, y), n


def params(jenkins=False):
    return cl.LaddieParams.from_config(Config(
        **dict(BASE, choice_laddie_gamma="Jenkins1991" if jenkins
               else "uniform")))


STAGES = ("fbrk3_s1", "fbrk3_beta_s3", "euler", "lfra", "jenkins_Ti",
          "euler_sgd")


def stage_case(name, md, lm, fc, s0, s1, dt):
    """(params, old, ref, forcing, dt_i, visc, post) of a stage case."""
    P = params(jenkins=name == "jenkins_Ti")
    if name == "fbrk3_s1":
        return P, s0, s0, fc, dt / 3, False, ("blend", (0.0, 1.0), s0.H)
    if name == "fbrk3_beta_s3":
        return P, s1, s0, fc, dt, True, ("blend3", (0.344, 0.312, 0.344),
                                         s1.H)
    if name == "lfra":
        return P, s1, s0, fc, dt, True, ("lfra", 0.1)
    if name == "jenkins_Ti":
        return P, s0, s0, dict(fc, use_Ti=True), dt, True, None
    if name == "euler_sgd":
        y = torch.as_tensor(md._host_mesh.V[:, 1])
        band = lm.a & (y.abs() < 12e3)
        sgd = torch.where(band, 72.0 / max(int(band.sum()), 1) / 1e6,
                          0.0).to(fc["Hib"].dtype)
        assert bool((sgd > 0).any())
        return P, s0, s0, dict(fc, SGD=sgd), dt, True, None
    return P, s0, s0, fc, dt, True, None


MESHES = {"uniform": False, "compact": True}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("where", list(MESHES))
@pytest.mark.parametrize("L", [32, 1])
@pytest.mark.parametrize("name", STAGES)
def test_stage_design_bit_equal(mesh, dtype, where, L, name):
    """The design's stage (each ELL row's stored entries added in order on
    L lanes and one padding product for the rest, the shared column
    loads, the direct tables, the bisection) equals laddie_stage_plain to
    the bit, on the uniform mesh and on the compact shelf mesh with its
    long and its padded rows."""
    md, tab, lm, fc, s0, s1 = setup(mesh, dtype, MESHES[where])
    P, old, ref, f, dt_i, visc, post = stage_case(name, md, lm, fc, s0, s1,
                                                  120.0)
    got = design_stage(tab, P, old, ref, lm, f, dt_i, visc, post, L)
    want = cl.laddie_stage_plain(tab, P, old, ref, lm, f, dt_i, visc, post)
    assert_same_states(got[0], want[0])
    if want[1] is not None:
        assert_same_states(got[1], want[1])
    for n in cl.PH_FIELDS:
        assert same(got[2][n], want[2][n]), n
    assert bool(lm.a.any()) and not bool(
        (want[0].U == 0).all()), "a vacuous case"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("where", list(MESHES))
def test_tables(mesh, dtype, where):
    """Past each ELL row's length every entry is padding (column 0, value
    +0.0); the compact mesh has rows past 16 entries (the run-time form's)
    and padded rows; the direct tables are the compositions of the mesh's
    own: VET = ETri[VE], TriET = ETri[TriE], TriEV = EV[TriE], TriCV =
    Tri[TriC] (edge or triangle 0 where there is none)."""
    md, tab, lm, fc, s0, s1 = setup(mesh, dtype, MESHES[where])
    longest, padded = 0, False
    for pre, M in (("ba", tab.M_map_b_a), ("ab", tab.M_map_a_b),
                   ("dx", tab.M_ddx_a_b), ("dy", tab.M_ddy_a_b)):
        m = tab.k32[f"{pre}_len"].long()
        k = torch.arange(M.cols.shape[0])[:, None]
        tail = k >= m[None]
        assert bool((M.cols[tail] == 0).all())
        assert bool(((M.vals[tail] == 0) & ~torch.signbit(M.vals[tail]))
                    .all())
        padded = padded or bool(tail.any())
        longest = max(longest, int(m.max()))
    assert padded
    assert (longest > 16) == MESHES[where], longest
    TriC = tab.k32["TriC"].long()
    Tri = tab.k32["Tri"].long()
    assert torch.equal(tab.k32["TriCV"].long(), Tri[TriC.clamp(min=0)])
    mesh_h = md._host_mesh
    ETri, EV = (torch.as_tensor(mesh_h.ETri), torch.as_tensor(mesh_h.EV))
    VE = torch.as_tensor(mesh_h.VE).clamp(min=0)
    TriE = torch.as_tensor(mesh_h.TriE).clamp(min=0)
    assert torch.equal(tab.k32["VET"].long(), ETri[VE].long())
    assert torch.equal(tab.k32["TriET"].long(), ETri[TriE].long())
    assert torch.equal(tab.k32["TriEV"].long(), EV[TriE].long())
    assert bool((tab.k32["VET"] < 0).any())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_bisection_is_the_linear_walk(dtype):
    """search_left against the linear side-left walk and
    torch.searchsorted: depths at every level, between two, above the
    first, below the last, infinite, signed zero and NaN; on the schema's
    axis (16 levels) and on one of uneven steps with a repeated level."""
    for z in (torch.as_tensor(ocean_depth_axis(Config(**BASE))),
              torch.tensor([0.0, 5.0, 20.0, 20.0, 21.5, 300.0, 1000.0])):
        z = z.to(dtype)
        mids = (z[1:] + z[:-1]) / 2
        depths = torch.cat([z, mids, z - 1e-3, z + 1e-3, torch.tensor(
            [-7.0, -0.0, 0.0, float(z[-1]) * 2, float("inf"),
             float("-inf"), float("nan")], dtype=dtype)]).to(dtype)
        got = search_left(z, depths)
        assert torch.equal(got, linear_walk(z, depths))
        assert torch.equal(got[~depths.isnan()], torch.searchsorted(
            z, depths[~depths.isnan()]))
        assert int(got[depths.isnan()][0]) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("where", list(MESHES))
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_leg_rotation_bit_equal(mesh, dtype, where, scheme):
    """The leg's four rotated state sets, each stage's vertex fields
    written before its triangle fields are formed, over 3 pseudo-steps:
    the state and the last stage's melt equal the loop of
    make_laddie_step's plain steps to the bit."""
    md, tab, lm, fc, s0, s1 = setup(mesh, dtype, MESHES[where])
    C = Config(**dict(BASE, **SCHEMES[scheme]))
    sch = LaddieScheme.from_config(C)
    step = tl.make_laddie_step(C, md, stage_fn=cl.laddie_stage_plain)
    carry = (s0, s0)
    for _ in range(3):
        carry, ph = step(carry, lm, fc)
    got, melt = design_leg(tab, step.params, sch, s0, lm, fc, 3, 32)
    assert_same_states(got, carry[0])
    assert same(melt, ph["melt"])
    if scheme != "fbrk3":        # the fbrk3 freeze: H stays put
        assert not same(carry[0].H, s0.H)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_laddie_leg_cpu_is_the_plain_loop(mesh, scheme):
    """laddie_leg on CPU tensors (f64) equals the loop of plain steps, and
    run_laddie_leg equals both, with the default step and with a step of
    plain stages (it hands either step's tables to laddie_leg)."""
    md, tab, lm, fc, s0, s1 = setup(mesh, torch.float64)
    C = Config(**dict(BASE, **SCHEMES[scheme]))
    step = tl.make_laddie_step(C, md, stage_fn=cl.laddie_stage_plain)
    carry = (s0, s0)
    for _ in range(4):
        carry, ph = step(carry, lm, fc)
    got, melt = cl.laddie_leg(step.tables, step.params, step.scheme, s0, lm,
                              fc, 4)
    assert_same_states(got, carry[0])
    assert same(melt, ph["melt"])
    for step_fn in (tl.make_laddie_step(C, md), step):
        st, melt_yr = tl.run_laddie_leg(C, md, s0, lm, fc,
                                        4 * C.dt_laddie / 86400.0, step_fn)
        assert_same_states(st, carry[0])
        assert same(melt_yr, ph["melt"] * tl.sec_per_year)


def test_laddie_leg_has_no_host_fallback(mesh):
    """Without a card the default device raises before any leg runs, and a
    leg on a device that is neither the card nor the host raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh_data(mesh)
    md, tab, lm, fc, s0, s1 = setup(mesh, torch.float64)
    meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t
    with pytest.raises(ValueError, match="unsupported device"):
        cl.laddie_leg(tab, params(), LaddieScheme("euler", 120.0),
                      LaddieState(*(meta(t) for t in s0)),
                      type(lm)(*(meta(t) for t in lm)),
                      {k: meta(v) for k, v in fc.items()}, 2)
