"""The port's BPA stress balance against the JAX package's, on the CPU.

The whole solve (`make_solve_stress_balance`, 'BPA') on the conftest's
small mesh with the Halfar dome of tests/test_hybrid.py, and on ISMIP-HOM
A and C at a small L, from the same state on both sides: the same
viscosity and Krylov iteration counts, and u3, v3 and the vertical
averages within F64_TOL of the largest velocity. The JAX closure A_op
cannot be reached from outside its solve, so the equal Krylov counts are
the operator's check; the port's operator (`bpa_apply_plain`, the CUDA
kernel's plain version) is held to the literal composition of bpa.py
(`M @ f` and the zeta differences) and its line preconditioner to
thomas_batched here.

Tolerances. F64_TOL = 1e-10 of the largest velocity: both sides run the
same arithmetic in f64 and differ in summation order only (the stencil
sums of the kernel's plain version run over the M2 stack's shared
pattern entry by entry, the JAX package's over each operator's own
pattern); GMRES then stops on the same iteration, and the fields differ
by the rounding of an rtol-1e-7 solve amplified by the viscosity loop
(measured: 1e-14 to 3e-11 of the largest velocity, the largest in
experiment C, whose sliding law is singular at the zero initial
velocity)."""

import numpy as np
import pytest
import torch

import jax

from torch_port_fixture import (mesh_to_numpy, state_to_numpy, rel_gap,
                                ismip_hom)

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.core.analytical import halfar_H
from ufemism2_tpu.core.ice.pc import make_solve_stress_balance as j_make_solve
from ufemism2_tpu.core.ice.state import init_ice_state as j_init_state
from ufemism2_tpu.core.mesh_data import build_mesh_data as j_build_md
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import mesh_from_numpy, ice_state_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice.bpa import (BpaGeometry, register_bpa_static,
                                             viscosity_3d)
from ufemism2_tpu_torch.core.ice.pc import \
    make_solve_stress_balance as t_make_solve
from ufemism2_tpu_torch.main.region import _build_bedrock_cdfs
from ufemism2_tpu_torch.ops import cuda_bpa
from ufemism2_tpu_torch.ops.tridiag import thomas_batched

F64_TOL = 1e-10

# tests/test_hybrid.py's dome: Weertman sliding, Martin2011 hydrology
HALFAR = dict(choice_sliding_law="Weertman",
              choice_basal_hydrology_model="Martin2011",
              choice_ice_rheology_Glen="uniform",
              uniform_Glens_flow_factor=1e-16,
              choice_subgrid_grounded_fraction="bilin_interp_TAF",
              choice_stress_balance_approximation="BPA")


class Setup:
    pass


def halfar_setup(small_mesh, dtype=torch.float64, **over):
    """(JAX Config, port Config, JAX md, port md, JAX state, port state,
    bedrock CDFs of each side) for the dome on the small mesh."""
    e = Setup()
    kw = dict(HALFAR, **over)
    if dtype == torch.float32:
        kw["tpu_precision"] = "f32"
    e.Cj, e.Ct = CJ(**kw), CT(**kw)
    e.mdj = j_build_md(small_mesh, dtype=None if dtype == torch.float64
                       else np.float32)
    mesh_t = mesh_from_numpy(mesh_to_numpy(small_mesh))
    e.mdt = tmd.build_mesh_data(mesh_t, dtype=dtype, device="cpu")
    x, y = small_mesh.V[:, 0], small_mesh.V[:, 1]
    Hi = halfar_H(1e-16, 3.0, 2000.0, 45e3, x, y, 0.0)
    Hb = np.zeros_like(Hi)
    e.sj = j_init_state(e.mdj, Hi, Hb, np.zeros_like(Hi), nz=e.mdj.nz,
                        dt_init=0.1)
    e.st = ice_state_from_numpy(state_to_numpy(e.sj), device="cpu",
                                dtype=dtype)
    e.cdfs_j = e.cdfs_t = None
    return e


def ismip_setup(experiment, L=20e3, res=5e3, **over):
    """The same for ISMIP-HOM: the JAX region (without a stress balance)
    makes the state and the bedrock CDFs, the port takes them as numpy."""
    e = Setup()
    kw = ismip_hom(experiment, L, res, **over)
    e.Cj, e.Ct = CJ(**kw), CT(**kw)
    mesh_j = build_mesh_from_config(e.Cj, "ANT")
    mesh_t = mesh_from_numpy(mesh_to_numpy(mesh_j))
    rj = JaxRegion(CJ(**dict(kw, choice_stress_balance_approximation="none")),
                   "ANT", mesh=mesh_j)
    e.mdj, e.sj, e.cdfs_j = rj.md, rj.state, rj._bedrock_cdfs
    e.mdt = tmd.build_mesh_data(mesh_t, dtype=torch.float64, device="cpu")
    e.st = ice_state_from_numpy(state_to_numpy(e.sj), device="cpu",
                                dtype=torch.float64)
    e.cdfs_t = _build_bedrock_cdfs(e.Ct, mesh_t, "ANT", e.mdt)
    return e


def solve_both(e):
    """Each side's solve from its state: (JAX outputs, port outputs)."""
    sj, st = e.sj, e.st
    oj = jax.jit(j_make_solve(e.Cj, e.mdj, bedrock_cdfs=e.cdfs_j))(
        e.mdj, sj.Hi, sj.Hs, sj.Hb, sj.SL, sj.Ti, sj)
    ot = t_make_solve(e.Ct, e.mdt, bedrock_cdfs=e.cdfs_t)(
        e.mdt, st.Hi, st.Hs, st.Hb, st.SL, st.Ti, st)
    return oj, ot


def check_equal(oj, ot, tol=F64_TOL):
    assert ot[4] == int(oj[4]) > 0                        # n_visc_its
    assert ot[5] == int(oj[5]) > 0                        # n_Axb_its
    scale = max(float(np.abs(np.asarray(oj[i])).max()) for i in range(4))
    assert scale > 0.01                                   # the ice flows
    for i in range(4):
        gap = np.abs(ot[i].double().numpy()
                     - np.asarray(oj[i], np.float64)).max()
        assert gap <= tol * scale, (i, gap / scale)
    # the solver's warm-start fields pass through unchanged
    for k in ("visc_tau_bx", "visc_tau_by", "visc_eta_3D_b"):
        assert rel_gap(ot[6][k], np.asarray(oj[6][k])) == 0.0


# (set-up, config overrides): both preconditioner families, every name the
# reference maps to M_pre, no-slip and sliding bases (Weertman and
# ISMIP-HOM C's linear friction), zero and infinite lateral sides (the
# dome's box) and periodic ones (ISMIP-HOM), one viscosity iteration and
# the whole loop. The dome runs without sliding: with Weertman sliding from
# zero velocity its f64 GMRES solves end by stagnation far above their
# tolerance (residual 3e-2 after 310 iterations; from a warm start, 652
# against 586 iterations on the two sides), so two summation orders give
# fields 1e-4 apart; ISMIP-HOM A carries the Weertman case instead.
SOLVE_CASES = {
    "halfar_block_jacobi_one_iteration": ("halfar", dict(visc_it_nit=0)),
    "halfar_zero_sides": ("halfar", dict(
        visc_it_nit=1, BC_u_west="zero", BC_v_west="zero",
        BC_u_south="zero", BC_v_north="zero")),
    "ismip_a_weertman": ("A", dict(visc_it_nit=1,
                                   choice_sliding_law="Weertman")),
    # the loop until its own criterion stops it (a looser one than the
    # schema's 5e-5, which this coarse periodic mesh reaches only after
    # some 50 iterations)
    "ismip_a_whole_loop": ("A", dict(visc_it_nit=50,
                                     visc_it_norm_dUV_tol=1e-3)),
    "ismip_c_sliding": ("C", dict(visc_it_nit=1)),
}
# the solves that build the polynomial preconditioners compile slowly on
# the JAX side; the coarsest ISMIP-HOM mesh keeps them short
PRECOND_CASES = ("chebyshev", "neumann", "block_dense")


def run_case(small_mesh, kind, over, res=5e3):
    if kind == "halfar":
        e = halfar_setup(small_mesh, choice_sliding_law="no_sliding", **over)
    else:
        e = ismip_setup(kind, res=res, **over)
    oj, ot = solve_both(e)
    check_equal(oj, ot)
    assert ot[2].shape == (e.mdt.nTri, e.mdt.nz)
    return ot


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_bpa_solve_matches_jax(small_mesh, case):
    kind, over = SOLVE_CASES[case]
    ot = run_case(small_mesh, kind, over,
                  res=10e3 if case == "ismip_a_whole_loop" else 5e3)
    if case == "ismip_a_whole_loop":
        assert 1 < ot[4] < 50             # the loop converged by itself


@pytest.mark.parametrize("kind", PRECOND_CASES)
def test_bpa_preconditioners_match_jax(small_mesh, kind):
    """chebyshev and neumann accelerate the line preconditioner; every
    other name (block_dense here) takes it alone, as in the reference."""
    run_case(small_mesh, "A", dict(visc_it_nit=0,
                                   tpu_stress_balance_precond=kind),
             res=10e3)


# -- the operator and the preconditioner against their literal forms ---

def _operator_fields(small_mesh, dtype, no_sliding):
    """A BpaOperator's inputs on the dome from a seeded 3-D field: the
    coefficients of one viscosity iteration as the solve forms them."""
    e = halfar_setup(small_mesh, dtype=dtype)
    md, st = e.mdt, e.st
    register_bpa_static(e.Ct, md._host_mesh, md)
    rng = np.random.default_rng(11)
    shape = (md.nTri, md.nz)
    u = torch.as_tensor(50.0 * rng.standard_normal(shape), dtype=dtype)
    v = torch.as_tensor(50.0 * rng.standard_normal(shape), dtype=dtype)
    zeta = np.asarray(md._host_mesh.zeta)
    geo = BpaGeometry(md, st.Hi, st.Hs, float(zeta[1] - zeta[0]))
    from ufemism2_tpu_torch.core.ice.rheology import calc_ice_rheology_glen
    from ufemism2_tpu_torch.core.ice.masks import determine_masks
    masks = determine_masks(md, st.Hi, st.Hb, st.SL)
    A_flow = calc_ice_rheology_glen(e.Ct, md, st.Hi, st.Hs, st.Ti,
                                    masks["mask_grounded_ice"],
                                    masks["mask_floating_ice"])
    eta, ex, ey, ez, _ = viscosity_3d(e.Ct, geo, A_flow, u, v, 1e-8)
    beta = torch.as_tensor(1e3 * rng.random(md.nTri), dtype=dtype)
    eta_base = torch.clamp(eta[:, -1], min=1e4)
    coeffs = geo.coeffs(eta, ex, ey, ez, beta, eta_base)
    A = cuda_bpa.BpaOperator(md.M2_stack.op, md.x("bpa_rows"), coeffs,
                             geo.dzeta, no_sliding,
                             round_x_bf16=dtype == torch.float32)
    return md, geo, coeffs, A, u, v


def literal_apply(md, geo, c, rows, u, v, no_sliding):
    """bpa.py:208-289 written as the JAX package writes it: each
    derivative `M @ f + z * ddzeta(f)` with the port's own M2 operators."""
    ddx, ddy, ddz = geo.ddx, geo.ddy, geo.ddz
    dz2 = geo.consts[2]
    d2 = lambda f: cuda_bpa.d2dzeta2_plain(f, dz2)
    ux, uy, vx, vy = ddx(u), ddy(u), ddx(v), ddy(v)
    uxx, uyy, uxy = ddx(ux), ddy(uy), ddy(ux)
    vxx, vyy, vxy = ddx(vx), ddy(vy), ddy(vx)
    uz, vz = ddz(u), ddz(v)
    uzz = c.zz[:, None] ** 2 * d2(u)
    vzz = c.zz[:, None] ** 2 * d2(v)
    e, ex, ey, ez = c.eta, c.eta_x, c.eta_y, c.eta_z
    Au = (4 * e * uxx + 4 * ex * ux + e * uyy + ey * uy + e * uzz
          + ez * uz + 3 * e * vxy + 2 * ex * vy + ey * vx)
    Av = (4 * e * vyy + 4 * ey * vy + e * vxx + ex * vx + e * vzz
          + ez * vz + 3 * e * uxy + 2 * ey * ux + ex * uy)
    S_u0 = (2 * c.dh_dx * (2 * ux[:, 0] + vy[:, 0])
            + c.dh_dy * (uy[:, 0] + vx[:, 0]))
    S_v0 = (2 * c.dh_dy * (2 * vy[:, 0] + ux[:, 0])
            + c.dh_dx * (vx[:, 0] + uy[:, 0]))
    Au[:, 0] = (4 * e[:, 0] * uxx[:, 0] + 4 * ex[:, 0] * ux[:, 0]
                + e[:, 0] * uyy[:, 0] + ey[:, 0] * uy[:, 0]
                + e[:, 0] * c.qfac * (u[:, 1] - u[:, 0] - c.dzz * S_u0)
                + ez[:, 0] * S_u0 + 3 * e[:, 0] * vxy[:, 0]
                + 2 * ex[:, 0] * vy[:, 0] + ey[:, 0] * vx[:, 0])
    Av[:, 0] = (4 * e[:, 0] * vyy[:, 0] + 4 * ey[:, 0] * vy[:, 0]
                + e[:, 0] * vxx[:, 0] + ex[:, 0] * vx[:, 0]
                + e[:, 0] * c.qfac * (v[:, 1] - v[:, 0] - c.dzz * S_v0)
                + ez[:, 0] * S_v0 + 3 * e[:, 0] * uxy[:, 0]
                + 2 * ey[:, 0] * ux[:, 0] + ex[:, 0] * uy[:, 0])
    k = u.shape[1] - 1
    if no_sliding:
        Au[:, k], Av[:, k] = u[:, k], v[:, k]
    else:
        P_u = (2 * c.db_dx * (2 * ux[:, k] + vy[:, k])
               + c.db_dy * (uy[:, k] + vx[:, k]) + c.ratio * u[:, k])
        P_v = (2 * c.db_dy * (2 * vy[:, k] + ux[:, k])
               + c.db_dx * (vx[:, k] + uy[:, k]) + c.ratio * v[:, k])
        Au[:, k] = (4 * e[:, k] * uxx[:, k] + 4 * ex[:, k] * ux[:, k]
                    + e[:, k] * uyy[:, k] + ey[:, k] * uy[:, k]
                    + 3 * e[:, k] * vxy[:, k] + 2 * ex[:, k] * vy[:, k]
                    + ey[:, k] * vx[:, k]
                    + c.qb * (u[:, k - 1] - u[:, k]) + c.rb * P_u)
        Av[:, k] = (4 * e[:, k] * vyy[:, k] + 4 * ey[:, k] * vy[:, k]
                    + e[:, k] * vxx[:, k] + ex[:, k] * vx[:, k]
                    + 3 * e[:, k] * uxy[:, k] + 2 * ey[:, k] * ux[:, k]
                    + ex[:, k] * uy[:, k]
                    + c.qb * (v[:, k - 1] - v[:, k]) + c.rb * P_v)

    def nbr(x):
        s = torch.where(rows.mask_TriC[:, :, None], x[rows.TriC],
                        0.0).sum(dim=1)
        return s - rows.mask_TriC.sum(dim=1).to(x.dtype)[:, None] * x
    free = rows.free[:, None]
    Au = torch.where(free, Au, torch.where(rows.inf_u[:, None], nbr(u), u))
    Av = torch.where(free, Av, torch.where(rows.inf_v[:, None], nbr(v), v))
    return Au, Av


# f64: summation order apart, the same arithmetic (measured below 1e-15
# of the largest row). f32: both sides round the stencil operands to
# bfloat16 alike; the rows then sum about 70 products whose largest terms
# cancel to the row's value, so the order of the sums shows at a few f32
# ulps of the largest term (measured 2e-6 of the largest row).
LITERAL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("no_sliding", [False, True],
                         ids=["sliding", "no_slip"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_bpa_apply_plain_matches_literal_form(small_mesh, dtype, no_sliding):
    md, geo, c, A, u, v = _operator_fields(small_mesh, dtype, no_sliding)
    rows = md.x("bpa_rows")
    assert (~rows.free).any() and rows.inf_u[~rows.free].all()
    n0 = cuda_bpa.launches
    Au, Av = A((u, v))
    assert cuda_bpa.launches == n0          # the CPU takes the plain version
    Lu, Lv = literal_apply(md, geo, c, rows, u, v, no_sliding)
    scale = float(torch.cat([Lu, Lv]).abs().max())
    for a, b in ((Au, Lu), (Av, Lv)):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= LITERAL_TOL[dtype] * scale
    # lateral rows copy or sum the unrounded operand exactly as written
    assert torch.equal(Au[~rows.free], Lu[~rows.free])
    # the flat form gmres uses is the same operator
    y = A.flat(torch.cat([u.reshape(-1), v.reshape(-1)]))
    assert torch.equal(y, torch.cat([Au.reshape(-1), Av.reshape(-1)]))


def test_line_thomas_plain_is_thomas_batched(small_mesh):
    """The preconditioner's column solves equal thomas_batched per
    right-hand side to the bit, on the bands a solve forms (lateral rows
    identity) and on the flat vector."""
    rng = np.random.default_rng(3)
    n, nz = 300, 12
    sub = torch.as_tensor(rng.standard_normal((n, nz - 1)))
    sup = torch.as_tensor(rng.standard_normal((n, nz - 1)))
    dia = torch.as_tensor(4.0 + rng.random((n, nz)))
    dia[:7, 3] = 0.0                         # pivots at the clamp
    sub[:7, 2] = 0.0
    ru, rv = (torch.as_tensor(rng.standard_normal((n, nz)))
              for _ in range(2))
    M = cuda_bpa.LineThomas(sub, dia, sup)
    n0 = cuda_bpa.thomas_launches
    xu, xv = M((ru, rv))
    assert cuda_bpa.thomas_launches == n0
    assert torch.equal(xu, thomas_batched(sub, dia, sup, ru))
    assert torch.equal(xv, thomas_batched(sub, dia, sup, rv))
    x = M.flat(torch.cat([ru.reshape(-1), rv.reshape(-1)]))
    assert torch.equal(x, torch.cat([xu.reshape(-1), xv.reshape(-1)]))
    with pytest.raises(ValueError):
        cuda_bpa.LineThomas(sub[:, :-1], dia, sup)
    with pytest.raises(ValueError):
        cuda_bpa.LineThomas(sub[:, :1], dia[:, :2], sup[:, :1])


def test_bpa_operator_checks(small_mesh):
    md, geo, c, A, u, v = _operator_fields(small_mesh, torch.float64, False)
    with pytest.raises(TypeError):
        A((u.float(), v.float()))
    with pytest.raises(ValueError):
        A((u[:, :-1], v[:, :-1]))
    with pytest.raises(TypeError):
        cuda_bpa.BpaOperator(md.M2_stack.op, md.x("bpa_rows"), c, geo.dzeta,
                             round_x_bf16=True)
    with pytest.raises(ValueError):
        cuda_bpa.BpaOperator(md.M2_stack.op, md.x("bpa_rows"),
                             c._replace(eta=c.eta[:, :2]), geo.dzeta)


# -- f32 ---------------------------------------------------------------

# visc_it_nit -> the largest relative gap of the Krylov counts allowed
F32_COUNT_GAP = {0: 0.0, 3: 0.05}


@pytest.mark.parametrize("nit", list(F32_COUNT_GAP),
                         ids=["one_iteration", "four_iterations"])
def test_bpa_f32_against_jax_f32(small_mesh, nit):
    """The port's f32 BPA solve against the JAX package's f32 solve on the
    dome without sliding. Both round the stencil operands to bfloat16 and
    stop GMRES at the f32 floor (rtol 1e-5), where the iteration counts
    follow the operator's last bit: after one viscosity iteration they are
    equal (58 and 58), after four they part by 3.7 % (335 against 323), so
    that case is held to 5 %. The velocities differ by the floor of two f32
    solves of one system, which the relative step of bfloat16, 2^-8 =
    3.9e-3, bounds (tests/test_torch_f32.py takes 2e-2 for the DIVA
    initial solve; measured here 2.6e-4 and 3.1e-4)."""
    e = halfar_setup(small_mesh, dtype=torch.float32, visc_it_nit=nit,
                     choice_sliding_law="no_sliding")
    oj, ot = solve_both(e)
    assert np.asarray(oj[2]).dtype == np.float32
    assert ot[2].dtype == torch.float32
    assert ot[4] == int(oj[4]) == nit + 1
    n_j = int(oj[5])
    assert n_j > 0 and abs(ot[5] - n_j) <= F32_COUNT_GAP[nit] * n_j, \
        (ot[5], n_j)
    scale = float(np.abs(np.asarray(oj[2], np.float64)).max())
    assert scale > 1.0                               # the dome flows
    gap = np.abs(ot[2].double().numpy() - np.asarray(oj[2], np.float64)).max()
    assert gap <= 2e-2 * scale, gap / scale
