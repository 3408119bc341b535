"""The port's SSA/DIVA stress balance against the JAX package on the
fixture mesh: the host BC tables, the matrix-free operator and its
block-Jacobi preconditioner on seeded fields, and the full viscosity
iteration from the cold (zero-velocity) fixture state.

On the CPU the port's stack apply runs the plain version of its kernel;
the JAX side runs its gather-ELL operators in f64 and its tiled (hi, lo)
stack in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_fixture import (configs, build_meshes, state_to_numpy,
                                rel_gap)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import ssadiva as jss
from ufemism2_tpu.core.ice.pc import make_solve_stress_balance as j_make_solve
from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.convert import ice_state_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import ssadiva as tss
from ufemism2_tpu_torch.core.ice.pc import \
    make_solve_stress_balance as t_make_solve
from ufemism2_tpu_torch.main.region import _build_bedrock_cdfs

# f64: the same arithmetic on both sides, summation order apart
# (measured 7e-17 of max|y|).
F64_TOL = 1e-11
# f32: both sides round x to bfloat16 alike; the JAX side's coefficients
# are a bf16 (hi, lo) pair, exact to 2^-17, the port's are plain f32, and
# each row sums about ten products in another order. Measured 8e-8 of
# max|y|; the bound allows a little over ten times that.
F32_TOL = 1e-6
# Two GMRES runs at rtol 1e-7 with different summation order.
VEL_TOL = 1e-5


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs()
    e.mesh_j, e.mesh_t = build_meshes()
    rng = np.random.default_rng(7)
    nTri = e.mesh_j.nTri
    # per-triangle fields of the size the viscosity iteration produces
    e.fields = dict(N=1e9 * (1.0 + rng.random(nTri)),
                    dNx=1e4 * rng.standard_normal(nTri),
                    dNy=1e4 * rng.standard_normal(nTri),
                    beta=1e3 * rng.random(nTri),
                    u=300.0 * rng.standard_normal(nTri),
                    v=300.0 * rng.standard_normal(nTri))
    return e


def test_bc_tables_match(env):
    """Host-side statics: triangle border indices and the BC row
    classification."""
    assert np.array_equal(tss.calc_TriBI(env.mesh_t),
                          jss.calc_TriBI(env.mesh_j))
    bt, bj = tss.make_bc_data(env.Ct, env.mesh_t), \
        jss.make_bc_data(env.Cj, env.mesh_j)
    for name in bt._fields:
        assert np.array_equal(getattr(bt, name), getattr(bj, name)), name
    assert bt.free.sum() < env.mesh_t.nTri      # there are border rows


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_operator_and_preconditioner(env, prec):
    jd, td, tol = ((jnp.float64, torch.float64, F64_TOL) if prec == "f64"
                   else (jnp.float32, torch.float32, F32_TOL))
    mdj = jmd.build_mesh_data(env.mesh_j,
                              dtype=None if prec == "f64" else jd)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=td, device="cpu")
    jss.register_ssadiva_static(env.Cj, env.mesh_j, mdj)
    tss.register_ssadiva_static(env.Ct, env.mesh_t, mdt)
    # the port applies the stack in both precisions
    assert mdt.M2_stack.n_ops == 5 and mdt.M2_stack.vals.dtype == td
    J = {k: jnp.asarray(a, jd) for k, a in env.fields.items()}
    T = {k: torch.as_tensor(a, dtype=td) for k, a in env.fields.items()}
    args = ("N", "dNx", "dNy", "beta")
    yj = jss.make_A(mdj, *(J[k] for k in args))((J["u"], J["v"]))
    yt = tss.make_A(mdt, *(T[k] for k in args))((T["u"], T["v"]))
    zj = jss.make_precond(mdj, *(J[k] for k in args))((J["u"], J["v"]))
    zt = tss.make_precond(mdt, *(T[k] for k in args))((T["u"], T["v"]))
    for a, b in zip(yt + zt, yj + zj):
        assert a.dtype == td
        assert rel_gap(a, np.asarray(b)) <= tol
    # border rows: 'infinite' rows hold sum(neighbours) - n x, every other
    # border row the identity
    free = mdt.x("ssa_bc_free").numpy()
    inf_u = mdt.x("ssa_bc_inf_u").numpy()
    assert (~free).any() and inf_u.any()
    TriC, u = env.mesh_t.TriC, np.asarray(T["u"].double())
    nbr = np.where(TriC >= 0, u[np.maximum(TriC, 0)], 0.0).sum(axis=1) \
        - (TriC >= 0).sum(axis=1) * u
    want = np.where(inf_u, nbr, u)[~free]
    assert rel_gap(yt[0][torch.from_numpy(~free)].double(), want) <= tol


# Border-row choices: the schema's default makes every border row
# 'infinite'; the mixed case has free, 'infinite' and 'zero' (identity)
# rows at once, and rows whose u and v kinds differ.
BC_CASES = {
    "all_infinite": {},
    "mixed": dict(BC_u_west="zero", BC_v_west="infinite",
                  BC_u_south="zero", BC_v_south="zero",
                  BC_u_north="infinite", BC_v_north="zero"),
}
# f32 with the rounding on: as F32_TOL above (both sides round the
# derivative operand to bfloat16 alike and leave beta * u unrounded).
DIVA_TOL = {"f64": 1e-12, "f32": F32_TOL}


def _both_operators(env, prec, bc, fields=None):
    """make_A of both packages on the fixture mesh and seeded fields;
    returns (port md, port fields, JAX result, port operator)."""
    jd, td = ((jnp.float64, torch.float64) if prec == "f64"
              else (jnp.float32, torch.float32))
    Cj, Ct = configs(**BC_CASES[bc])
    mdj = jmd.build_mesh_data(env.mesh_j,
                              dtype=None if prec == "f64" else jd)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=td, device="cpu")
    jss.register_ssadiva_static(Cj, env.mesh_j, mdj)
    tss.register_ssadiva_static(Ct, env.mesh_t, mdt)
    fields = fields or env.fields
    J = {k: jnp.asarray(a, jd) for k, a in fields.items()}
    T = {k: torch.as_tensor(a, dtype=td) for k, a in fields.items()}
    args = ("N", "dNx", "dNy", "beta")
    yj = jss.make_A(mdj, *(J[k] for k in args))((J["u"], J["v"]))
    A = tss.make_A(mdt, *(T[k] for k in args))
    return mdt, T, yj, A


@pytest.mark.parametrize("bc", list(BC_CASES))
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_diva_apply_plain_matches_jax(env, prec, bc):
    """The operator make_A gives on the CPU (diva_apply_plain) against
    the JAX package's, on both call forms, with every row kind the BC
    choices make."""
    mdt, T, yj, A = _both_operators(env, prec, bc)
    free = mdt.x("ssa_bc_free")
    inf_u, inf_v = mdt.x("ssa_bc_inf_u"), mdt.x("ssa_bc_inf_v")
    assert free.any() and (~free & inf_u).any()
    if bc == "mixed":
        assert (~free & ~inf_u).any() and (~free & ~inf_v).any()
        assert (~free & (inf_u != inf_v)).any()
    yt = A((T["u"], T["v"]))
    for a, b in zip(yt, yj):
        assert a.dtype == T["u"].dtype
        assert rel_gap(a, np.asarray(b)) <= DIVA_TOL[prec]
    # the flat form gmres uses is the same operator
    yf = A.flat(torch.cat([T["u"], T["v"]]))
    assert torch.equal(yf, torch.cat(yt))
    # identity rows copy the unrounded operand exactly
    ident = ~free & ~inf_u
    assert torch.equal(yt[0][ident], T["u"][ident])
    # the row tables the kernel reads say what the masks say
    rows = mdt.x("ssa_diva_rows")
    code = rows.code.numpy()
    assert np.array_equal(code == 0, free.numpy())
    assert np.array_equal((code & 2) != 0, (~free & inf_u).numpy())
    assert np.array_equal((code & 4) != 0, (~free & inf_v).numpy())
    assert np.array_equal(rows.tric32.numpy(), env.mesh_t.TriC)
    assert A.rows is rows                   # built once per mesh data


def test_friction_term_takes_the_unrounded_velocity(env):
    """In f32 the derivative terms see (u, v) rounded to bfloat16, but
    beta_eff * u does not: with a friction that dominates every other
    term, A u is -beta * u to f32 accuracy, which the rounded u (2^-9
    relative) would miss a thousandfold."""
    fields = dict(env.fields, beta=np.full_like(env.fields["beta"], 1e12),
                  N=np.full_like(env.fields["N"], 1e3),
                  dNx=np.zeros_like(env.fields["dNx"]),
                  dNy=np.zeros_like(env.fields["dNy"]))
    mdt, T, yj, A = _both_operators(env, "f32", "all_infinite", fields)
    free = mdt.x("ssa_bc_free")
    Au, _ = A((T["u"], T["v"]))
    want = (-T["beta"] * T["u"])[free]
    u_r = T["u"].to(torch.bfloat16).to(torch.float32)
    wrong = (-T["beta"] * u_r)[free]
    assert rel_gap(Au[free], want.numpy()) < 1e-6
    assert rel_gap(wrong, want.numpy()) > 1e-4      # the test can tell
    assert rel_gap(Au, np.asarray(yj[0])) <= F32_TOL


def test_diva_operator_checks():
    """What depends only on the operator is checked when it is built,
    what depends on x per call; on the CPU nothing is launched."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    from ufemism2_tpu_torch.ops.sparse import ell_stack_from_csr
    import scipy.sparse as sp
    n = 12
    mats = [sp.eye(n, format="csr") * (i + 1.0) for i in range(5)]
    S = ell_stack_from_csr(mats, dtype=torch.float64, device="cpu")
    z = torch.zeros(n, dtype=torch.bool)
    TriC = torch.zeros((n, 3), dtype=torch.int64)
    rows = cuda_spmv.DivaRows(TriC, TriC > 0, ~z, z, z)
    f = [torch.ones(n, dtype=torch.float64)] * 4
    before = cuda_spmv.diva_launches
    A = cuda_spmv.DivaOperator(S.op, rows, *f)
    x = torch.arange(2.0 * n, dtype=torch.float64)
    # ddx = 1, ddy = 2, dxx = 3, dxy = 4, dyy = 5 times the identity:
    # Au = (4*3 + 4*1 + 5 + 2 - 1) u + (3*4 + 2*2 + 1) v = 22 u + 17 v
    # Av = (4*5 + 4*2 + 3 + 1 - 1) v + (3*4 + 2*1 + 2) u = 31 v + 16 u
    want = torch.cat([22 * x[:n] + 17 * x[n:], 31 * x[n:] + 16 * x[:n]])
    assert torch.equal(A.flat(x), want)
    assert cuda_spmv.diva_launches == before
    with pytest.raises(ValueError):
        cuda_spmv.DivaOperator(
            ell_stack_from_csr(mats[:1], dtype=torch.float64,
                               device="cpu").op, rows, *f)
    with pytest.raises(ValueError):
        cuda_spmv.DivaOperator(S.op, rows, f[0][:-1], *f[1:])
    with pytest.raises(TypeError):
        cuda_spmv.DivaOperator(S.op, rows, f[0].float(), *f[1:])
    with pytest.raises(TypeError):
        cuda_spmv.DivaOperator(S.op, rows, *f, round_x_bf16=True)
    with pytest.raises(ValueError):
        cuda_spmv.DivaRows(TriC[:-1], TriC > 0, ~z, z, z)
    with pytest.raises(TypeError):
        A.flat(x.float())
    with pytest.raises(ValueError):
        A.flat(x[:-1])
    with pytest.raises(ValueError):
        A((x[:n], x[n:-1]))


@pytest.fixture(scope="module")
def cold(env):
    """The fixture state before any stress-balance solve, on both sides,
    and each side's DIVA solve function."""
    Cj0, _ = configs(choice_stress_balance_approximation="none")
    rj = JaxRegion(Cj0, "ANT", mesh=env.mesh_j)
    sj = rj.state
    st = ice_state_from_numpy(state_to_numpy(sj), device="cpu",
                              dtype=torch.float64)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    c = Env()
    c.mdj, c.mdt, c.sj, c.st = rj.md, mdt, sj, st
    c.cdfs_j = rj._bedrock_cdfs
    c.cdfs_t = _build_bedrock_cdfs(env.Ct, env.mesh_t, "ANT", mdt)
    c.solve_j = jax.jit(j_make_solve(env.Cj, c.mdj, bedrock_cdfs=c.cdfs_j))
    c.solve_t = t_make_solve(env.Ct, c.mdt, bedrock_cdfs=c.cdfs_t)
    return c


def _solve_both(c, sj, st):
    oj = c.solve_j(c.mdj, sj.Hi, sj.Hs, sj.Hb, sj.SL, sj.Ti, sj)
    ot = c.solve_t(c.mdt, st.Hi, st.Hs, st.Hb, st.SL, st.Ti, st)
    return oj, ot


def _check_solve(oj, ot):
    assert ot[4] == int(oj[4]) > 0                       # n_visc_its
    assert abs(ot[5] - int(oj[5])) <= 0.02 * int(oj[5])  # n_Axb_its
    umax = max(np.abs(np.asarray(oj[0])).max(),
               np.abs(np.asarray(oj[1])).max())
    assert umax > 1.0                                    # m/yr: real flow
    for i in range(4):
        bj = np.asarray(oj[i])
        assert np.abs(ot[i].numpy() - bj).max() <= VEL_TOL * umax
    for k in ("visc_tau_bx", "visc_tau_by", "visc_eta_3D_b"):
        assert rel_gap(ot[6][k], np.asarray(oj[6][k])) <= VEL_TOL


def test_diva_solve_cold_then_warm(env, cold):
    """The whole viscosity iteration from zero velocity, then again from
    its own result (the warm-start carry): same iteration counts, same
    velocities, and the warm solve needs fewer Krylov iterations."""
    oj, ot = _solve_both(cold, cold.sj, cold.st)
    _check_solve(oj, ot)
    assert ot[2].shape == (env.mesh_t.nTri, env.Ct.nz)
    warm = lambda s, o: s.replace(u_vav_b=o[0], v_vav_b=o[1], u_3D_b=o[2],
                                  v_3D_b=o[3], **o[6])
    oj2, ot2 = _solve_both(cold, warm(cold.sj, oj), warm(cold.st, ot))
    _check_solve(oj2, ot2)
    assert ot2[5] < ot[5]


def test_ssa_solve_and_no_sliding(env, cold):
    Cj, Ct = configs(choice_stress_balance_approximation="SSA")
    sj, st = cold.sj, cold.st
    oj = jax.jit(j_make_solve(Cj, cold.mdj, bedrock_cdfs=cold.cdfs_j))(
        cold.mdj, sj.Hi, sj.Hs, sj.Hb, sj.SL, sj.Ti, sj)
    ot = t_make_solve(Ct, cold.mdt, bedrock_cdfs=cold.cdfs_t)(
        cold.mdt, st.Hi, st.Hs, st.Hb, st.SL, st.Ti, st)
    _check_solve(oj, ot)
    # SSA without sliding: zero velocity, no solve
    _, Cn = configs(choice_stress_balance_approximation="SSA",
                    choice_sliding_law="no_sliding")
    on = t_make_solve(Cn, cold.mdt, bedrock_cdfs=cold.cdfs_t)(
        cold.mdt, st.Hi, st.Hs, st.Hb, st.SL, st.Ti, st)
    assert on[4] == on[5] == 0
    assert float(on[0].abs().max()) == float(on[2].abs().max()) == 0.0


@pytest.mark.parametrize("over, exc, word", [
    (dict(choice_stress_balance_approximation="hybrid DIVA/BPA",
          choice_hybrid_DIVA_BPA_mask_ANT="ROI",
          choice_regions_of_interest="Atlantis"),
     ValueError, "Atlantis"),
    (dict(tpu_stress_balance_precond="ilu"), ValueError,
     "tpu_stress_balance_precond"),
    (dict(choice_stress_balance_approximation="hybrid DIVA/BPA",
          choice_hybrid_DIVA_BPA_mask_ANT="no_such_mask"), ValueError,
     "choice_hybrid_DIVA_BPA_mask_ANT"),
    (dict(BC_u_north="no_such_bc"), ValueError, "BC_u_north"),
])
def test_unported_choices_raise_by_name(env, over, exc, word):
    """What is not ported raises NotImplementedError, what does not exist
    ValueError, each naming the choice (the preconditioners, the
    ocean-pressure front, BPA and the hybrid DIVA/BPA are ported now:
    test_ported_choices_build; the hybrid's 'ROI' mask too, and an unknown
    region of interest raises by its name)."""
    _, Ct = configs(**over)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    with pytest.raises(exc, match=word):
        t_make_solve(Ct, mdt)


@pytest.mark.parametrize("over", [
    dict(tpu_stress_balance_precond="chebyshev"),
    dict(tpu_stress_balance_precond="neumann"),
    dict(tpu_stress_balance_precond="block_dense"),
    dict(tpu_stress_balance_precond="two_level"),
    dict(BC_ice_front="ocean_pressure"),
    dict(choice_stress_balance_approximation="BPA"),
    dict(choice_stress_balance_approximation="hybrid DIVA/BPA",
         choice_hybrid_DIVA_BPA_mask_ANT="read_from_file"),
], ids=["chebyshev", "neumann", "block_dense", "two_level",
        "ocean_pressure", "BPA", "hybrid DIVA/BPA"])
def test_ported_choices_build(env, over, tmp_path):
    """The choices that raised until the MISMIP+ slice (the preconditioners,
    the front) and until the BPA slice (BPA, the hybrid with a mask read
    from a file) build a solver, and the preconditioners their tables."""
    if over.get("choice_hybrid_DIVA_BPA_mask_ANT") == "read_from_file":
        from ufemism2_tpu_torch.io.ncio import NCFile
        x = np.linspace(-1000e3, 1000e3, 5)
        path = str(tmp_path / "mask_BPA.nc")
        with NCFile(path, "w") as nc:
            nc.def_dim("x", 5)
            nc.def_dim("y", 5)
            for name, dims, data in (("x", ("x",), x), ("y", ("y",), x),
                                     ("mask_BPA", ("y", "x"),
                                      (x[None, :] > 0) * np.ones((5, 1)))):
                nc.def_var(name, dims)
                nc.put(name, data)
        over = dict(over, filename_hybrid_DIVA_BPA_mask_ANT=path)
    _, Ct = configs(**over)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    assert callable(t_make_solve(Ct, mdt))
    kind = over.get("tpu_stress_balance_precond")
    assert ("bjd_vals" in mdt.extras) == (kind == "block_dense")
    assert ("c2_bcol" in mdt.extras) == (kind == "two_level")
    approx = over.get("choice_stress_balance_approximation")
    assert ("bpa_rows" in mdt.extras) == (approx in ("BPA",
                                                     "hybrid DIVA/BPA"))
