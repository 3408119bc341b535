"""The ocean-pressure calving front and the preconditioners of the port
against the JAX package on the 40 km MISMIP+ mesh with a carved front
(the ice removed beyond x = 400 km, as tests/test_ocean_pressure_bc.py
carves it): the per-solve front data, the operator with front rows (the
plain version of the kernel diva_apply), the front branch of the 2x2
block-Jacobi, and the dense block-Jacobi and two-level preconditioners
with and without a front, on seeded fields.

Tolerances: f64 1e-12 of the largest value (the same arithmetic, summation
order apart; measured below 1e-14, the two-level coarse inverse 1e-13).
f32: both sides round the operand of a physics matvec to bfloat16, but the
JAX package's f32 coefficients are a bf16 (hi, lo) pair, exact to 2^-17
(7.6e-6) relative, the port's plain f32. A row of the operator sums about
ten such products, some of which cancel: 1e-5 (measured 1.5e-6). The back
pressure 0.5 g (rho_i Hi_b^2 - rho_sw Ho_b^2) of floating ice keeps a
tenth of each term (1 - rho_i / rho_sw), so the coefficient error of the
map Ho_a -> Ho_b grows tenfold there: 2e-4 (measured 8e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import mismipplus_configs, build_meshes_for, rel_gap

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.idealised_geometries import calc_idealised_geometry
from ufemism2_tpu.core.ice import ssadiva as jss
from ufemism2_tpu.utils.constants import (ice_density, grav,
                                          seawater_density)

from ufemism2_tpu_torch.convert import extra_tables_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import ssadiva as tss
from ufemism2_tpu_torch.ops import cuda_spmv

TOL = {"f64": 1e-12, "f32": 1e-5}
TAU_TOL = {"f64": 1e-12, "f32": 2e-4}
X_FRONT = 400e3


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = mismipplus_configs()
    e.mesh_j, e.mesh_t = build_meshes_for(e.Cj)
    V = e.mesh_j.V
    Hi, Hb, _, _ = calc_idealised_geometry(V[:, 0], V[:, 1], "MISMIP+", e.Cj)
    Hi = np.where(V[:, 0] > X_FRONT, 0.0, np.where(Hi < 2.0, 0.0, Hi))
    rng = np.random.default_rng(17)
    nTri = e.mesh_j.nTri
    e.geo = dict(Hi=Hi * (1.0 + 0.3 * rng.random(len(Hi))), Hb=Hb,
                 SL=np.zeros(len(Hi)))
    e.fields = dict(N=1e9 * (1.0 + rng.random(nTri)),
                    dNx=1e4 * rng.standard_normal(nTri),
                    dNy=1e4 * rng.standard_normal(nTri),
                    beta=1e3 * rng.random(nTri),
                    u=300.0 * rng.standard_normal(nTri),
                    v=300.0 * rng.standard_normal(nTri))
    e.md = {}
    return e


def _mds(env, prec):
    """Both packages' MeshData in `prec` with the SSA/DIVA tables and both
    preconditioners' tables registered (built once per precision)."""
    if prec not in env.md:
        jd, td = ((jnp.float64, torch.float64) if prec == "f64"
                  else (jnp.float32, torch.float32))
        mdj = jmd.build_mesh_data(env.mesh_j,
                                  dtype=None if prec == "f64" else jd)
        mdt = tmd.build_mesh_data(env.mesh_t, dtype=td, device="cpu")
        jss.register_ssadiva_static(env.Cj, env.mesh_j, mdj)
        tss.register_ssadiva_static(env.Ct, env.mesh_t, mdt)
        for reg in ("register_bjdense_static", "register_two_level_static"):
            getattr(jss, reg)(env.mesh_j, mdj)
            getattr(tss, reg)(env.mesh_t, mdt)
        env.md[prec] = (mdj, mdt, jd, td)
    return env.md[prec]


def _front_jax(mdj, Hi, Hb, SL):
    """The JAX package's per-solve front data, as its solve computes it
    (ufemism2_tpu/core/ice/ssadiva.py:700-735)."""
    Hi_b = mdj.M_map_a_b.exact_matvec(Hi)
    ice_a = mdj.ext_V(Hi > 0.1)
    ice_b = ice_a[mdj.Tri].any(axis=1)
    ice_nbr = mdj.ext_Tri(ice_b)[mdj.TriC]
    noice_nbr = (~ice_nbr) & mdj.mask_TriC
    is_front = ice_b & noice_nbr.any(axis=1)
    off = ~ice_b
    gc_nbr = mdj.ext_Tri(mdj.TriGC)[mdj.TriC]
    d = jnp.where(noice_nbr[:, :, None],
                  gc_nbr - mdj.TriGC[:, None, :], 0.0).sum(axis=1)
    d_len = jnp.sqrt((d ** 2).sum(axis=1))
    nhat = d / jnp.maximum(d_len, 1e-30)[:, None]
    n_x, n_y = nhat[:, 0], nhat[:, 1]
    Ho_a = jnp.minimum(jnp.maximum(SL - Hb, 0.0),
                       ice_density / seawater_density * Hi)
    Ho_b = mdj.M_map_a_b @ Ho_a
    tau_mag = (0.5 * ice_density * grav * Hi_b ** 2
               - 0.5 * seawater_density * grav * Ho_b ** 2)
    return (is_front, off, n_x, n_y, tau_mag * n_x, tau_mag * n_y)


def _fronts(env, prec):
    mdj, mdt, jd, td = _mds(env, prec)
    gj = {k: jnp.asarray(v, jd) for k, v in env.geo.items()}
    gt = {k: torch.as_tensor(v, dtype=td) for k, v in env.geo.items()}
    fj = _front_jax(mdj, gj["Hi"], gj["Hb"], gj["SL"])
    Hi_b = mdt.M_map_a_b.exact_matvec(gt["Hi"])
    ft = tss.calc_front(mdt, gt["Hi"], gt["Hb"], gt["SL"], Hi_b)
    return fj, ft


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_front_data_matches_jax(env, prec):
    fj, ft = _fronts(env, prec)
    assert np.array_equal(ft.is_front.numpy(), np.asarray(fj[0]))
    assert np.array_equal(ft.off.numpy(), np.asarray(fj[1]))
    for a, b in zip(ft[2:4], fj[2:4]):
        assert rel_gap(a, np.asarray(b)) <= TOL[prec]
    for a, b in zip(ft[4:], fj[4:]):
        assert rel_gap(a, np.asarray(b)) <= TAU_TOL[prec]
    # a front at the carved edge, unit outward normals pointing downstream
    front = ft.is_front.numpy()
    gc_x = env.mesh_t.TriGC[:, 0]
    assert front.any() and ft.off.numpy().any()
    assert (np.abs(gc_x[front] - X_FRONT) < 100e3).all()
    n = np.hypot(ft.n_x.double().numpy(), ft.n_y.double().numpy())
    assert np.allclose(n[front], 1.0, atol=1e-6)
    assert (ft.n_x.numpy()[front] > 0).mean() > 0.5
    assert not (front & ft.off.numpy()).any()


def _operands(env, prec):
    mdj, mdt, jd, td = _mds(env, prec)
    J = {k: jnp.asarray(a, jd) for k, a in env.fields.items()}
    T = {k: torch.as_tensor(a, dtype=td) for k, a in env.fields.items()}
    return mdj, mdt, J, T


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_front_operator_matches_jax(env, prec):
    """make_A with the front rows: the JAX package's against the port's
    (diva_apply_plain), both call forms; off rows copy the unrounded
    operand; the kernel's row codes say what the masks say."""
    mdj, mdt, J, T = _operands(env, prec)
    fj, ft = _fronts(env, prec)
    args = ("N", "dNx", "dNy", "beta")
    yj = jss.make_A(mdj, *(J[k] for k in args), front=fj[:4])(
        (J["u"], J["v"]))
    A = tss.make_A(mdt, *(T[k] for k in args), front=ft)
    yt = A((T["u"], T["v"]))
    for a, b in zip(yt, yj):
        assert a.dtype == T["u"].dtype
        assert rel_gap(a, np.asarray(b)) <= TOL[prec]
    assert torch.equal(A.flat(torch.cat([T["u"], T["v"]])), torch.cat(yt))
    off, front = ft.off, ft.is_front
    assert torch.equal(yt[0][off], T["u"][off])
    assert torch.equal(yt[1][off], T["v"][off])
    # the front rows are the Neumann rows, not the PDE rows
    y0 = tss.make_A(mdt, *(T[k] for k in args))((T["u"], T["v"]))
    assert not torch.equal(yt[0][front], y0[0][front])
    code = A.code.numpy()
    assert np.array_equal((code & cuda_spmv.ROW_OFF) != 0, off.numpy())
    assert np.array_equal((code & cuda_spmv.ROW_FRONT) != 0, front.numpy())
    assert np.array_equal(code & 7, mdt.x("ssa_diva_rows").code.numpy())


def test_front_operator_on_constant_velocity(env):
    """For a constant (u, v) every derivative vanishes: front rows give 0
    (the operator's Neumann rows balance the back pressure alone)."""
    mdj, mdt, J, T = _operands(env, "f64")
    _, ft = _fronts(env, "f64")
    ones = torch.ones_like(T["u"])
    args = ("N", "dNx", "dNy", "beta")
    yu, yv = tss.make_A(mdt, *(T[k] for k in args), front=ft)(
        (3.0 * ones, -2.0 * ones))
    f = ft.is_front
    assert float(yu[f].abs().max()) < 1e-6 * float(T["N"].max())
    assert float(yv[f].abs().max()) < 1e-6 * float(T["N"].max())


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_front_block_jacobi_matches_jax(env, prec):
    mdj, mdt, J, T = _operands(env, prec)
    fj, ft = _fronts(env, prec)
    args = ("N", "dNx", "dNy", "beta")
    zj = jss.make_precond(mdj, *(J[k] for k in args), front=fj[:4])(
        (J["u"], J["v"]))
    zt = tss.make_precond(mdt, *(T[k] for k in args), front=ft)(
        (T["u"], T["v"]))
    for a, b in zip(zt, zj):
        assert rel_gap(a, np.asarray(b)) <= TOL[prec]
    # off rows: the identity
    assert torch.equal(zt[0][ft.off], T["u"][ft.off])


@pytest.mark.parametrize("front", [False, True])
@pytest.mark.parametrize("kind", ["block_dense", "two_level"])
def test_dense_and_two_level_match_jax(env, kind, front):
    """One application of the dense block-Jacobi and of the two-level
    preconditioner, with and without a front, in f64."""
    mdj, mdt, J, T = _operands(env, "f64")
    fj, ft = _fronts(env, "f64")
    args = ("N", "dNx", "dNy", "beta")
    mk = {"block_dense": "make_precond_dense",
          "two_level": "make_precond_two_level"}[kind]
    Mj = getattr(jss, mk)(mdj, *(J[k] for k in args),
                          front=fj[:4] if front else None)
    fields = tuple(T[k] for k in args)
    ft = ft if front else None
    A = tss.make_A(mdt, *fields, front=ft)
    Mt = tss.make_preconditioner(kind, mdt, A, fields, ft)
    zj = Mj((J["u"], J["v"]))
    zt = Mt((T["u"], T["v"]))
    for a, b in zip(zt, zj):
        assert a.dtype == torch.float64 and bool(torch.isfinite(a).all())
        assert rel_gap(a, np.asarray(b)) <= TOL["f64"]
    # a better preconditioner than the 2x2 block-Jacobi: on the operator's
    # own image it comes closer to the identity
    Mbj = tss.make_preconditioner("block_jacobi", mdt, A, fields, ft)
    x = (T["u"], T["v"])
    Ax = A(x)

    def err(M):
        z = M(Ax)
        return float(torch.sqrt(sum(((a - b) ** 2).sum()
                                    for a, b in zip(z, x))))
    assert np.isfinite(err(Mt)) and err(Mt) < 10.0 * err(Mbj)


def test_static_tables_match_jax(env):
    """The dense block-Jacobi and two-level tables the port builds are the
    JAX package's, carried in through the converter too."""
    mdj, mdt, _, _ = _mds(env, "f64")
    names = ("bjd_vals", "bjd_rows", "bjd_base", "bjd_diag",
             "bjd_row_valid", "c2_blk", "c2_bcol", "c2_vals5", "c2_valid")
    tables = {k: (np.asarray(mdj.extras[k].arr), mdj.extras[k].row)
              for k in names}
    fresh = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64,
                                device="cpu")
    extra_tables_from_numpy(fresh, tables)
    for k in names:
        a, b = mdt.x(k), fresh.x(k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
        assert mdt.extras[k].row == mdj.extras[k].row
    assert fresh.x("bjd_rows").dtype == torch.int64
    assert fresh.x("c2_valid").dtype == torch.bool
