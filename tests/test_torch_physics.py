"""Leaf physics of the port against the JAX package on the fixture mesh
with seeded fields, in f64.

Tolerance 1e-12 relative (of the field's largest value): both sides run
the same f64 arithmetic and differ only in summation order and in the
last bit of pow/exp/erf; boolean and integer masks must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (configs, build_meshes, bedrock_cdfs_numpy,
                                ell_to_dense, rel_gap)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import (geometry as jgeo, masks as jmasks,
                                   subgrid as jsub, rheology as jrheo,
                                   hydrology as jhyd, sliding as jslid,
                                   mass as jmass, safeties as jsafe)
from ufemism2_tpu.core.ice.ssadiva import \
    _bed_roughness_fields as j_bed_roughness
from ufemism2_tpu.mesh import zeta as jzeta

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import (geometry as tgeo, masks as tmasks,
                                         subgrid as tsub, rheology as trheo,
                                         hydrology as thyd, sliding as tslid,
                                         mass as tmass, safeties as tsafe)
from ufemism2_tpu_torch.core.ice.ssadiva import \
    _bed_roughness_fields as t_bed_roughness
from ufemism2_tpu_torch.mesh import zeta as tzeta

TOL = 1e-12


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs()
    e.mesh_j, e.mesh_t = build_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    V = e.mesh_j.V
    nV, nTri, nz = e.mesh_j.nV, e.mesh_j.nTri, e.mesh_j.nz
    rng = np.random.default_rng(42)
    r = np.hypot(V[:, 0], V[:, 1])
    # a dome with a floating fringe and an open-ocean rim: every mask
    # type occurs
    Hb = 400.0 - 1.6e-3 * r + 60.0 * rng.standard_normal(nV)
    Hi = np.maximum(0.0, 1800.0 * (1.0 - (r / 820e3) ** 2)
                    + 40.0 * rng.standard_normal(nV))
    Hi[r > 820e3] = 0.0
    SL = np.zeros(nV)
    e.np = dict(
        Hi=Hi, Hb=Hb, SL=SL,
        u_b=300.0 * rng.standard_normal(nTri),
        v_b=300.0 * rng.standard_normal(nTri),
        u_a=200.0 * rng.standard_normal(nV),
        v_a=200.0 * rng.standard_normal(nV),
        SMB=0.3 + 0.1 * rng.standard_normal(nV),
        BMB=-0.5 * rng.random(nV),
        LMB=-0.1 * rng.random(nV),
        Ti=250.0 + 20.0 * rng.random((nV, nz)),
        f3=1.0 + rng.random((nV, nz)),
        dHb=5.0 * rng.standard_normal(nV),
        x_a3=rng.standard_normal((nV, 3)),
        x_b3=rng.standard_normal((nTri, 3)),
    )
    e.j = {k: jnp.asarray(v) for k, v in e.np.items()}
    e.t = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in e.np.items()}
    e.cdf_a, e.cdf_b = bedrock_cdfs_numpy(e.mesh_j)
    border_b = (e.mesh_j.TriC < 0).any(axis=1)
    e.cdfs_j = (jnp.asarray(e.cdf_a), jnp.asarray(e.cdf_b),
                jnp.asarray(border_b))
    e.cdfs_t = (torch.from_numpy(e.cdf_a), torch.from_numpy(e.cdf_b),
                torch.from_numpy(border_b))
    e.masks_j = jmasks.determine_masks(e.mdj, e.j["Hi"], e.j["Hb"], e.j["SL"])
    e.masks_t = tmasks.determine_masks(e.mdt, e.t["Hi"], e.t["Hb"], e.t["SL"])
    # The first float64 torch.exp of a process that has also loaded JAX was
    # seen to come out only ~3e-9 accurate in about one process in six on
    # an AVX-512 host (every later call agrees with numpy to the last bit),
    # so that call is spent here and not inside a comparison.
    torch.exp(-30.0 * torch.rand(nV * nz, dtype=torch.float64))
    return e


def _same(a_t, a_j, tol=TOL):
    a_j = np.asarray(a_j)
    if a_j.dtype == np.bool_ or np.issubdtype(a_j.dtype, np.integer):
        assert np.array_equal(a_t.numpy(), a_j)
    else:
        assert a_t.dtype == torch.float64
        assert rel_gap(a_t, a_j) <= tol, rel_gap(a_t, a_j)


def test_mesh_data_fields_match(env):
    """build_mesh_data: every field of the JAX MeshData has its
    counterpart with the same values; halo fields stay None."""
    import dataclasses
    for f in dataclasses.fields(env.mdj):
        vj, vt = getattr(env.mdj, f.name), getattr(env.mdt, f.name)
        if f.name.startswith("halo_"):
            assert vt is None
        elif f.name == "extras":
            assert vt == {}
        elif f.name == "M2_stack":
            assert vj is None and vt.n_ops == 5     # set in f64 too
        elif f.name.startswith("M"):
            dense_j = np.zeros((vj.n_rows, vj.n_cols))
            np.add.at(dense_j, (np.arange(vj.n_rows)[:, None],
                                np.asarray(vj.inds)), np.asarray(vj.vals))
            assert np.array_equal(ell_to_dense(vt), dense_j)
        else:
            _same(vt, vj, tol=0.0)
    assert env.mdt._host_mesh is env.mesh_t
    assert (env.mdt.nV, env.mdt.nTri, env.mdt.nE, env.mdt.nz) == \
        (env.mdj.nV, env.mdj.nTri, env.mdj.nE, env.mdj.nz)


def test_gather_neighbours_and_map_b_to_c(env):
    for k in ("Hi", "x_a3"):
        _same(tmd.gather_neighbours(env.mdt, env.t[k]),
              jmd.gather_neighbours(env.mdj, env.j[k]))
    for k in ("u_b", "x_b3"):
        _same(tmd.map_b_to_c(env.mdt, env.t[k]),
              jmd.map_b_to_c(env.mdj, env.j[k]))


@pytest.mark.parametrize("fn", ["ice_surface_elevation",
                                "thickness_above_flotation",
                                "height_of_water_column_at_ice_front"])
def test_geometry(env, fn):
    _same(getattr(tgeo, fn)(env.t["Hi"], env.t["Hb"], env.t["SL"]),
          getattr(jgeo, fn)(env.j["Hi"], env.j["Hb"], env.j["SL"]))


def test_geometry_Hi_from_Hs(env):
    Hs_j = jgeo.ice_surface_elevation(env.j["Hi"], env.j["Hb"], env.j["SL"])
    Hs_t = torch.from_numpy(np.asarray(Hs_j))
    _same(tgeo.Hi_from_Hb_Hs_and_SL(env.t["Hb"], Hs_t, env.t["SL"]),
          jgeo.Hi_from_Hb_Hs_and_SL(env.j["Hb"], Hs_j, env.j["SL"]))


def test_masks(env):
    assert set(env.masks_t) == set(env.masks_j)
    for k in env.masks_j:
        _same(env.masks_t[k], env.masks_j[k])
    # the seeded geometry exercises every mask type
    for k in ("mask_grounded_ice", "mask_floating_ice", "mask_gl_gr",
              "mask_gl_fl", "mask_cf_fl", "mask_icefree_ocean",
              "mask_margin"):
        assert bool(env.masks_t[k].any()), k
    _same(tmasks.is_floating(env.t["Hi"], env.t["Hb"], env.t["SL"]),
          jmasks.is_floating(env.j["Hi"], env.j["Hb"], env.j["SL"]))
    for choice in ("none", "MISMIP_mod", "MISMIP+", "Thule"):
        _same(tmasks.calc_mask_noice(env.mdt, choice),
              jmasks.calc_mask_noice(env.mdj, choice))


def test_subgrid_effective_thickness(env):
    a = tsub.calc_effective_thickness(env.mdt, env.t["Hi"], env.t["Hb"],
                                      env.t["SL"])
    b = jsub.calc_effective_thickness(env.mdj, env.j["Hi"], env.j["Hb"],
                                      env.j["SL"])
    _same(a[0], b[0])
    _same(a[1], b[1])


def test_subgrid_bilin_TAF(env):
    fa_t = tsub.calc_grounded_fractions_bilin_TAF(
        env.mdt, env.t["Hi"], env.t["Hb"], env.t["SL"],
        env.masks_t["mask_floating_ice"])
    fa_j = jsub.calc_grounded_fractions_bilin_TAF(
        env.mdj, env.j["Hi"], env.j["Hb"], env.j["SL"],
        env.masks_j["mask_floating_ice"])
    _same(fa_t, fa_j)
    assert 0.0 < float(fa_t.mean()) < 1.0
    _same(tsub.calc_grounded_fractions_b_from_a(env.mdt, env.mdt.Tri, fa_t),
          jsub.calc_grounded_fractions_b_from_a(env.mdj, env.mdj.Tri, fa_j))


def test_subgrid_bedrock_cdf(env):
    _same(tsub.calc_grounded_fractions_bedrock_cdf(
        env.t["Hi"], env.t["SL"], env.t["dHb"], env.cdfs_t[0]),
        jsub.calc_grounded_fractions_bedrock_cdf(
        env.j["Hi"], env.j["SL"], env.j["dHb"], env.cdfs_j[0]))


@pytest.mark.parametrize("choice", ["bilin_interp_TAF", "bedrock_CDF",
                                    "bilin_interp_TAF+bedrock_CDF"])
def test_subgrid_grounded_fractions_dispatch(env, choice):
    Cj, Ct = configs(choice_subgrid_grounded_fraction=choice)
    a = tsub.calc_grounded_fractions(
        Ct, env.mdt, env.t["Hi"], env.t["Hb"], env.t["SL"],
        env.masks_t["mask_floating_ice"], dHb=env.t["dHb"],
        bedrock_cdfs=env.cdfs_t)
    b = jsub.calc_grounded_fractions(
        Cj, env.mdj, env.j["Hi"], env.j["Hb"], env.j["SL"],
        env.masks_j["mask_floating_ice"], dHb=env.j["dHb"],
        bedrock_cdfs=env.cdfs_j)
    _same(a[0], b[0])
    _same(a[1], b[1])


@pytest.mark.parametrize("choice", ["uniform", "Huybrechts1992"])
def test_rheology(env, choice):
    Cj, Ct = configs(choice_ice_rheology_Glen=choice)
    Hs_t = tgeo.ice_surface_elevation(env.t["Hi"], env.t["Hb"], env.t["SL"])
    Hs_j = jgeo.ice_surface_elevation(env.j["Hi"], env.j["Hb"], env.j["SL"])
    _same(trheo.calc_ice_rheology_glen(
        Ct, env.mdt, env.t["Hi"], Hs_t, env.t["Ti"],
        env.masks_t["mask_grounded_ice"], env.masks_t["mask_floating_ice"]),
        jrheo.calc_ice_rheology_glen(
        Cj, env.mdj, env.j["Hi"], Hs_j, env.j["Ti"],
        env.masks_j["mask_grounded_ice"], env.masks_j["mask_floating_ice"]))


@pytest.mark.parametrize("choice", ["none", "Martin2011", "Leguy2014",
                                    "error_function_Martin2011",
                                    "error_function_constant"])
def test_hydrology(env, choice):
    Cj, Ct = configs(choice_basal_hydrology_model=choice)
    a = thyd.run_basal_hydrology(Ct, env.t["Hi"], env.t["Hb"], env.t["SL"],
                                 env.masks_t["mask_grounded_ice"])
    b = jhyd.run_basal_hydrology(Cj, env.j["Hi"], env.j["Hb"], env.j["SL"],
                                 env.masks_j["mask_grounded_ice"])
    for x, y in zip(a, b):
        _same(x, y)


def _friction(env, Cj, Ct):
    Hs_j = jgeo.ice_surface_elevation(env.j["Hi"], env.j["Hb"], env.j["SL"])
    slope_j = jnp.sqrt((env.mdj.M_ddx_a_a @ Hs_j) ** 2
                       + (env.mdj.M_ddy_a_a @ Hs_j) ** 2)
    slope_t = torch.from_numpy(np.asarray(slope_j))
    fg_j = jsub.calc_grounded_fractions_bilin_TAF(
        env.mdj, env.j["Hi"], env.j["Hb"], env.j["SL"], None)
    fg_t = torch.from_numpy(np.asarray(fg_j))
    he_j, _ = jsub.calc_effective_thickness(env.mdj, env.j["Hi"],
                                            env.j["Hb"], env.j["SL"])
    he_t = torch.from_numpy(np.asarray(he_j))
    rough_t = t_bed_roughness(Ct, env.mdt, torch.zeros(env.mdt.nV,
                                                       dtype=torch.float64))
    rough_j = j_bed_roughness(Cj, env.mdj, jnp.zeros(env.mdj.nV))
    for k in rough_j:
        _same(rough_t[k], rough_j[k])
    bt = tslid.calc_basal_friction_coefficient(
        Ct, env.mdt, rough_t, env.t["u_a"], env.t["v_a"], env.t["Hi"], he_t,
        env.t["Hb"], env.t["SL"], slope_t, fg_t, env.masks_t)
    bj = jslid.calc_basal_friction_coefficient(
        Cj, env.mdj, rough_j, env.j["u_a"], env.j["v_a"], env.j["Hi"], he_j,
        env.j["Hb"], env.j["SL"], slope_j, fg_j, env.masks_j)
    return bt, bj


def test_sliding_zoet_iverson(env):
    assert env.Ct.choice_sliding_law == "Zoet-Iverson"
    bt, bj = _friction(env, env.Cj, env.Ct)
    _same(bt, bj)
    assert float(bt.max()) > 0.0


def test_sliding_no_sliding_and_unported_laws(env):
    """no_sliding, and the laws ported since the first slice (each of them
    in all its variants: tests/test_torch_sliding.py): set-up accepts
    them and they give the reference's friction."""
    Cj, Ct = configs(choice_sliding_law="no_sliding")
    bt, bj = _friction(env, Cj, Ct)
    _same(bt, bj)
    for law in ("Weertman", "Coulomb", "Budd", "Tsai2015"):
        Cj, Cl = configs(choice_sliding_law=law)
        tslid.register_sliding_static(Cl, env.mesh_t, env.mdt)
        bt, bj = _friction(env, Cj, Cl)
        _same(bt, bj)


def test_zeta_integrals(env):
    zj, zt = env.mdj.zeta, env.mdt.zeta
    _same(zt, zj, tol=0.0)
    _same(tzeta.vertical_average(zt, env.t["f3"]),
          jzeta.vertical_average(zj, env.j["f3"]))
    _same(tzeta.integrate_from_base_up(zt.expand(env.t["f3"].shape),
                                       env.t["f3"]),
          jzeta.integrate_from_base_up(
              jnp.broadcast_to(zj, env.j["f3"].shape), env.j["f3"]))
    for choice, nz in (("regular", 12), ("irregular_log", 12),
                       ("old_15_layer_zeta", 15)):
        for a, b in zip(tzeta.setup_zeta_grid(choice, nz),
                        jzeta.setup_zeta_grid(choice, nz)):
            assert np.array_equal(a, b)


def _fm(env):
    _, fm_j = jsub.calc_effective_thickness(env.mdj, env.j["Hi"],
                                            env.j["Hb"], env.j["SL"])
    return torch.from_numpy(np.asarray(fm_j)), fm_j


def test_divQ_operator(env):
    fm_t, fm_j = _fm(env)
    at, up_t, dg_t = tmass.make_divQ_operator(env.mdt, env.t["u_b"],
                                              env.t["v_b"], fm_t)
    aj, up_j, dg_j = jmass.make_divQ_operator(env.mdj, env.j["u_b"],
                                              env.j["v_b"], fm_j)
    _same(up_t, up_j)
    _same(dg_t, dg_j)
    _same(at(env.t["Hi"]), aj(env.j["Hi"]))
    _same(tmass.calc_divQ_upwind(env.mdt, env.t["Hi"], env.t["u_b"],
                                 env.t["v_b"], fm_t),
          jmass.calc_divQ_upwind(env.mdj, env.j["Hi"], env.j["u_b"],
                                 env.j["v_b"], fm_j))


def test_critical_timestep(env):
    dt_t = tmass.calc_critical_timestep_adv(
        env.Ct, env.mdt, env.t["Hi"], env.masks_t["mask_floating_ice"],
        env.t["u_b"], env.t["v_b"])
    dt_j = float(jmass.calc_critical_timestep_adv(
        env.Cj, env.mdj, env.j["Hi"], env.masks_j["mask_floating_ice"],
        env.j["u_b"], env.j["v_b"]))
    assert isinstance(dt_t, float)
    assert abs(dt_t - dt_j) <= TOL * dt_j


@pytest.mark.parametrize("method", ["explicit", "semi-implicit", "none"])
@pytest.mark.parametrize("bc", ["zero", "infinite"])
def test_calc_dHi_dt(env, method, bc):
    over = dict(choice_ice_integration_method=method, BC_H_north=bc,
                BC_H_south=bc)
    Cj, Ct = configs(**over)
    fm_t, fm_j = _fm(env)
    noice_t = tmasks.calc_mask_noice(env.mdt, "MISMIP_mod")
    noice_j = jmasks.calc_mask_noice(env.mdj, "MISMIP_mod")
    zt, zj = torch.zeros_like(env.t["Hi"]), jnp.zeros_like(env.j["Hi"])
    dt = 0.37
    # velocities small enough for the explicit scheme at this dt
    rt = tmass.calc_dHi_dt(Ct, env.mdt, env.t["Hi"], env.t["Hb"],
                           env.t["SL"], env.t["u_b"], env.t["v_b"],
                           env.t["SMB"], env.t["BMB"], env.t["LMB"], None,
                           fm_t, noice_t, dt, zt)
    rj = jmass.calc_dHi_dt(Cj, env.mdj, env.j["Hi"], env.j["Hb"],
                           env.j["SL"], env.j["u_b"], env.j["v_b"],
                           env.j["SMB"], env.j["BMB"], env.j["LMB"], None,
                           fm_j, noice_j, jnp.asarray(dt), zj)
    # the semi-implicit result carries the BiCGSTAB residual
    # (dHi_PETSc_rtol 1e-8 of ||b||): two converged solves with different
    # summation order agree to that, not to rounding
    tol = 1e-7 if method == "semi-implicit" else TOL
    for a, b in zip(rt[:3], rj[:3]):
        _same(a, b, tol=tol)
    assert rt[3] == int(rj[3])
    if method == "semi-implicit":
        assert rt[3] > 0


def test_alter_ice_thickness_and_spill_over(env):
    Cj, Ct = configs(fixiness_t_start=0.0, fixiness_t_end=100.0,
                     fixiness_H_grounded=0.5, limitness_t_start=0.0,
                     limitness_t_end=100.0, limitness_H_grounded=50.0,
                     limitness_H_floating=20.0)
    rng = np.random.default_rng(3)
    Hi_new = np.maximum(0.0, env.np["Hi"] + 30.0 * rng.standard_normal(
        env.mesh_j.nV))
    ref_Hi = np.maximum(0.0, env.np["Hi"] - 10.0)
    args_t = [torch.from_numpy(a) for a in (Hi_new, ref_Hi, env.np["Hb"])]
    args_j = [jnp.asarray(a) for a in (Hi_new, ref_Hi, env.np["Hb"])]
    for C_j, C_t, time in ((env.Cj, env.Ct, 5.0), (Cj, Ct, 30.0)):
        ht = tsafe.alter_ice_thickness(
            C_t, env.mdt, env.masks_t, env.t["Hi"], env.t["Hb"], env.t["SL"],
            args_t[0], args_t[1], args_t[2], time)
        hj = jsafe.alter_ice_thickness(
            C_j, env.mdj, env.masks_j, env.j["Hi"], env.j["Hb"], env.j["SL"],
            args_j[0], args_j[1], args_j[2], jnp.asarray(time))
        _same(ht, hj)
    fm_t, fm_j = _fm(env)
    _, up_t, _ = tmass.make_divQ_operator(env.mdt, env.t["u_b"],
                                          env.t["v_b"], fm_t)
    _, up_j, _ = jmass.make_divQ_operator(env.mdj, env.j["u_b"],
                                          env.j["v_b"], fm_j)
    he_j, _ = jsub.calc_effective_thickness(env.mdj, env.j["Hi"],
                                            env.j["Hb"], env.j["SL"])
    st = tsafe.calc_and_apply_spill_over_flux(
        env.Ct, env.mdt, env.masks_t, torch.from_numpy(np.asarray(he_j)),
        up_t, args_t[0], 0.5)
    sj = jsafe.calc_and_apply_spill_over_flux(
        env.Cj, env.mdj, env.masks_j, he_j, up_j, args_j[0], 0.5)
    _same(st[0], sj[0])
    _same(st[1], sj[1])
    assert float(st[1].abs().max()) > 0.0
