"""The port's thermodynamics against the JAX package on the fixture mesh:
each function of core/ice/thermodynamics.py and ops/tridiag.py on seeded
fields, and the heat solve (the plain version of the `heat_columns`
kernel) in f64 and f32. The region with thermodynamics on is in
tests/test_torch_thermo_region.py.

Tolerances, relative to the field's largest value, beside the gaps
measured on this fixture:
- f64 functions 1e-12: the same arithmetic on both sides, summation order
  and the last bit of exp/erf/pow apart (measured 0 to 3.1e-15; the heat
  solve 8.3e-16).
- the heat solve in f32 (f64 systems formed from f32 fields) 1e-7: the
  Robin profile takes float32 erf and sqrt, whose last bit differs between
  the two libraries (measured 1.35e-8)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (configs, build_meshes, state_to_numpy,
                                rel_gap, write_nc_pair)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import thermodynamics as jth
from ufemism2_tpu.core.ice.masks import determine_masks as j_masks
from ufemism2_tpu.core.ice.state import init_ice_state as j_init_state
from ufemism2_tpu.ops import tridiag as jtri

from ufemism2_tpu_torch.convert import ice_state_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import thermodynamics as tth
from ufemism2_tpu_torch.ops import cuda_heat
from ufemism2_tpu_torch.ops import tridiag as ttri

TOL = 1e-12
F32_SOLVE_TOL = 1e-7
THERMO = dict(choice_thermo_model="3D_heat_equation",
              choice_ice_rheology_Glen="Huybrechts1992",
              choice_initial_ice_temperature_ANT="Robin",
              dt_thermodynamics=0.1)


class Env:
    pass


def _fields(mesh, rng):
    """Seeded physical fields on the fixture mesh: a dome with a floating
    fringe and an open-ocean rim, temperatures below the melting point,
    3-D velocities of a few hundred m/yr."""
    V = mesh.V
    nV, nTri, nz = mesh.nV, mesh.nTri, mesh.nz
    r = np.hypot(V[:, 0], V[:, 1])
    Hb = 400.0 - 1.6e-3 * r + 60.0 * rng.standard_normal(nV)
    Hi = np.maximum(0.0, 1800.0 * (1.0 - (r / 820e3) ** 2)
                    + 40.0 * rng.standard_normal(nV))
    Hi[r > 820e3] = 0.0
    Hi[rng.random(nV) < 0.05] = 5.0          # thin-ice columns
    shear = np.linspace(0.2, 1.0, nz)[None, :]
    return dict(
        Hi=Hi, Hb=Hb, SL=np.zeros(nV),
        Ti=240.0 + 25.0 * rng.random((nV, nz)),
        u_3D_b=shear * 200.0 * rng.standard_normal((nTri, 1)),
        v_3D_b=shear * 200.0 * rng.standard_normal((nTri, 1)),
        dHi_dt=0.3 * rng.standard_normal(nV),
        SMB=0.3 + 0.2 * rng.standard_normal(nV),
        BMB=-0.5 * rng.random(nV),
        A_flow=1e-17 * (1.0 + rng.random((nV, nz))),
        beta=1e3 * rng.random(nV),
        T_surf=230.0 + 40.0 * rng.random(nV),
        fraction_gr=rng.random(nV),
    )


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs(**THERMO)
    e.mesh_j, e.mesh_t = build_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    jth.register_thermo_static(e.mdj)
    tth.register_thermo_static(e.mdt)
    e.np = _fields(e.mesh_j, np.random.default_rng(11))
    e.j = {k: jnp.asarray(v) for k, v in e.np.items()}
    e.t = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in e.np.items()}
    # state: geometry from the seeded fields, derived fields by the JAX
    # package, then handed to the port as numpy
    sj = j_init_state(e.mdj, e.np["Hi"], e.np["Hb"], e.np["SL"],
                      nz=e.mesh_j.nz)
    sj = sj.replace(**{k: e.j[k] for k in ("Ti", "u_3D_b", "v_3D_b",
                                           "dHi_dt", "A_flow")},
                    u_vav_b=e.j["u_3D_b"].mean(axis=1),
                    v_vav_b=e.j["v_3D_b"].mean(axis=1))
    e.sj = sj
    e.st = ice_state_from_numpy(state_to_numpy(sj), "cpu", torch.float64)
    e.masks_j = j_masks(e.mdj, sj.Hi, sj.Hb, sj.SL)
    e.masks_t = {k: torch.from_numpy(np.asarray(v))
                 for k, v in e.masks_j.items()}
    e.geo_j = jth.make_geothermal_flux(e.Cj, e.mdj)
    e.geo_t = tth.make_geothermal_flux(e.Ct, e.mdt)
    # spend the process's first float64 torch.exp outside a comparison
    # (see tests/test_torch_physics.py)
    torch.exp(-30.0 * torch.rand(4096, dtype=torch.float64))
    return e


def _same(a_t, a_j, tol=TOL):
    a_j = np.asarray(a_j)
    if a_j.dtype == np.bool_ or np.issubdtype(a_j.dtype, np.integer):
        assert np.array_equal(a_t.numpy(), a_j)
        return
    assert str(a_t.dtype).replace("torch.", "") == str(a_j.dtype)
    assert bool(torch.isfinite(a_t).all())
    gap = rel_gap(a_t, a_j)
    assert gap <= tol, gap


def test_register_thermo_static_tables_equal(env):
    for name in ("th_ab_x", "th_ab_y", "th_ac_x", "th_ac_y", "th_has_wrap",
                 "th_tri_sector"):
        a_t, a_j = env.mdt.x(name), np.asarray(env.mdj.x(name))
        assert a_t.shape == a_j.shape, name
        assert np.array_equal(a_t.numpy(), a_j), name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_zeta_tridiag_operators_equal(env, dtype):
    zeta = np.asarray(env.mesh_j.zeta, dtype)
    oj, ot = jtri.zeta_tridiag_operators(zeta), \
        ttri.zeta_tridiag_operators(torch.from_numpy(zeta))
    for key in ("ddzeta", "d2dzeta2"):
        for a_t, a_j in zip(ot[key], oj[key]):
            assert a_t.dtype == a_j.dtype == np.float64
            assert np.array_equal(a_t, a_j)


def test_thomas_batched_against_dense_solve():
    """Diagonally dominant random systems, batched over two axes; and the
    reference's batched solver on the same systems (measured 2e-16)."""
    rng = np.random.default_rng(3)
    n = 12
    lo = rng.standard_normal((4, 5, n - 1))
    up = rng.standard_normal((4, 5, n - 1))
    d = 4.0 + rng.random((4, 5, n))
    b = rng.standard_normal((4, 5, n))
    x = ttri.thomas_batched(*(torch.from_numpy(a) for a in (lo, d, up, b)))
    A = np.zeros((4, 5, n, n))
    i = np.arange(n)
    A[..., i, i] = d
    A[..., i[1:], i[:-1]] = lo
    A[..., i[:-1], i[1:]] = up
    assert rel_gap(x, np.linalg.solve(A, b[..., None])[..., 0]) <= TOL
    xj = jtri.thomas_batched(*(jnp.asarray(a) for a in (lo, d, up, b)))
    assert rel_gap(x, np.asarray(xj)) <= TOL


@pytest.mark.parametrize("choice", ["uniform", "Pounder1965"])
def test_heat_capacity(env, choice):
    Cj, Ct = configs(choice_ice_heat_capacity=choice)
    _same(tth.calc_heat_capacity(Ct, env.t["Ti"]),
          jth.calc_heat_capacity(Cj, env.j["Ti"]))


@pytest.mark.parametrize("choice", ["uniform", "Ritz1987"])
def test_thermal_conductivity(env, choice):
    Cj, Ct = configs(choice_ice_thermal_conductivity=choice)
    _same(tth.calc_thermal_conductivity(Ct, env.t["Ti"]),
          jth.calc_thermal_conductivity(Cj, env.j["Ti"]))


def test_pressure_melting_point_and_zeta_gradients(env):
    _same(tth.calc_pressure_melting_point(env.mdt, env.t["Hi"]),
          jth.calc_pressure_melting_point(env.mdj, env.j["Hi"]))
    st, sj = env.st, env.sj
    for a_t, a_j in zip(
            tth.calc_zeta_gradients(env.mdt, st.Hi, st.Hs, st.dHi_dt,
                                    st.dHi_dt),
            jth.calc_zeta_gradients(env.mdj, sj.Hi, sj.Hs, sj.dHi_dt,
                                    sj.dHi_dt)):
        _same(a_t, a_j)


def test_strain_and_frictional_heating(env):
    w_np = np.random.default_rng(5).standard_normal(env.np["Ti"].shape)
    _same(tth.calc_strain_heating(env.Ct, env.mdt, env.masks_t,
                                  env.t["A_flow"], env.t["u_3D_b"],
                                  env.t["v_3D_b"], torch.from_numpy(w_np)),
          jth.calc_strain_heating(env.Cj, env.mdj, env.masks_j,
                                  env.j["A_flow"], env.j["u_3D_b"],
                                  env.j["v_3D_b"], jnp.asarray(w_np)))
    uabs = torch.sqrt(env.t["u_3D_b"][:env.mesh_j.nV, -1] ** 2 + 1.0)
    _same(tth.calc_frictional_heating(env.masks_t, env.t["beta"], uabs),
          jth.calc_frictional_heating(env.masks_j, env.j["beta"],
                                      jnp.asarray(uabs.numpy())))


def _a_grid(env):
    """u, v on the a-grid and the zeta gradients, from each package."""
    st, sj = env.st, env.sj
    out_t = dict(u=env.mdt.M_map_b_a @ st.u_3D_b,
                 v=env.mdt.M_map_b_a @ st.v_3D_b,
                 uv=env.mdt.M_map_b_a @ st.u_vav_b,
                 vv=env.mdt.M_map_b_a @ st.v_vav_b,
                 z=tth.calc_zeta_gradients(env.mdt, st.Hi, st.Hs, st.dHi_dt,
                                           st.dHi_dt))
    out_j = dict(u=env.mdj.M_map_b_a @ sj.u_3D_b,
                 v=env.mdj.M_map_b_a @ sj.v_3D_b,
                 uv=env.mdj.M_map_b_a @ sj.u_vav_b,
                 vv=env.mdj.M_map_b_a @ sj.v_vav_b,
                 z=jth.calc_zeta_gradients(env.mdj, sj.Hi, sj.Hs, sj.dHi_dt,
                                           sj.dHi_dt))
    return out_t, out_j


def test_vertical_velocities_and_upwind_heat_flux(env):
    at, aj = _a_grid(env)
    st, sj = env.st, env.sj
    w_t = tth.calc_vertical_velocities(
        env.Ct, env.mdt, env.masks_t, st.Hi, st.Hib, st.dHi_dt,
        torch.zeros_like(st.Hi), st.u_3D_b, st.v_3D_b, at["u"], at["v"],
        *at["z"][:3], env.t["BMB"])
    w_j = jth.calc_vertical_velocities(
        env.Cj, env.mdj, env.masks_j, sj.Hi, sj.Hib, sj.dHi_dt,
        jnp.zeros_like(sj.Hi), sj.u_3D_b, sj.v_3D_b, aj["u"], aj["v"],
        *aj["z"][:3], env.j["BMB"])
    _same(w_t, w_j)
    assert float(w_t.abs().max()) > 0.0
    for a_t, a_j in zip(
            tth.calc_upwind_heat_flux(env.mdt, st.Hi, st.Ti, st.u_3D_b,
                                      st.v_3D_b, at["uv"], at["vv"]),
            jth.calc_upwind_heat_flux(env.mdj, sj.Hi, sj.Ti, sj.u_3D_b,
                                      sj.v_3D_b, aj["uv"], aj["vv"])):
        _same(a_t, a_j)


def test_robin_solution(env):
    pmp_t = tth.calc_pressure_melting_point(env.mdt, env.t["Hi"])
    pmp_j = jth.calc_pressure_melting_point(env.mdj, env.j["Hi"])
    _same(tth.robin_solution(env.Ct, env.mdt, env.t["Hi"], pmp_t,
                             env.masks_t, env.t["T_surf"], env.t["SMB"],
                             env.geo_t),
          jth.robin_solution(env.Cj, env.mdj, env.j["Hi"], pmp_j,
                             env.masks_j, env.j["T_surf"], env.j["SMB"],
                             env.geo_j))


def _solver_inputs(fields, md_dtype, rng, nV, nz, zeta):
    """The arguments of make_heat_solver's solve: random physical columns,
    a tenth of them made unstable (huge or infinite strain heating)."""
    H = np.maximum(fields["Hi"], 0.0)
    Phi = 1e4 * rng.random((nV, nz))
    Phi[rng.random(nV) < 0.05] = np.inf
    Phi[rng.random(nV) < 0.05] *= 1e6
    dzz = -1.0 / np.maximum(H, 0.1)[:, None] * np.ones((1, nz))
    arrs = dict(
        Ti=fields["Ti"], u_3D_a=50.0 * rng.standard_normal((nV, nz)),
        v_3D_a=50.0 * rng.standard_normal((nV, nz)),
        w_3D=0.3 * rng.standard_normal((nV, nz)),
        u_dTdx_up=1e-2 * rng.standard_normal((nV, nz)),
        v_dTdy_up=1e-2 * rng.standard_normal((nV, nz)),
        T_surf=fields["T_surf"],
        Ti_pmp=273.16 - 8.7e-4 * H[:, None] * zeta[None, :],
        Ki=6.6e7 * (1.0 + 0.1 * rng.random((nV, nz))),
        Cpi=2000.0 + 100.0 * rng.random((nV, nz)),
        dzx=1e-6 * rng.standard_normal((nV, nz)),
        dzy=1e-6 * rng.standard_normal((nV, nz)),
        dzz=dzz, dzt=1e-5 * rng.standard_normal((nV, nz)), Phi=Phi,
        fraction_gr=fields["fraction_gr"], Hi_eff=H, SMB=fields["SMB"])
    arrs = {k: np.asarray(v, md_dtype) for k, v in arrs.items()}
    arrs["Q_base_grnd"] = 1.72e6 + 1e5 * rng.random(nV)       # float64
    arrs["T_base_float"] = arrs["Ti_pmp"][:, -1].copy()
    return arrs


ORDER = ("Ti", "u_3D_a", "v_3D_a", "w_3D", "u_dTdx_up", "v_dTdy_up",
         "T_surf", "Ti_pmp", "Ki", "Cpi", "dzx", "dzy", "dzz", "dzt", "Phi",
         "Q_base_grnd", "T_base_float")


@pytest.mark.parametrize("precision, gl_bc", [
    ("f64", "grounded"), ("f64", "pmp"), ("f64", "subgrid"),
    ("f32", "subgrid")])
def test_make_heat_solver(env, precision, gl_bc):
    """The heat solve with both basal boundary conditions, unstable
    columns (Robin fallback) and thin ice; in f32 the fields are float32
    and the systems float64, on both sides."""
    dtj = jnp.float32 if precision == "f32" else jnp.float64
    dtt = torch.float32 if precision == "f32" else torch.float64
    Cj, Ct = configs(**THERMO, choice_GL_temperature_BC=gl_bc,
                     tpu_precision=precision)
    mdj = jmd.build_mesh_data(env.mesh_j, dtype=dtj)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=dtt, device="cpu")
    nV, nz = env.mesh_j.nV, env.mesh_j.nz
    arrs = _solver_inputs(env.np, np.dtype(precision.replace("f", "float")),
                          np.random.default_rng(17), nV, nz,
                          np.asarray(mdj.zeta))
    masks_t = {k: v for k, v in env.masks_t.items()}
    out_j, n_j = jth.make_heat_solver(Cj, mdj)(
        *(jnp.asarray(arrs[k]) for k in ORDER), env.masks_j,
        jnp.asarray(arrs["fraction_gr"]), jnp.asarray(arrs["Hi_eff"]), 1.0,
        jnp.asarray(arrs["SMB"]), jnp.asarray(arrs["Q_base_grnd"]))
    out_t, n_t = tth.make_heat_solver(Ct, mdt)(
        *(torch.from_numpy(arrs[k]) for k in ORDER), masks_t,
        torch.from_numpy(arrs["fraction_gr"]),
        torch.from_numpy(arrs["Hi_eff"]), 1.0,
        torch.from_numpy(arrs["SMB"]),
        torch.from_numpy(arrs["Q_base_grnd"]))
    assert out_t.dtype == torch.float64 and np.asarray(out_j).dtype == \
        np.float64
    _same(out_t, out_j, TOL if precision == "f64" else F32_SOLVE_TOL)
    assert int(n_t) == int(n_j) > 0
    thin = arrs["Hi_eff"] < Ct.Hi_min_thermo
    assert int(n_t) < int((~thin).sum())      # some columns were stable


def test_geothermal_flux(env, tmp_path):
    """The uniform flux; the flux read from a global lon/lat file of W m^-2
    (tools/gen_antarctica_synthetic.py's layout and field), remapped and
    converted to J m^-2 yr^-1, on separate mesh data (the module's keeps
    the uniform one); an unknown choice is refused."""
    assert env.geo_t.dtype == torch.float64
    _same(env.geo_t, env.geo_j, 0.0)
    assert env.mdt.x("geothermal") is env.geo_t
    lon = np.linspace(0.0, 358.0, 180)
    lat = np.linspace(-90.0, 90.0, 91)
    LON, LAT = np.meshgrid(lon, lat, indexing="ij")
    hflux = (0.054 + 0.012 * np.cos(np.deg2rad(LAT))
             + 0.008 * np.sin(2 * np.deg2rad(LON)) * np.cos(np.deg2rad(LAT)))
    fj, fc = write_nc_pair(tmp_path, "ghf", {"lon": 180, "lat": 91}, {
        "lon": (("lon",), lon), "lat": (("lat",), lat),
        "hflux": (("lon", "lat"), hflux)})
    Cj, _ = configs(**THERMO, choice_geothermal_heat_flux="read_from_file",
                    filename_geothermal_heat_flux=fj)
    _, Ct = configs(**THERMO, choice_geothermal_heat_flux="read_from_file",
                    filename_geothermal_heat_flux=fc)
    mdj = jmd.build_mesh_data(env.mesh_j)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    geo_t = tth.make_geothermal_flux(Ct, mdt)
    _same(geo_t, jth.make_geothermal_flux(Cj, mdj))
    assert mdt.x("geothermal") is geo_t
    spy = 31556943.36
    assert 0.04 * spy < float(geo_t.min()) < float(geo_t.max()) < 0.08 * spy
    _, Cx = configs(**THERMO, choice_geothermal_heat_flux="from_a_hat")
    with pytest.raises(ValueError, match="from_a_hat"):
        tth.make_geothermal_flux(Cx, mdt)


def test_run_thermodynamics(env):
    """One whole step on the seeded state; the strain heating of a state
    whose A_flow field is zero is infinite in ice (as in the reference's
    time loop, where the state's A_flow stays zero), so every ice column
    that is not thin takes the Robin profile and counts as unstable."""
    T_surf_t, T_surf_j = env.t["T_surf"], env.j["T_surf"]
    for s_t, s_j, zero_A in ((env.st, env.sj, False),
                             (env.st.replace(A_flow=torch.zeros_like(
                                 env.st.A_flow)),
                              env.sj.replace(A_flow=jnp.zeros_like(
                                  env.sj.A_flow)), True)):
        heat_t = tth.make_heat_solver(env.Ct, env.mdt)
        heat_j = jth.make_heat_solver(env.Cj, env.mdj)
        Ti_t, n_t = tth.run_thermodynamics(env.Ct, env.mdt, s_t, 0.1,
                                           T_surf_t, env.t["SMB"],
                                           env.t["BMB"], heat_t)
        Ti_j, n_j = jth.run_thermodynamics(env.Cj, env.mdj, s_j, 0.1,
                                           T_surf_j, env.j["SMB"],
                                           env.j["BMB"], heat_j)
        _same(Ti_t, Ti_j)
        assert int(n_t) == int(n_j)
        ice = (env.masks_t["mask_grounded_ice"]
               | env.masks_t["mask_floating_ice"])
        n_ice = int((ice & (s_t.Hi_eff >= env.Ct.Hi_min_thermo)).sum())
        if zero_A:
            assert int(n_t) == n_ice > 0
        else:
            assert int(n_t) < n_ice


def test_heat_columns_wrapper_checks_and_counts(env):
    """The wrapper takes the plain version for CPU tensors only, without
    counting a launch, and refuses mismatched operands."""
    n, nz = 5, env.mesh_j.nz
    zeta = env.mesh_t.zeta
    zrows = cuda_heat.zeta_rows(ttri.zeta_tridiag_operators(zeta), "cpu")
    f = lambda *s: torch.full(s, 250.0, dtype=torch.float64)
    b = torch.zeros(n, dtype=torch.bool)
    args = [f(n, nz), f(n, nz) * 0, f(n, nz) * 0, f(n, nz) * 0, f(n),
            f(n) * 0, f(n) + 20, f(n, nz) + 20, b, b, b, f(n) * 0, b,
            f(n, nz), zrows, 1.0, "grounded"]
    n0 = cuda_heat.launches
    out, n_unstable = cuda_heat.heat_columns(*args)
    assert cuda_heat.launches == n0
    assert out.shape == (n, nz) and int(n_unstable) == 0
    # a column at rest stays at rest: T = T_surf everywhere
    assert torch.allclose(out, f(n, nz), rtol=0, atol=1e-9)
    bad = list(args)
    bad[5] = bad[5].float()                   # q_base must be float64
    with pytest.raises(ValueError, match="heat_columns"):
        cuda_heat.heat_columns(*bad)
    bad = list(args)
    bad[1] = bad[1][:, :-1]
    with pytest.raises(ValueError, match="heat_columns"):
        cuda_heat.heat_columns(*bad)
