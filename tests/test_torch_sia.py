"""The port's SIA and hybrid SIA/SSA stress balances against the JAX
package, in f64: `solve_SIA` on seeded fields of the fixture mesh, the
SIA branch of make_solve_stress_balance and the SIA/SSA solve (with
sliding, and without, where the SSA part is zero) on a thick dome over
the fixture's bed, and a few ice steps of the Halfar dome
(tests/test_halfar.py's configuration, thermodynamics on as the schema
has it).

Tolerances, relative to the field's largest value, beside the gaps
measured here: the stress balances 1e-12 (measured 6.1e-15 to 6.5e-15:
both sides do the same f64 arithmetic, summation order and the last bit
of pow apart, and the SSA part's GMRES takes the same iterations); the
Halfar steps 5e-14 for Hi and the velocities and 1e-12 for Ti (measured
4.8e-15 and 2.1e-16), with equal dt trajectories and thickness-solve
counts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_fixture import (configs, build_meshes, state_to_numpy,
                                rel_gap)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import sia as jsia
from ufemism2_tpu.core.ice.pc import make_solve_stress_balance as j_make_solve
from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import ice_state_from_numpy, mesh_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.analytical import halfar_H
from ufemism2_tpu_torch.core.ice import sia as tsia
from ufemism2_tpu_torch.core.ice.pc import \
    make_solve_stress_balance as t_make_solve
from ufemism2_tpu_torch.main.region import ModelRegion, _build_bedrock_cdfs

TOL = 1e-12
HALFAR_TOL = {"Hi": 5e-14, "u_vav_b": 5e-14, "v_vav_b": 5e-14,
              "u_3D_b": 5e-14, "v_3D_b": 5e-14}
# tests/test_halfar.py:34-52, on a fixed mesh
HALFAR = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="Halfar",
    dx_refgeo_init_idealised=50e3,
    refgeo_idealised_Halfar_H0=3000.0,
    refgeo_idealised_Halfar_R0=500e3,
    uniform_Glens_flow_factor=1e-16,
    choice_ice_rheology_Glen="uniform",
    choice_stress_balance_approximation="SIA",
    choice_sliding_law="no_sliding",
    xmin_ANT=-750e3, xmax_ANT=750e3, ymin_ANT=-750e3, ymax_ANT=750e3,
    maximum_resolution_uniform=100e3,
    maximum_resolution_grounded_ice=100e3,
    maximum_resolution_ice_front=50e3,
    ice_front_width=50e3,
    start_time_of_run=0.0, end_time_of_run=200.0,
    nit_Lloyds_algorithm=2,
    refgeo_Hi_min=2.0,
    allow_mesh_updates=False,       # a fixed mesh, as tests/test_halfar.py
)
HALFAR_T_ENDS = (0.05, 0.15, 0.3, 0.6, 1.2)


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs(choice_stress_balance_approximation="SIA")
    e.mesh_j, e.mesh_t = build_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(23)
    V = e.mesh_j.V
    r = np.hypot(V[:, 0], V[:, 1])
    Hi = np.maximum(0.0, 2500.0 * (1.0 - (r / 800e3) ** 2)) \
        + 20.0 * rng.random(e.mesh_j.nV)
    Hs = Hi + 10.0 * rng.standard_normal(e.mesh_j.nV)
    A = 1e-16 * (1.0 + rng.random((e.mesh_j.nV, e.mesh_j.nz)))
    e.np = dict(Hi=Hi, Hs=Hs, A=A)
    return e


def test_solve_SIA(env):
    j = {k: jnp.asarray(v) for k, v in env.np.items()}
    t = {k: torch.from_numpy(v) for k, v in env.np.items()}
    out_j = jsia.solve_SIA(env.Cj, env.mdj, j["Hi"], j["Hs"], j["A"])
    out_t = tsia.solve_SIA(env.Ct, env.mdt, t["Hi"], t["Hs"], t["A"])
    assert len(out_t) == len(out_j) == 7
    for a_t, a_j in zip(out_t, out_j):
        assert a_t.dtype == torch.float64 and bool(torch.isfinite(a_t).all())
        assert rel_gap(a_t, np.asarray(a_j)) <= TOL
    assert float(out_t[5].abs().max()) > 1.0          # m/yr: real flow


@pytest.fixture(scope="module")
def cold(env):
    """The fixture state before any stress-balance solve, on both sides."""
    Cj0, _ = configs(choice_stress_balance_approximation="none")
    rj = JaxRegion(Cj0, "ANT", mesh=env.mesh_j)
    c = Env()
    c.sj = rj.state
    c.st = ice_state_from_numpy(state_to_numpy(c.sj), device="cpu",
                                dtype=torch.float64)
    c.mdj = rj.md
    c.cdfs_j = rj._bedrock_cdfs
    # a thick dome on the fixture's bed, so that the SIA part is large
    from ufemism2_tpu.core.ice.geometry import ice_surface_elevation
    Hi = np.asarray(env.np["Hi"]) + 500.0 * (np.asarray(c.sj.Hi) > 0)
    Hs = np.asarray(ice_surface_elevation(jnp.asarray(Hi), c.sj.Hb,
                                          c.sj.SL))
    c.geo_j = (jnp.asarray(Hi), jnp.asarray(Hs))
    c.geo_t = (torch.from_numpy(Hi), torch.from_numpy(Hs))
    return c


def _solve_both(env, cold, **over):
    Cj, Ct = configs(**over)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    cdfs_t = _build_bedrock_cdfs(Ct, env.mesh_t, "ANT", mdt)
    sj, st = cold.sj, cold.st
    oj = jax.jit(j_make_solve(Cj, cold.mdj, bedrock_cdfs=cold.cdfs_j))(
        cold.mdj, *cold.geo_j, sj.Hb, sj.SL, sj.Ti, sj)
    ot = t_make_solve(Ct, mdt, bedrock_cdfs=cdfs_t)(
        mdt, *cold.geo_t, st.Hb, st.SL, st.Ti, st)
    return oj, ot


@pytest.mark.parametrize("choice, sliding", [
    ("SIA", "Zoet-Iverson"), ("SIA/SSA", "Zoet-Iverson"),
    ("SIA/SSA", "no_sliding")])
def test_sia_stress_balances(env, cold, choice, sliding):
    """The SIA branch (no solver state of its own, no iterations), and the
    SSA solve plus the SIA velocities: with sliding the viscosity
    iteration runs, without it the SSA part is zero and not solved."""
    oj, ot = _solve_both(env, cold,
                         choice_stress_balance_approximation=choice,
                         choice_sliding_law=sliding)
    for i in range(4):
        assert rel_gap(ot[i], np.asarray(oj[i])) <= TOL, i
    assert float(ot[0].abs().max()) > 1.0
    assert ot[4] == int(oj[4]) and ot[5] == int(oj[5])
    if choice == "SIA" or sliding == "no_sliding":
        assert ot[4] == ot[5] == 0
        for k in ("visc_tau_bx", "visc_tau_by", "visc_eta_3D_b"):
            assert ot[6][k] is getattr(cold.st, k)       # carried through
    else:
        assert ot[4] > 0 and ot[5] > 0
        # the SIA part is really added: it differs from the SSA alone
        _, ot_ssa = _solve_both(env, cold,
                                choice_stress_balance_approximation="SSA",
                                choice_sliding_law=sliding)
        assert float((ot[0] - ot_ssa[0]).abs().max()) > 1e-3


def test_halfar_steps_match_jax():
    """The Halfar dome: a few ice steps (and the thermodynamics step at
    t = 1 yr) of the port's region against the JAX package's, on the same
    mesh; and the dome thins towards the analytical solution."""
    from ufemism2_tpu.mesh import build_mesh_from_config
    from torch_port_fixture import mesh_to_numpy
    Cj, Ct = CJ(**HALFAR), CT(**HALFAR)
    mesh_j = build_mesh_from_config(Cj, "ANT")
    mesh_t = mesh_from_numpy(mesh_to_numpy(mesh_j))
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rt = ModelRegion(Ct, "ANT", mesh=mesh_t, device="cpu")
    assert rt.do_thermo and Ct.choice_thermo_model == "3D_heat_equation"
    assert rel_gap(rt.state.Ti, np.asarray(rj.state.Ti)) <= TOL
    traj_t, traj_j = [], []
    for t_end in HALFAR_T_ENDS:
        st, sj = rt.run_to(t_end), rj.run_to(t_end)
        traj_t.append((st.dt_ice, st.t_Hi_next))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next)))
        for name, tol in HALFAR_TOL.items():
            gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
            assert gap <= tol, (t_end, name, gap)
        assert st.n_visc_its == int(sj.n_visc_its) == 0
        assert st.n_Axb_its == int(sj.n_Axb_its)
    assert rel_gap(rt.state.Ti, np.asarray(rj.state.Ti)) <= TOL
    assert np.allclose(traj_t, traj_j, rtol=1e-12, atol=0.0)
    assert rt.n_dt_ice == rj.n_dt_ice >= len(HALFAR_T_ENDS)
    assert rt.thermo_steps == 1
    Hex = halfar_H(1e-16, 3.0, 3000.0, 500e3, mesh_t.V[:, 0], mesh_t.V[:, 1],
                   rt.time)
    rmse = float(np.sqrt(((rt.state.Hi.numpy() - Hex) ** 2).mean()))
    assert rmse < 80.0, rmse
