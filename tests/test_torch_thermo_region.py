"""The port's region with thermodynamics on against the JAX package's, on
the MISMIP_mod fixture in f64 (Huybrechts rheology, Robin initial
temperatures, a thermodynamics step every 0.1 yr, caught up after each ice
step): six ice steps; the same run with a uniform flow factor against the
thermodynamics-off run; and the choices of the slice that still raise.

Tolerances, relative to the field's largest value, beside the gaps
measured on this fixture: Ti 1e-12, Hi 5e-15, velocities 5e-14 (measured
2.1e-16, 5.7e-16, 5.1e-15), with equal dt trajectories, thermodynamics
times and solver counts. With a uniform flow factor Ti enters nothing
else, so thermodynamics on or off gives the same ice to the bit."""

import numpy as np
import pytest
import torch

from torch_port_fixture import configs, build_meshes, rel_gap

from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.main.region import ModelRegion

REGION_TOL = {"Ti": 1e-12, "Hi": 5e-15, "u_vav_b": 5e-14, "v_vav_b": 5e-14,
              "u_3D_b": 5e-14, "v_3D_b": 5e-14}
THERMO = dict(choice_thermo_model="3D_heat_equation",
              choice_ice_rheology_Glen="Huybrechts1992",
              choice_initial_ice_temperature_ANT="Robin",
              dt_thermodynamics=0.1)
# each run_to below ends inside a new prediction window, so each takes
# exactly one ice step
T_ENDS = (0.05, 0.15, 0.25, 0.35, 0.5, 0.6)


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs(**THERMO)
    e.mesh_j, e.mesh_t = build_meshes()
    return e


@pytest.fixture(scope="module")
def regions(env):
    r = Env()
    r.rj = JaxRegion(env.Cj, "ANT", mesh=env.mesh_j)
    r.rt = ModelRegion(env.Ct, "ANT", mesh=env.mesh_t, device="cpu")
    return r


def test_region_with_thermodynamics_matches_jax(env, regions):
    """Huybrechts rheology, Robin initial temperature, thermodynamics
    every 0.1 yr: six ice steps, each caught up with the thermodynamics
    steps it passed."""
    rt, rj = regions.rt, regions.rj
    assert rt.do_thermo and rel_gap(rt.state.Ti, np.asarray(rj.state.Ti)) \
        <= REGION_TOL["Ti"]
    traj_t, traj_j = [], []
    for t_end in T_ENDS:
        st, sj = rt.run_to(t_end), rj.run_to(t_end)
        traj_t.append((st.dt_ice, st.t_Hi_next, rt.t_thermo_next))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next),
                       float(rj.t_thermo_next)))
        for name, tol in REGION_TOL.items():
            gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
            assert gap <= tol, (t_end, name, gap)
        assert st.n_visc_its == int(sj.n_visc_its)
        assert st.n_Axb_its == int(sj.n_Axb_its)
    assert np.allclose(traj_t, traj_j, rtol=1e-12, atol=0.0)
    assert rt.n_dt_ice == rj.n_dt_ice == len(T_ENDS)
    assert rt.thermo_steps == 7 and int(rt.thermo_n_unstable) > 0
    # Ti moved away from its initial profile, but only where the Robin
    # profile of the moving geometry moved
    Ti = rt.state.Ti
    assert bool(torch.isfinite(Ti).all())
    assert float(Ti.min()) >= 180.0 and float(Ti.max()) <= 273.16


def test_uniform_rheology_thermodynamics_leaves_the_ice_alone(env):
    """With a uniform flow factor Ti enters nothing else: thermodynamics
    on or off, Hi and the velocities are the same to the bit."""
    _, C_on = configs(**dict(THERMO, choice_ice_rheology_Glen="uniform"))
    _, C_off = configs()
    r_on = ModelRegion(C_on, "ANT", mesh=env.mesh_t, device="cpu")
    r_off = ModelRegion(C_off, "ANT", mesh=env.mesh_t, device="cpu")
    s_on, s_off = r_on.run_to(0.15), r_off.run_to(0.15)
    assert r_on.thermo_steps == 2 and r_off.thermo_steps == 0
    assert not torch.equal(s_on.Ti, s_off.Ti)
    for name in ("Hi", "u_vav_b", "v_vav_b", "u_3D_b", "v_3D_b"):
        assert torch.equal(getattr(s_on, name), getattr(s_off, name)), name
    assert (s_on.n_visc_its, s_on.n_Axb_its, s_on.dt_ice) == \
        (s_off.n_visc_its, s_off.n_Axb_its, s_off.dt_ice)


def test_thermo_config_refusals(env):
    _, Ct = configs(**THERMO, choice_SMB_model_ANT="reconstructed")
    with pytest.raises(NotImplementedError, match="choice_SMB_model"):
        ModelRegion(Ct, "ANT", mesh=env.mesh_t, device="cpu")
    # (a geothermal flux read from a file is ported:
    # tests/test_torch_thermo.py test_geothermal_flux)
    _, Ct = configs(**dict(THERMO, choice_thermo_model="prescribed"))
    with pytest.raises(NotImplementedError, match="choice_thermo_model"):
        ModelRegion(Ct, "ANT", mesh=env.mesh_t, device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card, never the host
        with pytest.raises(RuntimeError, match="cuda"):
            ModelRegion(env.Ct, "ANT", mesh=env.mesh_t)
