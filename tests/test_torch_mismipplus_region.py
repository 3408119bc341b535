"""The MISMIP+ slice as a whole: the port's `ModelRegion` against the JAX
package's on the 40 km MISMIP+ configuration with the ocean-pressure
calving front at x = 640 km, Weertman sliding and the flow-factor tuning
slot, in f64, on the identical mesh - the initial solve, three ice steps
and the scalars of the output event - and the MISMIP+ flow-factor
controller on the same state.

Measured gaps in f64 (this configuration, CPU): Hi 1.4e-16, u_vav_b 4e-15,
v_vav_b 6e-15 of the field's largest value after the ice steps (v after
the initial solve 5e-13: v is small beside u in the channel), with equal
dt trajectories, n_visc_its and n_Axb_its. Tolerance 1e-10 on the fields
and the scalars (1e-8 on v after the initial solve)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import mismipplus_configs, build_meshes_for, rel_gap

from ufemism2_tpu.core.ice import rheology as jrheo
from ufemism2_tpu.main import program as jprog
from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.convert import extra_tables_from_numpy
from ufemism2_tpu_torch.core.ice import rheology as trheo
from ufemism2_tpu_torch.core.ice.ssadiva import calc_front
from ufemism2_tpu_torch.main import program as tprog
from ufemism2_tpu_torch.main.region import ModelRegion

TOL = 1e-10
T_ENDS = (0.05, 0.15, 0.3)       # one ice step each (dt 0.1, 0.11, 0.121)


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = mismipplus_configs(refgeo_idealised_MISMIPplus_tune_A=True)
    e.mesh_j, e.mesh_t = build_meshes_for(e.Cj)
    e.rj = JaxRegion(e.Cj, "ANT", mesh=e.mesh_j)
    e.rt = ModelRegion(e.Ct, "ANT", mesh=e.mesh_t, device="cpu")
    e.init = (e.rt.state, e.rj.state)
    return e


def test_initial_state_and_slot(env):
    st, sj = env.init
    assert float(env.rt.md.x("glen_A_scale")) == 1.0 \
        == float(np.asarray(env.rj.md.extras["glen_A_scale"].arr))
    assert env.rt.md.x("glen_A_scale").dtype == torch.float64
    assert rel_gap(st.Hi, np.asarray(sj.Hi)) == 0.0
    assert rel_gap(st.u_vav_b, np.asarray(sj.u_vav_b)) <= TOL
    assert rel_gap(st.v_vav_b, np.asarray(sj.v_vav_b)) <= 1e-8
    assert float(st.u_vav_b.abs().max()) > 1.0      # a real solve
    # the domain reaches past the ice: a calving front with rows off it
    Hi_b = env.rt.md.M_map_a_b.exact_matvec(st.Hi)
    f = calc_front(env.rt.md, st.Hi, st.Hb, st.SL, Hi_b)
    assert int(f.is_front.sum()) > 0 and int(f.off.sum()) > 0


def test_ice_steps_match_jax(env):
    """Three ice steps: the dt trajectory, the solver counts, the fields,
    and the scalars of the output event at t = 0."""
    traj_t, traj_j = [], []
    for t_end in T_ENDS:
        st = env.rt.run_to(t_end)
        sj = env.rj.run_to(t_end)
        traj_t.append((st.dt_ice, st.t_Hi_next))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next)))
        assert st.n_visc_its == int(sj.n_visc_its)
        assert st.n_Axb_its == int(sj.n_Axb_its)
        for name in ("Hi", "Hs", "u_vav_b", "v_vav_b", "u_3D_b", "v_3D_b",
                     "fraction_gr"):
            gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
            assert gap <= TOL, (name, gap)
    assert env.rt.n_dt_ice == env.rj.n_dt_ice == len(T_ENDS)
    assert np.allclose(traj_t, traj_j, rtol=1e-12, atol=0.0)
    assert st.n_Axb_its > 0 and st.n_visc_its > 0
    # the output event at t = 0: the same scalars, one entry
    assert len(env.rt.scalars_history) == len(env.rj.scalars_history) == 1
    _same_scalars(env.rt.scalars_history[0], env.rj.scalars_history[0])


def _same_scalars(a, b):
    assert sorted(a) == sorted(b)
    scale = max(abs(v) for v in b.values())
    for k in b:
        assert abs(a[k] - b[k]) <= TOL * max(abs(b[k]), 1e-6 * scale), \
            (k, a[k], b[k])


def test_write_output_matches_jax(env):
    """The scalar half of an output event at the current time."""
    env.rt.write_output()
    env.rj.write_output()
    _same_scalars(env.rt.scalars_history[-1], env.rj.scalars_history[-1])
    assert env.rt.scalars_history[-1]["time"] == T_ENDS[-1]
    assert env.rt.scalars_history[-1]["ice_volume"] > 0.0


def _thick_state(env):
    """Both regions' states with 600 m of ice where the MISMIP+ mask has
    ice: a grounding line on the centreline between x = 0 and 640 km."""
    sj = env.rj.state
    Hb, SL = np.asarray(sj.Hb), np.asarray(sj.SL)
    Hi = np.where(env.mesh_j.V[:, 0] > 640e3, 0.0, 600.0)
    TAF = Hi - np.maximum(0.0, (SL - Hb) * (1028.0 / 910.0))
    env.rj.state = sj.replace(TAF=jnp.asarray(TAF))
    env.rt.state = env.rt.state.replace(TAF=torch.from_numpy(TAF))


def test_adapt_flow_factor_matches_jax(env):
    """The MISMIP+ controller on the same state: the grounding line, the
    new scale and the gain, over three adaptations - the second with the
    error's sign kept, the third after a sign change (the gain halves)."""
    _thick_state(env)
    x_t = tprog.mismipplus_x_GL(env.Ct, env.rt)
    assert x_t is not None and 0.0 < x_t < 640e3
    for step in range(3):
        if step == 2:
            # pretend the last error had the other sign
            env.rt._mismip_tune["last_err"] *= -1.0
            env.rj._mismip_tune["last_err"] *= -1.0
        Ct = tprog.mismipplus_adapt_flow_factor(env.Ct, env.rt)
        Cj = jprog.mismipplus_adapt_flow_factor(env.Cj, env.rj)
        assert Ct is env.Ct and Cj is env.Cj     # the slot takes it
        st_, sj_ = env.rt._mismip_tune, env.rj._mismip_tune
        assert st_["gain"] == sj_["gain"]
        assert abs(st_["last_err"] - sj_["last_err"]) <= 1e-6
        scale_t = float(env.rt.md.x("glen_A_scale"))
        scale_j = float(np.asarray(env.rj.md.extras["glen_A_scale"].arr))
        assert abs(scale_t - scale_j) <= 1e-12 * scale_j
    assert st_["gain"] == 0.5 and scale_t != 1.0
    assert abs(st_["last_err"] - (x_t - 450e3)) <= 1e-6


def test_flow_factor_slot_feeds_rheology(env):
    """The rheology reads the uniform flow factor times the slot, as the
    JAX package's does, so a new scale acts without a new step."""
    n = env.mesh_t.nV
    Ti = np.full((n, env.Ct.nz), 260.0)
    m = np.ones(n, bool)
    scale = 3.25
    extra_tables_from_numpy(env.rt.md, {"glen_A_scale": (scale, "scalar")})
    env.rj.md.extras["glen_A_scale"].arr = jnp.asarray(scale)
    At = trheo.calc_ice_rheology_glen(env.Ct, env.rt.md, None, None,
                                      torch.from_numpy(Ti),
                                      torch.from_numpy(m),
                                      torch.from_numpy(~m))
    Aj = jrheo.calc_ice_rheology_glen(env.Cj, env.rj.md, None, None,
                                      jnp.asarray(Ti), jnp.asarray(m),
                                      jnp.asarray(~m))
    assert rel_gap(At, np.asarray(Aj)) == 0.0
    assert float(At.max()) == pytest.approx(
        scale * env.Ct.uniform_Glens_flow_factor * env.Ct.m_enh_sheet,
        rel=1e-15)


def test_no_grounding_line_keeps_the_factor(env):
    """Without a grounding line on the centreline there is nothing to tune
    for: the port returns the config and leaves the scale. (The JAX
    package returns None here, which its coupling loop then reads as the
    config: ROADMAP, section C.)"""
    s = env.rt.state
    env.rt.state = s.replace(TAF=-torch.ones_like(s.TAF))
    before = float(env.rt.md.x("glen_A_scale"))
    try:
        assert tprog.mismipplus_x_GL(env.Ct, env.rt) is None
        assert tprog.mismipplus_adapt_flow_factor(env.Ct, env.rt) is env.Ct
        assert float(env.rt.md.x("glen_A_scale")) == before
    finally:
        env.rt.state = s
