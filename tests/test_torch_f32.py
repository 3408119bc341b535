"""The port's f32 performance mode against the JAX package's, on the CPU:
the 64 km MISMIP_mod DIVA fixture in f32 through both `ModelRegion`s, on
the identical mesh, over four ice steps.

The tolerances come from the f32 floor. Both packages round x to
bfloat16 inside the f32 Krylov and physics matvecs (relative step 2^-8
= 3.9e-3) and stop GMRES at rtol 1e-5, so every f32 solve ends at its
precision floor and the two solves of one system differ by up to about
1e-2 of the velocity, whatever the summation order (the initial solve
here: 1.0e-2 measured). The thickness moves by dt * divQ a step:
- over the four steps the ice volume changes by 7.5e-4 of itself, so a
  1e-2 velocity gap bounds the volume gap by 7.5e-6; the test takes
  1e-5 (measured 1.1e-7);
- the thickness gap is held to the port's own f32-against-f64 bound,
  tests/test_torch_region.py F32_HI_TOL = 1e-3 of the largest thickness
  (measured 2.1e-5);
- the dt controller grows dt by its maximum 10 % a step on both sides
  (its truncation error is far below pc_epsilon), so the trajectory is
  equal to rounding; and every viscosity iteration and every GMRES solve
  runs to its cap here (visc_it_nit 3, the fixture's), so n_visc_its and
  n_Axb_its are equal (measured: equal). A departure beyond these is a
  fault of the port."""

import numpy as np
import pytest
import torch

from torch_port_fixture import configs, build_meshes, rel_gap

from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.main.region import ModelRegion

T_ENDS = (0.05, 0.15, 0.25, 0.35)      # one ice step each
VOLUME_TOL = 1e-5
HI_TOL = 1e-3
INITIAL_U_TOL = 2e-2


@pytest.fixture(scope="module")
def runs():
    Cj, Ct = configs(tpu_precision="f32")
    mesh_j, mesh_t = build_meshes()
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rt = ModelRegion(Ct, "ANT", mesh=mesh_t, device="cpu")
    init = rel_gap(rt.state.u_vav_b.double(),
                   np.asarray(rj.state.u_vav_b, np.float64))
    traj = []
    for t in T_ENDS:
        sj, st = rj.run_to(t), rt.run_to(t)
        vj = float(np.sum(np.asarray(sj.Hi, np.float64)
                          * np.asarray(rj.md.A, np.float64)))
        vt = float((st.Hi.double() * rt.md.A.double()).sum())
        traj.append(dict(
            dt=(st.dt_ice, float(sj.dt_ice)),
            t_next=(st.t_Hi_next, float(sj.t_Hi_next)),
            visc=(st.n_visc_its, int(sj.n_visc_its)),
            axb=(st.n_Axb_its, int(sj.n_Axb_its)),
            volume=(vt, vj),
            hi_gap=rel_gap(st.Hi.double(),
                           np.asarray(sj.Hi, np.float64))))
    return rt, rj, init, traj


def test_f32_both_packages_run_in_f32(runs):
    rt, rj, _, _ = runs
    assert rt.state.Hi.dtype == torch.float32
    assert np.asarray(rj.state.Hi).dtype == np.float32
    assert rt.n_dt_ice == rj.n_dt_ice == len(T_ENDS)


def test_f32_initial_solve_at_the_floor(runs):
    _, _, init, _ = runs
    assert init <= INITIAL_U_TOL, init


def test_f32_trajectory_and_counts_match_jax(runs):
    _, _, _, traj = runs
    for rec in traj:
        assert rec["dt"][0] == pytest.approx(rec["dt"][1], rel=1e-12)
        assert rec["t_next"][0] == pytest.approx(rec["t_next"][1],
                                                 rel=1e-12)
        assert rec["visc"][0] == rec["visc"][1], rec
        assert rec["axb"][0] == rec["axb"][1], rec


def test_f32_volume_and_thickness_match_jax(runs):
    _, _, _, traj = runs
    for rec in traj:
        vt, vj = rec["volume"]
        assert abs(vt - vj) <= VOLUME_TOL * vj, rec
        assert rec["hi_gap"] <= HI_TOL, rec
