"""A mesh update in the port's `ModelRegion` against the JAX package's, on
the 64 km MISMIP_mod DIVA fixture with `allow_mesh_updates` on, in f64 on
the CPU: a few ice steps, a forced `update_mesh()`, more ice steps.

Both packages rasterise the same geometry, build the same mesh from it
and remap with the same maps, so the new mesh is identical (nV, nTri, V
exactly) and the run on it reproduces the dt trajectory and the solver
counts; the fields agree within REGION_TOL, the tolerances of
tests/test_torch_region.py (measured after the remesh: Hi 8e-16,
u_vav_b 2e-15 of the largest value)."""

import numpy as np
import pytest

from torch_port_fixture import configs, build_meshes, rel_gap

from ufemism2_tpu.io.ncio import NCFile as JaxNC
from ufemism2_tpu.utils.checksum import compare_checksum_logs
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.main.region import \
    calc_mesh_fitness_coefficient as jax_fitness

from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.main.region import (ModelRegion,
                                            calc_mesh_fitness_coefficient)

REGION_TOL = {"Hi": 5e-15, "Hs": 2e-15, "u_vav_b": 2e-14, "v_vav_b": 2e-14,
              "u_3D_b": 2e-14, "v_3D_b": 2e-14, "fraction_gr": 1e-14}
T_BEFORE = (0.15, 0.35)          # two run_to calls, four ice steps
T_AFTER = (0.45, 0.55, 0.7)      # one ice step each on the new mesh


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    e.dir = tmp_path_factory.mktemp("remesh")
    e.Cj, e.Ct = configs(allow_mesh_updates=True, do_write_checksum_log=True,
                         dt_SMB=0.1, dt_BMB=0.1)
    mesh_j, mesh_t = build_meshes()
    e.rj = JaxRegion(e.Cj, "ANT", mesh=mesh_j, output_dir=str(e.dir / "j"))
    e.rt = ModelRegion(e.Ct, "ANT", mesh=mesh_t, device="cpu",
                       output_dir=str(e.dir / "t"))
    for t in T_BEFORE:
        e.rj.run_to(t)
        e.rt.run_to(t)
    e.before = (e.rt.mesh, e.rj.mesh, e.rt.state, e.rj.state)
    e.rj.update_mesh()
    e.rt.update_mesh()
    e.remesh_time = e.rt.time
    e.after = (e.rt.state, e.rj.state)
    e.traj = []
    for t in T_AFTER:
        sj, st = e.rj.run_to(t), e.rt.run_to(t)
        e.traj.append(((st.dt_ice, st.t_Hi_next, st.n_visc_its,
                        st.n_Axb_its),
                       (float(sj.dt_ice), float(sj.t_Hi_next),
                        int(sj.n_visc_its), int(sj.n_Axb_its))))
    e.rj.write_output()
    e.rt.write_output()
    return e


def _compare(st, sj):
    for name, tol in REGION_TOL.items():
        gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
        assert gap <= tol, f"{name}: {gap:.2e}"


def test_fitness_coefficient_matches_jax(env):
    """The same fitness on the same state: 1 on the fixture, below 1 for
    a configuration that asks for a finer grounding line."""
    mt, mj, st, sj = env.before
    assert calc_mesh_fitness_coefficient(env.Ct, mt, st) \
        == jax_fitness(env.Cj, mj, sj) == 1.0
    Cj, Ct = configs(allow_mesh_updates=True,
                     maximum_resolution_grounding_line=20e3)
    f = calc_mesh_fitness_coefficient(Ct, mt, st)
    assert f == jax_fitness(Cj, mj, sj) and f < 1.0


def test_new_mesh_is_identical(env):
    mt, mj = env.rt.mesh, env.rj.mesh
    assert (mt.nV, mt.nTri) == (mj.nV, mj.nTri)
    assert (mt.nV, mt.nTri) != (env.before[0].nV, env.before[0].nTri)
    assert np.array_equal(mt.V, mj.V) and np.array_equal(mt.Tri, mj.Tri)
    assert env.rt.n_mesh_updates == env.rj.n_mesh_updates == 1
    assert env.rt.md.nV == mt.nV


def test_remapped_state_matches_jax(env):
    """Right after the update: the remapped state and the PC controller
    restarted at dt_ice_min, as the JAX package has them."""
    st, sj = env.after
    _compare(st, sj)
    for name in ("Hb", "SL", "Ti", "visc_eta_3D_b", "bed_roughness"):
        assert rel_gap(getattr(st, name),
                       np.asarray(getattr(sj, name))) <= 1e-14, name
    assert st.dt_ice == float(sj.dt_ice) == env.Ct.dt_ice_min
    assert st.pc.dt_np1 == float(sj.pc.dt_np1) == env.Ct.dt_ice_min
    assert st.pc.eta_n == float(sj.pc.eta_n) == env.Ct.pc_epsilon
    assert st.t_Hi_next == float(sj.t_Hi_next)
    assert float(st.pc.tau_np1.abs().max()) == 0.0


def test_run_after_remesh_matches_jax(env):
    """Three ice steps on the new mesh: the dt trajectory, n_visc_its and
    n_Axb_its equal, the fields within REGION_TOL."""
    for mine, ref in env.traj:
        assert mine[2:] == ref[2:], (mine, ref)
        assert np.allclose(mine[:2], ref[:2], rtol=1e-12, atol=0.0)
    assert env.rt.n_dt_ice == env.rj.n_dt_ice == 4 + len(T_AFTER)
    _compare(env.rt.state, env.rj.state)


def test_outputs_rotate_and_restart_follows_the_mesh(env):
    """The mesh output moves to generation 00002 on the new mesh, the
    restart is rewritten on it at the update's time, and the files hold
    what the JAX package's hold."""
    dt, dj = env.dir / "t", env.dir / "j"
    names = sorted(p.name for p in dt.glob("*.nc"))
    assert names == sorted(p.name for p in dj.glob("*.nc")) == [
        "main_output_ANT_00001.nc", "main_output_ANT_00002.nc",
        "main_output_ANT_grid.nc", "restart_ANT_00001.nc",
        "scalar_output_ANT_00001.nc"]
    g1 = NCFile(dt / "main_output_ANT_00001.nc")
    g2 = NCFile(dt / "main_output_ANT_00002.nc")
    assert g1.dims()["vi"] == env.before[0].nV
    assert g2.dims()["vi"] == env.rt.mesh.nV and g2.dims()["time"] == 1
    r = NCFile(dt / "restart_ANT_00001.nc")
    assert r.dims()["vi"] == env.rt.mesh.nV
    assert float(r.read("time")[0]) == env.remesh_time
    j2 = JaxNC(dj / "main_output_ANT_00002.nc")
    for name in ("Hi", "u_vav_b"):
        assert rel_gap(g2.read(name), j2.read(name)) \
            <= REGION_TOL[name], name
    j2.close()
    grid = NCFile(dt / "main_output_ANT_grid.nc")
    assert grid.dims()["time"] == 2          # spans both generations


def test_checksum_logs_match_jax(env):
    """do_write_checksum_log: the same entries at the same times, sums,
    minima and maxima within 1e-12 of the larger value, across the
    remesh."""
    lt = env.dir / "t" / "checksum_log_ANT.jsonl"
    lj = env.dir / "j" / "checksum_log_ANT.jsonl"
    import json
    et = [json.loads(x) for x in lt.read_text().splitlines()]
    ej = [json.loads(x) for x in lj.read_text().splitlines()]
    assert len(et) == len(ej) > 8
    assert [(e["name"], e["t"], e["n"]) for e in et] \
        == [(e["name"], e["t"], e["n"]) for e in ej]
    assert compare_checksum_logs(lt, lj, rtol=1e-12) == []
