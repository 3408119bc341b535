"""Restarts in the port: the resume contract (a run interrupted at a
restart and resumed in a fresh region ends where the uninterrupted run
ends), the host counters, the PC controller's warm start from a file, and
a resume of the JAX package's MISMIP+ 5 km spin-up (the committed classic
copy of its restart) against the JAX package's resume of the original
NetCDF4 file, on the CPU in f64.

The port's own resume is exact: the restart holds every state field in
f64 and the time bookkeeping as f64 scalars, so the resumed run repeats
the uninterrupted one to the bit. Against the JAX package the MISMIP+
resume agrees to 1e-10 over its first two ice steps (the same f64
arithmetic, summation order apart; measured below 1e-13)."""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixture import rel_gap

from ufemism2_tpu.config import Config as JaxConfig
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh.creation import set_mesh_lonlat as jax_lonlat
from ufemism2_tpu.mesh.mesh_types import mesh_from_points as jax_mesh

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.io.output_files import (
    _state_leaves, load_restart_host_counters, mesh_from_restart,
    write_restart_file)
from ufemism2_tpu_torch.main.region import ModelRegion

REPO = Path(__file__).resolve().parents[1]
JAX_RESTART = (REPO / "validation_runs" / "persist" / "mismipplus_5km_spinup"
               / "restart_ANT_00001.nc")
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# tests/test_restart.py's Halfar dome (SIA) with thermodynamics off, f64
HALFAR = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="Halfar",
    dx_refgeo_init_idealised=50e3,
    refgeo_idealised_Halfar_H0=3000.0, refgeo_idealised_Halfar_R0=500e3,
    uniform_Glens_flow_factor=1e-16, choice_ice_rheology_Glen="uniform",
    choice_stress_balance_approximation="SIA",
    choice_sliding_law="no_sliding", choice_thermo_model="none",
    xmin_ANT=-750e3, xmax_ANT=750e3, ymin_ANT=-750e3, ymax_ANT=750e3,
    maximum_resolution_uniform=150e3, maximum_resolution_grounded_ice=150e3,
    maximum_resolution_ice_front=100e3, ice_front_width=100e3,
    start_time_of_run=0.0, end_time_of_run=40.0, nit_Lloyds_algorithm=2,
    refgeo_Hi_min=2.0, tpu_precision="f64", dt_output_restart=10.0,
    dt_output=10.0)
# the chip_smoke.py resume of the MISMIP+ spin-up in f64, with the
# viscosity loop cut to 3 iterations and the PC corrector to 2 (as the
# CPU tests' other MISMIP+ configurations) to keep the CPU time short;
# both packages take the same cut
MP = dict(chip_smoke.MP_RESUME, tpu_precision="f64", visc_it_nit=3,
          pc_nit_max=2, dt_output=1000.0, dt_output_restart=1000.0)
# two ice steps at dt 0.1, the first with the resume's cold viscosity
# loop: from the third step on, thin ice on the side walls crosses the
# Hi_min removal threshold at a few vertices, where any two roundings part
# (chip_smoke.py mismipplus_resume measures it)
MP_T_END = 11425.25


def _leaves_equal(a, b):
    for name, v in _state_leaves(a).items():
        w = _state_leaves(b)[name]
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), name
        else:
            assert v == w, name


@pytest.fixture(scope="module")
def halfar(tmp_path_factory):
    """An uninterrupted 0 -> 40 yr run that writes its restarts, and the
    restart at 20 yr kept aside."""
    d = tmp_path_factory.mktemp("halfar")
    C = Config(**HALFAR)
    r = ModelRegion(C, "ANT", device="cpu", output_dir=str(d / "run"))
    r.run_to(20.0)
    mid = d / "restart_t20.nc"
    shutil.copy(d / "run" / "restart_ANT_00001.nc", mid)
    n_mid, state_mid = r.n_dt_ice, r.state
    r.run_to(40.0)
    return C, r, mid, n_mid, state_mid


def test_resume_matches_uninterrupted(halfar):
    """A fresh region on the restart's mesh, resumed at 20 yr and run to
    40 yr, equals the uninterrupted run to the bit (the resume contract
    of tests/test_restart.py:60, there within 1e-6)."""
    C, r, mid, _, state_mid = halfar
    r2 = ModelRegion(C, "ANT", mesh=mesh_from_restart(mid, C), device="cpu")
    r2.resume_from_restart(mid)
    assert r2.time == 20.0
    _leaves_equal(r2.state, state_mid)
    r2.run_to(40.0)
    assert r2.n_dt_ice == r.n_dt_ice
    _leaves_equal(r2.state, r.state)


def test_host_counters_survive_the_resume(halfar, tmp_path):
    C, r, mid, n_mid, _ = halfar
    assert load_restart_host_counters(mid) == {"n_dt_ice": n_mid} \
        and n_mid > 0
    r2 = ModelRegion(C, "ANT", mesh=r.mesh, device="cpu")
    r2.resume_from_restart(mid)
    assert r2.n_dt_ice == n_mid
    r2.run_to(30.0)
    assert r2.n_dt_ice > n_mid


def test_pc_initialise_read_from_file(halfar, tmp_path):
    """pc_choice_initialise 'read_from_file' warm-starts the dt controller
    from a restart, and only the controller."""
    C, r, _, _, _ = halfar
    path = tmp_path / "pc.nc"
    write_restart_file(path, r.mesh, r.state, r.time)
    C2 = Config(**dict(HALFAR, pc_choice_initialise_ANT="read_from_file",
                       filename_pc_initialise_ANT=str(path)))
    r2 = ModelRegion(C2, "ANT", mesh=r.mesh, device="cpu")
    pc, pc0 = r2.state.pc, r.state.pc
    assert (pc.dt_n, pc.dt_np1, pc.eta_n, pc.eta_np1) \
        == (pc0.dt_n, pc0.dt_np1, pc0.eta_n, pc0.eta_np1)
    assert torch.equal(pc.tau_np1, pc0.tau_np1)
    assert torch.equal(pc.dHi_dt_Hi_nm1_u_nm1, pc0.dHi_dt_Hi_nm1_u_nm1)
    assert r2.time == 0.0 and r2.state.dt_ice != pc0.dt_np1


def _jax_resume():
    Cj = JaxConfig(**MP)
    from ufemism2_tpu.io.ncio import NCFile
    with NCFile(JAX_RESTART) as nc:
        V = np.asarray(nc.read("V"))
        Tri = np.asarray(nc.read("Tri")).astype(np.int64) - 1
    mesh = jax_mesh(V, Cj.xmin_ANT, Cj.xmax_ANT, Cj.ymin_ANT, Cj.ymax_ANT,
                    nz=Cj.nz, choice_zeta_grid=Cj.choice_zeta_grid,
                    zeta_irregular_log_R=Cj.zeta_irregular_log_R, Tri=Tri)
    jax_lonlat(mesh, Cj, "ANT")
    r = JaxRegion(Cj, "ANT", mesh=mesh)
    import jax.numpy as jnp
    e = r.md.extras["glen_A_scale"]
    e.arr = jnp.asarray(chip_smoke.MP_GLEN_A_SCALE, e.arr.dtype)
    r.resume_from_restart(str(JAX_RESTART))
    return r


def test_mismipplus_5km_resume_matches_jax():
    """The MISMIP+ 5 km spin-up resumed at t = 11,425 with glen_A_scale
    0.34: the port from the committed classic copy, the JAX package from
    its NetCDF4 original; two ice steps with the same dt trajectory and
    counts, fields to 1e-10."""
    C = Config(**MP)
    mesh = mesh_from_restart(chip_smoke.MP_RESTART, C)
    assert (mesh.nV, mesh.nTri) == (632, 1134)
    rt = ModelRegion(C, "ANT", mesh=mesh, device="cpu")
    rt.md.extras["glen_A_scale"].arr = torch.tensor(
        chip_smoke.MP_GLEN_A_SCALE, dtype=torch.float64)
    rt.resume_from_restart(chip_smoke.MP_RESTART)
    rj = _jax_resume()
    assert np.array_equal(rt.mesh.V, rj.mesh.V)
    assert np.array_equal(rt.mesh.Tri, rj.mesh.Tri)
    assert rt.time == float(rj.time) == 11425.0
    assert rt.n_dt_ice == rj.n_dt_ice == 22017
    traj_t, traj_j = [], []
    for t in np.arange(11425.1, MP_T_END, 0.1):
        st, sj = rt.run_to(t), rj.run_to(t)
        traj_t.append((st.dt_ice, st.t_Hi_next, st.n_visc_its,
                       st.n_Axb_its))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next),
                       int(sj.n_visc_its), int(sj.n_Axb_its)))
    assert [x[2:] for x in traj_t] == [x[2:] for x in traj_j]
    assert np.allclose([x[:2] for x in traj_t], [x[:2] for x in traj_j],
                       rtol=1e-12, atol=0.0)
    assert rt.n_dt_ice == rj.n_dt_ice == 22017 + 2
    for name in ("Hi", "Hs", "u_vav_b", "v_vav_b", "u_3D_b", "fraction_gr",
                 "TAF"):
        gap = rel_gap(getattr(rt.state, name),
                      np.asarray(getattr(rj.state, name)))
        assert gap <= 1e-10, (name, gap)
