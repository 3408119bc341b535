"""The slice as a whole: the port's `ModelRegion` against the JAX package's
on the MISMIP_mod DIVA fixture, in f64, on the identical mesh - the state
after the initial stress-balance solve and along `run_to` over several
ice steps - and one f32 run of the port.

Measured gaps in f64, the largest along 6 ice steps (this fixture, CPU):
Hi 6e-16, Hs 2e-16, u_vav_b and v_vav_b 5e-15, fraction_gr 2e-15 of the
field's largest value, with equal dt trajectories and equal n_visc_its
and n_Axb_its. Both sides do the same
f64 arithmetic and differ in summation order only; the tolerances are set
below ten times those gaps."""

import numpy as np
import pytest
import torch

from torch_port_fixture import configs, build_meshes, rel_gap

from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.main.region import ModelRegion

TOL = {"Hi": 5e-15, "Hs": 2e-15, "u_vav_b": 2e-14, "v_vav_b": 2e-14,
       "u_3D_b": 2e-14, "v_3D_b": 2e-14, "fraction_gr": 1e-14}
# f32 against f64 in the port after 4 ice steps: measured 1.2e-4 of max Hi
# (x rounded to bfloat16 in the physics matvecs, GMRES at rtol 1e-5)
F32_HI_TOL = 1e-3
# each run_to below ends inside a new prediction window, so each takes
# exactly one ice step (dt starts at 0.1 yr and grows by 10 % a step)
T_ENDS = (0.05, 0.15, 0.25, 0.35, 0.5, 0.6)


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = configs()
    e.mesh_j, e.mesh_t = build_meshes()
    e.rj = JaxRegion(e.Cj, "ANT", mesh=e.mesh_j)
    e.rt = ModelRegion(e.Ct, "ANT", mesh=e.mesh_t, device="cpu")
    return e


def _compare(st, sj):
    for name, tol in TOL.items():
        gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
        assert gap <= tol, f"{name}: {gap:.2e}"
    for name in ("mask_grounded_ice", "mask_floating_ice", "mask_gl_gr",
                 "mask_icefree_ocean", "mask_noice"):
        assert np.array_equal(getattr(st, name).numpy(),
                              np.asarray(getattr(sj, name))), name


def test_initial_state_and_forcing(env):
    """After construction: geometry, the initial DIVA solve from zero
    velocity, and the uniform component models."""
    st, sj = env.rt.state, env.rj.state
    assert st.Hi.dtype == torch.float64 and st.Hi.device.type == "cpu"
    assert float(st.u_vav_b.abs().max()) > 1.0           # a real solve
    _compare(st, sj)
    assert rel_gap(st.Ti, np.asarray(sj.Ti)) == 0.0
    assert rel_gap(st.bed_roughness, np.asarray(sj.bed_roughness)) == 0.0
    for name in ("SMB", "BMB", "LMB"):
        assert rel_gap(getattr(env.rt, name),
                       np.asarray(getattr(env.rj, name))) == 0.0
    assert rel_gap(env.rt.AMB, np.asarray(env.rj.AMB)) == 0.0
    assert env.rt.time == float(env.rj.time) == 0.0


def test_run_to_matches_jax(env):
    """The dt trajectory, the thickness, the velocities and the solver
    counts over six ice steps."""
    traj_t, traj_j = [], []
    for t_end in T_ENDS:
        st = env.rt.run_to(t_end)
        sj = env.rj.run_to(t_end)
        traj_t.append((st.dt_ice, st.t_Hi_next))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next)))
        _compare(st, sj)
        assert st.n_visc_its == int(sj.n_visc_its)
        assert st.n_Axb_its == int(sj.n_Axb_its)
    assert env.rt.n_dt_ice == env.rj.n_dt_ice == len(T_ENDS) >= 3
    assert np.allclose(traj_t, traj_j, rtol=1e-12, atol=0.0), \
        (traj_t, traj_j)
    dts = [dt for dt, _ in traj_t]
    assert dts[0] == pytest.approx(env.Ct.dt_ice_min) and dts[-1] > dts[0]
    assert env.rt.time == float(env.rj.time) == T_ENDS[-1]
    st = env.rt.state
    assert st.n_visc_its > 0 and st.n_Axb_its > 0
    # time bookkeeping stays on the host in f64
    assert isinstance(st.t_Hi_next, float) and isinstance(st.dt_ice, float)


def test_f32_run(env):
    """Performance mode: f32 fields, f64 time bookkeeping; finite, solved,
    and close to the f64 run."""
    _, C32 = configs(tpu_precision="f32")
    _, C64 = configs()
    r32 = ModelRegion(C32, "ANT", mesh=env.mesh_t, device="cpu")
    r64 = ModelRegion(C64, "ANT", mesh=env.mesh_t, device="cpu")
    s32, s64 = r32.run_to(0.35), r64.run_to(0.35)
    assert s32.Hi.dtype == s32.u_vav_b.dtype == torch.float32
    assert r32.md.M2_stack.vals.dtype == torch.float32
    assert isinstance(s32.t_Hi_next, float)
    for name in ("Hi", "Hs", "u_vav_b", "v_vav_b", "u_3D_b", "dHi_dt"):
        assert bool(torch.isfinite(getattr(s32, name)).all()), name
    assert s32.n_Axb_its > 0 and s32.n_visc_its > 0
    assert r32.n_dt_ice == r64.n_dt_ice >= 3
    assert float((s32.Hi * r32.md.A).sum()) > 0.0
    gap = rel_gap(s32.Hi.double(), s64.Hi.numpy())
    assert gap <= F32_HI_TOL, gap


def test_default_device_is_the_card(env):
    """Without `device=` the region runs on the card; without a card it
    raises and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        ModelRegion(env.Ct, "ANT", mesh=env.mesh_t)


@pytest.mark.parametrize("over, word", [
    (dict(choice_GIA_model="Lingle"), "choice_GIA_model"),
    (dict(choice_sealevel_model="SELEN"), "choice_sealevel_model"),
    (dict(choice_tracer_tracking_model="ages"),
     "choice_tracer_tracking_model"),
    (dict(pc_choice_initialise_ANT="analytical"), "pc_choice_initialise"),
    (dict(choice_BMB_model_ANT="laddie_py"), "choice_BMB_model"),
    (dict(choice_GIA_model="SELEN"), "choice_GIA_model"),
    (dict(choice_initial_velocity_ANT="read_from_file"),
     "choice_initial_velocity"),
    (dict(tpu_n_devices=4), "tpu_n_devices"),
])
def test_unported_choices_raise_by_name(env, over, word):
    _, Ct = configs(**over)
    with pytest.raises(NotImplementedError, match=word):
        ModelRegion(Ct, "ANT", mesh=env.mesh_t, device="cpu")


def test_transect_output_matches_jax(env, tmp_path):
    """transects_ANT: two transects' output files, written at every output
    event of a run with an output directory, against the JAX package's
    (read back through the port's ncio; the JAX package's time and zeta are
    HDF5 dimension scales there)."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    over = dict(transects_ANT="westeast,dx=20e3||southnorth,dx=30e3",
                dt_output=0.15)
    Cj, Ct = configs(**over)
    rj = JaxRegion(Cj, "ANT", mesh=env.mesh_j, output_dir=str(tmp_path / "j"))
    rt = ModelRegion(Ct, "ANT", mesh=env.mesh_t, device="cpu",
                     output_dir=str(tmp_path / "t"))
    rj.run_to(0.35)
    rt.run_to(0.35)
    for tr in rj.transect_out:
        tr.close()
    for name in ("westeast", "southnorth"):
        a = NCFile(tmp_path / "t" / f"transect_{name}.nc")
        b = NCFile(tmp_path / "j" / f"transect_{name}.nc")
        assert a.dims()["time"] == b.dims()["time"] == 3   # 0, 0.15, 0.3
        assert sorted(a.variables()) == sorted(b.variables()
                                               + ["time", "zeta"])
        for v in a.variables():
            va, vb = a.read(v), b.read(v)
            nan = np.isnan(vb)
            assert np.array_equal(np.isnan(va), nan), v
            if (~nan).any():
                assert np.abs(va[~nan] - vb[~nan]).max() <= 1e-12 * max(
                    1.0, np.abs(vb[~nan]).max()), v
        gl = a.read("grounding_line_distance_from_start")
        assert np.isfinite(gl).all() and (gl > 0).all(), gl
