"""The port's matrix climate (ufemism2_tpu_torch/models/climate_matrix.py)
against the JAX package's (Berends et al. 2018) on the same mesh, files
and states: ANT (Clausius-Clapeyron precipitation, constant lapse rate)
and NAM (Roe & Lindzen precipitation, the spatially variable lapse rate),
f64, through set-up (bias correction, lapse rates, the ten-year I_abs
spin-up of each snapshot) and four calls, each of which advances the
carried albedo state a year, with a carry of that state across a map to
another mesh and into a fresh runner through
convert.component_state_from_numpy; the same number of calls on both
sides.

The reference's floors of 1e-300 round to 0 in f32: with the warm
snapshot's precipitation 0 on part of the grid and both precipitation
weights near one half, the f32 runs of both packages give P_ref exactly 0
there (log 0 = -inf), where the port's f64 keeps the floor's tiny
positive power of it. The port's f32 precipitation equals the JAX
package's f32 at those vertices, and elsewhere is within 1e-4 of its
largest value (measured 6.2e-7: the f32 rounding of exp, log and the CC
correction's powers). The f32 temperature is held within 1e-5 (measured
1.1e-7): its insolation weight divides by the difference of two f32 sums
of absorbed insolation over the mesh (the warm orbit's and the cold
orbit's, 11 % apart here), which the two packages sum in other orders, so
their rounding is amplified by the ratio of the sum to that difference.
How small the difference becomes when an orbit lies outside the run's
window: test_matrix_orbit_frames_clamped.

Small: a 30 km mesh on a 600 km square, so that the test runs in the
tier-1 suite (the JAX package's own matrix test is marked slow). f64
tolerance 1e-12 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (climate_files, climate_state, configs,
                                polar_meshes, rel_gap)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.models import climate_matrix as jcm

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.models import climate_matrix as tcm

TOL = 1e-12
KEYS = ("T2m", "Precip", "Q_TOA", "Wind_LR", "Wind_DU")
STATE = ("_firn", "_melt_yr", "_albedo", "_T2m", "_Precip")


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    e.mesh_j, e.mesh_t = polar_meshes()
    e.files = climate_files(tmp_path_factory.mktemp("matrix"))
    e.files0 = climate_files(tmp_path_factory.mktemp("matrix0"),
                             zero_precip=True)
    e.states = [climate_state(e.mesh_t, np.random.default_rng(k), scale)
                for k, scale in ((11, 1.0), (12, 1.1), (13, 0.95))]
    return e


def matrix_pair(env, region, dtype, files, **over):
    kw = dict(dict(choice_climate_model_ANT="matrix",
                   choice_matrix_forcing="CO2_direct",
                   choice_insolation_forcing="realistic",
                   start_time_of_run=-25000.0, end_time_of_run=50.0,
                   climate_matrix_warm_orbit_time=0.0,
                   climate_matrix_cold_orbit_time=-21000.0,
                   tpu_precision="f32" if dtype == torch.float32 else "f64"),
              **over)
    names = dict(climate_matrix_filename_PD_obs_climate="PD",
                 climate_matrix_filename_climate_snapshot_PI="PI",
                 climate_matrix_filename_climate_snapshot_warm="warm",
                 climate_matrix_filename_climate_snapshot_cold="cold",
                 filename_CO2_record="CO2", filename_insolation="insolation")
    Cj, _ = configs(**kw, **{k: files[v][0] for k, v in names.items()})
    _, Ct = configs(**kw, **{k: files[v][1] for k, v in names.items()})
    mdj = jmd.build_mesh_data(env.mesh_j,
                              dtype=jnp.float32 if dtype == torch.float32
                              else jnp.float64)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=dtype, device="cpu")
    return (jcm.MatrixClimate(Cj, mdj, region, env.mesh_j),
            tcm.MatrixClimate(Ct, mdt, region, env.mesh_t))


def cast(s, dtype):
    from types import SimpleNamespace
    if isinstance(s.Hi, torch.Tensor):
        return SimpleNamespace(**{k: v.to(dtype) for k, v in vars(s).items()})
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    return SimpleNamespace(**{k: v.astype(jd) for k, v in vars(s).items()})


def close(a, b, tol=TOL):
    gap = rel_gap(a, np.asarray(b))
    assert gap <= tol, gap


@pytest.fixture(scope="module")
def ant64(env):
    """The ANT pair in f64 with both bias corrections, shared by the tests
    below in their order (each advances both sides alike)."""
    return matrix_pair(env, "ANT", torch.float64, env.files,
                       climate_matrix_biascorrect_warm=True,
                       climate_matrix_biascorrect_cold=True)


@pytest.mark.parametrize("region", ("ANT", "NAM"))
def test_matrix_climate(env, ant64, region):
    mj, mt = ant64 if region == "ANT" else matrix_pair(
        env, region, torch.float64, env.files,
        climate_matrix_biascorrect_warm=True,
        climate_matrix_biascorrect_cold=True)
    for snap in ("warm", "cold"):
        for k in ("T2m", "Precip", "Hs", "lambda", "I_abs", "Wind_LR",
                  "Wind_DU"):
            close(getattr(mt, snap)[k], getattr(mj, snap)[k])
    if region == "NAM":
        # the spatially variable lapse rate
        assert float(mt.cold["lambda"].std()) > 0.0
    n0 = mt.calls
    for t, (sj, st) in zip((-21000.0, -3.0, 12.5, 49.0),
                           env.states + env.states[:1]):
        oj, ot = mj(t, sj), mt(t, st)
        for k in KEYS:
            close(ot[k], oj[k])
        for k in STATE:
            close(getattr(mt, k), getattr(mj, k))
    assert mt.calls == n0 + 4
    assert float(ot["Precip"].min()) >= 0.0


def test_matrix_glacial_index_precip(env):
    mj, mt = matrix_pair(env, "ANT", torch.float64, env.files,
                         climate_matrix_switch_glacial_index_precip=True)
    for t in (-21000.0, 0.0):
        oj, ot = mj(t, env.states[0][0]), mt(t, env.states[0][1])
        for k in KEYS:
            close(ot[k], oj[k])


def test_matrix_carry_state(env, ant64):
    """The carried albedo state and last climate taken over through a map
    to another mesh (the region's remesh), on both sides."""
    from ufemism2_tpu.mesh import build_uniform_mesh
    from ufemism2_tpu.mesh.projections import inverse_oblique_sg_projection
    from ufemism2_tpu.remap.atlas import get_map
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    from torch_port_fixture import mesh_to_numpy
    mj, mt = ant64
    mj(0.0, env.states[0][0])
    mt(0.0, env.states[0][1])
    new_j = build_uniform_mesh(-300e3, 300e3, -300e3, 300e3, 45e3)
    new_j.proj = env.mesh_j.proj
    new_j.lon, new_j.lat = inverse_oblique_sg_projection(
        new_j.V[:, 0], new_j.V[:, 1], *new_j.proj)
    M = get_map(env.mesh_j, new_j, method="trilin")
    env2 = Env()
    env2.mesh_j, env2.mesh_t = new_j, mesh_from_numpy(mesh_to_numpy(new_j))
    nj, nt = matrix_pair(env2, "ANT", torch.float64, env.files)
    nj.carry_state_from(mj, lambda a: jnp.asarray(M @ np.asarray(a)))
    nt.carry_state_from(mt, lambda a: torch.from_numpy(M @ a.numpy()))
    for k in STATE:
        close(getattr(nt, k), getattr(nj, k))
    assert nt.calls == mt.calls
    sj, st = climate_state(env2.mesh_t, np.random.default_rng(3))
    oj, ot = nj(5.0, sj), nt(5.0, st)
    for k in KEYS:
        close(ot[k], oj[k])


def test_matrix_state_through_convert(env, ant64):
    """A fresh port runner takes the JAX runner's carried state through
    convert.component_state_from_numpy; both then go on alike."""
    from types import SimpleNamespace
    from ufemism2_tpu_torch.convert import component_state_from_numpy
    mj, _ = ant64
    mt = matrix_pair(env, "ANT", torch.float64, env.files,
                     climate_matrix_biascorrect_warm=True,
                     climate_matrix_biascorrect_cold=True)[1]
    component_state_from_numpy(
        SimpleNamespace(run_climate=mt),
        {"climate_matrix": {k: np.asarray(getattr(mj, k)) for k in STATE}},
        "cpu", torch.float64)
    for t, (sj, st) in zip((7.0, 8.0), env.states[1:]):
        oj, ot = mj(t, sj), mt(t, st)
        for k in KEYS:
            close(ot[k], oj[k])
    with pytest.raises(ValueError):
        component_state_from_numpy(SimpleNamespace(run_climate=mt),
                                   {"climate_matrix": {"PD_obs": 0.0}},
                                   "cpu", torch.float64)


def test_matrix_f32_floor(env):
    """f32: the 1e-300 floors are 0 on both sides (see the module
    docstring); the port's f64 keeps them."""
    assert tcm.floor_at(torch.zeros(3, dtype=torch.float32), 1e-300).eq(
        0.0).all()
    assert tcm.floor_at(torch.zeros(3, dtype=torch.float64), 1e-300).eq(
        1e-300).all()
    mj, mt = matrix_pair(env, "ANT", torch.float32, env.files0)
    mt64 = matrix_pair(env, "ANT", torch.float64, env.files0)[1]
    # a surface between the warm and the cold snapshot's, so that both
    # precipitation weights are near one half
    sj, st = env.states[0]
    Hs = 0.5 * (mt64.warm["Hs"] + mt64.cold["Hs"])
    st = cast(st, torch.float64)
    st.Hs = Hs
    sj = cast(sj, torch.float64)
    sj.Hs = jnp.asarray(Hs.numpy())
    oj32, ot32 = mj(0.0, cast(sj, torch.float32)), mt(0.0, cast(st,
                                                                torch.float32))
    ot64 = mt64(0.0, st)
    zero = np.asarray(oj32["Precip"]) == 0.0
    assert zero.any() and not zero.all()
    assert (ot32["Precip"].numpy()[zero] == 0.0).all()
    assert (ot64["Precip"].numpy()[zero] > 0.0).all()
    close(ot32["Precip"], oj32["Precip"], 1e-4)
    close(ot32["T2m"], oj32["T2m"], 1e-5)


def test_matrix_orbit_frames_clamped(env, ant64):
    """Which insolation frame each orbit reads. The JAX package preloads
    only the frames of the run's window (min(start, 0) to end, and one
    frame either side) and clamps every time to them (ufemism2_tpu/models/
    insolation.py at_time); the reference re-reads the file at the orbit
    time. The port copies the clamp for parity (ROADMAP.md C). With the run
    starting at 0, the cold orbit (-21000) reads the -5 frame, whose annual
    mean is the warm orbit's, and not the -21000 frame: the insolation
    weight of the matrix climate then divides by what the seasonal
    amplitude and the two snapshots' albedo leave of the difference
    between the warm and the cold absorbed insolation, a fraction of the
    difference between the orbits (ant64, whose window starts before
    -21000, reads that frame). Here that is nothing at all: the snapshots
    are cold enough that the ten-year spin-up leaves the albedo of snow
    everywhere, so equal annual means give equal absorbed insolation (0
    against 3.0e-2 of the warm orbit's with the -21000 frame), and both
    packages fall back on the weight's guard alike."""
    from ufemism2_tpu_torch.io.input_files import \
        read_field_from_file_2D_monthly
    mj, mt = matrix_pair(env, "ANT", torch.float64, env.files,
                         start_time_of_run=0.0,
                         climate_matrix_biascorrect_warm=True,
                         climate_matrix_biascorrect_cold=True)
    frame = {t: torch.from_numpy(read_field_from_file_2D_monthly(
        env.files["insolation"][1], "insolation", env.mesh_t,
        time_to_read=t)) for t in (-5.0, -21000.0)}
    assert mt.insol._t.tolist() == [-5.0, 0.0, 10.0, 40.0]
    cold_read = mt.insol.at_time(-21000.0)
    assert torch.equal(cold_read, frame[-5.0])
    assert rel_gap(cold_read, frame[-21000.0].numpy()) > 0.01
    close(cold_read, mj.insol.at_time(-21000.0))
    close(ant64[1].insol.at_time(-21000.0), frame[-21000.0])
    for snap in ("warm", "cold"):
        close(getattr(mt, snap)["I_abs"], getattr(mj, snap)["I_abs"])

    def apart(m):
        w, c = m.warm["I_abs"].sum(), m.cold["I_abs"].sum()
        return float((w - c).abs() / w)
    clamped, read = apart(mt), apart(ant64[1])
    assert clamped < read / 3.0, (clamped, read)
    oj, ot = mj(0.0, env.states[0][0]), mt(0.0, env.states[0][1])
    for k in KEYS:
        close(ot[k], oj[k])
