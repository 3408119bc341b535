"""The port's climate models and insolation (ufemism2_tpu_torch/models/
climate.py, insolation.py, utils/interp.py) against the JAX package's on
the same mesh, files and states, f64: every choice of the climate
dispatch but the matrix method (tests/test_torch_climate_matrix.py) -
none, idealised EISMINT1 A-F, realistic, snapshot_plus_uniform_deltaT and
snapshot_plus_transient_deltaT with and without the lapse-rate
downscaling, snapshot_plus_anomalies - insolation static and realistic,
and the port's `interp` against `jnp.interp` (to a few units in the last
place in f64 and f32).

The mesh: a uniform 30 km mesh on a 600 km square around the South Pole;
the files: seeded synthetic fields written by each package's NCFile
(tests/torch_port_fixture.py climate_files). The times reach inside,
between and beyond each series' ends. Tolerance 1e-12 relative to each
field's largest value (the same f64 arithmetic; the grid-to-mesh maps are
built on each side)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (climate_files, climate_state, configs,
                                polar_meshes, rel_gap)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.models import climate as jclim
from ufemism2_tpu.models.insolation import InsolationForcing as JaxInsol

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.models import climate as tclim
from ufemism2_tpu_torch.models.insolation import InsolationForcing
from ufemism2_tpu_torch.utils.interp import interp

TOL = 1e-12
TIMES = (-50.0, 0.0, 2.5, 7.3, 12.0, 25.0, 60.0)


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    e.mesh_j, e.mesh_t = polar_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    e.files = climate_files(tmp_path_factory.mktemp("climate"))
    e.states = [climate_state(e.mesh_t, np.random.default_rng(k), scale)
                for k, scale in ((1, 1.0), (2, 0.9))]
    return e


def config_pair(env, over, files=()):
    """(JAX config, port config), each naming its own package's files."""
    Cj, _ = configs(**over, **{k: env.files[v][0] for k, v in files})
    _, Ct = configs(**over, **{k: env.files[v][1] for k, v in files})
    return Cj, Ct


def compare(out_t, out_j, keys=("T2m", "Precip")):
    for k in keys:
        assert out_t[k].shape == tuple(out_j[k].shape), k
        gap = rel_gap(out_t[k], np.asarray(out_j[k]))
        assert gap <= TOL, (k, gap)


def runners(env, over, files=()):
    Cj, Ct = config_pair(env, over, files)
    return (jclim.make_run_climate(Cj, env.mdj, "ANT", mesh=env.mesh_j),
            tclim.make_run_climate(Ct, env.mdt, "ANT", mesh=env.mesh_t))


def test_none(env):
    rj, rt = runners(env, dict(choice_climate_model_ANT="none"))
    compare(rt(0.0), rj(0.0))


@pytest.mark.parametrize("exp", "ABCDEF")
def test_idealised_eismint1(env, exp):
    rj, rt = runners(env, dict(choice_climate_model_ANT="idealised",
                               choice_climate_model_idealised=f"EISMINT1_{exp}"))
    for t in (0.0, 3100.0, 17500.5):
        for sj, st in env.states:
            compare(rt(t, st), rj(t, sj))
    compare(rt(1000.0), rj(1000.0))      # no state: Hs = 0


SNAPSHOT_CHOICES = {
    "realistic": dict(choice_climate_model_realistic="snapshot"),
    "snapshot_plus_uniform_deltaT": dict(uniform_deltaT_ANT=-1.7),
    "snapshot_plus_transient_deltaT": dict(precip_CC_correction_ANT=1.068),
}


@pytest.mark.parametrize("lapse", (False, True))
@pytest.mark.parametrize("choice", sorted(SNAPSHOT_CHOICES))
def test_snapshot_climates(env, choice, lapse):
    over = dict(SNAPSHOT_CHOICES[choice], choice_climate_model_ANT=choice,
                do_lapse_rate_corrections_ANT=lapse, lapse_rate_temp_ANT=0.008)
    rj, rt = runners(env, over, (("filename_climate_snapshot_ANT",
                                  "snapshot"),
                                 ("filename_atmosphere_dT_ANT", "dT")))
    for t in TIMES:
        for sj, st in env.states:
            compare(rt(t, st), rj(t, sj))
    out = rt(12.0, env.states[0][1])
    if lapse:
        # the downscaling acts where the model's surface leaves the
        # snapshot's
        assert not torch.equal(out["T2m"], rt(12.0)["T2m"])


def test_snapshot_with_insolation(env):
    """With IMAU-ITM as the SMB, the snapshot climate adds the realistic
    insolation (Q_TOA) to its output."""
    over = dict(choice_climate_model_ANT="snapshot_plus_transient_deltaT",
                choice_SMB_model_ANT="IMAU-ITM",
                choice_insolation_forcing="realistic",
                start_time_of_run=0.0, end_time_of_run=30.0)
    rj, rt = runners(env, over, (("filename_climate_snapshot_ANT",
                                  "snapshot"),
                                 ("filename_atmosphere_dT_ANT", "dT"),
                                 ("filename_insolation", "insolation")))
    for t in TIMES:
        compare(rt(t, env.states[0][1]), rj(t, env.states[0][0]),
                ("T2m", "Precip", "Q_TOA"))
    with pytest.raises(ValueError, match="insolation"):
        runners(env, dict(over, choice_insolation_forcing="none"),
                (("filename_climate_snapshot_ANT", "snapshot"),
                 ("filename_atmosphere_dT_ANT", "dT")))


def test_snapshot_plus_anomalies(env):
    over = dict(choice_climate_model_ANT="snapshot_plus_anomalies")
    rj, rt = runners(env, over, (
        ("climate_snp_p_anml_filename_snapshot_ANT", "snapshot"),
        ("climate_snp_p_anml_filename_anomalies_ANT", "anomalies")))
    for t in TIMES:
        compare(rt(t), rj(t))
    # the anomalies' precipitation is clipped at zero
    assert float(rt(30.0)["Precip"].min()) >= 0.0


@pytest.mark.parametrize("choice", ("none", "static", "realistic"))
def test_insolation(env, choice):
    over = dict(choice_insolation_forcing=choice, static_insolation_time=-4.0,
                start_time_of_run=-20.0, end_time_of_run=30.0)
    Cj, Ct = config_pair(env, over, (("filename_insolation", "insolation"),))
    qj = JaxInsol(Cj, env.mesh_j, jnp.float64)
    qt = InsolationForcing(Ct, env.mesh_t, torch.float64, "cpu")
    for t in (-40000.0, -20.0, -5.0, -2.0, 0.0, 3.3, 10.0, 27.0, 1e6):
        gap = rel_gap(qt.at_time(t), np.asarray(qj.at_time(t)))
        assert gap <= TOL, (t, gap)
    if choice == "realistic":
        # the window: one frame below the start, one above the end
        assert qt._t.tolist() == [-21000.0, -5.0, 0.0, 10.0, 40.0]
        assert not torch.equal(qt.at_time(3.3), qt.at_time(0.0))


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_interp(dtype):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    rng = np.random.default_rng(5)
    xp = np.array([-3.0, -1.0, 0.0, 0.0, 2.5, 7.0])   # a repeated knot
    fp = rng.standard_normal(len(xp))
    txp, tfp = torch.tensor(xp, dtype=dtype), torch.tensor(fp, dtype=dtype)
    for x in (-10.0, -3.0, -2.2, -1.0, 0.0, 1e-9, 1.3, 2.5, 6.99, 7.0, 9.0):
        a = interp(x, txp, tfp)
        b = jnp.interp(jnp.asarray(x, jd), jnp.asarray(xp, jd),
                       jnp.asarray(fp, jd))
        assert a.dtype == dtype and a.shape == ()
        # a few units in the last place: XLA may contract the update into
        # a fused multiply-add
        eps = torch.finfo(dtype).eps
        assert abs(float(a) - float(b)) <= 4 * eps * max(1.0, abs(float(b))), \
            (x, float(a), float(b))
