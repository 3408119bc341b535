"""The port's IMAU-ITM SMB and SMB snapshot_plus_anomalies
(ufemism2_tpu_torch/models/smb.py) against the JAX package's, f64:

- imau_itm_step on random climates, insolation, masks and carried state
  (the twelve months in order, each reading the month before's firn);
- ImauItmSMB over three model years, with each firn initialisation
  (uniform; read_from_file, whose file name the schema does not define, so
  both packages read it from the configuration object's attribute), its
  state carried across a map to another mesh (carry_state_from), and a
  port runner started from a JAX runner's state through
  convert.component_state_from_numpy; the calls counted on both sides;
- snapshot_plus_anomalies at times inside, between and beyond the
  anomalies' frames; 'reconstructed' raises by name.

The mesh: a uniform 30 km mesh on a 600 km square around the South Pole;
tolerance 1e-12 relative."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (ConfigWith, climate_files, climate_state,
                                configs, polar_meshes, rel_gap, write_nc_pair)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.models import climate as jclim, smb as jsmb

from ufemism2_tpu_torch.convert import component_state_from_numpy
from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.models import climate as tclim, smb as tsmb

TOL = 1e-12
STATE = ("FirnDepth", "MeltPreviousYear", "Albedo")


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    d = tmp_path_factory.mktemp("smb_itm")
    e.mesh_j, e.mesh_t = polar_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    e.files = climate_files(d)
    x = np.linspace(-350e3, 350e3, 15)
    X, Y = np.meshgrid(x, x, indexing="ij")
    firn = (1.5 + np.hypot(X, Y)[None] / 2e5
            + 0.1 * np.arange(12.0)[:, None, None])
    e.files["firn"] = write_nc_pair(d, "firn", {"x": 15, "y": 15,
                                                "month": 12}, {
        "x": (("x",), x), "y": (("y",), x),
        "month": (("month",), np.arange(1.0, 13.0)),
        "FirnDepth": (("month", "x", "y"), firn)})
    e.states = [climate_state(e.mesh_t, np.random.default_rng(k), scale)
                for k, scale in ((21, 1.0), (22, 0.85), (23, 1.05))]
    return e


def close(a, b, tol=TOL):
    gap = rel_gap(a, np.asarray(b))
    assert gap <= tol, gap


def test_imau_itm_step(env):
    rng = np.random.default_rng(7)
    Cj, Ct = configs()
    pj, pt = jsmb.imau_itm_params(Cj, "ANT"), tsmb.imau_itm_params(Ct, "ANT")
    assert pj == pt
    n = env.mesh_t.nV
    for _ in range(4):
        f = dict(T2m=255.0 + 25.0 * rng.random((n, 12)),
                 Precip=0.2 * rng.random((n, 12)),
                 Q_TOA=500.0 * rng.random((n, 12)),
                 firn=np.clip(rng.normal(1.0, 2.0, (n, 12)), 0.0, 10.0),
                 melt=0.3 * rng.random(n))
        m = {k: rng.random(n) < p for k, p in (
            ("mask_icefree_ocean", 0.3), ("mask_floating_ice", 0.2),
            ("mask_grounded_ice", 0.4))}
        noice = rng.random(n) < 0.1
        SMBj, auxj = jsmb.imau_itm_step(
            pj, *(jnp.asarray(f[k]) for k in ("T2m", "Precip", "Q_TOA")),
            {k: jnp.asarray(v) for k, v in m.items()}, jnp.asarray(noice),
            jnp.asarray(f["firn"]), jnp.asarray(f["melt"]))
        SMBt, auxt = tsmb.imau_itm_step(
            pt, *(torch.from_numpy(f[k]) for k in ("T2m", "Precip", "Q_TOA")),
            {k: torch.from_numpy(v) for k, v in m.items()},
            torch.from_numpy(noice), torch.from_numpy(f["firn"]),
            torch.from_numpy(f["melt"]))
        close(SMBt, SMBj)
        for k in STATE + ("SMB_monthly",):
            close(auxt[k], auxj[k])


def itm_pair(env, init="uniform", mdj=None, mdt=None, mesh_j=None,
             mesh_t=None):
    """(JAX climate, JAX SMB, port climate, port SMB): the transient
    snapshot climate with the realistic insolation, and IMAU-ITM."""
    over = dict(choice_climate_model_ANT="snapshot_plus_transient_deltaT",
                choice_SMB_model_ANT="IMAU-ITM",
                choice_insolation_forcing="realistic",
                choice_SMB_IMAUITM_init_firn_ANT=init,
                start_time_of_run=0.0, end_time_of_run=30.0)
    names = dict(filename_climate_snapshot_ANT="snapshot",
                 filename_atmosphere_dT_ANT="dT",
                 filename_insolation="insolation")
    Cj, _ = configs(**over, **{k: env.files[v][0] for k, v in names.items()})
    _, Ct = configs(**over, **{k: env.files[v][1] for k, v in names.items()})
    Cj = ConfigWith(Cj, filename_SMB_IMAUITM_init_firn_ANT=env.files[
        "firn"][0])
    Ct = ConfigWith(Ct, filename_SMB_IMAUITM_init_firn_ANT=env.files[
        "firn"][1])
    mdj, mdt = mdj or env.mdj, mdt or env.mdt
    mesh_j, mesh_t = mesh_j or env.mesh_j, mesh_t or env.mesh_t
    return (jclim.make_run_climate(Cj, mdj, "ANT", mesh=mesh_j),
            jsmb.make_run_smb(Cj, mdj, "ANT"),
            tclim.make_run_climate(Ct, mdt, "ANT", mesh=mesh_t),
            tsmb.make_run_smb(Ct, mdt, "ANT"))


def run_years(cj, sj_run, ct, st_run, states, t0):
    for k, (sj, st) in enumerate(states):
        t = t0 + k
        SMBj = sj_run(t, sj, climate=cj(t, sj))
        SMBt = st_run(t, st, climate=ct(t, st))
        close(SMBt, SMBj)
        for name in STATE:
            close(getattr(st_run, name), getattr(sj_run, name))


@pytest.mark.parametrize("init", ("uniform", "read_from_file"))
def test_imau_itm_three_years(env, init):
    cj, sj_run, ct, st_run = itm_pair(env, init)
    close(st_run.FirnDepth, sj_run.FirnDepth)
    if init == "read_from_file":
        assert float(st_run.FirnDepth.std()) > 0.0
    run_years(cj, sj_run, ct, st_run, env.states, 1.5)
    assert st_run.calls == 3


def test_imau_itm_needs_insolation(env):
    _, _, ct, st_run = itm_pair(env)
    st = env.states[0][1]
    with pytest.raises(ValueError, match="Q_TOA"):
        st_run(0.0, st, climate={k: v for k, v in ct(0.0, st).items()
                                 if k != "Q_TOA"})
    with pytest.raises(ValueError):
        itm_pair(env, "nowhere")


def test_imau_itm_carry_and_convert(env):
    """Two years on one mesh, the state mapped to another mesh by each
    package's runner; a third year there. Then a fresh port runner takes
    the JAX runner's state through component_state_from_numpy and both go
    on alike."""
    from ufemism2_tpu.mesh import build_uniform_mesh
    from ufemism2_tpu.mesh.projections import inverse_oblique_sg_projection
    from ufemism2_tpu.remap.atlas import get_map
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    from torch_port_fixture import mesh_to_numpy
    cj, sj_run, ct, st_run = itm_pair(env)
    run_years(cj, sj_run, ct, st_run, env.states[:2], 0.0)
    new_j = build_uniform_mesh(-300e3, 300e3, -300e3, 300e3, 45e3)
    new_j.proj = env.mesh_j.proj
    new_j.lon, new_j.lat = inverse_oblique_sg_projection(
        new_j.V[:, 0], new_j.V[:, 1], *new_j.proj)
    new_t = mesh_from_numpy(mesh_to_numpy(new_j))
    M = get_map(env.mesh_j, new_j, method="trilin")
    mdj2 = jmd.build_mesh_data(new_j)
    mdt2 = tmd.build_mesh_data(new_t, dtype=torch.float64, device="cpu")
    cj2, sj2, ct2, st2 = itm_pair(env, mdj=mdj2, mdt=mdt2, mesh_j=new_j,
                                  mesh_t=new_t)
    sj2.carry_state_from(sj_run, lambda a: jnp.asarray(M @ np.asarray(a)))
    st2.carry_state_from(st_run, lambda a: torch.from_numpy(M @ a.numpy()))
    assert st2.calls == 2
    for name in STATE:
        close(getattr(st2, name), getattr(sj2, name))
    states2 = [climate_state(new_t, np.random.default_rng(31))]
    run_years(cj2, sj2, ct2, st2, states2, 2.0)
    # a fresh port runner on the first mesh, started from the JAX runner
    _, _, ct3, st3 = itm_pair(env)
    component_state_from_numpy(
        SimpleNamespace(run_smb=st3),
        {"SMB_IMAU_ITM": {k: np.asarray(getattr(sj_run, k))
                          for k in STATE}}, "cpu", torch.float64)
    run_years(cj, sj_run, ct3, st3, env.states[2:], 3.0)
    with pytest.raises(ValueError):
        component_state_from_numpy(
            SimpleNamespace(run_smb=st3), {"SMB_IMAU_ITM": {"calls": 1}},
            "cpu", torch.float64)


def test_smb_snapshot_plus_anomalies(env):
    over = dict(choice_SMB_model_ANT="snapshot_plus_anomalies")
    Cj, _ = configs(**over,
                    SMB_snp_p_anml_filename_snapshot_SMB=env.files["SMB"][0],
                    SMB_snp_p_anml_filename_anomalies=env.files[
                        "SMB_anomalies"][0])
    _, Ct = configs(**over,
                    SMB_snp_p_anml_filename_snapshot_SMB=env.files["SMB"][1],
                    SMB_snp_p_anml_filename_anomalies=env.files[
                        "SMB_anomalies"][1])
    rj = jsmb.make_run_smb(Cj, env.mdj, "ANT")
    rt = tsmb.make_run_smb(Ct, env.mdt, "ANT")
    for t in (-5.0, 0.0, 4.0, 10.0, 17.5, 30.0, 99.0):
        close(rt(t), rj(t))
    assert not torch.equal(rt(0.0), rt(30.0))


def test_reconstructed_refused(env):
    _, Ct = configs(choice_SMB_model_ANT="reconstructed")
    with pytest.raises(NotImplementedError, match="ROI"):
        tsmb.make_run_smb(Ct, env.mdt, "ANT")
