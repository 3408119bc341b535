"""The port's BMB and ocean models (ufemism2_tpu_torch/models/bmb.py,
ocean.py) against the JAX package's on the 40 km MISMIP+ mesh, f64: every
BMB choice (uniform, idealised uniform and MISMIP+ ice1r melt, prescribed,
prescribed_fixed, Favier2019 under each idealised ocean, inverted over
several calls) with each grounding-line scheme, every ocean choice (none,
the ISOMIP+ and MISMIP+ WARM/COLD profiles, TANH, LINEAR,
LINEAR_THERMOCLINE, the realistic snapshot with and without a uniform or
transient deltaT, snapshot plus anomalies, snapshot+nudge2D over several
calls and across a mesh change), the cavity extrapolation and the freezing
point.

The state: 700 m of ice on the MISMIP+ bed (a grounded sheet, a floating
shelf with a cavity), seeded thinning rates and b-grid grounded
fractions. The snapshot files are written by each package's NCFile with
NaN below a sloping sea floor, so the extrapolation fills them.
Tolerance 1e-12 relative (the same f64 arithmetic; the file maps are
built on each side)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (build_meshes_for, mismipplus_configs,
                                rel_gap, write_nc_pair,
                                ocean_snapshot_spec as snapshot_spec)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import masks as jmasks, subgrid as jsub
from ufemism2_tpu.core.idealised_geometries import calc_idealised_geometry
from ufemism2_tpu.models import bmb as jbmb, ocean as joc
from ufemism2_tpu.remap.atlas import get_map as jax_get_map

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import masks as tmasks, subgrid as tsub
from ufemism2_tpu_torch.models import bmb as tbmb, ocean as toc
from ufemism2_tpu_torch.remap.atlas import get_map as port_get_map

TOL = 1e-12
OCEAN_FIELDS = ("T", "S", "T_draft", "S_draft", "T_freezing_point")


class Env:
    pass


def state_pair(mesh, md_j, md_t, rng, Hi_scale=1.0):
    """(JAX state, port state, JAX masks, port masks, JAX fg, port fg)."""
    V = mesh.V
    Hi, Hb, _, SL = calc_idealised_geometry(V[:, 0], V[:, 1], "MISMIP+",
                                            mismipplus_configs()[0])
    Hi = np.where(V[:, 0] < 640e3, 700.0 * Hi_scale
                  + 20.0 * rng.standard_normal(len(V)), 0.0)
    SL = np.zeros_like(Hi)
    Hs = Hi + np.maximum(SL - 917.0 / 1027.0 * Hi, Hb)
    f = dict(Hi=Hi, Hb=Hb, SL=SL, Hs=Hs, Hib=Hs - Hi,
             dHi_dt=rng.standard_normal(len(V)),
             fraction_gr_b=np.clip(rng.random(mesh.nTri) * 1.4 - 0.2,
                                   0.0, 1.0))
    sj = {k: jnp.asarray(v) for k, v in f.items()}
    st = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in f.items()}
    mj = jmasks.determine_masks(md_j, sj["Hi"], sj["Hb"], sj["SL"])
    mt = tmasks.determine_masks(md_t, st["Hi"], st["Hb"], st["SL"])
    sj["mask_margin"], st["mask_margin"] = mj["mask_margin"], \
        mt["mask_margin"]
    fgj = jsub.calc_grounded_fractions_bilin_TAF(
        md_j, sj["Hi"], sj["Hb"], sj["SL"], mj["mask_floating_ice"])
    fgt = tsub.calc_grounded_fractions_bilin_TAF(
        md_t, st["Hi"], st["Hb"], st["SL"], mt["mask_floating_ice"])
    return (SimpleNamespace(**sj), SimpleNamespace(**st), mj, mt, fgj, fgt)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    d = tmp_path_factory.mktemp("bmb_ocean")
    Cj, _ = mismipplus_configs()
    e.mesh_j, e.mesh_t = build_meshes_for(Cj)
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(17)
    e.states = [state_pair(e.mesh_t, e.mdj, e.mdt, rng, k)
                for k in (1.0, 1.05, 0.97)]
    e.files = {
        "snapshot": write_nc_pair(d, "snap", *snapshot_spec()),
        "anomalies": write_nc_pair(d, "anom",
                                   *snapshot_spec(with_time=True)),
        "dT": write_nc_pair(d, "dT", {"time": 3}, {
            "time": (("time",), np.array([0.0, 5.0, 50.0])),
            "dT": (("time",), np.array([0.0, 0.7, 1.1]))}),
        "bmb": write_nc_pair(d, "bmb", {"x": 42, "y": 11}, {
            "x": (("x",), np.linspace(-10e3, 810e3, 42)),
            "y": (("y",), np.linspace(-50e3, 50e3, 11)),
            "BMB": (("x", "y"), -np.outer(np.linspace(0.0, 30.0, 42),
                                          np.ones(11)))}),
    }
    return e


def configs_for(env, over, files=()):
    """(JAX config, port config): each reads its own package's files."""
    fj = {k: env.files[v][0] for k, v in files}
    ft = {k: env.files[v][1] for k, v in files}
    Cj, _ = mismipplus_configs(**over, **fj)
    _, Ct = mismipplus_configs(**over, **ft)
    return Cj, Ct


def close(a, b, tol=TOL):
    gap = rel_gap(a, np.asarray(b))
    assert gap <= tol, gap


OCEANS = {
    "none": dict(choice_ocean_model_ANT="none"),
    "MISMIPplus_WARM": dict(choice_ocean_model_ANT="idealised",
                            choice_ocean_model_idealised="MISMIPplus_WARM"),
    "MISMIPplus_COLD": dict(choice_ocean_model_ANT="idealised",
                            choice_ocean_model_idealised="MISMIPplus_COLD"),
    "ISOMIP_WARM": dict(choice_ocean_model_ANT="idealised",
                        choice_ocean_model_idealised="ISOMIP",
                        choice_ocean_isomip_scenario="WARM"),
    "ISOMIP_COLD": dict(choice_ocean_model_ANT="idealised",
                        choice_ocean_model_idealised="ISOMIP",
                        choice_ocean_isomip_scenario="COLD"),
    "TANH": dict(choice_ocean_model_ANT="idealised",
                 choice_ocean_model_idealised="TANH"),
    "LINEAR": dict(choice_ocean_model_ANT="idealised",
                   choice_ocean_model_idealised="LINEAR"),
    "LINEAR_THERMOCLINE": dict(
        choice_ocean_model_ANT="idealised",
        choice_ocean_model_idealised="LINEAR_THERMOCLINE"),
}
FILE_OCEANS = {
    "realistic": (dict(choice_ocean_model_ANT="realistic"),
                  (("filename_ocean_snapshot_ANT", "snapshot"),)),
    "realistic_uniform_dT": (
        dict(choice_ocean_model_ANT="realistic",
             choice_ocean_model_realistic="snapshot_plus_uniform_deltaT",
             ocean_uniform_deltaT_ANT=0.8),
        (("filename_ocean_snapshot_ANT", "snapshot"),)),
    "snapshot_plus_uniform_deltaT": (
        dict(choice_ocean_model_ANT="snapshot_plus_uniform_deltaT",
             ocean_uniform_deltaT_ANT=-0.4),
        (("filename_ocean_snapshot_ANT", "snapshot"),)),
    "deltaT_transient": (
        dict(choice_ocean_model_ANT="deltaT_transient"),
        (("filename_ocean_snapshot_ANT", "snapshot"),
         ("filename_ocean_dT_ANT", "dT"))),
    "realistic_transient": (
        dict(choice_ocean_model_ANT="realistic",
             choice_ocean_model_realistic="transient"),
        (("filename_ocean_snapshot_ANT", "snapshot"),
         ("filename_ocean_dT_ANT", "dT"))),
    "snapshot_plus_anomalies": (
        dict(choice_ocean_model_ANT="snapshot_plus_anomalies"),
        (("ocean_snp_p_anml_filename_snapshot", "snapshot"),
         ("ocean_snp_p_anml_filename_anomalies", "anomalies"))),
}


def ocean_pair(env, name):
    over, files = (OCEANS[name], ()) if name in OCEANS \
        else FILE_OCEANS[name]
    Cj, Ct = configs_for(env, over, files)
    return (joc.make_run_ocean(Cj, env.mdj, "ANT", mesh=env.mesh_j),
            toc.make_run_ocean(Ct, env.mdt, "ANT", mesh=env.mesh_t))


@pytest.mark.parametrize("name", list(OCEANS) + list(FILE_OCEANS))
def test_ocean(env, name):
    rj, rt = ocean_pair(env, name)
    for t, (sj, st, *_) in zip((0.0, 2.5, 12.0), env.states):
        oj, ot = rj(t, sj), rt(t, st)
        for k in OCEAN_FIELDS:
            close(ot[k], oj[k])
        assert torch.isfinite(ot["T"]).all()


def test_ocean_depth_axis_and_freezing_point(env):
    _, Ct = mismipplus_configs()
    assert np.array_equal(toc.ocean_depth_axis(Ct),
                          joc.ocean_depth_axis(mismipplus_configs()[0]))
    S = np.linspace(33.0, 35.0, 7)
    z = np.linspace(-900.0, 0.0, 7)
    close(tbmb.ocean_freezing_point_at_draft(torch.from_numpy(S),
                                             torch.from_numpy(z)),
          jbmb.ocean_freezing_point_at_draft(jnp.asarray(S),
                                             jnp.asarray(z)))


def test_extrapolation(env):
    """The cavity extrapolation and the neighbour fill on the snapshot's
    raw remapped field."""
    from ufemism2_tpu.io.input_files import read_field_from_file_3D_ocean
    Cj, _ = mismipplus_configs()
    z = joc.ocean_depth_axis(Cj)
    raw = read_field_from_file_3D_ocean(env.files["snapshot"][0], "T_ocean",
                                        env.mesh_j, z)
    raw[np.random.default_rng(2).random(raw.shape) < 0.2] = np.nan
    Hi, Hb, _, SL = calc_idealised_geometry(
        env.mesh_j.V[:, 0], env.mesh_j.V[:, 1], "MISMIP+", Cj)
    a = toc.extrapolate_ocean_forcing(env.mesh_t, Hi, Hb, SL, z, raw)
    b = joc.extrapolate_ocean_forcing(env.mesh_j, Hi, Hb, SL, z, raw)
    assert np.isfinite(a).all() and np.array_equal(a, b)
    fill = np.random.default_rng(3).random(raw.shape) < 0.5
    assert np.array_equal(toc._gaussian_fill_2d(env.mesh_t, raw, fill),
                          joc._gaussian_fill_2d(env.mesh_j, raw, fill),
                          equal_nan=True)


def test_unknown_ocean_choices(env):
    for over in (dict(choice_ocean_model_ANT="GlacialIndex"),
                 dict(choice_ocean_model_ANT="idealised",
                      choice_ocean_model_idealised="nowhere"),
                 dict(choice_ocean_model_ANT="idealised",
                      choice_ocean_model_idealised="ISOMIP")):
        _, Ct = mismipplus_configs(**over)
        with pytest.raises(ValueError):
            toc.make_run_ocean(Ct, env.mdt, "ANT", mesh=env.mesh_t)


def test_nudge2D_across_a_mesh_change(env):
    """snapshot+nudge2D: four calls inside the inversion window on the
    40 km mesh, then the runner of a 30 km mesh takes the nudged deltaT
    over through each package's trilinear map and is called twice more;
    deltaT and every ocean field within TOL after each call."""
    over = dict(choice_ocean_model_ANT="snapshot+nudge2D",
                BMB_inversion_t_start=0.0, BMB_inversion_t_end=100.0)
    files = (("filename_ocean_snapshot_ANT", "snapshot"),)
    Cj, Ct = configs_for(env, over, files)
    rj = joc.make_run_ocean(Cj, env.mdj, "ANT", mesh=env.mesh_j)
    rt = toc.make_run_ocean(Ct, env.mdt, "ANT", mesh=env.mesh_t)
    for t, (sj, st, *_) in zip((0.0, 1.0, 3.0, 150.0),
                               env.states + env.states[:1]):
        oj, ot = rj(t, sj), rt(t, st)
        close(rt.deltaT, rj.deltaT)
        for k in OCEAN_FIELDS:
            close(ot[k], oj[k])
    assert float(rt.deltaT.abs().max()) > 0.0
    # the runner of another mesh takes the state over
    Cj2, _ = mismipplus_configs(maximum_resolution_uniform=30e3,
                                maximum_resolution_grounded_ice=30e3,
                                maximum_resolution_grounding_line=30e3)
    mesh_j2, mesh_t2 = build_meshes_for(Cj2)
    mdj2 = jmd.build_mesh_data(mesh_j2)
    mdt2 = tmd.build_mesh_data(mesh_t2, dtype=torch.float64, device="cpu")
    Mj = jax_get_map(env.mesh_j, mesh_j2, method="trilin")
    Mt = port_get_map(env.mesh_t, mesh_t2, method="trilin")
    rj2 = joc.make_run_ocean(Cj, mdj2, "ANT", mesh=mesh_j2)
    rt2 = toc.make_run_ocean(Ct, mdt2, "ANT", mesh=mesh_t2)
    rj2.carry_state_from(rj, lambda a: jnp.asarray(Mj @ np.asarray(a)))
    rt2.carry_state_from(rt, lambda a: torch.from_numpy(Mt @ a.numpy()))
    close(rt2.deltaT, rj2.deltaT)
    assert rt2._t_prev == rj2._t_prev
    rng = np.random.default_rng(23)
    for t in (4.0, 6.0):
        sj, st, *_ = state_pair(mesh_t2, mdj2, mdt2, rng)
        oj, ot = rj2(t, sj), rt2(t, st)
        close(rt2.deltaT, rj2.deltaT)
        for k in OCEAN_FIELDS:
            close(ot[k], oj[k])


BMBS = {
    "uniform": dict(choice_BMB_model_ANT="uniform", uniform_BMB=-1.5),
    "idealised_uniform": dict(choice_BMB_model_ANT="idealised",
                              choice_BMB_model_idealised="uniform",
                              uniform_BMB=-2.0),
    "ice1r": dict(choice_BMB_model_ANT="idealised",
                  choice_BMB_model_idealised="MISMIP+"),
    "ice1r_spelt_out": dict(choice_BMB_model_ANT="idealised",
                            choice_BMB_model_idealised="MISMIPplus"),
    "prescribed": dict(choice_BMB_model_ANT="prescribed"),
    "prescribed_fixed": dict(choice_BMB_model_ANT="prescribed_fixed"),
}
SUBGRID = {
    "NMP": dict(do_subgrid_BMB_at_grounding_line=False),
    "FCMP": dict(do_subgrid_BMB_at_grounding_line=True,
                 choice_BMB_subgrid="FCMP"),
    "PMP": dict(do_subgrid_BMB_at_grounding_line=True,
                choice_BMB_subgrid="PMP"),
}


@pytest.mark.parametrize("scheme", list(SUBGRID))
@pytest.mark.parametrize("name", list(BMBS))
def test_bmb(env, name, scheme):
    over = dict(BMBS[name], **SUBGRID[scheme],
                BMB_maximum_allowed_melt_rate=25.0)
    Cj, Ct = configs_for(env, over,
                         (("filename_BMB_prescribed_ANT", "bmb"),))
    rj = jbmb.make_run_bmb(Cj, env.mdj, "ANT")
    rt = tbmb.make_run_bmb(Ct, env.mdt, "ANT")
    for sj, st, mj, mt, fgj, fgt in env.states:
        bj, bt = rj(0.0, sj, mj, fgj), rt(0.0, st, mt, fgt)
        close(bt, bj)
    if name.startswith("ice1r"):
        assert float(bt.min()) < -1.0      # the cavity melts


@pytest.mark.parametrize("ocean", ["ISOMIP_WARM", "ISOMIP_COLD",
                                   "MISMIPplus_WARM", "LINEAR", "realistic"])
def test_favier2019(env, ocean):
    """The quadratic local melt under each ocean (the schema's gamma)."""
    over = dict(choice_BMB_model_ANT="parameterised",
                choice_BMB_model_parameterised="Favier2019")
    Cj, Ct = configs_for(env, over)
    rj, rt = jbmb.make_run_bmb(Cj, env.mdj, "ANT"), \
        tbmb.make_run_bmb(Ct, env.mdt, "ANT")
    oj_run, ot_run = ocean_pair(env, ocean)
    for sj, st, mj, mt, fgj, fgt in env.states:
        bj = rj(0.0, sj, mj, fgj, oj_run(0.0, sj))
        bt = rt(0.0, st, mt, fgt, ot_run(0.0, st))
        close(bt, bj)
    if ocean == "ISOMIP_WARM":
        assert float(bt.min()) < 0.0
    with pytest.raises(ValueError, match="ocean"):
        rt(0.0, st, mt, fgt)


@pytest.mark.parametrize("window", [(0.0, 100.0), (50.0, 100.0)])
def test_inverted(env, window):
    """The inverted BMB over five calls with a target geometry (the
    host-held cache carried between calls), then without a target."""
    over = dict(choice_BMB_model_ANT="inverted",
                BMB_inversion_t_start=window[0],
                BMB_inversion_t_end=window[1], dt_BMB=2.0)
    Cj, Ct = configs_for(env, over)
    sj0, st0, mj0, mt0, _, _ = env.states[1]
    shelf = mt0["mask_floating_ice"]
    rj = jbmb.make_run_bmb(Cj, env.mdj, "ANT", target_geometry=lambda: (
        sj0.Hi, mj0["mask_floating_ice"]))
    rt = tbmb.make_run_bmb(Ct, env.mdt, "ANT",
                           target_geometry=lambda: (st0.Hi, shelf))
    for k, t in enumerate((0.0, 2.0, 60.0, 62.0, 200.0)):
        sj, st, mj, mt, fgj, fgt = env.states[k % 3]
        bj, bt = rj(t, sj, mj, fgj), rt(t, st, mt, fgt)
        close(bt, bj)
        assert torch.equal(rt.cache["BMB"], bt)
    assert float(bt.abs().max()) > 0.0
    rj2 = jbmb.make_run_bmb(Cj, env.mdj, "ANT")
    rt2 = tbmb.make_run_bmb(Ct, env.mdt, "ANT")
    for t in (60.0, 62.0):
        sj, st, mj, mt, fgj, fgt = env.states[2]
        close(rt2(t, st, mt, fgt), rj2(t, sj, mj, fgj))


def test_refused_bmb_choices(env):
    _, Ct = mismipplus_configs(choice_BMB_model_ANT="laddie_py")
    with pytest.raises(NotImplementedError, match="laddie_py"):
        tbmb.make_run_bmb(Ct, env.mdt, "ANT")
    _, Ct = mismipplus_configs(choice_BMB_model_ANT="parameterised",
                               choice_BMB_model_parameterised="Holland")
    with pytest.raises(NotImplementedError, match="Holland"):
        tbmb.make_run_bmb(Ct, env.mdt, "ANT")
    _, Ct = mismipplus_configs(choice_BMB_model_ANT="prescribed")
    with pytest.raises(ValueError, match="filename_BMB_prescribed"):
        tbmb.make_run_bmb(Ct, env.mdt, "ANT")
