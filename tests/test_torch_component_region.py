"""The new component paths inside the region, the port's ModelRegion
against the JAX package's on the 40 km MISMIP+ fixture, f64:

- an ocean and a BMB that reads it: the ISOMIP+ WARM profile and the
  Favier et al. (2019) quadratic melt, an ocean and a BMB event every ice
  step, 500 m of ice (a shelf with a cavity): the events in the JAX
  package's order (ocean before SMB and BMB), three ice steps;
- a region driven by files: the initial and present-day geometry, the
  prescribed SMB and the target thinning rate (limited by the SMB) read
  from x/y files, the mesh built from the file's geometry; two ice steps;
- the host-held component state (the inverted BMB, the nudge2D ocean, the
  nudged roughness) of a JAX region carried into a port region, which then
  runs on equal.

Equal dt trajectories and counts, fields within 1e-10 relative (measured
near 1e-15)."""

import numpy as np
import pytest
import torch

from torch_port_fixture import (build_meshes_for, mesh_to_numpy,
                                mismipplus_configs, ocean_snapshot_spec,
                                rel_gap, state_to_numpy, write_nc_pair)

from ufemism2_tpu.core.idealised_geometries import calc_idealised_geometry
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config as jax_build_mesh

from ufemism2_tpu_torch.convert import (component_state_from_numpy,
                                        ice_state_from_numpy,
                                        mesh_from_numpy)
from ufemism2_tpu_torch.main.region import ModelRegion
from ufemism2_tpu_torch.mesh import build_mesh_from_config as port_build_mesh

TOL = 1e-10
FIELDS = ("Hi", "Hs", "u_vav_b", "v_vav_b", "TAF", "dHi_dt",
          "dHi_dt_target")


def run_and_compare(rt, rj, t_ends):
    for t in t_ends:
        st, sj = rt.run_to(t), rj.run_to(t)
        assert (st.n_visc_its, st.n_Axb_its) == (int(sj.n_visc_its),
                                                 int(sj.n_Axb_its))
        assert abs(st.dt_ice - float(sj.dt_ice)) <= 1e-12
        for name in FIELDS:
            gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
            assert gap <= TOL, (t, name, gap)
        for name in ("SMB", "BMB"):
            gap = rel_gap(getattr(rt, name), np.asarray(getattr(rj, name)))
            assert gap <= TOL, (t, name, gap)
    assert rt.n_dt_ice == rj.n_dt_ice >= len(t_ends)


def test_ocean_and_favier_melt():
    over = dict(refgeo_idealised_MISMIPplus_Hi_init=500.0,
                choice_ocean_model_ANT="idealised",
                choice_ocean_model_idealised="ISOMIP",
                choice_ocean_isomip_scenario="WARM",
                choice_BMB_model_ANT="parameterised",
                choice_BMB_model_parameterised="Favier2019",
                dt_ocean=0.1, dt_BMB=0.1, tpu_precision="f64")
    Cj, Ct = mismipplus_configs(**over)
    mesh_j, mesh_t = build_meshes_for(Cj)
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rt = ModelRegion(Ct, "ANT", mesh=mesh_t, device="cpu")
    for k in ("T_draft", "T_freezing_point"):
        assert rel_gap(rt.ocean[k], np.asarray(rj.ocean[k])) <= 1e-13
    assert float(rt.BMB.min()) < -1.0          # the cavity melts
    run_and_compare(rt, rj, (0.05, 0.15, 0.25))
    assert rel_gap(rt.ocean["T_draft"],
                   np.asarray(rj.ocean["T_draft"])) <= TOL


def test_region_from_files(tmp_path):
    """choice_refgeo_init / choice_refgeo_PD 'read_from_file' (the mesh
    built from the file's geometry), SMB 'prescribed' and
    do_target_dHi_dt with do_limit_target_dHi_dt_to_SMB, each file read
    by its own package."""
    Cj0, _ = mismipplus_configs()
    x = np.arange(0.0, 800e3 + 1, 10e3)
    y = np.arange(-40e3, 40e3 + 1, 10e3)
    X, Y = np.meshgrid(x, y, indexing="ij")
    Hi, Hb, _, _ = calc_idealised_geometry(X.ravel(), Y.ravel(), "MISMIP+",
                                           Cj0)
    Hi = np.where(X.ravel() < 640e3, 500.0, 0.0).reshape(X.shape)
    Hb = Hb.reshape(X.shape)
    geo = write_nc_pair(tmp_path, "geo", {"x": len(x), "y": len(y)}, {
        "x": (("x",), x), "y": (("y",), y),
        "Hi": (("y", "x"), Hi.T), "Hb": (("y", "x"), Hb.T),
        "SL": (("y", "x"), np.zeros_like(Hi.T))})
    smb = write_nc_pair(tmp_path, "smb", {"x": len(x), "y": len(y)}, {
        "x": (("x",), x), "y": (("y",), y),
        "SMB": (("x", "y"), 0.5 - 6e-7 * X)})
    dhdt = write_nc_pair(tmp_path, "dhdt", {"x": len(x), "y": len(y),
                                            "time": 2}, {
        "x": (("x",), x), "y": (("y",), y),
        "time": (("time",), np.array([0.0, 10.0])),
        "dHdt": (("time", "x", "y"), np.stack([
            np.sin(X / 80e3), 0.8 * np.cos(X / 60e3)]))})
    over = dict(choice_refgeo_init_ANT="read_from_file",
                choice_refgeo_PD_ANT="read_from_file",
                choice_SMB_model_ANT="prescribed", do_target_dHi_dt=True,
                do_limit_target_dHi_dt_to_SMB=True,
                timeframe_dHi_dt_target_ANT=10.0, tpu_precision="f64")

    def files(k):
        return dict(filename_refgeo_init_ANT=geo[k],
                    filename_refgeo_PD_ANT=geo[k],
                    filename_SMB_prescribed_ANT=smb[k],
                    filename_dHi_dt_target_ANT=dhdt[k])
    Cj, _ = mismipplus_configs(**over, **files(0))
    _, Ct = mismipplus_configs(**over, **files(1))
    mesh_j = jax_build_mesh(Cj, "ANT")
    mesh_t = port_build_mesh(Ct, "ANT")
    assert np.array_equal(mesh_t.V, mesh_j.V)
    assert np.array_equal(mesh_t.Tri, mesh_j.Tri)
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rt = ModelRegion(Ct, "ANT",
                     mesh=mesh_from_numpy(mesh_to_numpy(mesh_j)),
                     device="cpu")
    for a, b in zip(rt.refgeo_PD, rj.refgeo_PD):
        assert rel_gap(a, np.asarray(b)) <= 1e-13
    tgt = rt.state.dHi_dt_target
    assert rel_gap(tgt, np.asarray(rj.state.dHi_dt_target)) <= 1e-13
    # the SMB limit acts: positive targets never exceed the SMB
    assert bool((tgt <= torch.clamp(rt.SMB, min=0.0) + 1e-12).all())
    assert float(tgt.min()) < 0.0 < float(tgt.max())
    run_and_compare(rt, rj, (0.05, 0.15))


def test_geometry_file_needs_its_keys():
    _, Ct = mismipplus_configs(choice_refgeo_init_ANT="read_from_file")
    with pytest.raises((OSError, ValueError)):
        port_build_mesh(Ct, "ANT")


def test_carry_component_state(tmp_path):
    """A JAX region run for a while with host-held component state (the
    inverted BMB's cache, the nudge2D ocean's offset, the nudged roughness)
    is carried into a fresh port region (convert.py: the ice state and
    component_state_from_numpy); both then run on equal."""
    snap = write_nc_pair(tmp_path, "snap", *ocean_snapshot_spec())
    over = dict(refgeo_idealised_MISMIPplus_Hi_init=500.0,
                choice_sliding_law="Zoet-Iverson",
                choice_ocean_model_ANT="snapshot+nudge2D",
                BMB_inversion_t_start=0.0, BMB_inversion_t_end=10.0,
                choice_BMB_model_ANT="inverted",
                do_bed_roughness_nudging=True,
                choice_bed_roughness_nudging_method="H_dHdt_flowline",
                bed_roughness_nudging_dt=0.1, dt_ocean=0.1, dt_BMB=0.1,
                tpu_precision="f64")
    Cj, _ = mismipplus_configs(**over, filename_ocean_snapshot_ANT=snap[0])
    _, Ct = mismipplus_configs(**over, filename_ocean_snapshot_ANT=snap[1])
    mesh_j, mesh_t = build_meshes_for(Cj)
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rj.run_to(0.25)
    rt = ModelRegion(Ct, "ANT", mesh=mesh_t, device="cpu")
    rt.state = ice_state_from_numpy(state_to_numpy(rj.state), "cpu",
                                    torch.float64)
    rt.time, rt.n_dt_ice = float(rj.time), rj.n_dt_ice
    rt.t_next = {k: float(v) for k, v in rj.t_next.items() if k in rt.t_next}
    rt.BMB = torch.from_numpy(np.array(rj.BMB))
    bmb_cache = next(c.cell_contents for c in rj.run_bmb.__closure__
                     if isinstance(c.cell_contents, dict)
                     and "BMB" in c.cell_contents)
    component_state_from_numpy(rt, {
        "bed_roughness": np.asarray(rj.bed_roughness_state.generic),
        "BMB_inverted": np.asarray(bmb_cache["BMB"]),
        "ocean_deltaT": np.asarray(rj.run_ocean.deltaT),
        "ocean_t_prev": rj.run_ocean._t_prev}, "cpu", torch.float64)
    assert float(rt.run_ocean.deltaT.abs().max()) > 0.0
    assert float(rt.run_bmb.cache["BMB"].abs().max()) > 0.0
    for t in (0.35, 0.45):
        st, sj = rt.run_to(t), rj.run_to(t)
        assert (st.n_visc_its, st.n_Axb_its) == (int(sj.n_visc_its),
                                                 int(sj.n_Axb_its))
        for name in ("Hi", "u_vav_b", "bed_roughness"):
            gap = rel_gap(getattr(st, name), np.asarray(getattr(sj, name)))
            assert gap <= TOL, (t, name, gap)
        assert rel_gap(rt.BMB, np.asarray(rj.BMB)) <= TOL
        assert rel_gap(rt.run_ocean.deltaT,
                       np.asarray(rj.run_ocean.deltaT)) <= TOL
