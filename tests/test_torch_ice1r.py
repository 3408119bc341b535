"""The runs this slice of the port adds, against the JAX package on the
CPU in f64:

- MISMIP+ ice1r: the committed MISMIP+ 5 km spin-up (t = 11,425,
  glen_A_scale 0.34) resumed with the ice1r melt of Asay-Davis et al.
  (2016) after the retreat leg's start-up (the prediction window collapsed
  onto the resumed thickness, the leg's own counters), four ice steps: the
  same dt trajectory and counts, fields within 1e-10 over the first two
  (as tests/test_torch_restart.py holds the plain resume; IR_FIELD_STEPS
  says why not further).
- Berends et al. (2023) experiment II, the inversion chain
  'dHdt_invfric_invBMB' at 40 km (chip_smoke.py exp2_chain on the CPU
  against the JAX package's harness steps, ufemism2_tpu/validation/
  integrated_tests.py:1142-1260): the true roughness read from an x/y
  file, the ice1r retreat, then H_dHdt_flowline nudging with an inverted
  BMB and target thinning rates, a few ice steps a leg: equal counts in
  every leg, the nudged roughness and the inverted BMB within 1e-10.

Both use the viscosity loop cut to 3 iterations and the corrector to 2 on
both sides, as the CPU tests' other MISMIP+ configurations do."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

import jax.numpy as jnp

from torch_port_fixture import rel_gap, write_nc

from ufemism2_tpu.config import Config as JaxConfig
from ufemism2_tpu.core.ice.geometry import (
    ice_surface_elevation as jax_Hs, thickness_above_flotation as jax_TAF)
from ufemism2_tpu.io.ncio import NCFile as JaxNC
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config as jax_build_mesh
from ufemism2_tpu.mesh.creation import set_mesh_lonlat as jax_lonlat
from ufemism2_tpu.mesh.mesh_types import mesh_from_points as jax_mesh
from ufemism2_tpu.models.transects import Transect as JaxTransect

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.io.output_files import mesh_from_restart
from ufemism2_tpu_torch.main.region import ModelRegion

REPO = Path(__file__).resolve().parents[1]
JAX_RESTART = (REPO / "validation_runs" / "persist" / "mismipplus_5km_spinup"
               / "restart_ANT_00001.nc")
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-10
IR = dict(chip_smoke.MP_ICE1R, tpu_precision="f64", visc_it_nit=3,
          pc_nit_max=2, dt_output=1000.0, dt_output_restart=1000.0,
          transects_ANT="")
IR_STEPS = 4
# the fields are held after two steps: in the third a vertex near the
# grounding line parts by 3e-7 and in the fourth thin ice on a side wall
# crosses the Hi_min removal threshold on one side only (11 m against
# 6e-10 m), the sensitivity of this state that chip_smoke.py's
# mismipplus_resume measures; the counts and the dt trajectory stay equal
IR_FIELD_STEPS = 2
# the 40 km chain with legs of a few ice steps, a BMB and a nudging event
# every 0.1 model years
EXP2 = dict(chip_smoke.SMALL_EXP2, dt_BMB=0.1, bed_roughness_nudging_dt=0.1)
EXP2_LEGS = (0.3, 0.2, 0.3)
FIELDS = ("Hi", "Hs", "u_vav_b", "v_vav_b", "TAF", "bed_roughness")


def _jax_resume(Cj):
    with JaxNC(JAX_RESTART) as nc:
        V = np.asarray(nc.read("V"))
        Tri = np.asarray(nc.read("Tri")).astype(np.int64) - 1
    mesh = jax_mesh(V, Cj.xmin_ANT, Cj.xmax_ANT, Cj.ymin_ANT, Cj.ymax_ANT,
                    nz=Cj.nz, choice_zeta_grid=Cj.choice_zeta_grid,
                    zeta_irregular_log_R=Cj.zeta_irregular_log_R, Tri=Tri)
    jax_lonlat(mesh, Cj, "ANT")
    r = JaxRegion(Cj, "ANT", mesh=mesh)
    e = r.md.extras["glen_A_scale"]
    e.arr = jnp.asarray(chip_smoke.MP_GLEN_A_SCALE, e.arr.dtype)
    r.resume_from_restart(str(JAX_RESTART))
    return r


def _jax_ice1r_start(r):
    """integrated_tests.py:582-597, as the harness makes it."""
    s, t0 = r.state, float(r.time)
    r.state = s.replace(
        Hi_prev=s.Hi, Hi_next=s.Hi,
        t_Hi_prev=jnp.asarray(t0, s.t_Hi_prev.dtype),
        t_Hi_next=jnp.asarray(t0, s.t_Hi_next.dtype),
        n_visc_its=jnp.zeros_like(s.n_visc_its),
        n_Axb_its=jnp.zeros_like(s.n_Axb_its))


def test_ice1r_resume_matches_jax():
    C = Config(**IR)
    rt = ModelRegion(C, "ANT", mesh=mesh_from_restart(chip_smoke.MP_RESTART,
                                                      C), device="cpu")
    rt.md.extras["glen_A_scale"].arr = torch.tensor(
        chip_smoke.MP_GLEN_A_SCALE, dtype=torch.float64)
    rt.resume_from_restart(chip_smoke.MP_RESTART)
    rj = _jax_resume(JaxConfig(**IR))
    assert rt.time == float(rj.time) == 11425.0
    # the melt switched on at the resume: the first BMB field
    gap = rel_gap(rt.BMB, np.asarray(rj.BMB))
    assert gap <= 1e-13 and float(rt.BMB.min()) < -1.0, gap
    chip_smoke.ice1r_start(rt)
    _jax_ice1r_start(rj)
    n0 = rt.n_dt_ice
    traj_t, traj_j = [], []
    for k in range(1, IR_STEPS + 1):
        st, sj = rt.run_to(11425.0 + 0.1 * k), rj.run_to(11425.0 + 0.1 * k)
        traj_t.append((st.dt_ice, st.t_Hi_next, st.n_visc_its,
                       st.n_Axb_its))
        traj_j.append((float(sj.dt_ice), float(sj.t_Hi_next),
                       int(sj.n_visc_its), int(sj.n_Axb_its)))
        if k == IR_FIELD_STEPS:
            for name in FIELDS:
                gap = rel_gap(getattr(rt.state, name),
                              np.asarray(getattr(rj.state, name)))
                assert gap <= TOL, (name, gap)
            gap = rel_gap(rt.BMB, np.asarray(rj.BMB))
            assert gap <= TOL, gap
            # the grounding line on the westeast transect, as the harness
            # reads it
            tr = JaxTransect.named(rj.mesh, "westeast", dx=1e3)
            x_j = tr.zero_crossing_distance(tr.sample_vertices(
                np.asarray(rj.state.TAF))) + rj.mesh.xmin
            assert abs(chip_smoke.x_GL_westeast(rt) - x_j) <= 1e-6
    assert [x[2:] for x in traj_t] == [x[2:] for x in traj_j]
    assert np.allclose([x[:2] for x in traj_t], [x[:2] for x in traj_j],
                       rtol=1e-12, atol=0.0)
    assert rt.n_dt_ice - n0 == rj.n_dt_ice - n0 == IR_STEPS


def _jax_exp2(base, legs, workdir):
    """The JAX package's harness steps of 'dHdt_invfric_invBMB'
    (integrated_tests.py:1142-1260) with these legs, the roughness file
    written by the JAX package's NCFile."""
    res = base["maximum_resolution_uniform"]
    gx = np.arange(0.0, 800e3 + 1, res / 2)
    gy = np.arange(-40e3, 40e3 + 1, res / 2)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    phi_g = chip_smoke.berends_roughness(np.stack([GX.ravel(), GY.ravel()],
                                                  1)).reshape(GX.shape)
    rough = write_nc(JaxNC, workdir / "exp_II_bed_roughness.nc",
                     {"x": len(gx), "y": len(gy)},
                     {"x": (("x",), gx), "y": (("y",), gy),
                      "till_friction_angle": (("x", "y"), phi_g)})
    leg1 = dict(base, choice_bed_roughness="read_from_file",
                filename_bed_roughness_ANT=rough)
    mesh = jax_build_mesh(JaxConfig(**leg1), "ANT")
    out = {}

    def start_from(r, Hi0):
        Hi = jnp.asarray(Hi0, r.md.A.dtype)
        Hs = jax_Hs(Hi, r.state.Hb, r.state.SL)
        r.state = r.state.replace(Hi=Hi, Hi_prev=Hi, Hi_next=Hi, Hs=Hs,
                                  Hib=Hs - Hi,
                                  TAF=jax_TAF(Hi, r.state.Hb, r.state.SL))

    def run_leg(name, cfg, years, prepare=None):
        r = JaxRegion(JaxConfig(**dict(cfg, end_time_of_run=years)), "ANT",
                      mesh=mesh)
        if prepare is not None:
            prepare(r)
        r.run_to(years)
        out[name] = dict(steps=r.n_dt_ice, n_visc_its=int(r.state.n_visc_its),
                         n_Axb_its=int(r.state.n_Axb_its))
        return r

    r1 = run_leg("leg1", leg1, legs[0])
    phi_true = np.asarray(r1.state.bed_roughness)
    Hi_t, Hb_t = np.asarray(r1.state.Hi), np.asarray(r1.state.Hb)
    r2 = run_leg("leg2", dict(leg1, choice_BMB_model_ANT="idealised",
                              choice_BMB_model_idealised="MISMIP+"),
                 legs[1], lambda r: start_from(r, Hi_t))
    Hi_ret, dHdt_ret = np.asarray(r2.state.Hi), np.asarray(r2.state.dHi_dt)

    def leg3_start(r):
        r.refgeo_PD = (Hi_ret, Hb_t)
        start_from(r, Hi_ret)
        r.state = r.state.replace(dHi_dt_target=jnp.asarray(dHdt_ret))

    r3 = run_leg("leg3", dict(
        base, choice_bed_roughness="uniform",
        slid_ZI_phi_fric_uniform=float(phi_true.mean()),
        do_bed_roughness_nudging=True,
        choice_bed_roughness_nudging_method="H_dHdt_flowline",
        choice_BMB_model_ANT="inverted", do_target_dHi_dt=True),
        legs[2], leg3_start)
    return out, mesh, dict(
        phi_true=phi_true, phi_inv=np.asarray(r3.state.bed_roughness),
        BMB_inv=np.asarray(r3.BMB), BMB_ret=np.asarray(r2.BMB),
        Hi=np.asarray(r3.state.Hi), u_vav_b=np.asarray(r3.state.u_vav_b))


def test_berends_exp2_chain_matches_jax(tmp_path):
    numbers, metrics, r3, fields = chip_smoke.exp2_chain(
        EXP2, EXP2_LEGS, "cpu", str(tmp_path))
    legs_j, mesh_j, fields_j = _jax_exp2(EXP2, EXP2_LEGS, tmp_path)
    assert np.array_equal(r3.mesh.V, mesh_j.V)
    assert numbers["nV"] == mesh_j.nV < 100
    for leg, c in legs_j.items():
        got = {k: numbers["legs"][leg][k] for k in c}
        assert got == c, (leg, got, c)
        assert c["steps"] >= 2, leg
    # the nudging and the inversion acted: 3 events in leg 3, the
    # roughness moved off its uniform start, the inverted BMB is not zero
    assert numbers["legs"]["leg3"]["nudging_events"] == 3
    assert np.ptp(fields["phi_inv"]) > 0.0
    assert np.abs(fields["BMB_inv"]).max() > 0.0
    for k in ("phi_true", "phi_inv", "BMB_inv", "BMB_ret", "Hi",
              "u_vav_b"):
        gap = rel_gap(fields[k], fields_j[k])
        assert gap <= TOL, (k, gap)
    assert metrics["grounded_vertices"] > 0
    assert np.isfinite(metrics["r95_till_friction_angle"])
