"""The port's Salle2025 transient hydrology
(ufemism2_tpu_torch/core/ice/hydrology_salle2025.py) against the JAX
package's, f64: one adaptive sub-step, a leg with the same count of
sub-steps (the JAX package's lax.while_loop is a Python loop in the port),
the till outputs, the state carried over from numpy; and a coarse
Antarctica region (the writer's 80 km data, 600 km on grounded ice) with
Zoet-Iverson sliding on the Salle2025 effective pressure, the particle
tracers and two regions of interest (Pine Island and Thwaites), through a
forced mesh update: equal dt trajectories and solver counts, the same
number of hydrology sub-steps in every leg, the fields, the hydrology state
and the effective pressure within 1e-10 of their largest value, the same
live particles (the spawn draws of the JAX package fed to the port), the
per-ROI scalar files.

The JAX package cannot start such a region: its initial stress-balance
solve reads hydro_N_eff before the region registers it (ROADMAP C). The
port registers the slot first, with the value the JAX package registers
right after (rho_i g Hi); the JAX side here gets the same by a wrapper
around its region's init_ice_state. Tolerances: 1e-12 relative for a
sub-step, 1e-10 for legs and the region (the dt of each sub-step is a
minimum over the mesh; the sub-step sums carry the rounding along)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_fixture import (build_meshes_for, mismipplus_configs,
                                mesh_to_numpy, rel_gap, copy_to_nc4)

from ufemism2_tpu.config import Config as JaxConfig
from ufemism2_tpu.core.mesh_data import build_mesh_data as jbmd, EField
from ufemism2_tpu.core.ice import hydrology_salle2025 as jh
from ufemism2_tpu.main import region as jregion
from ufemism2_tpu.mesh import build_mesh_from_config as jax_build_mesh

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.convert import (mesh_from_numpy,
                                        salle2025_state_from_numpy)
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data as tbmd
from ufemism2_tpu_torch.core.ice import hydrology_salle2025 as th
from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.main.region import ModelRegion
from ufemism2_tpu_torch.tools import antarctica_synthetic as writer

STEP_TOL = 1e-12
TOL = 1e-10


@pytest.fixture(scope="module")
def unit():
    Cj, Ct = mismipplus_configs(basal_hydro_equil_time=0.02)
    mj, mt = build_meshes_for(Cj)
    mdj, mdt = jbmd(mj), tbmd(mt, device="cpu")
    rng = np.random.default_rng(8)
    x = mj.V[:, 0]
    f = dict(Hi=np.where(x < 450e3, 1500.0 - 2e-3 * x, 0.0)
             + 30.0 * rng.random(mj.nV),
             Hb=-100.0 - 1e-3 * x + 20.0 * rng.standard_normal(mj.nV),
             u=200.0 * rng.random(mj.nV), v=20.0 * rng.standard_normal(mj.nV))
    h = dict(W=0.05 * rng.random(mj.nV), W_til=1.5 * rng.random(mj.nV),
             P=1e6 * rng.random(mj.nV))
    gr = x < 450e3
    return Cj, Ct, mdj, mdt, f, h, gr


def _jax_leg_count(C, md, h, Hi, Hb, gr, u, v, max_substeps=2000):
    """The JAX package's leg as its while_loop runs it, one eager sub-step
    at a time, to count the sub-steps."""
    from ufemism2_tpu.utils.constants import sec_per_year
    mask_b = gr[md.Tri].any(axis=1)
    t_goal = C.basal_hydro_equil_time * sec_per_year
    dt_max = jnp.asarray(C.dt_ice_max * sec_per_year)
    t, it = jnp.asarray(0.0), 0
    while bool(t < t_goal) and it < max_substeps:
        h, dt = jh._hydro_step(md, h, Hi, Hb, gr, mask_b, u / sec_per_year,
                               v / sec_per_year,
                               jnp.minimum(dt_max, t_goal - t))
        t, it = t + dt, it + 1
    return h, it


def test_hydro_step_and_leg(unit):
    Cj, Ct, mdj, mdt, f, h, gr = unit
    hj = jh.Salle2025State(**{k: jnp.asarray(v) for k, v in h.items()})
    ht = salle2025_state_from_numpy(h, "cpu", torch.float64)
    J = {k: jnp.asarray(v) for k, v in f.items()}
    T = {k: torch.tensor(v) for k, v in f.items()}
    grj, grt = jnp.asarray(gr), torch.as_tensor(gr)
    # one sub-step
    mbj, mbt = grj[mdj.Tri].any(axis=1), grt[mdt.Tri].any(dim=1)
    nj, dtj = jh._hydro_step(mdj, hj, J["Hi"], J["Hb"], grj, mbj,
                             J["u"] / 3e7, J["v"] / 3e7, jnp.asarray(1e6))
    nt, dtt = th._hydro_step(mdt, ht, T["Hi"], T["Hb"], grt, mbt,
                             T["u"] / 3e7, T["v"] / 3e7,
                             torch.tensor(1e6, dtype=torch.float64),
                             th._min_tri_side(mdt))
    assert rel_gap(dtt, np.asarray(dtj)) <= STEP_TOL
    for k in ("W", "W_til", "P"):
        assert rel_gap(getattr(nt, k), np.asarray(getattr(nj, k))) \
            <= STEP_TOL, k
    # a leg: the same sub-steps, state and till outputs
    lj, Nj, tj = jh.run_salle2025_leg(Cj, mdj, hj, J["Hi"], J["Hb"], grj,
                                      J["u"], J["v"])
    _, n_j = _jax_leg_count(Cj, mdj, hj, J["Hi"], J["Hb"], grj, J["u"],
                            J["v"])
    lt, Nt, tt, n_t = th.run_salle2025_leg(Ct, mdt, ht, T["Hi"], T["Hb"],
                                           grt, T["u"], T["v"])
    assert n_t == n_j > 5
    for k in ("W", "W_til", "P"):
        assert rel_gap(getattr(lt, k), np.asarray(getattr(lj, k))) <= TOL, k
    assert rel_gap(Nt, np.asarray(Nj)) <= TOL
    assert rel_gap(tt, np.asarray(tj)) <= TOL
    # the cap on sub-steps
    assert th.run_salle2025_leg(Ct, mdt, ht, T["Hi"], T["Hb"], grt, T["u"],
                                T["v"], max_substeps=3)[3] == 3


def test_till_outputs(unit):
    _, _, _, _, f, h, _ = unit
    hj = jh.Salle2025State(**{k: jnp.asarray(v) for k, v in h.items()})
    ht = salle2025_state_from_numpy(h, "cpu", torch.float64)
    Nj, tj = jh.salle2025_till_outputs(hj, jnp.asarray(f["Hi"]))
    Nt, tt = th.salle2025_till_outputs(ht, torch.tensor(f["Hi"]))
    assert rel_gap(Nt, np.asarray(Nj)) <= STEP_TOL
    assert rel_gap(tt, np.asarray(tj)) <= STEP_TOL


# -- the region --------------------------------------------------------------

RES = 600e3
ROIS = "Pine_Island_Glacier,Thwaites_Glacier"
T_BEFORE = (0.2,)
T_AFTER = (0.4,)
FIELDS = ("Hi", "Hs", "u_vav_b", "v_vav_b", "dHi_dt")


def hydro_cfg(topo):
    return dict(
        choice_refgeo_init_ANT="read_from_file",
        choice_refgeo_PD_ANT="read_from_file",
        filename_refgeo_init_ANT=str(topo), filename_refgeo_PD_ANT=str(topo),
        xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
        choice_SMB_model_ANT="uniform", uniform_SMB=0.3,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        choice_sliding_law="Zoet-Iverson",
        choice_basal_hydrology_model="Salle2025", dt_basal_hydro=0.2,
        basal_hydro_equil_time=0.02,
        choice_tracer_tracking_model="particles",
        tractrackpart_dt_coupling=0.2,
        choice_regions_of_interest=ROIS,
        choice_thermo_model="none", allow_mesh_updates=True,
        maximum_resolution_uniform=800e3,
        maximum_resolution_grounded_ice=RES,
        maximum_resolution_floating_ice=2 * RES,
        maximum_resolution_grounding_line=RES, grounding_line_width=RES,
        maximum_resolution_calving_front=2 * RES,
        calving_front_width=2 * RES,
        maximum_resolution_ice_front=2 * RES, ice_front_width=2 * RES,
        ROI_maximum_resolution_uniform=400e3,
        ROI_maximum_resolution_grounding_line=RES,
        ROI_maximum_resolution_calving_front=2 * RES,
        nit_Lloyds_algorithm=2, tpu_precision="f64", visc_it_nit=3,
        pc_nit_max=2, dt_output=0.2, start_time_of_run=0.0,
        end_time_of_run=1.0)


def _jax_draws(region):
    """The port region's spawn draws taken from the JAX package's stream
    (PRNGKey(7), split at every event)."""
    key = {"k": jax.random.PRNGKey(7)}

    def draw(n):
        key["k"], sub = jax.random.split(key["k"])
        return torch.tensor(np.asarray(
            jax.random.randint(sub, (n,), 0, region.md.nV)))
    return draw


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    d = tmp_path_factory.mktemp("hydro")
    topo = writer.write_all(d / "port", 80e3)["topo"]
    topo_j = copy_to_nc4(topo, d / "topo_nc4.nc")
    Cj = JaxConfig(**hydro_cfg(topo_j))
    Ct = Config(**hydro_cfg(topo))
    mesh_j = jax_build_mesh(Cj, "ANT")
    inner = jregion.init_ice_state

    def with_slot(md, Hi, *a, **kw):
        s = inner(md, Hi, *a, **kw)
        md.extras["hydro_N_eff"] = EField(917.0 * 9.81 * s.Hi, "V")
        return s
    jregion.init_ice_state = with_slot
    try:
        rj = jregion.ModelRegion(Cj, "ANT", mesh=mesh_j,
                                 output_dir=str(d / "jax"))
    finally:
        jregion.init_ice_state = inner
    rt = ModelRegion(Ct, "ANT", mesh=mesh_from_numpy(mesh_to_numpy(mesh_j)),
                     output_dir=str(d / "port"), device="cpu")
    rt._spawn_draw = _jax_draws(rt)
    traj = []

    def step(t):
        sj, st = rj.run_to(t), rt.run_to(t)
        traj.append(((st.n_visc_its, st.n_Axb_its),
                     (int(sj.n_visc_its), int(sj.n_Axb_its))))
        compare(rt, rj)
    for t in T_BEFORE:
        step(t)
    rj.update_mesh()
    rt.update_mesh()
    assert rt.mesh.nV == rj.mesh.nV and np.array_equal(rt.mesh.V, rj.mesh.V)
    compare(rt, rj)
    for t in T_AFTER:
        step(t)
    return rt, rj, traj, d


def compare(rt, rj):
    for name in FIELDS:
        gap = rel_gap(getattr(rt.state, name),
                      np.asarray(getattr(rj.state, name)))
        assert gap <= TOL, (rt.time, name, gap)
    for k in ("W", "W_til", "P"):
        gap = rel_gap(getattr(rt.hydro_state, k),
                      np.asarray(getattr(rj.hydro_state, k)))
        assert gap <= TOL, (rt.time, k, gap)
    gap = rel_gap(rt.md.x("hydro_N_eff"),
                  np.asarray(rj.md.extras["hydro_N_eff"].arr))
    assert gap <= TOL, (rt.time, "hydro_N_eff", gap)
    pt, pj = rt.tracer_state, rj.tracer_state
    np.testing.assert_array_equal(pt.alive.numpy(), np.asarray(pj.alive))
    for k in ("x", "y", "zeta", "t_origin"):
        assert rel_gap(getattr(pt, k), np.asarray(getattr(pj, k))) <= TOL, k


def test_region_through_a_remesh(regions):
    rt, rj, traj, d = regions
    for got, want in traj:
        assert got == want
    assert rt.n_dt_ice == rj.n_dt_ice >= 3
    assert rt.n_mesh_updates == 1
    # every hydrology event ran a leg; the till took water; tracers live
    assert len(rt.hydro_substeps) >= 3 and min(rt.hydro_substeps) >= 1
    assert float(rt.hydro_state.W_til.max()) > 0.0
    assert int(rt.tracer_state.alive.sum()) > 0


def test_region_roi_scalar_files(regions):
    rt, rj, _, d = regions
    from ufemism2_tpu.io.ncio import NCFile as JaxNC
    for roi in ROIS.split(","):
        fp = d / "port" / f"scalar_output_ANT_{roi}_00001.nc"
        fj = d / "jax" / f"scalar_output_ANT_{roi}_00001.nc"
        with NCFile(str(fp)) as a, JaxNC(str(fj)) as b:
            ta, tb = a.read("time"), b.read("time")
            assert len(ta) == len(tb) >= 3 and np.allclose(ta, tb)
            for k in ("ice_area", "ice_volume", "SMB_total"):
                assert rel_gap(a.read(k), b.read(k)) <= TOL, (roi, k)
        hist = rt.roi_history[roi]
        assert len(hist) == len(ta) and hist[-1]["ice_area"] > 0.0
