"""The realistic Antarctica stand-in on the CPU, the port against the JAX
package, f64:

- the port's synthetic-data writer (ufemism2_tpu_torch/tools/
  antarctica_synthetic.py) against the repository's generator
  (tools/gen_antarctica_synthetic.py): make_geometry to 0 at two grid
  spacings, and every array of the generator's five files (its NetCDF4
  through h5py) equal to the port's NetCDF classic copies;
- a coarse Antarctica region (600 km on grounded ice, about 170 vertices,
  on the writer's 80 km grid) through a few ice steps, one forced
  update_mesh() and a few more: geometry from the files, the transient
  snapshot climate with lapse-rate downscaling and the realistic
  insolation, IMAU-ITM, ELRA and the GlacialIndex LMB, every component
  event every 0.2 years. Equal dt trajectories and solver counts, the
  same number of calls of the stateful IMAU-ITM runner on both sides (it
  advances its firn each call: construction, every SMB event, the forcing
  refresh after the remesh), fields, SMB, LMB, the bed deformation dHb and
  the firn within 1e-10 of their largest value, the new mesh identical.

The JAX side reads the generator's files and NetCDF4 copies of the
writer's others (tests/torch_port_fixture.py copy_to_nc4). The viscosity
loop and the corrector are cut as in the other region tests.

At 400 and 500 km the JAX package's compiled ice step parts from its own
eager evaluation at the calving front after the remesh: in the first step
on the new mesh an open-ocean vertex with a positive SMB keeps 3e-4 m of
new ice in the compiled step, where the eager step (jax_disable_jit) and
the port calve it; at 500 km the port then equals the eager JAX run to
1e-15 through the remesh and four more steps (ROADMAP.md C). The eager
JAX run takes minutes, so the test holds the compiled one at 600 km,
where the two evaluations agree."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixture import copy_to_nc4, mesh_to_numpy, rel_gap

from ufemism2_tpu.config import Config as JaxConfig
from ufemism2_tpu.io.ncio import NCFile as JaxNC
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config as jax_build_mesh
from ufemism2_tpu.models import smb as jsmb

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.main.region import ModelRegion
from ufemism2_tpu_torch.tools import antarctica_synthetic as writer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import gen_antarctica_synthetic as generator   # noqa: E402

TOL = 1e-10
DX = 80e3
FIELDS = ("Hi", "Hs", "Hb", "dHb", "u_vav_b", "v_vav_b", "TAF", "dHi_dt")
T_BEFORE = (0.2, 0.4)
T_AFTER = (0.6, 0.8)
RES = 600e3


@pytest.mark.parametrize("dx", (80e3, 20e3))
def test_writer_geometry_equals_generator(dx):
    for a, b in zip(writer.make_geometry(dx), generator.make_geometry(dx)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ant")
    port = writer.write_all(d / "port", DX)
    jax_files = generator.write_all(DX, d / "jax")
    jax = {k: Path(v) for k, v in jax_files.items()}
    for k, p in port.items():
        if k not in jax:
            jax[k] = Path(copy_to_nc4(p, d / f"{k}_nc4.nc"))
    return port, jax


def test_writer_files_equal_generator_files(data):
    port, jax = data
    for key in ("topo", "climate", "SMB", "dHdt", "ghf"):
        with NCFile(str(port[key])) as a, JaxNC(str(jax[key])) as b:
            names = [n for n in a.variables() if n not in a.dims()]
            assert names and set(names) <= set(b.variables())
            for n in a.variables():
                assert np.array_equal(a.read(n), b.read(n)), (key, n)
                if n not in a.dims():
                    assert tuple(a.dim_names(n)) == tuple(b.dim_names(n))


def antarctica_itm(files):
    return dict(
        choice_refgeo_init_ANT="read_from_file",
        choice_refgeo_PD_ANT="read_from_file",
        choice_refgeo_GIAeq_ANT="read_from_file",
        filename_refgeo_init_ANT=str(files["topo"]),
        filename_refgeo_PD_ANT=str(files["topo"]),
        filename_refgeo_GIAeq_ANT=str(files["topo"]),
        xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
        choice_climate_model_ANT="snapshot_plus_transient_deltaT",
        filename_climate_snapshot_ANT=str(files["climate"]),
        do_lapse_rate_corrections_ANT=True,
        filename_atmosphere_dT_ANT=str(files["dT_atm"]),
        choice_insolation_forcing="realistic",
        filename_insolation=str(files["insolation"]),
        choice_SMB_model_ANT="IMAU-ITM", choice_GIA_model="ELRA",
        choice_LMB_model_ANT="GlacialIndex",
        filename_LMB_GI_ANT=str(files["GI"]),
        warm_LMB_ANT=0.0, cold_LMB_ANT=-2.0,
        dt_GIA=0.2, dt_SMB=0.2, dt_climate=0.2, dt_LMB=0.2,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        choice_thermo_model="none", allow_mesh_updates=True,
        maximum_resolution_uniform=800e3,
        maximum_resolution_grounded_ice=RES,
        maximum_resolution_floating_ice=2 * RES,
        maximum_resolution_grounding_line=RES, grounding_line_width=RES,
        maximum_resolution_calving_front=2 * RES,
        calving_front_width=2 * RES,
        maximum_resolution_ice_front=2 * RES, ice_front_width=2 * RES,
        nit_Lloyds_algorithm=2, tpu_precision="f64", visc_it_nit=3,
        pc_nit_max=2, start_time_of_run=0.0, end_time_of_run=1.0)


@pytest.fixture(scope="module")
def regions(data):
    port, jax = data
    Cj = JaxConfig(**antarctica_itm(jax))
    Ct = Config(**antarctica_itm(port))
    mesh_j = jax_build_mesh(Cj, "ANT")
    calls = {"n": 0}
    inner = jsmb.ImauItmSMB.__call__

    def counted(self, *a, **kw):
        calls["n"] += 1
        return inner(self, *a, **kw)
    jsmb.ImauItmSMB.__call__ = counted
    try:
        rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
        rt = ModelRegion(Ct, "ANT", mesh=mesh_from_numpy(
            mesh_to_numpy(mesh_j)), device="cpu")
        traj = []

        def step(t):
            sj, st = rj.run_to(t), rt.run_to(t)
            traj.append(((st.dt_ice, st.n_visc_its, st.n_Axb_its),
                         (float(sj.dt_ice), int(sj.n_visc_its),
                          int(sj.n_Axb_its))))
            compare(rt, rj)
            assert rt.run_smb.calls == calls["n"]
        for t in T_BEFORE:
            step(t)
        rj.update_mesh()
        rt.update_mesh()
        assert rt.mesh.nV == rj.mesh.nV and np.array_equal(rt.mesh.V,
                                                           rj.mesh.V)
        compare(rt, rj)
        for t in T_AFTER:
            step(t)
    finally:
        jsmb.ImauItmSMB.__call__ = inner
    return rt, rj, traj, calls["n"]


def compare(rt, rj):
    for name in FIELDS:
        gap = rel_gap(getattr(rt.state, name),
                      np.asarray(getattr(rj.state, name)))
        assert gap <= TOL, (rt.time, name, gap)
    for name in ("SMB", "LMB"):
        gap = rel_gap(getattr(rt, name), np.asarray(getattr(rj, name)))
        assert gap <= TOL, (rt.time, name, gap)
    for k in ("T2m", "Precip", "Q_TOA"):
        gap = rel_gap(rt.climate[k], np.asarray(rj.climate[k]))
        assert gap <= TOL, (rt.time, k, gap)
    for k in ("FirnDepth", "MeltPreviousYear", "Albedo"):
        gap = rel_gap(getattr(rt.run_smb, k),
                      np.asarray(getattr(rj.run_smb, k)))
        assert gap <= TOL, (rt.time, k, gap)


def test_antarctica_region_through_a_remesh(regions):
    rt, rj, traj, n_calls = regions
    for got, want in traj:
        assert got[1:] == want[1:]
        assert abs(got[0] - want[0]) <= 1e-12
    assert rt.n_dt_ice == rj.n_dt_ice >= 4
    assert rt.n_mesh_updates == 1
    # every component acted: the bed moved, the firn and the SMB evolved,
    # the calving front took the glacial-index LMB
    assert rt.gia_events >= 3
    assert float(rt.state.dHb.abs().max()) > 0.0
    assert rt.run_smb.calls == n_calls >= 6
    assert float(rt.LMB.min()) < 0.0
