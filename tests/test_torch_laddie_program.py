"""The port's standalone LADDIE program and LADDIE in a region, against
the JAX package, f64:

- `python -m ufemism2_tpu_torch laddie <cfg> --device cpu` (through
  program.main) on tests/test_laddie.py's standalone configuration (the
  MISMIP+ geometry at 40 km, the MISMIP+ WARM ocean, 0.25 days at
  dt_laddie 360 s, in two output legs): both output files and every field
  in them against the JAX package's run_laddie_standalone, 1e-10
  relative;
- the 40 km MISMIP+ region of tests/torch_port_fixture.py with BMB
  'laddie' under the ISOMIP+ WARM ocean and the idealised subglacial
  discharge, over two BMB intervals of half a year (the LADDIE legs cut
  to 0.1 and 0.05 days): equal dt trajectories and solver counts, the
  fields and the BMB within 1e-10 of their largest value, the initial leg
  once."""

import numpy as np
import pytest
import torch

from torch_port_fixture import (build_meshes_for, mismipplus_configs,
                                mesh_to_numpy, rel_gap)

from ufemism2_tpu.io.ncio import NCFile as JaxNC
from ufemism2_tpu.main.laddie_program import run_laddie_standalone as jrun
from ufemism2_tpu.main.region import ModelRegion as JaxRegion

from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.main import program
from ufemism2_tpu_torch.main.laddie_program import (MESH_FIELDS,
                                                    SCALAR_FIELDS,
                                                    run_laddie_standalone)
from ufemism2_tpu_torch.main.region import ModelRegion

TOL = 1e-10

STANDALONE = """&CONFIG
  choice_refgeo_init_ANT = 'idealised'
  choice_refgeo_PD_ANT = 'idealised'
  choice_refgeo_PD_idealised = 'MISMIPplus'
  choice_refgeo_init_idealised = 'MISMIPplus'
  refgeo_idealised_MISMIPplus_Hi_init = 100.0
  xmin_ANT = 0.0
  xmax_ANT = 800e3
  ymin_ANT = -40e3
  ymax_ANT = 40e3
  maximum_resolution_uniform = 40e3
  nit_Lloyds_algorithm = 1
  choice_ocean_model_ANT = 'idealised'
  choice_ocean_model_idealised = 'MISMIPplus_WARM'
  dt_laddie = 360.0
  time_duration_laddie_init = 0.25
  dt_output = 0.125
/
"""


def test_standalone_program(tmp_path):
    cfg = tmp_path / "laddie_test.cfg"
    cfg.write_text(STANDALONE)
    lj, mj = jrun(str(cfg), str(tmp_path / "jax"))
    out = program.main(["laddie", str(cfg), "--output-dir",
                        str(tmp_path / "port"), "--device", "cpu"])
    lt, mt = out
    assert float(mt.max()) > 0.0
    assert rel_gap(mt, np.asarray(mj)) <= TOL
    for k in ("H", "U", "V", "T", "S"):
        assert rel_gap(getattr(lt, k), np.asarray(getattr(lj, k))) <= TOL, k
    last = run_laddie_standalone.last
    assert last["shelf"] > 0 and last["steps"] == 2 * (30 + 1)
    for name, fields in (("laddie_output_fields_mesh.nc", MESH_FIELDS),
                         ("laddie_scalar_output.nc", SCALAR_FIELDS)):
        with NCFile(str(tmp_path / "port" / name)) as a, \
                JaxNC(str(tmp_path / "jax" / name)) as b:
            assert np.allclose(a.read("time"), b.read("time"))
            assert len(a.read("time")) == 2
            for f in fields:
                va, vb = a.read(f), b.read(f)
                assert np.isfinite(va).all(), f
                assert rel_gap(va, vb) <= TOL, (name, f)


def test_laddie_entry_needs_a_config():
    with pytest.raises(SystemExit):
        program.main(["laddie"])


REGION = dict(choice_BMB_model_ANT="laddie",
              choice_ocean_model_ANT="idealised",
              choice_ocean_model_idealised="ISOMIP",
              choice_ocean_isomip_scenario="WARM",
              choice_laddie_SGD="idealised",
              choice_laddie_SGD_idealised="MISMIPplus_PC",
              start_time_of_applying_SGD=-1e9,
              dt_laddie=360.0, time_duration_laddie_init=0.1,
              time_duration_laddie=0.05, dt_BMB=0.5, dt_ocean=0.5,
              end_time_of_run=1.0)


def test_mismipplus_region_with_laddie():
    Cj, Ct = mismipplus_configs(**REGION)
    mj, mt = build_meshes_for(Cj)
    rj = JaxRegion(Cj, "ANT", mesh=mj)
    rt = ModelRegion(Ct, "ANT", mesh=mt, device="cpu")
    assert rel_gap(rt.BMB, np.asarray(rj.BMB)) <= TOL
    assert float(rt.BMB.min()) < 0.0
    for t in (0.5, 1.0):
        sj, st = rj.run_to(t), rt.run_to(t)
        assert (st.n_visc_its, st.n_Axb_its) == (int(sj.n_visc_its),
                                                 int(sj.n_Axb_its))
        assert abs(st.dt_ice - float(sj.dt_ice)) <= 1e-12
        for k in ("Hi", "u_vav_b", "v_vav_b"):
            assert rel_gap(getattr(st, k),
                           np.asarray(getattr(sj, k))) <= TOL, (t, k)
        assert rel_gap(rt.BMB, np.asarray(rj.BMB)) <= TOL, t
    assert rt.n_dt_ice == rj.n_dt_ice
    legs = rt.run_bmb.legs
    assert legs[0]["initial"] and not any(l["initial"] for l in legs[1:])
    assert len(legs) >= 3 and legs[0]["nV"] % 256 == 0


@pytest.mark.parametrize("over", [
    dict(REGION),
    dict(choice_SMB_model_ANT="reconstructed",
         choice_regions_of_interest="Patagonia"),
    dict(choice_tracer_tracking_model="particles"),
    dict(choice_basal_hydrology_model="Salle2025"),
    dict(choice_regions_of_interest="Pine_Island_Glacier,Thwaites_Glacier"),
], ids=["laddie", "reconstructed", "particles", "Salle2025", "ROIs"])
def test_slice_accepts_ported_choices(over):
    """The choices this slice ported build a region (which raised
    NotImplementedError before); more than one device still does not."""
    _, Ct = mismipplus_configs(**over)
    Cj, _ = mismipplus_configs()
    _, mt = build_meshes_for(Cj)
    r = ModelRegion(Ct, "ANT", mesh=mt, device="cpu")
    assert torch.isfinite(r.SMB).all() and torch.isfinite(r.BMB).all()
    _, Ct = mismipplus_configs(tpu_n_devices=2, **over)
    with pytest.raises(NotImplementedError, match="tpu_n_devices"):
        ModelRegion(Ct, "ANT", mesh=mt, device="cpu")
