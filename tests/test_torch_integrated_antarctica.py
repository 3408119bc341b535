"""run_antarctica_40km (the realistic Antarctica initialisation of the
integrated tests) against the JAX package's, in f64 on the CPU: a coarse
stand-in of the reference's config (the inversion set-up of chip_smoke.py
ant_init_cfg at 600 km, no thermodynamics), each package on its own copy
of the synthetic continent written by its own generator into a temporary
directory at 80 km (tools/antarctica_synthetic.py ensure_data for the
port, the repository's tools/gen_antarctica_synthetic.py for the JAX
package), a coupling interval of 0.2 model years and a second one resumed
from the restart.
Cost functions within 1e-10 relative, stability counters equal."""

import gc
import sys
from pathlib import Path

import pytest

from torch_port_fixture import (ANT_CFG_REL, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.tools import antarctica_synthetic as writer
from ufemism2_tpu_torch.validation import integrated_tests as tit

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import gen_antarctica_synthetic as generator   # noqa: E402

RES = 600e3
DX = 80e3       # the synthetic data's grid (the harness's default is 20 km)
# the reference's choices (file geometry, realistic snapshot climate,
# prescribed SMB, geothermal flux and target thinning from files,
# Zoet-Iverson with H_dHdt_flowline nudging, inverted BMB); the file
# names are the harness's to set
ANT = dict(
    choice_refgeo_init_ANT="read_from_file",
    choice_refgeo_PD_ANT="read_from_file",
    choice_refgeo_GIAeq_ANT="read_from_file",
    xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
    choice_climate_model_ANT="realistic",
    choice_climate_model_realistic="snapshot",
    do_lapse_rate_corrections_ANT=True,
    choice_SMB_model_ANT="prescribed",
    choice_geothermal_heat_flux="read_from_file",
    do_target_dHi_dt=True,
    choice_sliding_law="Zoet-Iverson", do_bed_roughness_nudging=True,
    choice_bed_roughness_nudging_method="H_dHdt_flowline",
    bed_roughness_nudging_dt=0.2,
    choice_BMB_model_ANT="inverted",
    choice_thermo_model="none", choice_ice_rheology_Glen="uniform",
    choice_initial_ice_temperature_ANT="uniform",
    allow_mesh_updates=False,
    maximum_resolution_uniform=800e3,
    maximum_resolution_grounded_ice=RES,
    maximum_resolution_floating_ice=2 * RES,
    maximum_resolution_grounding_line=RES, grounding_line_width=RES,
    maximum_resolution_calving_front=2 * RES, calving_front_width=2 * RES,
    maximum_resolution_ice_front=2 * RES, ice_front_width=2 * RES,
    nit_Lloyds_algorithm=2, tpu_precision="f64", visc_it_nit=3,
    pc_nit_max=2, start_time_of_run=0.0, dt_coupling=0.2)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {ANT_CFG_REL: ANT})
    point_harness_at(monkeypatch, root)
    monkeypatch.setattr(writer, "DATA_DIR", tmp_path / "data_port")
    inner_t, inner_j = writer.ensure_data, generator.ensure_data
    monkeypatch.setattr(writer, "ensure_data", lambda: inner_t(dx=DX))
    monkeypatch.setattr(generator, "ensure_data", lambda: inner_j(
        dx=DX, data_dir=tmp_path / "data_jax"))
    return root


def test_antarctica(ref, tmp_path):
    kw = dict(end_time=0.2, dt_restart=0.2)
    rj = jit.run_antarctica_40km(str(tmp_path / "oj"), tmp_path / "sj", **kw)
    rt = tit.run_antarctica_40km(str(tmp_path / "ot"), tmp_path / "st",
                                 device="cpu", **kw)
    assert_same_scores(rt, rj)
    s = scores(rt)
    assert rt.name == "Antarctica_init_40km_synthetic"
    assert s["t_end"] == pytest.approx(0.2) and s["ice_area_Mkm2"] > 1.0
    assert 0.0 <= s["rmse_Hi_vs_init"] < 100.0
    # the port's files: the five the run reads, written once
    files = sorted(p.name for p in (tmp_path / "data_port").iterdir())
    assert {writer.NAMES[k] for k in writer.INIT_KEYS} <= set(files)
    # a second call with a later end resumes from the restart, and finds
    # the data in place
    stamp = (tmp_path / "data_port" / writer.NAMES["topo"]).stat().st_mtime
    # the JAX package's first region holds its NetCDF4 scalar file open
    # until it is collected; the resumed region writes the same file
    gc.collect()
    rj2 = jit.run_antarctica_40km(str(tmp_path / "oj"), None, end_time=0.4,
                                  dt_restart=0.2)
    rt2 = tit.run_antarctica_40km(str(tmp_path / "ot"), None, end_time=0.4,
                                  dt_restart=0.2, device="cpu")
    assert_same_scores(rt2, rj2)
    assert scores(rt2)["t_end"] == pytest.approx(0.4)
    assert (tmp_path / "data_port" / writer.NAMES["topo"]).stat().st_mtime \
        == stamp


def test_ensure_data_writes_only_if_absent(tmp_path):
    got = writer.ensure_data(dx=200e3, data_dir=tmp_path)
    assert set(got) == set(writer.NAMES)
    again = writer.ensure_data(dx=200e3, data_dir=tmp_path)
    assert set(again) == set(writer.INIT_KEYS)
    assert all(again[k] == got[k] for k in writer.INIT_KEYS)
    (tmp_path / writer.NAMES["ghf"]).unlink()
    assert set(writer.ensure_data(dx=200e3, data_dir=tmp_path)) \
        == set(writer.NAMES)
