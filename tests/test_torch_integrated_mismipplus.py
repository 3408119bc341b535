"""The MISMIP+ chain of the integrated tests' full tier
(run_mismipplus_spinup, run_mismipplus_ice1r and the resume of
_mismip_resume_region) against the JAX package's, in f64 on the CPU, on
small stand-ins (tests/torch_port_fixture.py H_MISMIPPLUS: 40 km, 500 m
of initial ice so that a grounding line exists): a spin-up leg of 0.3
model years, its resumption to 0.4 from its own restart, then the ice1r
retreat leg from it with a tuned flow-factor scale to restore. Each
package chains its own files (the port's NetCDF classic restarts, the JAX
package's NetCDF4 ones). Cost functions within 1e-10 relative, stability
counters equal."""

import gc
import json

import pytest

from torch_port_fixture import (H_MISMIPPLUS, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

DIR = "idealised/MISMIPplus"
# the ice1r leg: the MISMIP+ ice1r melt, half a model year from the
# spin-up's end
ICE1R = dict(H_MISMIPPLUS, choice_BMB_model_ANT="idealised",
             choice_BMB_model_idealised="MISMIP+", dt_BMB=0.25,
             start_time_of_run=0.0, end_time_of_run=0.5)
SLAB = dict(refgeo_idealised_MISMIPplus_Hi_init=500.0)
SCALE = {"scale": 0.9, "A0": 2.0e-17, "t": 0.3, "gain": 0.5,
         "last_err": 1000.0}


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {
        f"{DIR}/config_01_5km_spinup_part0.cfg": H_MISMIPPLUS,
        f"{DIR}/config_03_5km_ice1r.cfg": ICE1R})
    point_harness_at(monkeypatch, root)
    return root


def test_spinup_resume_and_ice1r(ref, tmp_path):
    runs = {}
    for tag, it, kw in (("j", jit, {}), ("t", tit, {"device": "cpu"})):
        spin = tmp_path / f"spin_{tag}"
        sb = tmp_path / f"sb_{tag}"
        first = it.run_mismipplus_spinup(str(spin), sb, end_time=0.3,
                                         dt_restart=0.1, **SLAB, **kw)
        # a fresh call with the same directory resumes from its restart
        # (the JAX package's first region holds its NetCDF4 files open
        # until it is collected)
        gc.collect()
        again = it.run_mismipplus_spinup(str(spin), sb, end_time=0.4,
                                         dt_restart=0.1, **SLAB, **kw)
        (spin / "glen_A_scale.json").write_text(json.dumps(SCALE))
        ice1r = it.run_mismipplus_ice1r(
            str(spin), str(tmp_path / f"ir_{tag}"), sb, **SLAB, **kw)
        runs[tag] = (first, again, ice1r)
    for rt, rj in zip(runs["t"], runs["j"]):
        assert_same_scores(rt, rj)
    first, again, ice1r = (scores(r) for r in runs["t"])
    assert 0.0 < first["x_GL_km"] < 800.0
    assert again["n_dt_ice"] > first["n_dt_ice"]
    assert runs["t"][2].name == "MISMIPplus_5km_ice1r"
    assert ice1r["n_dt_ice"] > again["n_dt_ice"]
    # the leg's series: its start and one reading after the half year
    rec = json.loads((tmp_path / "ir_t" / "x_GL_series.json").read_text())
    assert len(rec["x_GL"]) == 2 and abs(rec["t_end"] - 0.9) < 1e-12
    assert (tmp_path / "ir_t" / "restart_ANT_00001.nc").read_bytes()[:3] \
        == b"CDF"
    assert sorted(p.name for p in (tmp_path / "sb_t").iterdir()) \
        == sorted(p.name for p in (tmp_path / "sb_j").iterdir())


def test_resume_restores_the_tuned_scale(ref, tmp_path):
    """_mismip_resume_region: the newest restart and, into the region's
    glen_A_scale slot in place, the scale and the controller's state of
    glen_A_scale.json."""
    from ufemism2_tpu_torch.config import load_config
    spin = tmp_path / "spin"
    tit.run_mismipplus_spinup(str(spin), None, end_time=0.1,
                              dt_restart=0.1, device="cpu", **SLAB)
    (spin / "glen_A_scale.json").write_text(json.dumps(SCALE))
    C = load_config(str(ref / DIR / "config_01_5km_spinup_part0.cfg"),
                    refgeo_idealised_MISMIPplus_Hi_init=500.0)
    r, resumed = tit._mismip_resume_region(C, str(spin), device="cpu")
    assert resumed and abs(r.time - 0.1) < 1e-12
    assert float(r.md.extras["glen_A_scale"].arr) == pytest.approx(0.9)
    assert r._mismip_tune == {"gain": 0.5, "last_err": 1000.0}
    r2, resumed2 = tit._mismip_resume_region(C, str(tmp_path / "none"),
                                             device="cpu")
    assert not resumed2 and r2.time == 0.0
