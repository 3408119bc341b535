"""run_mismipplus_iceocean1r (the MISOMIP iceocean1r leg of the integrated
tests' full tier: MISMIP+ with the LADDIE melt) against the JAX package's,
in f64 on the CPU: a short spin-up of the small MISMIP+ stand-in, then
half a model year with LADDIE under the ISOMIP+ WARM ocean (the legs cut
as in tests/test_torch_laddie_program.py). Cost functions within 1e-10
relative, stability counters equal."""

import json

import pytest

from torch_port_fixture import (H_MISMIPPLUS, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

DIR = "idealised/MISMIPplus"
ICEOCEAN1R = dict(H_MISMIPPLUS, choice_BMB_model_ANT="laddie",
                  choice_ocean_model_ANT="idealised",
                  choice_ocean_model_idealised="ISOMIP",
                  choice_ocean_isomip_scenario="WARM",
                  dt_laddie=360.0, time_duration_laddie_init=0.1,
                  time_duration_laddie=0.05, dt_BMB=0.25, dt_ocean=0.25,
                  start_time_of_run=0.0, end_time_of_run=0.5)
SLAB = dict(refgeo_idealised_MISMIPplus_Hi_init=500.0)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {
        f"{DIR}/config_01_5km_spinup_part0.cfg": H_MISMIPPLUS,
        f"{DIR}/config_06_5km_iceocean1r.cfg": ICEOCEAN1R})
    point_harness_at(monkeypatch, root)
    return root


def test_iceocean1r(ref, tmp_path):
    runs = {}
    for tag, it, kw in (("j", jit, {}), ("t", tit, {"device": "cpu"})):
        spin = str(tmp_path / f"spin_{tag}")
        it.run_mismipplus_spinup(spin, None, end_time=0.2, dt_restart=0.1,
                                 **SLAB, **kw)
        runs[tag] = it.run_mismipplus_iceocean1r(
            spin, str(tmp_path / f"io_{tag}"), tmp_path / f"sb_{tag}",
            **SLAB, **kw)
    assert_same_scores(runs["t"], runs["j"])
    s = scores(runs["t"])
    assert runs["t"].name == "MISOMIP" and s["n_dt_ice"] > 1
    assert {"err_x_GL_final_lo", "err_x_GL_final_hi"} <= set(s)
    rec = json.loads((tmp_path / "io_t" / "x_GL_series.json").read_text())
    assert len(rec["x_GL"]) == 2
    assert [p.name for p in (tmp_path / "sb_t").iterdir()] \
        == [p.name for p in (tmp_path / "sb_j").iterdir()]
