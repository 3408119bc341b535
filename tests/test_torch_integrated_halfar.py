"""The Halfar-dome runners of the integrated tests (run_halfar,
run_halfar_matrix) against the JAX package's, in f64 on the CPU, on small
stand-ins of the reference's Halfar configs (tests/torch_port_fixture.py
H_HALFAR: SIA, 150 km, the schema's 3-D heat equation in the dynamic
dome). Cost functions within 1e-10 relative, stability counters equal."""

import json

import pytest

from torch_port_fixture import (H_HALFAR, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

DIR = "idealised/Halfar_dome"
# the static dome: its SMB cancels the t = 0 thinning, so it holds its
# shape; without thermodynamics, to keep the file short
STATIC = dict(H_HALFAR, choice_thermo_model="none",
              choice_initial_ice_temperature_ANT="uniform",
              end_time_of_run=1.0)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {
        f"{DIR}/config_Halfar_40km.cfg": H_HALFAR,
        f"{DIR}/config_Halfar_static_40km.cfg": STATIC})
    point_harness_at(monkeypatch, root)
    return root


def test_halfar(ref, tmp_path):
    rj = jit.run_halfar(tmp_path / "j", resolution_km=40)
    rt = tit.run_halfar(tmp_path / "t", resolution_km=40, device="cpu")
    assert_same_scores(rt, rj)
    s = scores(rt)
    assert 0.0 < s["rmse"] < 60.0 and s["n_dt_ice"] > 1
    names = [p.name for p in (tmp_path / "t").iterdir()]
    assert names == [p.name for p in (tmp_path / "j").iterdir()]
    assert names == [f"it_ideal_Hlf_dome_Halfar_40km_{rt.git_hash}.json"]


def test_halfar_matrix_resumes(ref, tmp_path):
    """The matrix skips the tiers its scoreboard already holds (here the
    dynamic and the two adaptive tiers, written beforehand) and runs the
    rest: the static dome, scored at t = 0."""
    for d in (tmp_path / "j", tmp_path / "t"):
        d.mkdir()
        for stem in ("Halfar_40km", "Halfar_adaptive_10km",
                     "Halfar_adaptive_5km"):
            (d / f"it_ideal_Hlf_dome_{stem}_scored.json").write_text(
                json.dumps({"name": stem}))
    rj = jit.run_halfar_matrix(tmp_path / "j", resolutions=(40,))
    rt = tit.run_halfar_matrix(tmp_path / "t", resolutions=(40,),
                               device="cpu")
    assert [r.name for r in rt] == [r.name for r in rj] \
        == ["Halfar_static_40km"]
    assert_same_scores(rt[0], rj[0])
    assert scores(rt[0])["rmse"] < 60.0
