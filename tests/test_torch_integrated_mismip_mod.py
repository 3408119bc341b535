"""run_mismip_mod (the MISMIP_mod hysteresis chain of the integrated tests'
full tier: a 40 km spin-up, a 10 km spin-up, an advance and a retreat leg,
scored by the grounding-line radii on the eight octant transects) against
the JAX package's, in f64 on the CPU, on small stand-ins of the four leg
configs (tests/torch_port_fixture.py FIXTURE's MISMIP_mod geometry, SIA,
200 km with 128 km at the grounding line, each leg cut to 0.2 model
years): in one process (the geometry handed on in memory) and one leg a
call (handed on through the previous leg's output files). Cost functions
within 1e-10 relative, stability counters equal."""

import json

import pytest

from torch_port_fixture import (FIXTURE, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

LEG = dict(FIXTURE, choice_stress_balance_approximation="SIA",
           maximum_resolution_grounding_line=128e3,
           grounding_line_width=128e3, dt_output=0.1,
           start_time_of_run=0.0, end_time_of_run=0.2)
LEGS = {"config_01_spinup_40km.cfg": LEG,
        "config_02_spinup_10km.cfg": LEG,
        "config_03_advance_10km.cfg": dict(LEG,
                                           uniform_Glens_flow_factor=1e-17),
        "config_04_retreat_10km.cfg": LEG}
T = dict(t_spin40=0.2, t_spin10=0.2, t_adv=0.2, t_ret=0.2)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {
        f"idealised/MISMIP_mod/{k}": v for k, v in LEGS.items()})
    point_harness_at(monkeypatch, root)
    return root


def test_chain_in_one_process(ref, tmp_path):
    rj = jit.run_mismip_mod(tmp_path / "j", **T)
    rt = tit.run_mismip_mod(tmp_path / "t", device="cpu", **T)
    assert_same_scores(rt, rj)
    s = scores(rt)
    assert rt.name == "MISMIP_mod"
    assert all(f"GL_hyst_{oc}" in s for oc in tit._OCTANTS)
    assert [p.name for p in (tmp_path / "t").iterdir()] \
        == [p.name for p in (tmp_path / "j").iterdir()]


def test_one_leg_a_call(ref, tmp_path):
    """only_leg: each leg a call with its own output directory, legs 2-4
    chained through the previous leg's files; leg 4 writes the entry."""
    out = {}
    for tag, it, kw in (("j", jit, {}), ("t", tit, {"device": "cpu"})):
        o = str(tmp_path / f"out_{tag}")
        out[tag] = [it.run_mismip_mod(tmp_path / f"sb_{tag}", output_dir=o,
                                      only_leg=n, **T, **kw)
                    for n in (1, 2, 3, 4)]
    for rt, rj in zip(out["t"], out["j"]):
        assert_same_scores(rt, rj)
    assert [r.name for r in out["t"]] == [
        "MISMIP_mod_leg1", "MISMIP_mod_leg2", "MISMIP_mod_leg3",
        "MISMIP_mod"]
    assert scores(out["t"][1])["t_end"] == pytest.approx(0.2)
    rgl = json.loads((tmp_path / "out_t" / "rGL_leg_04.json").read_text())
    assert set(rgl) == set(tit._OCTANTS)
    assert (tmp_path / "out_t" / "leg_03" / "restart_ANT_00001.nc"
            ).read_bytes()[:3] == b"CDF"
