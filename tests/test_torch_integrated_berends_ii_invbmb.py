"""run_berends_exp_II (Berends et al. (2023) bed-roughness nudging,
experiment II, the MISMIP+ channel, with the retreat leg and the
simultaneous friction and BMB inversion; method 'dHdt_invfric_invBMB')
against the JAX package's, in f64 on the CPU, on the small stand-in of the
reference's spin-up config (tests/torch_port_fixture.py BERENDS_STANDINS) at
40 km, each leg cut to 0.2 model years. The harness writes its own input
files (the true till friction angle, the SMB). Cost functions within 1e-10
relative, stability counters equal."""

import pytest

from torch_port_fixture import (BERENDS_STANDINS, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

KW = dict(method="dHdt_invfric_invBMB", resolution=40e3, t_spinup=0.2,
          t_invert=0.2, t_retreat=0.2)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", BERENDS_STANDINS)
    point_harness_at(monkeypatch, root)
    return root


def test_berends_exp_II_dHdt_invfric_invBMB(ref, tmp_path):
    rj = jit.run_berends_exp_II(scoreboard_dir=tmp_path / "j", **KW)
    rt = tit.run_berends_exp_II(scoreboard_dir=tmp_path / "t", device="cpu",
                                **KW)
    assert_same_scores(rt, rj)
    s = scores(rt)
    assert s["r95_till_friction_angle"] >= 1.0 and s["n_dt_ice"] >= 1
    assert [p.name for p in (tmp_path / "t").iterdir()] \
        == [p.name for p in (tmp_path / "j").iterdir()]
