"""run_berends_exp_II (Berends et al. (2023) bed-roughness nudging,
experiment II, the MISMIP+ channel, friction only; method 'H_u_flowline')
against the JAX package's, in f64 on the CPU, on the small stand-in of the
reference's spin-up config (tests/torch_port_fixture.py BERENDS_STANDINS) at
20 km (at 40 km no triangle lies wholly in the sliding grounded mask the
velocity score reads), each leg one 0.1-year step. The harness writes its
own input files (the true till friction angle, the SMB). Cost functions
within 1e-10 relative, stability counters equal.

One step a leg: p95_ice_thickness is the 95th percentile of a difference of
two close surfaces (about 1.5 m against some 500 m), which amplifies the
last bits at which two f64 GMRES solves part; after two steps a leg it parts
by 4e-10 relative, beyond this file's tolerance."""

import pytest

from torch_port_fixture import (BERENDS_STANDINS, assert_same_scores,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

KW = dict(method="H_u_flowline", resolution=20e3, t_spinup=0.1,
          t_invert=0.1)


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", BERENDS_STANDINS)
    point_harness_at(monkeypatch, root)
    return root


def test_berends_exp_II_H_u_flowline(ref, tmp_path):
    rj = jit.run_berends_exp_II(scoreboard_dir=tmp_path / "j", **KW)
    rt = tit.run_berends_exp_II(scoreboard_dir=tmp_path / "t", device="cpu",
                                **KW)
    assert_same_scores(rt, rj)
    s = scores(rt)
    assert s["r95_till_friction_angle"] >= 1.0 and s["n_dt_ice"] >= 1
    assert [p.name for p in (tmp_path / "t").iterdir()] \
        == [p.name for p in (tmp_path / "j").iterdir()]
