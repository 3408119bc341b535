"""run_ismip_hom_matrix (validation/integrated_tests.py) against the JAX
package's, in f64 on the CPU: ISMIP-HOM A at L = 160 km with DIVA and BPA
on a small stand-in mesh (tests/torch_port_fixture.py h_ismip), each cell
scored, the transects kept as sidecar files, and the crosscheck entry
(rmse of DIVA's u_surf against BPA's). Cost functions within 1e-10
relative, stability counters equal; a second call resumes from the
sidecars."""

import numpy as np
import pytest

from torch_port_fixture import (assert_same_scores, h_ismip,
                                point_harness_at, scores, write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit

DIR = "idealised/ISMIP-HOM"


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", {
        f"{DIR}/config_ISMIP_HOM_A_160_{a}.cfg": h_ismip(a)
        for a in ("DIVA", "BPA")})
    point_harness_at(monkeypatch, root)
    return root


def test_ismip_hom_matrix(ref, tmp_path):
    kw = dict(experiments=("A",), Ls=(160,),
              approximations=("DIVA", "BPA"), verbose=False)
    rj = jit.run_ismip_hom_matrix(tmp_path / "sj",
                                  output_dir=str(tmp_path / "oj"), **kw)
    rt = tit.run_ismip_hom_matrix(tmp_path / "st",
                                  output_dir=str(tmp_path / "ot"),
                                  device="cpu", **kw)
    assert [r.name for r in rt] == [r.name for r in rj] == [
        "experiment_A_DIVA_L160", "experiment_A_BPA_L160",
        "experiment_A_crosscheck_L160"]
    for a, b in zip(rt, rj):
        assert_same_scores(a, b)
    x = scores(rt[2])
    assert 0.0 < x["rmse_DIVA_vs_BPA"] and x["n_failed_cells"] == 0.0
    for approx in ("DIVA", "BPA"):
        ut = np.load(tmp_path / "ot" / f"u_A_{approx}_L160.npy")
        uj = np.load(tmp_path / "oj" / f"u_A_{approx}_L160.npy")
        assert ut.shape == (100,)
        assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()
    assert sorted(p.name for p in (tmp_path / "st").iterdir()) \
        == sorted(p.name for p in (tmp_path / "sj").iterdir())
    # a second call: both cells scored, their transects on disk, so only
    # the crosscheck is rebuilt (from the sidecars)
    again = tit.run_ismip_hom_matrix(tmp_path / "st",
                                     output_dir=str(tmp_path / "ot"),
                                     device="cpu", **kw)
    assert [r.name for r in again] == ["experiment_A_crosscheck_L160"]
    assert_same_scores(again[0], rt[2])
