"""The quick tier of the integrated tests (validation/integrated_tests.py)
against the JAX package's: the SSA ice stream, ISMIP-HOM A with DIVA and
MISMIP+, each runner in both packages on the same small stand-in configs,
written in the reference's layout to a temporary directory that both
harnesses' REF_TESTS point at; in f64 on the CPU. Cost functions within
1e-10 relative, stability counters equal. And the program's
`integrated_tests` commands, which run the tier's runners on --device."""

import json

import pytest
import torch

from torch_port_fixture import (H_MISMIPPLUS, H_SSA, assert_same_scores,
                                h_ismip, point_harness_at, scores,
                                write_standins)

from ufemism2_tpu.validation import integrated_tests as jit
from ufemism2_tpu_torch.validation import integrated_tests as tit
from ufemism2_tpu_torch.main import program as tprog

STANDINS = {
    "idealised/SSA_icestream/config_01_32km.cfg": H_SSA,
    "idealised/ISMIP-HOM/config_ISMIP_HOM_A_160_DIVA.cfg": h_ismip("DIVA"),
    "idealised/MISMIPplus/config_01_5km_spinup_part0.cfg": H_MISMIPPLUS,
}


@pytest.fixture
def ref(tmp_path, monkeypatch):
    root = write_standins(tmp_path / "ref", STANDINS)
    point_harness_at(monkeypatch, root)
    return root


def test_constants_are_the_jax_packages():
    """Without a caller's setting, the harness reads the reference's
    configs where the JAX package does."""
    assert str(tit.MISMIP_MOD_DIR) == str(tit.REF_TESTS
                                          / "idealised/MISMIP_mod")
    assert str(tit.ANT_CFG).startswith(str(tit.REF_TESTS / "realistic"))
    assert str(tit.REF_TESTS).endswith(
        "reference/automated_testing/integrated_tests")
    assert str(jit.REF_TESTS).endswith(
        "reference/automated_testing/integrated_tests")
    assert tit._ref_published_rmse("A", "DIVA", 160) is None \
        and jit._ref_published_rmse("A", "DIVA", 160) is None


def test_ssa_icestream(ref, tmp_path):
    rj = jit.run_ssa_icestream(tmp_path / "sj", resolutions=(32,))
    rt = tit.run_ssa_icestream(tmp_path / "st", resolutions=(32,),
                               device="cpu")
    assert_same_scores(rt, rj)
    s = scores(rt)
    # the Schoof (2006) stream: a real geometry, so a real score
    assert 10.0 < s["RMSE_32km"] < 1000.0 and s["n_dt_ice"] == 1
    names = sorted(p.name for p in (tmp_path / "st").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "sj").iterdir())
    assert names == [f"it_ideal_SSA_icestream_SSA_icestream_"
                     f"{rt.git_hash}.json"]
    # a second call merges the first call's cost functions (per-tier
    # processes accumulate into one entry)
    rt2 = tit.run_ssa_icestream(tmp_path / "st", resolutions=(32,),
                                device="cpu")
    names2 = [c["name"] for c in rt2.cost_functions]
    assert names2.count("RMSE_32km") == 1
    assert scores(rt2)["RMSE_32km"] == scores(rt)["RMSE_32km"]


def test_ismip_hom_diva(ref, tmp_path):
    rj, uj = jit.run_ismip_hom(None, "A", 160, "DIVA",
                               _return_transect=True)
    rt, ut = tit.run_ismip_hom(tmp_path, "A", 160, "DIVA",
                               _return_transect=True, device="cpu")
    assert_same_scores(rt, rj)
    assert abs(ut - uj).max() <= 1e-10 * abs(uj).max()
    s = scores(rt)
    assert 0.0 < s["u_surf_min"] < s["u_surf_mean"] < s["u_surf_max"]
    assert (tmp_path / f"it_ideal_ISMIP_HOM_experiment_A_DIVA_L160_"
            f"{rt.git_hash}.json").exists()


def test_mismipplus(ref, tmp_path):
    """The full-configuration branch (quick=False): the stand-in's own
    resolution and window, the reference's 100 m slab (no grounding line
    yet, so the scores are NaN in both packages)."""
    rj = jit.run_mismipplus(None, quick=False)
    rt = tit.run_mismipplus(tmp_path, quick=False, device="cpu")
    assert_same_scores(rt, rj)
    assert rt.name == "MISMIPplus" and scores(rt)["n_dt_ice"] >= 2
    entry = json.loads(next(tmp_path.glob("it_ideal_MISMIPplus_*.json"))
                       .read_text())
    assert [c["name"] for c in entry["cost_functions"]][:2] \
        == ["x_GL_km", "err_x_GL_init"]


@pytest.mark.parametrize("command,quick", [("integrated_tests", True),
                                           ("integrated_tests_full", False)])
def test_program_runs_the_tier(command, quick, monkeypatch, tmp_path):
    """`python -m ufemism2_tpu_torch integrated_tests[_full]` runs the
    harness's tier on --device into --output-dir (no NotImplementedError;
    the runners themselves are held above and in the other files)."""
    seen = []
    monkeypatch.setattr(tit, "run_all_integrated_tests",
                        lambda d, quick=True, verbose=True, device="cuda":
                        seen.append((d, quick, device)) or ["ran"])
    out = tprog.main([command, "--output-dir", str(tmp_path),
                      "--device", "cpu"])
    assert out == ["ran"] and seen == [(str(tmp_path), quick, "cpu")]


def test_quick_tier_calls(monkeypatch):
    """run_all_integrated_tests' quick tier: the four runners the JAX
    package's calls, with its arguments and the device."""
    calls = []

    def rec(name):
        def f(*a, **k):
            calls.append((name, a, k))
            return tit.ScoreboardRun(name, "integrated_tests/x")
        return f
    for name in ("run_halfar", "run_ssa_icestream", "run_ismip_hom",
                 "run_mismipplus"):
        monkeypatch.setattr(tit, name, rec(name))
    runs = tit.run_all_integrated_tests("sb", quick=True, verbose=False,
                                        device="cpu")
    cpu = torch.device("cpu")
    assert [r.name for r in runs] == ["run_halfar", "run_ssa_icestream",
                                      "run_ismip_hom", "run_mismipplus"]
    assert calls == [
        ("run_halfar", ("sb",), dict(resolution_km=40, quick=True,
                                     device=cpu)),
        ("run_ssa_icestream", ("sb",), dict(resolutions=(32,), device=cpu)),
        ("run_ismip_hom", ("sb", "A", 160, "DIVA"), dict(device=cpu)),
        ("run_mismipplus", ("sb",), dict(quick=True, device=cpu))]
