"""The config-file entry point: the port's `program.main` on a `.cfg`
written here, on the CPU, against the JAX package's `run_model` on the
same file - the MISMIP+ configuration (ocean-pressure calving front,
Weertman sliding) with the flow-factor tuning on, three coupling
intervals, in f64.

The final scalars agree to 1e-10 (the trajectories are the same f64
arithmetic, summation order apart; measured 1e-14); the config copy, the
manifest's keys, the resource-tracking records and the names of the
region's NetCDF files are those the JAX package writes."""

import json

import numpy as np
import pytest
import torch

from torch_port_fixture import MISMIPPLUS

from ufemism2_tpu.main import program as jprog

from ufemism2_tpu_torch.main import program as tprog

TOL = 1e-10
# 500 m of ice in the MISMIP+ mask: a grounding line on the centreline,
# so that the tuning, which starts in the second coupling interval, has
# one to tune for. (At 600 m the JAX package's compiled step and its own
# eager evaluation part at a border vertex in the first step, where the
# thickness change cancels the thickness exactly; the port follows the
# eager one: ROADMAP, section C.)
RUN = dict(MISMIPPLUS, do_ANT=True,
           refgeo_idealised_MISMIPplus_Hi_init=500.0,
           refgeo_idealised_MISMIPplus_tune_A=True,
           start_time_of_run=0.0, end_time_of_run=0.3, dt_coupling=0.1)


def _literal(v):
    if isinstance(v, bool):
        return ".TRUE." if v else ".FALSE."
    if isinstance(v, str):
        return f"'{v}'"
    return repr(float(v)) if isinstance(v, float) else str(v)


def write_cfg(path, values):
    """A reference-style namelist: `&CONFIG`, one `key_config = value`
    line each, `/`."""
    lines = ["&CONFIG"] + [f"  {k}_config = {_literal(v)}  ! set here"
                           for k, v in values.items()] + ["/"]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("program")
    cfg = write_cfg(d / "mismipplus_test.cfg", RUN)
    rj = jprog.run_model(str(cfg), output_dir=str(d / "jax"))
    rt = tprog.main([str(cfg), "--output-dir", str(d / "torch"),
                     "--device", "cpu"])
    return d, cfg, rj, rt


def test_final_scalars_match_jax(runs):
    _, _, rj, rt = runs
    assert list(rt) == list(rj) == ["ANT"]
    a, b = rt["ANT"].scalars_history[-1], rj["ANT"].scalars_history[-1]
    assert sorted(a) == sorted(b)
    scale = max(abs(v) for v in b.values())
    for k in b:
        assert abs(a[k] - b[k]) <= TOL * max(abs(b[k]), 1e-6 * scale), \
            (k, a[k], b[k])
    assert a["time"] == 0.3 and a["ice_volume"] > 0.0 and a["n_Axb_its"] > 0
    assert rt["ANT"].n_dt_ice == rj["ANT"].n_dt_ice >= 3
    assert rt["ANT"].md.device.type == "cpu"


def test_flow_factor_was_tuned_as_jax(runs):
    _, _, rj, rt = runs
    st, sj = rt["ANT"], rj["ANT"]
    assert st._mismip_tune["gain"] == sj._mismip_tune["gain"]
    scale_t = float(st.md.x("glen_A_scale"))
    scale_j = float(np.asarray(sj.md.extras["glen_A_scale"].arr))
    assert scale_t != 1.0
    assert abs(scale_t - scale_j) <= 1e-9 * scale_j


def test_output_files_as_jax(runs):
    d, cfg, _, _ = runs
    ot, oj = d / "torch", d / "jax"
    assert (ot / cfg.name).read_text() == cfg.read_text() \
        == (oj / cfg.name).read_text()
    mt = json.loads((ot / "run_manifest.json").read_text())
    mj = json.loads((oj / "run_manifest.json").read_text())
    assert sorted(mt) == sorted(mj)
    assert mt["config"] == mj["config"] == str(cfg)
    assert mt["devices"] == ["cpu"]
    assert set(mt["versions"]) >= {"torch", "numpy", "scipy"}
    assert mt["versions"]["torch"] == torch.__version__
    lt = (ot / "resource_tracking.jsonl").read_text().splitlines()
    lj = (oj / "resource_tracking.jsonl").read_text().splitlines()
    assert len(lt) == len(lj) == 3
    for a, b in zip(lt, lj):
        a, b = json.loads(a), json.loads(b)
        assert sorted(a) == sorted(b) == ["routines", "t"]
        assert a["t"] == pytest.approx(b["t"], rel=1e-12)
        assert "run_model_region" in a["routines"]
    # the region's NetCDF files, as the JAX package names them, in
    # classic format (readable without h5py)
    names = sorted(p.relative_to(ot).as_posix() for p in ot.glob("**/*.nc"))
    assert names == sorted(p.relative_to(oj).as_posix()
                           for p in oj.glob("**/*.nc")) == [
        "ANT/main_output_ANT_00001.nc", "ANT/main_output_ANT_grid.nc",
        "ANT/restart_ANT_00001.nc", "ANT/scalar_output_ANT_00001.nc"]
    for n in names:
        assert (ot / n).read_bytes()[:4] == b"CDF\x02", n


def test_default_device_and_other_commands(runs, tmp_path):
    """The card unless --device says otherwise: without one the run, and
    the validation harness's subcommands, raise before they write
    anything; 'laddie' needs its config."""
    _, cfg, _, _ = runs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tprog.main([str(cfg), "--output-dir", str(tmp_path / "x")])
        assert not (tmp_path / "x").exists()
        for cmd in ("component_tests", "integrated_tests",
                    "integrated_tests_full"):
            with pytest.raises(RuntimeError, match="cuda"):
                tprog.main([cmd, "--output-dir", str(tmp_path / cmd)])
            assert not (tmp_path / cmd).exists()
    # the standalone plume is ported; without its config it is a usage
    # error
    with pytest.raises(SystemExit):
        tprog.main(["laddie"])
