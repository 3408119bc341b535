"""The port's scoreboard and component tests (validation/scoreboard.py,
validation/component_tests.py) against the JAX package's, in f64 on the
CPU: the same file names and JSON keys, every cost function equal."""

import json
import math

import numpy as np
import pytest

from torch_port_fixture import H_HALFAR

from ufemism2_tpu.validation import component_tests as jct
from ufemism2_tpu.validation import scoreboard as jsb
from ufemism2_tpu.main import program as jprog

from ufemism2_tpu_torch.validation import component_tests as tct
from ufemism2_tpu_torch.validation import scoreboard as tsb
from ufemism2_tpu_torch.main import program as tprog

CT_REL = 1e-12          # the host tiers: the same numpy/scipy code
MASS_REL = 1e-10        # the device tier: upwind divQ and the BiCGSTAB solve
MASS_ATOL = 1e-14       # [m/yr] rounding of the exact (linear) sheet


def _close(a, b, rel, atol=0.0):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= rel * max(abs(a), abs(b)) + atol


def _same_runs(runs_t, runs_j, rel, atol=0.0):
    assert [r.name for r in runs_t] == [r.name for r in runs_j]
    for rt, rj in zip(runs_t, runs_j):
        assert rt.category == rj.category
        assert [c["name"] for c in rt.cost_functions] \
            == [c["name"] for c in rj.cost_functions]
        assert [c["definition"] for c in rt.cost_functions] \
            == [c["definition"] for c in rj.cost_functions]
        for ct, cj in zip(rt.cost_functions, rj.cost_functions):
            assert _close(ct["value"], cj["value"], rel, atol), \
                (rt.name, ct["name"], ct["value"], cj["value"])


@pytest.fixture(scope="module")
def meshes():
    mj = jct.create_test_meshes(resolutions=[500e3, 400e3], gradients=False)
    mt = tct.create_test_meshes(resolutions=[500e3, 400e3], gradients=False)
    for (nj, a), (nt, b) in zip(mj, mt):
        assert nj == nt
        assert np.array_equal(a.V, b.V) and np.array_equal(a.Tri, b.Tri)
    return mj, mt


@pytest.mark.parametrize("i", [0, 1])
def test_map_deriv(meshes, i, tmp_path):
    (nj, mj), (nt, mt) = meshes[0][i], meshes[1][i]
    rj = jct.run_map_deriv_tests(mj, nj, tmp_path / "jax")
    rt = tct.run_map_deriv_tests(mt, nt, tmp_path / "torch")
    _same_runs(rt, rj, CT_REL)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("i", [0, 1])
def test_laplace(meshes, i):
    (nj, mj), (nt, mt) = meshes[0][i], meshes[1][i]
    _same_runs([tct.run_laplace_test(mt, nt)],
               [jct.run_laplace_test(mj, nj)], CT_REL)


def test_remapping(meshes):
    mj, mt = meshes
    rj = jct.run_remapping_tests(mj[1][1], mj[0][1], "t")
    rt = tct.run_remapping_tests(mt[1][1], mt[0][1], "t")
    _same_runs([rt], [rj], CT_REL)


@pytest.mark.parametrize("i", [0, 1])
def test_mass_conservation(meshes, i):
    (nj, mj), (nt, mt) = meshes[0][i], meshes[1][i]
    rj = jct.run_mass_conservation_test(mj, nj)
    rt = tct.run_mass_conservation_test(mt, nt, device="cpu")
    _same_runs(rt, rj, MASS_REL, MASS_ATOL)
    lin = {c["name"]: c["value"] for c in rt[0].cost_functions}
    assert lin["rmse_dHi_dt_explicit"] < 1e-10


def _entries(d):
    return {p.name: json.loads(p.read_text()) for p in d.iterdir()}


def test_component_tests_program(tmp_path):
    """`component_tests` through both programs' entry points: the default
    suite (uniform 400/300/200 km and the two gradient meshes), the same
    scoreboard file names, keys and cost functions."""
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    jprog.main(["component_tests", "--output-dir", str(dj)])
    runs = tprog.main(["component_tests", "--output-dir", str(dt),
                       "--device", "cpu"])
    ej, et = _entries(dj), _entries(dt)
    assert sorted(et) == sorted(ej) and len(et) == len(runs) == 24
    assert any("gradient_x" in n for n in et) \
        and any("mass_conservation" in n for n in et)
    for name, e in et.items():
        f = ej[name]
        assert set(e) == set(f)
        assert (e["name"], e["category"], e["git_hash"]) \
            == (f["name"], f["category"], f["git_hash"])
        mass = "mass_conservation" in e["category"]
        for ct, cj in zip(e["cost_functions"], f["cost_functions"]):
            assert set(ct) == set(cj) and ct["name"] == cj["name"]
            assert _close(ct["value"], cj["value"],
                          MASS_REL if mass else CT_REL,
                          MASS_ATOL if mass else 0.0), (name, ct, cj)


CATEGORIES = ["component_tests/discretisation/mapping_and_derivatives",
              "component_tests/remapping/mesh_to_grid",
              "integrated_tests/idealised/Halfar_dome",
              "integrated_tests/idealised/SSA_icestream",
              "integrated_tests/realistic/Antarctica"]


@pytest.mark.parametrize("category", CATEGORIES)
def test_scoreboard_file_and_keys(category, tmp_path):
    stab = {"n_dt_ice": 13, "n_visc_its": 4, "n_Axb_its": 28}
    paths = []
    for sb, d in ((jsb, tmp_path / "jax"), (tsb, tmp_path / "torch")):
        run = sb.ScoreboardRun("x_5km", category)
        run.add_cost_function("rmse", "sqrt(mean(e^2))", 13.38)
        run.add_stability_info(stab)
        paths.append(run.write(d))
        assert run.summary().splitlines()[0] == f"{category}/x_5km:"
    pj, pt = paths
    assert pt.name == pj.name
    ej, et = json.loads(pj.read_text()), json.loads(pt.read_text())
    assert list(et) == list(ej)
    et.pop("date"), ej.pop("date")
    assert et == ej
    assert tsb.read_scoreboard_dir(pt.parent)[0]["cost_functions"] \
        == jsb.read_scoreboard_dir(pj.parent)[0]["cost_functions"]


def test_git_hash_matches():
    assert tsb.git_hash() == jsb.git_hash()
    assert tsb.git_hash(short=False) == jsb.git_hash(short=False)


def test_read_stability_info(tmp_path):
    """The counters of one run's scalar file, read from the port's NetCDF
    classic file and from the JAX package's NetCDF4 one."""
    from ufemism2_tpu.config import Config as CJ
    from ufemism2_tpu.main.region import ModelRegion as JaxRegion
    from ufemism2_tpu_torch.config import Config as CT
    from ufemism2_tpu_torch.main.region import ModelRegion
    cfg = dict(H_HALFAR, choice_thermo_model="none",
               choice_initial_ice_temperature_ANT="uniform",
               dt_output=0.5, do_create_netcdf_output=True)
    rj = JaxRegion(CJ(**cfg), "ANT", output_dir=str(tmp_path / "jax"))
    rt = ModelRegion(CT(**cfg), "ANT", output_dir=str(tmp_path / "torch"),
                     device="cpu")
    rj.run_to(2.0)
    rt.run_to(2.0)
    rj.write_output()
    rt.write_output()
    name = "scalar_output_ANT_00001.nc"
    st = tsb.read_stability_info(tmp_path / "torch" / name)
    sj = tsb.read_stability_info(tmp_path / "jax" / name)
    assert st == sj and st["n_dt_ice"] > 1
    assert st["n_Axb_its"] == sum(r["n_Axb_its"]
                                  for r in rt.scalars_history)
    assert tsb.read_stability_info(tmp_path / "torch" / name, nskip=1) \
        == tsb.read_stability_info(tmp_path / "jax" / name, nskip=1)
