"""The plain reference against a second, independent witness: the JAX
package, the implementation that the port was written from. On the CPU in
float64, at each cell's small stand-in, the reference's PC step (and its
thermodynamics step) from a state of the JAX package's region equals the
JAX package's own step from that state: the same mesh, the same time
step, the same solver counts, and the fields to summation order. The
program's start-up, which a run's comparison skips, is held to the JAX
package's here as well.

The reference is the port's plain code frozen when the benchmark was
defined; this test holds that frozen code to the JAX package, so that
what `correct` compares the program with is the JAX package's physics and
not only the port's. JAX is loaded in this test's process alone: nothing
the benchmark runs loads it (test_bench_imports.py). Where the JAX package
cannot be imported (the card's machine has no JAX) the test skips."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference.model import ReferenceModel, build_mesh
from benchmark.tests.conftest import small_cell

# about ten times the largest gaps measured on these stand-ins, relative to
# the field's largest value (Hi_next 1.5e-16, u_3D_b 1.6e-14, v_3D_b
# 2.8e-13, all in the BPA cell) or to the largest change of the
# temperature (2.8e-14)
TOL = {"Hi_next": 2e-15, "u_3D_b": 2e-13, "v_3D_b": 3e-12, "Ti": 3e-13}
# the program's start-up against the JAX package's: about ten times the
# largest gap measured (3.1e-13, v_3D_b after the BPA cell's initial solve)
START_TOL = 3e-12
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def jax_package():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    return pytest.importorskip(
        "ufemism2_tpu", reason="the JAX package is not installed here")


def as_torch(s):
    """A JAX-package state as plain attributes: arrays as float64 CPU
    tensors, 0-d arrays as host scalars."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return SimpleNamespace(**{f.name: conv(getattr(v, f.name))
                                      for f in dataclasses.fields(v)})
        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        return torch.from_numpy(np.array(a))
    return conv(s)


def rel_gap(a, b):
    a = a.detach().double().cpu().numpy()
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def make_pair(workload, precision):
    """(cell, JAX-package region moved on past its start-up, reference) in
    `precision` on one mesh."""
    jax_package()
    from ufemism2_tpu.config import Config as CJ
    from ufemism2_tpu.main.region import ModelRegion as JaxRegion
    from ufemism2_tpu.mesh import build_mesh_from_config
    cell = small_cell(workload, precision=precision)
    cfg = cell.program_config()
    Cj = CJ(**cfg)
    mesh_j = build_mesh_from_config(Cj, "ANT")
    mesh = build_mesh(cfg)
    assert np.array_equal(mesh.V, mesh_j.V)
    assert np.array_equal(mesh.Tri, mesh_j.Tri)
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    if cell.traffic["startup_years"] > 0:
        rj.run_to(rj.time + float(cell.traffic["startup_years"]))
    return cell, rj, ReferenceModel(cfg, mesh, "cpu", precision)


@pytest.fixture(scope="module", params=CELLS)
def pair(request):
    return make_pair(request.param, "f64")


def test_pc_step_equals_the_jax_package(pair):
    import jax.numpy as jnp
    cell, rj, ref = pair
    dt_max = float(rj.C.dt_ice_max)
    s = rj.state
    sj = rj.pc_step(rj.md, s, jnp.asarray(dt_max), SMB=rj.SMB, BMB=rj.BMB,
                    LMB=rj.LMB)
    r = ref.step(as_torch(s), dt_max)
    assert r.dt_ice == pytest.approx(float(sj.dt_ice), rel=1e-12, abs=0.0)
    assert r.n_visc_its == int(sj.n_visc_its)
    assert r.n_Axb_its == int(sj.n_Axb_its)
    assert r.n_visc_its > int(s.n_visc_its)
    for name in ("Hi_next", "u_3D_b", "v_3D_b"):
        gap = rel_gap(getattr(r, name), getattr(sj, name))
        assert gap <= TOL[name], (cell.name, name, gap)
    assert float(np.abs(np.asarray(sj.Hi_next)
                        - np.asarray(s.Hi_next)).max()) > 0.0


def test_thermodynamics_step_equals_the_jax_package(pair):
    cell, rj, ref = pair
    if ref.thermo is None:
        assert not rj.do_thermo
        return
    # the region's temperature has just been stepped on this geometry, so
    # a step from it moves it by round-off alone: the ice 2 K colder
    # instead, which the step warms back
    s = rj.state.replace(Ti=rj.state.Ti - 2.0)
    Ti_j, _ = rj._thermo_step(rj.md, s, rj._T_surf, rj.SMB, rj.BMB)
    Ti = ref.thermo_step(as_torch(s))
    T0, Ti_j = np.asarray(s.Ti), np.asarray(Ti_j)
    gap = rel_gap(Ti - torch.from_numpy(np.array(T0)), Ti_j - T0)
    assert gap <= TOL["Ti"], (cell.name, gap)
    assert float(np.abs(Ti_j - T0).max()) > 0.1


def test_program_start_up_equals_the_jax_package(pair):
    """The stage that a run's comparison skips: the program's construction
    and start-up, which make the starting states, held by themselves to
    the JAX package's region after the same start-up."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.mesh.operators import build_all_matrix_operators
    cell, rj, _ = pair
    C = Config(**cell.program_config())
    mesh = build_mesh_from_config(C, "ANT")
    mesh.operators = build_all_matrix_operators(mesh)
    region = ModelRegion(C, "ANT", mesh=mesh, device="cpu")
    if cell.traffic["startup_years"] > 0:
        region.run_to(region.time + float(cell.traffic["startup_years"]))
    st, sj = region.state, rj.state
    assert region.time == float(rj.time)
    assert region.n_dt_ice == rj.n_dt_ice
    assert st.n_visc_its == int(sj.n_visc_its)
    assert st.n_Axb_its == int(sj.n_Axb_its)
    for name in ("Hi_next", "u_3D_b", "v_3D_b", "Ti"):
        gap = rel_gap(getattr(st, name), getattr(sj, name))
        assert gap <= START_TOL, (cell.name, name, gap)


@pytest.mark.parametrize("workload", CELLS)
def test_f32_step_is_within_the_cell_limits_of_the_jax_package(workload):
    """In the precision the cells run (f32, x rounded through bfloat16 in
    both packages' operators), the JAX package's steps, put in the
    program's place, pass the cell's comparison with the reference: the
    reference's f32 path is the JAX package's, to within what the
    comparison allows the program."""
    import jax.numpy as jnp
    from benchmark.reference import compare
    cell, rj, ref = make_pair(workload, "f32")
    dt_max = float(rj.C.dt_ice_max)
    s = rj.state
    sj = rj.pc_step(rj.md, s, jnp.asarray(dt_max), SMB=rj.SMB, BMB=rj.BMB,
                    LMB=rj.LMB)
    thermo = []
    if ref.thermo is not None:
        s2 = s.replace(Ti=s.Ti - 2.0)
        Ti_j, _ = rj._thermo_step(rj.md, s2, rj._T_surf, rj.SMB, rj.BMB)
        thermo = [(as_torch(s2), torch.from_numpy(np.array(Ti_j)))]
    gaps = compare.step_gaps(ref, [(as_torch(s), as_torch(sj), dt_max)],
                             thermo)
    ok, compared = compare.judge(gaps, compare.load_limits(cell.name))
    assert ok, (cell.name, gaps)
    assert gaps["dt_gap"] == 0.0
