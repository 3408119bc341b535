"""The demo model (models/demo.py) against the JAX package's, in f64 on
the CPU: variant 'a' (diffusion) within 1e-12, variant 'b' (rotation,
a nearest-vertex gather) equal, the remap onto a new mesh and the restart
round trip."""

import numpy as np
import pytest
import torch

from torch_port_fixture import mesh_to_numpy

from ufemism2_tpu.core.mesh_data import build_mesh_data as j_build_md
from ufemism2_tpu.mesh import build_uniform_mesh
from ufemism2_tpu.models import demo as jdemo

from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
from ufemism2_tpu_torch.models import demo as tdemo

TOL_A = 1e-12


@pytest.fixture(scope="module")
def meshes():
    out = []
    for res in (20e3, 15e3):
        mj = build_uniform_mesh(-100e3, 100e3, -100e3, 100e3, res)
        mt = mesh_from_numpy(mesh_to_numpy(mj))
        out.append((mj, j_build_md(mj), mt,
                    build_mesh_data(mt, dtype=torch.float64, device="cpu")))
    return out


def _gap(t, j):
    a, b = t.phi.numpy(), np.asarray(j.phi)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("t_end", [1.0, 20.0])
def test_variant_a(meshes, t_end):
    mj, mdj, mt, mdt = meshes[0]
    dj, dt = jdemo.DemoModel("a"), tdemo.DemoModel("a")
    sj, st = dj.initialise(mdj), dt.initialise(mdt)
    assert _gap(st, sj) == 0.0
    sj, st = dj.run(sj, t_end), dt.run(st, t_end, dt=1.0)
    assert _gap(st, sj) <= TOL_A
    assert st.t == pytest.approx(float(sj.t), abs=1e-12)
    assert float(st.phi.max()) < 1.0 and float(st.phi.min()) >= -1e-12


@pytest.mark.parametrize("t_end", [1.0, 10.0, 37.5])
def test_variant_b(meshes, t_end):
    mj, mdj, mt, mdt = meshes[0]
    dj, dt = jdemo.DemoModel("b"), tdemo.DemoModel("b")
    sj, st = dj.run(dj.initialise(mdj), t_end), \
        dt.run(dt.initialise(mdt), t_end)
    assert np.array_equal(st.phi.numpy(), np.asarray(sj.phi))
    assert st.t == pytest.approx(float(sj.t), abs=1e-12)


def test_unknown_variant(meshes):
    with pytest.raises(ValueError, match="choice_demo_model"):
        tdemo.DemoModel("c").initialise(meshes[0][3])


@pytest.mark.parametrize("choice", ["a", "b"])
def test_remap_and_restart(meshes, choice, tmp_path):
    (mj1, mdj1, mt1, mdt1), (mj2, mdj2, mt2, mdt2) = meshes
    dj, dt = jdemo.DemoModel(choice), tdemo.DemoModel(choice)
    sj = dj.run(dj.initialise(mdj1), 5.0)
    st = dt.run(dt.initialise(mdt1), 5.0)
    sj2 = dj.remap(sj, mj1, mj2, mdj2)
    st2 = dt.remap(st, mt1, mt2, mdt2)
    tol = TOL_A if choice == "a" else 0.0
    assert _gap(st2, sj2) <= tol
    if choice == "a":     # the JAX package's test holds the smooth field
        mass1 = float((st.phi * mdt1.A).sum())
        assert float((st2.phi * mdt2.A).sum()) \
            == pytest.approx(mass1, rel=1e-2)
    # the port's restart: NetCDF classic, the time a scalar variable
    p = tmp_path / "demo_restart.nc"
    dt.write_restart(str(p), mt2, st2)
    assert p.read_bytes()[:3] == b"CDF"
    st3 = dt.read_restart(str(p), mdt2)
    assert torch.equal(st3.phi, st2.phi) and st3.t == st2.t
    # the JAX package's (NetCDF4) restart read by the port
    pj = tmp_path / "demo_restart_jax.nc"
    dj.write_restart(str(pj), mj2, sj2)
    st4 = dt.read_restart(str(pj), mdt2)
    assert np.array_equal(st4.phi.numpy(), np.asarray(sj2.phi))
    assert st4.t == float(sj2.t)
    # both keep running on the new mesh
    sj5, st5 = dj.run(dj.read_restart(str(pj), mdj2), 10.0), \
        dt.run(st3, 10.0)
    assert _gap(st5, sj5) <= tol
