"""The port's Lagrangian tracers (ufemism2_tpu_torch/models/tracers.py)
against the JAX package's on the 40 km MISMIP+ mesh, f64: the locator's
bucket tables and its lookups (points inside, on the domain's edges and
outside), the initial buffer, a spawn event with the JAX package's own
draws passed in, RK2 steps in a seeded velocity field (deaths at the
domain's edge and on thin ice included), particles_to_mesh, and the state
carried over from numpy. Positions and ages to 1e-12 relative; the alive
masks and every index equal."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_fixture import build_meshes_for, mismipplus_configs, rel_gap

from ufemism2_tpu.core.mesh_data import build_mesh_data as jbmd
from ufemism2_tpu.models import tracers as jt

from ufemism2_tpu_torch.convert import particle_state_from_numpy
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data as tbmd
from ufemism2_tpu_torch.models import tracers as tt

TOL = 1e-12
NZ = 6


@pytest.fixture(scope="module")
def env():
    Cj, Ct = mismipplus_configs(nz=NZ)
    mj, mt = build_meshes_for(Cj)
    e = SimpleNamespace(Cj=Cj, Ct=Ct, mj=mj, mt=mt)
    e.mdj, e.mdt = jbmd(mj), tbmd(mt, device="cpu")
    e.locj = jt.PointLocator(mj, n_cells=64)
    e.loct = tt.PointLocator(mt, "cpu", n_cells=64)
    e.J = jt.make_tracer_stepper(Cj, e.mdj, e.locj, n_particles=512)
    e.T = tt.make_tracer_stepper(Ct, e.mdt, e.loct, n_particles=512)
    rng = np.random.default_rng(21)
    x = mj.V[:, 0]
    f = dict(u_3D_b=80.0 + 40.0 * rng.random((mj.nTri, e.mdj.nz)),
             v_3D_b=5.0 * rng.standard_normal((mj.nTri, e.mdj.nz)),
             Hi=np.where(x < 600e3, 900.0 - 1e-3 * x, 0.5),
             dHi_dt=rng.standard_normal(mj.nV))
    e.sj = SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()})
    e.st = SimpleNamespace(**{k: torch.tensor(v) for k, v in f.items()})
    return e


def _state_pair(e, seed):
    rng = np.random.default_rng(seed)
    n = 512
    f = dict(x=rng.random(n) * 820e3 - 10e3, y=rng.random(n) * 80e3 - 40e3,
             zeta=rng.random(n), t_origin=-50.0 * rng.random(n),
             alive=rng.random(n) < 0.7)
    return (jt.ParticleState(**{k: jnp.asarray(v) for k, v in f.items()}),
            particle_state_from_numpy(f, "cpu", torch.float64))


def _assert_pstate(pt, pj):
    np.testing.assert_array_equal(pt.alive.numpy(), np.asarray(pj.alive))
    for k in ("x", "y", "zeta", "t_origin"):
        assert rel_gap(getattr(pt, k), np.asarray(getattr(pj, k))) <= TOL, k


def test_locator(env):
    e = env
    np.testing.assert_array_equal(e.loct.tri_table.numpy(),
                                  np.asarray(e.locj.tri_table))
    np.testing.assert_array_equal(e.loct.vtx_table.numpy(),
                                  np.asarray(e.locj.vtx_table))
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(300) * 800e3, [0.0, 800e3, -5e3, 9e5]])
    y = np.concatenate([rng.random(300) * 80e3 - 40e3,
                        [-40e3, 40e3, 0.0, 1e5]])
    for a, b in zip(e.loct.locate(torch.tensor(x), torch.tensor(y)),
                    e.locj.locate(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_and_spawn(env):
    """A spawn event fed the JAX package's draws for its key."""
    e = env
    pj, pt = e.J[0](e.sj, 3.0), e.T[0](e.st, 3.0)
    _assert_pstate(pt, pj)
    _, pt = _state_pair(e, 1)
    pj, _ = _state_pair(e, 1)
    key = jax.random.PRNGKey(7)
    idx = jax.random.randint(key, (512,), 0, e.mdj.nV)
    pj2 = e.J[2](pj, e.sj, 7.5, key)
    pt2 = e.T[2](pt, e.st, 7.5, torch.tensor(np.asarray(idx)))
    _assert_pstate(pt2, pj2)
    assert int(pt2.alive.sum()) > int(pt.alive.sum())


def test_rk2_steps(env):
    """Five RK2 steps of 2 years: positions, zeta and the deaths."""
    e = env
    pj, pt = _state_pair(e, 2)
    for k in range(5):
        pj = e.J[1](pj, e.sj, jnp.asarray(2.0), 2.0 * k)
        pt = e.T[1](pt, e.st, 2.0, 2.0 * k)
        _assert_pstate(pt, pj)
    assert 0 < int(pt.alive.sum()) < 512


def test_particles_to_mesh(env):
    e = env
    pj, pt = _state_pair(e, 4)
    aj, mj = e.J[3](pj, 10.0)
    at, mt = e.T[3](pt, 10.0)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert rel_gap(at, np.asarray(aj)) <= TOL
    assert mt.any()
