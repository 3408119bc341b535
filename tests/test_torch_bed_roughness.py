"""The port's bed roughness and its nudging
(ufemism2_tpu_torch/models/bed_roughness.py) against the JAX package's on
the 40 km MISMIP+ mesh, f64: every initial roughness (uniform for each
sliding law, read from an x/y file of till friction angle or beta^2,
Martin2011, MISMIP+), the extrapolation, smoothing, upwind hops and
flowline averages, one step of each nudging method, the inverted BMB over
several calls, and the tie rule of the upwind hop (the first of several
equally aligned neighbours, as jnp.argmax takes it).

The state: 700 m of ice on the MISMIP+ bed, a velocity field flowing
east with a seeded cross-flow part, seeded thinning rates. Tolerance
1e-12 relative (the same f64 arithmetic, summation order apart)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (build_meshes_for, mismipplus_configs,
                                rel_gap, write_nc_pair)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import masks as jmasks
from ufemism2_tpu.core.idealised_geometries import calc_idealised_geometry
from ufemism2_tpu.models import bed_roughness as jbr

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import masks as tmasks
from ufemism2_tpu_torch.models import bed_roughness as tbr

TOL = 1e-12


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    Cj, _ = mismipplus_configs()
    e.mesh_j, e.mesh_t = build_meshes_for(Cj)
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    V, TriGC = e.mesh_j.V, e.mesh_j.TriGC
    rng = np.random.default_rng(29)
    _, Hb, _, _ = calc_idealised_geometry(V[:, 0], V[:, 1], "MISMIP+", Cj)
    Hi = np.where(V[:, 0] < 640e3, 1400.0 - 1.5e-3 * V[:, 0]
                  + 20.0 * rng.standard_normal(len(V)), 0.0)
    SL = np.zeros_like(Hi)
    Hs = Hi + np.maximum(SL - 917.0 / 1027.0 * Hi, Hb)
    f = dict(Hi=Hi, Hb=Hb, SL=SL, Hs=Hs, Hib=Hs - Hi,
             dHi_dt=0.5 * rng.standard_normal(len(V)),
             u_vav_b=200.0 + 1e-3 * TriGC[:, 0]
             + 30.0 * rng.standard_normal(len(TriGC)),
             v_vav_b=40.0 * rng.standard_normal(len(TriGC)))
    e.np = f
    e.sj = SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()})
    e.st = SimpleNamespace(**{k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in f.items()})
    e.mj = jmasks.determine_masks(e.mdj, e.sj.Hi, e.sj.Hb, e.sj.SL)
    e.mt = tmasks.determine_masks(e.mdt, e.st.Hi, e.st.Hb, e.st.SL)
    assert bool(e.mt["mask_grounded_ice"].any()) \
        and bool(e.mt["mask_floating_ice"].any())
    # the roughness files: till friction angle and beta^2 on an x/y grid
    d = tmp_path_factory.mktemp("roughness")
    gx = np.arange(0.0, 800e3 + 1, 5e3)
    gy = np.arange(-40e3, 40e3 + 1, 5e3)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    phi = 2.0 - 1.8 * np.exp(-0.5 * (((GX - 400e3) / 150e3) ** 2
                                     + (GY / 15e3) ** 2))
    e.files = write_nc_pair(d, "rough", {"x": len(gx), "y": len(gy)}, {
        "x": (("x",), gx), "y": (("y",), gy),
        "till_friction_angle": (("x", "y"), phi),
        "beta_sq": (("x", "y"), 1e4 * phi)})
    return e


def close(a, b, tol=TOL):
    gap = rel_gap(a, np.asarray(b))
    assert gap <= tol, gap


@pytest.mark.parametrize("law", ["Weertman", "Coulomb", "Budd", "Tsai2015",
                                 "Schoof2005", "Zoet-Iverson"])
@pytest.mark.parametrize("choice", ["uniform", "read_from_file",
                                    "Martin2011", "MISMIPplus"])
def test_initial_bed_roughness(env, law, choice):
    over = dict(choice_sliding_law=law)
    if choice in ("Martin2011", "MISMIPplus"):
        over.update(choice_bed_roughness="parameterised",
                    choice_bed_roughness_parameterised=choice)
    else:
        over.update(choice_bed_roughness=choice)
    Cj, _ = mismipplus_configs(**over, filename_bed_roughness_ANT=env.files[0])
    _, Ct = mismipplus_configs(**over, filename_bed_roughness_ANT=env.files[1])
    a = tbr.initial_bed_roughness(Ct, env.mdt, "ANT", Hb=env.np["Hb"])
    b = jbr.initial_bed_roughness(Cj, env.mdj, "ANT", Hb=env.np["Hb"])
    assert a.generic.dtype == torch.float64 and a.generic.shape == (
        env.mesh_t.nV,)
    close(a.generic, b.generic)


def test_read_from_file_needs_a_file(env):
    _, Ct = mismipplus_configs(choice_bed_roughness="read_from_file")
    with pytest.raises(ValueError, match="filename_bed_roughness_ANT"):
        tbr.initial_bed_roughness(Ct, env.mdt, "ANT")


def test_extrapolate_and_smooth(env):
    rng = np.random.default_rng(5)
    f = rng.standard_normal(env.mesh_t.nV)
    seed = rng.random(env.mesh_t.nV) < 0.2
    fill = rng.random(env.mesh_t.nV) < 0.8
    for n_iter in (1, 20):
        close(tbr.gaussian_extrapolate(env.mdt, torch.from_numpy(seed),
                                       torch.from_numpy(fill),
                                       torch.from_numpy(f), n_iter),
              jbr.gaussian_extrapolate(env.mdj, jnp.asarray(seed),
                                       jnp.asarray(fill), jnp.asarray(f),
                                       n_iter))
    close(tbr.smooth_field(env.mdt, torch.from_numpy(f), w_smooth=0.3),
          jbr.smooth_field(env.mdj, jnp.asarray(f), w_smooth=0.3))


@pytest.mark.parametrize("downstream", [False, True])
def test_hops_and_flowline_average(env, downstream):
    u = env.mdt.M_map_b_a @ env.st.u_vav_b
    v = env.mdt.M_map_b_a @ env.st.v_vav_b
    uj, vj = jnp.asarray(u.numpy()), jnp.asarray(v.numpy())
    nt, okt = tbr._upwind_hop_table(env.mdt, u, v, downstream)
    nj, okj = jbr._upwind_hop_table(env.mdj, uj, vj, downstream)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    assert bool(okt.any()) and bool((nt != torch.arange(len(nt))).any())
    close(tbr.flowline_average(env.mdt, env.st.Hs, u, v, env.st.Hi,
                               downstream),
          jbr.flowline_average(env.mdj, env.sj.Hs, uj, vj, env.sj.Hi,
                               downstream))


def test_upwind_hop_tie_takes_the_first(env):
    """Two neighbours equally aligned with the flow: the first in the
    connectivity order is taken, as jnp.argmax takes it; a masked slot
    (-2) never wins, and no alignment above 0.2 means no hop."""
    C = np.array([[1, 2, 3, 0], [0, 2, 3, 0], [3, 1, 0, 0], [2, 0, 1, 0]])
    mask_C = np.array([[True, True, True, False], [True, True, True, False],
                       [True, True, False, False], [True, True, True, False]])
    # vertex 0: neighbours 1 and 2 at +-45 degrees of a flow along x (a
    # tie, neighbour 2 listed after 1); vertex 1: the tie in slots 1 and 2
    # behind a worse first slot; vertex 2: nothing aligned; vertex 3:
    # the best in its last real slot (neighbour 1)
    D_x = np.array([[1.0, 1.0, -1.0, 5.0], [-1.0, 1.0, 1.0, 5.0],
                    [-1.0, 0.0, 5.0, 5.0], [-1.0, 0.0, 1.0, 5.0]])
    D_y = np.array([[1.0, -1.0, 0.0, 0.0], [0.0, 1.0, -1.0, 0.0],
                    [0.0, 1.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    D = np.hypot(D_x, D_y)
    u = np.array([3.0, 2.0, 1.0, 1.0])
    v = np.zeros(4)
    mt = SimpleNamespace(C=torch.from_numpy(C), mask_C=torch.from_numpy(
        mask_C), D_x=torch.from_numpy(D_x), D_y=torch.from_numpy(D_y),
        D=torch.from_numpy(D), nV=4, device=torch.device("cpu"))
    mj = SimpleNamespace(C=jnp.asarray(C), mask_C=jnp.asarray(mask_C),
                         D_x=jnp.asarray(D_x), D_y=jnp.asarray(D_y),
                         D=jnp.asarray(D), nV=4)
    nt, okt = tbr._upwind_hop_table(mt, torch.from_numpy(u),
                                    torch.from_numpy(v), downstream=True)
    nj, okj = jbr._upwind_hop_table(mj, jnp.asarray(u), jnp.asarray(v),
                                    downstream=True)
    assert nt.tolist() == np.asarray(nj).tolist() == [1, 2, 2, 1]
    assert okt.tolist() == np.asarray(okj).tolist() == [True, True, False,
                                                        True]
    x = torch.tensor([[1.0, 3.0, 3.0, -2.0], [5.0, 5.0, 5.0, 5.0],
                      [-2.0, -2.0, -2.0, 0.0]])
    assert tbr._first_argmax(x).tolist() == [1, 0, 3]


@pytest.mark.parametrize("method", ["H_dHdt_local", "H_dHdt_flowline",
                                    "H_u_flowline"])
def test_nudging_step(env, method):
    """One nudging step of each method from a uniform roughness towards a
    target geometry 40 m thinner than the state."""
    over = dict(choice_sliding_law="Zoet-Iverson",
                do_bed_roughness_nudging=True,
                choice_bed_roughness_nudging_method=method,
                bed_roughness_nudging_dt=5.0)
    Cj, Ct = mismipplus_configs(**over)
    rt = tbr.make_run_bed_roughness_nudging(Ct, env.mdt)
    rj = jbr.make_run_bed_roughness_nudging(Cj, env.mdj)
    bt = tbr.initial_bed_roughness(Ct, env.mdt)
    bj = jbr.initial_bed_roughness(Cj, env.mdj)
    Hs_t = env.st.Hs - 40.0
    Hs_j = env.sj.Hs - 40.0
    for _ in range(2):
        bt = rt(env.st, env.mt, bt, Hs_t, env.st.Hi)
        bj = rj(env.sj, env.mj, bj, Hs_j, env.sj.Hi)
        close(bt.generic, bj.generic)
    assert float((bt.generic - Ct.slid_ZI_phi_fric_uniform).abs().max()) \
        > 1e-6


def test_unknown_nudging_method(env):
    _, Ct = mismipplus_configs(choice_bed_roughness_nudging_method="nope")
    with pytest.raises(ValueError, match="nope"):
        tbr.make_run_bed_roughness_nudging(Ct, env.mdt)


def test_bmb_inverted(env):
    """make_run_bmb_inverted over several calls, inside and outside its
    window, against a target shelf thinner than the state."""
    over = dict(BMB_inversion_t_start=1.0, BMB_inversion_t_end=30.0,
                dt_BMB=1.0)
    Cj, Ct = mismipplus_configs(**over)
    rt, rj = tbr.make_run_bmb_inverted(Ct, env.mdt), \
        jbr.make_run_bmb_inverted(Cj, env.mdj)
    Hi_tt, Hi_tj = env.st.Hi * 0.95, env.sj.Hi * 0.95
    shelf_t, shelf_j = env.mt["mask_floating_ice"], env.mj["mask_floating_ice"]
    bt = torch.zeros(env.mesh_t.nV, dtype=torch.float64)
    bj = jnp.zeros(env.mesh_t.nV)
    for t in (0.0, 1.0, 2.0, 3.0, 31.0):
        bt = rt(bt, env.st, env.mt, Hi_tt, shelf_t, t)
        bj = rj(bj, env.sj, env.mj, Hi_tj, shelf_j, t)
        close(bt, bj)
    assert float(bt.abs().max()) > 0.0
