"""Every sliding law of the port against the JAX package's on the 64 km
fixture mesh, in f64, on seeded fields: a dome with a floating fringe and
an open-ocean rim (every mask type occurs), random basal velocities, and
a random per-vertex roughness field beside the uniform one.

Tolerance 1e-13 of the largest friction coefficient: both sides run the
same f64 arithmetic (pow, log10, min) element by element; the largest gap
measured was below 1e-15."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import configs, build_meshes, rel_gap

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import (geometry as jgeo, masks as jmasks,
                                   subgrid as jsub, sliding as jslid)
from ufemism2_tpu.core.ice.ssadiva import \
    _bed_roughness_fields as j_bed_roughness

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import masks as tmasks, sliding as tslid
from ufemism2_tpu_torch.core.ice.ssadiva import \
    _bed_roughness_fields as t_bed_roughness

TOL = 1e-13

LAWS = ("Weertman", "Coulomb", "Budd", "Tsai2015", "Schoof2005",
        "Zoet-Iverson", "no_sliding")
IDEALISED = ("SSA_icestream", "ISMIP-HOM_C", "ISMIP-HOM_D", "ISMIP-HOM_F")


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.mesh_j, e.mesh_t = build_meshes()
    e.mdj = jmd.build_mesh_data(e.mesh_j)
    e.mdt = tmd.build_mesh_data(e.mesh_t, dtype=torch.float64, device="cpu")
    V = e.mesh_j.V
    nV = e.mesh_j.nV
    rng = np.random.default_rng(11)
    r = np.hypot(V[:, 0], V[:, 1])
    Hb = 400.0 - 1.6e-3 * r + 60.0 * rng.standard_normal(nV)
    Hi = np.maximum(0.0, 1800.0 * (1.0 - (r / 820e3) ** 2)
                    + 40.0 * rng.standard_normal(nV))
    Hi[r > 820e3] = 0.0
    e.np = dict(Hi=Hi, Hb=Hb, SL=np.zeros(nV),
                u_a=200.0 * rng.standard_normal(nV),
                v_a=200.0 * rng.standard_normal(nV),
                # a nudged roughness: positive where it applies, else 0
                rough=np.where(rng.random(nV) < 0.7,
                               5.0 + 2e4 * rng.random(nV), 0.0))
    j = {k: jnp.asarray(v) for k, v in e.np.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in e.np.items()}
    e.j, e.t = j, t
    Hs = jgeo.ice_surface_elevation(j["Hi"], j["Hb"], j["SL"])
    slope = jnp.sqrt((e.mdj.M_ddx_a_a @ Hs) ** 2
                     + (e.mdj.M_ddy_a_a @ Hs) ** 2)
    fg = jsub.calc_grounded_fractions_bilin_TAF(e.mdj, j["Hi"], j["Hb"],
                                                j["SL"], None)
    he, _ = jsub.calc_effective_thickness(e.mdj, j["Hi"], j["Hb"], j["SL"])
    # the same derived inputs on both sides
    e.derived_j = (he, slope, fg)
    e.derived_t = tuple(torch.from_numpy(np.array(a)) for a in
                        e.derived_j)
    e.masks_j = jmasks.determine_masks(e.mdj, j["Hi"], j["Hb"], j["SL"])
    e.masks_t = tmasks.determine_masks(e.mdt, t["Hi"], t["Hb"], t["SL"])
    return e


def _friction(env, over, generic):
    Cj, Ct = configs(**over)
    gj = jnp.asarray(env.np["rough"]) if generic else None
    gt = env.t["rough"] if generic else None
    rough_j = j_bed_roughness(Cj, env.mdj, gj)
    rough_t = t_bed_roughness(Ct, env.mdt, gt)
    for k in rough_j:
        assert rel_gap(rough_t[k], np.asarray(rough_j[k])) == 0.0, k
    he_j, slope_j, fg_j = env.derived_j
    he_t, slope_t, fg_t = env.derived_t
    j, t = env.j, env.t
    bj = jslid.calc_basal_friction_coefficient(
        Cj, env.mdj, rough_j, j["u_a"], j["v_a"], j["Hi"], he_j, j["Hb"],
        j["SL"], slope_j, fg_j, env.masks_j)
    bt = tslid.calc_basal_friction_coefficient(
        Ct, env.mdt, rough_t, t["u_a"], t["v_a"], t["Hi"], he_t, t["Hb"],
        t["SL"], slope_t, fg_t, env.masks_t)
    return bt, np.asarray(bj)


@pytest.mark.parametrize("subgrid", [True, False])
@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("law", LAWS)
def test_sliding_law_matches_jax(env, law, generic, subgrid):
    bt, bj = _friction(env, dict(choice_sliding_law=law,
                                 do_subgrid_friction_on_A_grid=subgrid),
                       generic)
    assert bt.dtype == torch.float64 and bt.shape == bj.shape
    # Schoof2005 is 0/0 where the applied roughness and the effective
    # pressure both vanish (floating ice), in the reference as here: the
    # same rows
    nan = np.isnan(bj)
    assert np.array_equal(torch.isnan(bt).numpy(), nan)
    assert not nan.any() or law == "Schoof2005"
    bt, bj = bt[torch.from_numpy(~nan)], bj[~nan]
    assert rel_gap(bt, bj) <= TOL, rel_gap(bt, bj)
    if law == "no_sliding":
        assert float(bt.abs().max()) == 0.0
    else:
        assert float(bt.max()) > 0.0


@pytest.mark.parametrize("registered", [True, False])
@pytest.mark.parametrize("ideal", IDEALISED)
def test_idealised_sliding_matches_jax(env, ideal, registered):
    """The idealised laws from the static table register_sliding_static
    builds, and from the analytic field on md.V without it."""
    # the idealised experiments' own parameters (the schema's defaults
    # are placeholders): ISMIP-HOM at L = 160 km, the Schoof (2006) ice
    # stream of the SSA_icestream test
    over = dict(choice_sliding_law="idealised",
                choice_idealised_sliding_law=ideal,
                refgeo_idealised_ISMIP_HOM_L=160e3,
                refgeo_idealised_SSA_icestream_Hi=2000.0,
                refgeo_idealised_SSA_icestream_dhdx=-0.001,
                refgeo_idealised_SSA_icestream_L=150e3,
                refgeo_idealised_SSA_icestream_m=1.0)
    Cj, Ct = configs(**over)
    try:
        if registered:
            jslid.register_sliding_static(Cj, env.mesh_j, env.mdj)
            tslid.register_sliding_static(Ct, env.mesh_t, env.mdt)
            assert rel_gap(env.mdt.x("slid_ideal"),
                           np.asarray(env.mdj.x("slid_ideal"))) == 0.0
        bt, bj = _friction(env, over, generic=False)
    finally:
        env.mdj.extras.pop("slid_ideal", None)
        env.mdt.extras.pop("slid_ideal", None)
    assert bt.dtype == torch.float64
    assert rel_gap(bt, bj) <= TOL, rel_gap(bt, bj)


def test_till_yield_extends_to_land_neighbours(env):
    """Ice-free land vertices next to grounded ice take the smallest till
    yield stress of their grounded neighbours; every other vertex keeps
    its own."""
    rng = np.random.default_rng(3)
    nV = env.mesh_j.nV
    tau = rng.random(nV) * 1e5
    # scattered grounded ice and ice-free land: many land vertices border
    # grounded ones
    kind = rng.integers(0, 3, nV)
    gr, land = kind == 0, kind == 1
    masks_j = {"mask_grounded_ice": jnp.asarray(gr),
               "mask_icefree_land": jnp.asarray(land)}
    masks_t = {"mask_grounded_ice": torch.from_numpy(gr),
               "mask_icefree_land": torch.from_numpy(land)}
    tj = jslid._extend_till_yield_to_neighbours(env.mdj, masks_j,
                                                jnp.asarray(tau))
    tt = tslid._extend_till_yield_to_neighbours(env.mdt, masks_t,
                                                torch.from_numpy(tau))
    assert rel_gap(tt, np.asarray(tj)) == 0.0
    changed = tt.numpy() != tau
    assert changed.any() and not (changed & ~land).any()


def test_unknown_law_raises(env):
    with pytest.raises(ValueError, match="no_such_law"):
        _friction(env, dict(choice_sliding_law="no_such_law"), False)
