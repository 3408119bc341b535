"""The port's LADDIE (ufemism2_tpu_torch/models/laddie.py, with the plain
stage of ops/cuda_laddie.py) against the JAX package's
(ufemism2_tpu/models/laddie.py) on an 8 km uniform mesh of 100 km square,
f64: the masks, every SGD choice, one pseudo-step of each scheme (fbrk3
with the default and with non-zero beta, euler, lfra; uniform and
Jenkins1991 gamma; with the ice temperature; with SGD), a 0.25-day leg,
the compact leg, make_run_bmb_laddie over two calls with a shelf change
between them, the state carried over from numpy, and the fbrk3 freeze.

The geometry is tests/test_laddie.py's `_shelf_setup`: grounded on the
west, a floating shelf in the middle, open ocean in the east; the state
of a single step is perturbed with seeded noise so that every term acts.
Tolerances: 1e-12 relative for one step (the same f64 arithmetic, summed
in another order); 1e-10 for the 0.25-day legs (180 steps, the rounding
differences of each step carried along)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import mesh_to_numpy, rel_gap, write_nc_pair

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.mesh import build_uniform_mesh
from ufemism2_tpu.core.mesh_data import build_mesh_data as jbmd
from ufemism2_tpu.core.ice.masks import determine_masks as jdm
from ufemism2_tpu.core.ice.state import init_ice_state as jinit
from ufemism2_tpu.models import laddie as jl
from ufemism2_tpu.models.ocean import make_run_ocean as jro, ocean_depth_axis

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import mesh_from_numpy, laddie_state_from_numpy
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data as tbmd
from ufemism2_tpu_torch.core.ice.masks import determine_masks as tdm
from ufemism2_tpu_torch.core.ice.state import init_ice_state as tinit
from ufemism2_tpu_torch.models import laddie as tl
from ufemism2_tpu_torch.models.ocean import make_run_ocean as tro

STEP_TOL = 1e-12
LEG_TOL = 1e-10
BASE = dict(dt_laddie=120.0, choice_ocean_model_ANT="idealised",
            choice_ocean_model_idealised="MISMIPplus_WARM")
FIELDS = ("H", "U", "V", "T", "S")


class Side:
    pass


def _geometry(x, shift=0.0):
    Hb = np.where(x < -20e3, 100.0, -600.0)
    Hi = np.where(x < 20e3 + shift, np.where(x < -20e3, 500.0, 300.0), 0.0)
    return Hi, Hb


@pytest.fixture(scope="module")
def mesh():
    mj = build_uniform_mesh(-50e3, 50e3, -50e3, 50e3, 8e3)
    return mj, mesh_from_numpy(mesh_to_numpy(mj))


def sides(mesh, shift=0.0, use_Ti=False, **over):
    """(JAX side, port side): config, mesh data, ice state, masks, LADDIE
    masks and forcing of the shelf set-up."""
    mj, mt = mesh
    kw = dict(BASE, **over)
    J, T = Side(), Side()
    J.C, T.C = CJ(**kw), CT(**kw)
    J.md, T.md = jbmd(mj), tbmd(mt, device="cpu")
    x = mj.V[:, 0]
    Hi, Hb = _geometry(x, shift)
    J.s = jinit(J.md, Hi, Hb, np.zeros_like(Hi), nz=4, dt_init=0.1)
    T.s = tinit(T.md, Hi, Hb, np.zeros_like(Hi), nz=4, dt_init=0.1)
    J.masks = jdm(J.md, J.s.Hi, J.s.Hb, J.s.SL)
    T.masks = tdm(T.md, T.s.Hi, T.s.Hb, T.s.SL)
    J.lm, T.lm = jl.laddie_masks(J.md, J.masks), tl.laddie_masks(T.md,
                                                                 T.masks)
    oj = jro(J.C, J.md, "ANT")(0.0, J.s)
    ot = tro(T.C, T.md, "ANT")(0.0, T.s)
    Ti = 250.0 + 10.0 * np.random.default_rng(5).random(len(x))
    dHx = np.asarray(J.md.M_ddx_a_b @ J.s.Hib)
    dHy = np.asarray(J.md.M_ddy_a_b @ J.s.Hib)
    z = ocean_depth_axis(J.C)
    J.fc = {"Hib": J.s.Hib, "dHib_dx_b": jnp.asarray(dHx),
            "dHib_dy_b": jnp.asarray(dHy),
            "Ti_base": jnp.asarray(Ti - 273.15),
            "use_Ti": jnp.asarray(use_Ti), "z_ocean": jnp.asarray(z),
            "T_ocean": oj["T"], "S_ocean": oj["S"]}
    T.fc = {"Hib": T.s.Hib, "dHib_dx_b": torch.tensor(dHx),
            "dHib_dy_b": torch.tensor(dHy),
            "Ti_base": torch.as_tensor(Ti - 273.15), "use_Ti": use_Ti,
            "z_ocean": torch.as_tensor(z), "T_ocean": ot["T"],
            "S_ocean": ot["S"], "SGD": torch.zeros(len(x),
                                                   dtype=torch.float64)}
    return J, T


def _perturbed(J, T, seed=0):
    """The initial plume state of each side, with seeded noise on H, U, V,
    T and S."""
    rng = np.random.default_rng(seed)
    s0 = jl.init_laddie_state(J.C, J.md, J.lm, J.fc)
    f = {"H": 10.0 + 5.0 * rng.random(J.md.nV),
         "U": 0.05 * rng.standard_normal(J.md.nTri),
         "V": 0.05 * rng.standard_normal(J.md.nTri),
         "T": np.asarray(s0.T) + 0.2 * rng.standard_normal(J.md.nV),
         "S": np.asarray(s0.S) + 0.1 * rng.standard_normal(J.md.nV)}
    return (jl.LaddieState(**{k: jnp.asarray(v) for k, v in f.items()}),
            laddie_state_from_numpy(f, "cpu", torch.float64))


def _assert_states(st, sj, tol):
    for k in FIELDS:
        g = rel_gap(getattr(st, k), np.asarray(getattr(sj, k)))
        assert g <= tol, (k, g)


def test_laddie_masks(mesh):
    J, T = sides(mesh)
    assert bool(np.asarray(J.lm.a).any())
    for k in jl.LaddieMasks._fields:
        np.testing.assert_array_equal(getattr(T.lm, k).numpy(),
                                      np.asarray(getattr(J.lm, k)), k)


def _sgd_over(kind, tmp_path, mesh):
    if kind == "idealised":
        return dict(choice_laddie_SGD="idealised",
                    choice_laddie_SGD_idealised="MISMIPplus_PC",
                    laddie_SGD_flux=72.0, start_time_of_applying_SGD=-1e9)
    if kind == "read_from_file":
        x = np.linspace(-60e3, 60e3, 31)
        y = np.linspace(-60e3, 60e3, 25)
        m = (np.abs(y)[None, :] < 12e3) * np.ones((len(x), 1))
        fj, ft = write_nc_pair(tmp_path, "sgd", {"x": 31, "y": 25}, {
            "x": (("x",), x), "y": (("y",), y),
            "mask_SGD": (("x", "y"), m)})
        return dict(choice_laddie_SGD="read_from_file",
                    filename_laddie_mask_SGD=(fj, ft),
                    laddie_SGD_flux=30.0, start_time_of_applying_SGD=-1e9)
    wp = tmp_path / "sgd_line.txt"
    np.savetxt(wp, np.array([[-30e3, 4e3], [40e3, 4e3]]))
    dist = "single_cell" if kind == "read_transects" else "distributed"
    return dict(choice_laddie_SGD="read_transects", distribute_SGD=dist,
                transects_SGD=f"file:{wp},SF=25.0")


@pytest.mark.parametrize("kind", ["idealised", "read_from_file",
                                  "read_transects", "read_transects_dist"])
def test_calc_SGD(mesh, tmp_path, kind):
    over = _sgd_over(kind, tmp_path, mesh)
    files = over.pop("filename_laddie_mask_SGD", None)
    J, T = sides(mesh, **over)
    if files is not None:
        J.C = CJ(**dict(BASE, **over, filename_laddie_mask_SGD=files[0]))
        T.C = CT(**dict(BASE, **over, filename_laddie_mask_SGD=files[1]))
    cj = jl.make_calc_SGD(J.C, J.md)
    ct = tl.make_calc_SGD(T.C, T.md)
    sj = np.asarray(cj(J.masks["mask_floating_ice"], J.masks["mask_gl_fl"],
                       0.0))
    st = ct(T.masks["mask_floating_ice"], T.masks["mask_gl_fl"], 0.0)
    assert sj.any()
    assert rel_gap(st, sj) <= STEP_TOL
    if kind in ("idealised", "read_from_file"):
        # the time gate
        assert not ct(T.masks["mask_floating_ice"], T.masks["mask_gl_fl"],
                      -2e9).any()


def test_calc_SGD_none(mesh):
    J, T = sides(mesh)
    assert tl.make_calc_SGD(T.C, T.md) is None


STEP_CASES = {
    "fbrk3": dict(choice_laddie_integration_scheme="fbrk3"),
    "fbrk3_beta": dict(choice_laddie_integration_scheme="fbrk3",
                       laddie_fbrk3_beta1=0.5, laddie_fbrk3_beta2=0.5,
                       laddie_fbrk3_beta3=0.344),
    "fbrk3_jenkins_Ti": dict(choice_laddie_integration_scheme="fbrk3",
                             laddie_fbrk3_beta1=0.4,
                             choice_laddie_gamma="Jenkins1991"),
    "euler": dict(choice_laddie_integration_scheme="euler"),
    "euler_jenkins_Ti": dict(choice_laddie_integration_scheme="euler",
                             choice_laddie_gamma="Jenkins1991"),
    "euler_sgd": dict(choice_laddie_integration_scheme="euler",
                      choice_laddie_SGD="idealised",
                      laddie_SGD_flux=72.0,
                      start_time_of_applying_SGD=-1e9),
    "lfra": dict(choice_laddie_integration_scheme="lfra"),
    "lfra_jenkins_Ti": dict(choice_laddie_integration_scheme="lfra",
                            choice_laddie_gamma="Jenkins1991"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step(mesh, case):
    """One pseudo-step of each scheme from the same perturbed state (lfra
    with a different nm1), within 1e-12."""
    J, T = sides(mesh, use_Ti=case.endswith("_Ti"), **STEP_CASES[case])
    if case.endswith("_sgd"):
        sgd = np.asarray(jl.make_calc_SGD(J.C, J.md)(
            J.masks["mask_floating_ice"], J.masks["mask_gl_fl"], 0.0))
        J.fc["SGD"] = jnp.asarray(sgd)
        T.fc["SGD"] = torch.as_tensor(sgd)
    nj, nt = _perturbed(J, T, 0)
    mj, mt = _perturbed(J, T, 1)
    (aj, bj), phj = jl.make_laddie_step(J.C, J.md)((nj, mj), J.lm, J.fc)
    (at, bt), pht = tl.make_laddie_step(T.C, T.md)((nt, mt), T.lm, T.fc)
    _assert_states(at, aj, STEP_TOL)
    _assert_states(bt, bj, STEP_TOL)
    for k in ("melt", "entr", "detr", "gamma_T", "gamma_S", "T_base",
              "T_amb", "S_amb", "drho_amb", "Hdrho_amb"):
        assert rel_gap(pht[k], np.asarray(phj[k])) <= STEP_TOL, k


@pytest.mark.parametrize("scheme", ["fbrk3", "euler", "lfra"])
def test_quarter_day_leg(mesh, scheme):
    """A 0.25-day leg (180 steps of 120 s) from the initial state: the
    state and the last step's melt within 1e-10; melt where the shelf is
    (the warm ISOMIP+ profile under a 300 m draft)."""
    J, T = sides(mesh, choice_laddie_integration_scheme=scheme)
    sj = jl.init_laddie_state(J.C, J.md, J.lm, J.fc)
    st = tl.init_laddie_state(T.C, T.md, T.lm, T.fc)
    _assert_states(st, sj, STEP_TOL)
    sj, mj = jl.run_laddie_leg(J.C, J.md, sj, J.lm, J.fc, 0.25)
    st, mt = tl.run_laddie_leg(T.C, T.md, st, T.lm, T.fc, 0.25)
    _assert_states(st, sj, LEG_TOL)
    assert rel_gap(mt, np.asarray(mj)) <= LEG_TOL
    assert float(mt[T.lm.a].mean()) > 0.0


def test_fbrk3_freeze(mesh):
    """Under the schema's default beta (0, 0, 0) the fbrk3 blend returns
    the step's starting H after every stage: over a leg max |dH| is 0 on
    both sides. With non-zero beta H moves, on both sides alike."""
    for beta, moves in (((0.0, 0.0, 0.0), False), ((0.5, 0.5, 0.344), True)):
        J, T = sides(mesh, choice_laddie_integration_scheme="fbrk3",
                     laddie_fbrk3_beta1=beta[0], laddie_fbrk3_beta2=beta[1],
                     laddie_fbrk3_beta3=beta[2])
        s0j = jl.init_laddie_state(J.C, J.md, J.lm, J.fc)
        s0t = tl.init_laddie_state(T.C, T.md, T.lm, T.fc)
        sj, _ = jl.run_laddie_leg(J.C, J.md, s0j, J.lm, J.fc, 0.1)
        st, _ = tl.run_laddie_leg(T.C, T.md, s0t, T.lm, T.fc, 0.1)
        dHj = float(np.abs(np.asarray(sj.H - s0j.H)).max())
        dHt = float((st.H - s0t.H).abs().max())
        if moves:
            assert dHj > 0.1 and abs(dHt - dHj) <= 1e-9 * dHj
        else:
            assert dHj == 0.0 and dHt == 0.0


def test_compact_leg(mesh):
    """The leg on the compact shelf mesh (shelf + 3 rings, padded to 256)
    equals the leg on the full mesh on the real rows, and the compact md
    equals the JAX package's."""
    J, T = sides(mesh, choice_laddie_integration_scheme="euler")
    shelf = T.masks["mask_floating_ice"].numpy()
    mdc, (Vk, nVr), (Tk, nTr), _ = tl.build_compact_laddie_md(T.md, shelf)
    mdcj, (Vkj, _), (Tkj, _), _ = jl.build_compact_laddie_md(J.md, shelf)
    np.testing.assert_array_equal(Vk, Vkj)
    np.testing.assert_array_equal(Tk, Tkj)
    assert mdc.nV % 256 == 0 and mdc.nTri % 256 == 0
    iV, iT = torch.as_tensor(Vk), torch.as_tensor(Tk)
    s_full = tl.init_laddie_state(T.C, T.md, T.lm, T.fc)
    st_full, m_full = tl.run_laddie_leg(T.C, T.md, s_full, T.lm, T.fc, 0.05)
    masks_c = {k: T.masks[k][iV] for k in (
        "mask_floating_ice", "mask_grounded_ice", "mask_icefree_land",
        "mask_icefree_ocean")}
    lm_c = tl.laddie_masks(mdc, masks_c)
    fc = dict(T.fc)
    for k in ("Hib", "Ti_base", "T_ocean", "S_ocean", "SGD"):
        fc[k] = fc[k][iV]
    for k in ("dHib_dx_b", "dHib_dy_b"):
        fc[k] = fc[k][iT]
    s_c = tl.LaddieState(H=s_full.H[iV], U=s_full.U[iT], V=s_full.V[iT],
                         T=s_full.T[iV], S=s_full.S[iV])
    st_c, m_c = tl.run_laddie_leg(T.C, mdc, s_c, lm_c, fc, 0.05)
    shelf_c = lm_c.a[:nVr]
    assert rel_gap(m_c[:nVr][shelf_c], m_full[iV[:nVr]][shelf_c]
                   .numpy()) <= STEP_TOL
    assert rel_gap(st_c.T[:nVr][shelf_c],
                   st_full.T[iV[:nVr]][shelf_c].numpy()) <= STEP_TOL


def test_run_bmb_laddie(mesh):
    """make_run_bmb_laddie (compaction on) over two calls, the second on a
    longer shelf (a rebuild of the compact mesh, the 6-day leg cut to
    0.05 days), against the JAX package's."""
    over = dict(time_duration_laddie_init=0.1, time_duration_laddie=0.05,
                choice_laddie_integration_scheme="fbrk3",
                laddie_fbrk3_beta1=0.5, laddie_fbrk3_beta2=0.5,
                laddie_fbrk3_beta3=0.344)
    J, T = sides(mesh, **over)
    rj = jl.make_run_bmb_laddie(J.C, J.md, "ANT")
    rt = tl.make_run_bmb_laddie(T.C, T.md, "ANT")
    for shift in (0.0, 9e3):
        J, T = sides(mesh, shift=shift, **over)
        J.s = J.s.replace(Ti=jnp.full_like(J.s.Ti, 260.0))
        T.s = T.s.replace(Ti=torch.full_like(T.s.Ti, 260.0))
        oj = jro(J.C, J.md, "ANT")(0.0, J.s)
        ot = tro(T.C, T.md, "ANT")(0.0, T.s)
        fg = np.zeros(J.md.nV)
        bj = rj(0.0, J.s, J.masks, jnp.asarray(fg), oj)
        bt = rt(0.0, T.s, T.masks, torch.as_tensor(fg), ot)
        assert float(np.abs(np.asarray(bj)).max()) > 0.0
        assert rel_gap(bt, np.asarray(bj)) <= LEG_TOL, shift
    assert [leg["initial"] for leg in rt.legs] == [True, False]
    assert rt.legs[0]["steps"] == 72 and rt.legs[1]["steps"] == 36
