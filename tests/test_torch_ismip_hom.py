"""ISMIP-HOM (Pattyn et al. 2008) through the port's entry points on the
CPU, against the JAX package's region: experiments A (no slip) and C
(the idealised ISMIP-HOM_C friction) with BPA, and A with the hybrid
DIVA/BPA (BPA where x > 0, the mask read from a file), at L = 20 km on a
uniform 5 km mesh, periodic sides, one diagnostic ice step after the
region's initial solve (a few viscosity iterations each, to keep the run
short). Each case runs through `ModelRegion(...).run_to` and through
`program.main` on a written .cfg (device "cpu"), and both are held to
the JAX region: equal viscosity and Krylov iteration counts, u_3D_b and
the surface velocity on the JAX harness's transect (x in [xmin/2,
xmax/2], y = ymin/4; ufemism2_tpu/validation/integrated_tests.py:249-252)
within TOL of their largest value (f64 on both sides, summation order
apart, as tests/test_torch_bpa.py)."""

import numpy as np
import pytest
import torch

from torch_port_fixture import (mesh_to_numpy, ismip_hom, ismip_transect,
                                write_nc_pair)
from test_torch_program import write_cfg

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.main import program as tprog
from ufemism2_tpu_torch.main.region import ModelRegion

TOL = 1e-10
T_END = 0.1                  # one ice step of dt_ice_min
RUN = dict(do_ANT=True, start_time_of_run=0.0, end_time_of_run=T_END,
           dt_coupling=T_END, visc_it_nit=2)
CASES = {
    "A_BPA": ("A", {}),
    "C_BPA": ("C", {}),
    "A_hybrid": ("A", dict(
        choice_stress_balance_approximation="hybrid DIVA/BPA",
        choice_hybrid_DIVA_BPA_mask_ANT="read_from_file")),
}


def _mask_files(d):
    x = np.linspace(-30e3, 30e3, 13)
    y = np.linspace(-30e3, 30e3, 9)
    return write_nc_pair(d, "mask", {"x": len(x), "y": len(y)},
                         {"x": (("x",), x), "y": (("y",), y),
                          "mask_BPA": (("y", "x"),
                                       (x[None, :] > 0) * np.ones((9, 1)))})


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    exp, over = CASES[request.param]
    d = tmp_path_factory.mktemp(request.param)
    kw_j = kw_t = dict(ismip_hom(exp, **over), **RUN)
    if "choice_hybrid_DIVA_BPA_mask_ANT" in over:
        fj, ft = _mask_files(d)
        kw_j = dict(kw_j, filename_hybrid_DIVA_BPA_mask_ANT=fj)
        kw_t = dict(kw_t, filename_hybrid_DIVA_BPA_mask_ANT=ft)
    Cj = CJ(**kw_j)
    mesh_j = build_mesh_from_config(Cj, "ANT")
    rj = JaxRegion(Cj, "ANT", mesh=mesh_j)
    rj.run_to(T_END)
    rt = ModelRegion(CT(**kw_t), "ANT",
                     mesh=mesh_from_numpy(mesh_to_numpy(mesh_j)),
                     device="cpu")
    rt.run_to(T_END)
    cfg = write_cfg(d / f"ismip_hom_{request.param}.cfg", kw_t)
    rp = tprog.main([str(cfg), "--output-dir", str(d / "out"),
                     "--device", "cpu"])["ANT"]
    return request.param, rj, rt, rp, d


def test_counts_and_fields_match_jax(runs):
    case, rj, rt, rp, _ = runs
    sj = rj.state
    u_j = np.asarray(sj.u_3D_b, np.float64)
    scale = np.abs(u_j).max()
    assert scale > 0.1                           # the ice flows (m/yr)
    for r in (rt, rp):
        s = r.state
        assert r.n_dt_ice == rj.n_dt_ice == 1
        assert s.n_visc_its == int(sj.n_visc_its) > 0
        assert s.n_Axb_its == int(sj.n_Axb_its) > 0
        for name in ("u_3D_b", "v_3D_b", "u_vav_b", "v_vav_b", "Hi"):
            a = getattr(s, name).double().numpy()
            b = np.asarray(getattr(sj, name), np.float64)
            ref = scale if name != "Hi" else np.abs(b).max()
            assert np.abs(a - b).max() <= TOL * ref, (case, name)


def test_transect_u_surf_matches_jax(runs):
    case, rj, rt, rp, _ = runs
    u_j = ismip_transect(rj.mesh, np.asarray(rj.state.u_3D_b))
    assert np.isfinite(u_j).all() and np.abs(u_j).max() > 0.1
    for r in (rt, rp):
        u_t = ismip_transect(r.mesh, r.state.u_3D_b)
        assert np.abs(u_t - u_j).max() <= TOL * np.abs(u_j).max(), case


def test_outputs_and_restart_carry_the_3d_velocities(runs):
    """The surface velocity of the program's mesh output is the top layer
    of u_3D_b, and a restart written after the step gives back the 3-D
    velocities and the solver's warm-start fields to the bit (the state
    walk of io/output_files.py, as the JAX package writes them)."""
    case, _, rt, rp, d = runs
    with NCFile(str(d / "out" / "ANT" / "main_output_ANT_00001.nc")) as nc:
        assert np.array_equal(nc.read("u_surf")[-1],
                              rp.state.u_3D_b[:, 0].numpy())
        assert np.array_equal(nc.read("v_surf")[-1],
                              rp.state.v_3D_b[:, 0].numpy())
    names = ("u_3D_b", "v_3D_b", "u_vav_b", "v_vav_b", "visc_eta_3D_b")
    kept = {k: getattr(rt.state, k).clone() for k in names}
    rt.output_dir = str(d / "restart")
    rt.write_restart()
    rt.state = rt.state.replace(**{k: torch.zeros_like(v)
                                   for k, v in kept.items()})
    rt.resume_from_restart(str(d / "restart" / "restart_ANT_00001.nc"))
    for k, v in kept.items():
        assert torch.equal(getattr(rt.state, k), v), (case, k)
    assert rt.time == T_END
