"""The port's hybrid DIVA/BPA stress balance against the JAX package's, on
the CPU, with tests/test_hybrid.py's Halfar dome on the conftest's small
mesh, an all-DIVA mask reproduces the port's own DIVA solve (the merged
system is then algebraically the DIVA system); with a mixed mask (BPA for
x > 0) on ISMIP-HOM A, the port's hybrid solve is the JAX package's, with
the same counts; the mask read from a file is the JAX package's in both
of its layouts.

Tolerance: 1e-10 of the largest velocity, as in tests/test_hybrid.py and
tests/test_torch_bpa.py (f64 on both sides, summation order apart)."""

import numpy as np
import pytest
import torch

from torch_port_fixture import mesh_to_numpy, write_nc_pair, ismip_hom

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.core.ice import hybrid as jhy

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.core.ice import hybrid as thy
from ufemism2_tpu_torch.core.ice.ssadiva import make_solve_ssa_diva

from test_torch_bpa import halfar_setup, ismip_setup, solve_both

TOL = 1e-10

# tests/test_hybrid.py's configuration
HYBRID = dict(choice_stress_balance_approximation="hybrid DIVA/BPA",
              visc_it_nit=30)


def _gap(a, b, scale):
    a = a.double().numpy() if hasattr(a, "double") else np.asarray(a)
    return float(np.abs(a - np.asarray(b, np.float64)).max()) / scale


def test_all_diva_mask_is_the_diva_solve(small_mesh):
    e = halfar_setup(small_mesh, **HYBRID)
    st, md = e.st, e.mdt
    uh, vh, u3h, v3h, nvh, nah = thy.make_solve_hybrid(
        e.Ct, md, np.zeros(md.nTri, bool))(md, st.Hi, st.Hs, st.Hb, st.SL,
                                           st.Ti, st)
    ud, vd = make_solve_ssa_diva(e.Ct, md, "DIVA")(
        md, st.Hi, st.Hs, st.Hb, st.SL, st.Ti, st)[:2]
    scale = max(float(ud.abs().max()), 1e-6)
    assert scale > 1.0                         # the dome flows
    assert torch.isfinite(uh).all() and nah > 0
    assert float((uh - ud).abs().max()) / scale < TOL
    assert float((vh - vd).abs().max()) / scale < TOL
    # off the BPA side the profile is the vertical mean
    assert torch.equal(u3h, uh[:, None].expand_as(u3h))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The mixed mask (BPA where x > 0, read from a file as a user
    configures it) on ISMIP-HOM A (L 20 km, 5 km), through each package's
    make_solve_stress_balance, three viscosity iterations. The dome of
    tests/test_hybrid.py does not serve here: with Weertman sliding the
    hybrid's f64 GMRES solves end by stagnation, and two summation orders
    part in their counts (27 against 26 viscosity iterations, some 21,000
    Krylov iterations); without sliding the counts agree but the fields
    only to 2e-6."""
    x = np.linspace(-30e3, 30e3, 13)
    y = np.linspace(-30e3, 30e3, 9)
    m = (x[None, :] > 0.0) * np.ones((len(y), 1))          # [y, x]
    fj, ft = write_nc_pair(tmp_path_factory.mktemp("hybrid"), "mask",
                           {"x": len(x), "y": len(y)},
                           {"x": (("x",), x), "y": (("y",), y),
                            "mask_BPA": (("y", "x"), m)})
    over = dict(choice_stress_balance_approximation="hybrid DIVA/BPA",
                choice_hybrid_DIVA_BPA_mask_ANT="read_from_file",
                visc_it_nit=2)
    e = ismip_setup("A", **over, filename_hybrid_DIVA_BPA_mask_ANT=fj)
    e.Ct = CT(**ismip_hom("A", **over,
                          filename_hybrid_DIVA_BPA_mask_ANT=ft))
    oj, ot = solve_both(e)
    return e, oj, ot


def test_mixed_mask_matches_jax(mixed):
    e, oj, ot = mixed
    mesh = e.mdt._host_mesh
    mask = thy.resolve_hybrid_mask(e.Ct, mesh, "ANT")
    assert np.array_equal(mask, mesh.Tricc[:, 0] > 0.0)
    assert mask.any() and (~mask).any()
    assert ot[4] == int(oj[4]) > 0
    assert ot[5] == int(oj[5]) > 0
    scale = max(float(np.abs(np.asarray(oj[i])).max()) for i in range(4))
    assert scale > 0.1
    for i in range(4):
        assert _gap(ot[i], oj[i], scale) <= TOL, (i, _gap(ot[i], oj[i],
                                                          scale))
    # the composed fields: the vertical mean as the DIVA side's profile,
    # the BPA side's own vertical structure (the base slower than the
    # surface, no slip)
    u3 = ot[2]
    assert torch.equal(u3[~mask], ot[0][~mask][:, None].expand(-1, u3.shape[1]))
    assert (u3[mask, -1] == 0).all()
    assert (u3[mask, 0].abs() > 0).any()


@pytest.mark.parametrize("layout", ["yx", "xy"])
def test_mask_from_file_matches_jax(small_mesh, tmp_path, layout):
    """Both layouts of the mask file (a grid that is not square, so the
    layout is told by its shape) give the JAX function's mask."""
    x = np.linspace(-55e3, 55e3, 12)
    y = np.linspace(-52e3, 52e3, 7)
    field = (np.sin(x[None, :] / 2e4) * np.cos(y[:, None] / 3e4) > 0.1) \
        .astype(float)                                     # [y, x]
    dims = ("y", "x") if layout == "yx" else ("x", "y")
    data = field if layout == "yx" else field.T
    fj, ft = write_nc_pair(tmp_path, f"mask_{layout}",
                           {"x": len(x), "y": len(y)},
                           {"x": (("x",), x), "y": (("y",), y),
                            "mask_BPA": (dims, data)})
    mesh_t = mesh_from_numpy(mesh_to_numpy(small_mesh))
    kw = dict(choice_hybrid_DIVA_BPA_mask_ANT="read_from_file")
    mj = jhy.resolve_hybrid_mask(
        CJ(**kw, filename_hybrid_DIVA_BPA_mask_ANT=fj), small_mesh, "ANT")
    mt = thy.resolve_hybrid_mask(
        CT(**kw, filename_hybrid_DIVA_BPA_mask_ANT=ft), mesh_t, "ANT")
    assert mt.dtype == bool and mt.any() and (~mt).any()
    assert np.array_equal(mt, np.asarray(mj))


def test_roi_mask_raises_by_name(small_mesh):
    mesh_t = mesh_from_numpy(mesh_to_numpy(small_mesh))
    C = CT(choice_hybrid_DIVA_BPA_mask_ANT="ROI")
    with pytest.raises(NotImplementedError, match="A.15"):
        thy.resolve_hybrid_mask(C, mesh_t, "ANT")
    with pytest.raises(ValueError, match="choice_hybrid_DIVA_BPA_mask_ANT"):
        thy.resolve_hybrid_mask(CT(choice_hybrid_DIVA_BPA_mask_ANT="x"),
                                mesh_t, "ANT")
