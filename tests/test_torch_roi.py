"""The port's regions of interest against the JAX package's: the polygon
registry (ufemism2_tpu_torch/mesh/roi_polygons.py, every polygon to the
bit), the point-in-polygon test that stands in for matplotlib's
Path.contains_points (mesh/refinement.py points_in_polygon: equal on mesh
vertices, triangle centroids, and points on the polygons' vertices and
edges, matplotlib's boundary rule), a ROI-refined mesh on a coarse
Antarctic domain (equal to the JAX package's, array for array), the
hybrid's ROI mask, the reconstructed SMB (f64, 1e-12 relative) and the
per-ROI scalars (1e-12 relative)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from matplotlib.path import Path as MplPath

from torch_port_fixture import mesh_to_numpy, rel_gap

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.mesh import build_mesh_from_config as j_build
from ufemism2_tpu.mesh import build_uniform_mesh
from ufemism2_tpu.mesh import roi_polygons as jroi
from ufemism2_tpu.core.mesh_data import build_mesh_data as jbmd

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data as tbmd
from ufemism2_tpu_torch.mesh import build_mesh_from_config as t_build
from ufemism2_tpu_torch.mesh import roi_polygons as troi
from ufemism2_tpu_torch.mesh.refinement import points_in_polygon

NAMES = sorted(jroi._POLYGONS)
TOL = 1e-12


def test_registry_matches():
    assert troi.list_rois() == jroi.list_rois() == NAMES
    assert len(NAMES) == 29
    for name in NAMES:
        a, b = troi._POLYGONS[name], jroi._POLYGONS[name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # the case-insensitive lookup, and unknown names
    assert troi.calc_roi_polygon(" pine_island_glacier ") is \
        troi._POLYGONS["Pine_Island_Glacier"]
    with pytest.raises(ValueError, match="unknown region of interest"):
        troi.calc_roi_polygon("Atlantis")


@pytest.fixture(scope="module")
def polar_mesh():
    """A 60 km uniform mesh over most of Antarctica (every ANT polygon
    lies in it or reaches into it)."""
    return build_uniform_mesh(-2.8e6, 2.8e6, -2.4e6, 2.4e6, 60e3)


@pytest.mark.parametrize("name", NAMES)
def test_points_in_polygon_like_matplotlib(polar_mesh, name):
    """Mesh vertices, centroids, the polygon's own vertices, its edge
    midpoints, and points 1 m off each vertex along x and y: the same
    answer as matplotlib, point for point."""
    poly = troi.calc_roi_polygon(name)
    lo, hi = poly.min(0), poly.max(0)
    rng = np.random.default_rng(len(poly))
    sets = [polar_mesh.V, polar_mesh.TriGC, poly,
            0.5 * (poly + np.roll(poly, -1, axis=0)),
            poly + [1.0, 0.0], poly - [1.0, 0.0],
            poly + [0.0, 1.0], poly - [0.0, 1.0],
            lo + (hi - lo) * rng.random((2000, 2))]
    for pts in sets:
        pts = np.asarray(pts, np.float64)
        np.testing.assert_array_equal(points_in_polygon(pts, poly),
                                      MplPath(poly).contains_points(pts))


def _antarctic_geometry():
    """A coarse gridded geometry over the Amundsen Sea sector: an ice
    sheet with a floating fringe on a bed that deepens seawards."""
    x = np.linspace(-2.2e6, -0.6e6, 81)
    y = np.linspace(-1.2e6, 0.4e6, 81)
    X, Y = np.meshgrid(x, y, indexing="ij")
    r = np.hypot(X + 0.6e6, Y - 0.4e6)
    Hb = 800.0 - r * 1.4e-3
    Hi = np.clip(3200.0 * (1.0 - (r / 1.35e6) ** 2), 0.0, None)
    Hi = np.where(Hi < 50.0, 0.0, Hi)
    return x, y, Hi, Hb, np.zeros_like(Hi)


MESH_OVER = dict(
    choice_regions_of_interest="Pine_Island_Glacier,Thwaites_Glacier",
    xmin_ANT=-2.2e6, xmax_ANT=-0.6e6, ymin_ANT=-1.2e6, ymax_ANT=0.4e6,
    maximum_resolution_uniform=200e3,
    maximum_resolution_grounded_ice=150e3,
    maximum_resolution_floating_ice=100e3,
    maximum_resolution_grounding_line=60e3, grounding_line_width=50e3,
    maximum_resolution_calving_front=100e3, calving_front_width=100e3,
    maximum_resolution_ice_front=150e3, ice_front_width=100e3,
    maximum_resolution_coastline=200e3, coastline_width=100e3,
    ROI_maximum_resolution_uniform=60e3,
    ROI_maximum_resolution_grounding_line=20e3,
    ROI_maximum_resolution_calving_front=40e3, nit_Lloyds_algorithm=2)


def test_roi_refined_mesh_matches():
    """The mesh refined inside the Pine Island and Thwaites polygons (the
    polygon criterion and the grounding-line and calving-front lines
    clipped to it) is the JAX package's, array for array; and it is finer
    inside the polygons than the same mesh without them."""
    geo = _antarctic_geometry()
    mj = j_build(CJ(**MESH_OVER), "ANT", geometry=geo)
    mt = t_build(CT(**MESH_OVER), "ANT", geometry=geo)
    assert (mt.nV, mt.nTri) == (mj.nV, mj.nTri)
    for f in dataclasses.fields(mt):
        if f.name in ("operators", "device"):
            continue
        a, b = getattr(mt, f.name), getattr(mj, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, np.asarray(b)), f.name
    plain = t_build(CT(**dict(MESH_OVER, choice_regions_of_interest="")),
                    "ANT", geometry=geo)
    assert mt.nV > plain.nV


def test_hybrid_roi_mask():
    """choice_hybrid_DIVA_BPA_mask 'ROI': the triangles whose circumcentre
    lies in a region of interest."""
    from ufemism2_tpu.core.ice.hybrid import resolve_hybrid_mask as jmask
    from ufemism2_tpu_torch.core.ice.hybrid import resolve_hybrid_mask as tmask
    mj = build_uniform_mesh(-2.2e6, -0.6e6, -1.2e6, 0.4e6, 40e3)
    mt = mesh_from_numpy(mesh_to_numpy(mj))
    over = dict(choice_regions_of_interest="Pine_Island_Glacier,"
                "Thwaites_Glacier", choice_hybrid_DIVA_BPA_mask_ANT="ROI")
    a = tmask(CT(**over), mt, "ANT")
    b = np.asarray(jmask(CJ(**over), mj, "ANT"))
    assert a.shape == (mt.nTri,) and a.any()
    np.testing.assert_array_equal(a, b)


def test_reconstructed_smb():
    """The Patagonia reconstructed SMB on a mesh over its polygon, from a
    seeded surface and flux divergence."""
    from ufemism2_tpu.models.smb import make_run_smb as jsmb
    from ufemism2_tpu_torch.models.smb import make_run_smb as tsmb
    mj = build_uniform_mesh(-4.0e5, 3.0e5, -1.0e6, 1.05e6, 50e3)
    mt = mesh_from_numpy(mesh_to_numpy(mj))
    mdj, mdt = jbmd(mj), tbmd(mt, device="cpu")
    over = dict(choice_regions_of_interest="Patagonia",
                choice_SMB_model_ANT="reconstructed")
    rng = np.random.default_rng(11)
    Hs = 3000.0 * rng.random(mj.nV)
    divQ = 4.0 * rng.standard_normal(mj.nV)
    rj = jsmb(CJ(**over), mdj, "ANT")
    rt = tsmb(CT(**over), mdt, "ANT")
    bj = np.asarray(rj(0.0, SimpleNamespace(Hs=jnp.asarray(Hs),
                                            divQ=jnp.asarray(divQ))))
    bt = rt(0.0, SimpleNamespace(Hs=torch.tensor(Hs),
                                 divQ=torch.tensor(divQ)))
    assert rel_gap(bt, bj) <= TOL
    assert (bt > 0).any() and (bt < 0).any()
    with pytest.raises(ValueError, match="Patagonia"):
        tsmb(CT(**dict(over, choice_regions_of_interest="Amery_ice_shelf")),
             mdt, "ANT")


def test_roi_scalars():
    """calc_ice_scalars restricted to a region of interest's vertices."""
    from ufemism2_tpu.core.ice.scalars import calc_ice_scalars as jscal
    from ufemism2_tpu_torch.core.ice.scalars import calc_ice_scalars as tscal
    mj = build_uniform_mesh(-2.2e6, -0.6e6, -1.2e6, 0.4e6, 40e3)
    mt = mesh_from_numpy(mesh_to_numpy(mj))
    mdj, mdt = jbmd(mj), tbmd(mt, device="cpu")
    rng = np.random.default_rng(2)
    f = dict(Hi=np.clip(2000.0 * rng.random(mj.nV) - 300.0, 0.0, None),
             Hb=-500.0 + 1000.0 * rng.random(mj.nV), SL=np.zeros(mj.nV),
             SMB=rng.standard_normal(mj.nV), BMB=rng.standard_normal(mj.nV),
             LMB=rng.standard_normal(mj.nV))
    poly = troi.calc_roi_polygon("Thwaites_Glacier")
    m = points_in_polygon(mj.V, poly)
    assert 5 < m.sum() < mj.nV // 2
    sj = jscal(mdj, *(jnp.asarray(f[k]) for k in ("Hi", "Hb", "SL")), None,
               *(jnp.asarray(f[k]) for k in ("SMB", "BMB", "LMB")),
               roi_mask=jnp.asarray(m))
    st = tscal(mdt, *(torch.tensor(f[k]) for k in ("Hi", "Hb", "SL")), None,
               *(torch.tensor(f[k]) for k in ("SMB", "BMB", "LMB")),
               roi_mask=torch.as_tensor(m))
    assert set(st) == set(sj)
    for k in st:
        assert rel_gap(st[k], np.asarray(sj[k])) <= TOL, k
