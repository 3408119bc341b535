"""The port's own host-side mesh engine (its copy of the numpy/scipy mesh
code, with a numpy marching-squares contour tracer in place of the JAX
package's contourpy call) against the JAX package's: the fixture
configuration must give the identical mesh and operators, since the parity
tests of the device code hand the JAX side's mesh to the port."""

import dataclasses

import numpy as np

from torch_port_fixture import configs, mesh_to_numpy

from ufemism2_tpu.mesh import build_mesh_from_config as j_build
from ufemism2_tpu.mesh.creation import _contour_lines as j_contours
from ufemism2_tpu.mesh.operators import \
    build_all_matrix_operators as j_operators

from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.mesh import build_mesh_from_config as t_build
from ufemism2_tpu_torch.mesh.creation import _contour_lines as t_contours
from ufemism2_tpu_torch.mesh.operators import \
    build_all_matrix_operators as t_operators


def _segments(lines):
    """The set of undirected segments of a list of polylines, rounded."""
    out = set()
    for l in lines:
        p = np.round(np.asarray(l), 9)
        for a, b in zip(p[:-1], p[1:]):
            out.add(tuple(sorted((tuple(a), tuple(b)))))
    return out


def test_contour_lines_match_contourpy():
    rng = np.random.default_rng(0)
    x, y = np.linspace(0.0, 1.0, 40), np.linspace(0.0, 2.0, 50)
    F = np.sin(6 * x)[:, None] * np.cos(5 * y)[None, :] \
        + 0.1 * rng.standard_normal((40, 50))
    for level in (0.0, 0.3):
        a, b = j_contours(x, y, F, level), t_contours(x, y, F, level)
        assert len(a) == len(b) > 0
        assert _segments(a) == _segments(b)


def test_fixture_mesh_and_operators_are_identical():
    Cj, Ct = configs()
    mj, mt = j_build(Cj, "ANT"), t_build(Ct, "ANT")
    assert (mj.nV, mj.nTri, mj.nE) == (mt.nV, mt.nTri, mt.nE)
    assert mj.nV > 1000
    for f in dataclasses.fields(mj):
        if f.name in ("operators", "device"):
            continue
        a, b = getattr(mj, f.name), getattr(mt, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    oj, ot = j_operators(mj), t_operators(mt)
    names = [f.name for f in dataclasses.fields(oj)]
    assert "M2_d2dxdy_b_b" in names and "M_map_a_b" in names
    for name in names:
        a, b = getattr(oj, name), getattr(ot, name)
        if a is None:
            assert b is None, name
            continue
        assert a.shape == b.shape and abs(a - b).max() == 0.0, name


def test_mesh_from_numpy_round_trip():
    Cj, _ = configs()
    mj = j_build(Cj, "ANT")
    arrays = mesh_to_numpy(mj)
    mt = mesh_from_numpy(arrays)
    assert mt.operators is None
    for name, a in arrays.items():
        b = getattr(mt, name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and b is not a, name
        else:
            assert a == b, name


def test_points_in_polygon_and_bedrock_cdfs_match():
    """The two other places where the port's host code takes a numpy
    route (the JAX package goes through matplotlib): the point-in-polygon
    test of the refinement criteria and the triangle lookup of the bedrock
    CDFs."""
    from ufemism2_tpu.mesh.refinement import points_in_polygon as j_pip
    from ufemism2_tpu_torch.mesh.refinement import points_in_polygon as t_pip
    from ufemism2_tpu.core.ice.bedrock_cdf import \
        build_bedrock_cdfs_from_config as j_cdfs
    from ufemism2_tpu_torch.core.ice.bedrock_cdf import \
        build_bedrock_cdfs_from_config as t_cdfs
    rng = np.random.default_rng(4)
    ang = np.sort(rng.random(60)) * 2 * np.pi
    poly = np.column_stack([np.cos(ang), np.sin(ang)]) \
        * (0.6 + 0.4 * rng.random(60))[:, None]
    pts = rng.random((5000, 2)) * 2.4 - 1.2
    inside = t_pip(pts, poly)
    assert np.array_equal(inside, j_pip(pts, poly))
    assert 0.2 < inside.mean() < 0.8
    Cj, Ct = configs()
    mj = j_build(Cj, "ANT")
    mt = mesh_from_numpy(mesh_to_numpy(mj))
    (aj, bj), (at, bt) = j_cdfs(Cj, mj, "ANT"), t_cdfs(Ct, mt, "ANT")
    aj, bj = np.asarray(aj), np.asarray(bj)
    assert at.shape == aj.shape == (mj.nV, Ct.subgrid_bedrock_cdf_nbins)
    assert bt.shape == bj.shape == (mj.nTri, Ct.subgrid_bedrock_cdf_nbins)
    # vertices (nearest-vertex membership): the same quantiles
    assert np.array_equal(at, aj)
    # triangles: the same quantiles too - a point of the bedrock grid that
    # lies exactly on an edge or a vertex of the mesh goes to the same
    # triangle in both lookups
    assert np.array_equal(bt, bj)
    import matplotlib.tri as mtri
    from ufemism2_tpu_torch.core.ice.bedrock_cdf import \
        find_containing_triangles
    from ufemism2_tpu_torch.core.idealised_geometries import \
        generate_idealised_geometry_grid
    x, y, *_ = generate_idealised_geometry_grid(Ct, "ANT", which="init")
    X, Y = np.meshgrid(x, y, indexing="ij")
    finder = mtri.Triangulation(mj.V[:, 0], mj.V[:, 1],
                                mj.Tri).get_trifinder()
    owner = find_containing_triangles(mt.V, mt.Tri, x, y)
    assert np.array_equal(owner, finder(X.ravel(), Y.ravel()))
    # the grid does put points on edges and vertices of this mesh
    P = mj.V[mj.Tri[owner]]
    cross = [(X.ravel() - P[:, i, 0]) * (P[:, (i + 1) % 3, 1] - P[:, i, 1])
             - (Y.ravel() - P[:, i, 1]) * (P[:, (i + 1) % 3, 0] - P[:, i, 0])
             for i in range(3)]
    assert (np.min(np.abs(cross), axis=0) == 0.0).sum() > 10
