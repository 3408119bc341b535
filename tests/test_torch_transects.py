"""The port's transects (ufemism2_tpu_torch/models/transects.py) against
the JAX package's (ufemism2_tpu/models/transects.py) on the 40 km MISMIP+
mesh: the resampled points, the sampling maps, the velocity components,
the zero-crossing distances, every hardcoded set and a waypoint file, and
the transect output file (the port's NetCDF classic file against the JAX
package's NetCDF4 one, both read back through the port's ncio). f64;
the maps are host scipy matrices on both sides, built independently, so
sampled values agree to 1e-13 relative."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_fixture import build_meshes_for, mismipplus_configs

from ufemism2_tpu.models import transects as jtr

from ufemism2_tpu_torch.io.ncio import NCFile
from ufemism2_tpu_torch.models import transects as ttr

TOL = 1e-13


@pytest.fixture(scope="module")
def meshes():
    Cj, _ = mismipplus_configs()
    return build_meshes_for(Cj)


def pair(meshes, maker):
    mj, mt = meshes
    return maker(jtr, mj), maker(ttr, mt)


def test_parse_and_resample():
    for s in ("westeast,dx=1e3", "file:/a/b/my_line.cfg,dx=2.5e3"):
        assert ttr.parse_transect_str(s) == jtr.parse_transect_str(s)
    with pytest.raises(ValueError, match="no dx"):
        ttr.parse_transect_str("westeast")
    wp = np.array([[0.0, 0.0], [3e3, 4e3], [3e3, 10e3]])
    for dx in (0.7e3, 1e3, 50e3):
        assert np.array_equal(ttr.resample_waypoints(wp, dx),
                              jtr.resample_waypoints(wp, dx))


@pytest.mark.parametrize("name", [
    "westeast", "southnorth", "east", "west", "north", "south", "northeast",
    "southwest", "ISMIP-HOM", "Thwaites_groundingline",
    "PineIsland_centralflowline"])
def test_named_transect(meshes, name):
    """Points, distances, tangents, normals, the vertex map and the
    nearest triangles of every hardcoded set (the Antarctic ones lie off
    this mesh: their points take the nearest triangle's weights)."""
    tj, tt = pair(meshes, lambda m, mesh: m.Transect.named(mesh, name,
                                                            dx=2e3))
    for k in ("points", "s", "tangent", "normal", "tri_idx", "zeta"):
        assert np.array_equal(getattr(tt, k), getattr(tj, k)), k
    assert tt.M_vertices.shape == tj.M_vertices.shape
    assert abs(tt.M_vertices - tj.M_vertices).max() <= TOL


def test_unknown_name(meshes):
    with pytest.raises(ValueError, match="unknown native transect"):
        ttr.Transect.named(meshes[1], "nowhere")


def test_waypoint_file(meshes, tmp_path):
    f = tmp_path / "line.cfg"
    f.write_text("! a comment\n100e3 -10e3\n300e3 5e3\n500e3 0.0\n")
    tj, tt = pair(meshes, lambda m, mesh: m.Transect.from_config_str(
        mesh, f"file:{f},dx=3e3"))
    assert tt.name == tj.name == "line"
    assert np.array_equal(tt.points, tj.points)
    assert abs(tt.M_vertices - tj.M_vertices).max() <= TOL


def test_sampling_and_velocity(meshes):
    mj, mt = meshes
    rng = np.random.default_rng(3)
    tj, tt = pair(meshes, lambda m, mesh: m.Transect.named(
        mesh, "westeast", dx=1e3))
    f = rng.standard_normal((mt.nV, 3))
    u3, v3 = rng.standard_normal((2, mt.nTri, mt.nz))
    a, b = tt.sample_vertices(f), tj.sample_vertices(f)
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    assert np.array_equal(tt.sample_triangles(u3), tj.sample_triangles(u3))
    for a, b in zip(tt.velocity_components(u3, v3),
                    tj.velocity_components(u3, v3)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("f", [
    [5.0, 3.0, 1.0, -1.0, -2.0, 1.0, 2.0, -0.5],
    [1.0, 0.0, -1.0, 2.0, 3.0, 0.5, 0.0, 0.0],
    [-1.0, -2.0, -3.0, -4.0, -5.0, -6.0, -7.0, -8.0],
])
def test_zero_crossing_distance(meshes, f):
    tj, tt = pair(meshes, lambda m, mesh: m.Transect(
        mesh, np.column_stack([np.linspace(1e5, 6e5, 8), np.zeros(8)])))
    for from_end in (False, True):
        a = tt.zero_crossing_distance(np.array(f), from_end=from_end)
        b = tj.zero_crossing_distance(np.array(f), from_end=from_end)
        assert a == b or (np.isnan(a) and np.isnan(b))


def test_output_file(meshes, tmp_path):
    """Two frames written by each package's TransectOutputFile from the
    same fields (a grounding line and a calving front on the centreline);
    every variable equal within TOL."""
    mj, mt = meshes
    rng = np.random.default_rng(9)
    x = mt.V[:, 0]
    frames = []
    for k in range(2):
        Hi = np.clip(900.0 - 1.3e-3 * x + 30.0 * k, 0.0, None)
        Hb = -100.0 - 1.2e-3 * x
        SL = np.zeros_like(Hi)
        TAF = Hi - np.maximum(0.0, (SL - Hb) * 1027.0 / 917.0)
        Hib = np.maximum(SL - Hi * 917.0 / 1027.0, Hb)
        frames.append(dict(Hi=Hi, Hb=Hb, SL=SL, TAF=TAF, Hib=Hib,
                           Hs=Hib + Hi,
                           u_3D_b=rng.standard_normal((mt.nTri, mt.nz)),
                           v_3D_b=rng.standard_normal((mt.nTri, mt.nz))))
    tj, tt = pair(meshes, lambda m, mesh: m.Transect.named(
        mesh, "westeast", dx=1e3))
    fj, fc = tmp_path / "jax.nc", tmp_path / "port.nc"
    oj, ot = jtr.TransectOutputFile(fj, tj), ttr.TransectOutputFile(fc, tt)
    for k, fr in enumerate(frames):
        oj.write(10.0 * k, SimpleNamespace(**fr))
        ot.write(10.0 * k, SimpleNamespace(**{
            n: torch.from_numpy(v) for n, v in fr.items()}))
    oj.close()
    ot.close()
    a, b = NCFile(fc), NCFile(fj)
    assert a.dims()["time"] == 2
    # the JAX package's zeta is an HDF5 dimension scale, which the port's
    # reader lists as a dimension (readable all the same)
    names = [n for n in a.variables() if n != "time"]
    assert sorted(names) == sorted(b.variables() + ["zeta"])
    assert np.array_equal(a.read("time"), b.read("time"))
    for n in names:
        va, vb = a.read(n), b.read(n)
        assert va.shape == vb.shape, n
        # from the end no crossing from positive to non-positive exists:
        # NaN on both sides
        nan = np.isnan(vb)
        assert np.array_equal(np.isnan(va), nan), n
        if nan.all():
            continue
        scale = max(1.0, np.abs(vb[~nan]).max())
        assert np.abs(va[~nan] - vb[~nan]).max() <= 1e-12 * scale, n
    gl = a.read("grounding_line_distance_from_start")
    assert 0.0 < gl[0] < gl[1] < 800e3
