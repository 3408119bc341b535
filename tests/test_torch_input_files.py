"""The port's input-file readers (ufemism2_tpu_torch/io/input_files.py)
against the JAX package's (ufemism2_tpu/io/input_files.py) on the same
files, in every layout: x/y grids in both storage orders and with flipped
axes, lon/lat grids (with the 0/360 seam and a flipped latitude), meshes,
3-D zeta and ocean-depth fields, monthly fields, 0-D series and
timeframes, and the geometry readers on a non-square and a square grid.

Each file is written twice, by the JAX package's NCFile (NetCDF4 through
h5py) and by the port's (NetCDF classic through scipy); the port reads
both, the JAX package its own. Tolerance 1e-12 relative to the field's
largest value (the maps are built independently on each side, the same
arithmetic in another summation order)."""

import numpy as np
import pytest

from torch_port_fixture import (mesh_to_numpy, write_nc,
                               write_nc_pair as write_both)

from ufemism2_tpu.io import input_files as jinp
from ufemism2_tpu.io.ncio import NCFile as JaxNC
from ufemism2_tpu.mesh import build_uniform_mesh as jax_uniform_mesh
from ufemism2_tpu.mesh.projections import inverse_oblique_sg_projection

from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.io import input_files as tinp
from ufemism2_tpu_torch.io.ncio import NCFile as PortNC

TOL = 1e-12


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh): a 100 km square at 6 km, with the ANT
    projection's lon/lat."""
    m = jax_uniform_mesh(-50e3, 50e3, -50e3, 50e3, 6e3)
    m.proj = (0.0, -90.0, 71.0)
    m.lon, m.lat = inverse_oblique_sg_projection(m.V[:, 0], m.V[:, 1],
                                                 *m.proj)
    return m, mesh_from_numpy(mesh_to_numpy(m))


def close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(b).all()
    scale = max(1.0, np.abs(b).max())
    gap = np.abs(a - b).max() / scale
    assert gap <= tol, gap


def field_xy(x, y, k=0.0):
    X, Y = np.meshgrid(x, y, indexing="ij")
    return 2.0 + 3e-5 * X - 1.5e-5 * Y + 1e-10 * X * Y + k


def xy_spec(order="xy", flip_x=False, flip_y=False, time=True, name="Hi"):
    x = np.linspace(-80e3, 80e3, 41)
    y = np.linspace(-80e3, 80e3, 37)
    F = np.stack([field_xy(x, y, k) for k in range(3)])   # [t, x, y]
    if flip_x:
        x, F = x[::-1], F[:, ::-1, :]
    if flip_y:
        y, F = y[::-1], F[:, :, ::-1]
    if order == "yx":
        F = np.swapaxes(F, 1, 2)
    sp = ("x", "y") if order == "xy" else ("y", "x")
    dims = {"x": len(x), "y": len(y)}
    variables = {"x": (("x",), x), "y": (("y",), y)}
    if time:
        dims["time"] = 3
        variables["time"] = (("time",), np.array([0.0, 100.0, 200.0]))
        variables[name] = (("time",) + sp, F)
    else:
        variables[name] = (sp, F[0])
    return dims, variables


@pytest.mark.parametrize("order, flip_x, flip_y, time, t_read", [
    ("xy", False, False, True, 100.0),
    ("yx", False, False, True, 0.0),
    ("yx", False, True, True, 200.0),
    ("xy", True, False, True, 150.0),
    ("xy", True, True, False, None),
    ("yx", False, False, False, None),
])
def test_xy_2D(tmp_path, meshes, order, flip_x, flip_y, time, t_read):
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "xy",
                        *xy_spec(order, flip_x, flip_y, time))
    ref = jinp.read_field_from_file_2D(fj, "Hi", mj, time_to_read=t_read)
    for f in (fj, fc):
        close(tinp.read_field_from_file_2D(f, "Hi", mt, time_to_read=t_read),
              ref)


@pytest.mark.parametrize("layout, method", [
    ("xy", "bilinear"), ("mesh", "nearest_neighbour"),
    ("mesh", "1st_order_conservative"), ("mesh", "trilin")])
def test_other_methods(tmp_path, meshes, layout, method):
    """Methods other than the 2nd-order conservative map: the bilinear
    sampling of an x/y grid, and the other mesh-to-mesh maps."""
    mj, mt = meshes
    spec = xy_spec(time=False) if layout == "xy" else mesh_spec(
        jax_uniform_mesh(-60e3, 60e3, -60e3, 60e3, 8e3))
    fj, fc = write_both(tmp_path, layout, *spec)
    ref = jinp.read_field_from_file_2D(fj, "Hi", mj, method=method)
    close(tinp.read_field_from_file_2D(fc, "Hi", mt, method=method), ref)


def test_field_alias(tmp_path, meshes):
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "alias",
                        *xy_spec(time=False, name="thickness"))
    ref = jinp.read_field_from_file_2D(fj, "Hi", mj)
    close(tinp.read_field_from_file_2D(fc, "Hi", mt), ref)
    with pytest.raises(KeyError):
        tinp.read_field_from_file_2D(fc, "Hb", mt)


def lonlat_spec(lon_from=0.0, flip_lat=False, name="T2m", months=False):
    lon = np.arange(lon_from, lon_from + 360.0, 5.0)
    lat = np.arange(-90.0, 90.1, 5.0)
    LO, LA = np.meshgrid(lon, lat, indexing="ij")
    F = 240.0 + 0.5 * LA + 2.0 * np.cos(np.deg2rad(LO)) \
        + 0.3 * np.sin(np.deg2rad(2 * LO))
    if flip_lat:
        lat, F = lat[::-1], F[:, ::-1]
    dims = {"lon": len(lon), "lat": len(lat)}
    variables = {"lon": (("lon",), lon), "lat": (("lat",), lat)}
    if months:
        dims["month"] = 12
        variables["month"] = (("month",), np.arange(1.0, 13.0))
        variables[name] = (("month", "lat", "lon"), np.stack(
            [F.T + m for m in range(12)]))
    else:
        variables[name] = (("lon", "lat"), F)
    return dims, variables


@pytest.mark.parametrize("lon_from, flip_lat", [(0.0, False),
                                                (-180.0, True)])
def test_lonlat_2D(tmp_path, meshes, lon_from, flip_lat):
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "ll", *lonlat_spec(lon_from, flip_lat))
    ref = jinp.read_field_from_file_2D(fj, "T2m", mj)
    for f in (fj, fc):
        close(tinp.read_field_from_file_2D(f, "T2m", mt), ref)


def test_lonlat_monthly(tmp_path, meshes):
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "llm", *lonlat_spec(months=True))
    ref = jinp.read_field_from_file_2D_monthly(fj, "T2m", mj)
    assert ref.shape == (mt.nV, 12)
    for f in (fj, fc):
        close(tinp.read_field_from_file_2D_monthly(f, "T2m", mt), ref)


def test_lonlat_needs_mesh_lonlat(tmp_path, meshes):
    _, mt = meshes
    _, fc = write_both(tmp_path, "ll", *lonlat_spec())
    bare = mesh_from_numpy({k: v for k, v in mesh_to_numpy(meshes[0]).items()
                            if k not in ("lon", "lat", "proj")})
    with pytest.raises(ValueError, match="lon/lat"):
        tinp.read_field_from_file_2D(fc, "T2m", bare)


def mesh_spec(src):
    F = 2.0 + 3e-5 * src.V[:, 0] - 1.5e-5 * src.V[:, 1]
    return ({"vi": src.nV, "ti": src.nTri, "two": 2, "three": 3},
            {"V": (("vi", "two"), src.V),
             "Tri": (("ti", "three"), src.Tri, "i8"),
             "Hi": (("vi",), F)})


@pytest.mark.parametrize("one_based", [False, True])
def test_mesh_to_mesh(tmp_path, meshes, one_based):
    """A field on another mesh (0-based as the JAX package writes it,
    1-based as the reference does), conservatively remapped; the mesh
    rebuilt from the file is the JAX package's."""
    mj, mt = meshes
    src = jax_uniform_mesh(-60e3, 60e3, -60e3, 60e3, 8e3)
    dims, variables = mesh_spec(src)
    if one_based:
        variables["Tri"] = (("ti", "three"), src.Tri + 1, "i8")
    fj, fc = write_both(tmp_path, "mesh", dims, variables)
    ref = jinp.read_field_from_file_2D(fj, "Hi", mj)
    for f in (fj, fc):
        close(tinp.read_field_from_file_2D(f, "Hi", mt), ref)
    mj2, mt2 = jinp.setup_mesh_from_file(fj), tinp.setup_mesh_from_file(fc)
    assert np.array_equal(mj2.V, mt2.V) and np.array_equal(mj2.Tri, mt2.Tri)
    assert np.allclose(mj2.A, mt2.A, rtol=1e-13, atol=0.0)


def zeta_spec(nz_src):
    x = np.linspace(-80e3, 80e3, 25)
    y = np.linspace(-80e3, 80e3, 27)
    zeta = np.linspace(0.0, 1.0, nz_src)
    F = field_xy(x, y)[None] + 10.0 * zeta[:, None, None] ** 2
    return ({"x": len(x), "y": len(y), "zeta": nz_src},
            {"x": (("x",), x), "y": (("y",), y), "zeta": (("zeta",), zeta),
             "Ti": (("zeta", "x", "y"), F)})


@pytest.mark.parametrize("nz_src", [7, 12])
def test_3D_zeta(tmp_path, meshes, nz_src):
    """A 3-D zeta field; at 7 layers remapped in the vertical, at the
    mesh's own regular 12 taken as it is."""
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "z", *zeta_spec(nz_src))
    ref = jinp.read_field_from_file_3D(fj, "Ti", mj)
    assert ref.shape == (mt.nV, mt.nz)
    for f in (fj, fc):
        close(tinp.read_field_from_file_3D(f, "Ti", mt), ref)


def ocean_spec(with_nan):
    x = np.linspace(-80e3, 80e3, 25)
    y = np.linspace(-80e3, 80e3, 25)
    depth = np.array([50.0, 150.0, 300.0, 600.0, 1200.0, 2000.0])
    T = (1.0 + 1e-3 * depth)[:, None, None] + 1e-6 * field_xy(x, y)[None]
    if with_nan:
        T[-1] = np.nan          # a depth with no data anywhere
    return ({"x": len(x), "y": len(y), "depth": len(depth)},
            {"x": (("x",), x), "y": (("y",), y),
             "depth": (("depth",), depth),
             "T_ocean": (("depth", "y", "x"), np.swapaxes(T, 1, 2))})


@pytest.mark.parametrize("with_nan", [False, True])
def test_3D_ocean(tmp_path, meshes, with_nan):
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "oc", *ocean_spec(with_nan))
    z_ocean = np.arange(0.0, 1501.0, 100.0)
    ref = jinp.read_field_from_file_3D_ocean(fj, "T_ocean", mj, z_ocean)
    assert ref.shape == (mt.nV, len(z_ocean))
    for f in (fj, fc):
        close(tinp.read_field_from_file_3D_ocean(f, "T_ocean", mt, z_ocean),
              ref)


def series_spec():
    t = np.array([-1000.0, -500.0, 0.0, 250.0])
    return ({"time": len(t)},
            {"time": (("time",), t),
             "dT": (("time",), np.array([-2.0, -1.0, 0.5, 1.5])),
             "CO2": (("time",), np.array([190.0, 220.0, 280.0, 400.0]))})


@pytest.mark.parametrize("name, t", [("dT_ocean", -750.0),
                                     ("dT_ocean", 100.0), ("CO2", None),
                                     ("CO2", 5000.0)])
def test_series_0D(tmp_path, name, t):
    fj, fc = write_both(tmp_path, "series", *series_spec())
    ref = jinp.read_field_from_file_0D(fj, name, time_to_read=t)
    assert tinp.read_field_from_file_0D(fc, name, time_to_read=t) == ref
    tj, dj = jinp.read_series_from_file(fj, name)
    tt, dt = tinp.read_series_from_file(fc, name)
    assert np.array_equal(tj, tt) and np.array_equal(dj, dt)


def test_timeframes(tmp_path, meshes):
    """find_timeframe (in range and beyond it), and every frame of a
    series at once with and without a window."""
    mj, mt = meshes
    fj, fc = write_both(tmp_path, "xy", *xy_spec())
    with JaxNC(fj) as a:
        ncp = PortNC(fc)
        for t in (-50.0, 49.0, 51.0, 180.0, 1e4):
            assert tinp.find_timeframe(ncp, t) == jinp.find_timeframe(a, t)
    for window in (None, (90.0, 110.0)):
        tj, Fj = jinp.load_timeframe_series(fj, "Hi", mj, t_window=window)
        tt, Ft = tinp.load_timeframe_series(fc, "Hi", mt, t_window=window)
        assert np.array_equal(tj, tt)
        close(Ft, Fj)


@pytest.mark.parametrize("nx, ny, order", [(41, 37, "yx"), (41, 37, "xy"),
                                           (33, 33, "yx")])
def test_geometry_readers(tmp_path, meshes, nx, ny, order):
    """read_geometry_onto_mesh and read_geometry_grid_raw: the [y, x] or
    [x, y] orientation is told from the shape, so a square grid always
    reads as [x, y], in the port as in the JAX package."""
    mj, mt = meshes
    x = np.linspace(-80e3, 80e3, nx)
    y = np.linspace(-70e3, 90e3, ny)
    Hi = 500.0 + field_xy(x, y) * 100.0
    Hb = -200.0 + 1e-3 * np.add.outer(x, 2 * y)
    SL = np.zeros_like(Hi) + 1.5
    tr = (lambda a: a.T) if order == "yx" else (lambda a: a)
    sp = ("y", "x") if order == "yx" else ("x", "y")
    fj, fc = write_both(tmp_path, "geo", {"x": nx, "y": ny}, {
        "x": (("x",), x), "y": (("y",), y), "Hi": (sp, tr(Hi)),
        "Hb": (sp, tr(Hb)), "SL": (sp, tr(SL))})
    out = []
    for f, inp, m, CC in ((fj, jinp, mj, None), (fc, tinp, mt, Config)):
        from ufemism2_tpu.config import Config as JaxConfig
        C = (CC or JaxConfig)(filename_refgeo_init_ANT=f,
                              filename_refgeo_PD_ANT=f, refgeo_Hi_min=2.0)
        out.append((inp.read_geometry_onto_mesh(C, "ANT", m, which="PD"),
                    inp.read_geometry_grid_raw(C, "ANT")))
    (geo_j, raw_j), (geo_t, raw_t) = out
    for a, b in zip(geo_t, geo_j):
        close(a, b)
    assert np.array_equal(raw_t[0], raw_j[0]) \
        and np.array_equal(raw_t[1], raw_j[1])
    assert sorted(raw_t[2]) == sorted(raw_j[2]) == ["Hb", "Hi", "SL"]
    for k in raw_j[2]:
        assert np.array_equal(raw_t[2][k], raw_j[2][k])
    if nx != ny:
        assert raw_t[2]["Hi"].shape == (nx, ny)
        assert np.array_equal(raw_t[2]["Hi"], Hi)


def test_layout_detection(tmp_path, meshes):
    src = jax_uniform_mesh(-60e3, 60e3, -60e3, 60e3, 20e3)
    files = {"xy": write_both(tmp_path, "a", *xy_spec())[1],
             "lonlat": write_both(tmp_path, "b", *lonlat_spec())[1],
             "mesh": write_both(tmp_path, "c", *mesh_spec(src))[1]}
    for layout, f in files.items():
        assert tinp.inquire_file_layout(PortNC(f)) == layout
    bad = write_nc(PortNC, tmp_path / "bad.nc", {"k": 3},
                {"k": (("k",), np.zeros(3))})
    with pytest.raises(ValueError, match="grid type"):
        tinp.inquire_file_layout(PortNC(bad))
