"""Input file reading: fields from NetCDF files onto the model mesh.

Re-design of src/UPSY/io/netcdf_input/ (netcdf_determine_indexing.f90,
netcdf_read_field_from_{xy_grid,lonlat_grid,mesh,series}_file.f90,
netcdf_setup_grid_mesh_from_file.f90) and
src/UPSY/io/read_and_remap/read_and_remap_field_from_file.f90: a file can
hold data on a regular x/y grid, a regular lon/lat grid, or a mesh; the
layout is detected, indexing and orientation are normalised, the requested
timeframe is selected, and the field is remapped onto the model mesh
(2nd-order conservative for x/y grids and meshes, bilinear for lon/lat
grids), 3-D fields also in the vertical (zeta or ocean depth).

Host-side numpy throughout (set-up work): the readers go through io/ncio.py,
so NetCDF classic files need only scipy and NetCDF4 files need h5py.
"""

from __future__ import annotations

import numpy as np

from .ncio import NCFile, FIELD_ALIASES, find_field, resolve_field_name
from ..utils.logging_utils import warning


# ---------------------------------------------------------------------------
# Geometry readers (refgeo initialisation, the mesh built from a file)
# ---------------------------------------------------------------------------

def read_geometry_onto_mesh(C, region_name, mesh, which="init"):
    """(Hi, Hb, SL) from the configured geometry file, interpolated onto
    the mesh vertices (bilinear). The file's [y, x] or [x, y] orientation
    is told from the shape alone: a square grid reads as [x, y]."""
    fname = getattr(C, f"filename_refgeo_{which}_{region_name}")
    with NCFile(fname) as nc:
        x = find_field(nc, "x")
        y = find_field(nc, "y")
        Hi = find_field(nc, "Hi")
        Hb = find_field(nc, "Hb")
        SL = np.zeros_like(Hi) if not nc.has("SL") else nc.read("SL")
    if Hi.shape == (len(y), len(x)):
        Hi, Hb, SL = Hi.T, Hb.T, SL.T
    Hi_m = bilinear_sample(x, y, Hi, mesh.V)
    Hb_m = bilinear_sample(x, y, Hb, mesh.V)
    SL_m = bilinear_sample(x, y, SL, mesh.V)
    Hi_m = np.where(Hi_m < C.refgeo_Hi_min, 0.0, Hi_m)
    return Hi_m, Hb_m, SL_m


def bilinear_sample(x, y, F, points):
    """Bilinear interpolation of F[..., x, y] at points [n, 2]."""
    xi = np.clip(np.searchsorted(x, points[:, 0]) - 1, 0, len(x) - 2)
    yi = np.clip(np.searchsorted(y, points[:, 1]) - 1, 0, len(y) - 2)
    wx = np.clip((points[:, 0] - x[xi]) / (x[xi + 1] - x[xi]), 0, 1)
    wy = np.clip((points[:, 1] - y[yi]) / (y[yi + 1] - y[yi]), 0, 1)
    return (F[..., xi, yi] * (1 - wx) * (1 - wy)
            + F[..., xi + 1, yi] * wx * (1 - wy)
            + F[..., xi, yi + 1] * (1 - wx) * wy
            + F[..., xi + 1, yi + 1] * wx * wy)


def read_geometry_grid_raw(C, region_name, which="init"):
    """The gridded geometry (x, y, {Hi, Hb, SL}) without remapping, each
    field as [x, y] (the mesh built from a geometry file)."""
    fname = getattr(C, f"filename_refgeo_{which}_{region_name}")
    with NCFile(fname) as nc:
        x = find_field(nc, "x")
        y = find_field(nc, "y")
        fields = {}
        for name in ("Hi", "Hb", "SL"):
            if resolve_field_name(nc, name) is None:
                continue
            F = find_field(nc, name)
            if F.shape == (len(y), len(x)):
                F = F.T
            fields[name] = F
    return x, y, fields


# ---------------------------------------------------------------------------
# Layout detection, grid and mesh set-up from a file
# ---------------------------------------------------------------------------

def inquire_file_layout(nc: NCFile) -> str:
    """'xy' | 'lonlat' | 'mesh', from the coordinate variables the file
    holds (netcdf_determine_indexing.f90)."""
    if nc.has("V") and nc.has("Tri"):
        return "mesh"
    if resolve_field_name(nc, "x") and resolve_field_name(nc, "y"):
        return "xy"
    if resolve_field_name(nc, "lon") and resolve_field_name(nc, "lat"):
        return "lonlat"
    raise ValueError(f"cannot determine grid type of {nc.path}: "
                     "no x/y, lon/lat, or mesh variables found")


def setup_xy_grid_from_file(nc: NCFile):
    """(Grid with ascending axes, flip_x, flip_y) from the file's x/y."""
    from ..mesh.grids import Grid
    x = np.asarray(find_field(nc, "x"), dtype=np.float64)
    y = np.asarray(find_field(nc, "y"), dtype=np.float64)
    flip_x = len(x) > 1 and x[1] < x[0]
    flip_y = len(y) > 1 and y[1] < y[0]
    if flip_x:
        x = x[::-1].copy()
    if flip_y:
        y = y[::-1].copy()
    dx = float(x[1] - x[0]) if len(x) > 1 else 1.0
    dy = float(y[1] - y[0]) if len(y) > 1 else dx
    return Grid(x=x, y=y, dx=dx, dy=dy), flip_x, flip_y


def setup_lonlat_grid_from_file(nc: NCFile):
    """(GridLonLat, the longitude order after the 360-degree wrap,
    flip_lat)."""
    from ..mesh.grids import GridLonLat
    lon = np.asarray(find_field(nc, "lon"), dtype=np.float64) % 360.0
    lat = np.asarray(find_field(nc, "lat"), dtype=np.float64)
    flip_lat = len(lat) > 1 and lat[1] < lat[0]
    if flip_lat:
        lat = lat[::-1].copy()
    order = np.argsort(lon, kind="stable")
    return GridLonLat(lon=lon[order], lat=lat), order, flip_lat


def setup_mesh_from_file(path_or_nc):
    """A Mesh rebuilt from a mesh file's V/Tri (the port's, the JAX
    package's or the reference's, which is 1-based;
    netcdf_setup_grid_mesh_from_file.f90)."""
    from ..mesh.mesh_types import mesh_from_points
    own = not isinstance(path_or_nc, NCFile)
    nc = NCFile(path_or_nc) if own else path_or_nc
    V = np.asarray(nc.read("V"), dtype=np.float64)
    Tri = np.asarray(nc.read("Tri"))
    if V.shape[0] == 2 and V.shape[1] != 2:
        V = V.T
    if Tri.shape[0] == 3 and Tri.shape[1] != 3:
        Tri = Tri.T
    if Tri.min() >= 1:
        Tri = Tri - 1
    kw = {"nz": len(nc.read("zeta"))} if nc.has("zeta") else {}
    xmin, xmax = float(V[:, 0].min()), float(V[:, 0].max())
    ymin, ymax = float(V[:, 1].min()), float(V[:, 1].max())
    return mesh_from_points(V, xmin, xmax, ymin, ymax,
                            Tri=np.asarray(Tri, dtype=np.int64), **kw)


def find_timeframe(nc: NCFile, time_to_read: float) -> int:
    """Index of the timeframe closest to time_to_read (netcdf_basic
    find_timeframe); a time outside the file's range warns."""
    t = np.asarray(find_field(nc, "time"), dtype=np.float64)
    ti = int(np.argmin(np.abs(t - time_to_read)))
    if abs(t[ti] - time_to_read) > 1e-9 * max(1.0, abs(time_to_read)) \
            and (time_to_read < t.min() - 1e-9 or
                 time_to_read > t.max() + 1e-9):
        warning(f"requested time {time_to_read} outside file range "
                f"[{t.min()}, {t.max()}] of {nc.path}; using nearest frame")
    return ti


# ---------------------------------------------------------------------------
# Raw field reading with indexing normalisation
# ---------------------------------------------------------------------------

_CANON_AXES = ("time", "x", "y", "lon", "lat", "zeta", "depth", "month")


def _read_raw(nc: NCFile, field_name: str, layout: str, ndims: str,
              time_to_read):
    """Read and orientation-normalise a field.

    Returns (data, extra_axis): data is [n_extra?, d1, d2] for grids
    ([x, y] or [lon, lat] order, ascending axes as stored) or
    [n_extra?, nV] for meshes; extra_axis is the zeta/depth/month vector
    (None for 2-D fields).
    """
    name = resolve_field_name(nc, field_name)
    if name is None:
        raise KeyError(f"no variable matching '{field_name}' in {nc.path}")
    data = nc.read(name)
    dims = nc.dim_names(name)
    nd = len(dims)

    # classify each axis by its dimension name; else by its size
    axis_kind = [""] * nd
    sizes = {}
    for canon in ("x", "y", "lon", "lat", "zeta", "depth", "month", "time"):
        n = resolve_field_name(nc, canon)
        if n is not None:
            sizes[canon] = len(nc.read(n))
    for i, d in enumerate(dims):
        for canon in _CANON_AXES:
            if d in FIELD_ALIASES.get(canon, [canon]):
                axis_kind[i] = canon
                break
        if not axis_kind[i] and d == "vi":
            axis_kind[i] = "mesh"
    for i in range(nd):
        if not axis_kind[i]:
            cands = [k for k, v in sizes.items()
                     if v == data.shape[i] and k not in axis_kind]
            axis_kind[i] = cands[0] if cands else ""

    # the timeframe
    if "time" in axis_kind:
        ti = 0 if time_to_read is None else find_timeframe(nc, time_to_read)
        ax = axis_kind.index("time")
        data = np.take(data, ti, axis=ax)
        axis_kind.pop(ax)
    elif time_to_read is not None:
        warning(f"'{field_name}' in {nc.path} has no time dimension; "
                "ignoring time_to_read")

    # the extra (vertical or monthly) axis goes first
    extra = None
    extra_kind = {"3D": "zeta", "3D_ocean": "depth",
                  "2D_monthly": "month"}.get(ndims)
    if extra_kind is not None:
        if extra_kind not in axis_kind:
            raise ValueError(f"'{field_name}' in {nc.path}: expected a "
                             f"{extra_kind} dimension for ndims={ndims}")
        ax = axis_kind.index(extra_kind)
        data = np.moveaxis(data, ax, 0)
        axis_kind.insert(0, axis_kind.pop(ax))
        n = resolve_field_name(nc, extra_kind)
        extra = (np.asarray(nc.read(n), dtype=np.float64)
                 if n is not None else np.arange(data.shape[0]) + 1.0)

    # the horizontal axes in [d1, d2] order
    off = 1 if extra is not None else 0
    if layout == "mesh":
        return data, extra
    d1, d2 = ("x", "y") if layout == "xy" else ("lon", "lat")
    sk = axis_kind[off:]
    if sk == [d2, d1]:
        data = np.swapaxes(data, off, off + 1)
    elif sk != [d1, d2]:
        # ambiguous (a square grid with unnamed dims): read as [d1, d2]
        if data.shape[off] != sizes.get(d1):
            data = np.swapaxes(data, off, off + 1)
    return data, extra


# ---------------------------------------------------------------------------
# Read and remap
# ---------------------------------------------------------------------------

def _remap_to_mesh(nc, layout, data, mesh, method):
    """Spatially normalised data ([..., d1, d2] or [..., nV_src]) onto the
    model mesh's vertices -> [..., nV]."""
    from ..remap.atlas import get_map

    if layout == "xy":
        grid, flip_x, flip_y = setup_xy_grid_from_file(nc)
        if flip_x:
            data = data[..., ::-1, :]
        if flip_y:
            data = data[..., :, ::-1]
        if method in (None, "2nd_order_conservative"):
            M = get_map(grid, mesh, "2nd_order_conservative")
            flat = data.reshape(-1, grid.n)    # [extra, nx*ny], x major
            out = (M @ flat.T).T
            return out.reshape(data.shape[:-2] + (mesh.nV,))
        return bilinear_sample(grid.x, grid.y, data, mesh.V)

    if layout == "lonlat":
        grid, order, flip_lat = setup_lonlat_grid_from_file(nc)
        if flip_lat:
            data = data[..., :, ::-1]
        data = data[..., order, :]
        if mesh.lon is None:
            raise ValueError("mesh has no lon/lat secondary data; set the "
                             "region projection (set_mesh_lonlat) before "
                             "reading lon/lat input")
        idx, w = grid.bilinear_weights(mesh.lon, mesh.lat)
        flat = data.reshape(-1, grid.n)
        return (flat[:, idx] * w).sum(axis=-1).reshape(
            data.shape[:-2] + (mesh.nV,))

    src_mesh = setup_mesh_from_file(nc)
    M = get_map(src_mesh, mesh, method or "2nd_order_conservative")
    flat = data.reshape(-1, src_mesh.nV)
    return (M @ flat.T).T.reshape(data.shape[:-1] + (mesh.nV,))


def read_field_from_file_2D(filename, field_name, mesh, time_to_read=None,
                            method=None):
    """[nV]: a 2-D field from any supported file on the mesh's vertices
    (read_and_remap_field_from_file.f90 read_field_from_file_2D)."""
    with NCFile(filename) as nc:
        layout = inquire_file_layout(nc)
        data, _ = _read_raw(nc, field_name, layout, "2D", time_to_read)
        return _remap_to_mesh(nc, layout, data, mesh, method)


def read_field_from_file_2D_monthly(filename, field_name, mesh,
                                    time_to_read=None, method=None):
    """[nV, 12]: a monthly field (read_field_from_file_2D_monthly)."""
    with NCFile(filename) as nc:
        layout = inquire_file_layout(nc)
        data, _ = _read_raw(nc, field_name, layout, "2D_monthly",
                            time_to_read)
        if data.shape[0] != 12:
            raise ValueError(f"'{field_name}' in {filename}: expected 12 "
                             f"months, got {data.shape[0]}")
        return _remap_to_mesh(nc, layout, data, mesh, method).T


def read_field_from_file_3D(filename, field_name, mesh, time_to_read=None,
                            method=None):
    """[nV, nz]: a zeta-dimensioned field, remapped in the vertical onto
    the model's zeta grid (read_field_from_file_3D)."""
    from ..remap.conservative import remap_vertical_1d
    with NCFile(filename) as nc:
        layout = inquire_file_layout(nc)
        data, zeta_src = _read_raw(nc, field_name, layout, "3D",
                                   time_to_read)
        on_mesh = _remap_to_mesh(nc, layout, data, mesh, method)
    if len(zeta_src) == mesh.nz and np.allclose(zeta_src, mesh.zeta):
        return on_mesh.T
    return remap_vertical_1d(zeta_src, mesh.zeta, on_mesh.T)


def read_field_from_file_3D_ocean(filename, field_name, mesh, z_ocean,
                                  time_to_read=None, method=None):
    """[nV, nz_ocean]: a depth-dimensioned ocean field, remapped in the
    vertical onto z_ocean; depths without source data are masked out of
    the vertical remap (read_field_from_file_3D_ocean)."""
    from ..remap.conservative import remap_vertical_1d
    with NCFile(filename) as nc:
        layout = inquire_file_layout(nc)
        data, depth_src = _read_raw(nc, field_name, layout, "3D_ocean",
                                    time_to_read)
        nan_cols = np.isnan(data).all(axis=tuple(range(1, data.ndim)))
        data = np.nan_to_num(data, nan=0.0)
        on_mesh = _remap_to_mesh(nc, layout, data, mesh, method)
    if len(depth_src) == len(z_ocean) and np.allclose(depth_src, z_ocean):
        return on_mesh.T
    return remap_vertical_1d(depth_src, z_ocean, on_mesh.T,
                             mask_src=(~nan_cols).astype(int))


def read_field_from_file_0D(filename, field_name, time_to_read=None):
    """A scalar, linearly interpolated in time where the file holds a
    series (netcdf_read_field_from_series_file.f90)."""
    with NCFile(filename) as nc:
        data = np.asarray(find_field(nc, field_name), dtype=np.float64)
        if data.ndim == 0 or len(data) == 1:
            return float(data.reshape(-1)[0])
        t = np.asarray(find_field(nc, "time"), dtype=np.float64)
    if time_to_read is None:
        return float(data[0])
    return float(np.interp(time_to_read, t, data))


def read_series_from_file(filename, field_name):
    """(time, values) arrays of a series file."""
    with NCFile(filename) as nc:
        t = np.asarray(find_field(nc, "time"), dtype=np.float64)
        d = np.asarray(find_field(nc, field_name), dtype=np.float64)
    return t, d


def load_timeframe_series(filename, field_name, mesh, reader="2D",
                          z_ocean=None, t_window=None):
    """All timeframes of a field as (times [nt], frames [nt, ...]), held on
    the device for interpolation in time (the reference re-reads a
    two-frame window, ocean_snapshot_plus_anomalies.f90:125-180).

    reader: '2D' | '2D_monthly' | '3D_ocean'. t_window restricts the
    frames to those covering [t0, t1] (one more on either side).
    """
    with NCFile(filename) as nc:
        t_all = np.asarray(find_field(nc, "time"), dtype=np.float64)
    idx = np.arange(len(t_all))
    if t_window is not None:
        i0 = max(0, int(np.searchsorted(t_all, t_window[0])) - 1)
        i1 = min(len(t_all), int(np.searchsorted(t_all, t_window[1])) + 2)
        idx = idx[i0:i1]
    read = {"2D": read_field_from_file_2D,
            "2D_monthly": read_field_from_file_2D_monthly,
            "3D_ocean": lambda f, n, m, time_to_read=None:
                read_field_from_file_3D_ocean(f, n, m, z_ocean,
                                              time_to_read=time_to_read),
            }[reader]
    frames = [read(filename, field_name, mesh, time_to_read=float(t_all[i]))
              for i in idx]
    return t_all[idx], np.stack(frames)
