"""Minimal NetCDF file I/O: classic (64-bit offset) files through scipy.

Re-design of the reference's NetCDF-Fortran layer
(src/UPSY/io/netcdf_basic/). The port writes NetCDF classic files with
64-bit offsets through `scipy.io.netcdf_file`, which exists wherever the
port runs; netCDF4-python, xarray and MATLAB's ncread open them. It reads
classic files the same way, and NetCDF4 (HDF5) files, such as the JAX
package's, through h5py, imported only for such a file.

Write API (the JAX package's `ufemism2_tpu/io/ncio.py` subset):

    with NCFile(path, "w") as nc:
        nc.def_dim("vi", nV)
        nc.def_dim("time", None)         # the one unlimited dimension
        nc.def_var("Hi", ("time", "vi"), units="m")
        nc.append("Hi", Hi, coord=t)     # grows the unlimited 'time'

A written file is held in memory and goes to disk whole at every
`flush()` (and at `close()`): into `<path>.tmp`, which is then renamed
into place, so the file on disk is always complete and a torn write
leaves the previous version readable.

Classic NetCDF has no int64 and no bool: bools are stored as int8,
integer data and integer attributes as int32, and an integer that does
not fit int32 raises.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_CLASSIC_MAGIC = (b"CDF\x01", b"CDF\x02")
_I32 = np.iinfo(np.int32)


class _ClassicWriter(netcdf_file):
    """scipy's writer, with its variable order repaired: scipy sorts the
    variables by shape in reverse and so writes a 0-d variable after the
    record variables, where its data lands inside the record section and
    overwrites records. Here the fixed-size variables come first, in the
    order of definition, then the record variables."""

    def _write_var_array(self):
        if not self.variables:
            return super()._write_var_array()
        self.fp.write(b"\x00\x00\x00\x0b")          # NC_VARIABLE
        self._pack_int(len(self.variables))
        names = sorted(self.variables,
                       key=lambda n: self.variables[n].isrec)
        for name in names:
            self._write_var_metadata(name)
        self.__dict__["_recsize"] = sum(
            v._vsize for v in self.variables.values() if v.isrec)
        for name in names:
            self._write_var_data(name)


def to_classic(a, what="data"):
    """`a` as a numpy value of a type classic NetCDF stores: bool -> int8,
    any integer -> int32 (raising where a value does not fit), floats
    keep their width."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a.astype(np.int8)
    if np.issubdtype(a.dtype, np.integer) and a.dtype not in (np.int8,
                                                              np.int16,
                                                              np.int32):
        if a.size and (a.min() < _I32.min or a.max() > _I32.max):
            raise OverflowError(f"{what}: integer value out of int32 range, "
                                "which classic NetCDF cannot store")
        return a.astype(np.int32)
    if a.dtype == np.float16:
        return a.astype(np.float32)
    return a


def _attr_value(v, what):
    if isinstance(v, (str, bytes)):
        return v
    if isinstance(v, bool):
        return np.int8(v)
    if isinstance(v, int):
        return to_classic(np.int64(v), what)
    if isinstance(v, float):
        return np.float64(v)
    return to_classic(v, what)


class _Var:
    __slots__ = ("dims", "data", "attrs", "dtype", "records")

    def __init__(self, dims, dtype, attrs):
        self.dims = tuple(dims)
        self.dtype = np.dtype(dtype)
        self.attrs = dict(attrs)
        self.data = None        # fixed-size variables
        self.records = []       # record variables: one array a record


class NCFile:
    """A NetCDF file opened for reading ("r") or writing ("w")."""

    def __init__(self, path, mode="r"):
        self.path = str(path)
        self.mode = mode
        self._dims: dict[str, int | None] = {}
        self._vars: dict[str, _Var] = {}
        self._gattrs: dict = {}
        self._scales: dict = {}     # an HDF5 file's dimension-scale data
        if mode == "r":
            with open(self.path, "rb") as f:
                magic = f.read(8)
            if magic[:4] in _CLASSIC_MAGIC:
                self._read_classic()
            elif magic == _HDF5_MAGIC:
                self._read_hdf5()
            else:
                raise ValueError(f"{self.path}: not a NetCDF file")
        elif mode != "w":
            raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")

    # -- write side ---------------------------------------------------------

    def _writable(self):
        if self.mode != "w":
            raise OSError(f"{self.path} is open for reading")

    @property
    def _record_dim(self):
        return next((d for d, n in self._dims.items() if n is None), None)

    def def_dim(self, name: str, size: int | None = None):
        """Define a dimension; size None = unlimited (at most one)."""
        self._writable()
        if name in self._dims:
            return
        if size is None and self._record_dim is not None:
            raise ValueError(f"{self.path}: classic NetCDF has one unlimited "
                             f"dimension ({self._record_dim!r} already)")
        self._dims[name] = None if size is None else int(size)

    def def_var(self, name: str, dims: tuple, dtype="f8", **attrs):
        self._writable()
        if name in self._vars:
            return self._vars[name]
        for d in dims:
            if d not in self._dims:
                raise KeyError(f"{name}: undefined dimension {d!r}")
        if self._record_dim in dims[1:]:
            raise ValueError(f"{name}: the unlimited dimension must come "
                             "first")
        dtype = to_classic(np.zeros(0, dtype)).dtype
        v = self._vars[name] = _Var(dims, dtype, {
            k: _attr_value(a, f"{name}:{k}") for k, a in attrs.items()})
        return v

    def put(self, name: str, data, **attrs):
        """Write a whole fixed-size variable (def_var'd first)."""
        self._writable()
        v = self._vars[name]
        data = to_classic(data, name)
        shape = tuple(self._dims[d] for d in v.dims)
        if data.shape != shape:
            raise ValueError(f"{name}: shape {data.shape} != {shape}")
        v.data = data.astype(v.dtype)
        v.attrs.update({k: _attr_value(a, f"{name}:{k}")
                        for k, a in attrs.items()})

    def append(self, name: str, data, coord=None, coord_name="time"):
        """Append one record along the variable's unlimited dimension;
        `coord`, when given, is appended to `coord_name` too."""
        self._writable()
        v = self._vars[name]
        if not v.dims or v.dims[0] != self._record_dim:
            raise ValueError(f"{name} is not a record variable")
        data = to_classic(data, name)
        shape = tuple(self._dims[d] for d in v.dims[1:])
        if data.shape != shape:
            raise ValueError(f"{name}: record shape {data.shape} != {shape}")
        v.records.append(data.astype(v.dtype))
        if coord is not None:
            self.append(coord_name, np.asarray(coord, np.float64))

    def set_global_attrs(self, **attrs):
        self._writable()
        self._gattrs.update({k: _attr_value(a, k) for k, a in attrs.items()})

    def flush(self):
        """Write the whole file to <path>.tmp and rename it into place."""
        self._writable()
        n_rec = max((len(v.records) for v in self._vars.values()), default=0)
        tmp = self.path + ".tmp"
        f = _ClassicWriter(tmp, "w", version=2, maskandscale=False)
        try:
            # scipy wants the unlimited dimension first
            for d, n in sorted(self._dims.items(),
                               key=lambda dn: dn[1] is not None):
                f.createDimension(d, n)
            for k, a in self._gattrs.items():
                setattr(f, k, a)
            for name, v in self._vars.items():
                var = f.createVariable(name, v.dtype, v.dims)
                for k, a in v.attrs.items():
                    setattr(var, k, a)
                if v.dims and v.dims[0] == self._record_dim:
                    if n_rec:
                        var[:] = self._stacked(v, n_rec)
                elif v.data is not None:
                    var[...] = v.data
        finally:
            f.close()
        os.replace(tmp, self.path)

    @staticmethod
    def _stacked(v, n_rec):
        """The records as one array, padded to n_rec records (NaN for
        floats, 0 for integers) where a variable missed an output."""
        out = np.zeros((n_rec,) + (v.records[0].shape if v.records
                                   else ()), v.dtype)
        if out.dtype.kind == "f":
            out[...] = np.nan
        for i, r in enumerate(v.records):
            out[i] = r
        return out

    # -- read side ----------------------------------------------------------

    def _read_classic(self):
        f = netcdf_file(self.path, "r", mmap=False, maskandscale=False)
        try:
            n_rec = f._recs
            for d, n in f.dimensions.items():
                self._dims[d] = n_rec if n is None else int(n)
            self._gattrs = {k: _decoded(a)
                            for k, a in f._attributes.items()}
            for name, var in f.variables.items():
                v = _Var(var.dimensions, var.data.dtype.newbyteorder("="),
                         {k: _decoded(a) for k, a in var._attributes.items()})
                v.data = np.array(var.data, dtype=v.dtype)
                self._vars[name] = v
        finally:
            f.close()

    def _read_hdf5(self):
        """A NetCDF4 (HDF5) file, read whole through h5py: datasets that
        are HDF5 dimension scales are dimensions, the other datasets are
        the variables (as the JAX package's reader has them; a scale's
        data, such as a coordinate's values, stays readable by `read`); a
        variable's dimensions come from the JAX package's '_dims'
        attribute or from its dimension-scale list."""
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{self.path} is a NetCDF4 (HDF5) file; reading it needs "
                "the h5py module, which is not installed here. Read the "
                "file's classic copy instead (NetCDF classic files need "
                "only scipy).") from e
        with h5py.File(self.path, "r") as h5:
            self._gattrs = {k: _decoded(a) for k, a in h5.attrs.items()}
            for name, ds in h5.items():
                if not isinstance(ds, h5py.Dataset):
                    continue
                if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                    self._dims[name] = int(ds.shape[0])
                    self._scales[name] = ds[...]
                    continue
                attrs = {k: _decoded(a) for k, a in ds.attrs.items()
                         if k not in ("_dims", "DIMENSION_LIST",
                                      "REFERENCE_LIST")}
                v = _Var(_hdf5_dims(name, ds), ds.dtype, attrs)
                v.data = ds[...]
                self._vars[name] = v
            for v in self._vars.values():
                for d, n in zip(v.dims, v.data.shape):
                    self._dims.setdefault(d, int(n))

    def read(self, name: str) -> np.ndarray:
        if name not in self._vars and name in self._scales:
            return np.array(self._scales[name])
        v = self._vars[name]
        if self.mode == "w" and v.dims and v.dims[0] == self._record_dim:
            return self._stacked(v, len(v.records))
        return np.array(v.data)

    def variables(self) -> list:
        return list(self._vars)

    def has(self, name) -> bool:
        return name in self._vars or name in self._scales

    def dim_names(self, name: str) -> list:
        return list(self._vars[name].dims)

    def dims(self) -> dict:
        """All dimension names -> sizes (an unlimited dimension's current
        number of records)."""
        return {d: (n if n is not None else max(
            (len(v.records) for v in self._vars.values()), default=0))
            for d, n in self._dims.items()}

    def attrs(self, name: str) -> dict:
        return dict(self._vars[name].attrs)

    def global_attrs(self) -> dict:
        return dict(self._gattrs)

    def close(self):
        if self.mode == "w":
            self.flush()
            self.mode = "closed"

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        else:               # nothing half-built goes to disk
            self.mode = "closed"


def _decoded(a):
    if isinstance(a, (bytes, np.bytes_)):
        return bytes(a).decode()
    if isinstance(a, np.ndarray) and a.shape == (1,):
        return a[0]
    return a


def _hdf5_dims(name, ds):
    raw = ds.attrs.get("_dims")
    if raw is not None:
        raw = raw.decode() if isinstance(raw, bytes) else str(raw)
        if raw:
            return tuple(raw.split(","))
        if ds.ndim == 0:
            return ()
    dims = []
    for i in range(ds.ndim):
        scales = [s.name.lstrip("/") for s in ds.dims[i]
                  if s.name is not None]
        dims.append(scales[0] if scales else None)
    if ds.ndim == 1 and dims[0] is None:
        dims[0] = name      # a bare 1-D dataset is its own coordinate
    return tuple(d if d is not None else f"phony_dim_{ds.shape[i]}"
                 for i, d in enumerate(dims))


# -- field-name aliases -------------------------------------------------------
# The reference's accepted input spellings (netcdf_field_name_options.f90:
# 83-150, '||'-separated options), so the same input files load in the port
# and in the reference.

FIELD_ALIASES = {
    "x": ["x", "X", "x1", "X1", "nx", "NX", "x-coordinate", "X-coordinate",
          "easting", "Easting"],
    "y": ["y", "Y", "y1", "Y1", "ny", "NY", "y-coordinate", "Y-coordinate",
          "northing", "Northing"],
    "zeta": ["zeta", "Zeta"],
    "lon": ["lon", "Lon", "long", "Long", "longitude", "Longitude"],
    "lat": ["lat", "Lat", "latitude", "Latitude"],
    "time": ["time", "Time", "t", "nt"],
    "month": ["month", "Month"],
    "depth": ["depth", "Depth"],
    "Hi": ["Hi", "thickness", "lithk", "ice_thickness"],
    "Hb": ["Hb", "bed", "topg", "bed_topography"],
    "Hs": ["Hs", "surface", "orog", "surface_topography"],
    "SL": ["SL", "sealevel"],
    "dHdt": ["dHdt", "dHi_dt"],
    "hflux": ["hflux", "GHF", "ghf", "geothermal_heat_flux"],
    "dHb": ["dHb"],
    "Ti": ["Ti"],
    "T_ocean": ["T_ocean", "t_ocean", "t_an", "votemper"],
    "S_ocean": ["S_ocean", "s_ocean", "s_an", "vosaline"],
    "dT_ocean": ["dT", "dT_ocean", "dTo"],
    "dT_atmosphere": ["dT", "dT_atmosphere", "dT_atm", "dTa"],
    "insolation": ["Q_TOA"],
    "sealevel": ["SL", "sea_level", "sl"],
    "GI": ["GI", "gi", "Glacial_Index", "glacial_index", "GlacialIndex"],
    "CO2": ["CO2", "co2"],
    "T2m": ["T2m", "T_2m", "Temp", "temp", "temperature", "tas"],
    "Precip": ["Precip", "precip", "precipitation", "pr"],
    "SMB": ["SMB", "smb", "acab"],
    "BMB": ["BMB", "bmb", "libmassbf"],
}


def resolve_field_name(nc: NCFile, canonical: str):
    """The name under which a canonical field appears in the file, or None.
    `canonical` may itself be a '||'-separated list of acceptable names
    (the reference passes such strings straight through)."""
    if "||" in canonical:
        options = canonical.split("||")
    else:
        options = FIELD_ALIASES.get(canonical, [canonical])
    return next((a for a in options if nc.has(a)), None)


def find_field(nc: NCFile, canonical: str):
    """A field's data, found through its accepted aliases."""
    name = resolve_field_name(nc, canonical)
    if name is None:
        raise KeyError(f"no variable matching '{canonical}' in {nc.path}")
    return nc.read(name)
