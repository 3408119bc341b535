"""Regional output files: main mesh output, scalar time series, restart.

Re-design of src/UFEMISM/io/main_regional_output/ (mesh_output_files.f90,
scalar_output_files.f90): NetCDF classic files (io/ncio.py) with the
reference's variable names, so the reference's MATLAB/python analysis
scripts (read_stability_info.m, compare_all_netcdfs_in_test_folder.py)
work on the port's outputs directly. Every file is rewritten whole and
renamed into place at each write, so a file on disk is always complete.
"""

from __future__ import annotations


import numpy as np

from .ncio import NCFile


# reference-named fields that live on the triangle (b) grid without the
# _b suffix (the reference stores all velocities on triangles)
B_GRID_FIELDS = {"u_surf", "v_surf", "uabs_surf",
                 "u_base", "v_base", "uabs_base",
                 "u_vav", "v_vav", "uabs_vav",
                 "u_3D", "v_3D", "Hs_b"}

# 3-D (x zeta) output fields (netcdf_write_field_mesh.f90 *_3D writers)
FIELDS_3D = {"u_3D", "v_3D", "w_3D"}

# polyline variables, written as NaN-padded (ei, two) Matlab-contour
# arrays into MESH files only (grid_output_files.f90:361-371 "Do
# nothing; only written to mesh files")
LINE_FIELDS = {"grounding_line", "ice_margin", "calving_front",
               "coastline", "grounded_ice_contour"}


def _is_b_grid(name):
    return name.endswith("_b") or name in B_GRID_FIELDS


MESH_FIELDS_DEFAULT = ["Hi", "Hb", "Hs", "Hib", "SL", "dHi_dt",
                       "u_vav_b", "v_vav_b", "uabs_vav_b", "divQ",
                       "fraction_gr", "Ti_base",
                       # reference-compatible surface-velocity names
                       # (main_regional_output.f90 default set; vertex
                       # staggering here vs the reference's triangles)
                       "u_surf", "v_surf", "uabs_surf"]


def setup_mesh_in_file(nc: NCFile, mesh):
    """Write the complete mesh description under the reference's names
    (netcdf_setup_grid_mesh_in_file.f90 setup_mesh_in_netcdf_file): the
    primary/secondary arrays, border indices, and the explicit Voronoi
    tessellation, so the reference's read_mesh_from_file/plot_mesh
    tooling consumes our files directly. Index arrays are converted to
    the reference's 1-based, 0=none convention."""
    from ..mesh.voronoi_mesh import (construct_voronoi_mesh, calc_EBI,
                                     calc_TriBI, calc_EA)

    EBI = calc_EBI(mesh)
    vor = construct_voronoi_mesh(mesh, EBI=EBI)

    nc.def_dim("vi", mesh.nV)
    nc.def_dim("ti", mesh.nTri)
    nc.def_dim("ci", mesh.nC_mem)
    nc.def_dim("ei", mesh.nE)
    nc.def_dim("vori", vor["nVor"])
    nc.def_dim("two", 2)
    nc.def_dim("three", 3)
    nc.def_dim("four", 4)
    nc.def_dim("ci_vor", vor["VVor"].shape[1])
    nc.def_dim("zeta", mesh.nz)

    def put(name, dims, data, **attrs):
        nc.def_var(name, dims, **attrs)
        nc.put(name, np.asarray(data))

    def put_idx(name, dims, data):
        # 1-based indices, 0 = none (reference convention)
        put(name, dims, np.asarray(data, dtype=np.float64) + 1)

    # domain + projection scalars
    for k in ("xmin", "xmax", "ymin", "ymax"):
        put(k, (), getattr(mesh, k), units="m")
    put("tol_dist", (), 1e-9 * max(mesh.xmax - mesh.xmin,
                                   mesh.ymax - mesh.ymin), units="m")
    if mesh.proj is not None:
        lam, phi, beta = mesh.proj
        put("lambda_M", (), lam, units="degrees_east")
        put("phi_M", (), phi, units="degrees_north")
        put("beta_stereo", (), beta, units="degrees")

    # primary
    put("V", ("vi", "two"), mesh.V, units="m")
    put("nC", ("vi",), mesh.nC)
    put_idx("C", ("vi", "ci"), mesh.C)
    put("niTri", ("vi",), mesh.niTri)
    put_idx("iTri", ("vi", "ci"), mesh.iTri)
    put("VBI", ("vi",), mesh.VBI)
    put_idx("Tri", ("ti", "three"), mesh.Tri)
    put("Tricc", ("ti", "two"), mesh.Tricc, units="m")
    put_idx("TriC", ("ti", "three"), mesh.TriC)

    # secondary
    put("TriBI", ("ti",), calc_TriBI(mesh))
    put("TriGC", ("ti", "two"), mesh.TriGC, units="m")
    put("TriA", ("ti",), mesh.TriA, units="m^2")
    put("A", ("vi",), mesh.A, units="m^2")
    put("R", ("vi",), mesh.R, units="m")
    if mesh.lon is not None:
        put("lon", ("vi",), mesh.lon, units="degrees_east")
        put("lat", ("vi",), mesh.lat, units="degrees_north")

    # edges: the reference's EV is [nE,4] = (vi, vj, vil, vir)
    vil = _edge_flank_vertices(mesh, side=0)
    vir = _edge_flank_vertices(mesh, side=1)
    put_idx("EV", ("ei", "four"),
            np.column_stack([mesh.EV, vil, vir]))
    put_idx("ETri", ("ei", "two"), mesh.ETri)
    put("E", ("ei", "two"), mesh.E, units="m")
    put_idx("VE", ("vi", "ci"), mesh.VE)
    put_idx("TriE", ("ti", "three"), mesh.TriE)
    put("EBI", ("ei",), EBI)
    put("EA", ("ei",), calc_EA(mesh), units="m^2")

    # Voronoi mirror
    put_idx("vi2vori", ("vi",), vor["vi2vori"])
    put_idx("ti2vori", ("ti",), vor["ti2vori"])
    put_idx("ei2vori", ("ei",), vor["ei2vori"])
    put_idx("vori2vi", ("vori",), vor["vori2vi"])
    put_idx("vori2ti", ("vori",), vor["vori2ti"])
    put_idx("vori2ei", ("vori",), vor["vori2ei"])
    put("Vor", ("vori", "two"), vor["Vor"], units="m")
    put("VornC", ("vori",), vor["VornC"])
    put_idx("VorC", ("vori", "three"), vor["VorC"])
    put("nVVor", ("vi",), vor["nVVor"])
    put_idx("VVor", ("vi", "ci_vor"), vor["VVor"])

    put("zeta", ("zeta",), mesh.zeta)


def _edge_flank_vertices(mesh, side):
    """Third vertex of the triangle on `side` of each edge (-1 if none):
    the vil/vir columns of the reference's 4-wide EV."""
    t = mesh.ETri[:, side]
    ok = t >= 0
    tri = mesh.Tri[np.maximum(t, 0)]                  # [nE,3]
    is_end = ((tri == mesh.EV[:, 0:1]) | (tri == mesh.EV[:, 1:2]))
    # exactly one corner of the flanking triangle is not an edge endpoint
    flank = tri[np.arange(len(tri)), np.argmin(is_end, axis=1)]
    return np.where(ok, flank, -1)


class MeshOutputFile:
    """Time-series output of mesh fields (main_output_ANT_00001.nc style)."""

    def __init__(self, path, mesh, fields=MESH_FIELDS_DEFAULT):
        self.nc = NCFile(path, "w")
        self.fields = fields
        setup_mesh_in_file(self.nc, mesh)
        self.nc.def_dim("time", None)
        self.nc.def_var("time", ("time",), units="years")
        for f in fields:
            if f in LINE_FIELDS:
                self.nc.def_var(f, ("time", "ei", "two"), units="m",
                                format="Matlab contour format")
                continue
            grid = "ti" if _is_b_grid(f) else "vi"
            dims = ("time", grid, "zeta") if f in FIELDS_3D \
                else ("time", grid)
            self.nc.def_var(f, dims)

    def write(self, time, state_fields: dict):
        first = True
        for f in self.fields:
            if f not in state_fields:
                continue
            self.nc.append(f, np.asarray(state_fields[f]),
                           coord=time if first else None)
            first = False
        self.nc.flush()

    def close(self):
        self.nc.close()


SCALAR_FIELDS = ["ice_area", "ice_volume", "ice_volume_af",
                 "SMB_total", "SMB_gr", "SMB_fl", "SMB_land", "SMB_ocean",
                 "BMB_total", "BMB_gr", "BMB_fl",
                 "LMB_total", "LMB_gr", "LMB_fl", "AMB_total",
                 "gl_flux", "cf_gr_flux", "cf_fl_flux",
                 "margin_land_flux", "margin_ocean_flux", "dV_dt",
                 "dt_ice", "n_visc_its", "n_Axb_its"]


class ScalarOutputFile:
    """Buffered scalar time series (scalar_output_ANT_00001.nc)."""

    def __init__(self, path, fields=None):
        self.fields = fields or SCALAR_FIELDS
        self.nc = NCFile(path, "w")
        self.nc.def_dim("time", None)
        self.nc.def_var("time", ("time",), units="years")
        for f in self.fields:
            self.nc.def_var(f, ("time",))

    def write(self, time, scalars: dict):
        first = True
        for f in self.fields:
            if f not in scalars:
                continue
            self.nc.append(f, float(scalars[f]),
                           coord=time if first else None)
            first = False
        self.nc.flush()

    def close(self):
        self.nc.close()


def _state_leaves(state):
    """Flat {name: array} view of the IceState pytree (pc.* prefixed),
    the generic restart/remap field walk (the reference's per-component
    write_to_restart_file set, predictor_corrector_scheme.f90:510-620)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"pc.{g.name}"] = getattr(v, g.name)
        else:
            out[f.name] = v
    return out


def _dims_for(arr, mesh):
    lead = {mesh.nV: "vi", mesh.nTri: "ti", mesh.nE: "ei"}
    if arr.ndim == 0:
        return ()
    d0 = lead.get(arr.shape[0])
    if d0 is None:
        raise ValueError(f"cannot map shape {arr.shape} to mesh dims")
    if arr.ndim == 1:
        return (d0,)
    if arr.shape[1] == mesh.nz:
        return (d0, "zeta")
    if arr.shape[1] == 12:
        return (d0, "month")
    raise ValueError(f"cannot map shape {arr.shape} to mesh dims")


def write_restart_file(path, mesh, state, time, host_counters=None):
    """Full-state restart: every IceState field (incl. the pc controller
    state, so the adaptive dt resumes exactly -
    predictor_corrector_scheme.f90:417-444) on the current mesh, read
    from the device in one transfer. `host_counters` (e.g. n_dt_ice) are
    host-side stability counters the reference also persists
    (predictor_corrector_scheme.f90:510-620); stored as `host_*` global
    attributes (int32 in a classic file).

    Written atomically (io/ncio.py: tmp + rename): a torn restart is
    unreadable, and would silently restart a long spin-up from t = 0."""
    from ..core.fields import host_arrays
    leaves = host_arrays(_state_leaves(state))
    with NCFile(path, "w") as nc:
        setup_mesh_in_file(nc, mesh)
        nc.def_dim("month", 12)
        nc.def_dim("time", None)
        nc.def_var("time", ("time",), units="years")
        for name, arr in leaves.items():
            key = name.replace(".", "_")
            nc.def_var(key, _dims_for(arr, mesh), dtype=arr.dtype)
            nc.put(key, arr)
        nc.append("time", float(time))
        nc.set_global_attrs(restart_time=float(time), nV=mesh.nV,
                            nTri=mesh.nTri)
        if host_counters:
            nc.set_global_attrs(**{f"host_{k}": v
                                   for k, v in host_counters.items()})


def load_restart_host_counters(path):
    """{name: value} of the host-side counters persisted by
    write_restart_file (empty for restarts written before the scheme)."""
    with NCFile(path) as nc:
        return {k[len("host_"):]: v.item() if hasattr(v, "item") else v
                for k, v in nc.global_attrs().items()
                if k.startswith("host_")}


def load_restart_file(path):
    """(time, {field: np.ndarray}) from a restart file written by
    write_restart_file (the port's classic file or the JAX package's
    NetCDF4 one); 'pc_*' keys hold the pc-controller state."""
    with NCFile(path) as nc:
        time = float(np.asarray(nc.read("time")).reshape(-1)[0])
        skip = {"V", "Tri", "TriGC", "A", "R", "zeta", "time", "time_r"}
        dims = nc.dims()
        fields = {k: nc.read(k) for k in nc.variables()
                  if k not in skip and k not in dims}
    return time, fields


def restore_state_from_restart(state, path):
    """IceState with every field (incl. pc controller) replaced from a
    restart file, on the state's device and in each field's dtype (bool
    fields from int8, host scalars as Python floats and ints), moved to
    the device in one transfer. The restart mesh must match the current
    one (mesh updates recreate restart files in the reference too,
    UFEMISM_main_model.f90:320-329)."""
    import dataclasses
    import torch
    from ..core.fields import device_arrays
    time, fields = load_restart_file(path)

    def key(name):
        return name.replace(".", "_")

    leaves = {n: v for n, v in _state_leaves(state).items()
              if key(n) in fields}
    tensors = {n: fields[key(n)] for n, v in leaves.items()
               if isinstance(v, torch.Tensor)}
    on_device = device_arrays(
        {n: np.asarray(a).reshape(tuple(leaves[n].shape))
         for n, a in tensors.items()},
        {n: leaves[n].dtype for n in tensors}, state.Hi.device)
    new = {}
    for n, v in leaves.items():
        if n in on_device:
            new[n] = on_device[n]
        else:                         # a host float or int
            new[n] = type(v)(np.asarray(fields[key(n)]).reshape(()))
    updates = {f.name: new[f.name] for f in dataclasses.fields(state)
               if f.name in new}
    pc_new = {k[3:]: v for k, v in new.items() if k.startswith("pc.")}
    if pc_new:
        updates["pc"] = state.pc.replace(**pc_new)
    return time, state.replace(**updates)


class GridOutputFile:
    """Gridded main output (main_output_<R>_grid.nc,
    grid_output_files.f90): the mesh fields conservatively remapped onto
    the square output grid at dx_output_grid_<R>; variables use the
    reference's names so its analysis tooling reads the files directly."""

    def __init__(self, path, mesh, grid, fields=None):
        from ..remap.atlas import get_map
        self.grid = grid
        self.fields = [f for f in (fields or MESH_FIELDS_DEFAULT)
                       if f not in LINE_FIELDS]
        self.M_a = get_map(mesh, grid)                 # vertices -> grid
        from ..remap.conservative import build_map_nearest
        self.M_b = build_map_nearest(mesh.TriGC, grid.centres(), mesh.nTri)
        self.nc = NCFile(path, "w")
        self.nc.def_dim("x", grid.nx)
        self.nc.def_var("x", ("x",), units="m")
        self.nc.put("x", grid.x)
        self.nc.def_dim("y", grid.ny)
        self.nc.def_var("y", ("y",), units="m")
        self.nc.put("y", grid.y)
        if any(f in FIELDS_3D for f in self.fields):
            self.nc.def_dim("zeta", mesh.nz)
            self.nc.def_var("zeta", ("zeta",))
            self.nc.put("zeta", np.asarray(mesh.zeta))
        self.nc.def_dim("time", None)
        self.nc.def_var("time", ("time",), units="years")
        for f in self.fields:
            dims = ("time", "zeta", "y", "x") if f in FIELDS_3D \
                else ("time", "y", "x")
            self.nc.def_var(f, dims)

    def update_mesh(self, mesh):
        """Rebuild the mesh->grid maps after a mesh update; the file
        and its history stay (grid output spans mesh generations)."""
        from ..remap.atlas import get_map
        from ..remap.conservative import build_map_nearest
        self.M_a = get_map(mesh, self.grid)
        self.M_b = build_map_nearest(mesh.TriGC, self.grid.centres(),
                                     mesh.nTri)

    def write(self, time, state_fields: dict):
        first = True
        for f in self.fields:
            if f not in state_fields:
                continue
            v = np.asarray(state_fields[f])
            M = self.M_b if _is_b_grid(f) else self.M_a
            if v.ndim == 2:                     # [n, nz] 3-D field
                g = (M @ v).reshape(self.grid.nx, self.grid.ny, -1)
                g = g.transpose(2, 1, 0)        # [nz, ny, nx]
            else:
                g = (M @ v).reshape(self.grid.nx, self.grid.ny).T
            # bound-preserving limiter: the 2nd-order conservative map
            # has no monotonicity constraint, so clamp to the source
            # field's range (the parity harness caught gridded Hi
            # dipping to -60 m / overshooting the dome summit)
            g = np.clip(g, v.min(), v.max())
            self.nc.append(f, g, coord=time if first else None)
            first = False
        self.nc.flush()

    def close(self):
        self.nc.close()


def mesh_from_restart(path, C, region="ANT"):
    """The mesh a restart file was written on, rebuilt from its vertices
    and triangles (stored 1-based) as the JAX package's resume does
    (ufemism2_tpu/validation/integrated_tests.py:389-397), with the
    region's domain, vertical grid and projection from the config."""
    from ..mesh.creation import set_mesh_lonlat
    from ..mesh.mesh_types import mesh_from_points
    with NCFile(path) as nc:
        V = nc.read("V")
        Tri = nc.read("Tri").astype(np.int64) - 1
    mesh = mesh_from_points(
        V, getattr(C, f"xmin_{region}"), getattr(C, f"xmax_{region}"),
        getattr(C, f"ymin_{region}"), getattr(C, f"ymax_{region}"),
        nz=C.nz, choice_zeta_grid=C.choice_zeta_grid,
        zeta_irregular_log_R=C.zeta_irregular_log_R, Tri=Tri)
    set_mesh_lonlat(mesh, C, region)
    return mesh
