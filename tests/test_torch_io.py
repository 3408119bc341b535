"""The port's file layer against the JAX package's: `io/ncio.py` (NetCDF
classic files through scipy, NetCDF4 files through h5py) and
`io/output_files.py` (mesh, scalar, grid and ISMIP output files, restart
files), on the CPU, in f64.

Restart files and their reads are compared exactly (the same numbers
written and read back); the gridded output goes through the conservative
remap of each package, held to 1e-12 of the field's largest value.

The committed classic copy of the JAX package's MISMIP+ 5 km spin-up
restart (`tests/data/mismipplus_5km_restart_t11425_classic.nc`) is what
lets a machine without h5py resume that state. It is made from the
repository's NetCDF4 file by `write_classic_copy` below:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_io.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixture import build_meshes, state_to_numpy

from ufemism2_tpu.core.mesh_data import build_mesh_data as jax_mesh_data
from ufemism2_tpu.core.ice.state import init_ice_state as jax_init_state
from ufemism2_tpu.io import ncio as jncio
from ufemism2_tpu.io import ismip_output as jismip
from ufemism2_tpu.io import output_files as jout
from ufemism2_tpu.mesh.grids import setup_square_grid as jax_grid

from ufemism2_tpu_torch.convert import ice_state_from_numpy
from ufemism2_tpu_torch.io import ismip_output as tismip
from ufemism2_tpu_torch.io import ncio as tncio
from ufemism2_tpu_torch.io import output_files as tout
from ufemism2_tpu_torch.mesh.grids import setup_square_grid as port_grid

REPO = Path(__file__).resolve().parents[1]
JAX_RESTART = (REPO / "validation_runs" / "persist" / "mismipplus_5km_spinup"
               / "restart_ANT_00001.nc")
CLASSIC_COPY = REPO / "tests" / "data" / \
    "mismipplus_5km_restart_t11425_classic.nc"
GRID_TOL = 1e-12


def write_classic_copy(src, dst):
    """A NetCDF classic copy of the NetCDF file `src`: every variable
    with its dimensions, data and attributes, and the global
    attributes (integers as int32)."""
    src = tncio.NCFile(src)
    with tncio.NCFile(dst, "w") as out:
        for d, n in src.dims().items():
            out.def_dim(d, n)
        for name in src.variables():
            data = src.read(name)
            out.def_var(name, tuple(src.dim_names(name)), dtype=data.dtype,
                        **src.attrs(name))
            out.put(name, data)
        out.set_global_attrs(**src.global_attrs())


# -- ncio -------------------------------------------------------------------

def _write_small(path, hi_frames=2):
    with tncio.NCFile(path, "w") as nc:
        nc.def_dim("vi", 3)
        nc.def_dim("time", None)
        nc.def_var("dt", (), dtype="f8", units="yr")
        nc.put("dt", 0.1)
        nc.def_var("time", ("time",), units="years")
        nc.def_var("Hi", ("time", "vi"), units="m")
        nc.def_var("flag", ("time",), dtype=np.int8)
        nc.def_var("mask", ("vi",), dtype=bool)
        nc.put("mask", np.array([True, False, True]))
        nc.def_var("count", (), dtype=np.int64)
        nc.put("count", np.int64(42))
        nc.def_var("idx", ("vi",), dtype=np.int32)
        nc.put("idx", np.array([1, 2, 3], np.int32))
        nc.set_global_attrs(host_n_dt_ice=22017, restart_time=11425.5,
                            title="t")
        for k in range(hi_frames):
            nc.append("Hi", np.arange(3.0) + k, coord=0.5 * k)
            nc.append("flag", k)
            nc.flush()


def test_ncio_round_trip(tmp_path):
    """Unlimited-time appends, int8, int32, bool and int64 (stored as int8
    and int32), f64, 0-d variables and global attributes, through scipy,
    in a classic 64-bit-offset file."""
    p = tmp_path / "a.nc"
    _write_small(p)
    assert p.read_bytes()[:4] == b"CDF\x02"
    r = tncio.NCFile(p)
    assert r.dims() == {"vi": 3, "time": 2}
    assert np.array_equal(r.read("Hi"), [[0.0, 1.0, 2.0], [1.0, 2.0, 3.0]])
    assert np.array_equal(r.read("time"), [0.0, 0.5])
    assert r.read("flag").dtype == np.int8
    assert r.read("mask").dtype == np.int8
    assert np.array_equal(r.read("mask"), [1, 0, 1])
    assert r.read("count").dtype == np.int32 and r.read("count") == 42
    assert r.read("idx").dtype == np.int32
    assert r.read("dt").shape == () and r.read("dt") == 0.1
    assert r.dim_names("dt") == [] and r.dim_names("Hi") == ["time", "vi"]
    assert r.attrs("Hi") == {"units": "m"}
    g = r.global_attrs()
    assert g["host_n_dt_ice"] == 22017 and g["title"] == "t"
    assert g["restart_time"] == 11425.5           # stored as f64


def test_ncio_write_is_atomic_and_refuses_what_classic_cannot_hold(tmp_path):
    """A write that fails leaves the previous complete file, and no
    temporary; int64 values beyond int32 and a second unlimited
    dimension raise."""
    p = tmp_path / "a.nc"
    _write_small(p, hi_frames=1)
    before = p.read_bytes()
    with pytest.raises(RuntimeError):
        with tncio.NCFile(p, "w") as nc:
            nc.def_dim("vi", 3)
            nc.def_var("Hi", ("vi",))
            nc.put("Hi", np.ones(3))
            raise RuntimeError("killed mid-write")
    assert p.read_bytes() == before
    assert not (tmp_path / "a.nc.tmp").exists()
    assert np.array_equal(tncio.NCFile(p).read("Hi"), [[0.0, 1.0, 2.0]])
    nc = tncio.NCFile(tmp_path / "b.nc", "w")
    nc.def_dim("vi", 1)
    nc.def_var("big", ("vi",), dtype=np.int64)
    with pytest.raises(OverflowError):
        nc.put("big", np.array([2 ** 40]))
    with pytest.raises(OverflowError):
        nc.set_global_attrs(n=2 ** 40)
    nc.def_dim("time", None)
    with pytest.raises(ValueError, match="unlimited"):
        nc.def_dim("time2", None)


def test_hdf5_read_names_the_missing_h5py(monkeypatch):
    """Without h5py a NetCDF4 file raises, naming the module and the
    file; it never reads as empty."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py") as e:
        tncio.NCFile(JAX_RESTART)
    assert str(JAX_RESTART) in str(e.value)
    assert tncio.NCFile(CLASSIC_COPY).has("Hi")      # classic needs no h5py


# -- restart files ------------------------------------------------------------

def test_reads_jax_restart_as_jax():
    """The JAX package's MISMIP+ 5 km restart (NetCDF4) read by the port
    gives exactly what the JAX package's own reader gives; so does the
    committed classic copy."""
    tj, fj = jout.load_restart_file(JAX_RESTART)
    hj = jout.load_restart_host_counters(JAX_RESTART)
    assert hj == {"n_dt_ice": 22017} and tj == 11425.0
    for path in (JAX_RESTART, CLASSIC_COPY):
        tt, ft = tout.load_restart_file(path)
        assert tt == tj
        assert sorted(ft) == sorted(fj)
        for k in fj:
            assert ft[k].dtype == fj[k].dtype, k
            assert np.array_equal(ft[k], fj[k], equal_nan=True), k
        assert tout.load_restart_host_counters(path) == hj


def test_classic_copy_equals_original(tmp_path):
    """The committed classic copy holds every variable of the NetCDF4
    original, with its dimensions, data and units, and its global
    attributes; the helper rewrites it byte for byte."""
    orig = jncio.NCFile(JAX_RESTART)
    port_orig = tncio.NCFile(JAX_RESTART)
    copy = tncio.NCFile(CLASSIC_COPY)
    assert sorted(copy.variables()) == sorted(orig.variables())
    assert len(copy.variables()) == 103 - 11        # 11 dimension scales
    for name in orig.variables():
        a, b = orig.read(name), copy.read(name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b, equal_nan=True), name
        assert copy.dim_names(name) == port_orig.dim_names(name), name
        assert copy.attrs(name).get("units") == \
            orig.attrs(name).get("units"), name
    assert copy.dims() == port_orig.dims()
    ga = {k: v.item() for k, v in orig.h5.attrs.items()}
    assert copy.global_attrs() == ga
    orig.close()
    again = tmp_path / "copy.nc"
    write_classic_copy(JAX_RESTART, again)
    assert again.read_bytes() == CLASSIC_COPY.read_bytes()


@pytest.fixture(scope="module")
def meshes():
    return build_meshes()


def _states(mesh_j, seed=3):
    """The same random-valued IceState in both packages."""
    rng = np.random.default_rng(seed)
    md = jax_mesh_data(mesh_j)
    Hi = rng.uniform(0.0, 3000.0, mesh_j.nV)
    Hb = rng.uniform(-800.0, 400.0, mesh_j.nV)
    sj = jax_init_state(md, Hi, Hb, np.zeros(mesh_j.nV), nz=12, dt_init=0.1)
    import jax.numpy as jnp
    sj = sj.replace(
        u_3D_b=jnp.asarray(rng.standard_normal((mesh_j.nTri, 12))),
        Ti=jnp.asarray(rng.uniform(240.0, 273.0, (mesh_j.nV, 12))),
        mask_gl_gr=jnp.asarray(rng.random(mesh_j.nV) < 0.3),
        mask=jnp.asarray(rng.integers(0, 9, mesh_j.nV), jnp.int32),
        n_visc_its=jnp.asarray(17, jnp.int32),
        t_Hi_next=jnp.asarray(12.5),
        pc=sj.pc.replace(tau_np1=jnp.asarray(rng.standard_normal(
            mesh_j.nV)), dt_np1=jnp.asarray(0.37)))
    st = ice_state_from_numpy(state_to_numpy(sj), "cpu", torch.float64)
    return sj, st


def test_restart_file_as_jax(meshes, tmp_path):
    """The port's restart file of a state has the JAX package's variable
    names, dimensions and values (the JAX file read by the JAX reader,
    the port's by the port's), and it restores the state exactly."""
    mesh_j, mesh_t = meshes
    sj, st = _states(mesh_j)
    pj, pt = tmp_path / "restart_j.nc", tmp_path / "restart_t.nc"
    jout.write_restart_file(pj, mesh_j, sj, 12.25,
                            host_counters={"n_dt_ice": 40})
    tout.write_restart_file(pt, mesh_t, st, 12.25,
                            host_counters={"n_dt_ice": 40})
    assert pt.read_bytes()[:4] == b"CDF\x02"
    fj, ft = jncio.NCFile(pj), tncio.NCFile(pt)
    # the port writes 'zeta' as a coordinate variable; the JAX package
    # keeps it as the data of its dimension scale
    assert sorted(ft.variables()) == sorted(fj.variables() + ["zeta"])
    for name in ft.variables():
        a, b = fj.read(name), ft.read(name)
        if a.dtype == np.int64 or a.dtype == bool:      # classic: int32/8
            a = a.astype(b.dtype)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
        if name not in ("time", "zeta"):      # ('' is the JAX reader's 0-d)
            assert ft.dim_names(name) == [d for d in fj.dim_names(name)
                                          if d], name
    assert {k: v.item() for k, v in fj.h5.attrs.items()} \
        == ft.global_attrs()
    fj.close()
    # a scrambled state restored from the port's file equals the original
    scr = st.replace(Hi=st.Hi * 0.5, n_visc_its=0,
                     pc=st.pc.replace(dt_n=7.0))
    t, back = tout.restore_state_from_restart(scr, pt)
    assert t == 12.25
    for name, v in tout._state_leaves(st).items():
        w = tout._state_leaves(back)[name]
        if isinstance(v, torch.Tensor):
            assert w.dtype == v.dtype and torch.equal(w, v), name
        else:
            assert type(w) is type(v) and w == v, name


def test_output_files_as_jax(meshes, tmp_path):
    """MeshOutputFile, ScalarOutputFile, GridOutputFile and the ISMIP
    file of both packages hold the same variables and values over two
    frames (mesh and scalar files exactly, the conservatively remapped
    grid to GRID_TOL)."""
    mesh_j, mesh_t = meshes
    rng = np.random.default_rng(11)
    frames = []
    for _ in range(2):
        f = {name: rng.standard_normal(
            mesh_j.nTri if jout._is_b_grid(name) else mesh_j.nV)
            for name in jout.MESH_FIELDS_DEFAULT}
        frames.append(f)
    scal = [{k: float(rng.standard_normal()) for k in jout.SCALAR_FIELDS}
            for _ in range(2)]
    gj = jax_grid(mesh_j.xmin, mesh_j.xmax, mesh_j.ymin, mesh_j.ymax, 200e3)
    gt = port_grid(mesh_t.xmin, mesh_t.xmax, mesh_t.ymin, mesh_t.ymax, 200e3)
    ismip = [{k: rng.standard_normal((gj.ny, gj.nx))
              for k in jismip.ISMIP_VARS} for _ in range(2)]
    files = {}
    for tag, mod, ism, mesh, grid in (("j", jout, jismip, mesh_j, gj),
                                      ("t", tout, tismip, mesh_t, gt)):
        files[tag] = dict(
            mesh=mod.MeshOutputFile(tmp_path / f"main_{tag}.nc", mesh),
            scalar=mod.ScalarOutputFile(tmp_path / f"scalar_{tag}.nc"),
            grid=mod.GridOutputFile(tmp_path / f"grid_{tag}.nc", mesh, grid),
            ismip=ism.ISMIPOutput(tmp_path / f"ismip_{tag}.nc", grid))
        for k in range(2):
            files[tag]["mesh"].write(0.5 * k, frames[k])
            files[tag]["scalar"].write(0.5 * k, scal[k])
            files[tag]["grid"].write(0.5 * k, frames[k])
            files[tag]["ismip"].write(0.5 * k, ismip[k])
        for f in files[tag].values():
            f.close()
    for kind in ("mesh", "scalar", "grid", "ismip"):
        fj = jncio.NCFile(tmp_path / f"{kind}_j.nc"
                          if kind != "mesh" else tmp_path / "main_j.nc")
        ft = tncio.NCFile(tmp_path / f"{kind}_t.nc"
                          if kind != "mesh" else tmp_path / "main_t.nc")
        # the JAX package's coordinate variables (time, x, y, zeta) are the
        # data of its dimension scales
        coords = set(ft.dims()) & set(ft.variables())
        assert sorted(set(ft.variables()) - coords) == sorted(
            set(fj.variables()) - coords), kind
        assert ft.dims()["time"] == 2
        for name in ft.variables():
            a, b = fj.read(name), ft.read(name)
            assert a.shape == b.shape, (kind, name)
            tol = GRID_TOL * max(np.abs(a).max(), 1e-300) \
                if kind == "grid" else 0.0
            assert np.abs(a - b).max() <= tol, (kind, name)
        fj.close()


@pytest.mark.parametrize("fmt", ["netcdf4", "classic"])
def test_forcing_series_as_jax(tmp_path, fmt):
    """The 'prescribed' sea level and the 'CO2_direct' record read and
    interpolated in time as the JAX package does (from the same NetCDF4
    file; and from a classic file the port writes)."""
    from ufemism2_tpu.config import Config as JaxConfig
    from ufemism2_tpu.models.forcings import GlobalForcings as JaxForcings
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.models.forcings import GlobalForcings
    t = np.array([-1000.0, 0.0, 500.0, 2000.0])
    series = {"sealevel.nc": ("SL", np.array([-60.0, -20.0, 3.0, 10.0])),
              "co2.nc": ("co2", np.array([190.0, 280.0, 300.0, 420.0]))}
    for name, (var, v) in series.items():
        if fmt == "netcdf4":
            with jncio.NCFile(tmp_path / name, "w") as nc:
                nc.def_dim("time", len(t))
                nc.def_var("time", ("time",))
                nc.put("time", t)
                nc.def_var(var, ("time",))
                nc.put(var, v)
        else:
            with tncio.NCFile(tmp_path / name, "w") as nc:
                nc.def_dim("time", len(t))
                nc.def_var("time", ("time",))
                nc.put("time", t)
                nc.def_var(var, ("time",))
                nc.put(var, v)
    kw = dict(choice_sealevel_model="prescribed",
              filename_prescribed_sealevel=str(tmp_path / "sealevel.nc"),
              choice_matrix_forcing="CO2_direct",
              filename_CO2_record=str(tmp_path / "co2.nc"))
    ft = GlobalForcings(Config(**kw))
    fj = JaxForcings(JaxConfig(**kw)) if fmt == "netcdf4" else None
    for time in (-2000.0, -500.0, 0.0, 123.4, 1999.0, 5000.0):
        ft.update(time)
        sl = np.interp(time, t, series["sealevel.nc"][1])
        co2 = np.interp(time, t, series["co2.nc"][1])
        assert (ft.sealevel, ft.CO2) == (sl, co2)
        if fj is not None:
            fj.update(time)
            assert (ft.sealevel, ft.CO2) == (fj.sealevel, fj.CO2)


if __name__ == "__main__":
    write_classic_copy(JAX_RESTART, CLASSIC_COPY)
    print(f"wrote {CLASSIC_COPY}")
