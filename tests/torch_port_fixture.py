"""Shared set-up of the PyTorch-port parity tests (not a test file).

One coarse MISMIP_mod DIVA configuration (64 km at the grounding line,
about 1.1k vertices), built once per test module in the JAX package and
handed to the port as numpy: both sides then run on the identical mesh
and the identical host tables.
"""

import dataclasses

import numpy as np
import torch

# One intra-op thread per process: the suite runs in several worker
# processes at once, and the port's tensors are small, so more threads only
# make the workers' thread pools spin against each other.
torch.set_num_threads(1)

FIXTURE = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="MISMIP_mod",
    choice_refgeo_PD_ANT="idealised",
    choice_refgeo_PD_idealised="MISMIP_mod",
    refgeo_idealised_MISMIP_mod_Hi_init=100.0,
    dx_refgeo_init_idealised=32e3,
    choice_mask_noice="MISMIP_mod",
    uniform_Glens_flow_factor=1e-16,
    choice_ice_rheology_Glen="uniform",
    choice_thermo_model="none",
    choice_initial_ice_temperature_ANT="uniform",
    xmin_ANT=-1000e3, xmax_ANT=1000e3, ymin_ANT=-1000e3, ymax_ANT=1000e3,
    maximum_resolution_uniform=200e3,
    maximum_resolution_grounded_ice=128e3,
    maximum_resolution_floating_ice=200e3,
    maximum_resolution_grounding_line=64e3, grounding_line_width=64e3,
    maximum_resolution_calving_front=128e3, calving_front_width=128e3,
    maximum_resolution_ice_front=128e3, ice_front_width=128e3,
    nit_Lloyds_algorithm=2, allow_mesh_updates=False,
    choice_SMB_model_ANT="uniform", uniform_SMB=0.3,
    choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
    visc_it_nit=3, pc_nit_max=2,
)


# A coarse MISMIP+ configuration (tests/test_ocean_pressure_bc.py's, with
# the domain reaching past the MISMIP+ ice mask at x = 640 km, so that the
# ocean-pressure calving front acts): DIVA, Weertman sliding, about 70
# vertices at 40 km.
MISMIPPLUS = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="MISMIP+",
    choice_refgeo_PD_ANT="idealised",
    choice_refgeo_PD_idealised="MISMIP+",
    refgeo_idealised_MISMIPplus_Hi_init=100.0,
    dx_refgeo_init_idealised=10e3,
    choice_mask_noice="MISMIP+",
    choice_stress_balance_approximation="DIVA",
    choice_sliding_law="Weertman",
    slid_Weertman_beta_sq_uniform=1e4,
    BC_ice_front="ocean_pressure",
    choice_ice_rheology_Glen="uniform", uniform_Glens_flow_factor=2.0e-17,
    choice_thermo_model="none",
    choice_initial_ice_temperature_ANT="uniform",
    choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
    uniform_SMB=0.3, choice_SMB_model_ANT="uniform",
    xmin_ANT=0.0, xmax_ANT=800e3, ymin_ANT=-40e3, ymax_ANT=40e3,
    maximum_resolution_uniform=40e3,
    maximum_resolution_grounded_ice=40e3,
    maximum_resolution_grounding_line=40e3,
    start_time_of_run=0.0, end_time_of_run=2.0,
    nit_Lloyds_algorithm=2, refgeo_Hi_min=2.0,
    allow_mesh_updates=False, visc_it_nit=3, pc_nit_max=2,
)


def mismipplus_configs(**over):
    """(JAX-package Config, port Config) of the MISMIP+ configuration."""
    from ufemism2_tpu.config import Config as CJ
    from ufemism2_tpu_torch.config import Config as CT
    kw = dict(MISMIPPLUS, **over)
    return CJ(**kw), CT(**kw)


def build_meshes_for(Cj):
    """(JAX-package mesh, port mesh) of a JAX-package Config."""
    from ufemism2_tpu.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    mesh_j = build_mesh_from_config(Cj, "ANT")
    return mesh_j, mesh_from_numpy(mesh_to_numpy(mesh_j))


def configs(**over):
    """(JAX-package Config, port Config) of the fixture with overrides."""
    from ufemism2_tpu.config import Config as CJ
    from ufemism2_tpu_torch.config import Config as CT
    kw = dict(FIXTURE, **over)
    return CJ(**kw), CT(**kw)


def mesh_to_numpy(mesh):
    """A host Mesh of the JAX package as a dict of numpy arrays/scalars."""
    return {f.name: getattr(mesh, f.name) for f in dataclasses.fields(mesh)
            if f.name not in ("operators", "device")}


def build_meshes():
    """(JAX-package mesh, port mesh): the same mesh, each with its own
    package's operators."""
    from ufemism2_tpu.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    Cj, _ = configs()
    mesh_j = build_mesh_from_config(Cj, "ANT")
    mesh_t = mesh_from_numpy(mesh_to_numpy(mesh_j))
    return mesh_j, mesh_t


def bedrock_cdfs_numpy(mesh_j):
    """The JAX package's host bedrock-CDF tables for the fixture mesh."""
    from ufemism2_tpu.core.ice.bedrock_cdf import \
        build_bedrock_cdfs_from_config
    Cj, _ = configs()
    cdf_a, cdf_b = build_bedrock_cdfs_from_config(Cj, mesh_j, "ANT")
    return np.asarray(cdf_a), np.asarray(cdf_b)


def state_to_numpy(s):
    """A JAX IceState as the dict `convert.ice_state_from_numpy` takes."""
    out = {}
    for name in s.__dataclass_fields__:
        v = getattr(s, name)
        if name == "pc":
            out["pc"] = {k: np.asarray(getattr(v, k))
                         for k in v.__dataclass_fields__}
        else:
            out[name] = np.asarray(v)
    return out


def rel_gap(a, b):
    """max|a - b| / max|b| (0 when both vanish); a may be a tensor."""
    a = np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach") else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    den = np.abs(b).max() if b.size else 0.0
    gap = np.abs(a - b).max() if b.size else 0.0
    return gap / den if den > 0 else gap


def ell_to_dense(M, op=0):
    """Dense numpy matrix of operator `op` of the port's EllStack."""
    cols = M.cols.cpu().numpy()
    rows = np.broadcast_to(np.arange(M.n_rows)[None, :], cols.shape)
    out = np.zeros((M.n_rows, M.n_cols), M.vals.cpu().numpy().dtype)
    np.add.at(out, (rows, cols), M.vals[op].cpu().numpy())
    return out


def write_nc(NC, path, dims, variables):
    """A NetCDF file written through NCFile class NC (the JAX package's or
    the port's) with dimensions {name: size} and variables
    {name: (dims, data[, dtype])}; returns the path."""
    with NC(str(path), "w") as nc:
        for d, n in dims.items():
            nc.def_dim(d, n)
        for name, spec in variables.items():
            nc.def_var(name, spec[0],
                       dtype=spec[2] if len(spec) > 2 else "f8")
            nc.put(name, np.asarray(spec[1]))
    return str(path)


def write_nc_pair(tmp_path, stem, dims, variables):
    """The same file twice: (the JAX package's NetCDF4 file, the port's
    NetCDF classic file)."""
    from ufemism2_tpu.io.ncio import NCFile as JaxNC
    from ufemism2_tpu_torch.io.ncio import NCFile as PortNC
    return (write_nc(JaxNC, tmp_path / f"{stem}_nc4.nc", dims, variables),
            write_nc(PortNC, tmp_path / f"{stem}_classic.nc", dims,
                     variables))


def ocean_snapshot_spec(T_shift=0.0, with_time=False):
    """An x/y T/S snapshot over the MISMIP+ domain, NaN below a sea floor
    that deepens towards the east, [depth, y, x] as ISMIP6 files hold
    it; with_time: three frames of anomalies instead."""
    x = np.linspace(-10e3, 810e3, 42)
    y = np.linspace(-50e3, 50e3, 11)
    depth = np.array([0.0, 100.0, 250.0, 400.0, 600.0, 800.0, 1100.0,
                      1500.0])
    X, Y = np.meshgrid(x, y, indexing="ij")
    floor = 300.0 + 1.2e-3 * X
    T = (-1.9 + 2.5 * np.tanh(depth / 500.0))[:, None, None] \
        + 1e-6 * X[None] + 1e-5 * Y[None] + T_shift
    S = (33.8 + 9e-4 * depth)[:, None, None] + 0.0 * X[None]
    T[depth[:, None, None] > floor[None]] = np.nan
    S[depth[:, None, None] > floor[None]] = np.nan
    dims = {"x": len(x), "y": len(y), "depth": len(depth)}
    variables = {"x": (("x",), x), "y": (("y",), y),
                 "depth": (("depth",), depth)}
    if with_time:
        t = np.array([0.0, 10.0, 20.0])
        dims["time"] = 3
        variables["time"] = (("time",), t)
        variables["temperature_anomaly"] = (
            ("time", "depth", "y", "x"), np.stack(
                [np.swapaxes(np.nan_to_num(T) * 0.0 + 0.3 * k + 1e-7 * X[None],
                             1, 2) for k in range(3)]))
        variables["salinity_anomaly"] = (
            ("time", "depth", "y", "x"), np.stack(
                [np.swapaxes(np.nan_to_num(S) * 0.0 - 0.05 * k, 1, 2)
                 for k in range(3)]))
    else:
        variables["T_ocean"] = (("depth", "y", "x"), np.swapaxes(T, 1, 2))
        variables["S_ocean"] = (("depth", "y", "x"), np.swapaxes(S, 1, 2))
    return dims, variables


# ISMIP-HOM (Pattyn et al. 2008) at a small size: the experiment's
# geometry on the domain [-L, L]^2 that the JAX package's harness's
# transect implies (x in [xmin/2, xmax/2], y = ymin/4:
# ufemism2_tpu/validation/integrated_tests.py:249-252), a uniform mesh,
# periodic lateral boundaries, uniform A 1e-16 Pa^-3 yr^-1; no SMB or BMB
# (the experiments are diagnostic).
def ismip_hom(experiment="A", L=20e3, res=5e3, **over):
    """The config dict of ISMIP-HOM experiment A or C at L and mesh
    resolution `res`, BPA (override the approximation in `over`)."""
    geo = f"ISMIP-HOM_{experiment}"
    kw = dict(
        choice_refgeo_init_ANT="idealised", choice_refgeo_init_idealised=geo,
        choice_refgeo_PD_ANT="idealised", choice_refgeo_PD_idealised=geo,
        refgeo_idealised_ISMIP_HOM_L=L, choice_mask_noice="none",
        choice_stress_balance_approximation="BPA",
        choice_sliding_law="no_sliding",
        choice_ice_rheology_Glen="uniform", uniform_Glens_flow_factor=1e-16,
        choice_thermo_model="none",
        choice_initial_ice_temperature_ANT="uniform",
        choice_SMB_model_ANT="uniform", uniform_SMB=0.0,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        xmin_ANT=-L, xmax_ANT=L, ymin_ANT=-L, ymax_ANT=L,
        maximum_resolution_uniform=res,
        maximum_resolution_grounded_ice=res,
        maximum_resolution_floating_ice=res,
        maximum_resolution_grounding_line=res, grounding_line_width=res,
        maximum_resolution_calving_front=res, calving_front_width=res,
        maximum_resolution_ice_front=res, ice_front_width=res,
        nit_Lloyds_algorithm=2, allow_mesh_updates=False,
        **{f"BC_{c}_{s}": "periodic_ISMIP-HOM" for c in "uv"
           for s in ("north", "south", "east", "west")})
    if experiment == "C":
        kw.update(choice_sliding_law="idealised",
                  choice_idealised_sliding_law="ISMIP-HOM_C")
    kw.update(over)
    return kw


def ismip_transect(mesh, u_3D_b):
    """u_surf on the JAX package's ISMIP-HOM transect (100 points, x in
    [xmin/2, xmax/2], y = ymin/4), sampled through the port's Transect."""
    from ufemism2_tpu_torch.models.transects import Transect
    xt = np.linspace(mesh.xmin / 2, mesh.xmax / 2, 100)
    yt = np.full_like(xt, mesh.ymin / 4)
    tr = Transect(mesh, np.stack([xt, yt], 1), "ISMIP-HOM")
    u = np.asarray(u_3D_b.detach().cpu().numpy() if hasattr(u_3D_b, "detach")
                   else u_3D_b, np.float64)
    return tr.sample_triangles(u)[:, 0]


def copy_to_nc4(path, out):
    """The port's NetCDF classic file at `path` rewritten through the JAX
    package's NCFile (NetCDF4) at `out`, variable by variable with its
    dimensions; returns out."""
    from ufemism2_tpu.io.ncio import NCFile as JaxNC
    from ufemism2_tpu_torch.io.ncio import NCFile as PortNC
    with PortNC(str(path)) as src, JaxNC(str(out), "w") as dst:
        for d, n in src.dims().items():
            dst.def_dim(d, n)
        for name in src.variables():
            dst.def_var(name, tuple(src.dim_names(name)))
            dst.put(name, np.asarray(src.read(name), dtype=np.float64))
    return str(out)


class ConfigWith:
    """A Config read through getattr with extra keys the schema does not
    define (both packages' IMAU-ITM read the firn file's name that way)."""

    def __init__(self, C, **extra):
        self._C, self._extra = C, extra

    def __getattr__(self, k):
        if k in self._extra:
            return self._extra[k]
        return getattr(self._C, k)


def polar_meshes(half=300e3, res=30e3):
    """(JAX-package mesh, port mesh): a uniform mesh on the square
    [-half, half]^2 around the South Pole, with the ANT projection's
    lon/lat."""
    from ufemism2_tpu.mesh import build_uniform_mesh
    from ufemism2_tpu.mesh.projections import inverse_oblique_sg_projection
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    m = build_uniform_mesh(-half, half, -half, half, res)
    m.proj = (0.0, -90.0, 71.0)
    m.lon, m.lat = inverse_oblique_sg_projection(m.V[:, 0], m.V[:, 1],
                                                 *m.proj)
    return m, mesh_from_numpy(mesh_to_numpy(m))


def climate_files(tmp_path, half=300e3, seed=3, zero_precip=False):
    """Seeded synthetic inputs of the climate chain on an x/y grid over
    [-half, half]^2 (and a global lon/lat grid), each written by both
    packages (write_nc_pair): {name: (JAX file, port file)}. Names:
    snapshot (Hs, T2m, Precip), anomalies (T2m_anomaly, Precip_anomaly,
    three frames), dT (a dT_atmosphere series), insolation (Laskar layout,
    Q_TOA at six times), GI, CO2, SMB (a snapshot), SMB_anomalies, PD, PI,
    warm and cold (GCM snapshots with winds; the cold one thicker, colder
    and drier; zero_precip: the warm snapshot's precipitation is 0 on part
    of the grid, which the matrix climate's 1e-300 floors meet)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.1 * half, 1.1 * half, 23)
    y = np.linspace(-1.1 * half, 1.1 * half, 19)
    X, Y = np.meshgrid(x, y, indexing="ij")
    R = np.hypot(X, Y) / half
    xy = {"x": len(x), "y": len(y)}
    axes = {"x": (("x",), x), "y": (("y",), y)}
    mon = {"month": (("month",), np.arange(1.0, 13.0))}
    cyc = np.cos(2 * np.pi * (np.arange(12) + 0.5) / 12.0)[:, None, None]

    def smooth(amp):
        from scipy.ndimage import gaussian_filter
        f = gaussian_filter(rng.standard_normal(X.shape), 2.0)
        return amp * f / np.abs(f).max()

    Hs = np.maximum(0.0, 2500.0 * (1.0 - R ** 2) + smooth(200.0))
    T2m = (250.0 - 0.006 * Hs + smooth(3.0))[None] + 12.0 * cyc
    Precip = (0.3 * np.exp(-Hs / 1500.0) + 0.02)[None] * (1 + 0.2 * cyc)
    files = {}

    def pair(name, dims, variables):
        files[name] = write_nc_pair(tmp_path, name, dims, variables)

    def snapshot(Hs_, T_, P_, winds=None):
        v = dict(axes, **mon, Hs=(("x", "y"), Hs_),
                 T2m=(("month", "x", "y"), T_),
                 Precip=(("month", "x", "y"), P_))
        if winds is not None:
            v["Wind_WE"] = (("month", "x", "y"), winds[0])
            v["Wind_SN"] = (("month", "x", "y"), winds[1])
        return dict(xy, month=12), v

    pair("snapshot", *snapshot(Hs, T2m, Precip))
    t3 = np.array([0.0, 10.0, 30.0])
    k = np.arange(3.0)[:, None, None, None]
    pair("anomalies", dict(xy, month=12, time=3), dict(
        axes, **mon, time=(("time",), t3),
        T2m_anomaly=(("time", "month", "x", "y"),
                     k * (0.7 + 0.1 * cyc[None]) + 0.0 * X),
        Precip_anomaly=(("time", "month", "x", "y"),
                        -k * 0.02 * np.exp(-Hs / 800.0)[None, None]
                        * np.ones((1, 12, 1, 1)))))
    pair("SMB", dict(xy), dict(axes, SMB=(("x", "y"), 0.4 - 0.1 * R)))
    pair("SMB_anomalies", dict(xy, time=3), dict(
        axes, time=(("time",), t3),
        SMB_anomaly=(("time", "x", "y"),
                     -np.arange(3.0)[:, None, None] * 0.05 * R[None])))
    for name, var, t, v in (
            ("dT", "dT_atmosphere", [0.0, 5.0, 20.0], [0.0, 0.8, 2.5]),
            ("GI", "GI", [-100.0, 0.0, 7.0, 50.0], [1.0, 0.6, 0.25, 0.0]),
            ("CO2", "CO2", [-30000.0, -21000.0, 0.0, 50.0],
             [230.0, 190.0, 280.0, 300.0])):
        pair(name, {"time": len(t)}, {"time": (("time",), np.array(t)),
                                      var: (("time",), np.array(v))})
    lon = np.arange(0.0, 360.0, 30.0)
    lat = np.arange(-90.0, 90.1, 15.0)
    # insolation: the frames of the tests' windows (-5 to 40) share one
    # annual mean and differ in the amplitude of their seasonal cycle, so
    # that interpolating in time changes the result; the orbit frames
    # (-30000, -21000) also have a lower annual mean, so that the matrix
    # climate's warm (0) and cold (-21000) orbits absorb different
    # insolation. A run whose window starts at 0 does not load them
    # (test_torch_climate_matrix.py test_matrix_orbit_frames_clamped)
    t_ins = np.array([-30000.0, -21000.0, -5.0, 0.0, 10.0, 40.0])
    mean = np.array([0.985, 0.97, 1.0, 1.0, 1.0, 1.0])
    amp = np.array([1.04, 0.96, 1.03, 1.0, 0.97, 1.05])
    Q = (250.0 * mean[:, None, None, None]
         - 230.0 * np.sin(np.deg2rad(lat))[None, None, None, :]
         * cyc.reshape(1, 12, 1, 1) * amp[:, None, None, None]
         + 3.0 * np.cos(np.deg2rad(lon))[None, None, :, None])
    pair("insolation", {"time": 6, "month": 12, "lon": len(lon),
                        "lat": len(lat)}, {
        "time": (("time",), t_ins), **mon, "lon": (("lon",), lon),
        "lat": (("lat",), lat),
        "Q_TOA": (("time", "month", "lon", "lat"), np.maximum(Q, 0.0))})
    winds = (6.0 + smooth(2.0)[None] + cyc, -2.0 + smooth(1.5)[None] * cyc)
    pair("PD", *snapshot(Hs, T2m, Precip, winds))
    pair("PI", *snapshot(Hs, T2m + 0.7, Precip * 1.15, winds))
    P_warm = Precip * 1.2
    if zero_precip:
        P_warm = np.where((X > 0.3 * half)[None], 0.0, P_warm)
    pair("warm", *snapshot(Hs, T2m + 2.0, P_warm, winds))
    Hs_cold = np.where(Hs > 0.0, Hs + 400.0 * (1.0 - R ** 2), 0.0)
    pair("cold", *snapshot(Hs_cold, T2m - 10.0 - 0.006 * (Hs_cold - Hs),
                           Precip * 0.6, winds))
    return files


def climate_state(mesh, rng, scale=1.0):
    """(JAX-side state, port-side state) namespaces with Hi, Hb, SL, Hs,
    TAF and dHb on the mesh's vertices: an ice sheet over a bed that
    falls below sea level at the margin, open ocean beyond it."""
    from types import SimpleNamespace
    import jax.numpy as jnp
    R = np.hypot(mesh.V[:, 0], mesh.V[:, 1]) / np.abs(mesh.V).max()
    Hb = 800.0 - 1800.0 * R ** 2 + 30.0 * rng.standard_normal(len(R))
    Hi = np.where(R < 0.8, scale * 2600.0 * np.sqrt(np.clip(
        1.0 - (R / 0.8) ** 2, 0.0, 1.0)), 0.0)
    SL = np.zeros_like(Hi)
    rho = 917.0 / 1027.0
    Hs = np.where(Hi * rho > SL - Hb, Hi + Hb, SL + Hi * (1.0 - rho))
    Hs = np.where(Hi > 0.0, Hs, np.maximum(Hb, SL))
    TAF = Hi - np.maximum(0.0, (SL - Hb) * (1027.0 / 917.0))
    f = dict(Hi=Hi, Hb=Hb, SL=SL, Hs=Hs, TAF=TAF,
             dHb=5.0 * rng.standard_normal(len(R)))
    return (SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()}),
            SimpleNamespace(**{k: torch.from_numpy(v.copy())
                               for k, v in f.items()}))


# -- stand-ins for the validation harness's configs -------------------------
# The reference's integrated-test configs, which the harness reads from
# its REF_TESTS, MISMIP_MOD_DIR and ANT_CFG, are not in the repository.
# The parity tests of the harness write small stand-ins in the reference's
# layout into a temporary directory and point both packages' harness at
# it (`point_harness_at`): a few hundred vertices at most, a few model
# years, fixed meshes.

def _literal(v):
    if isinstance(v, bool):
        return ".TRUE." if v else ".FALSE."
    if isinstance(v, str):
        return f"'{v}'"
    return repr(float(v)) if isinstance(v, float) else str(v)


def write_namelist(path, values, comment="stand-in"):
    """A reference-style namelist: `&CONFIG`, one `key_config = value`
    line each, `/`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [f"! {comment}", "&CONFIG"] \
        + [f"  {k}_config = {_literal(v)}" for k, v in values.items()] \
        + ["/"]
    path.write_text("\n".join(lines) + "\n")
    return path


ANT_CFG_REL = ("realistic/Antarctica/initialisation/"
               "Ant_init_20kyr_invBMB_invfric_40km/config.cfg")


def point_harness_at(monkeypatch, root):
    """REF_TESTS, MISMIP_MOD_DIR and ANT_CFG of both packages' harness set
    to the stand-ins under `root`."""
    from ufemism2_tpu.validation import integrated_tests as jit
    from ufemism2_tpu_torch.validation import integrated_tests as tit
    for m in (jit, tit):
        monkeypatch.setattr(m, "REF_TESTS", root)
        monkeypatch.setattr(m, "MISMIP_MOD_DIR",
                            root / "idealised/MISMIP_mod")
        monkeypatch.setattr(m, "ANT_CFG", root / ANT_CFG_REL)


def write_standins(root, files):
    """Write {path under root: values} as namelists; returns root."""
    for rel, values in files.items():
        write_namelist(root / rel, values)
    return root


# the Halfar dome of tests/test_halfar.py, coarser (150 km, 100 km at the
# margin), SIA, with the schema's 3-D heat equation
H_HALFAR = dict(
    choice_refgeo_init_ANT="idealised", choice_refgeo_init_idealised="Halfar",
    dx_refgeo_init_idealised=50e3,
    refgeo_idealised_Halfar_H0=3000.0, refgeo_idealised_Halfar_R0=500e3,
    uniform_Glens_flow_factor=1e-16, choice_ice_rheology_Glen="uniform",
    choice_stress_balance_approximation="SIA",
    choice_sliding_law="no_sliding",
    xmin_ANT=-750e3, xmax_ANT=750e3, ymin_ANT=-750e3, ymax_ANT=750e3,
    maximum_resolution_uniform=150e3, maximum_resolution_grounded_ice=150e3,
    maximum_resolution_ice_front=100e3, ice_front_width=100e3,
    start_time_of_run=0.0, end_time_of_run=2.0,
    nit_Lloyds_algorithm=2, refgeo_Hi_min=2.0, allow_mesh_updates=False,
    choice_SMB_model_ANT="uniform", uniform_SMB=0.0,
)
# Schoof's (2006) ice stream with the parameters of Bueler and Brown
# (2009, J. Geophys. Res. 114, F03008, test I): H 2000 m, surface slope
# 0.001, L 40 km, m 10; A = B^-3 with B = 3.7e8 Pa s^1/3
H_SSA = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="SSA_icestream",
    refgeo_idealised_SSA_icestream_Hi=2000.0,
    refgeo_idealised_SSA_icestream_dhdx=-0.001,
    refgeo_idealised_SSA_icestream_L=40e3,
    refgeo_idealised_SSA_icestream_m=10.0,
    choice_ice_rheology_Glen="uniform",
    uniform_Glens_flow_factor=(3.7e8) ** -3 * 31556926.0,
    choice_stress_balance_approximation="SSA",
    choice_sliding_law="idealised",
    choice_idealised_sliding_law="SSA_icestream",
    choice_thermo_model="none", choice_initial_ice_temperature_ANT="uniform",
    choice_SMB_model_ANT="uniform", uniform_SMB=0.0,
    BC_u_west="infinite_SSA_icestream", BC_v_west="infinite_SSA_icestream",
    BC_u_east="infinite_SSA_icestream", BC_v_east="infinite_SSA_icestream",
    BC_u_north="zero", BC_v_north="zero",
    BC_u_south="zero", BC_v_south="zero",
    xmin_ANT=-150e3, xmax_ANT=150e3, ymin_ANT=-150e3, ymax_ANT=150e3,
    maximum_resolution_uniform=50e3, maximum_resolution_grounded_ice=50e3,
    start_time_of_run=0.0, end_time_of_run=0.1,
    nit_Lloyds_algorithm=2, allow_mesh_updates=False,
    visc_it_nit=100, visc_it_norm_dUV_tol=1e-4,
)


def h_ismip(approximation, L_km=160):
    """ISMIP-HOM A at L_km on a 4 x 4 km... mesh of L/4: ismip_hom()
    with the approximation of the harness's file name, one 0.1-year step."""
    approx = {"SIASSA": "SIA/SSA"}.get(approximation, approximation)
    return ismip_hom("A", L=L_km * 1e3, res=L_km * 1e3 / 4,
                     choice_stress_balance_approximation=approx,
                     start_time_of_run=0.0, end_time_of_run=0.1)


# the MISMIP+ configuration above, 0.3 years, as the spin-up stand-in
H_MISMIPPLUS = dict(MISMIPPLUS, refgeo_idealised_MISMIPplus_tune_A=True,
                    start_time_of_run=0.0, end_time_of_run=0.3,
                    dt_coupling=0.1)


STABILITY = ("n_dt_ice", "n_visc_its", "n_Axb_its")


def assert_same_scores(run_t, run_j, rel=1e-10):
    """Two scoreboard runs of the same test: the same name, category and
    cost functions, every value within `rel` of the larger (NaN equal to
    NaN), the stability counters equal."""
    import math
    assert (run_t.name, run_t.category) == (run_j.name, run_j.category)
    ct = {c["name"]: c for c in run_t.cost_functions}
    cj = {c["name"]: c for c in run_j.cost_functions}
    assert list(ct) == list(cj)
    for name, c in ct.items():
        a, b = c["value"], cj[name]["value"]
        assert c["definition"] == cj[name]["definition"]
        if name in STABILITY:
            assert a == b, (name, a, b)
        elif math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (name, a, b)
        else:
            assert abs(a - b) <= rel * max(abs(a), abs(b)), (name, a, b)


def scores(run):
    return {c["name"]: c["value"] for c in run.cost_functions}


# Berends et al. (2023) experiment I's spin-up stand-in: the Halfar dome
# (the target and the initial geometry) on the +-700 km domain of the
# harness's input grid, DIVA with Zoet-Iverson sliding on the till friction
# angle the harness writes, the SMB it writes, nudging every 0.1 years
H_BERENDS_I = dict(
    H_HALFAR, choice_thermo_model="none",
    choice_initial_ice_temperature_ANT="uniform",
    choice_refgeo_PD_ANT="idealised", choice_refgeo_PD_idealised="Halfar",
    choice_stress_balance_approximation="DIVA",
    choice_sliding_law="Zoet-Iverson", choice_SMB_model_ANT="prescribed",
    xmin_ANT=-700e3, xmax_ANT=700e3, ymin_ANT=-700e3, ymax_ANT=700e3,
    visc_it_nit=3, pc_nit_max=2, bed_roughness_nudging_dt=0.1,
    start_time_of_run=0.0)
# experiment II's: the MISMIP+ configuration above with Zoet-Iverson
# sliding, nudging and BMB events every 0.1 years
H_BERENDS_II = dict(MISMIPPLUS, choice_sliding_law="Zoet-Iverson",
                    bed_roughness_nudging_dt=0.1, dt_BMB=0.1,
                    start_time_of_run=0.0)
BERENDS_DIR = "idealised/Berends2023_nudging"
BERENDS_STANDINS = {
    f"{BERENDS_DIR}/experiment_I/config_01_exp_I_spinup_40km_part0.cfg":
        H_BERENDS_I,
    f"{BERENDS_DIR}/experiment_II/config_01_exp_II_spinup_5km.cfg":
        H_BERENDS_II}
