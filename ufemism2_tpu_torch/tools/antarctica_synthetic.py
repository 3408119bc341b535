"""Synthetic realistic-format Antarctica input data, written as NetCDF
classic through the port's own writer (no h5py needed).

    python -m ufemism2_tpu_torch.tools.antarctica_synthetic DIR [--dx M]

The reference's realistic Antarctica tests read BedMachine, RACMO,
Shapiro-Ritzwoller and thinning-rate files that are not in the repository.
`make_geometry` and the first five files of `write_all` are the port's copy
of the repository's generator (tools/gen_antarctica_synthetic.py; the same
seeded arrays, the same file layouts and names): an Antarctica-like
continent with an East-Antarctic Vialov dome on an elevated bed, a marine
West-Antarctic sector and two ice-shelf embayments, on a square x/y grid
written as ("x", "y"), with

  - topography:  BedMachine names 'bed', 'surface', 'thickness';
  - climate:     a RACMO-style monthly snapshot (Hs, T2m[12], Precip[12]);
  - SMB:         'SMB' [m ice/yr], no time dimension;
  - thinning:    'dHdt' [m/yr];
  - geothermal:  a global lon/lat 'hflux' [W m^-2].

The other files, as synthetic and seeded as those (none is data), are the
inputs of the climate chain:

  - insolation:  Laskar layout, Q_TOA [time, month, lon, lat] [W m^-2],
                 a polar seasonal cycle and annual mean varying slowly
                 with time;
  - dT_atm:      a dT_atmosphere [K] series;
  - GI:          a glacial-index series for the GlacialIndex LMB;
  - CO2:         a CO2 [ppm] series for the matrix climate;
  - clim_anom:   monthly T2m_anomaly and Precip_anomaly, three frames;
  - SMB_anom:    SMB_anomaly [m ice/yr], three frames;
  - PI, warm, cold: GCM-style snapshots with winds (Hs, T2m, Precip,
                 Wind_WE, Wind_SN); the cold one a larger, colder and
                 drier ice sheet.

Every file goes into the directory the caller names; `ensure_data` writes
them into DATA_DIR (the repository's git-ignored validation_runs/, a
directory of the port's own beside the JAX generator's) unless the five
files of the realistic initialisation are there already.
"""

import argparse
import os
from pathlib import Path

import numpy as np

from ..io.ncio import NCFile
from ..utils.constants import ice_density, seawater_density

DATA_DIR = Path(__file__).resolve().parents[2] / "validation_runs" / \
    "ant_data_classic"

XMIN, XMAX = -3040e3, 3040e3
S0 = 3900.0          # [m] dome summit surface elevation
N_GLEN = 3.0

NAMES = {"topo": "BedMachine_Antarctica_synthetic.nc",
         "climate": "RACMO_Antarctica_synthetic_clim.nc",
         "SMB": "RACMO_Antarctica_synthetic_SMB.nc",
         "dHdt": "dHdt_Antarctica_synthetic.nc",
         "ghf": "ShapiroRitzwoller_synthetic_global.nc",
         "insolation": "Laskar_insolation_synthetic.nc",
         "dT_atm": "dT_atmosphere_synthetic.nc",
         "GI": "glacial_index_synthetic.nc",
         "CO2": "CO2_record_synthetic.nc",
         "clim_anom": "climate_anomalies_synthetic.nc",
         "SMB_anom": "SMB_anomalies_synthetic.nc",
         "PI": "GCM_snapshot_PI_synthetic.nc",
         "warm": "GCM_snapshot_warm_synthetic.nc",
         "cold": "GCM_snapshot_cold_synthetic.nc"}


def _smooth_noise(shape, rng, sigma_cells, amp):
    """Deterministic smooth random field (Gaussian-filtered white
    noise)."""
    from scipy.ndimage import gaussian_filter
    f = gaussian_filter(rng.standard_normal(shape), sigma_cells)
    return amp * f / max(np.abs(f).max(), 1e-12)


def make_geometry(dx=20e3):
    """(x, y, Hb, Hs, Hi): the Antarctica-like synthetic geometry, each
    field [x, y]."""
    x = np.arange(XMIN, XMAX + dx / 2, dx)
    y = np.arange(XMIN, XMAX + dx / 2, dx)
    X, Y = np.meshgrid(x, y, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2)
    th = np.arctan2(Y, X)
    rng = np.random.default_rng(20260819)

    # grounded-margin radius: a wobbly continent outline
    Rm = (1750e3 + 260e3 * np.sin(2 * th + 1.0)
          + 140e3 * np.sin(5 * th - 0.4) + 90e3 * np.sin(3 * th + 2.2))

    # bed: an elevated East-Antarctic plateau, a marine West-Antarctic
    # sector, a continental shelf dropping to the abyssal plain outside
    west = 0.5 * (1 + np.tanh((np.cos(th - 2.6) - 0.35) / 0.18))
    Hb = (500.0 - 900.0 * (r / 2200e3) ** 2
          + _smooth_noise(X.shape, rng, 6.0, 450.0)
          - 1400.0 * west * np.exp(-((r - 900e3) / 700e3) ** 2))
    beyond = np.maximum(0.0, r - Rm)
    Hb = Hb - 2800.0 * np.minimum(1.0, beyond / 600e3) ** 1.5
    Hb = np.maximum(Hb, -3600.0)

    # a Vialov profile surface inside the margin
    p = 1.0 + 1.0 / N_GLEN
    q = N_GLEN / (2.0 * N_GLEN + 2.0)
    s_vialov = S0 * np.maximum(0.0, 1.0 - (r / Rm) ** p) ** q

    # two shelf embayments (Ross and Filchner-Ronne analogues): floating
    # tongues past the grounded margin
    shelf = np.zeros_like(r)
    for th0, w, L in ((-2.0, 0.35, 420e3), (2.9, 0.30, 380e3)):
        dth = np.arctan2(np.sin(th - th0), np.cos(th - th0))
        sector = np.exp(-(dth / w) ** 2)
        ext = (r > 0.82 * Rm) & (r < Rm + L) & (sector > 0.3)
        Hi_sh = 900.0 * np.exp(-np.maximum(0.0, r - 0.82 * Rm) / 260e3)
        shelf = np.where(ext, np.maximum(shelf, Hi_sh * sector), shelf)

    # grounded where the Vialov column does not float
    rho = ice_density / seawater_density
    Hi_grounded = np.maximum(0.0, s_vialov - Hb)
    floats = Hi_grounded * ice_density < -np.minimum(Hb, 0.0) \
        * seawater_density
    Hi = np.where(r < Rm, np.where(floats, s_vialov / (1.0 - rho),
                                   Hi_grounded), 0.0)
    Hi = np.maximum(Hi, shelf)
    # the consistent surface
    floats = Hi * ice_density < -np.minimum(Hb, 0.0) * seawater_density
    Hs = np.where(floats, Hi * (1.0 - rho), Hi + Hb)
    Hi = np.where(Hi < 5.0, 0.0, Hi)
    Hs = np.where(Hi == 0.0, np.maximum(Hb, 0.0), Hs)
    return x, y, Hb, Hs, Hi


def _series_file(path, name, t, v):
    with NCFile(path, "w") as nc:
        nc.def_dim("time", len(t))
        nc.def_var("time", ("time",))
        nc.put("time", np.asarray(t, dtype=np.float64))
        nc.def_var(name, ("time",))
        nc.put(name, np.asarray(v, dtype=np.float64))
    return path


def write_all(data_dir, dx=20e3):
    """Write every file into data_dir; returns {key: path} (keys of
    NAMES)."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    x, y, Hb, Hs, Hi = make_geometry(dx)
    X, Y = np.meshgrid(x, y, indexing="ij")
    paths = {k: data_dir / n for k, n in NAMES.items()}

    def xy_file(key, fields, times=None):
        with NCFile(paths[key], "w") as nc:
            nc.def_dim("x", len(x))
            nc.def_dim("y", len(y))
            nc.def_var("x", ("x",))
            nc.put("x", x)
            nc.def_var("y", ("y",))
            nc.put("y", y)
            lead = ()
            if times is not None:
                nc.def_dim("time", len(times))
                nc.def_var("time", ("time",))
                nc.put("time", np.asarray(times, dtype=np.float64))
                lead = ("time",)
            for fname, arr in fields.items():
                if arr.ndim - len(lead) == 3:      # [(time,) 12, nx, ny]
                    if not nc.has("month"):
                        nc.def_dim("month", 12)
                        nc.def_var("month", ("month",))
                        nc.put("month", np.arange(1.0, 13.0))
                    nc.def_var(fname, lead + ("month", "x", "y"))
                else:
                    nc.def_var(fname, lead + ("x", "y"))
                nc.put(fname, arr)

    # 1. topography, BedMachine names
    xy_file("topo", {"bed": Hb, "surface": Hs, "thickness": Hi})

    # 2. a RACMO-style climate snapshot: monthly T2m and Precip, its Hs
    season = 14.0 * np.cos(2 * np.pi * (np.arange(12) + 0.5) / 12.0)
    lat_like = np.sqrt(np.maximum(0.0, 1.0 - (np.hypot(X, Y)
                                              / 3040e3) ** 2))
    T_ann = 273.15 - 18.0 - 0.0085 * Hs - 8.0 * lat_like
    T2m = T_ann[None, :, :] + season[:, None, None]
    # precipitation: a moisture-starved interior, a wetter coast
    # [m w.e./yr]
    P_ann = 0.04 + 1.1 * np.exp(-np.maximum(Hs, 0.0) / 900.0)
    Precip = np.repeat(P_ann[None, :, :] / 12.0, 12, axis=0)
    xy_file("climate", {"Hs": Hs, "T2m": T2m, "Precip": Precip})

    # 3. the prescribed SMB [m ice/yr], no time dimension
    SMB = (P_ann * 1000.0 / ice_density) * 0.9 - 0.02
    xy_file("SMB", {"SMB": SMB})

    # 4. the target thinning rate [m/yr]: modest West-Antarctic thinning
    th = np.arctan2(Y, X)
    west = 0.5 * (1 + np.tanh((np.cos(th - 2.6) - 0.35) / 0.18))
    dHdt = -0.25 * west * (Hi > 0) * np.exp(
        -((np.hypot(X, Y) - 1500e3) / 500e3) ** 2)
    xy_file("dHdt", {"dHdt": dHdt})

    # 5. the geothermal heat flux, global lon/lat [W m^-2]
    lon = np.linspace(0.0, 358.0, 180)
    lat = np.linspace(-90.0, 90.0, 91)
    LON, LAT = np.meshgrid(lon, lat, indexing="ij")
    hflux = (0.054 + 0.012 * np.cos(np.deg2rad(LAT))
             + 0.008 * np.sin(2 * np.deg2rad(LON)) *
             np.cos(np.deg2rad(LAT)))
    with NCFile(paths["ghf"], "w") as nc:
        nc.def_dim("lon", len(lon))
        nc.def_dim("lat", len(lat))
        nc.def_var("lon", ("lon",))
        nc.put("lon", lon)
        nc.def_var("lat", ("lat",))
        nc.put("lat", lat)
        nc.def_var("hflux", ("lon", "lat"))
        nc.put("hflux", hflux)

    # 6. insolation, Laskar layout: a polar seasonal cycle (southern
    # summer in December and January) whose amplitude and annual mean
    # drift with a period of 44 kyr, near obliquity's 41 (the annual mean
    # about 0.5 % between -1000 and 0, 4 % between -21000 and 0). A run
    # from 0 loads the frames from -1000 on and reads the -1000 frame for
    # an orbit at -21000 (models/insolation.py)
    t_ins = np.array([-30000.0, -21000.0, -1000.0, 0.0, 1000.0, 2000.0])
    lon_i = np.arange(0.0, 360.0, 10.0)
    lat_i = np.arange(-90.0, 90.1, 5.0)
    month = np.arange(12)
    cyc = np.cos(2 * np.pi * (month + 0.5) / 12.0)
    Q = (250.0 * (1.0 + 0.04 * np.sin(t_ins / 7000.0 + 0.5))[
        :, None, None, None]
         - 230.0 * np.sin(np.deg2rad(lat_i))[None, None, None, :]
         * cyc[None, :, None, None]
         * (1.0 + 0.03 * np.sin(t_ins / 7000.0))[:, None, None, None]
         + 2.0 * np.cos(np.deg2rad(lon_i))[None, None, :, None])
    Q = np.broadcast_to(np.maximum(Q, 0.0),
                        (len(t_ins), 12, len(lon_i), len(lat_i)))
    with NCFile(paths["insolation"], "w") as nc:
        for d, v in (("time", t_ins), ("month", month + 1.0),
                     ("lon", lon_i), ("lat", lat_i)):
            nc.def_dim(d, len(v))
            nc.def_var(d, (d,))
            nc.put(d, v)
        nc.def_var("Q_TOA", ("time", "month", "lon", "lat"))
        nc.put("Q_TOA", np.ascontiguousarray(Q))

    # 7-9. the series: a warming dT_atmosphere, a glacial index, CO2
    _series_file(paths["dT_atm"], "dT_atmosphere",
                 [-1000.0, 0.0, 50.0, 100.0, 200.0, 1000.0],
                 [-0.5, 0.0, 0.2, 0.5, 1.2, 3.0])
    _series_file(paths["GI"], "GI", [-1000.0, 0.0, 100.0, 200.0, 1000.0],
                 [0.9, 0.6, 0.4, 0.3, 0.0])
    _series_file(paths["CO2"], "CO2",
                 [-30000.0, -21000.0, -1000.0, 0.0, 100.0, 1000.0],
                 [230.0, 190.0, 275.0, 280.0, 300.0, 400.0])

    # 10. monthly climate anomalies, three frames, growing in time
    t_anom = np.array([0.0, 100.0, 200.0])
    k = np.arange(3.0)[:, None, None, None]
    dT = k * 0.8 * (1.0 + 0.2 * cyc)[None, :, None, None] \
        * (1.0 + 0.3 * lat_like)[None, None]
    dP = k * 0.002 * np.exp(-np.maximum(Hs, 0.0) / 1500.0)[None, None] \
        * np.ones((1, 12, 1, 1))
    xy_file("clim_anom", {"T2m_anomaly": dT, "Precip_anomaly": dP},
            times=t_anom)

    # 11. SMB anomalies: thinning accumulation on the low ice
    dS = -np.arange(3.0)[:, None, None] * 0.05 \
        * np.exp(-np.maximum(Hs, 0.0) / 1200.0)[None]
    xy_file("SMB_anom", {"SMB_anomaly": dS}, times=t_anom)

    # 12-14. GCM snapshots with winds: PI (a warm, wet bias against the
    # RACMO-style climate), warm (PI plus 1.5 K) and cold (a thicker ice
    # sheet reaching the shelf break, 9 K colder, drier)
    rng = np.random.default_rng(20261017)
    wind_WE = 6.0 + 2.0 * cyc[:, None, None] \
        + _smooth_noise(X.shape, rng, 4.0, 1.5)[None]
    wind_SN = -3.0 * lat_like[None] * (1.0 + 0.1 * cyc[:, None, None])
    base = dict(Hs=Hs, T2m=T2m + 0.5, Precip=Precip * 1.1,
                Wind_WE=wind_WE, Wind_SN=wind_SN)
    xy_file("PI", base)
    xy_file("warm", dict(base, T2m=base["T2m"] + 1.5))
    Hs_cold = np.where(Hs > 0.0, Hs + 300.0 * np.sqrt(lat_like), Hs)
    xy_file("cold", dict(base, Hs=Hs_cold,
                         T2m=base["T2m"] - 9.0 - 0.0085 * (Hs_cold - Hs),
                         Precip=base["Precip"] * 0.6))
    return paths


INIT_KEYS = ("topo", "climate", "SMB", "dHdt", "ghf")


def ensure_data(dx=20e3, data_dir=None):
    """The synthetic dataset in data_dir (DATA_DIR by default), written
    only if one of the realistic initialisation's five files is absent;
    returns {key: path} (the five keys, and all of NAMES when written)."""
    data_dir = Path(DATA_DIR if data_dir is None else data_dir)
    if all((data_dir / NAMES[k]).exists() for k in INIT_KEYS):
        return {k: data_dir / NAMES[k] for k in INIT_KEYS}
    return write_all(data_dir, dx)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--dx", type=float, default=20e3)
    args = ap.parse_args(argv)
    for k, v in write_all(args.data_dir, args.dx).items():
        print(f"{k}: {v} ({os.path.getsize(v) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
