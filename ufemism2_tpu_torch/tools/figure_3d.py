"""upsy-plot-3dfigure equivalent: vertical cross-sections of 3-D fields.

Re-design of tools/python/upsy/figure_3d.py: sample a 3-D output
variable (u_3D/v_3D/w_3D/Ti...) along a transect polyline, build the
physical depth grid from Hs/Hi and the zeta coordinate, and render the
filled section (distance x elevation) with the ice surface/base and
bedrock drawn on top."""

from __future__ import annotations

import argparse

import numpy as np

from .run import Run, MeshOutput

NAMED_TRANSECTS = {
    # fractional (x, y) endpoints of the domain bounding box
    "westeast": ((0.0, 0.5), (1.0, 0.5)),
    "southnorth": ((0.5, 0.0), (0.5, 1.0)),
}


def _interp_a(mo: MeshOutput, d, pts_km):
    """Linear interpolation of an a-grid field at [n,2] km points."""
    import matplotlib.tri as mtri
    tri = mtri.Triangulation(mo.V[:, 0] / 1e3, mo.V[:, 1] / 1e3, mo.Tri)
    out = np.empty((len(pts_km),) + d.shape[1:])
    if d.ndim == 1:
        f = mtri.LinearTriInterpolator(tri, d)
        return np.asarray(f(pts_km[:, 0], pts_km[:, 1]).filled(np.nan))
    for k in range(d.shape[1]):
        f = mtri.LinearTriInterpolator(tri, d[:, k])
        out[:, k] = f(pts_km[:, 0], pts_km[:, 1]).filled(np.nan)
    return out


def _sample_b(mo: MeshOutput, d, pts_km):
    """Nearest-triangle sampling of a b-grid field at [n,2] km points."""
    from scipy.spatial import cKDTree
    gc = mo.V[mo.Tri].mean(axis=1) / 1e3
    _, ti = cKDTree(gc).query(pts_km)
    return d[ti]


def transect_points(mo: MeshOutput, spec, dx_km=2.0):
    """[n,2] km sample points from 'x0,y0,x1,y1' (km) or a named
    transect."""
    if spec in NAMED_TRANSECTS:
        (fx0, fy0), (fx1, fy1) = NAMED_TRANSECTS[spec]
        x0, x1 = mo.V[:, 0].min() / 1e3, mo.V[:, 0].max() / 1e3
        y0, y1 = mo.V[:, 1].min() / 1e3, mo.V[:, 1].max() / 1e3
        p0 = (x0 + fx0 * (x1 - x0), y0 + fy0 * (y1 - y0))
        p1 = (x0 + fx1 * (x1 - x0), y0 + fy1 * (y1 - y0))
    else:
        a = [float(v) for v in spec.split(",")]
        p0, p1 = (a[0], a[1]), (a[2], a[3])
    p0, p1 = np.asarray(p0), np.asarray(p1)
    L = float(np.linalg.norm(p1 - p0))
    n = max(int(L / dx_km) + 1, 2)
    s = np.linspace(0.0, 1.0, n)
    return p0[None, :] + s[:, None] * (p1 - p0)[None, :], s * L


def plot_transect_3d(mo: MeshOutput, var, spec="westeast", ti=-1,
                     ax=None, cmap="RdBu_r", vmin=None, vmax=None):
    """Filled section of a 3-D variable along a transect."""
    import matplotlib.pyplot as plt

    pts, dist = transect_points(mo, spec)
    d = mo.read(var, ti)
    zeta = np.asarray(mo.read("zeta"))
    if d.shape[0] == mo.nV:
        sec = _interp_a(mo, d, pts)                 # [n, nz]
    else:
        sec = _sample_b(mo, d, pts)
    Hi = _interp_a(mo, mo.read("Hi", ti), pts)
    Hs = _interp_a(mo, mo.read("Hs", ti), pts)
    Hb = _interp_a(mo, mo.read("Hb", ti), pts)
    z = Hs[:, None] - zeta[None, :] * Hi[:, None]   # [n, nz] elevation

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    D = np.broadcast_to(dist[:, None], z.shape)
    ice = Hi > 0.1
    sec_m = np.where(ice[:, None], sec, np.nan)
    pc = ax.pcolormesh(D, z, sec_m, shading="gouraud", cmap=cmap,
                       vmin=vmin, vmax=vmax)
    ax.plot(dist, Hb, color="saddlebrown", lw=1.5, label="bedrock")
    ax.plot(dist, np.where(ice, Hs, np.nan), color="k", lw=1.0)
    ax.plot(dist, np.where(ice, Hs - Hi, np.nan), color="k", lw=1.0)
    ax.set_xlabel("distance along transect [km]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"{var} ({spec})")
    plt.colorbar(pc, ax=ax, shrink=0.8)
    return ax


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="upsy-plot-3dfigure",
        description="Plot a vertical cross-section of a 3-D output field")
    p.add_argument("rundir")
    p.add_argument("var", help="3-D variable (u_3D, v_3D, w_3D, ...)")
    p.add_argument("--transect", default="westeast",
                   help="named transect or 'x0,y0,x1,y1' in km")
    p.add_argument("--mesh", type=int, default=-1)
    p.add_argument("--ti", type=int, default=-1)
    p.add_argument("--region", default=None)
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)

    import matplotlib
    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    run = Run(args.rundir)
    mo = run.get_mesh(args.mesh, region=args.region)
    plot_transect_3d(mo, args.var, args.transect, ti=args.ti)
    if args.output:
        plt.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
