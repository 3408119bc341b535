"""upsy-plot-2dfigure equivalent: plot mesh output fields.

Re-design of tools/python/upsy/figure.py: render an a-grid (tripcolor
over vertices) or b-grid (flat per-triangle) field at a chosen timeframe,
with optional grounding-line overlay. matplotlib is imported lazily (it
is an optional dependency, pyproject [plot])."""

from __future__ import annotations

import argparse

import numpy as np

from .run import Run


def plot_field(mesh_output, var, ti=-1, ax=None, cmap="viridis",
               show_gl=True, vmin=None, vmax=None):
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 7))
    tri = mtri.Triangulation(mesh_output.V[:, 0] / 1e3,
                             mesh_output.V[:, 1] / 1e3,
                             mesh_output.Tri)
    d = mesh_output.read(var, ti)
    if d.shape[0] == mesh_output.nV:
        pc = ax.tripcolor(tri, d, shading="gouraud", cmap=cmap,
                          vmin=vmin, vmax=vmax)
    else:
        pc = ax.tripcolor(tri, facecolors=d, cmap=cmap,
                          vmin=vmin, vmax=vmax)
    if show_gl and "Hi" in mesh_output.variables:
        gl = mesh_output.grounding_line_mask(ti)
        if gl.any():
            ax.plot(mesh_output.V[gl, 0] / 1e3, mesh_output.V[gl, 1] / 1e3,
                    ".", ms=2, color="magenta", label="grounding line")
    ax.set_xlabel("x [km]")
    ax.set_ylabel("y [km]")
    ax.set_aspect("equal")
    ax.set_title(var)
    import matplotlib.pyplot as plt
    plt.colorbar(pc, ax=ax, shrink=0.8)
    return ax


def main_2d(argv=None):
    p = argparse.ArgumentParser(
        prog="upsy-plot-2dfigure",
        description="Plot a 2-D field from a run's mesh output")
    p.add_argument("rundir")
    p.add_argument("var")
    p.add_argument("--mesh", type=int, default=-1)
    p.add_argument("--ti", type=int, default=-1)
    p.add_argument("--region", default=None)
    p.add_argument("-o", "--output", default=None,
                   help="write PNG here instead of showing")
    args = p.parse_args(argv)

    import matplotlib
    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    run = Run(args.rundir)
    mo = run.get_mesh(args.mesh, region=args.region)
    plot_field(mo, args.var, ti=args.ti)
    if args.output:
        plt.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main_2d()
