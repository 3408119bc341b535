"""upsy-diagnose-run equivalent: inspect a run's output directory.

Re-design of tools/python/upsy/__main__.py: list the output variables,
meshes and times, print the final timeframe's field ranges and the last
scalar values."""

from __future__ import annotations

import argparse

from .run import Run


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="upsy-diagnose-run",
        description="Diagnose a run directory of the port, the JAX "
                    "package or the reference")
    p.add_argument("rundir", help="run output directory")
    p.add_argument("--region", default=None)
    args = p.parse_args(argv)

    run = Run(args.rundir)
    print(run)
    print(f"model: {run.model}")
    for i in range(run.n_meshes):
        mo = run.get_mesh(i, region=args.region)
        print(f"mesh {i}: nV={mo.nV} nTri={mo.nTri} "
              f"nt={len(mo.time)} vars={mo.variables}")
    if run.n_meshes:
        print(run.get_mesh(-1, region=args.region).timeframe(-1).summary())
    scal = run.scalars(region=args.region)
    if scal:
        print("final scalars:")
        for k, v in scal.items():
            if len(v):
                print(f"  {k:20s} = {float(v[-1]):.6g}")


if __name__ == "__main__":
    main()
