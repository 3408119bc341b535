"""Run / MeshOutput / Timeframe: post-processing access to model output.

Re-design of tools/python/upsy/run.py + mesh.py: a Run scans an output
directory for per-region mesh output files (main_output_<R>_XXXXX.nc),
scalar series and restart files; MeshOutput wraps one mesh generation
with its geometry and fields; Timeframe slices one output time.

Files are read through the port's io/ncio.py: the port's NetCDF classic
output (main_output_ANT_00001.nc, scalar_output_ANT_00001.nc,
restart_ANT_00001.nc in <output dir>/ANT/) needs only scipy, the JAX
package's NetCDF4 output needs h5py as well.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..io.ncio import NCFile


class Run:
    """A model run's output directory."""

    def __init__(self, rundir):
        self.dir = Path(rundir)
        if not self.dir.exists():
            raise FileNotFoundError(self.dir)
        self.mesh_files = sorted(self.dir.glob("main_output_*_0*.nc"))
        self.scalar_files = sorted(self.dir.glob("scalar_output_*.nc"))
        self.transect_files = sorted(self.dir.glob("transect_*.nc"))
        self.restart_files = sorted(self.dir.glob("restart_*.nc"))
        self.regions = sorted({m.group(1) for f in self.mesh_files
                               if (m := re.match(
                                   r"main_output_(\w{3})_\d+",
                                   f.stem))})
        self.model = "LADDIE" if any(
            "laddie" in f.stem.lower() for f in self.dir.glob("*.nc")) \
            else "UFEMISM"

    def __repr__(self):
        return (f"Run({self.dir}, regions={self.regions}, "
                f"{len(self.mesh_files)} mesh files)")

    @property
    def n_meshes(self):
        return len(self.mesh_files)

    def get_mesh(self, mesh_number=0, region=None):
        files = [f for f in self.mesh_files
                 if region is None or f"_{region}_" in f.name]
        return MeshOutput(files[mesh_number])

    def variables(self, mesh_number=0):
        return self.get_mesh(mesh_number).variables

    def scalars(self, region=None):
        """dict of scalar time series from the scalar output file."""
        files = [f for f in self.scalar_files
                 if region is None or f"_{region}_" in f.name]
        if not files:
            return {}
        with NCFile(str(files[0])) as nc:
            return {v: nc.read(v) for v in nc.variables() + ["time"]
                    if nc.has(v)}


class MeshOutput:
    """One mesh-generation output file."""

    def __init__(self, path):
        self.path = Path(path)
        with NCFile(str(self.path)) as nc:
            self.V = nc.read("V")
            self.Tri = np.asarray(nc.read("Tri"), dtype=np.int64)
            if self.Tri.min() >= 1:
                self.Tri = self.Tri - 1
            self.time = nc.read("time") if nc.has("time") else np.array([])
            self.variables = [v for v in nc.variables()
                              if v not in ("V", "Tri", "TriGC", "A", "R",
                                           "zeta", "time")]

    @property
    def nV(self):
        return len(self.V)

    @property
    def nTri(self):
        return len(self.Tri)

    def timeframe(self, ti=-1):
        return Timeframe(self, ti)

    def read(self, var, ti=None):
        with NCFile(str(self.path)) as nc:
            data = nc.read(var)
        if ti is not None and data.ndim >= 1 \
                and data.shape[0] == len(self.time):
            return data[ti]
        return data

    def grounding_line_mask(self, ti=-1):
        """Vertices on the grounded side of the grounding line."""
        Hi = self.read("Hi", ti)
        Hb = self.read("Hb", ti)
        SL = self.read("SL", ti) if "SL" in self.variables \
            else np.zeros_like(Hi)
        taf = Hi - np.maximum(0.0, (SL - Hb) * 1028.0 / 910.0)
        grounded = (taf > 0) & (Hi > 0.1)
        nbr_float = np.zeros_like(grounded)
        for k in range(3):
            np.logical_or.at(nbr_float, self.Tri[:, k],
                             ~grounded[self.Tri[:, (k + 1) % 3]])
        return grounded & nbr_float


class Timeframe:
    def __init__(self, mesh_output: MeshOutput, ti=-1):
        self.mo = mesh_output
        self.ti = ti
        self.t = float(mesh_output.time[ti]) if len(mesh_output.time) \
            else float("nan")

    def get_data(self, var):
        return self.mo.read(var, self.ti)

    def summary(self):
        rows = [f"t = {self.t:.2f} yr ({self.mo.path.name})"]
        for v in self.mo.variables:
            d = self.get_data(v)
            rows.append(f"  {v:16s} min={np.nanmin(d):12.4g} "
                        f"max={np.nanmax(d):12.4g}")
        return "\n".join(rows)
