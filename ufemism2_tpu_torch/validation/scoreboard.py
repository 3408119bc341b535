"""Scoreboard: per-test, per-commit records of accuracy cost functions
and solver-effort counters.

Re-design of automated_testing/scoreboard/scripts/ (write_scoreboard_file.m,
initialise_single_test_run.m, add_cost_function_to_single_run.m,
read_stability_info.m): each test run produces one JSON file named
<category>_<name>_<githash>.json holding named cost functions (with their
defining expression) plus the stability counters (n_dt_ice, n_visc_its,
n_Axb_its read from the scalar output), so accuracy AND solver effort are
regression-tracked together.
"""

from __future__ import annotations

import json
import subprocess
from datetime import datetime, timezone
from pathlib import Path

import numpy as np


_ABBREV = [  # filename abbreviations (write_scoreboard_file.m:7-18)
    ("/", "_"), ("component_tests", "ct"), ("integrated_tests", "it"),
    ("discretisation", "disc"), ("mapping_and_derivatives", "map_deriv"),
    ("remapping", "remap"), ("mesh_to_grid", "m2g"),
    ("grid_to_mesh", "g2m"), ("mesh_to_mesh", "m2m"),
    ("idealised", "ideal"), ("Halfar", "Hlf"),
]


def git_hash(short=True) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short" if short else "HEAD", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=Path(__file__).resolve().parents[2])
        h = out.stdout.strip()
        return h if h else "nogit"
    except Exception:
        return "nogit"


class ScoreboardRun:
    """One test run's scoreboard entry."""

    def __init__(self, name: str, category: str):
        self.name = name
        self.category = category
        self.date = datetime.now(timezone.utc).isoformat()
        self.git_hash = git_hash()
        self.cost_functions = []

    def add_cost_function(self, name: str, definition: str, value):
        self.cost_functions.append(
            {"name": name, "definition": definition,
             "value": float(value)})
        return self

    def add_stability_info(self, stab: dict):
        """n_dt_ice / n_visc_its / n_Axb_its counters
        (add_stability_info_cost_functions.m)."""
        for k, definition in (
                ("n_dt_ice", "number of ice-dynamics time steps"),
                ("n_visc_its", "total viscosity iterations"),
                ("n_Axb_its", "total linear-solver iterations")):
            if k in stab:
                self.add_cost_function(k, definition, stab[k])
        return self

    def to_dict(self):
        return {"name": self.name, "category": self.category,
                "date": self.date, "git_hash": self.git_hash,
                "cost_functions": self.cost_functions}

    def write(self, scoreboard_dir) -> Path:
        d = Path(scoreboard_dir)
        d.mkdir(parents=True, exist_ok=True)
        cat = self.category
        for a, b in _ABBREV:
            cat = cat.replace(a, b)
        path = d / f"{cat}_{self.name}_{self.git_hash}.json"
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path

    def summary(self) -> str:
        rows = [f"{self.category}/{self.name}:"]
        for cf in self.cost_functions:
            rows.append(f"  {cf['name']:28s} = {cf['value']:.6g}")
        return "\n".join(rows)


def read_stability_info(scalar_output_path, nskip=0) -> dict:
    """Counters from a scalar output file (read_stability_info.m:1-7):
    the port's NetCDF classic scalar_output_<R>_00001.nc, or a NetCDF4
    one where h5py is installed."""
    from ..io.ncio import NCFile
    with NCFile(scalar_output_path) as nc:
        dt_ice = np.asarray(nc.read("dt_ice"))[nskip:]
        n_visc = np.asarray(nc.read("n_visc_its"))[nskip:]
        n_axb = np.asarray(nc.read("n_Axb_its"))[nskip:]
    return {"n_dt_ice": int(len(dt_ice)),
            "n_visc_its": int(n_visc.sum()),
            "n_Axb_its": int(n_axb.sum())}


def read_scoreboard_dir(scoreboard_dir) -> list:
    """All scoreboard entries in a directory, newest first."""
    entries = []
    for p in sorted(Path(scoreboard_dir).glob("*.json")):
        entries.append(json.loads(p.read_text()))
    entries.sort(key=lambda e: e.get("date", ""), reverse=True)
    return entries
