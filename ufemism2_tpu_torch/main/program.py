"""The program: command-line entry point of the PyTorch/CUDA port.

Re-design of src/UFEMISM/main/UFEMISM_program.f90: run up to four model
regions (NAM/EAS/GRL/ANT) through the coupling loop, with the MISMIP+
flow-factor tuning between coupling intervals, the standalone LADDIE
plume (main/laddie_program.py), or the port's unit tests.

Usage:
    python -m ufemism2_tpu_torch <config.cfg> [--output-dir DIR] [--device cpu]
    python -m ufemism2_tpu_torch laddie <config.cfg> [--output-dir DIR]
        [--device cpu]
    python -m ufemism2_tpu_torch unit_tests

The run writes a copy of the config, run_manifest.json and
resource_tracking.jsonl into the output directory, and each region's
NetCDF files (main_output_<R>_0000N.nc per mesh generation,
main_output_<R>_grid.nc, scalar_output_<R>_00001.nc,
restart_<R>_00001.nc) into <output dir>/<R>/; the regions' scalars are
also kept in each region's `scalars_history` and the final ones printed.
The run is on the card unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time as _time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..models.forcings import GlobalForcings
from ..ops import resolve_device
from ..utils.logging_utils import happy, get_tracker


REGIONS = ["NAM", "EAS", "GRL", "ANT"]


def git_hash(short=True) -> str:
    """The repository's commit, or 'nogit' outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short" if short else "HEAD", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=Path(__file__).resolve().parents[2])
        h = out.stdout.strip()
        return h if h else "nogit"
    except Exception:
        return "nogit"


def write_run_manifest(out_dir, config_path, device):
    """Run manifest: git commit, library versions and the device, the
    reference's pre-compile stamping (git_commit_hash_and_package_versions
    .f90, compile_UFEMISM.csh:73-78) done at run time instead."""
    versions = {}
    for mod in ("torch", "numpy", "scipy"):
        try:
            versions[mod] = __import__(mod).__version__
        except Exception:
            versions[mod] = "unavailable"
    versions["cuda"] = torch.version.cuda or "unavailable"
    device = torch.device(device)
    manifest = {
        "git_hash": git_hash(short=False),
        "config": str(config_path),
        "started": _time.strftime("%Y-%m-%dT%H:%M:%S"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "versions": versions,
        "devices": [torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)],
    }
    (Path(out_dir) / "run_manifest.json").write_text(
        json.dumps(manifest, indent=1))


def _write_resource_record(out: Path, t: float):
    """Append one coupling interval's per-routine wall times to
    <out>/resource_tracking.jsonl and reset the tracker (the reference
    writes its resource NetCDF and resets each coupling interval,
    netcdf_resource_tracking.f90:26-149)."""
    tr = get_tracker()
    rec = {"t": float(t), "routines": tr.as_dict()}
    with open(out / "resource_tracking.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
    tr.reset()


def run_model(config_path: str, output_dir: str | None = None,
              device="cuda"):
    """Run the regions the config enables to its end time; returns them
    by name."""
    from .region import ModelRegion

    device = resolve_device(device)
    C = load_config(config_path)
    if C.dt_coupling <= 0.0:
        raise ValueError(f"dt_coupling must be positive, got "
                         f"{C.dt_coupling}")
    if output_dir is None:
        if C.create_procedural_output_dir:
            stamp = _time.strftime("%Y%m%d")
            n = 1
            while Path(f"results_{stamp}_{n:03d}").exists():
                n += 1
            output_dir = f"results_{stamp}_{n:03d}"
        else:
            output_dir = C.fixed_output_dir or "results"
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    # copy the config into the output dir (the reference does the same)
    (out / Path(config_path).name).write_text(Path(config_path).read_text())
    write_run_manifest(out, config_path, device)

    forcings = GlobalForcings(C)

    regions = {}
    for name in REGIONS:
        if getattr(C, f"do_{name}"):
            happy("Initialising model region {} ...", name)
            regions[name] = ModelRegion(C, name, output_dir=str(out / name),
                                        device=device)

    if not regions:
        print("No regions enabled in config (do_NAM/EAS/GRL/ANT).")
        return {}

    # the coupling loop (UFEMISM_program.f90:99-129)
    t = C.start_time_of_run
    Hs_cur = 1.0
    while t < C.end_time_of_run - 1e-9:
        t_next = min(t + C.dt_coupling, C.end_time_of_run)
        forcings.update(t)
        # plumb the global sea level into every region
        # (update_sealevel_at_model_time, UFEMISM_main_model.f90)
        if forcings.choice_sealevel != "fixed" \
                or forcings.sealevel != 0.0:
            for region in regions.values():
                region.set_sealevel(forcings.sealevel)
        for name, region in regions.items():
            happy("  Running region {} to t = {:.1f} yr ...", name, t_next)
            region.run_to(t_next)
        t = t_next
        # per-coupling-interval resource-tracking record + reset
        _write_resource_record(out, t)

        # MISMIP+ flow-factor tuning for the GL position
        # (UFEMISM_program.f90:114-123)
        if C.refgeo_idealised_MISMIPplus_tune_A and "ANT" in regions:
            Hs_prev = Hs_cur
            Hs_cur = float(regions["ANT"].state.Hs.max())
            if abs(1.0 - Hs_cur / Hs_prev) < 5.0e-3:
                C = mismipplus_adapt_flow_factor(C, regions["ANT"])

    for name, region in regions.items():
        region.write_output()
        happy("Region {}: {} ice-dynamics steps, final scalars: {}",
              name, region.n_dt_ice,
              region.scalars_history[-1] if region.scalars_history else {})

    print(get_tracker().report())
    return regions


def mismipplus_x_GL(C, region):
    """The mid-channel (y = 0) grounding line [m]: the first sign change
    of the thickness above flotation on a line sampled every
    maximum_resolution_grounding_line; None without one."""
    from scipy.interpolate import LinearNDInterpolator
    mesh = region.mesh
    TAF = region.state.TAF.double().cpu().numpy()
    interp = LinearNDInterpolator(mesh.V, TAF, fill_value=-1.0)
    dx = C.maximum_resolution_grounding_line
    xs = np.arange(mesh.xmin, mesh.xmax + dx / 2, dx)
    taf_line = interp(np.column_stack([xs, np.zeros_like(xs)]))
    sign_change = np.flatnonzero((taf_line[:-1] > 0) & (taf_line[1:] <= 0))
    if len(sign_change) == 0:
        return None
    i = sign_change[0]
    lam = taf_line[i] / (taf_line[i] - taf_line[i + 1])
    return (1 - lam) * xs[i] + lam * xs[i + 1]


def mismipplus_adapt_flow_factor(C, region):
    """Tune the uniform Glen flow factor so the steady-state mid-channel
    grounding line sits at x = 450 km
    (inversion_utilities.f90 MISMIPplus_adapt_flow_factor: 92-140).
    The new factor goes into the region's glen_A_scale slot, which the
    rheology reads at every solve (ModelRegion registers it whenever the
    tuning is on), so the step is not rebuilt. Returns the config,
    unchanged, also where there is no grounding line to tune for."""
    if C.choice_ice_rheology_Glen != "uniform":
        raise RuntimeError(
            "MISMIP+ flow-factor tuning needs a uniform flow factor")
    x_GL = mismipplus_x_GL(C, region)
    if x_GL is None:
        return C

    # The reference's raw proportional controller
    # (f = 2^((x_GL-450km)/80km), inversion_utilities.f90:135) has gain
    # ~2x per adaptation and makes the GL oscillate around the target;
    # the fixed point - the A for which the steady GL sits at 450 km - is
    # unchanged by the gain, so damp bisection-style: halve the exponent
    # gain every time the error changes sign, restore it slowly while the
    # sign persists.
    err = x_GL - 450e3
    tune = getattr(region, "_mismip_tune", None)
    if tune is None:
        tune = region._mismip_tune = {"gain": 1.0, "last_err": None}
    if tune["last_err"] is not None and err * tune["last_err"] < 0:
        tune["gain"] = max(0.125, tune["gain"] * 0.5)
    elif tune["last_err"] is not None:
        tune["gain"] = min(1.0, tune["gain"] * 1.1)
    tune["last_err"] = err
    f = 2.0 ** (tune["gain"] * err / 80000.0)
    # the rheology reads C.uniform_Glens_flow_factor * glen_A_scale
    e = region.md.extras["glen_A_scale"]
    e.arr = e.arr * f
    happy("    MISMIPplus_adapt_flow_factor: x_GL = {:.1f} km; "
          "flow factor -> {:.3e}", x_GL / 1e3,
          C.uniform_Glens_flow_factor * float(e.arr))
    return C


def main(argv=None):
    p = argparse.ArgumentParser(prog="ufemism2_tpu_torch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("config", help="path to a .cfg namelist, 'laddie' (the "
                   "standalone plume; its config follows) or 'unit_tests' "
                   "(component_tests and integrated_tests are not ported "
                   "yet)")
    p.add_argument("laddie_config", nargs="?", default=None,
                   help="config path when the first argument is 'laddie'")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; "
                   "'cpu' only when asked for)")
    args = p.parse_args(argv)

    if args.config == "unit_tests":
        import pytest
        tests = Path(__file__).resolve().parents[2] / "tests"
        sys.exit(pytest.main(["-x", "-q"] + sorted(
            str(f) for f in tests.glob("test_torch_*.py"))))
    if args.config in ("component_tests", "integrated_tests",
                       "integrated_tests_full"):
        raise NotImplementedError(
            f"'{args.config}': the validation harness is not ported yet "
            "(ROADMAP A.20)")
    if args.config == "laddie":
        if not args.laddie_config:
            p.error("'laddie' needs the path of a config")
        from .laddie_program import run_laddie_standalone
        return run_laddie_standalone(args.laddie_config, args.output_dir,
                                     device=args.device)
    return run_model(args.config, args.output_dir, device=args.device)
