"""Integrated tests: full-model runs driven by the reference's own config
files, scored with the reference's cost functions.

Re-design of automated_testing/integrated_tests/idealised/
(Halfar_dome, SSA_icestream, ISMIP-HOM, MISMIPplus analyse_*.m): each
runner executes the model from a config, computes the published cost
functions (RMSE vs analytic solutions, grounding-line position bands) and
the stability counters, and writes a scoreboard JSON. `quick=True`
coarsens resolution / shortens the run for CI-speed smoke scoring;
`quick=False` reproduces the reference's exact configuration.

Every runner takes `device` (default the card) and runs its regions
there. The reference's configs are read from REF_TESTS, MISMIP_MOD_DIR
and ANT_CFG (module constants: the reference's checkout, where the JAX
package reads them); a caller with the configs elsewhere, such as a
directory of stand-ins in the reference's layout, sets these attributes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import torch

from .scoreboard import ScoreboardRun

# the reference repository's checkout, where the JAX package reads it
REFERENCE = Path.home() / "reference"
REF_TESTS = REFERENCE / "automated_testing" / "integrated_tests"


def _load(cfg_path, **overrides):
    from ..config import load_config
    return load_config(str(cfg_path), **overrides)


def _region(C, output_dir=None, device="cuda"):
    from ..main.region import ModelRegion
    return ModelRegion(C, "ANT", output_dir=output_dir, device=device)


def _np(x):
    """A field as a host numpy array (a tensor read from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stability(region):
    # the port keeps the counters on the host: one read of the state's
    s = region.state
    return {"n_dt_ice": int(region.n_dt_ice), "n_visc_its": int(s.n_visc_its),
            "n_Axb_its": int(s.n_Axb_its)}


# ---------------------------------------------------------------------------
# Halfar dome (analyse_integrated_test_Halfar_*.m; reference value
# 13.38 m RMSE at 5 km / 200 yr, BASELINE.md)
# ---------------------------------------------------------------------------

def run_halfar(scoreboard_dir=None, resolution_km=40, quick=False,
               output_dir=None, static=False, adaptive=False,
               device="cuda"):
    """Halfar dome vs the analytical SIA solution. `static=True` runs the
    reference's Halfar_static variant (config_Halfar_static_*.cfg): SMB
    exactly cancels the t=0 thinning rate, so the dome must hold its
    t=0 shape for 2500 yr and is scored against the analytic solution AT
    t=0 (analyse_integrated_test_Halfar_static_5km.m:50-58; reference
    anchors 28.45 m at 5 km).

    `adaptive=True` is an EXTRA (non-reference) tier: the reference's CI
    config pins allow_mesh_updates=.FALSE., so its 5 km ice-front band —
    refined around the t=0 margin — is left behind as the dome spreads
    ~28 km over the 500 yr run, and the margin error grows with the
    local (coarsening) resolution. This variant turns the adaptive
    remeshing ON (everything else identical) so the band follows the
    front; scored under its own name so the faithful-config entry
    remains the parity statement."""
    from ..core.analytical import halfar_H
    stem = "Halfar_static" if static else "Halfar"
    cfg = REF_TESTS / "idealised/Halfar_dome" \
        / f"config_{stem}_{resolution_km}km.cfg"
    over = {}
    if quick:
        over["end_time_of_run"] = 50.0
    if adaptive:
        stem = stem + "_adaptive"
        over["allow_mesh_updates"] = True
    C = _load(cfg, **over)
    r = _region(C, output_dir, device)
    r.run_to(C.end_time_of_run)
    Hi = _np(r.state.Hi)
    t_eval = 0.0 if static else C.end_time_of_run
    Hex = halfar_H(C.uniform_Glens_flow_factor, C.Glens_flow_law_exponent,
                   C.refgeo_idealised_Halfar_H0, C.refgeo_idealised_Halfar_R0,
                   r.mesh.V[:, 0], r.mesh.V[:, 1], t_eval)
    # adaptive runs end on a remeshed vertex set; the analytic field is
    # evaluated on whatever mesh the run ended with, so the comparison
    # stays vertex-for-vertex either way
    rmse = float(np.sqrt(((Hi - Hex) ** 2).mean()))

    run = ScoreboardRun(name=f"{stem}_{resolution_km}km",
                        category="integrated_tests/idealised/Halfar_dome")
    run.add_cost_function("rmse", "sqrt(mean((Hi - Hi_analytical).^2))",
                          rmse)
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


def run_halfar_matrix(scoreboard_dir=None,
                      resolutions=(40, 20, 10, 5), output_dir=None,
                      device="cuda"):
    """All 8 Halfar tiers of the reference's analyse_integrated_test.m
    (dynamic + static x 40/20/10/5 km), resumable: tiers that already
    have a scoreboard entry are skipped when the matrix is run again."""
    import glob as _glob
    runs = []
    tiers = [(res, False, False) for res in resolutions] \
        + [(res, True, False) for res in resolutions] \
        + [(10, False, True), (5, False, True)]   # adaptive extras
    for res, static, adaptive in tiers:
        stem = "Hlf_dome_Halfar" + ("_static" if static else "") \
            + ("_adaptive" if adaptive else "")
        if scoreboard_dir and _glob.glob(str(
                Path(scoreboard_dir) / f"it_ideal_{stem}_{res}km_*.json")):
            print(f"skip {stem} {res}km (scored)", flush=True)
            continue
        run = run_halfar(scoreboard_dir, resolution_km=res,
                         output_dir=output_dir, static=static,
                         adaptive=adaptive, device=device)
        runs.append(run)
        print(run.summary(), flush=True)
    return runs


# ---------------------------------------------------------------------------
# SSA icestream (analyse_integrated_test.m; reference RMSE tiers
# 400.4 / 303.7 / 151.9 / 81.4 m/yr at 32/16/8/4 km)
# ---------------------------------------------------------------------------

SSA_CONFIGS = {32: "config_01_32km.cfg", 16: "config_02_16km.cfg",
               8: "config_03_8km.cfg", 4: "config_04_4km.cfg"}


def run_ssa_icestream(scoreboard_dir=None, resolutions=(32, 16, 8, 4),
                      output_dir=None, device="cuda"):
    from ..core.analytical import schoof_icestream
    from ..models.transects import Transect

    run = ScoreboardRun(name="SSA_icestream",
                        category="integrated_tests/idealised/SSA_icestream")
    if scoreboard_dir:
        # per-tier processes accumulate into ONE entry: merge the cost
        # functions a previous tier's process wrote for this commit
        import glob as _glob
        import json as _json
        prev = _glob.glob(str(Path(scoreboard_dir) /
                              f"*SSA_icestream_{run.git_hash}.json"))
        if prev:
            for cf in _json.loads(Path(prev[0]).read_text(
                    ))["cost_functions"]:
                if not any(c["name"] == cf["name"]
                           for c in run.cost_functions):
                    run.cost_functions.append(cf)
    last_region = None
    for res in resolutions:
        cfg = REF_TESTS / "idealised/SSA_icestream" / SSA_CONFIGS[res]
        C = _load(cfg)
        r = _region(C, output_dir, device)
        # The plastic-till viscosity iteration needs ~500 Picard its x
        # ~90 Krylov its (the config asks for visc_it_nit=5000 at
        # rtol 5e-8). Warm-started passes continue the solve from the
        # persistent solver state (u_vav/visc_*), equivalent to one long
        # solve: the port's solve has no dispatch budget, so its first
        # pass converges and the second, converged on entry, ends the
        # loop (as the JAX package's passes do on the CPU).
        from ..core.ice.pc import make_solve_stress_balance
        _solve = make_solve_stress_balance(
            C, r.md, bedrock_cdfs=r._bedrock_cdfs)
        for _pass in range(8):
            s0 = r.state
            uv, vv, u3, v3, _nvi, nai, aux = _solve(
                r.md, s0.Hi, s0.Hs, s0.Hb, s0.SL, s0.Ti, s0)
            r.state = s0.replace(u_vav_b=uv, v_vav_b=vv,
                                 u_3D_b=u3, v_3D_b=v3, **aux)
            if int(_nvi) <= 1:      # converged on entry to this pass
                break
        r.run_to(C.end_time_of_run)
        last_region = r

        tr = Transect.named(r.mesh, "southnorth", dx=1e3)
        u_3D = _np(r.state.u_3D_b)
        _, u_ort = tr.velocity_components(u_3D, _np(r.state.v_3D_b))
        u_surf = u_ort[:, 0]
        u_an, _ = schoof_icestream(
            C.uniform_Glens_flow_factor, C.Glens_flow_law_exponent,
            C.refgeo_idealised_SSA_icestream_Hi,
            C.refgeo_idealised_SSA_icestream_dhdx,
            C.refgeo_idealised_SSA_icestream_L,
            C.refgeo_idealised_SSA_icestream_m,
            tr.points[:, 1])
        rmse = float(np.sqrt(((u_surf - u_an) ** 2).mean()))
        print(f"[ssa] {res} km: RMSE(u_surf) = {rmse:.1f} m/yr "
              f"(nV={r.mesh.nV})", flush=True)
        run.cost_functions = [c for c in run.cost_functions
                              if c["name"] != f"RMSE_{res}km"]
        run.add_cost_function(f"RMSE_{res}km",
                              "sqrt( mean( (u_surf - u_an).^2 ))", rmse)
        if scoreboard_dir:
            # incremental write: a crash mid-matrix keeps the finished
            # resolutions on the scoreboard
            run.write(scoreboard_dir)
    run.add_stability_info(_stability(last_region))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# ISMIP-HOM (analyse_integrated_test_ISMIP_HOM_*.m). The reference scores
# against the Pattyn et al. (2008) ensemble data, which ships outside the
# repo ('ismip_all'); when an ensemble directory is available pass it as
# ensemble_dir for the banded RMSE, otherwise the u_surf statistics along
# the standard ISMIP-HOM transect (y = L/4) are recorded.
# ---------------------------------------------------------------------------

def _ref_published_rmse(experiment, approximation, L_km):
    """The reference's own published scoreboard values for this ISMIP-HOM
    test (vs the Pattyn 2008 HO ensemble, which is not shipped):
    (mean, min, max) over the committed scoreboard history, or None."""
    import glob as _glob
    import re
    pat = str(REFERENCE / "automated_testing/scoreboard/scoreboard_files"
              / f"it_ideal_ISMIP_HOM_experiment_{experiment}_{approximation}"
              f"_L{L_km:03d}_*.xml")
    vals = []
    for f in _glob.glob(pat):
        txt = Path(f).read_text()
        m = re.search(r"<name>rmse</name>.*?<value>([0-9eE.+-]+)</value>",
                      txt, re.S)
        if m:
            vals.append(float(m.group(1)))
    if not vals:
        return None
    return float(np.mean(vals)), float(np.min(vals)), float(np.max(vals))


def run_ismip_hom(scoreboard_dir=None, experiment="A", L_km=80,
                  approximation="DIVA", output_dir=None,
                  ensemble_dir=None, _return_transect=False,
                  device="cuda"):
    from ..models.transects import Transect
    cfg = REF_TESTS / "idealised/ISMIP-HOM" \
        / f"config_ISMIP_HOM_{experiment}_{L_km}_{approximation}.cfg"
    C = _load(cfg)
    r = _region(C, output_dir, device)
    r.run_to(C.end_time_of_run)

    L = L_km * 1e3
    xt = np.linspace(r.mesh.xmin / 2, r.mesh.xmax / 2, 100)
    yt = np.full_like(xt, r.mesh.ymin / 4)
    tr = Transect(r.mesh, np.stack([xt, yt], 1), "ISMIP-HOM")
    u_surf = tr.sample_triangles(_np(r.state.u_3D_b))[:, 0]

    run = ScoreboardRun(
        name=f"experiment_{experiment}_{approximation}_L{L_km:03d}",
        category="integrated_tests/idealised/ISMIP_HOM")
    run.add_cost_function("u_surf_min", "min u_surf on y=L/4 transect",
                          float(u_surf.min()))
    run.add_cost_function("u_surf_max", "max u_surf on y=L/4 transect",
                          float(u_surf.max()))
    run.add_cost_function("u_surf_mean", "mean u_surf on y=L/4 transect",
                          float(u_surf.mean()))
    ref = _ref_published_rmse(experiment, approximation, L_km)
    if ref is not None:
        # the Pattyn ensemble data is not shipped; record the reference's
        # own published rmse-vs-ensemble as the comparison anchor
        run.add_cost_function("reference_rmse_vs_ensemble_mean",
                              "published reference scoreboard values",
                              ref[0])
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    if _return_transect:
        return run, u_surf
    return run


def run_ismip_hom_matrix(scoreboard_dir=None, experiments=("A", "B", "C",
                                                           "D"),
                         Ls=(5, 10, 20, 40, 80, 160),
                         approximations=("DIVA", "BPA", "SIASSA"),
                         output_dir=None, verbose=True, device="cuda"):
    """The reference's full ISMIP-HOM matrix
    (analyse_integrated_test_ISMIP_HOM_{A..D}.m: 4 experiments x 6 domain
    lengths x 3 approximations). The Pattyn 2008 HO ensemble ships
    outside the reference repo ('external/data/model_ensembles'), so BPA
    - the highest-order model here - plays the ensemble's role: every
    DIVA/SIASSA cell is scored as rmse(u_surf vs BPA) with an explicit
    PASS/FAIL band of 2x the reference's own published
    rmse-vs-ensemble for that cell (the reference's deviation from the
    HO ensemble mean bounds how far a shallower approximation may sit
    from a full higher-order solution of the same problem).

    Transect velocities are persisted as sidecar .npy files so a re-run
    resumes the crosscheck instead of silently skipping it."""
    import glob as _glob
    side_dir = Path(output_dir) if output_dir else \
        Path(__file__).resolve().parents[2] / "validation_runs/ismip_hom"
    side_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for exp in experiments:
        for L in Ls:
            transects = {}
            for approx in approximations:
                side = side_dir / f"u_{exp}_{approx}_L{L:03d}.npy"
                if side.exists() and scoreboard_dir and _glob.glob(str(
                        Path(scoreboard_dir) / f"it_ideal_ISMIP_HOM_"
                        f"experiment_{exp}_{approx}_L{L:03d}_*.json")):
                    # already scored (incremental across re-runs)
                    transects[approx] = np.load(side)
                    if verbose:
                        print(f"skip {exp}/{approx}/L{L:03d} (scored)",
                              flush=True)
                    continue
                run, u = run_ismip_hom(scoreboard_dir, exp, L, approx,
                                       output_dir, _return_transect=True,
                                       device=device)
                np.save(side, u)
                transects[approx] = u
                runs.append(run)
                if verbose:
                    print(run.summary(), flush=True)
            if "BPA" in transects:
                u_ref = transects["BPA"]
                xrun = ScoreboardRun(
                    name=f"experiment_{exp}_crosscheck_L{L:03d}",
                    category="integrated_tests/idealised/ISMIP_HOM")
                n_fail = 0
                for approx, u in transects.items():
                    if approx == "BPA":
                        continue
                    rmse = float(np.sqrt(((u - u_ref) ** 2).mean()))
                    xrun.add_cost_function(
                        f"rmse_{approx}_vs_BPA",
                        "sqrt( mean( (u_surf - u_surf_BPA).^2 ))", rmse)
                    ref = _ref_published_rmse(exp, approx, L)
                    if ref is not None:
                        band = 2.0 * ref[0]
                        ok = rmse <= band
                        n_fail += 0 if ok else 1
                        xrun.add_cost_function(
                            f"pass_{approx}",
                            f"rmse_{approx}_vs_BPA <= 2x reference's "
                            f"published rmse-vs-ensemble ({ref[0]:.2f})",
                            1.0 if ok else 0.0)
                xrun.add_cost_function("n_failed_cells",
                                       "cells outside the 2x band",
                                       float(n_fail))
                runs.append(xrun)
                if scoreboard_dir:
                    xrun.write(scoreboard_dir)
                if verbose:
                    print(xrun.summary(), flush=True)
    return runs


# ---------------------------------------------------------------------------
# MISMIP+ (analyse_integrated_test.m:30-54): grounding-line position
# costs from the westeast transect; bands 450 km (init), [350,420] km
# (after ice1r retreat), wobble bound.
# ---------------------------------------------------------------------------

def _mismip_resume_region(C, output_dir, device="cuda"):
    """(region, resumed) for a MISMIP+ leg: resume from the newest
    restart in output_dir if one exists (the reference gets the same
    robustness from its restart machinery, UFEMISM_main_model.f90)."""
    import glob
    import json
    from ..io.ncio import NCFile
    from ..io.output_files import mesh_from_restart
    from ..main.region import ModelRegion

    restarts = sorted(glob.glob(str(Path(output_dir) / "restart_ANT_*.nc"))
                      + glob.glob(str(Path(output_dir) / "ANT"
                                      / "restart_ANT_*.nc")))
    mesh = None
    resume_path = None
    if restarts:
        # newest restart by recorded time (files cycle per mesh update)
        def _rt(p):
            try:
                with NCFile(p) as nc:
                    return float(np.asarray(nc.read("time")).reshape(-1)[0])
            except Exception:
                return -np.inf
        resume_path = max(restarts, key=_rt)
        t_res = _rt(resume_path)
        if np.isfinite(t_res) and t_res > C.start_time_of_run:
            mesh = mesh_from_restart(resume_path, C, "ANT")
            print(f"[gate] resuming from {resume_path} at t={t_res:.1f}",
                  flush=True)
        else:
            resume_path = None

    r = ModelRegion(C, "ANT", mesh=mesh, output_dir=output_dir,
                    device=device)
    if resume_path is not None:
        r.resume_from_restart(resume_path)
        # restore the tuned flow-factor scale alongside the state
        sf = Path(output_dir) / "glen_A_scale.json"
        if sf.exists() and r.md.extras and "glen_A_scale" in r.md.extras:
            scale = json.loads(sf.read_text())["scale"]
            d = json.loads(sf.read_text())
            # in place: the solvers hold the slot's tensor
            r.md.extras["glen_A_scale"].arr.fill_(scale)
            # damped-controller state survives the resume too
            if "gain" in d:
                r._mismip_tune = {"gain": d["gain"],
                                  "last_err": d.get("last_err")}
            print(f"[gate] restored glen_A_scale = {scale:.6f} "
                  f"(gain {d.get('gain', 1.0):.3f})", flush=True)
    return r, resume_path is not None


def _x_GL_westeast(r):
    from ..models.transects import Transect
    tr = Transect.named(r.mesh, "westeast", dx=1e3)
    taf = tr.sample_vertices(_np(r.state.TAF))
    return tr.zero_crossing_distance(taf) + r.mesh.xmin


def run_mismipplus_spinup(output_dir, scoreboard_dir=None,
                          end_time=None, dt_restart=500.0, device="cuda",
                          **overrides):
    """The real MISMIP+ gate: the reference's 5 km spinup
    (config_01_5km_spinup_part0.cfg, 20 kyr to steady state with the
    flow factor auto-tuned so the GL settles at x = 450 km,
    analyse_integrated_test.m:51 + UFEMISM_program.f90:114-123). Writes
    restart files every dt_restart model-years and RESUMES from the
    newest one on a fresh call with the same output_dir."""
    import json
    from ..main.program import mismipplus_adapt_flow_factor

    cfg = REF_TESTS / "idealised/MISMIPplus/config_01_5km_spinup_part0.cfg"
    over = {"refgeo_idealised_MISMIPplus_Hi_init": 100.0,
            "dt_output_restart": dt_restart}
    over.update(overrides)
    if end_time is not None:
        over["end_time_of_run"] = end_time
    C = _load(cfg, **over)

    r, _ = _mismip_resume_region(C, output_dir, device)

    # coupling loop with the MISMIP+ flow-factor tuning (the reference
    # tunes every dt_coupling once Hs has stabilised to 0.5%)
    import time as _time
    t = float(r.time)
    Hs_cur = 1.0
    x_GL_prev = None
    sf = Path(output_dir) / "glen_A_scale.json"
    print(f"[gate] mismipplus_spinup t={t:.1f} -> {C.end_time_of_run:.0f}",
          flush=True)
    while t < C.end_time_of_run - 1e-9:
        t_next = min(t + C.dt_coupling, C.end_time_of_run)
        _tw = _time.perf_counter()
        # advance in sub-windows with a heartbeat print and a restart
        # each: rough GL intervals can take many minutes of wall time
        t_sub = t
        while t_sub < t_next - 1e-9:
            t_sub = min(t_sub + C.dt_coupling / 4.0, t_next)
            r.run_to(t_sub)
            if t_sub < t_next - 1e-9:
                print(f"[gate]  ...t={t_sub:9.1f} steps={r.n_dt_ice} "
                      f"axb={int(r.state.n_Axb_its)}", flush=True)
                r.write_restart()
        t = t_next
        print(f"[gate] t={t:9.1f}  x_GL={_x_GL_westeast(r)/1e3:7.1f} km  "
              f"steps={r.n_dt_ice}  axb={int(r.state.n_Axb_its)}  "
              f"wall={_time.perf_counter() - _tw:6.1f}s  "
              f"dt={float(r.state.dt_ice):.3f}  "
              f"eta={float(r.state.pc.eta_np1):.2e}/"
              f"{C.pc_epsilon:.1e}", flush=True)
        # checkpoint every coupling interval: a lost process then costs
        # at most dt_coupling of recompute, not the whole leg
        r.write_restart()
        if C.refgeo_idealised_MISMIPplus_tune_A:
            Hs_prev = Hs_cur
            Hs_cur = float(r.state.Hs.max())
            # GL-motion gate on top of the reference's Hs-stability
            # gate: the controller's steady-state assumption fails while
            # the GL is still in transit (Hs_max at the dome stabilises
            # long before the GL does), and adapting every interval
            # during transit winds the flow factor far past its
            # equilibrium (measured +-100 km GL swings). Only adapt when
            # the GL moved < 30 m/yr over the last coupling interval.
            x_GL_cur = _x_GL_westeast(r)
            # 10 m/yr: genuine steady-state GL wander is < 5 m/yr, while
            # the long monotone relaxations after an adaptation drift at
            # 20-50 m/yr for centuries - a 30 m/yr threshold still let
            # the controller re-adapt mid-approach and wind up (r5 log,
            # t=10850: A doubled while the GL was already descending)
            gl_steady = (x_GL_prev is not None
                         and abs(x_GL_cur - x_GL_prev)
                         / C.dt_coupling < 10.0)
            x_GL_prev = x_GL_cur
            if abs(1.0 - Hs_cur / Hs_prev) < 5.0e-3 and gl_steady:
                mismipplus_adapt_flow_factor(C, r)
                if r.md.extras and "glen_A_scale" in r.md.extras:
                    tune = getattr(r, "_mismip_tune", {})
                    sf.write_text(json.dumps({
                        "scale": float(
                            r.md.extras["glen_A_scale"].arr),
                        "A0": C.uniform_Glens_flow_factor, "t": t,
                        "gain": tune.get("gain", 1.0),
                        "last_err": tune.get("last_err")}))

    r.write_restart()   # the ice1r leg chains from the finished state
    x_GL = _x_GL_westeast(r)
    run = ScoreboardRun(name="MISMIPplus_5km_spinup",
                        category="integrated_tests/idealised/MISMIPplus")
    run.add_cost_function("x_GL_km", "mid-channel grounding-line position",
                          x_GL / 1e3)
    run.add_cost_function("err_x_GL_init", "abs( x_GL - 450e3)",
                          abs(x_GL - 450e3))
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


def run_mismipplus_ice1r(spinup_dir, output_dir, scoreboard_dir=None,
                         end_time=None, device="cuda", **overrides):
    """MISMIP+ ice1r retreat leg (config_03_5km_ice1r.cfg): resume from
    the spinup's newest restart (with its tuned flow factor), switch on
    the Asay-Davis/Cornford melt, run 100 yr sampling the mid-channel GL
    every year, and score the reference's cost functions
    (analyse_integrated_test.m:51-54): err_x_GL_init vs 450 km, final GL
    inside [350, 420] km, wobble of the 7-pass-smoothed series."""
    import glob
    import json
    import shutil

    cfg = REF_TESTS / "idealised/MISMIPplus/config_03_5km_ice1r.cfg"
    over = {"choice_refgeo_init_ANT": "idealised",
            "choice_refgeo_init_idealised": "MISMIPplus",
            "refgeo_idealised_MISMIPplus_Hi_init": 100.0,
            # the restart resume replaces every read-from-file init the
            # reference's config_03 points at its spinup output files
            "filename_initial_mesh_ANT": "",
            "choice_initial_velocity_ANT": "zero",
            "pc_choice_initialise_ANT": "zero",
            # resume supplies mesh+state; keep the tuning slot alive so
            # the spinup's tuned scale can be restored into it
            "refgeo_idealised_MISMIPplus_tune_A": True}
    over.update(overrides)
    if end_time is not None:
        over["end_time_of_run"] = end_time
    C = _load(cfg, **over)

    # seed output_dir with the spinup's newest restart + tuned scale
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    if not glob.glob(str(Path(output_dir) / "restart_ANT_*.nc")):
        from ..io.ncio import NCFile
        src = sorted(glob.glob(str(Path(spinup_dir) / "restart_ANT_*.nc")))

        def _rt(p):
            try:
                with NCFile(p) as nc:
                    return float(np.asarray(nc.read("time")).reshape(-1)[0])
            except Exception:
                return -np.inf
        newest = max(src, key=_rt)
        shutil.copy(newest, Path(output_dir) / "restart_ANT_00001.nc")
        # ice1r restarts its clock at 0 regardless of spinup time
        sfs = Path(spinup_dir) / "glen_A_scale.json"
        if sfs.exists():
            shutil.copy(sfs, Path(output_dir) / "glen_A_scale.json")

    r, resumed = _mismip_resume_region(C, output_dir, device)
    assert resumed, "ice1r must start from a spinup restart"
    t0 = float(r.time)
    if not (Path(output_dir) / "x_GL_series.json").exists():
        # fresh retreat start: collapse the spinup's Hi prediction window
        # so the first step resolves the new melt forcing immediately
        # (the reference restarts the pc clock when chaining runs)
        s = r.state
        r.state = s.replace(
            Hi_prev=s.Hi, Hi_next=s.Hi, t_Hi_prev=t0, t_Hi_next=t0,
            # per-leg stability counters (the reference reads them from
            # this leg's own scalar output, read_stability_info.m)
            n_visc_its=0, n_Axb_its=0)

    # the retreat window is RELATIVE to the resumed spinup clock; its
    # absolute end is pinned in the series file so a mid-window crash
    # resumes the remaining years instead of re-deriving the window
    x_series_file = Path(output_dir) / "x_GL_series.json"
    duration = C.end_time_of_run - C.start_time_of_run
    if x_series_file.exists():
        rec = json.loads(x_series_file.read_text())
        x_GL, t_end = rec["x_GL"], rec["t_end"]
    else:
        x_GL, t_end = [], t0 + duration
    t = t0
    if not x_GL:
        x_GL.append(_x_GL_westeast(r))
    while t < t_end - 1e-9:
        t = min(t + 1.0, t_end)
        r.run_to(t)
        x_GL.append(_x_GL_westeast(r))
        r.write_restart()   # keep state and series in lock-step
        x_series_file.write_text(json.dumps({"x_GL": x_GL, "t": t,
                                             "t_end": t_end}))

    x = np.asarray(x_GL, float)
    xs = x.copy()
    for _ in range(7):   # analyse_integrated_test.m:43-48
        xs[1:-1] = 0.25 * xs[:-2] + 0.5 * xs[1:-1] + 0.25 * xs[2:]

    run = ScoreboardRun(name="MISMIPplus_5km_ice1r",
                        category="integrated_tests/idealised/MISMIPplus")
    run.add_cost_function("err_x_GL_init", "abs( x_GL(1) - 450e3)",
                          abs(x[0] - 450e3))
    run.add_cost_function("err_x_GL_final_lo",
                          "abs( min( 0, x_GL(end) - 350e3))",
                          abs(min(0.0, x[-1] - 350e3)))
    run.add_cost_function("err_x_GL_final_hi",
                          "abs( max( 0, x_GL(end) - 420e3))",
                          abs(max(0.0, x[-1] - 420e3)))
    run.add_cost_function("var_x_GL", "max( abs( x_GL_smooth - x_GL))",
                          float(np.abs(xs - x).max()))
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


def run_mismipplus_iceocean1r(spinup_dir, output_dir, scoreboard_dir=None,
                              end_time=None, device="cuda", **overrides):
    """MISOMIP iceocean1r: the reference's LADDIE-coupled retreat leg
    (config_06_5km_iceocean1r.cfg — choice_BMB_model='laddie' with the
    ISOMIP WARM ocean). Resumes from the spinup restart, runs 60 yr with
    the in-tree LADDIE supplying sub-shelf melt every dt_BMB, and scores
    the reference's cost functions
    (analyse_integrated_test_misomip.py:36-40): final mid-channel GL
    inside the [430, 450] km band."""
    import glob
    import json
    import shutil

    cfg = REF_TESTS / "idealised/MISMIPplus/config_06_5km_iceocean1r.cfg"
    over = {"choice_refgeo_init_ANT": "idealised",
            "choice_refgeo_init_idealised": "MISMIPplus",
            "refgeo_idealised_MISMIPplus_Hi_init": 100.0,
            "filename_initial_mesh_ANT": "",
            "choice_initial_velocity_ANT": "zero",
            "pc_choice_initialise_ANT": "zero",
            "refgeo_idealised_MISMIPplus_tune_A": True}
    over.update(overrides)
    if end_time is not None:
        over["end_time_of_run"] = end_time
    C = _load(cfg, **over)

    Path(output_dir).mkdir(parents=True, exist_ok=True)
    if not glob.glob(str(Path(output_dir) / "restart_ANT_*.nc")):
        from ..io.ncio import NCFile
        src = sorted(glob.glob(str(Path(spinup_dir) / "restart_ANT_*.nc")))

        def _rt(p):
            try:
                with NCFile(p) as nc:
                    return float(np.asarray(nc.read("time")).reshape(-1)[0])
            except Exception:
                return -np.inf
        newest = max(src, key=_rt)
        shutil.copy(newest, Path(output_dir) / "restart_ANT_00001.nc")
        sfs = Path(spinup_dir) / "glen_A_scale.json"
        if sfs.exists():
            shutil.copy(sfs, Path(output_dir) / "glen_A_scale.json")

    r, resumed = _mismip_resume_region(C, output_dir, device)
    assert resumed, "iceocean1r must start from a spinup restart"
    t0 = float(r.time)
    x_series_file = Path(output_dir) / "x_GL_series.json"
    if not x_series_file.exists():
        s = r.state
        r.state = s.replace(
            Hi_prev=s.Hi, Hi_next=s.Hi, t_Hi_prev=t0, t_Hi_next=t0,
            n_visc_its=0, n_Axb_its=0)

    duration = C.end_time_of_run - C.start_time_of_run
    if x_series_file.exists():
        rec = json.loads(x_series_file.read_text())
        x_GL, t_end = rec["x_GL"], rec["t_end"]
    else:
        x_GL, t_end = [], t0 + duration
    t = t0
    if not x_GL:
        x_GL.append(_x_GL_westeast(r))
    while t < t_end - 1e-9:
        t = min(t + 1.0, t_end)
        r.run_to(t)
        x_GL.append(_x_GL_westeast(r))
        r.write_restart()
        x_series_file.write_text(json.dumps({"x_GL": x_GL, "t": t,
                                             "t_end": t_end}))
        print(f"[gate] iceocean1r t={t:7.1f} x_GL={x_GL[-1]/1e3:7.1f} km",
              flush=True)

    x = np.asarray(x_GL, float)
    run = ScoreboardRun(name="MISOMIP",
                        category="integrated_tests/idealised/MISMIPplus")
    run.add_cost_function("err_x_GL_final_lo",
                          "abs( min( 0, x_GL[-1] - 430e3))",
                          abs(min(0.0, x[-1] - 430e3)))
    run.add_cost_function("err_x_GL_final_hi",
                          "abs( max( 0, x_GL[-1] - 450e3))",
                          abs(max(0.0, x[-1] - 450e3)))
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


def run_mismipplus(scoreboard_dir=None, quick=True, output_dir=None,
                   device="cuda"):
    from ..models.transects import Transect
    cfg = REF_TESTS / "idealised/MISMIPplus/config_01_5km_spinup_part0.cfg"
    over = {"refgeo_idealised_MISMIPplus_Hi_init": 100.0}
    if quick:
        # CI-speed: coarser GL resolution + short spinup leg from a
        # thicker slab (the reference's 100 m slab only grounds after
        # centuries; 500 m grounds immediately so a GL exists to score)
        over.update(end_time_of_run=20.0,
                    maximum_resolution_grounding_line=16e3,
                    maximum_resolution_grounded_ice=32e3,
                    refgeo_idealised_MISMIPplus_Hi_init=500.0)
    C = _load(cfg, **over)
    r = _region(C, output_dir, device)
    r.run_to(C.end_time_of_run)

    tr = Transect.named(r.mesh, "westeast", dx=1e3)
    taf = tr.sample_vertices(_np(r.state.TAF))
    x_GL = tr.zero_crossing_distance(taf) + r.mesh.xmin

    run = ScoreboardRun(name="MISMIPplus" + ("_quick" if quick else ""),
                        category="integrated_tests/idealised/MISMIPplus")
    run.add_cost_function("x_GL_km", "mid-channel grounding-line position",
                          x_GL / 1e3)
    run.add_cost_function("err_x_GL_init", "abs( x_GL - 450e3)",
                          abs(x_GL - 450e3))
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# MISMIP_mod hysteresis (analyse_integrated_test.m in MISMIP_mod/): the
# radially-symmetric MISMIP experiment run through the reference's 4-leg
# chain (40 km spinup -> 10 km spinup -> advance at A=1e-17 -> retreat at
# A=1e-16), scored as |rGL_retreat(end) - rGL_spinup(end)| along the 8
# octant transects (reference values 451-13,543 m by octant, BASELINE.md).
# ---------------------------------------------------------------------------

MISMIP_MOD_DIR = REF_TESTS / "idealised/MISMIP_mod"
_OCTANTS = ("east", "northeast", "north", "northwest",
            "west", "southwest", "south", "southeast")


def _set_geometry(r, Hi, Hb, SL):
    """Start region r from the host arrays (Hi, Hb, SL): the geometry and
    its derived fields, on r's device and in its precision."""
    from ..core.ice.geometry import (ice_surface_elevation,
                                     thickness_above_flotation)
    kw = dict(dtype=r.state.Hi.dtype, device=r.state.Hi.device)
    Hi_t = torch.as_tensor(Hi, **kw)
    Hb_t = torch.as_tensor(Hb, **kw)
    SL_t = torch.as_tensor(SL, **kw)
    Hs_t = ice_surface_elevation(Hi_t, Hb_t, SL_t)
    r.state = r.state.replace(
        Hi=Hi_t, Hi_prev=Hi_t, Hi_next=Hi_t, Hb=Hb_t, SL=SL_t, Hs=Hs_t,
        Hib=Hs_t - Hi_t, TAF=thickness_above_flotation(Hi_t, Hb_t, SL_t))
    return r


def _transfer_geometry(region_prev, C_next, r_next=None, device="cuda"):
    """Hand the final (Hi, Hb, SL) of one leg to the next leg's fresh
    mesh by trilinear mesh-to-point interpolation (the reference chains
    legs through main-output files + read_from_file geometry;
    in-process the remap atlas map does the same job)."""
    from ..remap.conservative import build_map_trilin_mesh_to_points
    from ..main.region import ModelRegion
    if r_next is None:
        r_next = ModelRegion(C_next, "ANT", device=device)
    M = build_map_trilin_mesh_to_points(region_prev.mesh, r_next.mesh.V)
    Hi = np.maximum(0.0, M @ _np(region_prev.state.Hi))
    Hb = M @ _np(region_prev.state.Hb)
    SL = M @ _np(region_prev.state.SL)
    Hi = np.where(Hi < C_next.refgeo_Hi_min, 0.0, Hi)
    return _set_geometry(r_next, Hi, Hb, SL)


def _transfer_geometry_from_dir(prev_leg_dir, C_next, r_next):
    """File-based leg chaining for per-process legs (each MISMIP_mod leg
    in a process of its own, `run_mismip_mod(only_leg=N)`): read the
    previous leg's final geometry from its main output file and restart
    and interpolate onto the next leg's fresh mesh."""
    import glob as _glob
    from scipy.interpolate import LinearNDInterpolator
    from ..io.ncio import NCFile

    outs = sorted(_glob.glob(str(Path(prev_leg_dir)
                                 / "main_output_ANT_0*.nc")))
    outs = [p for p in outs if "_grid" not in p]
    with NCFile(outs[-1]) as nc:
        V = np.asarray(nc.read("V"))
    # exact final state from the restart (written on the same, newest
    # mesh generation as the newest main output file)
    def _rt(p):
        try:
            with NCFile(p) as nc:
                return float(np.asarray(nc.read("time")).reshape(-1)[0])
        except Exception:
            return -np.inf
    rst = max(_glob.glob(str(Path(prev_leg_dir) / "restart_ANT_*.nc")),
              key=_rt)
    with NCFile(rst) as nc:
        Hi = np.asarray(nc.read("Hi"))
        Hb = np.asarray(nc.read("Hb"))
        SL = np.asarray(nc.read("SL"))
    assert len(Hi) == len(V), "restart mesh != newest output mesh"
    P = np.asarray(r_next.mesh.V)
    def interp(f):
        return LinearNDInterpolator(V, f, fill_value=0.0)(P)
    Hi_n = np.maximum(0.0, interp(Hi))
    Hi_n = np.where(Hi_n < C_next.refgeo_Hi_min, 0.0, Hi_n)
    return _set_geometry(r_next, Hi_n, interp(Hb), interp(SL))


def _octant_rGL(region):
    """GL distance from the domain centre along each octant transect."""
    from ..models.transects import Transect
    out = {}
    taf_np = _np(region.state.TAF)
    for oc in _OCTANTS:
        tr = Transect.named(region.mesh, oc, dx=2e3)
        taf = tr.sample_vertices(taf_np)
        out[oc] = float(tr.zero_crossing_distance(taf))
    return out


def run_mismip_mod(scoreboard_dir=None, output_dir=None, scale=1.0,
                   t_spin40=None, t_spin10=None, t_adv=None, t_ret=None,
                   only_leg=None, device="cuda"):
    """Full MISMIP_mod hysteresis chain. scale < 1 shortens every leg
    proportionally (recorded in the scoreboard name) for CI-speed runs;
    scale=1.0 is the reference configuration. When output_dir is given,
    each leg writes restarts in its own subdirectory and a re-invocation
    resumes mid-chain.

    only_leg=N runs leg N alone in this process; legs chain through the
    previous leg's restart + output files (_transfer_geometry_from_dir),
    octant GL radii persist in <output_dir>/rGL_leg_NN.json, and the
    scoreboard entry is written by the leg-4 invocation."""
    import json as _json

    def _t(cfg_default, override):
        return override if override is not None else cfg_default * scale

    def _leg(cfg_name, end_time, leg_no, prev_region, **extra):
        over = dict(end_time_of_run=end_time, **extra)
        leg_dir = None
        if output_dir is not None:
            leg_dir = str(Path(output_dir) / f"leg_{leg_no:02d}")
            over["dt_output_restart"] = max(100.0, end_time / 20.0)
        C = _load(MISMIP_MOD_DIR / cfg_name, **over)
        if leg_dir is not None:
            r, resumed = _mismip_resume_region(C, leg_dir, device)
        else:
            r, resumed = _region(C, None, device), False
        if not resumed and prev_region is not None:
            r = _transfer_geometry(prev_region, C, r_next=r)
        if not resumed and prev_region is None and leg_no > 1 \
                and output_dir is not None:
            # per-process mode: chain from the previous leg's files
            r = _transfer_geometry_from_dir(
                Path(output_dir) / f"leg_{leg_no - 1:02d}", C, r)
        r.run_to(C.end_time_of_run)
        if leg_dir is not None:
            r.write_restart()   # completed leg resumes as completed
        return r

    geom = dict(choice_refgeo_init_ANT="idealised",
                choice_refgeo_init_idealised="MISMIP_mod")
    legs = {1: ("config_01_spinup_40km.cfg", _t(20000.0, t_spin40), {}),
            2: ("config_02_spinup_10km.cfg", _t(5000.0, t_spin10), geom),
            3: ("config_03_advance_10km.cfg", _t(10000.0, t_adv), geom),
            4: ("config_04_retreat_10km.cfg", _t(10000.0, t_ret), geom)}

    if only_leg is not None:
        n = int(only_leg)
        cfg_name, end, extra = legs[n]
        r = _leg(cfg_name, end, n, None, **extra)
        if n in (2, 4):
            rGL = _octant_rGL(r)
            Path(output_dir, f"rGL_leg_{n:02d}.json").write_text(
                _json.dumps(rGL))
        run = ScoreboardRun(name=f"MISMIP_mod_leg{n}",
                            category="integrated_tests/idealised/MISMIP_mod")
        run.add_cost_function("t_end", "leg end model time",
                              float(r.time))
        run.add_stability_info(_stability(r))
        if n == 4:
            rGL_spin = _json.loads(
                Path(output_dir, "rGL_leg_02.json").read_text())
            rGL_ret = _json.loads(
                Path(output_dir, "rGL_leg_04.json").read_text())
            tag = "" if scale >= 1.0 else f"_scale{scale:g}"
            run = ScoreboardRun(
                name="MISMIP_mod" + tag,
                category="integrated_tests/idealised/MISMIP_mod")
            for oc in _OCTANTS:
                run.add_cost_function(
                    f"GL_hyst_{oc}",
                    "abs( rGL_retreat(end) - rGL_spinup(end) )",
                    abs(rGL_ret[oc] - rGL_spin[oc]))
            run.add_stability_info(_stability(r))
        if scoreboard_dir:
            run.write(scoreboard_dir)
        return run

    r1 = _leg(*legs[1][:2], 1, None, **legs[1][2])
    r2 = _leg(*legs[2][:2], 2, r1, **legs[2][2])
    rGL_spin = _octant_rGL(r2)
    r3 = _leg(*legs[3][:2], 3, r2, **legs[3][2])
    r4 = _leg(*legs[4][:2], 4, r3, **legs[4][2])
    rGL_ret = _octant_rGL(r4)

    tag = "" if scale >= 1.0 else f"_scale{scale:g}"
    run = ScoreboardRun(name="MISMIP_mod" + tag,
                        category="integrated_tests/idealised/MISMIP_mod")
    for oc in _OCTANTS:
        run.add_cost_function(
            f"GL_hyst_{oc}",
            "abs( rGL_retreat(end) - rGL_spinup(end) )",
            abs(rGL_ret[oc] - rGL_spin[oc]))
    run.add_stability_info(_stability(r2))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# Berends et al. (2023) bed-roughness nudging, experiment I
# (Berends2023_nudging/experiment_I/): an EISMINT-like moving-margin dome
# with a prescribed ice-stream till-friction-angle anomaly; a spinup with
# the TRUE roughness provides the target, then an inversion run starting
# from uniform roughness must recover it. Scored with the reference's
# 95th-percentile cost functions
# (analyse_integrated_test_H_dHdt_flowline.m:110-140).
# ---------------------------------------------------------------------------

def _berends_exp_I_fields(V):
    """The experiment-I synthetic till friction angle and SMB on points V
    (input_data/AA_create_experiment_I_data.m:20-33,247,258)."""
    phi_min, phi_max = 0.8, 2.0
    x_c, y_c = 0.0, -400e3
    sig_x, sig_y = 50e3, 300e3
    phi = phi_max - (phi_max - phi_min) * np.exp(
        -0.5 * (((V[:, 0] - x_c) / sig_x) ** 2
                + ((V[:, 1] - y_c) / sig_y) ** 2))
    M_max, E, S = 0.5, 400e3, 1e-5
    r = np.sqrt(V[:, 0] ** 2 + V[:, 1] ** 2)
    smb = np.minimum(M_max, S * (E - r))
    return phi, smb


def _start_from(r, Hi0):
    """Region r's geometry from the thickness Hi0 (host) on its own bed
    and sea level."""
    return _set_geometry(r, Hi0, r.state.Hb, r.state.SL)


def _p95(x):
    return float(np.percentile(np.abs(np.asarray(x)), 95))


def _r95(target, inverted):
    ratio = np.asarray(inverted, float) / np.asarray(target, float)
    ratio = np.maximum(ratio, 1.0 / np.maximum(ratio, 1e-30))
    return float(np.percentile(ratio, 95))


def run_berends_nudging(method="H_dHdt_flowline", resolution=40e3,
                        t_spinup=5000.0, t_invert=2000.0,
                        scoreboard_dir=None, output_dir=None,
                        device="cuda"):
    """Experiment I at the given resolution: target spinup with the true
    roughness, then an inversion leg starting from uniform roughness
    nudged by `method` toward the target geometry. The reference runs the
    chain at 5 km / 20+ kyr; resolution/t let CI run the same physics
    scaled down (recorded in the scoreboard name)."""
    import tempfile
    from ..io.ncio import NCFile
    cfg = (REF_TESTS / "idealised/Berends2023_nudging/experiment_I"
           / "config_01_exp_I_spinup_40km_part0.cfg")

    # generate the experiment-I input files the reference ships as MATLAB
    # generators (input_data/AA_create_experiment_I_data.m): bed roughness
    # + SMB on a grid at the requested resolution
    tmp = tempfile.mkdtemp(prefix="berends_")
    gx = np.arange(-700e3, 700e3 + 1, resolution / 2)
    gy = gx.copy()
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    pts = np.stack([GX.ravel(), GY.ravel()], 1)
    phi_g, smb_g = _berends_exp_I_fields(pts)
    rough_file = f"{tmp}/exp_I_bed_roughness.nc"
    smb_file = f"{tmp}/exp_I_SMB.nc"
    with NCFile(rough_file, "w") as nc:
        nc.def_dim("x", len(gx))
        nc.def_dim("y", len(gy))
        nc.def_var("x", ("x",), units="m"); nc.put("x", gx)
        nc.def_var("y", ("y",), units="m"); nc.put("y", gy)
        nc.def_var("till_friction_angle", ("x", "y"), units="degrees")
        nc.put("till_friction_angle", phi_g.reshape(GX.shape))
    with NCFile(smb_file, "w") as nc:
        nc.def_dim("x", len(gx))
        nc.def_dim("y", len(gy))
        nc.def_var("x", ("x",), units="m"); nc.put("x", gx)
        nc.def_var("y", ("y",), units="m"); nc.put("y", gy)
        nc.def_var("SMB", ("x", "y"), units="m/yr")
        nc.put("SMB", smb_g.reshape(GX.shape))

    common = dict(
        end_time_of_run=t_spinup,
        maximum_resolution_uniform=resolution,
        maximum_resolution_grounded_ice=resolution,
        maximum_resolution_grounding_line=resolution,
        filename_SMB_prescribed_ANT=smb_file,
        allow_mesh_updates=False,
    )

    # -- target spinup with the TRUE roughness (read from file, as the
    # reference's spinup legs do) ----------------------------------------
    C1 = _load(cfg, choice_bed_roughness="read_from_file",
               filename_bed_roughness_ANT=rough_file, **common)
    r1 = _region(C1, output_dir, device)
    phi_true = _np(r1.state.bed_roughness)
    r1.run_to(C1.end_time_of_run)

    u3 = _np(r1.state.u_3D_b)
    v3 = _np(r1.state.v_3D_b)
    uabs_t = np.sqrt(u3[:, 0] ** 2 + v3[:, 0] ** 2)
    Hs_t = _np(r1.state.Hs)
    Hi_t = _np(r1.state.Hi)

    # sliding grounded masks (analyse script: Hs>2 & sliding)
    mask_a = (Hs_t > 2.0) & _np(r1.state.mask_grounded_ice)
    mask_b = mask_a[r1.mesh.Tri].all(axis=1)

    # -- inversion from uniform roughness, nudged by `method` -----------
    over2 = dict(common, end_time_of_run=t_invert,
                 choice_bed_roughness="uniform",
                 slid_ZI_phi_fric_uniform=float(phi_true.mean()),
                 do_bed_roughness_nudging=True,
                 choice_bed_roughness_nudging_method=method)
    C2 = _load(cfg, **over2)
    r2 = _region(C2, output_dir, device)
    # target geometry = the spun-up state (same mesh: same config/domain)
    r2.refgeo_PD = (Hi_t, _np(r1.state.Hb))
    # start the inversion from the spun-up geometry (the reference's
    # inversion legs restart from the spinup output)
    _start_from(r2, Hi_t)
    r2.run_to(C2.end_time_of_run)

    phi_inv = _np(r2.state.bed_roughness)
    u3 = _np(r2.state.u_3D_b)
    v3 = _np(r2.state.v_3D_b)
    uabs_i = np.sqrt(u3[:, 0] ** 2 + v3[:, 0] ** 2)
    Hs_i = _np(r2.state.Hs)

    run = ScoreboardRun(
        name=f"exp_I_{method}_{int(resolution/1e3)}km",
        category="integrated_tests/idealised/Berends2023_nudging")
    run.add_cost_function(
        "r95_till_friction_angle",
        "95% of till friction is within this fraction of its target",
        _r95(phi_true[mask_a], phi_inv[mask_a]))
    run.add_cost_function(
        "p95_ice_thickness",
        "95% of ice thickness is within this range of its target",
        _p95(Hs_i[mask_a] - Hs_t[mask_a]))
    run.add_cost_function(
        "r95_ice_velocity",
        "95% of ice velocity is within this fraction of its target",
        _r95(uabs_t[mask_b] + 5.0, uabs_i[mask_b] + 5.0))
    run.add_stability_info(_stability(r2))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# Berends et al. (2023) bed-roughness nudging, experiment II
# (Berends2023_nudging/experiment_II/): the MISMIP+ channel with a
# Gaussian ice-stream trough in the till friction angle
# (input_data/AA_create_experiment_II_data.m:20-26). A spinup with the
# true roughness provides the target; the three friction-nudging methods
# invert it back (configs 02-04); 'dHdt_invfric_invBMB' additionally
# runs the 10-yr warm-ocean retreat (config 05) and inverts friction AND
# basal melt simultaneously against the retreated geometry + dHi_dt
# target (config 06, analyse_integrated_test_dHdt_invfric_invBMB.m).
# ---------------------------------------------------------------------------

def _berends_exp_II_roughness(V):
    """Experiment-II till friction angle on points V (y centred on the
    channel axis; the generator's y_c = 40 km sits mid-channel of its
    0..80 km axis, AA_create_experiment_II_data.m:20-26)."""
    phi_min, phi_max = 0.2, 2.0
    x_c, sig_x, sig_y = 400e3, 150e3, 15e3
    return phi_max - (phi_max - phi_min) * np.exp(
        -0.5 * (((V[:, 0] - x_c) / sig_x) ** 2 + (V[:, 1] / sig_y) ** 2))


def run_berends_exp_II(method="H_dHdt_flowline", resolution=10e3,
                       t_spinup=5000.0, t_invert=2000.0, t_retreat=10.0,
                       scoreboard_dir=None, output_dir=None, device="cuda"):
    """Experiment II at the given resolution (reference: 5 km, 20 kyr
    spinup; the gate scales both down and records them in the
    scoreboard name)."""
    import tempfile
    from ..io.ncio import NCFile
    cfg = (REF_TESTS / "idealised/Berends2023_nudging/experiment_II"
           / "config_01_exp_II_spinup_5km.cfg")

    # exp-II bed roughness input file (the reference ships a MATLAB
    # generator; the channel is re-centred on y=0)
    tmp = tempfile.mkdtemp(prefix="berends2_")
    gx = np.arange(0.0, 800e3 + 1, resolution / 2)
    gy = np.arange(-40e3, 40e3 + 1, resolution / 2)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    phi_g = _berends_exp_II_roughness(
        np.stack([GX.ravel(), GY.ravel()], 1))
    rough_file = f"{tmp}/exp_II_bed_roughness.nc"
    with NCFile(rough_file, "w") as nc:
        nc.def_dim("x", len(gx))
        nc.def_dim("y", len(gy))
        nc.def_var("x", ("x",), units="m"); nc.put("x", gx)
        nc.def_var("y", ("y",), units="m"); nc.put("y", gy)
        nc.def_var("till_friction_angle", ("x", "y"), units="degrees")
        nc.put("till_friction_angle", phi_g.reshape(GX.shape))

    common = dict(
        end_time_of_run=t_spinup,
        choice_refgeo_init_ANT="idealised",
        choice_refgeo_PD_ANT="idealised",
        choice_refgeo_GIAeq_ANT="idealised",
        choice_refgeo_init_idealised="MISMIPplus",
        choice_refgeo_PD_idealised="MISMIPplus",
        choice_refgeo_GIAeq_idealised="MISMIPplus",
        refgeo_idealised_MISMIPplus_Hi_init=100.0,
        ymin_ANT=-40e3, ymax_ANT=40e3,
        maximum_resolution_uniform=resolution,
        maximum_resolution_grounded_ice=resolution,
        maximum_resolution_grounding_line=resolution,
        ROI_maximum_resolution_grounding_line=resolution,
        allow_mesh_updates=False,
    )

    # -- leg 1: spinup with the TRUE roughness ---------------------------
    C1 = _load(cfg, choice_bed_roughness="read_from_file",
               filename_bed_roughness_ANT=rough_file, **common)
    r1 = _region(C1, output_dir, device)
    phi_true = _np(r1.state.bed_roughness)
    r1.run_to(C1.end_time_of_run)

    u3 = _np(r1.state.u_3D_b)
    v3 = _np(r1.state.v_3D_b)
    uabs_t = np.sqrt(u3[:, 0] ** 2 + v3[:, 0] ** 2)
    Hs_t = _np(r1.state.Hs)
    Hi_t = _np(r1.state.Hi)
    Hb_t = _np(r1.state.Hb)
    mask_a = (Hs_t > 2.0) & _np(r1.state.mask_grounded_ice)
    mask_b = mask_a[r1.mesh.Tri].all(axis=1)

    from ..core.ice.geometry import ice_surface_elevation

    run = ScoreboardRun(
        name=f"exp_II_{method}_{int(resolution/1e3)}km",
        category="integrated_tests/idealised/Berends2023_nudging")

    if method == "dHdt_invfric_invBMB":
        # -- leg 2: 10-yr warm-ocean retreat (config 05: MISMIP+ melt
        # formula switched on) from the spun-up state -------------------
        C5 = _load(cfg, choice_bed_roughness="read_from_file",
                   filename_bed_roughness_ANT=rough_file,
                   **dict(common, end_time_of_run=t_retreat,
                          choice_BMB_model_ANT="idealised",
                          choice_BMB_model_idealised="MISMIP+"))
        r5 = _region(C5, output_dir, device)
        _start_from(r5, Hi_t)
        r5.run_to(C5.end_time_of_run)
        Hi_ret = _np(r5.state.Hi)
        dHdt_ret = _np(r5.state.dHi_dt)
        BMB_ret = _np(r5.BMB)

        # -- leg 3: simultaneous friction + BMB inversion (config 06):
        # target = retreated geometry + its dHi_dt --------------------
        over6 = dict(common, end_time_of_run=t_invert,
                     choice_bed_roughness="uniform",
                     slid_ZI_phi_fric_uniform=float(phi_true.mean()),
                     do_bed_roughness_nudging=True,
                     choice_bed_roughness_nudging_method="H_dHdt_flowline",
                     choice_BMB_model_ANT="inverted",
                     do_target_dHi_dt=True)
        C6 = _load(cfg, **over6)
        r6 = _region(C6, output_dir, device)
        r6.refgeo_PD = (Hi_ret, Hb_t)          # BMB + nudging target
        _start_from(r6, Hi_ret)
        r6.state = r6.state.replace(dHi_dt_target=torch.as_tensor(
            dHdt_ret, dtype=r6.md.A.dtype, device=r6.md.device))
        r6.run_to(C6.end_time_of_run)

        phi_inv = _np(r6.state.bed_roughness)
        BMB_inv = _np(r6.BMB)
        shelf = _np(r6.state.mask_floating_ice)
        run.add_cost_function(
            "r95_till_friction_angle",
            "95% of till friction is within this fraction of its target",
            _r95(phi_true[mask_a], phi_inv[mask_a]))
        run.add_cost_function(
            "p95_ice_thickness",
            "95% of ice thickness is within this range of its target",
            _p95(_np(r6.state.Hs)[mask_a]
                 - _np(ice_surface_elevation(
                     torch.as_tensor(Hi_ret), torch.as_tensor(Hb_t),
                     r6.state.SL.cpu()))[mask_a]))
        if shelf.any():
            run.add_cost_function(
                "p95_BMB_shelf",
                "95% of inverted shelf melt is within this range of the"
                " retreat forcing", _p95(BMB_inv[shelf] - BMB_ret[shelf]))
        run.add_stability_info(_stability(r6))
    else:
        # -- leg 2: friction-only inversion from uniform roughness ------
        over2 = dict(common, end_time_of_run=t_invert,
                     choice_bed_roughness="uniform",
                     slid_ZI_phi_fric_uniform=float(phi_true.mean()),
                     do_bed_roughness_nudging=True,
                     choice_bed_roughness_nudging_method=method)
        C2 = _load(cfg, **over2)
        r2 = _region(C2, output_dir, device)
        r2.refgeo_PD = (Hi_t, Hb_t)
        _start_from(r2, Hi_t)
        r2.run_to(C2.end_time_of_run)

        phi_inv = _np(r2.state.bed_roughness)
        u3 = _np(r2.state.u_3D_b)
        v3 = _np(r2.state.v_3D_b)
        uabs_i = np.sqrt(u3[:, 0] ** 2 + v3[:, 0] ** 2)
        run.add_cost_function(
            "r95_till_friction_angle",
            "95% of till friction is within this fraction of its target",
            _r95(phi_true[mask_a], phi_inv[mask_a]))
        run.add_cost_function(
            "p95_ice_thickness",
            "95% of ice thickness is within this range of its target",
            _p95(_np(r2.state.Hs)[mask_a] - Hs_t[mask_a]))
        run.add_cost_function(
            "r95_ice_velocity",
            "95% of ice velocity is within this fraction of its target",
            _r95(uabs_t[mask_b] + 5.0, uabs_i[mask_b] + 5.0))
        run.add_stability_info(_stability(r2))

    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# The programs: every tier in one call
# ---------------------------------------------------------------------------

def run_all_integrated_tests(scoreboard_dir, quick=True, verbose=True,
                             device="cuda"):
    """Quick tier (CI): Halfar 40 km, SSA icestream 32 km, ISMIP-HOM A
    DIVA L=160, short MISMIP+ spinup. Full tier: the reference's exact
    test matrix. Every run on `device`."""
    from ..ops import resolve_device
    device = resolve_device(device)     # before anything is written
    runs = []
    if quick:
        runs.append(run_halfar(scoreboard_dir, resolution_km=40,
                               quick=True, device=device))
        runs.append(run_ssa_icestream(scoreboard_dir, resolutions=(32,),
                                      device=device))
        runs.append(run_ismip_hom(scoreboard_dir, "A", 160, "DIVA",
                                  device=device))
        runs.append(run_mismipplus(scoreboard_dir, quick=True,
                                   device=device))
    else:
        runs.append(run_halfar(scoreboard_dir, resolution_km=5,
                               device=device))
        runs.append(run_ssa_icestream(scoreboard_dir, device=device))
        runs.extend(run_ismip_hom_matrix(scoreboard_dir, verbose=verbose,
                                         device=device))
        runs.append(run_mismipplus_spinup("results_mismipplus_5km_spinup",
                                          scoreboard_dir, device=device))
        runs.append(run_mismip_mod(scoreboard_dir, device=device))
        for method in ("H_dHdt_flowline", "H_dHdt_local", "H_u_flowline"):
            runs.append(run_berends_nudging(method=method,
                                            scoreboard_dir=scoreboard_dir,
                                            device=device))
        for method in ("H_dHdt_flowline", "H_dHdt_local", "H_u_flowline",
                       "dHdt_invfric_invBMB"):
            runs.append(run_berends_exp_II(method=method,
                                           scoreboard_dir=scoreboard_dir,
                                           device=device))
    if verbose:
        for r in runs:
            print(r.summary())
    return runs


# ---------------------------------------------------------------------------
# Realistic Antarctica initialisation (the reference's flagship realistic
# integrated test, automated_testing/integrated_tests/realistic/Antarctica/
# initialisation/Ant_init_20kyr_invBMB_invfric_40km: BedMachine geometry,
# RACMO climate snapshot + prescribed SMB, Shapiro-Ritzwoller geothermal
# flux, target thinning rates, Zoet-Iverson + H_dHdt_flowline friction
# nudging + inverted BMB, 3-D thermodynamics, adaptive remeshing).
# The external/data inputs are not shipped with the reference, so the run
# uses the synthetic Antarctica-like dataset of tools/antarctica_synthetic.py
# (the port's copy of the repository's generator) in the SAME file formats
# - every realistic-pipeline code path is identical.
# ---------------------------------------------------------------------------

ANT_CFG = (REF_TESTS / "realistic/Antarctica/initialisation"
           / "Ant_init_20kyr_invBMB_invfric_40km/config.cfg")


def run_antarctica_40km(output_dir, scoreboard_dir=None, end_time=2000.0,
                        dt_restart=100.0, device="cuda", **overrides):
    """Resumable realistic-Antarctica 40 km leg. Scores RMSE(Hi final vs
    init) - the reference's anchor for the full 20 kyr run is 77.99 m -
    plus ice volume/area, VAF and the stability counters. The synthetic
    data go into tools/antarctica_synthetic.py's DATA_DIR, written there
    once."""
    from ..tools.antarctica_synthetic import ensure_data

    files = ensure_data()
    over = {
        "filename_refgeo_init_ANT": str(files["topo"]),
        "filename_refgeo_PD_ANT": str(files["topo"]),
        "filename_refgeo_GIAeq_ANT": str(files["topo"]),
        "filename_climate_snapshot_ANT": str(files["climate"]),
        "filename_SMB_prescribed_ANT": str(files["SMB"]),
        "filename_dHi_dt_target_ANT": str(files["dHdt"]),
        "filename_geothermal_heat_flux": str(files["ghf"]),
        "end_time_of_run": end_time,
        "dt_output_restart": dt_restart,
        # the BedMachine timeframes in the reference config are 1e9
        # (no time dimension) - our synthetic files likewise
        "timeframe_refgeo_init_ANT": 1e9,
        "timeframe_refgeo_PD_ANT": 1e9,
        "timeframe_refgeo_GIAeq_ANT": 1e9,
        "timeframe_dHi_dt_target_ANT": 1e9,
    }
    over.update(overrides)
    C = _load(ANT_CFG, **over)

    r, resumed = _mismip_resume_region(C, output_dir, device)
    Hi_init = _np(r.refgeo_PD[0])

    import time as _time
    t = float(r.time)
    print(f"[gate] antarctica_40km t={t:.1f} -> {C.end_time_of_run:.0f} "
          f"nV={r.mesh.nV}", flush=True)
    while t < C.end_time_of_run - 1e-9:
        t_next = min(t + C.dt_coupling, C.end_time_of_run)
        _tw = _time.perf_counter()
        r.run_to(t_next)
        t = t_next
        Hi_now = _np(r.state.Hi)
        vol = float((Hi_now * _np(r.md.A)).sum()) / 1e15
        print(f"[gate] t={t:9.1f}  vol={vol:8.3f}e6 km3  "
              f"steps={r.n_dt_ice}  axb={int(r.state.n_Axb_its)}  "
              f"wall={_time.perf_counter() - _tw:6.1f}s", flush=True)
        r.write_restart()

    Hi = _np(r.state.Hi)
    rmse_Hi = float(np.sqrt(((Hi - Hi_init) ** 2).mean()))
    run = ScoreboardRun(name="Antarctica_init_40km_synthetic",
                        category="integrated_tests/realistic/Antarctica")
    run.add_cost_function(
        "rmse_Hi_vs_init",
        "sqrt(mean((Hi_final - Hi_init).^2)); reference's 20 kyr anchor "
        "77.99 m (on real BedMachine data; this run uses the synthetic "
        "realistic-format dataset, tools/gen_antarctica_synthetic.py)",
        rmse_Hi)
    A = _np(r.md.A)
    ice = Hi > 0.1
    run.add_cost_function("ice_area_Mkm2", "ice-covered area",
                          float(A[ice].sum()) / 1e12)
    run.add_cost_function("ice_volume_mSLE_proxy", "sum(Hi*A)/3.62e14/sw",
                          float((Hi * A).sum()) / 3.625e14 * 0.9167)
    run.add_cost_function(
        "mean_abs_dHi_dt", "mean |dHi/dt| at end (inversion settling)",
        float(np.abs(_np(r.state.dHi_dt)[ice]).mean()))
    run.add_cost_function("t_end", "reached model time", float(r.time))
    run.add_stability_info(_stability(r))
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run
