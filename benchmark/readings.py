#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2] [--witness-seeds 1] [--out FILE]

Sets the cell up once; then, for each seed, runs the segments up to the
one the seed samples, in the seed's order of starting states, with its
steps recorded, and compares them with the plain reference as a run does
(the program's numbers: the lower readings). For each control seed it also
puts the control - the reference one precision lower - in the program's
place on the same starting states (the upper readings); for each witness
seed it holds both to the frozen model in float64 as well. One JSON line a
seed on standard output (and in FILE)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def dt_terms(ref, pre, dt_max):
    """The terms of the time step that the reference's PC step chooses
    from the state `pre` before any retry (Robinson et al. 2020, Eq. 33,
    then dt_max, the growth cap and the critical time step), and that
    choice."""
    import torch
    from benchmark.reference.icemodel.core.ice.mass import \
        calc_critical_timestep_adv
    from benchmark.reference.icemodel.core.ice.masks import (
        calc_mask_noice, determine_masks)
    C, md, s = ref.C, ref.md, ref.state_from(pre)
    dt_n = s.pc.dt_np1
    eps = C.pc_epsilon
    terms = {"controller": (eps / s.pc.eta_np1) ** (C.pc_k_I + C.pc_k_p)
             * (eps / s.pc.eta_n) ** (-C.pc_k_p) * dt_n,
             "dt_max": float(dt_max),
             "growth": C.pc_max_time_step_increase * dt_n}
    noice = calc_mask_noice(md, C.choice_mask_noice)
    Hi = torch.where(noice, 0.0, s.Hi_next)
    m = determine_masks(md, Hi, s.Hb, s.SL)
    terms["dt_crit"] = float(calc_critical_timestep_adv(
        C, md, Hi, m["mask_floating_ice"], s.u_vav_b, s.v_vav_b))
    terms["chosen"] = max(min(terms.values()), C.dt_ice_min)
    return terms


def survey(ref, rec):
    """For every recorded step: the program's time step over the one the
    reference chooses before a retry, the term that set it, and the
    program's truncation error over the tolerance."""
    out = []
    eps = ref.C.pc_epsilon
    for pre, post, dt_max in rec:
        t = dt_terms(ref, pre, dt_max)
        bind = min((k for k in t if k != "chosen"), key=t.get)
        out.append([post.dt_ice / t["chosen"], bind, post.pc.eta_np1 / eps])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    from benchmark import harness, spec
    from benchmark.reference import compare
    from benchmark.reference.model import ReferenceModel, build_mesh
    import torch
    import numpy as np
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("readings: no CUDA device")
        return 1
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    run = harness.Run(cell, seeds[0], 0.0, 0, t_start=T_START)
    run.setup()
    cfg = cell.program_config()
    t = time.perf_counter()
    mesh = build_mesh(cfg)
    ref = compare.reference(cfg, mesh, "cuda")
    # a witness: the same frozen model in float64, the program's steps and
    # the control's held to it as well (--witness-seeds)
    f64 = ReferenceModel(cfg, mesh, "cuda", "f64")
    harness.log(f"readings: set-up {run.setup_s:.1f} s, reference "
                f"{time.perf_counter() - t:.1f} s")
    n_check = int(cell.traffic["check_steps"])
    for seed in seeds:
        # the run's draws for this seed: the order of the starting states,
        # the sampled segment, the steps compared
        rng = np.random.default_rng(seed)
        run.order = [int(j) for j in rng.permutation(len(run.pool))]
        lo, hi = cell.traffic["sampled_segment"]
        k = int(rng.integers(lo, hi + 1))
        counts = [run.segment(run.start(i)) for i in range(k)]
        run.probe.record, run.probe.record_thermo = rec, rec_th = [], []
        counts.append(run.segment(run.start(k)))
        run.probe.record = run.probe.record_thermo = None
        steps, th = compare.checked_steps(
            rec, rec_th, n_check,
            int(cell.traffic.get("check_thermo_steps", 0)),
            np.random.default_rng([seed, 1]))
        line = {"workload": cell.name, "seed": seed, "sampled_segment": k,
                "start": run.order[k % len(run.order)],
                "segment_counts": counts, "steps_checked": len(steps),
                "thermo_checked": len(th)}
        detail = []
        for name, fn in (
                ("program", lambda: compare.step_gaps(ref, steps, th,
                                                      detail=detail)),
                ("control", lambda: compare.control_gaps(ref, steps, th)),
                ("program_f64", lambda: compare.step_gaps(f64, steps, th)),
                ("control_f64", lambda: compare.step_gaps(
                    f64, steps, th, against=ref, lowered=compare.lowered))):
            if name != "program" and seed not in (
                    witness if name.endswith("f64") else control):
                continue
            t = time.perf_counter()
            line[name] = fn()
            line[name + "_s"] = time.perf_counter() - t
        eps = ref.C.pc_epsilon
        line["steps"] = [[d["dt"] / d["dt_ref"], d["eta"] / eps,
                          d["eta_ref"] / eps] for d in detail]
        line["survey"] = survey(ref, rec)
        line["card"] = harness.card_line()
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
