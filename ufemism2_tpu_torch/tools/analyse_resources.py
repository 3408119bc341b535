"""upsy-analyse-resources equivalent: computation-time analysis.

Re-design of tools/python/upsy/analyse_resources.py + the MATLAB
AA_analyse_computation_time.m: read the per-coupling-interval
resource_tracking.jsonl written by the main program into its output
directory (main/program.py _write_resource_record; the JAX package's has
the same layout), aggregate per-routine
exclusive wall time, and print a ranked table (optionally a stacked
time-evolution plot of the top routines).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_records(path):
    """[(t, {routine: {tcomp, ncalls}})] from a resource_tracking.jsonl."""
    recs = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        r = json.loads(line)
        recs.append((r["t"], r["routines"]))
    return recs


def aggregate(recs):
    """{routine: (tcomp_total, ncalls_total)} over all intervals."""
    agg = {}
    for _t, routines in recs:
        for k, v in routines.items():
            tc, nc = agg.get(k, (0.0, 0))
            agg[k] = (tc + v["tcomp"], nc + v["ncalls"])
    return agg


def report(agg, top_n=30):
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    total = sum(tc for tc, _ in agg.values())
    lines = [f"{'routine':64s} {'t_excl [s]':>11s} {'%':>6s} {'calls':>9s}"]
    for k, (tc, nc) in rows[:top_n]:
        pct = 100.0 * tc / max(total, 1e-30)
        lines.append(f"{k[:64]:64s} {tc:11.3f} {pct:6.1f} {nc:9d}")
    lines.append(f"{'TOTAL (exclusive sum)':64s} {total:11.3f}")
    return "\n".join(lines)


def plot_evolution(recs, top_n=8, output=None):
    """Stacked per-interval wall time of the top routines."""
    import matplotlib
    if output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    agg = aggregate(recs)
    top = [k for k, _ in sorted(agg.items(),
                                key=lambda kv: -kv[1][0])[:top_n]]
    t = np.array([r[0] for r in recs])
    series = {k: np.array([r[1].get(k, {"tcomp": 0.0})["tcomp"]
                           for r in recs]) for k in top}
    other = np.array([sum(v["tcomp"] for kk, v in r[1].items()
                          if kk not in top) for r in recs])
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.stackplot(t, *series.values(), other,
                 labels=[k.split("/")[-1][:40] for k in top] + ["other"])
    ax.set_xlabel("model time [yr]")
    ax.set_ylabel("wall time per coupling interval [s]")
    ax.legend(loc="upper left", fontsize=7)
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=150)
        print(f"wrote {output}")
    else:
        plt.show()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="upsy-analyse-resources",
        description="Analyse a run's resource_tracking.jsonl")
    p.add_argument("path", help="run output dir or resource_tracking.jsonl")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--plot", action="store_true",
                   help="stacked time-evolution plot of the top routines")
    p.add_argument("-o", "--output", default=None, help="PNG path for --plot")
    args = p.parse_args(argv)

    path = Path(args.path)
    if path.is_dir():
        path = path / "resource_tracking.jsonl"
    recs = load_records(path)
    print(f"{len(recs)} coupling intervals in {path}")
    print(report(aggregate(recs), args.top))
    if args.plot:
        plot_evolution(recs, output=args.output)


if __name__ == "__main__":
    main()
