"""Seconds each phase of a `chip_smoke.py` run took, side by side for
several runs.

    python3 tools/phase_seconds.py run_a.out run_b.out ...

Reads the JSON lines a run printed; every line with an `at_s` stamp (the
script's clock when it was printed) is charged the seconds since the line
before it, under its `phase` (or its `case`). Phases are summed into the
groups of GROUPS (a phase goes to the group of its longest prefix there),
each run in a column; the last row is the whole run (the last stamp). The
lines of a card job (a `job` key: phases run in a process of their own
beside the script's) are charged on their own, since the job's line before,
in rows of their own marked with the job's name; those rows overlap the
script's and are not part of its sum.
"""
import json
import sys

GROUPS = (
    ("build and kernel cases", ("device", "build", "bpa_case", "thomas_case",
                                "kernel_case", "diva_case", "heat_case")),
    ("8 km main, thermodynamics, Halfar", (
        "mesh", "small", "small_thermo", "small_mismipplus", "initial_solve",
        "warm_up", "main_path", "thermo_initial_solve", "thermo_warm_up",
        "thermo_path", "halfar", "precond_solve")),
    ("multidevice (2 and 4 gloo ranks)", ("multidevice",)),
    ("MISMIP+, remesh, resume", ("mismipplus", "remesh", "small_remesh",
                                 "mismipplus_resume")),
    ("experiment II, ice1r, Favier, files", (
        "berends_exp2", "mismipplus_ice1r", "mismipplus_favier",
        "small_berends", "small_thermo_files")),
    ("ISMIP-HOM", ("ismip_hom",)),
    ("small_ismip (waits on its CPU job)", ("small_ismip",)),
    ("Antarctica, climate, hydrology", ("antarctica", "small_climate",
                                        "small_hydro")),
    ("mismipplus_iceocean1r", ("mismipplus_iceocean1r",)),
    ("LADDIE kernel cases and legs", ("laddie_case", "laddie_step",
                                      "laddie_leg", "laddie_kernel")),
    ("laddie_standalone, small_iceocean", ("laddie_standalone",
                                           "small_iceocean")),
)


def group_of(key):
    """The group of the longest name in GROUPS that is the key or a prefix
    of it ending at an underscore."""
    best, name = 0, "other"
    for g, keys in GROUPS:
        for k in keys:
            if (key == k or key.startswith(k + "_")) and len(k) > best:
                best, name = len(k), g
    return name


def phase_seconds(path):
    """{group: seconds} of one run's output, and "whole run"."""
    out, prev, last = {}, {None: 0.0}, 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if "at_s" not in d:
                continue
            job = d.get("job")
            g = group_of(d.get("phase") or d.get("case") or "")
            if job is not None:
                g = f"{g} (card job {job})"
            out[g] = out.get(g, 0.0) + d["at_s"] - prev.get(job, d["at_s"])
            prev[job] = d["at_s"]
            if job is None:
                last = d["at_s"]
    out["whole run"] = last
    return out


def main(paths):
    runs = [phase_seconds(p) for p in paths]
    names = [n for n, _ in GROUPS] + ["other"]
    names += sorted({n for r in runs for n in r
                     if n not in names and n != "whole run"})
    print("| group | " + " | ".join(paths) + " |")
    print("| --- |" + " --- |" * len(paths))
    for n in names + ["whole run"]:
        if any(n in r for r in runs):
            print(f"| {n} | " + " | ".join(f"{r.get(n, 0.0):.1f}"
                                          for r in runs) + " |")


if __name__ == "__main__":
    main(sys.argv[1:])
