"""launches_per_krylov_it: kernels the device ran in the traced segments
(the profiler's trace) over their Krylov iterations (GMRES and the
thickness solve's BiCGSTAB)."""


def read(run):
    p = run.profile
    its = sum(c[2] for c in p["counts"]) if p else 0
    if not its or not p["kernel_launches"]:
        return None
    return p["kernel_launches"] / its
