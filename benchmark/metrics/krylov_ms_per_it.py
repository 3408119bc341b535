"""krylov_ms_per_it: wall inside the stress balance's GMRES calls over
their iterations, in the window [ms]."""


def read(run):
    if run.gmres_its == 0:
        return None
    return run.gmres_s / run.gmres_its * 1e3
