"""thermo_ms_per_step: wall of a thermodynamics step, each timed between two
synchronisations in the traced run's window [ms]."""


def read(run):
    if run.thermo_n == 0:
        return None
    return run.thermo_s / run.thermo_n * 1e3
