"""sim_yr_per_hr: model years completed in the window over the window's
wall seconds (host clock, ending in a synchronisation), times 3600."""


def read(run):
    return run.years / run.window_s * 3600.0
