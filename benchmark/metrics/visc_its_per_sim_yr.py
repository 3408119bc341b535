"""visc_its_per_sim_yr: viscosity iterations of the window over its model
years. A count: a change in it is a change of the numerics."""


def read(run):
    return sum(c[1] for c in run.counts) / run.years
