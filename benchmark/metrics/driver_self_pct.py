"""driver_self_pct: the share of the window's wall spent outside the PC
steps and the thermodynamics steps: the region driver's own work (events,
interpolation, the segment's snapshot put back) [%]."""


def read(run):
    return (run.window_s - run.pc_s - run.thermo_s) / run.window_s * 100.0
