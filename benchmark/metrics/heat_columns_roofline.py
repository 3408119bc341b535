"""heat_columns_roofline: the least time the card needs for one column solve of a thermodynamics
step (from the masks of the last call's operands),
counted once from shapes (workcount.heat_work) at the published peaks, times
the calls in the traced segments, over the device time of every kernel
launched inside those calls' ranges [%]."""

from ..workcount import heat_work
from ._roofline import share


def read(run):
    return share(run, "heat_columns", "heat", heat_work)
