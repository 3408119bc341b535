"""diva_operator_roofline: the least time the card needs for one apply of the DIVA operator,
counted once from shapes (workcount.diva_work) at the published peaks, times
the calls in the traced segments, over the device time of every kernel
launched inside those calls' ranges [%]."""

from ..workcount import diva_work
from ._roofline import share


def read(run):
    return share(run, "diva_operator", "diva", diva_work)
