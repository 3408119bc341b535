"""bpa_operator_roofline: the least time the card needs for one apply of the BPA operator (both its
kernels),
counted once from shapes (workcount.bpa_work) at the published peaks, times
the calls in the traced segments, over the device time of every kernel
launched inside those calls' ranges [%]."""

from ..workcount import bpa_work
from ._roofline import share


def read(run):
    return share(run, "bpa_operator", "bpa", bpa_work)
