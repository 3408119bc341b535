"""The arithmetic the roofline readers share."""

from ..workcount import bound_s


def share(run, range_name, sample, work):
    """Calls of `range_name` in the traced segments times the bound of one
    call (the work of the last sampled call), over the device time of the
    kernels inside those calls [%]; None where the trace has none."""
    p = run.profile
    if not p or sample not in run.samples:
        return None
    r = p["ranges"].get(range_name)
    if not r or r["count"] == 0 or r["device_s"] <= 0:
        return None
    return r["count"] * bound_s(*work(run.samples[sample])) \
        / r["device_s"] * 100.0
