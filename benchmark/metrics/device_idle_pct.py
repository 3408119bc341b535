"""device_idle_pct: the share of a segment's wall in which no operation
ran on the device [%]: the device time of the traced segments (the union
of the trace's device intervals) against the wall that segments from the
same starting states took in the untraced window. Under the profiler the
host runs them about twice as slowly, so the traced block's own idle share
(the result line's `device.busy_s` over `device.window_s`) reads higher."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0 or not run.traced_untraced_s:
        return None
    return (1.0 - p["busy_s"] / run.traced_untraced_s) * 100.0
