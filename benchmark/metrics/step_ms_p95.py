"""step_ms_p95: the 95th percentile of the wall time of every ice step of
the window [ms]: the gaps between successive entries into the PC step on
the host clock, with no synchronisation added; the window's last step ends
at the window's synchronisation."""

import numpy as np


def read(run):
    if len(run.step_s) < 20:
        return None
    return float(np.percentile(np.asarray(run.step_s), 95)) * 1e3
