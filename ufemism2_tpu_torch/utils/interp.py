"""Linear interpolation in time, on the device, without a host read.

torch has no counterpart of numpy's `interp`; `interp` is the JAX
package's `jnp.interp`, step for step (the bracketing index by a right-side
search, the zero-width guard, the end values held outside the series), in
the series' dtype and on its device. `frame_weights` brackets a time
between two frames of a series of fields, as the JAX package's anomaly and
insolation models do.
"""

from __future__ import annotations

import numpy as np
import torch


def interp(x, xp, fp):
    """fp linearly interpolated at the scalar x over the increasing xp,
    clamped to fp[0] below xp[0] and fp[-1] above xp[-1]; a 0-d tensor in
    xp's dtype (x is cast to it first)."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, n - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def frame_weights(time, tt):
    """(i, w): the frames i and i + 1 of the times tt [nt] that bracket
    `time` (clamped to the ends) and the weight of frame i + 1; a
    left-side search, as the JAX package's anomaly models. The caller
    forms base + (1 - w) F[i] + w F[i + 1], in that order."""
    t = torch.clamp(torch.as_tensor(time, dtype=tt.dtype, device=tt.device),
                    tt[0], tt[-1])
    i = torch.clamp(torch.searchsorted(tt, t.reshape(1)) - 1,
                    0, len(tt) - 2)[0]
    return i, (t - tt[i]) / (tt[i + 1] - tt[i])
