"""Insolation forcing: monthly top-of-atmosphere shortwave at the mesh's
vertices.

Re-design of the reference's insolation handling (climate_realistic.f90:
245-322 initialise_insolation_forcing, climate_model_utilities.f90:334-443
get_insolation_at_time): where the reference keeps a two-frame window and
re-reads the file whenever the model time leaves it, every timeframe the
run can touch (its window and one frame either side) is read at set-up and
held on the device as one [n_frames, nV, 12] tensor; `at_time` interpolates
in it without a host read.

As in the JAX package, a time outside that window is clamped to its ends,
so the matrix climate's orbit times (climate_matrix_warm/cold_orbit_time)
read the window's edge frame where the reference reads the file at the
orbit time: a run starting at 0 takes the frame before 0 for a cold orbit
at -21000. The port keeps this for parity; ROADMAP.md C records it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.interp import frame_weights


class InsolationForcing:
    """Q_TOA(t) [nV, 12]: 'none' (zero), 'static' (the frame nearest
    static_insolation_time) or 'realistic' (interpolated in time)."""

    def __init__(self, C, mesh, dtype=torch.float64, device="cpu"):
        self.choice = C.choice_insolation_forcing
        kw = dict(dtype=dtype, device=device)
        if self.choice == "none":
            self._static = torch.zeros((mesh.nV, 12), **kw)
            return
        if self.choice not in ("static", "realistic"):
            raise ValueError(
                f"unknown choice_insolation_forcing '{self.choice}'")

        from ..io.input_files import read_field_from_file_2D_monthly
        from ..io.ncio import NCFile, find_field

        fname = C.filename_insolation
        with NCFile(fname) as nc:
            t_all = np.asarray(find_field(nc, "time"), dtype=np.float64)

        if self.choice == "static":
            t_want = [float(t_all[np.argmin(
                np.abs(t_all - C.static_insolation_time))])]
        else:
            t0 = min(C.start_time_of_run, 0.0)
            t1 = C.end_time_of_run
            i0 = max(0, int(np.searchsorted(t_all, t0)) - 1)
            i1 = min(len(t_all), int(np.searchsorted(t_all, t1)) + 2)
            t_want = list(t_all[i0:i1])

        Q = np.stack([read_field_from_file_2D_monthly(
            fname, "insolation", mesh, time_to_read=t) for t in t_want])
        if self.choice == "static":
            self._static = torch.as_tensor(Q[0], **kw)
        else:
            self._static = None
            self._t = torch.as_tensor(np.asarray(t_want), **kw)
            self._Q = torch.as_tensor(Q, **kw)

    def at_time(self, time):
        """[nV, 12] insolation at the model time, clamped to the preloaded
        window's ends (the reference's safety on the weights); the frame
        index is a left-side search, as the JAX package's."""
        if self._static is not None:
            return self._static
        i, w = frame_weights(time, self._t)
        return (1.0 - w) * self._Q[i] + w * self._Q[i + 1]
