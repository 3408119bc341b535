"""Global forcings: CO2 and sea level.

Re-design of src/UFEMISM/global_forcings/global_forcings_main.f90: the
sea level and CO2 shared by all model regions - the 'fixed' sea level, the
'prescribed' sea-level series, a constant CO2 and the 'CO2_direct' record.
The series are read from NetCDF files through io/ncio.py (time and value
under any of the reference's accepted names) and interpolated linearly in
time.
"""

from __future__ import annotations

import numpy as np

from ..io.ncio import NCFile

# the reference's accepted spellings (netcdf_field_name_options.f90)
_ALIASES = {
    "time": ["time", "Time", "t", "nt"],
    "sealevel": ["SL", "sea_level", "sl"],
    "CO2": ["CO2", "co2"],
}


class GlobalForcings:
    def __init__(self, C):
        self.C = C
        self.CO2 = 280.0
        self.sealevel = 0.0
        self._sl_series = None
        self._co2_series = None
        self.choice_sealevel = C.choice_sealevel_model
        if self.choice_sealevel == "fixed":
            self.sealevel = C.fixed_sealevel
        elif self.choice_sealevel == "prescribed" \
                and C.filename_prescribed_sealevel:
            self._sl_series = _read_series(C.filename_prescribed_sealevel,
                                           "sealevel")
        # CO2 record (global_forcings_main.f90 'CO2_direct')
        if C.choice_matrix_forcing == "CO2_direct" and C.filename_CO2_record:
            self._co2_series = _read_series(C.filename_CO2_record, "CO2")

    def update(self, time: float):
        """update_sealevel_at_model_time + CO2 at time."""
        if self._sl_series is not None:
            t, v = self._sl_series
            self.sealevel = float(np.interp(time, t, v))
        if self._co2_series is not None:
            t, v = self._co2_series
            self.CO2 = float(np.interp(time, t, v))
        return self


def _read_series(path, var):
    """(time, value) of a 1-D record, each found under any of its
    accepted names."""
    with NCFile(path) as nc:
        out = []
        for field in ("time", var):
            name = next((a for a in _ALIASES[field] if nc.has(a)), None)
            if name is None:
                raise KeyError(f"no variable matching '{field}' in {path}")
            out.append(np.asarray(nc.read(name), np.float64))
    return tuple(out)
