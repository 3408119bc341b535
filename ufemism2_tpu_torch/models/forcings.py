"""Global forcings: CO2 and sea level.

Re-design of src/UFEMISM/global_forcings/global_forcings_main.f90: the
sea level and CO2 shared by all model regions. Ported: the 'fixed' sea
level and the constant CO2. The 'prescribed' sea-level series and the CO2
record are read from NetCDF files and raise NotImplementedError until the
port has its file input (ROADMAP A.18).
"""

from __future__ import annotations


class GlobalForcings:
    def __init__(self, C):
        self.C = C
        self.CO2 = 280.0
        self.choice_sealevel = C.choice_sealevel_model
        self.sealevel = 0.0
        if self.choice_sealevel == "fixed":
            self.sealevel = C.fixed_sealevel
        elif self.choice_sealevel == "prescribed" \
                and C.filename_prescribed_sealevel:
            raise NotImplementedError(
                "choice_sealevel_model 'prescribed' reads a NetCDF series, "
                "which the port cannot read yet (ROADMAP A.18)")
        # CO2 record (global_forcings_main.f90 'CO2_direct')
        if C.choice_matrix_forcing == "CO2_direct" and C.filename_CO2_record:
            raise NotImplementedError(
                "choice_matrix_forcing 'CO2_direct' reads a NetCDF CO2 "
                "record, which the port cannot read yet (ROADMAP A.18)")

    def update(self, time: float):
        """update_sealevel_at_model_time + CO2 at time: constant here."""
        return self
