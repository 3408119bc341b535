"""Physical and mathematical constants.

Mirrors the reference's parameter module (src/UPSY/basic/parameters.f90) so
that parity runs agree bit-for-bit on constants.
"""

import numpy as np

pi = np.pi

sec_per_year = 31556943.36        # = 365.2424 * 24 * 3600
sec_per_day = 86400.0
T0 = 273.16                       # [K]      triple point of water
Clausius_Clapeyron_gradient = 8.7e-04   # [K m^-1]
grav = 9.81                       # [m s^-2]
earth_radius = 6.371221e6         # [m]
L_fusion = 3.335e+5               # [J kg^-1]
ice_density = 917.0               # [kg m^-3]
freshwater_density = 1000.0       # [kg m^-3]
seawater_density = 1027.0         # [kg m^-3]
earth_density = 5511.57           # [kg m^-3]
R_gas = 8.314                     # [J mol^-1 K^-1]
cp_ocean = 3.974e3                # [J kg^-1 K^-1]
ocean_area = 3.611e14             # [m^2]
earth_rotation_rate = 7.2921e-5   # [s^-1]

# LADDIE parameters (reference parameters.f90, LADDIE section)
freezing_lambda_1 = -5.73e-2      # [K PSU^-1] freezing point salinity coeff
freezing_lambda_2 = 8.32e-2       # [K]        freezing point offset
freezing_lambda_3 = 7.61e-4       # [K m^-1]   freezing point depth coeff
cp_ice = 2009.0                   # [J kg^-1 K^-1]
Stanton_number = 5.9e-4
Prandtl_number = 13.8
Schmidt_number = 2432.0
molecular_viscosity = 1.95e-6     # [m^2 s^-1]
