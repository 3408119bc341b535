"""Regular square grids (the reference's 'grid' type).

Re-design of src/UPSY/basic/grid_basic.f90 (setup_square_grid): a simple
x/y grid container (the gridded output, the rasterised geometry of a mesh
update, gridded input files) and the regular lon/lat grid of global input
files (grid_lonlat_basic.f90).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Grid:
    x: np.ndarray     # [nx] cell centres
    y: np.ndarray     # [ny]
    dx: float
    dy: float = None  # defaults to dx (square cells); input grids may differ

    def __post_init__(self):
        if self.dy is None:
            self.dy = self.dx

    @property
    def nx(self):
        return len(self.x)

    @property
    def ny(self):
        return len(self.y)

    @property
    def n(self):
        return self.nx * self.ny

    def cell_polygons(self):
        """[n, 4, 2] corner polygons of all cells (row-major x, then y)."""
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        cx = X.ravel()
        cy = Y.ravel()
        hx = self.dx / 2
        hy = self.dy / 2
        poly = np.empty((self.n, 4, 2))
        poly[:, 0] = np.stack([cx - hx, cy - hy], 1)
        poly[:, 1] = np.stack([cx + hx, cy - hy], 1)
        poly[:, 2] = np.stack([cx + hx, cy + hy], 1)
        poly[:, 3] = np.stack([cx - hx, cy + hy], 1)
        return poly

    def centres(self):
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        return np.stack([X.ravel(), Y.ravel()], 1)


def setup_square_grid(xmin, xmax, ymin, ymax, dx) -> Grid:
    """Grid covering the domain (grid_basic.f90 setup_square_grid)."""
    nx = int(np.floor((xmax - xmin) / dx)) + 1
    ny = int(np.floor((ymax - ymin) / dx)) + 1
    # centre the grid on the domain
    x0 = 0.5 * (xmin + xmax) - 0.5 * (nx - 1) * dx
    y0 = 0.5 * (ymin + ymax) - 0.5 * (ny - 1) * dx
    return Grid(x=x0 + np.arange(nx) * dx, y=y0 + np.arange(ny) * dx, dx=dx)


@dataclass
class GridLonLat:
    """Regular lon/lat grid (grid_lonlat_basic.f90): gridded global input
    data (climate/ocean snapshots, geothermal flux)."""
    lon: np.ndarray   # [nlon] degrees east, ascending
    lat: np.ndarray   # [nlat] degrees north, ascending

    @property
    def nlon(self):
        return len(self.lon)

    @property
    def nlat(self):
        return len(self.lat)

    @property
    def n(self):
        return self.nlon * self.nlat

    def bilinear_weights(self, lon_q, lat_q):
        """Bilinear interpolation stencil at query lon/lat points.

        Returns (idx [n,4], w [n,4]) into the flattened [lon, lat] grid;
        longitude wraps around the 0/360 seam (map_lonlat_grid_to_mesh).
        """
        lon_q = np.asarray(lon_q) % 360.0
        lat_q = np.clip(np.asarray(lat_q), self.lat[0], self.lat[-1])
        li = np.searchsorted(self.lon, lon_q) - 1
        li0 = li % self.nlon
        li1 = (li + 1) % self.nlon
        dlon = (self.lon[li1] - self.lon[li0]) % 360.0
        dlon = np.where(dlon == 0.0, 360.0, dlon)
        wl = ((lon_q - self.lon[li0]) % 360.0) / dlon
        yi = np.clip(np.searchsorted(self.lat, lat_q) - 1, 0, self.nlat - 2)
        wy = np.clip((lat_q - self.lat[yi])
                     / (self.lat[yi + 1] - self.lat[yi]), 0.0, 1.0)
        idx = np.stack([li0 * self.nlat + yi,
                        li1 * self.nlat + yi,
                        li0 * self.nlat + yi + 1,
                        li1 * self.nlat + yi + 1], axis=1)
        w = np.stack([(1 - wl) * (1 - wy), wl * (1 - wy),
                      (1 - wl) * wy, wl * wy], axis=1)
        return idx, w
