"""Regular square grids (the reference's 'grid' type).

Re-design of src/UPSY/basic/grid_basic.f90 (setup_square_grid): a simple
x/y grid container; the port uses it for the gridded output and for the
rasterised geometry of a mesh update (the lon/lat grid waits for GIA).
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
