"""Lagrangian tracer tracking: englacial particles and their age.

Port of the JAX package's models/tracers.py (a re-design of the
reference's src/UFEMISM/tracer_tracking/): a fixed-capacity particle
buffer [n_max] lives on the device and is advected with RK2 in the 3-D
velocity field. Point location reads a background-grid bucket table
(built on the host once per mesh) that maps a position to the nearest
triangle and vertex. Dead slots are recycled for new particles at the ice
surface.

The spawn draws: the JAX package draws the spawn vertices with
jax.random.randint from PRNGKey(7), split at every event; torch cannot
reproduce that stream, so `spawn_at_surface` takes the index draw as an
argument and the region draws it from a CPU torch.Generator (the card and
the host then draw the same indices).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.mesh_data import MeshData


class ParticleState(NamedTuple):
    x: torch.Tensor        # [nP]
    y: torch.Tensor
    zeta: torch.Tensor     # [nP] scaled vertical position
    t_origin: torch.Tensor  # [nP] deposition time
    alive: torch.Tensor    # [nP] bool


class PointLocator:
    """Background-grid bucket table for point location on the device."""

    def __init__(self, mesh, device, n_cells=256):
        from scipy.spatial import cKDTree
        self.xmin, self.xmax = mesh.xmin, mesh.xmax
        self.ymin, self.ymax = mesh.ymin, mesh.ymax
        self.n = n_cells
        gx = np.linspace(mesh.xmin, mesh.xmax, n_cells)
        gy = np.linspace(mesh.ymin, mesh.ymax, n_cells)
        X, Y = np.meshgrid(gx, gy, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], 1)
        _, tri = cKDTree(mesh.TriGC).query(pts)
        _, vtx = cKDTree(mesh.V).query(pts)
        self.tri_table = torch.as_tensor(tri.reshape(n_cells, n_cells),
                                         dtype=torch.int64, device=device)
        self.vtx_table = torch.as_tensor(vtx.reshape(n_cells, n_cells),
                                         dtype=torch.int64, device=device)

    def _cell(self, p, lo, hi):
        # truncation towards zero, as astype(int32) does, then the clamp
        c = ((p - lo) / (hi - lo) * (self.n - 1)).to(torch.int32)
        return torch.clamp(c, 0, self.n - 1).long()

    def locate(self, x, y):
        """(tri, vtx) indices for positions (x, y)."""
        ix = self._cell(x, self.xmin, self.xmax)
        iy = self._cell(y, self.ymin, self.ymax)
        return self.tri_table[ix, iy], self.vtx_table[ix, iy]


def make_tracer_stepper(C, md: MeshData, locator: PointLocator,
                        n_particles: int = 4096):
    """(init_state, step, spawn_at_surface, particles_to_mesh) of the
    particle tracker on md."""
    zeta = md.zeta
    nz = md.nz

    def sample_velocity(s, p: ParticleState):
        tri, vtx = locator.locate(p.x, p.y)
        # vertical interpolation of u, v at the particle's zeta
        k = torch.clamp(torch.searchsorted(zeta, p.zeta) - 1, 0, nz - 2)
        w = torch.clamp((p.zeta - zeta[k]) / (zeta[k + 1] - zeta[k]), 0, 1)
        u = s.u_3D_b[tri, k] * (1 - w) + s.u_3D_b[tri, k + 1] * w
        v = s.v_3D_b[tri, k] * (1 - w) + s.v_3D_b[tri, k + 1] * w
        return u, v, s.Hi[vtx], s.dHi_dt[vtx]

    def step(p: ParticleState, s, dt, time):
        """RK2 advection, the zeta update and the deaths."""
        u1, v1, _, _ = sample_velocity(s, p)
        p_mid = p._replace(x=p.x + 0.5 * dt * u1, y=p.y + 0.5 * dt * v1)
        u2, v2, Hi2, dHdt2 = sample_velocity(s, p_mid)
        x_new = p.x + dt * u2
        y_new = p.y + dt * v2
        # burial: zeta grows as the surface rises above the particle (the
        # zeta form keeps particles consistent under thinning)
        Hi_safe = torch.clamp(Hi2, min=1.0)
        dzeta_dt = (1.0 - p.zeta) * dHdt2 / Hi_safe
        zeta_new = torch.clamp(p.zeta + dt * dzeta_dt, 0.0, 1.0)
        alive = p.alive & (Hi2 > 1.0) \
            & (x_new > locator.xmin) & (x_new < locator.xmax) \
            & (y_new > locator.ymin) & (y_new < locator.ymax)
        return ParticleState(x=torch.where(alive, x_new, p.x),
                             y=torch.where(alive, y_new, p.y),
                             zeta=torch.where(alive, zeta_new, p.zeta),
                             t_origin=p.t_origin, alive=alive)

    def spawn_at_surface(p: ParticleState, s, time, idx):
        """Recycle dead slots as new surface particles on ice-covered
        vertices (create_particle_at_ice_surface); idx [nP] are the drawn
        vertex indices."""
        ok = (s.Hi > 10.0)[idx] & ~p.alive
        V = md.V
        return ParticleState(
            x=torch.where(ok, V[idx, 0], p.x),
            y=torch.where(ok, V[idx, 1], p.y),
            zeta=torch.where(ok, 0.0, p.zeta),
            t_origin=torch.where(ok, time, p.t_origin),
            alive=p.alive | ok)

    def init_state(s, time=0.0):
        kw = dict(dtype=md.A.dtype, device=md.device)
        return ParticleState(
            x=torch.zeros(n_particles, **kw),
            y=torch.zeros(n_particles, **kw),
            zeta=torch.zeros(n_particles, **kw),
            t_origin=torch.full((n_particles,), float(time), **kw),
            alive=torch.zeros(n_particles, dtype=torch.bool,
                              device=md.device))

    def particles_to_mesh(p: ParticleState, time):
        """Particle age on the mesh (nearest-vertex binned mean; the
        reference's map_particles_to_mesh). The bins are summed with
        index_add_: in particle order on the host, in atomic order on the
        card, where the sums of a bin may differ in their last bits from
        run to run."""
        _, vtx = locator.locate(p.x, p.y)
        age = time - p.t_origin
        w = p.alive.to(age.dtype)
        z = torch.zeros(md.nV, dtype=age.dtype, device=age.device)
        num = z.index_add(0, vtx, w * age)
        den = z.index_add(0, vtx, w)
        return num / torch.clamp(den, min=1e-12), den > 0

    return init_state, step, spawn_at_surface, particles_to_mesh

