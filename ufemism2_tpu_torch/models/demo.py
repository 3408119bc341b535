"""Demo model: the fields-framework reference implementation.

Re-design of src/UPSY/models/demo_model/ (demo_model.f90 +
demo_model_{a,b}.f90): a minimal model with two selectable variants that
exercises the whole model contract - metadata-registered state fields,
generic remap on mesh update, restart write/read - exactly what the
reference's demo model exists to demonstrate (and what its fields-
framework unit tests use as a fixture).

Variant 'a': diffusion of a scalar field on the mesh.
Variant 'b': advection of the same field by a solid-body rotation.

The state lives on the device of the MeshData it was initialised on; the
model time is a host float, as the ice state's times are. The restart is a
NetCDF classic file holding the mesh, phi and the time as a scalar
variable.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.fields import FieldMeta


@dataclass
class DemoState:
    phi: torch.Tensor    # [nV] the demo scalar field
    t: float             # model time [yr]

    def replace(self, **changes):
        return replace(self, **changes)


DEMO_FIELD_META = {
    "phi": FieldMeta("a", "", "-", "demo scalar field", "conservative"),
    "t": FieldMeta("0", "", "yr", "demo model time", "copy"),
}


@dataclass
class DemoModel:
    """create_demo_model(choice) equivalent: 'a' (diffusion) or 'b'
    (rotation advection)."""
    choice: str = "a"

    def initialise(self, md):
        """Gaussian bump initial condition."""
        V = md.V.double().cpu().numpy()
        r2 = (V[:, 0] ** 2 + V[:, 1] ** 2)
        L = max(float(np.abs(V).max()), 1.0)
        phi = torch.as_tensor(np.exp(-r2 / (0.1 * L) ** 2),
                              dtype=md.A.dtype, device=md.device)
        self.md = md
        self._step = self._make_step(md)
        return DemoState(phi=phi, t=0.0)

    def _make_step(self, md):
        choice = self.choice
        if choice == "a":
            n = md.mask_C.sum(dim=1).clamp(min=1)

            def step(s: DemoState, dt):
                # neighbour-mean diffusion (stable explicit scheme)
                nbr = torch.where(md.mask_C, s.phi[md.C],
                                  s.phi.new_zeros(()))
                lap = nbr.sum(dim=1) / n - s.phi
                return s.replace(phi=s.phi + 0.4 * dt * lap, t=s.t + dt)
            return step
        if choice == "b":
            V = md.V
            omega = 2.0 * np.pi / 100.0
            idx = torch.arange(md.nV, device=md.device)

            def step(s: DemoState, dt):
                # semi-Lagrangian solid-body rotation: evaluate phi at the
                # back-rotated neighbour (nearest-vertex gather)
                ang = torch.tensor(-omega * dt, dtype=V.dtype,
                                   device=V.device)
                c, sn = torch.cos(ang), torch.sin(ang)
                xb = c * V[:, 0] - sn * V[:, 1]
                yb = sn * V[:, 0] + c * V[:, 1]
                d2 = ((V[md.C, 0] - xb[:, None]) ** 2
                      + (V[md.C, 1] - yb[:, None]) ** 2)
                d2 = torch.where(md.mask_C, d2, torch.inf)
                d2_self = (V[:, 0] - xb) ** 2 + (V[:, 1] - yb) ** 2
                best = torch.argmin(d2, dim=1)
                cand = torch.gather(md.C, 1, best[:, None])[:, 0]
                use_self = d2_self <= torch.gather(d2, 1, best[:, None])[:, 0]
                src = torch.where(use_self, idx, cand)
                return s.replace(phi=s.phi[src], t=s.t + dt)
            return step
        raise ValueError(f"unknown choice_demo_model '{self.choice}'")

    def run(self, s: DemoState, t_end: float, dt: float = 1.0):
        while s.t < t_end - 1e-9:
            s = self._step(s, min(dt, t_end - s.t))
        return s

    def remap(self, s: DemoState, old_mesh, new_mesh, new_md):
        """Generic metadata-driven remap onto a new mesh (the framework
        contract demo_model_remap.f90 demonstrates); the map is built on
        the host (remap/atlas.py)."""
        from ..remap.atlas import get_map
        M = get_map(old_mesh, new_mesh)
        phi_new = torch.as_tensor(M @ s.phi.double().cpu().numpy(),
                                  dtype=new_md.A.dtype, device=new_md.device)
        self.md = new_md
        self._step = self._make_step(new_md)
        return DemoState(phi=phi_new, t=s.t)

    def write_restart(self, path, mesh, s: DemoState):
        from ..io.ncio import NCFile
        from ..io.output_files import setup_mesh_in_file
        with NCFile(path, "w") as nc:
            setup_mesh_in_file(nc, mesh)
            nc.def_var("phi", ("vi",))
            nc.put("phi", s.phi.double().cpu().numpy())
            nc.def_var("t", ())
            nc.put("t", np.asarray(s.t, np.float64))

    def read_restart(self, path, md):
        from ..io.ncio import NCFile
        with NCFile(path) as nc:
            phi = torch.as_tensor(nc.read("phi"), dtype=md.A.dtype,
                                  device=md.device)
            t = float(np.asarray(nc.read("t")).reshape(()))
        return DemoState(phi=phi, t=t)
