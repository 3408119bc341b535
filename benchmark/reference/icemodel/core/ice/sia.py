"""Shallow Ice Approximation velocity solver (pointwise analytical).

Counterpart of the reference's core/ice/sia.py, a vectorised re-derivation
of src/UFEMISM/ice_dynamics/conservation_of_momentum/SIA/SIA_main.f90
(Bueler & Brown 2009 Eqs. 12-13):

  D(z) = -2 (rho g)^n |grad Hs|^(n-1) int_b^z A(T) (Hs - zeta)^n dzeta
  u(z) = D(z) dHs/dx,  v(z) = D(z) dHs/dy      (on the b-grid)

No linear solve: a few exact mesh applies and elementwise work.
"""

from __future__ import annotations

import torch

from ..mesh_data import MeshData
from ...utils.constants import ice_density, grav
from ...mesh.zeta import integrate_from_base_up, vertical_average


def solve_SIA(C, md: MeshData, Hi, Hs, A_flow):
    """Returns (u_3D_b, v_3D_b, D_3D_b, du_dz_3D, dv_dz_3D, u_vav_b, v_vav_b).

    Hi, Hs, A_flow on the a-grid; velocities on the b-grid x nz.
    """
    n = C.Glens_flow_law_exponent
    Dmax = C.SIA_maximum_diffusivity

    # geometry applies at FULL accuracy: bf16-rounding Hs inside the f32
    # operators puts ~1e-3 absolute noise on surface slopes, which
    # dominates D ~ H^(n+2) |grad Hs|^(n-1) at low-slope interiors
    Hi_b = md.M_map_a_b.exact_matvec(Hi)
    Hs_b = md.M_map_a_b.exact_matvec(Hs)
    dHs_dx = md.M_ddx_a_a.exact_matvec(Hs)
    dHs_dy = md.M_ddy_a_a.exact_matvec(Hs)
    dHs_dx_b = md.M_ddx_a_b.exact_matvec(Hs)
    dHs_dy_b = md.M_ddy_a_b.exact_matvec(Hs)
    A_flow_b = md.M_map_a_b.exact_matvec(A_flow)   # [nTri, nz]

    zeta = md.zeta
    z_b = Hs_b[:, None] - zeta[None, :] * Hi_b[:, None]     # [nTri, nz]
    integrand = A_flow_b * torch.clamp(Hs_b[:, None] - z_b, min=0.0) ** n
    int_A = integrate_from_base_up(z_b, integrand, axis=-1)

    grad_b = torch.sqrt(dHs_dx_b ** 2 + dHs_dy_b ** 2)
    D_3D_b = (-2.0 * (ice_density * grav) ** n
              * torch.clamp(grad_b, min=1e-30)[:, None] ** (n - 1.0) * int_A)
    D_3D_b = torch.clamp(D_3D_b, min=-Dmax)

    u_3D_b = D_3D_b * dHs_dx_b[:, None]
    v_3D_b = D_3D_b * dHs_dy_b[:, None]

    # vertical shear strain rates on the a-grid (for thermodynamics)
    grad_a = torch.sqrt(dHs_dx ** 2 + dHs_dy ** 2)
    z_a = Hs[:, None] - zeta[None, :] * Hi[:, None]
    shear = (-2.0 * (ice_density * grav) ** n
             * torch.clamp(grad_a, min=1e-30)[:, None] ** (n - 1.0)
             * A_flow * torch.clamp(Hs[:, None] - z_a, min=0.0) ** n)
    du_dz_3D = shear * dHs_dx[:, None]
    dv_dz_3D = shear * dHs_dy[:, None]

    u_vav_b = vertical_average(zeta, u_3D_b, axis=-1)
    v_vav_b = vertical_average(zeta, v_3D_b, axis=-1)
    return u_3D_b, v_3D_b, D_3D_b, du_dz_3D, dv_dz_3D, u_vav_b, v_vav_b
