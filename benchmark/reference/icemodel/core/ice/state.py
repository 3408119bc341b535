"""Ice model state.

Analogue of the reference's mutable type_ice_model
(src/UFEMISM/types/ice_model_types.f90:297-533): plain dataclasses threaded
through step functions (state-in, state-out) with `.replace(...)`. Fields
are tensors on one device; model time, time steps and the solver-effort
counters are host-side Python floats and ints (float64 by construction,
whatever the field dtype).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .geometry import ice_surface_elevation, thickness_above_flotation


class _Replaceable:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        """Copy with every tensor field on `device`."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Replaceable)):
                moved[f.name] = v.to(device)
        return self.replace(**moved)


@dataclass
class PCState(_Replaceable):
    """Predictor-corrector controller state (Robinson et al. 2020)."""
    dt_n: float              # previous time step [yr]
    dt_np1: float            # current time step [yr]
    eta_n: float             # previous max truncation error
    eta_np1: float           # current max truncation error
    dHi_dt_Hi_nm1_u_nm1: torch.Tensor  # [nV] thinning rates of previous step
    tau_np1: torch.Tensor    # [nV] truncation error field (ice%pc%tau_np1,
    #                          the pc_truncation_error output)


@dataclass
class IceState(_Replaceable):
    """Per-vertex/triangle ice model state."""
    # geometry (a-grid)
    Hi: torch.Tensor         # [nV] ice thickness
    Hb: torch.Tensor         # [nV] bedrock elevation
    SL: torch.Tensor         # [nV] sea level
    Hs: torch.Tensor         # [nV] surface elevation
    Hib: torch.Tensor        # [nV] ice base elevation
    TAF: torch.Tensor        # [nV] thickness above flotation
    dHb: torch.Tensor        # [nV] bedrock deformation (GIA)

    # rates
    dHi_dt: torch.Tensor     # [nV]
    divQ: torch.Tensor       # [nV]
    dHi_dt_target: torch.Tensor  # [nV] (inversion target; zero by default)

    # prediction window
    t_Hi_prev: float         # [yr]
    t_Hi_next: float
    Hi_prev: torch.Tensor    # [nV]
    Hi_next: torch.Tensor    # [nV]

    # masks
    mask_noice: torch.Tensor         # [nV] bool
    mask_icefree_land: torch.Tensor
    mask_icefree_ocean: torch.Tensor
    mask_grounded_ice: torch.Tensor
    mask_floating_ice: torch.Tensor
    mask_margin: torch.Tensor
    mask_gl_gr: torch.Tensor
    mask_gl_fl: torch.Tensor
    mask_cf_gr: torch.Tensor
    mask_cf_fl: torch.Tensor
    mask_coastline: torch.Tensor
    mask: torch.Tensor               # [nV] int

    # sub-grid
    fraction_margin: torch.Tensor    # [nV]
    fraction_gr: torch.Tensor        # [nV] grounded fraction (a)
    fraction_gr_b: torch.Tensor      # [nTri] grounded fraction (b)
    Hi_eff: torch.Tensor             # [nV]

    # rheology
    A_flow: torch.Tensor             # [nV,nz] Glen flow factor

    # basal conditions
    bed_roughness: torch.Tensor      # [nV] generic (nudgable) roughness

    # velocities
    u_vav_b: torch.Tensor            # [nTri]
    v_vav_b: torch.Tensor            # [nTri]
    u_3D_b: torch.Tensor             # [nTri,nz]
    v_3D_b: torch.Tensor             # [nTri,nz]

    # stress-balance solver warm-start state: the reference's DIVA
    # solver keeps tau_b / eta_3D in type_ice_velocity_solver_DIVA
    # BETWEEN solves, so iteration 1 of a new solve sees the previous
    # step's converged vertical-shear feedback. Without these the
    # viscosity iteration re-converges that feedback from zero every step.
    visc_tau_bx: torch.Tensor        # [nTri] basal shear stress x
    visc_tau_by: torch.Tensor        # [nTri]
    visc_eta_3D_b: torch.Tensor      # [nTri,nz] effective viscosity

    # thermodynamics
    Ti: torch.Tensor                 # [nV,nz] englacial temperature

    # pc controller
    pc: PCState

    # solver-effort counters (scoreboard metrics)
    dt_ice: float                    # last dt
    n_visc_its: int
    n_Axb_its: int

    def solver_aux(self):
        """The stress-balance warm-start fields as a solver returns them:
        a solver without warm-start state of its own carries these
        through unchanged."""
        return {"visc_tau_bx": self.visc_tau_bx,
                "visc_tau_by": self.visc_tau_by,
                "visc_eta_3D_b": self.visc_eta_3D_b}


def init_ice_state(md, Hi, Hb, SL, nz: int, dt_init: float = 0.1,
                   Ti_init: float = 270.0) -> IceState:
    """Fresh ice state from initial geometry on the mesh (a-grid arrays)."""
    nV = md.nV
    nTri = md.nTri
    dtype = md.A.dtype
    dev = md.device
    kw = dict(dtype=dtype, device=dev)
    zeros_v = torch.zeros(nV, **kw)
    zeros_t = torch.zeros(nTri, **kw)
    f = lambda x: torch.as_tensor(x, **kw)
    Hi, Hb, SL = f(Hi), f(Hb), f(SL)
    Hs = ice_surface_elevation(Hi, Hb, SL)
    bfalse = torch.zeros(nV, dtype=torch.bool, device=dev)
    return IceState(
        Hi=Hi, Hb=Hb, SL=SL, Hs=Hs, Hib=Hs - Hi,
        TAF=thickness_above_flotation(Hi, Hb, SL),
        dHb=zeros_v,
        dHi_dt=zeros_v, divQ=zeros_v, dHi_dt_target=zeros_v,
        t_Hi_prev=0.0, t_Hi_next=0.0,
        Hi_prev=Hi, Hi_next=Hi,
        mask_noice=bfalse, mask_icefree_land=bfalse,
        mask_icefree_ocean=bfalse, mask_grounded_ice=bfalse,
        mask_floating_ice=bfalse, mask_margin=bfalse,
        mask_gl_gr=bfalse, mask_gl_fl=bfalse, mask_cf_gr=bfalse,
        mask_cf_fl=bfalse, mask_coastline=bfalse,
        mask=torch.zeros(nV, dtype=torch.int32, device=dev),
        fraction_margin=torch.ones(nV, **kw),
        fraction_gr=torch.ones(nV, **kw),
        fraction_gr_b=torch.ones(nTri, **kw),
        Hi_eff=Hi,
        A_flow=torch.zeros((nV, nz), **kw),
        bed_roughness=torch.zeros(nV, **kw),
        u_vav_b=zeros_t, v_vav_b=zeros_t,
        u_3D_b=torch.zeros((nTri, nz), **kw),
        v_3D_b=torch.zeros((nTri, nz), **kw),
        visc_tau_bx=zeros_t, visc_tau_by=zeros_t,
        visc_eta_3D_b=torch.full((nTri, nz), 1e4, **kw),  # = visc_eff_min
        Ti=torch.full((nV, nz), Ti_init, **kw),
        pc=PCState(dt_n=float(dt_init), dt_np1=float(dt_init),
                   eta_n=1e-8, eta_np1=1e-8,
                   dHi_dt_Hi_nm1_u_nm1=zeros_v, tau_np1=zeros_v),
        dt_ice=float(dt_init),
        n_visc_its=0,
        n_Axb_its=0,
    )
