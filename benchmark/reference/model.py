"""The plain reference of the benchmark's cells: the frozen copy of the
port's plain code (`icemodel`), built from a configuration alone, that
repeats an ice step, or a thermodynamics step, from a state it is given.

It builds its own mesh, operators, bedrock CDFs, present-day geometry and
forcing from the configuration, in its own precision, and imports nothing
of the port or of the JAX package. The states it starts from are the
program's (the segments run the program's own state forward; see
compare.py)."""

import dataclasses

import numpy as np
import torch

from .icemodel.config import Config
from .icemodel.core.ice.bedrock_cdf import build_bedrock_cdfs_from_config
from .icemodel.core.ice.pc import make_pc_step
from .icemodel.core.ice.state import IceState, PCState
from .icemodel.core.ice.thermodynamics import (make_geothermal_flux,
                                               make_heat_solver,
                                               register_thermo_static,
                                               run_thermodynamics)
from .icemodel.core.idealised_geometries import calc_idealised_geometry
from .icemodel.core.mesh_data import build_mesh_data
from .icemodel.mesh import build_mesh_from_config
from .icemodel.mesh.operators import build_all_matrix_operators
from .icemodel.utils.constants import T0

REGION = "ANT"
# None: a state is taken as given; the control of the comparison stores it
# in a lower type (compare.rounded_through)
STATE_ROUND = None


def build_mesh(cfg):
    """The host mesh of a configuration dict, with its operators."""
    mesh = build_mesh_from_config(Config(**cfg), REGION)
    mesh.operators = build_all_matrix_operators(mesh)
    return mesh


class ReferenceModel:
    """The configuration `cfg` (the program's keys) on `mesh` (from
    build_mesh) in `precision` ("f64" for the reference, "f32" for the
    control), on `device`."""

    def __init__(self, cfg, mesh, device, precision="f64"):
        C = self.C = Config(**dict(cfg, tpu_precision=precision))
        self.mesh = mesh
        self.dtype = torch.float32 if precision == "f32" else torch.float64
        md = self.md = build_mesh_data(mesh, dtype=self.dtype, device=device)
        V = mesh.V
        if getattr(C, f"choice_refgeo_PD_{REGION}") != "idealised":
            raise ValueError("the reference holds idealised geometries only")
        Hi_PD, Hb_PD, _, _ = calc_idealised_geometry(
            V[:, 0], V[:, 1], C.choice_refgeo_PD_idealised, C)
        Hi_PD = np.where(Hi_PD < C.refgeo_Hi_min, 0.0, Hi_PD)
        cdfs = None
        if "bedrock_CDF" in C.choice_subgrid_grounded_fraction:
            pair = build_bedrock_cdfs_from_config(C, mesh, REGION)
            if pair is not None:
                kw = dict(dtype=self.dtype, device=md.device)
                cdfs = (torch.as_tensor(pair[0], **kw),
                        torch.as_tensor(pair[1], **kw),
                        torch.as_tensor((mesh.TriC < 0).any(axis=1),
                                        device=md.device))
        self.pc_step = make_pc_step(C, md, refgeo_Hi=Hi_PD, refgeo_Hb=Hb_PD,
                                    bedrock_cdfs=cdfs)
        # the uniform forcing the configurations name (SMB, BMB and LMB
        # constant in time; the LMB's uniform value sits at calving fronts)
        for key, model in (("SMB", "uniform"), ("BMB", "uniform"),
                           ("LMB", "uniform")):
            if getattr(C, f"choice_{key}_model_{REGION}") != model:
                raise ValueError(f"the reference holds a uniform {key} only")
        full = lambda v: torch.full((md.nV,), float(v), dtype=self.dtype,
                                    device=md.device)
        self.SMB, self.BMB = full(C.uniform_SMB), full(C.uniform_BMB)
        if C.uniform_LMB != 0.0:
            raise ValueError("the reference holds LMB 0 only")
        self.LMB = full(0.0)
        self.thermo = None
        if C.choice_thermo_model == "3D_heat_equation":
            if getattr(C, f"choice_climate_model_{REGION}") != "none":
                raise ValueError("the reference holds the climate 'none' only")
            register_thermo_static(md)
            heat = make_heat_solver(C, md)
            make_geothermal_flux(C, md)
            # the climate 'none': T2m at T0 - 20 K every month, the annual
            # mean taken over the twelve months in the run's type
            self.T_surf = torch.full((md.nV, 12), T0 - 20.0, dtype=self.dtype,
                                     device=md.device).mean(dim=1)
            self.thermo = lambda s: run_thermodynamics(
                C, md, s, C.dt_thermodynamics, self.T_surf, self.SMB,
                self.BMB, heat)

    def state_from(self, s):
        """The reference's state with the fields of `s` (a state of the
        program, read by field name) on its device and in its type."""
        def conv(cls, obj):
            kw = {}
            for f in dataclasses.fields(cls):
                v = getattr(obj, f.name)
                if isinstance(v, torch.Tensor):
                    if v.is_floating_point():
                        if STATE_ROUND is not None:
                            v = v.to(STATE_ROUND)
                        v = v.to(device=self.md.device, dtype=self.dtype)
                    else:
                        v = v.to(device=self.md.device)
                elif f.name == "pc":
                    v = conv(PCState, v)
                kw[f.name] = v
            return cls(**kw)
        return conv(IceState, s)

    def step(self, s, dt_max):
        """The new state after the PC step from the program's state `s`,
        with the step's own choice of the time step (its controller, the
        growth cap, the critical time step) and its retries."""
        return self.pc_step(self.md, self.state_from(s), dt_max,
                            SMB=self.SMB, BMB=self.BMB, LMB=self.LMB)

    def thermo_step(self, s):
        """Ti after one thermodynamics step from the program's state `s`
        (the ice at the step's time)."""
        Ti, _ = self.thermo(self.state_from(s))
        return Ti
