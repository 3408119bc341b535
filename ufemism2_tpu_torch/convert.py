"""Carry state, meshes and operators into the port from plain numpy.

The port never sees a foreign array type: whoever holds a mesh, a state
or operators elsewhere (the parity tests hold the reference package's)
turns them into numpy / scipy objects first and hands those over here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.mesh_data import EField, EIndex
from .core.ice.state import IceState, PCState
from .mesh.mesh_types import Mesh
from .ops import resolve_device
from .ops.sparse import EllStack, ell_stack_from_csr

_HOST_SCALARS = {"t_Hi_prev": float, "t_Hi_next": float, "dt_ice": float,
                 "n_visc_its": int, "n_Axb_its": int}
_PC_SCALARS = ("dt_n", "dt_np1", "eta_n", "eta_np1")
# the carried state of the stateful component runners
_CARRIED = {"SMB_IMAU_ITM": ("FirnDepth", "MeltPreviousYear", "Albedo"),
            "climate_matrix": ("_firn", "_melt_yr", "_albedo", "_T2m",
                               "_Precip")}


def _tensor(a, device, dtype):
    # torch.tensor copies: the source may be a read-only view of a buffer
    # that another library owns
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def ice_state_from_numpy(fields: dict, device, dtype) -> IceState:
    """The port's IceState from a dict keyed by IceState field names; the
    controller state sits under 'pc' as a dict keyed by PCState field
    names. Time and counter fields become host floats and ints."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(IceState):
        v = fields[f.name]
        if f.name == "pc":
            kw["pc"] = PCState(**{
                k: (float(np.asarray(v[k])) if k in _PC_SCALARS
                    else _tensor(v[k], device, dtype))
                for k in (g.name for g in dataclasses.fields(PCState))})
        elif f.name in _HOST_SCALARS:
            kw[f.name] = _HOST_SCALARS[f.name](np.asarray(v))
        else:
            kw[f.name] = _tensor(v, device, dtype)
    return IceState(**kw)


def mesh_from_numpy(arrays: dict) -> Mesh:
    """The port's host Mesh from a dict keyed by Mesh field names (numpy
    arrays and plain scalars). Operators are not carried: the port builds
    its own from the mesh."""
    kw = {}
    for f in dataclasses.fields(Mesh):
        if f.name in ("operators", "device") or f.name not in arrays:
            continue
        v = arrays[f.name]
        if v is None or isinstance(v, (int, float, tuple)):
            kw[f.name] = v
        else:
            kw[f.name] = np.array(v)
    return Mesh(**kw)


def ell_from_scipy(mats, device, dtype) -> EllStack:
    """An EllStack over the union pattern of a list of scipy matrices of
    one shape."""
    return ell_stack_from_csr(list(mats), dtype=dtype, device=device)


def extra_tables_from_numpy(md, tables: dict):
    """Register static tables into md.extras from plain numpy: `tables`
    maps a name to (array, row) for a field (an EField: a per-entity
    table, or a 0-d one in row 'scalar' such as the MISMIP+ flow-factor
    scale glen_A_scale) or to (array, row, col) for an index table (an
    EIndex). Floating arrays take md's type, integer arrays become int64
    indices, booleans stay booleans; all go to md's device."""
    for name, spec in tables.items():
        a = np.asarray(spec[0])
        if a.dtype == np.bool_:
            t = torch.tensor(a, device=md.device)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.tensor(a, dtype=torch.int64, device=md.device)
        else:
            t = torch.tensor(a, dtype=md.A.dtype, device=md.device)
        md.extras[name] = (EIndex(t, spec[1], spec[2]) if len(spec) == 3
                           else EField(t, spec[1]))
    return md


def component_state_from_numpy(region, fields: dict, device, dtype):
    """Set a region's host-held component state from plain numpy, so that
    a region built elsewhere and this one start equal. Keys (each
    optional): 'bed_roughness' (the BedRoughnessState's field, also
    written into the ice state), 'BMB_inverted' (the inverted BMB's
    cache), 'ocean_deltaT' and 'ocean_t_prev' (the snapshot+nudge2D
    ocean's offset and the time of its last nudge), 'SMB_IMAU_ITM' (a dict
    of IMAU-ITM's FirnDepth, MeltPreviousYear and Albedo) and
    'climate_matrix' (a dict of the matrix climate's carried _firn,
    _melt_yr, _albedo, _T2m and _Precip)."""
    from .models.bed_roughness import BedRoughnessState
    device = resolve_device(device)
    if "bed_roughness" in fields:
        br = _tensor(fields["bed_roughness"], device, dtype)
        region.bed_roughness_state = BedRoughnessState(generic=br)
        region.state = region.state.replace(bed_roughness=br)
    if "BMB_inverted" in fields:
        region.run_bmb.cache["BMB"] = _tensor(fields["BMB_inverted"],
                                              device, dtype)
    if "ocean_deltaT" in fields:
        region.run_ocean.deltaT = _tensor(fields["ocean_deltaT"], device,
                                          dtype)
    if "ocean_t_prev" in fields:
        t = fields["ocean_t_prev"]
        region.run_ocean._t_prev = None if t is None else float(t)
    for key, runner in (("SMB_IMAU_ITM", getattr(region, "run_smb", None)),
                        ("climate_matrix",
                         getattr(region, "run_climate", None))):
        for name, v in fields.get(key, {}).items():
            if name not in _CARRIED[key] or not hasattr(runner, name):
                raise ValueError(f"{key}: '{name}' is not state of the "
                                 "region's runner")
            setattr(runner, name, _tensor(v, device, dtype))
    return region
