"""Fields framework: per-field metadata driving generic remap, restart
and output.

Re-design of src/UPSY/fields/ (fields_basic*.f90 type_field with grid
tag + third dimension, fields_registry.f90:98-158 create_field) and
src/UPSY/models/models_basic.f90 (atype_model with auto
allocate/remap/restart): here the model state is a dataclass of tensors,
so the framework is a METADATA TABLE over those fields plus generic walks
that consult it - what makes remap-everything-on-mesh-update
and restart breadth tractable as the model grows (the same reason the
reference built it).

Each entry says where a field lives (entity grid + third dimension),
its units/long_name (for NetCDF output), and how it transfers to a new
mesh: 'conservative' (2nd-order conservative remap), 'trilin' (linear
interpolation), 'reinit' (recomputed from other fields - masks,
effective quantities, velocities that the next solve regenerates),
'copy' (mesh-independent scalars).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FieldMeta:
    grid: str            # 'a' (vertices) | 'b' (triangles) | '0' (scalar)
    third: str = ""      # '' | 'zeta' | 'month'
    units: str = "-"
    long_name: str = ""
    remap: str = "reinit"


F = FieldMeta

# IceState (core/ice/state.py) field metadata; reference equivalents:
# ice_model_types.f90:297-533 + the per-component remap_* routines.
ICE_FIELD_META = {
    # geometry
    "Hi": F("a", "", "m", "ice thickness", "conservative"),
    "Hb": F("a", "", "m", "bedrock elevation", "conservative"),
    "SL": F("a", "", "m", "sea level", "trilin"),
    "Hs": F("a", "", "m", "surface elevation", "reinit"),
    "Hib": F("a", "", "m", "ice base elevation", "reinit"),
    "TAF": F("a", "", "m", "thickness above flotation", "reinit"),
    "dHb": F("a", "", "m", "bedrock deformation", "trilin"),
    # rates
    "dHi_dt": F("a", "", "m yr^-1", "thickness rate of change", "trilin"),
    "divQ": F("a", "", "m yr^-1", "ice flux divergence", "reinit"),
    "dHi_dt_target": F("a", "", "m yr^-1", "inversion target thinning "
                       "rate", "trilin"),
    # prediction window
    "t_Hi_prev": F("0", "", "yr", "window start", "copy"),
    "t_Hi_next": F("0", "", "yr", "window end", "copy"),
    "Hi_prev": F("a", "", "m", "Hi at window start", "conservative"),
    "Hi_next": F("a", "", "m", "Hi at window end", "conservative"),
    # masks (recomputed from geometry)
    **{m: F("a", "", "-", m.replace("_", " "), "reinit")
       for m in ("mask_noice", "mask_icefree_land", "mask_icefree_ocean",
                 "mask_grounded_ice", "mask_floating_ice", "mask_margin",
                 "mask_gl_gr", "mask_gl_fl", "mask_cf_gr", "mask_cf_fl",
                 "mask_coastline", "mask")},
    "fraction_margin": F("a", "", "-", "margin ice fraction", "reinit"),
    "fraction_gr": F("a", "", "-", "grounded fraction", "reinit"),
    "fraction_gr_b": F("b", "", "-", "grounded fraction (b)", "reinit"),
    "Hi_eff": F("a", "", "m", "effective thickness", "reinit"),
    "A_flow": F("a", "zeta", "Pa^-3 yr^-1", "Glen flow factor", "reinit"),
    "bed_roughness": F("a", "", "-", "bed roughness (nudgable)", "trilin"),
    # velocities (re-solved on the new mesh; carried as warm start)
    "u_vav_b": F("b", "", "m yr^-1", "vertically averaged x-velocity",
                 "trilin"),
    "v_vav_b": F("b", "", "m yr^-1", "vertically averaged y-velocity",
                 "trilin"),
    "u_3D_b": F("b", "zeta", "m yr^-1", "3-D x-velocity", "trilin"),
    "v_3D_b": F("b", "zeta", "m yr^-1", "3-D y-velocity", "trilin"),
    # stress-balance warm-start state (reference: persistent DIVA solver
    # fields, written to its restart files by create_restart_file_DIVA)
    "visc_tau_bx": F("b", "", "Pa", "basal shear stress x (warm start)",
                     "trilin"),
    "visc_tau_by": F("b", "", "Pa", "basal shear stress y (warm start)",
                     "trilin"),
    "visc_eta_3D_b": F("b", "zeta", "Pa yr", "effective viscosity "
                       "(warm start)", "trilin"),
    # thermodynamics
    "Ti": F("a", "zeta", "K", "englacial temperature", "conservative"),
    # counters / controller scalars
    "dt_ice": F("0", "", "yr", "last ice time step", "copy"),
    "n_visc_its": F("0", "", "-", "viscosity iterations", "copy"),
    "n_Axb_its": F("0", "", "-", "linear-solver iterations", "copy"),
    # pc controller (predictor_corrector_scheme.f90:417-444)
    "pc.dt_n": F("0", "", "yr", "pc previous dt", "copy"),
    "pc.dt_np1": F("0", "", "yr", "pc current dt", "copy"),
    "pc.eta_n": F("0", "", "-", "pc previous truncation error", "copy"),
    "pc.eta_np1": F("0", "", "-", "pc current truncation error", "copy"),
    "pc.dHi_dt_Hi_nm1_u_nm1": F("a", "", "m yr^-1",
                                "pc previous thinning rate",
                                "conservative"),
    "pc.tau_np1": F("a", "", "m yr^-1", "pc truncation error field",
                    "trilin"),
}


def field_meta(name: str) -> FieldMeta:
    return ICE_FIELD_META.get(name, FieldMeta("a"))


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_arrays(named: dict) -> dict:
    """{name: numpy array} of a dict of tensors and host scalars, with the
    tensors read from their device in one transfer (each widened to
    float64 on the device, which is exact for the float32, int32 and
    bool fields of a state, and narrowed back on the host)."""
    tensors = {k: v for k, v in named.items() if isinstance(v, torch.Tensor)}
    host = {}
    if tensors:
        flat = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in tensors.values()]).cpu().numpy()
        at = 0
        for k, t in tensors.items():
            n = t.numel()
            host[k] = flat[at:at + n].reshape(tuple(t.shape)).astype(
                _numpy_dtype(t.dtype))
            at += n
    return {k: host[k] if k in host else np.asarray(v)
            for k, v in named.items()}


def device_arrays(named: dict, dtypes: dict, device) -> dict:
    """{name: tensor} of a dict of numpy arrays, moved to `device` in one
    transfer (as float64) and cast there to dtypes[name]; bool tensors
    are the nonzero entries."""
    if not named:
        return {}
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float64).ravel() for a in named.values()])
    ).to(device)
    out, at = {}, 0
    for k, a in named.items():
        n = int(np.asarray(a).size)
        piece = flat[at:at + n].reshape(np.asarray(a).shape)
        out[k] = piece != 0 if dtypes[k] == torch.bool \
            else piece.to(dtypes[k])
        at += n
    return out


def remap_leaves(old_host, M_cons, M_trilin) -> dict:
    """{name: numpy array} of the state leaves that move by a map
    ('conservative' or 'trilin'), remapped on the host with scipy from
    `old_host` (the `host_arrays` of the old state's leaves).

    M_cons / M_trilin: scipy operators [nV_new, nV_old] (a-grid) and the
    b-grid variants as a (M_a, M_b) tuple each."""
    M_cons_a, M_cons_b = M_cons
    M_tri_a, M_tri_b = M_trilin
    moved = {}
    for name, arr in old_host.items():
        meta = field_meta(name)
        if meta.remap not in ("conservative", "trilin"):
            continue
        M = {("conservative", "a"): M_cons_a,
             ("conservative", "b"): M_cons_b,
             ("trilin", "a"): M_tri_a,
             ("trilin", "b"): M_tri_b}[(meta.remap, meta.grid)]
        was_bool = arr.dtype == bool
        if was_bool:
            arr = arr.astype(np.float64)
        out = M @ arr
        moved[name] = out > 0.5 if was_bool else out
    return moved


def assemble_remapped_state(old_state, new_state, moved):
    """`new_state` (freshly initialised on the new mesh: its 'reinit'
    fields are kept) with the 'copy' fields of `old_state` and the
    remapped tensors `moved` ({leaf name: tensor on the new state's
    device, in its dtype})."""
    from ..io.output_files import _state_leaves
    old = _state_leaves(old_state)
    out = {}
    for name in _state_leaves(new_state):
        if name in moved:
            out[name] = moved[name]
        elif field_meta(name).remap == "copy":
            out[name] = old[name]
    pc = {k[3:]: v for k, v in out.items() if k.startswith("pc.")}
    return new_state.replace(
        pc=new_state.pc.replace(**pc),
        **{k: v for k, v in out.items() if not k.startswith("pc.")})


def remap_ice_state(old_state, new_state, M_cons, M_trilin):
    """Transfer every IceState field onto a new mesh according to its
    metadata (the reference's remap-everything walk,
    UFEMISM_main_model.f90:1311-1323). `new_state` must be a freshly
    initialised state on the new mesh (its 'reinit' fields are kept).
    The old state is read to the host once, remapped there with scipy
    (`remap_leaves`), and the remapped fields go to the new state's
    device in one transfer, each in the new field's dtype."""
    from ..io.output_files import _state_leaves
    new = _state_leaves(new_state)
    moved = remap_leaves(host_arrays(_state_leaves(old_state)), M_cons,
                         M_trilin)
    moved = device_arrays(moved, {k: new[k].dtype for k in moved},
                          new_state.Hi.device)
    return assemble_remapped_state(old_state, new_state, moved)
