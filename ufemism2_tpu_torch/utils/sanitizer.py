"""NaN sanitizer: the reference's do_check_for_NaN mode
(src/UPSY/basic/checks .f90-style field scans, enabled in dev builds via
`-fcheck=all -finit-real=nan`, compile_UFEMISM.csh:55).

The region scans every IceState field after each dispatch of ice steps
(main/region.py run_to) when the config asks for it: the non-finite flags
of all floating tensor fields are stacked on the device and read to the
host once; the state's host scalars (model times, time steps, truncation
errors) are tested on the host. The message names the fields by their
dotted names (`pc.tau_np1`), in the dataclass order.

The reference's eager fault isolation (`jax_debug_nans`, which re-runs
every primitive un-jitted at the first NaN) has no counterpart in torch:
`torch.autograd.set_detect_anomaly` checks only the backward pass, and the
port runs no backward pass. `enable_debug_nans` therefore raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch


class NaNDetected(RuntimeError):
    pass


def _leaf_items(state, prefix=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            yield from _leaf_items(v, name + ".")
        else:
            yield name, v


def nonfinite_fields(state) -> list:
    """The dotted names of the state's fields that hold a NaN or an inf:
    one host read for all tensor fields."""
    names, flags, host = [], [], {}
    for name, v in _leaf_items(state):
        names.append(name)
        if isinstance(v, torch.Tensor):
            if v.is_floating_point():
                flags.append((name, ~torch.isfinite(v).all()))
        elif isinstance(v, float):
            host[name] = not math.isfinite(v)
    if flags:
        read = torch.stack([f for _, f in flags]).cpu().tolist()
        host.update(zip((n for n, _ in flags), read))
    return [n for n in names if host.get(n, False)]


def check_state_for_nan(state, where: str = ""):
    """Raise NaNDetected naming every non-finite IceState field (the
    reference's do_check_for_NaN crash('NaN in ...') behaviour)."""
    bad = nonfinite_fields(state)
    if bad:
        raise NaNDetected(
            f"non-finite values in state fields {bad}"
            + (f" at {where}" if where else ""))


def enable_debug_nans():
    """The reference's eager NaN fault isolation (jax_debug_nans) has no
    torch counterpart: anomaly detection covers only the backward pass,
    which the port never runs. Use do_check_for_NaN, which names the
    fields after each dispatch."""
    raise NotImplementedError(
        "enable_debug_nans: torch has no counterpart of jax_debug_nans "
        "(torch.autograd.set_detect_anomaly checks only the backward pass, "
        "and the model runs none); set do_check_for_NaN instead")
