"""The NaN sanitizer (utils/sanitizer.py) against the JAX package's, and the
region's do_check_for_NaN: a poisoned run raises NaNDetected naming the
same state fields in both packages.

Both regions run tests/torch_port_fixture.py's small Halfar stand-in (SIA,
no thermodynamics) on one mesh in f64."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (H_HALFAR, mesh_to_numpy, state_to_numpy)

from ufemism2_tpu.config import Config as CJ
from ufemism2_tpu.main.region import ModelRegion as JaxRegion
from ufemism2_tpu.mesh import build_mesh_from_config
from ufemism2_tpu.utils import sanitizer as jsan

from ufemism2_tpu_torch.config import Config as CT
from ufemism2_tpu_torch.convert import ice_state_from_numpy, mesh_from_numpy
from ufemism2_tpu_torch.main.region import ModelRegion
from ufemism2_tpu_torch.utils import sanitizer as tsan

CFG = dict(H_HALFAR, choice_thermo_model="none",
           choice_initial_ice_temperature_ANT="uniform",
           do_check_for_NaN=True)


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.Cj, e.Ct = CJ(**CFG), CT(**CFG)
    e.mesh_j = build_mesh_from_config(e.Cj, "ANT")
    e.mesh_t = mesh_from_numpy(mesh_to_numpy(e.mesh_j))
    e.rj = JaxRegion(e.Cj, "ANT", mesh=e.mesh_j)
    e.sj = e.rj.state
    e.st = ice_state_from_numpy(state_to_numpy(e.sj), device="cpu",
                                dtype=torch.float64)
    return e


def _message_fields(err):
    """The list of field names in a NaNDetected message."""
    msg = str(err)
    return msg[msg.index("["):msg.index("]") + 1]


def test_clean_state_passes(env):
    assert tsan.nonfinite_fields(env.st) == []
    tsan.check_state_for_nan(env.st)
    jsan.check_state_for_nan(env.sj)


# (field, index, value) poisonings, each applied to both states
POISON = {
    "one_vertex": [("Hi", 3, np.nan)],
    "nested_and_3d": [("u_3D_b", (5, 2), np.inf),
                      ("pc.tau_np1", 0, -np.inf)],
    "host_scalars": [("dt_ice", None, np.nan), ("t_Hi_next", None, np.inf),
                     ("pc.eta_np1", None, np.nan), ("Ti", (0, 0), np.nan)],
}


def _poison(state, edits, to_array, put):
    for name, idx, value in edits:
        holder = state
        *outer, leaf = name.split(".")
        for o in outer:
            holder = getattr(holder, o)
        old = getattr(holder, leaf)
        if idx is None:
            new = to_array(value, old)
        else:
            new = put(old, idx, value)
        holder_new = dataclasses.replace(holder, **{leaf: new})
        state = _set_path(state, outer, holder_new)
    return state


def _set_path(state, outer, holder):
    if not outer:
        return holder
    inner = getattr(state, outer[0])
    return dataclasses.replace(
        state, **{outer[0]: _set_path(inner, outer[1:], holder)})


def _put_torch(a, idx, v):
    a = a.clone()
    a[idx] = v
    return a


@pytest.mark.parametrize("case", sorted(POISON))
def test_same_fields_named(env, case):
    sj = _poison(env.sj, POISON[case],
                 lambda v, old: jnp.asarray(v, jnp.asarray(old).dtype),
                 lambda a, i, v: a.at[i].set(v))
    st = _poison(env.st, POISON[case], lambda v, old: float(v), _put_torch)
    with pytest.raises(jsan.NaNDetected) as ej:
        jsan.check_state_for_nan(sj, where="t=1.000")
    with pytest.raises(tsan.NaNDetected) as et:
        tsan.check_state_for_nan(st, where="t=1.000")
    assert str(et.value) == str(ej.value)
    named = {n for n, _, _ in POISON[case]}
    assert set(tsan.nonfinite_fields(st)) == named


def test_region_raises_naming_the_fields(env):
    """A NaN put into the ice thickness at the summit before a run_to: both
    regions raise after the first dispatch, naming the same fields at the
    same time."""
    rj = JaxRegion(env.Cj, "ANT", mesh=env.mesh_j)
    rt = ModelRegion(env.Ct, "ANT", mesh=env.mesh_t, device="cpu")
    top = int(np.argmax(np.asarray(rj.state.Hi)))     # the dome's summit
    rj.state = rj.state.replace(Hi=rj.state.Hi.at[top].set(jnp.nan))
    rt.state = rt.state.replace(Hi=_put_torch(rt.state.Hi, top, math.nan))
    with pytest.raises(jsan.NaNDetected) as ej:
        rj.run_to(1.0)
    with pytest.raises(tsan.NaNDetected) as et:
        rt.run_to(1.0)
    assert str(et.value) == str(ej.value)
    fields = _message_fields(et.value)
    assert "'Hi'" in fields


def test_region_without_the_check_does_not_scan(env, monkeypatch):
    """do_check_for_NaN off: run_to never calls the scan."""
    from ufemism2_tpu_torch.main import region as tregion
    calls = []
    monkeypatch.setattr(tregion, "check_state_for_nan",
                        lambda *a, **k: calls.append(a))
    rt = ModelRegion(CT(**dict(CFG, do_check_for_NaN=False)), "ANT",
                     mesh=env.mesh_t, device="cpu")
    rt.run_to(0.5)
    assert calls == []
    rt2 = ModelRegion(env.Ct, "ANT", mesh=env.mesh_t, device="cpu")
    rt2.run_to(0.5)
    assert len(calls) >= 1


def test_enable_debug_nans_refuses():
    with pytest.raises(NotImplementedError, match="jax_debug_nans"):
        tsan.enable_debug_nans()
