"""The comparison that decides `correct`.

The benchmark records the ice steps (and thermodynamics steps) of one
segment of the window, drawn from the seed, as the program took them: the
state each started from and the state it produced. The reference, in the precision the
configuration states, repeats a few consecutive steps of them, drawn from
the seed, each from the program's own starting state, with the reference's
own choice of the time step (its controller, the critical time step and
its retries), and the comparison reads, over those steps, the largest of:

- `u_gap`: the relative L2 gap of the 3-D velocities (u, v) on the
  triangles, against the reference's;
- `H_gap`: the gap of the thickness at the end of the step, relative to
  the change the reference makes in that step (a step that leaves the
  thickness as it was reads 1, and one taken at a time step a share off
  the reference's reads about that share), off the ice margin and the
  calving front
  (the reference's masks): there the spill-over of a full margin cell
  switches on the last bit of a fraction, and one vertex's switch would
  move the whole number;
- `V_gap`: the gap of the ice volume's change in the step, over the whole
  domain, margins included, relative to the reference's (the spill-over
  moves ice between vertices and keeps the volume);
- `T_gap` (cells with thermodynamics): the gap of the temperature after a
  thermodynamics step, relative to the change the reference makes in it.

The control is the reference itself put in the program's place, one
precision below what the configuration states: the fields of the state it
starts from stored in bfloat16 (float32 in the configuration), x rounded
through float8 (e4m3, scaled per apply to its range) in every
stress-balance operator apply (bfloat16 in the configuration), and the heat
solve's operands rounded through bfloat16 (float32 in the configuration).
"""

import contextlib
import json
import math
from pathlib import Path

import torch

from . import model
from .icemodel.ops import cuda_heat, cuda_spmv
from .model import ReferenceModel

LIMITS_DIR = Path(__file__).resolve().parent.parent / "limits"
CONTROL_ROUND = torch.float8_e4m3fn
CONTROL_HEAT_ROUND = torch.bfloat16
CONTROL_STATE_ROUND = torch.bfloat16


def load_limits(workload):
    """The limits of a cell: limits/<workload>.json, {name: limit}."""
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())["limits"]


@contextlib.contextmanager
def rounded_through(x_dtype, heat_dtype, state_dtype):
    """Within the block the reference's operators round x through
    `x_dtype`, its heat solve its operands through `heat_dtype`, and the
    states it starts from are stored in `state_dtype`."""
    old = cuda_spmv.ROUND_DTYPE, cuda_heat.HEAT_ROUND, model.STATE_ROUND
    cuda_spmv.ROUND_DTYPE, cuda_heat.HEAT_ROUND, model.STATE_ROUND = (
        x_dtype, heat_dtype, state_dtype)
    try:
        yield
    finally:
        cuda_spmv.ROUND_DTYPE, cuda_heat.HEAT_ROUND, model.STATE_ROUND = old


def _norm(x):
    return float(torch.linalg.vector_norm(x.double()))


def rel_gap(a, ref, base=None):
    """||a - ref|| / ||ref - base|| (base 0 when None), every tensor
    cast to float64 on ref's device; infinite where a is not finite."""
    a = a.to(device=ref.device, dtype=torch.float64)
    ref = ref.double()
    if not bool(torch.isfinite(a).all()):
        return math.inf
    den = _norm(ref if base is None else ref - base.to(ref.device).double())
    return _norm(a - ref) / max(den, 1e-300)


def checked_steps(steps, thermo_steps, n, n_thermo, rng):
    """`n` consecutive ice steps and `n_thermo` consecutive thermodynamics
    steps of a recorded segment, each from a start drawn by `rng`."""
    def pick(seq, m):
        j = int(rng.integers(0, max(len(seq) - m, 0) + 1))
        return seq[j:j + m]
    return pick(steps, n), pick(thermo_steps, n_thermo)


def step_gaps(ref, steps, thermo_steps, against=None,
              lowered=contextlib.nullcontext, detail=None):
    """The numbers of the comparison over recorded steps: `steps` is a
    list of (state before, state after, dt_max) and `thermo_steps` of
    (ice state at the step's time, Ti after) as the judged side produced
    them. With `against` (a ReferenceModel), the judged side is that
    model run from the same starting states, inside `lowered()` (the
    control). Besides the numbers compared, `dt_gap` reads the largest
    relative gap of the judged side's time step from the reference's;
    `detail`, a list, gets each step's time steps and truncation errors."""
    gaps = {"u_gap": 0.0, "H_gap": 0.0, "V_gap": 0.0, "dt_gap": 0.0}
    area = ref.md.A.double()
    for pre, post, dt_max in steps:
        r = ref.step(pre, dt_max)
        if against is not None:
            with lowered():
                post = against.step(pre, dt_max)
        gaps["dt_gap"] = max(gaps["dt_gap"],
                             abs(post.dt_ice / r.dt_ice - 1.0))
        if detail is not None:
            detail.append({"dt": post.dt_ice, "dt_ref": r.dt_ice,
                           "eta": post.pc.eta_np1, "eta_ref": r.pc.eta_np1})
        u = torch.cat([post.u_3D_b.reshape(-1), post.v_3D_b.reshape(-1)])
        u_r = torch.cat([r.u_3D_b.reshape(-1), r.v_3D_b.reshape(-1)])
        gaps["u_gap"] = max(gaps["u_gap"], rel_gap(u, u_r))
        inner = ~(r.mask_margin | r.mask_cf_fl | r.mask_cf_gr)
        H = post.Hi_next.to(r.Hi_next.device).double()
        gaps["H_gap"] = max(gaps["H_gap"], rel_gap(
            H[inner], r.Hi_next[inner], r.Hi_prev[inner]))
        dV = float((area * (H - r.Hi_next)).sum())
        dV_r = float((area * (r.Hi_next - r.Hi_prev)).sum())
        gaps["V_gap"] = max(gaps["V_gap"], abs(dV) / max(abs(dV_r), 1e-300)
                            if math.isfinite(dV) else math.inf)
    if ref.thermo is not None and thermo_steps:
        gaps["T_gap"] = 0.0
        for si, Ti in thermo_steps:
            Ti_r = ref.thermo_step(si)
            if against is not None:
                with lowered():
                    Ti = against.thermo_step(si)
            gaps["T_gap"] = max(gaps["T_gap"], rel_gap(Ti, Ti_r, si.Ti))
    return gaps


def judge(gaps, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and a number for every limit."""
    compared = {k: {"value": gaps.get(k, math.inf), "limit": v}
                for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared


def reference(cfg, mesh, device):
    """The reference: the frozen plain model in the precision the
    configuration states (float32 fields, x rounded through bfloat16 in
    the operators)."""
    if cfg["tpu_precision"] != "f32":
        raise ValueError("the comparison holds configurations in f32 only")
    return ReferenceModel(cfg, mesh, device, "f32")


def control_gaps(ref, steps, thermo_steps):
    """The control's numbers: the reference one precision lower in the
    program's place, from the program's starting states."""
    return step_gaps(ref, steps, thermo_steps, against=ref,
                     lowered=lowered)


def lowered():
    """The control's precision (see the module's docstring)."""
    return rounded_through(CONTROL_ROUND, CONTROL_HEAT_ROUND,
                           CONTROL_STATE_ROUND)
