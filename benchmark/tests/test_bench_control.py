"""The comparison separates, for every cell, on the CPU at its small
stand-in: the program's steps pass the cell's limits, the control (the
reference in the program's place one precision lower) fails them, and a
run with the timed path broken underneath comes out not correct: a step
that leaves the state as it was, the stress balance's answer altered, a
time step longer than the controller allows, and a thermodynamics step
that leaves the temperature as it was."""

import pytest

from benchmark import spec
from benchmark.harness import Run
from benchmark.reference import compare
from benchmark.reference.model import build_mesh
from benchmark.tests.conftest import small_cell

SEED = 31337
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_control_fails(workload):
    cell = small_cell(workload, sampled=(0, 0))
    run = Run(cell, SEED, 0.0, 0, device="cpu")
    run.setup()
    run.window()
    assert run.steps
    cfg = cell.program_config()
    ref = compare.reference(cfg, build_mesh(cfg), "cpu")
    limits = compare.load_limits(cell.name)
    th = run.thermo_steps[:2]
    ok, got = compare.judge(compare.step_gaps(ref, run.steps, th), limits)
    assert ok, got
    ok, got = compare.judge(compare.control_gaps(ref, run.steps, th), limits)
    assert not ok, got


def unchanged(region):
    """The PC step returns the state it was given, with only its time
    window moved on: the thickness and the velocities as they were."""
    inner = region.pc_step

    def pc_step(md, s, dt_max, **kw):
        out = inner(md, s, dt_max, **kw)
        return s.replace(t_Hi_prev=out.t_Hi_prev, t_Hi_next=out.t_Hi_next,
                         Hi_prev=out.Hi_prev, Hi_next=out.Hi_prev,
                         pc=out.pc, dt_ice=out.dt_ice)
    region.pc_step = pc_step


def longer_step(region):
    """The time step a fifth longer than the controller allows: the PC step
    takes the previous step, which caps its growth, as 1.2 times what it
    was."""
    inner = region.pc_step

    def pc_step(md, s, dt_max, **kw):
        pc = s.pc.replace(dt_np1=1.2 * s.pc.dt_np1)
        return inner(md, s.replace(pc=pc), dt_max, **kw)
    region.pc_step = pc_step


def thermo_unchanged(region):
    """The thermodynamics step returns the temperature it was given."""
    inner = region._thermo_step

    def thermo_step(md, s, *a):
        _, n_unstable = inner(md, s, *a)
        return s.Ti, n_unstable
    region._thermo_step = thermo_step


def altered(monkeypatch, workload):
    """The stress balance's answer altered where it is produced: every
    GMRES solution of the viscosity loop 50 % larger."""
    from ufemism2_tpu_torch.core.ice import bpa, ssadiva
    module = bpa if "bpa" in workload else ssadiva
    inner = module.gmres

    def gmres(*a, **kw):
        res = inner(*a, **kw)
        return res._replace(x=tuple(1.5 * x for x in res.x))
    monkeypatch.setattr(module, "gmres", gmres)


FAULTS = [(w, f) for w in CELLS
          for f in ("unchanged", "altered", "longer_step")] + [
    (w, "thermo_unchanged") for w in CELLS if "thermo" in w]


def broken_regions(monkeypatch, fault):
    """Every region built from here on has `fault` applied to it, before
    its start-up: the harness itself is left as it is."""
    from ufemism2_tpu_torch.main.region import ModelRegion
    init = ModelRegion.__init__

    def __init__(self, *a, **kw):
        init(self, *a, **kw)
        fault(self)
    monkeypatch.setattr(ModelRegion, "__init__", __init__)


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = small_cell(workload, sampled=(0, 0))
    if fault == "altered":
        altered(monkeypatch, workload)
    else:
        broken_regions(monkeypatch, {"unchanged": unchanged,
                                     "longer_step": longer_step,
                                     "thermo_unchanged": thermo_unchanged}[
                                         fault])
    out = Run(cell, SEED, 0.0, 0, device="cpu").result()
    assert out["correct"] is False, out["compared"]
    assert out["failed"] == 1
