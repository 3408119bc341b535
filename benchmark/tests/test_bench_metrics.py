"""The metric arithmetic: a rate over the whole window, a percentile over
every step of it, the union of device intervals."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spec
from benchmark.trace import _union


def test_rate_is_over_the_whole_window():
    run = SimpleNamespace(years=7 * 40.0, window_s=21.0)
    assert spec.reader("sim_yr_per_hr")(run) == pytest.approx(
        280.0 / 21.0 * 3600.0)


def test_p95_is_over_every_step_not_over_segments():
    rng = np.random.default_rng(3)
    # ten segments of 13 steps; one segment has all the slow steps
    segs = [list(0.06 + 0.01 * rng.random(13)) for _ in range(10)]
    segs[4] = [0.5] * 13
    steps = [s for seg in segs for s in seg]
    got = spec.reader("step_ms_p95")(SimpleNamespace(step_s=steps))
    assert got == pytest.approx(np.percentile(steps, 95) * 1e3)
    per_segment = np.mean([np.percentile(seg, 95) for seg in segs]) * 1e3
    assert abs(got - per_segment) > 1.0


def test_p95_needs_some_steps():
    assert spec.reader("step_ms_p95")(SimpleNamespace(step_s=[0.1] * 5)) \
        is None


def test_union_of_device_intervals():
    busy, gaps = _union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)])
    assert busy == pytest.approx(3 + 1 + 1)
    assert gaps == [(3, 5), (6, 10)]


def test_counts_and_shares():
    run = SimpleNamespace(
        counts=[(13, 40, 1568)] * 3, years=120.0, window_s=10.0, pc_s=8.0,
        thermo_s=1.0, gmres_s=6.0, gmres_its=4000, thermo_n=0,
        profile={"counts": [(13, 40, 1568)], "kernel_launches": 61152,
                 "busy_s": 0.25, "window_s": 1.0, "ranges": {}},
        samples={}, traced_untraced_s=10.0 / 3)
    assert spec.reader("visc_its_per_sim_yr")(run) == pytest.approx(1.0)
    assert spec.reader("driver_self_pct")(run) == pytest.approx(10.0)
    assert spec.reader("krylov_ms_per_it")(run) == pytest.approx(1.5)
    assert spec.reader("launches_per_krylov_it")(run) == pytest.approx(39.0)
    # 0.25 s of device time in one traced segment, which took 10/3 s in
    # the window
    assert spec.reader("device_idle_pct")(run) == pytest.approx(92.5)
    # nothing to read: no thermodynamics step, no traced range
    assert spec.reader("thermo_ms_per_step")(run) is None
    assert spec.reader("diva_operator_roofline")(run) is None
    assert spec.reader("heat_columns_roofline")(run) is None


def test_idle_reads_the_untraced_wall_of_the_traced_starting_states():
    from benchmark.harness import Run
    run = Run.__new__(Run)
    run.trace, run.tr, run.order = True, {"traced_segments": 2}, [2, 0, 1]
    # two cycles through three starting states; the traced block runs the
    # first two of the seed's order again
    run.segment_s = [1.0, 4.0, 9.0, 3.0, 6.0, 9.0]
    assert run.untraced_wall() == pytest.approx(2.0 + 5.0)
    run.trace = False
    assert run.untraced_wall() is None


def test_window_runs_whole_cycles_of_starting_states():
    from types import SimpleNamespace as N

    from benchmark.harness import Run
    run = Run.__new__(Run)
    run.seconds, run.sampled, run.order = 0.05, 1, [2, 0, 1]
    run.tr = {"segment_years": 40.0}
    run.probe = N(on=False, entries=[], record=None, record_thermo=None)
    run._sync = lambda: None
    started = []

    def segment(snap):
        started.append(snap)
        run.probe.entries.append(__import__("time").perf_counter())
        __import__("time").sleep(0.004)
        return (1, 1, 100)
    run.segment, run.pool = segment, ["a", "b", "c"]
    run.window()
    cycles = len(run.counts) / 3
    assert cycles == int(cycles) and run.window_s * (1 + 0.5 / cycles) >= 0.05
    assert started[:3] == ["c", "a", "b"]
    assert run.years == 40.0 * len(run.counts)
    assert len(run.step_s) == len(run.counts)
    assert sum(run.step_s) <= run.window_s
