"""A replayed segment repeats its work and its answer exactly: on the CPU
at the 64 km stand-in in float64, two segments from one snapshot give the
same counts and every field of the state bit for bit."""

import dataclasses

import torch

from benchmark.harness import Run
from benchmark.tests.conftest import small_cell


def fields(s):
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        out[f.name] = fields(v) if dataclasses.is_dataclass(v) else v
    return out


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_two_segments_are_equal():
    run = Run(small_cell(precision="f64"), 2 ** 33 + 5, 0.0, 0, device="cpu")
    run.setup()                       # ends with a segment from the last
    start = run.pool[run.order[-1]]
    first = fields(run.region.state), run.region.time, run.region.n_dt_ice
    counts = run.segment(start)
    again = fields(run.region.state), run.region.time, run.region.n_dt_ice
    assert counts[0] > 0 and counts[2] > 0
    assert counts == run.segment(start)
    assert same(first[0], again[0]) and first[1:] == again[1:]
    # the snapshot itself is what the segments start from, untouched
    assert start["time"] < run.region.time


def test_seeds_perturb_the_start():
    a = Run(small_cell(precision="f64"), 1, 0.0, 0, device="cpu")
    a.setup()
    from benchmark.harness import perturbed
    s = a.pool[0]["state"]
    b = perturbed(s, 2, 1e-4, 3.0, a.pool[0]["time"])
    c = perturbed(s, 2, 1e-4, 3.0, a.pool[0]["time"])
    assert torch.equal(b.Hi_next, c.Hi_next)
    assert not torch.equal(b.Hi_next, s.Hi_next)
    rel = ((b.Hi_next - s.Hi_next).abs() / s.Hi_next.clamp_min(1e-9)).max()
    assert float(rel) <= 3.1e-4
    assert torch.equal(b.Hi_next == 0, s.Hi_next == 0)
