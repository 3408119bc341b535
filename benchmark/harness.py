"""One run of one cell: set-up, the measured window of segments, the
traced block (with --trace 1), the comparison with the plain reference,
and the result line.

A cell's requests are segments: each starts from one of a pool of
snapshots of the region, taken after the cell's start-up, each with a
fixed perturbation of the thickness, and runs `ModelRegion.run_to` over a
fixed span of model time. Before a segment its snapshot is put back by
reference (no tensor is copied), with the host clocks. The window runs
whole cycles through the pool, in an order drawn from the seed, so every
seed does the same work whatever the speed of the code, and a faster
program runs more cycles of it."""

import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import spec
from .probe import Probe, restore, snapshot
from .trace import read_profile

FORBIDDEN = ("jax", "jaxlib", "flax", "ufemism2_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """The modules among `names` (default: those loaded) whose top-level
    name, compared whole, is JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def perturbed(state, seed, rel, clip, time_now):
    """The snapshot's state with the seed's perturbation: the thickness of
    the prediction window (Hi_prev and Hi_next) scaled by 1 + rel * xi,
    xi a standard normal per vertex clipped to +-clip, drawn on the device
    from the seed; Hi and the geometry that follows from it interpolated
    to the region's time again."""
    from ufemism2_tpu_torch.core.ice.pc import interpolate_ice_to_time
    gen = torch.Generator(device=state.Hi.device).manual_seed(
        int(seed) % 2 ** 63)
    xi = torch.randn(state.Hi.shape, generator=gen, device=state.Hi.device,
                     dtype=torch.float64).clamp_(-clip, clip)
    f = (1.0 + rel * xi).to(state.Hi.dtype)
    s = state.replace(Hi_prev=state.Hi_prev * f, Hi_next=state.Hi_next * f)
    return interpolate_ice_to_time(s, time_now)


class Run:
    """One run of a cell on `device` (the card; a test passes "cpu")."""

    def __init__(self, cell, seed, seconds, trace, device="cuda", t_start=None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.tr = cell.traffic
        self.parts = {}

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        """Mesh, region (with its cold initial solve), start-up, the pool of
        starting states and one warm segment."""
        from ufemism2_tpu_torch.config import Config
        from ufemism2_tpu_torch.main.region import ModelRegion
        from ufemism2_tpu_torch.mesh import build_mesh_from_config
        from ufemism2_tpu_torch.mesh.operators import \
            build_all_matrix_operators
        self.parts["import_s"] = time.perf_counter() - self.t_start
        cfg = self.cell.program_config()
        t = time.perf_counter()
        C = Config(**cfg)
        mesh = build_mesh_from_config(C, "ANT")
        mesh.operators = build_all_matrix_operators(mesh)
        self.parts["mesh_s"] = time.perf_counter() - t
        t = time.perf_counter()
        region = ModelRegion(C, "ANT", mesh=mesh, device=self.device)
        self._sync()
        self.parts["construct_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.t0 = region.time + float(self.tr["startup_years"])
        if self.tr["startup_years"] > 0:
            region.run_to(self.t0)
        self.parts["startup_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.probe = Probe(region, sync=self._sync if self.trace else None)
        base = snapshot(region)
        pert = self.tr["perturbation"]
        # the pool of starting states, the same for every seed; the seed
        # draws their order and the segment that is compared
        self.pool = [dict(base, state=perturbed(
            region.state, j, pert["relative_amplitude"], pert["clip_sigma"],
            region.time)) for j in range(int(pert["pool"]))]
        rng = np.random.default_rng(self.seed)
        self.order = [int(j) for j in rng.permutation(len(self.pool))]
        lo, hi = self.tr["sampled_segment"]
        self.sampled = int(rng.integers(lo, hi + 1))
        self.region, self.mesh = region, mesh
        self.t_end = self.t0 + float(self.tr["segment_years"])
        self.segment(self.pool[self.order[-1]])   # warm: every shape used
        self.parts["warm_segment_s"] = time.perf_counter() - t
        self.setup_s = time.perf_counter() - self.t_start

    def segment(self, snap):
        """One segment from the snapshot `snap`: the snapshot back in
        place, then run_to (which ends in a synchronisation). Returns its
        (steps, viscosity iterations, Krylov iterations)."""
        r = self.region
        restore(r, snap)
        r.run_to(self.t_end)
        s0 = snap["state"]
        return (r.n_dt_ice - snap["n_dt_ice"], r.state.n_visc_its
                - s0.n_visc_its, r.state.n_Axb_its - s0.n_Axb_its)

    def start(self, i):
        """The starting state of the window's segment i."""
        return self.pool[self.order[i % len(self.order)]]

    def window(self):
        """Whole cycles through the pool of starting states, in the seed's
        order, as many as come nearest to `seconds`: every seed does the
        same work.
        The segment drawn from the seed (`sampled`) has its steps recorded
        for the comparison."""
        p = self.probe
        self.steps, self.thermo_steps = [], []
        self.counts, self.segment_s, self.segment_cpu_s = [], [], []
        self._sync()
        p.on = True
        t0 = t = time.perf_counter()
        c = time.thread_time()
        while True:
            k = len(self.counts)
            if k == self.sampled:
                p.record, p.record_thermo = self.steps, self.thermo_steps
            self.counts.append(self.segment(self.start(k)))
            p.record = p.record_thermo = None
            t, t_prev = time.perf_counter(), t
            c, c_prev = time.thread_time(), c
            self.segment_s.append(t - t_prev)
            self.segment_cpu_s.append(c - c_prev)
            cycles = (k + 1) / len(self.order)
            if cycles == int(cycles):
                # stop at the cycle's end nearest to the window's length
                elapsed = t - t0
                if elapsed + 0.5 * elapsed / cycles >= self.seconds:
                    break
        self._sync()
        self.window_s = time.perf_counter() - t0
        p.on = False
        # the window's last step ends at the window's synchronisation
        self.step_s = list(np.diff(p.entries + [t0 + self.window_s]))
        self.years = len(self.counts) * float(self.tr["segment_years"])

    def traced(self):
        """`traced_segments` more segments under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        n = int(self.tr["traced_segments"])
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device == "cuda" else [])
        counts = []
        with self.probe.profiled(), profile(activities=acts) as prof:
            self._sync()
            t0 = time.perf_counter()
            for i in range(n):
                counts.append(self.segment(self.start(i)))
            self._sync()
            wall = time.perf_counter() - t0
        self.profile = read_profile(prof, set(Probe.RANGES.values()), wall)
        self.profile["counts"] = counts
        self.profile["years"] = n * float(self.tr["segment_years"])

    def untraced_wall(self):
        """The wall that the traced block's segments took in the window:
        for each, the mean over the window's segments from the same
        starting state; None without a traced block."""
        if not self.trace:
            return None
        n, m = int(self.tr["traced_segments"]), len(self.order)
        return sum(float(np.mean(self.segment_s[i::m])) for i in range(n))

    def check(self):
        """The comparison with the plain reference on the sampled
        segment's steps: (correct, compared, reason)."""
        from .reference import compare
        from .reference.model import build_mesh
        limits = compare.load_limits(self.cell.name)
        if not self.steps:
            return False, {}, "the sampled segment was not reached"
        cfg = self.cell.program_config()
        mesh = build_mesh(cfg)
        if not (np.array_equal(mesh.V, self.mesh.V)
                and np.array_equal(mesh.Tri, self.mesh.Tri)):
            return False, {}, "the program's mesh is not the configuration's"
        ref = compare.reference(cfg, mesh, self.device)
        steps, thermo = compare.checked_steps(
            self.steps, self.thermo_steps, int(self.tr["check_steps"]),
            int(self.tr.get("check_thermo_steps", 0)),
            np.random.default_rng([self.seed, 1]))
        gaps = compare.step_gaps(ref, steps, thermo)
        ok, compared = compare.judge(gaps, limits)
        return ok, compared, None

    def result(self):
        """The whole run: set-up, window, traced block, the check; the
        result line as a dict."""
        self.setup()
        self.window()
        if self.trace:
            self.traced()
        peak = (torch.cuda.max_memory_allocated() if self.device == "cuda"
                else 0)
        ctx = self.context()
        want = self.cell.per_layer if self.trace else self.cell.end_to_end
        metrics = {}
        for m in want:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        # the program's state is freed before the reference runs
        del ctx
        self.probe.close()
        self.region = self.pool = self.probe = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ok, compared, reason = self.check()
        check_s = time.perf_counter() - t
        device = {"platform": "gpu" if self.device == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(0)
                           if self.device == "cuda" else "cpu"),
                  "count": self.cell.chips, "memory_peak_bytes": int(peak)}
        out = {"correct": bool(ok), "attempted": len(self.counts),
               "failed": 0 if ok else 1, "metrics": metrics,
               "device": device}
        if self.trace:
            device["busy_s"] = self.profile["busy_s"]
            device["window_s"] = self.profile["window_s"]
            out["breakdown"] = self.profile["breakdown"]
            out["run_profile"] = {k: self.profile[k] for k in (
                "ranges", "kernel_launches", "device_ops", "unlinked_ops",
                "counts")}
        out["run"] = {"setup_parts_s": self.parts, "segments":
                      len(self.counts), "sampled_segment": self.sampled,
                      "segment_counts": self.counts[:3],
                      "start_order": self.order,
                      "window_s": self.window_s, "check_s": check_s,
                      "segment_s": self.segment_s,
                      "segment_cpu_s": self.segment_cpu_s,
                      "card": card_line() if self.device == "cuda" else None}
        if reason:
            out["run"]["check_failed"] = reason
        out["compared"] = compared
        return out

    def context(self):
        """What the metric readers read."""
        p = self.probe
        return SimpleNamespace(
            setup_s=self.setup_s, window_s=self.window_s, years=self.years,
            counts=self.counts, traced_untraced_s=self.untraced_wall(),
            step_s=self.step_s, pc_s=p.pc_s, thermo_s=p.thermo_s,
            thermo_n=p.thermo_n, gmres_s=p.gmres_s, gmres_its=p.gmres_its,
            profile=getattr(self, "profile", None), samples=p.samples)


def main(args, t_start):
    """The command line's run: exits non-zero, with no result, without the
    card the cell asks for or with JAX loaded once the window has closed."""
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    out = Run(cell, args.seed, args.seconds, args.trace,
              t_start=t_start).result()
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: modules loaded that must not be: {bad}")
        return 1
    for name, c in out["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
