"""The benchmark's wrappers around the calls into the port's layers, and
the snapshot of a region that the segments replay.

Nothing inside the program changes: the wrappers replace, on the region
and on the port's modules, the callables that the layers above call (the
PC step, the thermodynamics step, the stress balance's GMRES, the
operators' applies, the column solve), for the life of one `Probe`."""

import contextlib
import time

import torch


class Probe:
    """Counts, host-clock spans and records at the layer boundaries of
    one region.

    - `entries`: the host clock at every entry into the PC step while
      `on`;
    - `pc_s`, `thermo_s` / `thermo_n`, `gmres_s` / `gmres_its`: wall inside
      the PC steps, the thermodynamics steps (each between two calls of
      `sync` where one is given) and the GMRES calls while `on`;
    - `record`: when a list, every PC step appends (state before, state
      after, dt_max) and `record_thermo` every thermodynamics step (the ice
      at its time, Ti after);
    - under `profiled()` these calls and the operator applies and column
      solves run inside torch.profiler ranges named as RANGES says, and
      `samples` keeps the last operator and the last column solve's
      operands. Outside it the applies and solves are not wrapped."""

    RANGES = {"diva": "diva_operator", "bpa": "bpa_operator",
              "heat": "heat_columns", "pc": "pc_step",
              "thermo": "thermo_step", "gmres": "gmres"}

    def __init__(self, region, sync=None):
        from ufemism2_tpu_torch.core.ice import bpa, ssadiva, thermodynamics
        from ufemism2_tpu_torch.ops import cuda_bpa, cuda_spmv
        self.sync = sync
        self.on = False
        self.profiling = False
        self.entries = []
        self.pc_s = self.thermo_s = self.gmres_s = 0.0
        self.thermo_n = self.gmres_its = 0
        self.record = None
        self.record_thermo = None
        self.samples = {}
        self._undo = []
        approx = region.C.choice_stress_balance_approximation
        self._wrap_attr(region, "pc_step", self._pc)
        if getattr(region, "_thermo_step", None) is not None:
            self._wrap_attr(region, "_thermo_step", self._thermo)
        self._wrap_attr(bpa if approx == "BPA" else ssadiva, "gmres",
                        self._gmres)
        self._inner = [(thermodynamics, "heat_columns", self._heat)] + [
            (cls, meth, self._operator(key))
            for cls, key in ((cuda_spmv.DivaOperator, "diva"),
                             (cuda_bpa.BpaOperator, "bpa"))
            for meth in ("flat", "__call__")]

    def _wrap_attr(self, obj, name, make):
        inner = getattr(obj, name)
        setattr(obj, name, make(inner))
        self._undo.append((obj, name, inner))

    def close(self):
        """Put every wrapped callable back."""
        for obj, name, inner in reversed(self._undo):
            setattr(obj, name, inner)
        self._undo.clear()

    @contextlib.contextmanager
    def profiled(self):
        """Within the block the wrapped calls run inside profiler ranges,
        the operator applies and column solves too."""
        n = len(self._undo)
        for obj, name, make in self._inner:
            self._wrap_attr(obj, name, make)
        self.profiling = True
        try:
            yield
        finally:
            self.profiling = False
            for obj, name, inner in reversed(self._undo[n:]):
                setattr(obj, name, inner)
            del self._undo[n:]

    def _range(self, key):
        if self.profiling:
            return torch.profiler.record_function(self.RANGES[key])
        return contextlib.nullcontext()

    def _pc(self, inner):
        def pc_step(md, s, dt_max, **kw):
            t = time.perf_counter()
            if self.on:
                self.entries.append(t)
            with self._range("pc"):
                out = inner(md, s, dt_max, **kw)
            if self.on:
                self.pc_s += time.perf_counter() - t
            if self.record is not None:
                self.record.append((s, out, dt_max))
            return out
        return pc_step

    def _thermo(self, inner):
        def thermo_step(md, s, T_surf, SMB, BMB):
            if self.sync is not None:
                self.sync()
            t = time.perf_counter()
            with self._range("thermo"):
                Ti, n_unstable = inner(md, s, T_surf, SMB, BMB)
            if self.sync is not None:
                self.sync()
            if self.on:
                self.thermo_s += time.perf_counter() - t
                self.thermo_n += 1
            if self.record_thermo is not None:
                self.record_thermo.append((s, Ti))
            return Ti, n_unstable
        return thermo_step

    def _gmres(self, inner):
        def gmres(A, b, x0=None, M=None, **kw):
            t = time.perf_counter()
            with self._range("gmres"):
                res = inner(A, b, x0=x0, M=M, **kw)
            if self.on:
                self.gmres_s += time.perf_counter() - t
                self.gmres_its += res.n_iter
            return res
        return gmres

    def _heat(self, inner):
        def heat_columns(*args):
            self.samples["heat"] = args
            with self._range("heat"):
                return inner(*args)
        return heat_columns

    def _operator(self, key):
        def wrap(inner):
            def apply(op, x):
                self.samples[key] = op
                with self._range(key):
                    return inner(op, x)
            return apply
        return wrap


def snapshot(region):
    """The region's attributes as they stand (references: no tensor is
    copied); `restore` puts them back."""
    return dict(vars(region))


def restore(region, snap):
    """Put the snapshot back: every attribute the segment may have
    replaced or mutated, the host clocks (time, n_dt_ice, t_next,
    t_thermo_next, ...) with them; dicts and lists as fresh shallow
    copies, so that the snapshot itself never changes."""
    for k, v in snap.items():
        if isinstance(v, dict):
            v = dict(v)
        elif isinstance(v, list):
            v = list(v)
        setattr(region, k, v)
