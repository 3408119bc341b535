"""Checksum logging: the bitwise-drift parity oracle.

Re-design of src/UPSY/basic/checksum_mod.f90: after each major kernel, log
the global sum/min/max of a field to a structured log. The reference writes
a text checksum_logfile diffed between commits/ranks
(show_checksum_logfile_diff.csh); we write JSON lines so runs can be diffed
field-by-field across code versions and chip counts (single- vs multi-chip
bitwise comparison).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class ChecksumLogger:
    def __init__(self, path=None, enabled=False):
        self.enabled = enabled
        self.path = Path(path) if path else None
        self._fh = None
        self.entries = []

    def open(self):
        if self.path and self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("w")

    def log(self, name: str, field, t=None):
        if not self.enabled:
            return
        a = np.asarray(field)
        entry = {
            "name": name,
            "sum": float(a.sum()),
            "min": float(a.min()) if a.size else 0.0,
            "max": float(a.max()) if a.size else 0.0,
            "n": int(a.size),
        }
        if t is not None:
            entry["t"] = float(t)
        self.entries.append(entry)
        if self.path:
            self.open()
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def compare_checksum_logs(path_a, path_b, rtol=0.0):
    """Diff two checksum logs; returns list of mismatched entries."""
    def load(p):
        return [json.loads(l) for l in Path(p).read_text().splitlines() if l]
    la, lb = load(path_a), load(path_b)
    mism = []
    for ea, eb in zip(la, lb):
        for k in ("sum", "min", "max"):
            va, vb = ea[k], eb[k]
            tol = rtol * max(abs(va), abs(vb))
            if abs(va - vb) > tol:
                mism.append((ea["name"], k, va, vb))
    return mism
