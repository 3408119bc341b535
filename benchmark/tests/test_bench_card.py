"""A cell on the card, through the command BENCHMARK.json names, with a
short window: the result line is whole and correct. Runs only where there
is a CUDA device."""

import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT

CELL = "mismip_mod_8km.spinup_thermo"


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_thermo_cell_on_the_card(card, trace):
    bench = spec.load_benchmark()
    r = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload", CELL,
         "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "compared"
    cell = spec.load_cell(CELL)
    assert set(out["metrics"]) == {
        m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
