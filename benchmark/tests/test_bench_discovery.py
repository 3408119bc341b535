"""The harness finds configurations, traffic and metric readers by the
names BENCHMARK.json gives, a cell or a metric added as new files too."""

import json
import shutil
import subprocess
import sys

from benchmark import spec
from benchmark.tests.conftest import ROOT


def test_every_cell_and_metric_is_found():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.program_config()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for name in names:
            assert callable(spec.reader(name))


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "mismip_mod_8km.short", "chips": 1,
                           "config": "mismip_mod_8km", "traffic": "short",
                           "why": "a cell added as data"})
    b["per_layer"].append({"name": "segments_run", "unit": "segments",
                           "better": "higher", "source": "program_counter",
                           "layer": "region driver", "moves": "sim_yr_per_hr",
                           "workloads": ["mismip_mod_8km.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    tr = json.loads((tmp_path / "benchmark/traffic/spinup_thermo.json").read_text())
    (tmp_path / "benchmark/traffic/short.json").write_text(
        json.dumps(dict(tr, segment_years=4.0)))
    (tmp_path / "benchmark/metrics/segments_run.py").write_text(
        "def read(run):\n    return len(run.counts)\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from types import SimpleNamespace as N;"
            "from benchmark import spec;"
            "c = spec.load_cell('mismip_mod_8km.short', sys.argv[1]);"
            "print(c.traffic['segment_years'],"
            " [m['name'] for m in c.per_layer][-1],"
            " spec.reader('segments_run')(N(counts=[1, 2, 3])))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, check=True,
                         cwd=tmp_path).stdout.split()
    assert out == ["4.0", "segments_run", "3"]
