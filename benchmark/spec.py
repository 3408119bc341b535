"""What a cell is made of, found by name: BENCHMARK.json's entry, the
configuration file it names, the traffic file traffic/<traffic>.json and,
for every metric the cell reports, the reader metrics/<metric>.py."""

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    workload: dict        # the BENCHMARK.json entry
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the end-to-end metric entries the cell reports
    per_layer: list       # the per-layer metric entries the cell reports
    chips: int

    @property
    def name(self):
        return self.workload["name"]

    def program_config(self):
        """The program's configuration keys as the cell runs them: the
        configuration's, then the traffic's events on top."""
        return dict(self.config["config"], **self.traffic.get("config", {}))


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def reports(metric, workload):
    """Whether a metric entry is reported by a cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload, root=ROOT):
    """The cell named `workload` in BENCHMARK.json under `root`."""
    bench = load_benchmark(root)
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / c["file"]).read_text())
    traffic = json.loads((Path(root) / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if reports(m, workload)],
                [m for m in bench["per_layer"] if reports(m, workload)],
                int(w["chips"]))


def reader(metric_name):
    """The reader of a metric: metrics/<name>.py's `read(run)`, which
    returns the metric's value or None where it finds nothing to read."""
    return importlib.import_module(f"benchmark.metrics.{metric_name}").read
