#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port on one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Runs the cell named in BENCHMARK.json on the CUDA devices it asks for and
prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device` and, traced,
`breakdown`; the numbers compared with the plain reference come last,
under `compared`, and as the last lines of standard error. Exits non-zero,
with no result, without the devices, or when JAX or the JAX package has
been loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    from benchmark import harness
    sys.exit(harness.main(args, T_START))
