"""Without the card a run fails: it exits non-zero and prints no result;
the same in a directory that holds only BENCHMARK.json and the
benchmark's files."""

import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


def run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mismip_mod_8km.spinup_thermo", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=env, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    r = run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
