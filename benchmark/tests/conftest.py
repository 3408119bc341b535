"""Shared pieces of the benchmark's tests: the card marker and fixture, and
a small stand-in of a cell that a CPU can run in seconds."""

from pathlib import Path

import pytest
import torch

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]

# the MISMIP_mod configuration at 64 km at the grounding line (nV about
# 500): the cell's physics at a size a test run holds
SMALL_RESOLUTION = dict(
    dx_refgeo_init_idealised=32e3, maximum_resolution_uniform=200e3,
    maximum_resolution_grounded_ice=128e3,
    maximum_resolution_floating_ice=200e3,
    maximum_resolution_grounding_line=64e3, grounding_line_width=64e3,
    maximum_resolution_calving_front=128e3, calving_front_width=128e3,
    maximum_resolution_ice_front=128e3, ice_front_width=128e3)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device (decided here, never
    when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


# ISMIP-HOM A at L = 20 km on a 4 km mesh (nTri 444), the viscosity loop
# cut to two iterations a solve
ISMIP_SMALL = dict({k: 4e3 for k in (
    "maximum_resolution_uniform", "maximum_resolution_grounded_ice",
    "maximum_resolution_floating_ice", "maximum_resolution_grounding_line",
    "grounding_line_width", "maximum_resolution_calving_front",
    "calving_front_width", "maximum_resolution_ice_front",
    "ice_front_width")}, visc_it_nit=2)


def small_cell(workload="mismip_mod_8km.spinup_thermo", precision="f32",
               segment_years=1.0, startup_years=1.0, sampled=(1, 1)):
    """The cell `workload` (its traffic, metrics and limits) on a small
    stand-in of its configuration (64 km MISMIP_mod, 4 km ISMIP-HOM), with
    short segments (ISMIP-HOM keeps its one step)."""
    cell = spec.load_cell(workload)
    ismip = cell.config["config"]["choice_refgeo_init_idealised"].startswith(
        "ISMIP-HOM")
    cfg = dict(cell.config["config"],
               **(ISMIP_SMALL if ismip else SMALL_RESOLUTION),
               tpu_precision=precision)
    # two starting states: a window is whole cycles through them
    tr = dict(cell.traffic, sampled_segment=list(sampled), traced_segments=1,
              perturbation=dict(cell.traffic["perturbation"], pool=2))
    if not ismip:
        tr.update(startup_years=startup_years, segment_years=segment_years)
    if "dt_thermodynamics" in tr["config"]:
        tr["config"] = dict(tr["config"], dt_thermodynamics=0.5)
    cell.config = dict(cell.config, config=cfg)
    cell.traffic = tr
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
