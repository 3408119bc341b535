#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile STEPS] [--profile-out FILE]
        [--antarctica-only | --laddie-only | --multidevice-only |
         --validation-only]
        [--ant-init-years Y]

Needs one CUDA device and nvcc; exits non-zero without them. Phases, each
of which ends the run with a non-zero exit if it fails:

1. device   - the card's name and power limit; TF32 must be off.
2. build    - compiles ufemism2_tpu_torch/csrc/*.cu from source, one nvcc
              per source, all started together.
3. mesh     - builds the MISMIP_mod 8 km mesh on the host (a stand-in for
              config_MISMIP_8km_spinup_for_scaling.cfg, which is not in
              the repository: same geometry, physics choices and
              grounding-line resolution, written inline).
4. kernels  - stack_spmv, diva_apply (the DIVA operator fused onto it) and
              heat_columns (the column solves of the heat equation)
              against their plain tensor versions on the card at the 8 km
              shapes, with timings and the bound; torch.sparse.mm is the
              library yardstick of stack_spmv, 62 dense torch.linalg.solve
              calls that of heat_columns (no one PyTorch call computes
              diva_apply). diva_apply is also checked with an
              ocean-pressure calving front carved into the 8 km mesh at
              x = 400 km (f32 with and without the bfloat16 rounding,
              f64), on random operands, where every row must equal the
              plain version to the bit. heat_columns must equal its
              plain version to the bit, at nz 12 (its unrolled form:
              random operands in f32 and f64, and an all-stable f32
              case), at nz 15 and 7
              (its run-time-nz form), and on the edge operands of
              tests/test_torch_heat_design.py at nz 12 and 7 (inf, -inf
              and NaN in every operand that can carry one, a pivot at the
              1e-300 clamp, an overflowing factor).
5. small    - the coarse 64 km configuration in f64 on the card (CUDA
              kernels) against the same run on the CPU (plain versions),
              with thermodynamics off and on; and a 40 km MISMIP+
              configuration with 500 m of initial ice (a grounding line,
              so the flow-factor tuning fires) through program.main on the
              card and with --device cpu, f64, held to the same steps,
              viscosity iterations and tuned flow factor.
6. main     - ModelRegion(C, "ANT") on the card in f32 (initial DIVA
              solve from zero velocity), then run_to through the start-up
              transient and over a measured window of model years, with
              the kernels' launch counts read around it: diva_apply once
              per GMRES operator apply, stack_spmv for the single-operator
              applies of the viscosity iteration. The f32 solves end at
              their precision floor, so their iteration counts follow
              the operator's every rounding: the run is held to the
              counts below, which the operator as one stack_spmv launch
              and separate launches for the scaling gave as well.
7. profile  - only with --profile N: N more ice steps under
              torch.profiler; device busy share and the kernels by device
              time (the profiler's own table goes to --profile-out).
8. thermo   - the same 8 km configuration with thermodynamics on
              (Huybrechts rheology, Robin initial temperatures, a heat
              step every model year), driven the same way: heat_columns
              once per thermodynamics step, each step timed by itself;
              the trajectory is held to its own counts below; then the
              kernel case on the operands of the path's last call.
9. halfar   - the Halfar dome (SIA) in f64 to 200 model years, held to the
              analytical solution; then the kernel case on the operands
              of the phase's last heat_columns call.
9b. multidevice - the 8 km configuration sharded over P = 2 and 4 ranks
              (parallel/launch.py spawn, gloo, every rank on cuda:0; one
              spawn of 4 ranks, P = 2 on the first two, started before
              phase 5 so that their start-up goes on beside 5-9, idle
              until 9b; its processes write to standard error), each rank
              holding the region:
              stack_spmv and diva_apply on the rank's extended block
              gathered bit-equal to the single-device kernel (and
              diva_apply's sharded plain version to the single-device
              one), in f64 and in f32 (x rounded); in f32 a short window
              at P = 1, 2, 4 (Krylov and viscosity iterations, steps,
              wall a Krylov iteration; volume and mean |dHi| within
              MD_F32_TOL of P = 1), the collectives' share of a profiled
              continuation (rank 0, torch.profiler ranges around every
              collective), then a forced update_mesh and a sharded step
              on the new mesh (finite, Hi >= 0, every rank the same
              mesh), and halo_stats(). With --multidevice-only also, in
              f64 with thermodynamics (GMRES(300), MD_F64), a run_to
              window with the thermodynamics fused whose one sharded PC
              step equals the same step on one device (equal counts,
              Hi_next and the velocities within MD_STEP_TOL of their
              largest value, masks bitwise) and whose end equals that
              step and its thermodynamics step on one device (Hi, Ti,
              u_vav_b within MD_WINDOW_TOL); the whole run leaves it out
              for the 1,200 s limit (its f64 region's cold initial solve
              and the steps over gloo take the ranks about 90 s). Every
              rank counts its launches around each window; the kernels
              line has their sums by path.
10. mismipplus - a stand-in MISMIP+ configuration (written inline, as a
              .cfg file) through the program's entry point,
              program.main([cfg, "--output-dir", dir]), on the card in
              f32: the ocean-pressure calving front, Weertman sliding,
              the flow-factor tuning; the kernels' launches counted
              around it, the trajectory held to the MP_* counts below;
              then diva_apply on the operands of the run's last apply.
11. precond - one linear solve of the MISMIP+ run's last system with each
              preconditioner (block_jacobi, chebyshev, neumann,
              block_dense, two_level) in f64 on the card, built as the
              program builds it, by GMRES at the program's restart of 60
              (those in MP_CONVERGE_AT_RESTART must converge, the others
              must not) and by GMRES(300) (every one but block_jacobi must
              converge); converged means below the iteration cap with the
              true residual within the stopping rule.
12. remesh  - the main path's configuration with remeshing on (the
              schema's default), f32, driven like the main path across the
              first mesh-fitness check at 50 model years (update_mesh() is
              called at the window's end if the check does not fire),
              with at least three ice steps on the new mesh: the meshes'
              sizes, the remesh wall time in three parts (mesh build, map
              build, device rebuild) and the first step's, the new
              operators' ELL widths, the window's rates with the remesh in
              it, held to the RM_* counts; then diva_apply on the last
              operator apply of the remeshed mesh and stack_spmv on its
              five-operator stack against their plain versions.
13. small_remesh - the coarse configuration in f64 with outputs and one
              forced update_mesh(), on the card and on the CPU (a process
              of its own, started with 10): the same
              new mesh, the same steps, viscosity and Krylov iterations
              after it, fields within the small phase's gaps, the mesh
              output at generation 00002.
14. mismipplus_resume - the JAX package's MISMIP+ 5 km spin-up state
              (the committed NetCDF classic copy of its restart, t =
              11,425) resumed with its flow-factor scale 0.34 and run for
              half a model year (MP_RESUME_RUN) with outputs, restarts and
              remeshing on: in f32 and in f64 on the card, the f64 run
              held to the
              same run on the CPU over its first two ice steps (equal
              counts, small's gaps), and to a fresh region resumed from the
              port's own restart written halfway (equal steps and counts,
              fields within 1e-12); a run perturbed by 1e-15 measures the
              state's sensitivity; every output file read back through the
              port's ncio, without h5py.
15. berends_exp2 - Berends et al. (2023) experiment II's inversion chain
              on the MISMIP+ channel at 10 km in f32 (EXP2): the true
              till friction angle read from an x/y file, the ice1r
              retreat, then friction nudging with an inverted BMB and
              target thinning rates; per leg the steps, counts, wall and
              launches, the nudging events timed, the harness's metrics.
              The CPU runs that 13, 14 and 16-18 are held to start with
              10 and run beside the card's, one thread each.
16. mismipplus_ice1r - the state of 14 resumed with the MISMIP+ ice1r
              melt (MP_ICE1R) after the retreat leg's start-up, IR_YEARS
              model years in f32 with the grounding line read on the
              westeast transect every year and the transect's output file
              read back; the f32 counts held to IR_*; in f64 held to the
              CPU over MP_CMP_YR (equal counts, small's gaps, the first
              BMB field within 1e-12).
17. mismipplus_favier - the same with the Favier et al. (2019) melt under
              the ISOMIP+ WARM ocean (MP_FAVIER), FAVIER_YEARS model
              years; the same checks.
18. small_berends - the experiment II chain at 40 km in f64, card and
              CPU: equal counts in every leg, roughness and inverted BMB
              within 1e-10.
19. small_thermo_files - SMALL_THERMO with the geothermal flux read from
              a lon/lat file and the SMB from an x/y file, card against
              CPU as small_thermo, heat_columns on a file-driven path.
20. ismip_hom - ISMIP-HOM stand-ins (Pattyn et al. 2008; ISMIP_A and the
              rest, written inline: L = 20 km, a uniform 500 m mesh, nz 12,
              periodic sides), the initial solve and one ice step each:
              experiment A with BPA in f32 through the region and through
              program.main (equal counts) and in f64, A at 2 km, C (the
              sliding base row), A with the hybrid DIVA/BPA (BPA where x > 0,
              from a mask file) and with DIVA (the harness's crosscheck
              rmse against BPA); the counts, wall, u_surf on the harness's
              transect, bpa_apply twice per operator apply and line_thomas
              once per preconditioner apply, the last solve profiled; then
              small_ismip (A, C and the hybrid at 80 km in f64, card against
              a CPU process: equal counts). bpa_apply and line_thomas are
              held to their plain versions to the bit, before the main path
              on random operands at the ISMIP-HOM mesh's size (f32 with and
              without the rounding of x, f64; sliding and no-slip; periodic
              and mixed lateral rows; nz 12 and 7), and after these phases
              on the last operator and preconditioner of ismip_hom_a_bpa;
              each with its device time with the L2 hot and cold (a 64 MiB
              buffer written before each call) and its share of the bound;
              the dense torch.linalg.solve is line_thomas's yardstick; the
              profile of the last solve gives both kernels' device ms a
              Krylov iteration.
26. antarctica_init - the realistic Antarctica initialisation stand-in
              (ant_init_cfg: the reference's Ant_init_20kyr_invBMB_invfric_40km
              with every choice of its harness, 40 km on grounded ice, on
              the synthetic continent that the port's writer,
              ufemism2_tpu_torch/tools/antarctica_synthetic.py, writes into
              the work directory) in f32 on the card: construction (the
              mesh from the geometry file, the file reads, the initial
              solve), ANT_INIT_YEARS model years in windows of
              ANT_WINDOW_YEARS with the component events timed, a
              forced remesh and ANT_STEPS_AFTER steps on the new mesh; nV,
              counts, ms a Krylov iteration, sim-yr/hr, volume,
              RMSE(Hi - Hi_init) (the harness's score), the remesh wall and
              the kernels' launches; pinned by ANT_INIT_PINS. Then
              diva_apply on the last operator apply after the remesh,
              stack_spmv on the new mesh's five-operator stack and
              heat_columns on the phase's last call, against their plain
              versions.
27. antarctica_itm - resumed from 26's restart on its mesh with the rest of
              the climate chain (the transient-deltaT snapshot climate,
              realistic insolation, IMAU-ITM, ELRA, the GlacialIndex LMB),
              ANT_ITM_YEARS model years either side of a forced remesh: the
              integrated SMB, max |dHb|, the mean firn, the climate, SMB,
              GIA and LMB event times and the launches of one event each;
              pinned by ANT_ITM_PINS; diva_apply and heat_columns on the
              last calls after the remesh, against their plain versions.
28. small_climate - a coarse Antarctica in f64, card against a CPU process,
              through a forced remesh: the matrix climate with IMAU-ITM,
              ELRA and the GlacialIndex LMB, and snapshot_plus_anomalies
              for the climate and the SMB; equal counts and stateful calls,
              small's gaps, climate, SMB, firn and dHb within 1e-10; the
              insolation frame each orbit of the matrix climate reads and
              how far apart their absorbed insolation is.

29. antarctica_hydro - resumed from 26's restart with the Salle2025
              hydrology (a leg every model year), the particle tracers and
              the Pine Island and Thwaites regions of interest with their
              scalar files, ANT_HYDRO_YEARS in f32: the legs' sub-steps and
              wall, the live particles, the per-ROI volume; pinned by
              ANT_HYDRO_PINS.
30. mismipplus_iceocean1r - the state of 14 resumed with the LADDIE melt
              under the ISOMIP+ WARM ocean (MP_ICEOCEAN1R, the MISOMIP
              iceocean1r stand-in) after the retreat leg's start-up,
              IO_YEARS model years in f32, one run_to a year: the counts
              (pinned by IO_*), the grounding line on the westeast
              transect, the integrated melt and the shelf's mean and max
              melt, every LADDIE leg (wall, pseudo-steps, stages, kernel
              launches: one a leg, the seconds of the compact mesh's
              rebuild before it, the plume's max |dH|, whether a remesh
              re-ran the initial leg).
31. laddie_kernel - laddie_stage (csrc/laddie.cu, one LADDIE stage in two
              launches) against its plain version on the card, to the bit,
              on the operands of 30's last stage (its compact shelf mesh)
              and of the 2 km standalone set-up, in f32 and f64: fbrk3's
              first and third stage with the default and a non-zero beta,
              euler, lfra, Jenkins1991 gamma with the ice temperature, the
              idealised subglacial discharge; each with its eager and
              device (graph replay) ms, the plain version's ms and the bound
              (bytes at 3.35 TB/s); then laddie_leg (a whole leg in one
              cooperative launch) against the stage entry's loop and the
              plain loop over LADDIE_LEG_STEPS on both meshes, f32 and f64,
              fbrk3 with the default and a non-zero beta, euler and lfra,
              and against the stage entry over 30's whole initial leg: the
              ms a pseudo-step of each, the leg's grid and the floor of its
              grid barriers alone.
32. laddie_standalone - python -m ufemism2_tpu_torch laddie <cfg> on the
              card in a process of its own (tests/test_laddie.py's
              configuration at 2 km, the schema's dt_laddie and 30-day
              leg): nV, the shelf, the leg's wall and ms a pseudo-step, the
              stages and kernel launches, the mean melt; both output files
              read back, finite.
33. small_iceocean - MP_SMALL with the LADDIE melt and the idealised
              subglacial discharge (SMALL_IO), f64, through program.main on
              the card against a CPU process: equal counts, small's gaps,
              the melt within 1e-10.
34. small_hydro - the coarse Antarctica of 28 with Zoet-Iverson sliding on
              the Salle2025 effective pressure, the particles and the two
              regions of interest, f64, card against CPU through a forced
              remesh: equal counts and sub-steps, the till water and the
              effective pressure within 1e-10, the same live particles,
              the per-ROI scalars.

35. validation - the validation harness (ufemism2_tpu_torch/validation/):
              stand-ins for the reference's four quick-tier configs
              (VAL_STANDINS: the Halfar dome at 40 km, Schoof's ice
              stream at 32 km, ISMIP-HOM A with DIVA at L = 160 km, the
              MISMIP+ spin-up, cut for the time) written into the
              reference's layout, the harness's REF_TESTS pointed at them,
              and program.main(["integrated_tests", ...]) (the quick tier)
              on the card in a process of its own, started with phase
              10's CPU runs so that its host-bound runs go on beside
              10-19: each runner's launches counted (launches_by_path
              validation_*), then diva_apply on the quick MISMIP+ run's
              last apply and heat_columns on the Halfar run's last call
              against their plain versions. Here the script waits for it
              and holds every entry: finite cost functions with the
              stability counters, the Halfar dome to RMSE < 60 m after
              more than 10 steps, the quick MISMIP+ to a grounding line.
              program.main(["component_tests", ...]) (the default suite:
              24 scoreboard entries, the mass-conservation tier on the
              card); the demo model, both variants, card against CPU
              through a remap and a restart ('a' within 1e-12, 'b'
              bit-equal). Made earlier, where their inputs are: the NaN
              sanitizer on 5's two SMALL regions (clean they pass; with a
              NaN put into the ice thickness and do_check_for_NaN on, both
              raise NaNDetected naming the same fields), and the run tools
              (tools/run.py Run, diagnose_run, analyse_resources) on
              phase 10's MISMIP+ output directory right after 10.

With --antarctica-only the script builds the kernels and runs 26-29 alone
(no result line); --ant-init-years Y makes 26's window Y model years (not
ANT_INIT_YEARS; the pins of 26, 27 and 29 are then not held), run in
windows of ANT_WINDOW_YEARS either way, each printed. With --laddie-only
it builds the kernels and runs 30-34 alone (no result line), with
--multidevice-only 9b alone on the 8 km mesh (no result line), with
--validation-only 35 alone, with the sanitizer on SMALL regions of its
own and the run tools on an MP_SMALL run of program.main (no result
line). Every
result line carries `at_s`, the script's elapsed seconds.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import atexit
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, NVIDIA H100 SXM data sheet
H100_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.float64: 33.5e12}    # f64 outside the tensor cores
T_WARM = 20.0      # model years of start-up transient before the window
WINDOW = 40.0      # model years of the measured window
REPS = 200         # launches per kernel timing
FLUSH_BYTES = 64 << 20   # written before each call of a cold-L2 timing
# GMRES iterations of the initial solve and Krylov iterations of the window
# on the FULL configuration, and the grounding line after it [km]
INIT_GMRES_ITS, WINDOW_AXB_ITS, X_GL_KM = 3286, 1568, 457.457
# the same for the FULL configuration with thermodynamics on (FULL_THERMO),
# fixed by the first run of that path on an NVIDIA H100 80GB HBM3
TH_INIT_GMRES_ITS, TH_WINDOW_AXB_ITS, TH_X_GL_KM = 2108, 1436, 474.473

# The main path's configuration: MISMIP_mod geometry, DIVA, Zoet-Iverson
# sliding, bilinear-TAF + bedrock-CDF grounded fractions, semi-implicit
# thickness solve (the schema defaults), f32, fixed mesh.
BASE = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="MISMIP_mod",
    choice_refgeo_PD_ANT="idealised",
    choice_refgeo_PD_idealised="MISMIP_mod",
    refgeo_idealised_MISMIP_mod_Hi_init=100.0,
    choice_mask_noice="MISMIP_mod",
    uniform_Glens_flow_factor=1e-16,
    choice_ice_rheology_Glen="uniform",
    choice_thermo_model="none",
    choice_initial_ice_temperature_ANT="uniform",
    xmin_ANT=-1000e3, xmax_ANT=1000e3, ymin_ANT=-1000e3, ymax_ANT=1000e3,
    allow_mesh_updates=False,
    choice_SMB_model_ANT="uniform", uniform_SMB=0.3,
    choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
)
# full width: 8 km at the grounding line; the other resolutions are tuned
# so that the mesh lands near the real configuration's size
# (nV 13,735, nTri 27,308)
FULL = dict(
    BASE, tpu_precision="f32", dx_refgeo_init_idealised=5e3,
    maximum_resolution_uniform=100e3,
    maximum_resolution_grounded_ice=28e3,
    maximum_resolution_floating_ice=60e3,
    maximum_resolution_grounding_line=8e3, grounding_line_width=8e3,
    maximum_resolution_calving_front=16e3, calving_front_width=16e3,
    maximum_resolution_ice_front=20e3, ice_front_width=20e3,
    nit_Lloyds_algorithm=2,
)
# the coarse configuration of the CPU parity tests, run SMALL_YR model
# years card against CPU (two thermodynamics steps at 0.1 years in
# small_thermo)
SMALL_YR = 0.2
SMALL = dict(
    BASE, tpu_precision="f64", dx_refgeo_init_idealised=32e3,
    maximum_resolution_uniform=200e3,
    maximum_resolution_grounded_ice=128e3,
    maximum_resolution_floating_ice=200e3,
    maximum_resolution_grounding_line=64e3, grounding_line_width=64e3,
    maximum_resolution_calving_front=128e3, calving_front_width=128e3,
    maximum_resolution_ice_front=128e3, ice_front_width=128e3,
    nit_Lloyds_algorithm=2, visc_it_nit=3, pc_nit_max=2,
)
# thermodynamics as the schema has it: the 3-D heat equation, Huybrechts
# (1992) rheology, Robin initial temperatures, a step every model year
THERMO = dict(choice_thermo_model="3D_heat_equation",
              choice_ice_rheology_Glen="Huybrechts1992",
              choice_initial_ice_temperature_ANT="Robin",
              dt_thermodynamics=1.0)
# the small configuration with a thermodynamics step every ice step
SMALL_THERMO = dict(SMALL, **dict(THERMO, dt_thermodynamics=0.1))
FULL_THERMO = dict(FULL, **THERMO)
# the main path with remeshing on, as the schema and bench.py's amortised
# window have it: the first fitness check comes dt_mesh_update_min (50 yr)
# after the start, inside the 20 -> 60 yr window
FULL_REMESH = dict(FULL, allow_mesh_updates=True)
# its f32 trajectory on the card: the new mesh (nV, nTri), the window's
# Krylov iterations and the grounding line at its end [km], fixed by the
# first run of the phase on an NVIDIA H100 80GB HBM3
RM_MESH, RM_WINDOW_AXB_ITS, RM_X_GL_KM = (14240, 28394), 3998, 454.061
RM_STEPS_AFTER = 3          # ice steps on the new mesh at least
# the small configuration with remeshing on, for small_remesh
SMALL_REMESH = dict(SMALL, allow_mesh_updates=True)
# tests/test_halfar.py's configuration (SIA, no sliding, 50-100 km), on a
# fixed mesh, in f64, to 200 model years
HALFAR = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="Halfar",
    dx_refgeo_init_idealised=50e3,
    refgeo_idealised_Halfar_H0=3000.0,
    refgeo_idealised_Halfar_R0=500e3,
    uniform_Glens_flow_factor=1e-16,
    choice_ice_rheology_Glen="uniform",
    choice_stress_balance_approximation="SIA",
    choice_sliding_law="no_sliding",
    xmin_ANT=-750e3, xmax_ANT=750e3, ymin_ANT=-750e3, ymax_ANT=750e3,
    maximum_resolution_uniform=100e3,
    maximum_resolution_grounded_ice=100e3,
    maximum_resolution_ice_front=50e3,
    ice_front_width=50e3,
    start_time_of_run=0.0, end_time_of_run=200.0,
    nit_Lloyds_algorithm=2,
    refgeo_Hi_min=2.0,
    allow_mesh_updates=False,
)
HALFAR_T_END, HALFAR_RMSE_M = 200.0, 80.0      # tests/test_halfar.py limit
# A stand-in for the reference's MISMIP+ spin-up config
# (config_01_5km_spinup_part0.cfg, not in the repository), written from the
# MISMIP+ protocol (Asay-Davis et al. 2016, GMD 9:2471, Table 1): the
# MISMIP+ bed, 100 m of initial ice with no ice beyond x = 640 km, a domain
# reaching past it (x 0-800 km, y +-40 km) so that the ocean-pressure
# calving front acts, DIVA, Weertman sliding (m = 3, beta^2 1e4 Pa m^-1/3
# yr^1/3 = C 3.16e6 Pa m^-1/3 s^1/3), A = 2e-17 Pa^-3 yr^-1, SMB 0.3 m/yr,
# BMB 0, 5 km at the grounding line, the protocol's boundaries (u = 0 at
# the ice divide x = 0 with the thickness mirrored there, free-slip side
# walls: v = 0 and du/dy = 0 at y = +-40 km); f32, fixed mesh,
# thermodynamics off, the flow-factor tuning on. Cut: one model year in
# four coupling intervals (the spin-up runs 20,000).
MISMIPPLUS = dict(
    do_ANT=True,
    choice_refgeo_init_ANT="idealised", choice_refgeo_init_idealised="MISMIP+",
    choice_refgeo_PD_ANT="idealised", choice_refgeo_PD_idealised="MISMIP+",
    refgeo_idealised_MISMIPplus_Hi_init=100.0, dx_refgeo_init_idealised=2e3,
    choice_mask_noice="MISMIP+", refgeo_idealised_MISMIPplus_tune_A=True,
    xmin_ANT=0.0, xmax_ANT=800e3, ymin_ANT=-40e3, ymax_ANT=40e3,
    maximum_resolution_uniform=20e3, maximum_resolution_grounded_ice=10e3,
    maximum_resolution_floating_ice=10e3,
    maximum_resolution_grounding_line=5e3, grounding_line_width=5e3,
    maximum_resolution_calving_front=5e3, calving_front_width=5e3,
    maximum_resolution_ice_front=10e3, ice_front_width=10e3,
    nit_Lloyds_algorithm=2, allow_mesh_updates=False, refgeo_Hi_min=2.0,
    choice_stress_balance_approximation="DIVA", BC_ice_front="ocean_pressure",
    choice_sliding_law="Weertman", slid_Weertman_m=3.0,
    slid_Weertman_beta_sq_uniform=1e4,
    choice_ice_rheology_Glen="uniform", uniform_Glens_flow_factor=2.0e-17,
    choice_thermo_model="none", choice_initial_ice_temperature_ANT="uniform",
    choice_SMB_model_ANT="uniform", uniform_SMB=0.3,
    choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
    BC_u_west="zero", BC_v_west="infinite", BC_H_west="infinite",
    BC_u_north="infinite", BC_v_north="zero",
    BC_u_south="infinite", BC_v_south="zero",
    tpu_precision="f32",
    start_time_of_run=0.0, end_time_of_run=1.0, dt_coupling=0.25,
    dt_output=0.25,
)
# The JAX package's MISMIP+ 5 km spin-up at t = 11,425 (nV 632, nTri 1,134;
# validation_runs/persist/mismipplus_5km_spinup/restart_ANT_00001.nc, a
# NetCDF4 file) in its NetCDF classic copy, which needs no h5py; the
# spin-up's tuned flow-factor scale and the flow factor it scaled
# (glen_A_scale.json beside the restart: scale 0.34, A0 1.156e-17)
MP_RESTART = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data",
                          "mismipplus_5km_restart_t11425_classic.nc")
MP_GLEN_A_SCALE = 0.34
# the stand-in's physics resumed from that state, with the spin-up's flow
# factor, remeshing on (the schema's default) and outputs: one coupling
# interval of one model year, an output and a restart every half year
MP_RESUME = dict(MISMIPPLUS, uniform_Glens_flow_factor=1.156e-17,
                 allow_mesh_updates=True, start_time_of_run=11425.0,
                 end_time_of_run=11426.0, dt_coupling=1.0, dt_output=0.5,
                 dt_output_restart=0.5)
# mismipplus_resume's run of that state: half a model year, an output and a
# restart every quarter year (MP_RESUME's year took the phase 130 s, with
# the whole script near its 1,200 s limit)
MP_RESUME_RUN = dict(MP_RESUME,
                     end_time_of_run=MP_RESUME["start_time_of_run"] + 0.5,
                     dt_output=0.25, dt_output_restart=0.25)
# the f64 card run is held to the CPU's over its first two ice steps (0.2
# model years): from the third on, thin ice on the side walls crosses the
# Hi_min removal threshold at a few vertices, and there the run follows
# the last bit of any rounding (the phase measures how far one 1e-15
# perturbation carries by the run's end, half a model year)
MP_CMP_YR = 0.2
# its f32 trajectory on the card: GMRES iterations of the initial solve,
# Krylov iterations of the run, ice volume at its end [m^3], fixed by the
# first run of the phase on an NVIDIA H100 80GB HBM3
MP_INIT_GMRES_ITS, MP_AXB_ITS, MP_ICE_VOLUME_M3 = 8928, 56126, 4.109745379e12
# The MISMIP+ configuration of tests/test_torch_program.py (RUN) in f64:
# 40 km, 500 m of initial ice in the MISMIP+ mask, so that a grounding line
# exists and the flow-factor tuning fires in the second and third coupling
# intervals; three coupling intervals of 0.1 yr. Run through program.main
# on the card and on the CPU (the same run the CPU test holds to the JAX
# package's run_model).
MP_SMALL = dict(
    do_ANT=True,
    choice_refgeo_init_ANT="idealised", choice_refgeo_init_idealised="MISMIP+",
    choice_refgeo_PD_ANT="idealised", choice_refgeo_PD_idealised="MISMIP+",
    refgeo_idealised_MISMIPplus_Hi_init=500.0, dx_refgeo_init_idealised=10e3,
    choice_mask_noice="MISMIP+", refgeo_idealised_MISMIPplus_tune_A=True,
    choice_stress_balance_approximation="DIVA", choice_sliding_law="Weertman",
    slid_Weertman_beta_sq_uniform=1e4, BC_ice_front="ocean_pressure",
    choice_ice_rheology_Glen="uniform", uniform_Glens_flow_factor=2.0e-17,
    choice_thermo_model="none", choice_initial_ice_temperature_ANT="uniform",
    choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
    uniform_SMB=0.3, choice_SMB_model_ANT="uniform",
    xmin_ANT=0.0, xmax_ANT=800e3, ymin_ANT=-40e3, ymax_ANT=40e3,
    maximum_resolution_uniform=40e3, maximum_resolution_grounded_ice=40e3,
    maximum_resolution_grounding_line=40e3,
    nit_Lloyds_algorithm=2, refgeo_Hi_min=2.0,
    allow_mesh_updates=False, visc_it_nit=3, pc_nit_max=2,
    start_time_of_run=0.0, end_time_of_run=0.3, dt_coupling=0.1,
)
# the preconditioners held to a converged solve of the run's last system in
# GMRES(MP_PRECOND_RESTART), block_jacobi (the run's own) beside them; and
# those that converge in GMRES at the program's restart of 60 (all five),
# fixed by the first run of the phase on an NVIDIA H100 80GB HBM3
MP_PRECONDS = ("chebyshev", "neumann", "block_dense", "two_level")
MP_PRECOND_RESTART = 300
MP_CONVERGE_AT_RESTART = ("block_jacobi", "chebyshev", "neumann",
                          "block_dense", "two_level")
# MISMIP+ ice1r (Asay-Davis et al. 2016, the retreat leg after the spin-up;
# the JAX package's harness, ufemism2_tpu/validation/integrated_tests.py:
# 530-637): MP_RESUME's state and physics with the ice1r melt, a BMB event
# every model year (a stand-in: the schema's dt_BMB of 10 years would
# evaluate the melt once in the cut window; the reference's
# config_03_5km_ice1r.cfg is not in the repository) and the westeast
# transect's output file; IR_YEARS model years (the reference runs 100),
# the grounding line read from the transect every year as the harness
# reads it
IR_YEARS = 5
MP_ICE1R = dict(MP_RESUME, choice_BMB_model_ANT="idealised",
                choice_BMB_model_idealised="MISMIP+", dt_BMB=1.0,
                transects_ANT="westeast,dx=1e3",
                end_time_of_run=MP_RESUME["start_time_of_run"] + IR_YEARS)
# its f32 trajectory on the card: ice steps, viscosity and Krylov
# iterations over the IR_YEARS, fixed by the first run of the phase on an
# NVIDIA H100 80GB HBM3
IR_STEPS, IR_VISC_ITS, IR_AXB_ITS = 44, 168, 30140
# MISOMIP iceocean1r (Asay-Davis et al. 2016, the coupled retreat leg after
# the spin-up; the JAX package's harness, ufemism2_tpu/validation/
# integrated_tests.py:640-720): MP_RESUME's state and physics with the
# LADDIE melt under the ISOMIP+ WARM ocean, an ocean and a BMB event every
# model year, the westeast transect. A stand-in, as MP_ICE1R is (the
# reference's config_06_5km_iceocean1r.cfg is not in the repository); the
# schema's LADDIE settings (dt_laddie 360 s, a 30-day initial and 6-day
# later legs, fbrk3 with its default beta); IO_YEARS model years (the
# reference runs 100)
IO_YEARS = 5
MP_ICEOCEAN1R = dict(MP_RESUME, choice_BMB_model_ANT="laddie",
                     choice_ocean_model_ANT="idealised",
                     choice_ocean_model_idealised="ISOMIP",
                     choice_ocean_isomip_scenario="WARM",
                     dt_ocean=1.0, dt_BMB=1.0,
                     transects_ANT="westeast,dx=1e3",
                     end_time_of_run=MP_RESUME["start_time_of_run"]
                     + IO_YEARS)
# its f32 trajectory on the card: ice steps, viscosity and Krylov
# iterations over the IO_YEARS, fixed by the first run of the phase on an
# NVIDIA H100 80GB HBM3
IO_STEPS, IO_VISC_ITS, IO_AXB_ITS = 49, 224, 42251
# the quadratic local melt of Favier et al. (2019) under the ISOMIP+ WARM
# far-field profile (MISOMIP1: MISMIP+ ice under ISOMIP+ forcing), the
# schema's gamma, an ocean and a BMB event every model year; FAVIER_YEARS
# model years
FAVIER_YEARS = 0.5
MP_FAVIER = dict(MP_RESUME, choice_ocean_model_ANT="idealised",
                 choice_ocean_model_idealised="ISOMIP",
                 choice_ocean_isomip_scenario="WARM",
                 choice_BMB_model_ANT="parameterised",
                 choice_BMB_model_parameterised="Favier2019",
                 dt_ocean=1.0, dt_BMB=1.0)
# Berends et al. (2023) experiment II, the chain 'dHdt_invfric_invBMB'
# (integrated_tests.py:1142-1260) on the MISMIP+ channel: the MISMIPPLUS
# stand-in with Zoet-Iverson sliding and the schema's boundaries (the
# reference's config_01_exp_II_spinup_5km.cfg is not in the repository;
# with the protocol's free-slip walls the slab's f64 solves end by
# stagnation, and two roundings part by 1e-7 from the first solve on),
# 10 km everywhere, f32, fixed mesh. Leg 1 runs with the true till
# friction angle read from an x/y file; leg 2 runs the ice1r melt from leg
# 1's thickness; leg 3 starts from leg 2's thickness with a uniform angle
# (the true field's mean), nudges it by H_dHdt_flowline and inverts the
# BMB against leg 2's geometry and thinning rate (do_target_dHi_dt). Legs
# of EXP2_LEGS model years (the reference runs 20,000 / 10 / 2,000), so
# leg 1 starts from 500 m of ice, not the reference's 100 m slab (whose
# draft stays above the melt's -100 m and which has no grounded ice for
# the nudging within a cut leg), the nudging comes every half model year
# and the BMB events every model year (the schema's 5 and 10 years would
# give none in a cut leg)
EXP2 = dict({k: v for k, v in MISMIPPLUS.items()
             if not k.startswith(("BC_u_", "BC_v_", "BC_H_"))},
            choice_sliding_law="Zoet-Iverson",
            refgeo_idealised_MISMIPplus_tune_A=False,
            maximum_resolution_uniform=10e3,
            maximum_resolution_grounded_ice=10e3,
            maximum_resolution_floating_ice=10e3,
            maximum_resolution_grounding_line=10e3,
            grounding_line_width=10e3,
            maximum_resolution_calving_front=10e3, calving_front_width=10e3,
            maximum_resolution_ice_front=10e3, ice_front_width=10e3,
            refgeo_idealised_MISMIPplus_Hi_init=500.0,
            bed_roughness_nudging_dt=0.5, dt_BMB=1.0,
            start_time_of_run=0.0)
EXP2_LEGS = (0.1, 0.1, 0.5)
# the same chain at 40 km (MP_SMALL's mesh) in f64, the viscosity loop and
# the corrector cut as in the CPU tests; held card against CPU
SMALL_EXP2 = dict(EXP2, tpu_precision="f64",
                  maximum_resolution_uniform=40e3,
                  maximum_resolution_grounded_ice=40e3,
                  maximum_resolution_floating_ice=40e3,
                  maximum_resolution_grounding_line=40e3,
                  grounding_line_width=40e3,
                  maximum_resolution_calving_front=40e3,
                  calving_front_width=40e3,
                  maximum_resolution_ice_front=40e3, ice_front_width=40e3,
                  dx_refgeo_init_idealised=10e3,
                  bed_roughness_nudging_dt=1.0,
                  visc_it_nit=3, pc_nit_max=2)
SMALL_EXP2_LEGS = (2.0, 1.0, 2.0)


_T0 = time.perf_counter()
_JOB = None        # the name of a card job (start_card_job) in its process


def say(phase, **kv):
    """One result line; `at_s` is the script's elapsed time (in a card
    job, on its parent's clock, and the line carries the job's name)."""
    job = {} if _JOB is None else {"job": _JOB}
    print(json.dumps({"phase": phase, **kv, **job,
                      "at_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def time_ms(fn, reps, warm=50):
    """Mean time of fn() in ms over `reps` back-to-back eager calls (CUDA
    events), after `warm` calls: what a caller in a Python loop pays per
    call, host work included."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean device time of fn() in ms with the host taken out: `reps`
    calls captured into one CUDA graph, the replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms_cold(fn, reps):
    """(mean device time of fn() in ms with a cold L2, the flush's own
    time): `reps` pairs of a flush and fn() in one CUDA graph, less `reps`
    flushes alone. The flush writes FLUSH_BYTES, more than the 50 MB L2,
    as GMRES's CGS2 walks its basis between two operator applies."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush = lambda: buf.fill_(1.0)
    both = graph_ms(lambda: (flush(), fn()), reps)
    alone = graph_ms(flush, reps)
    return both - alone, alone


def kernel_case(name, A_mats, x_np, dtype, round_x):
    """One stack_spmv comparison: kernel vs plain vs torch.sparse.mm on
    the same operands, plus the roofline bound for this data."""
    import scipy.sparse as sp
    from ufemism2_tpu_torch.ops import cuda_spmv
    from ufemism2_tpu_torch.ops.sparse import ell_stack_from_csr

    S = ell_stack_from_csr(A_mats, dtype=dtype, device="cuda")
    x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
    n0 = cuda_spmv.launches
    y = cuda_spmv.stack_spmv(S.cols, S.vals, x, round_x_bf16=round_x)
    torch.cuda.synchronize()
    assert cuda_spmv.launches == n0 + 1
    y_ref = cuda_spmv.stack_spmv_plain(S.cols, S.vals, x,
                                       round_x_bf16=round_x)
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape and y.dtype == dtype
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    # summation order differs between the kernel's k-loop and the plain
    # version's reduction: a few ulps of the largest result
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * scale
    ok = bool(torch.isfinite(y).all()) and err <= tol

    # timed as the model calls it: through the operator object, whose
    # tables were checked when it was built
    assert torch.equal(S.apply(x, exact=not round_x), y)
    n0 = cuda_spmv.launches
    ms = time_ms(lambda: S.apply(x, exact=not round_x), REPS)
    n1 = cuda_spmv.launches
    assert n1 == n0 + 50 + REPS
    device_ms = graph_ms(lambda: S.apply(x, exact=not round_x), REPS)
    # launches recorded into the graph counted once each, replays not
    assert cuda_spmv.launches == n1 + REPS + 3
    plain_ms = time_ms(lambda: cuda_spmv.stack_spmv_plain(
        S.cols, S.vals, x, round_x_bf16=round_x), max(REPS // 10, 5))
    # library yardstick: all operators stacked row-wise in one CSR matrix,
    # one torch.sparse.mm (no x rounding there)
    A_all = sp.vstack([m.tocsr() for m in A_mats]).tocsr()
    A_t = torch.sparse_csr_tensor(
        torch.as_tensor(A_all.indptr, dtype=torch.int64, device="cuda"),
        torch.as_tensor(A_all.indices, dtype=torch.int64, device="cuda"),
        torch.as_tensor(A_all.data, dtype=dtype, device="cuda"),
        size=A_all.shape)
    x2 = x if x.ndim == 2 else x[:, None]
    y_lib = torch.sparse.mm(A_t, x2)
    if not round_x:
        lib_err = float((y_lib.reshape(len(A_mats), -1, x2.shape[1])
                         - y_ref.reshape(len(A_mats), -1, x2.shape[1]))
                        .abs().max())
        ok = ok and lib_err <= 10 * tol
    library_ms = time_ms(lambda: torch.sparse.mm(A_t, x2), REPS)

    size = torch.empty((), dtype=dtype).element_size()
    n_ops, n_rows, n_cols = len(A_mats), S.n_rows, S.n_cols
    d = x2.shape[1]
    U = sum(abs(m) for m in A_mats).tocsr()
    nnz = int(U.nnz)                       # shared pattern: what the data needs
    nbytes = (nnz * 4 + n_ops * nnz * size + n_cols * d * size
              + n_ops * n_rows * d * size)
    flops = 2 * n_ops * nnz * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[dtype] * 1e3
    out = dict(case=name, n_ops=n_ops, n_rows=n_rows, n_cols=n_cols, K=S.K,
               nnz=nnz, d=d, dtype=str(dtype).replace("torch.", ""),
               round_x_bf16=round_x, max_abs_err=err, tol=tol,
               max_abs_y=scale, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms,
               library_ms=library_ms, eager_over_library=ms / library_ms,
               bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               ok=ok)
    say("kernel_case", **out)
    if not ok:
        raise SystemExit(f"stack_spmv disagrees with its plain version in "
                         f"case {name}: err {err:.3e} > tol {tol:.3e}")
    return out


def diva_operands(mesh, m2, dtype, rng):
    """Operands of one diva_apply comparison at the mesh's size: random
    per-triangle fields of the sizes the viscosity iteration produces, a
    random (u, v), and row kinds in which free, 'infinite' and identity
    rows all occur (a fifth of the rows are boundary rows, of either kind
    per component)."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    from ufemism2_tpu_torch.ops.sparse import ell_stack_from_csr
    n = mesh.nTri
    S = ell_stack_from_csr(m2, dtype=dtype, device="cuda")
    dev = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device="cuda")
    mask = mesh.TriC >= 0
    free = rng.random(n) > 0.2
    inf_u = ~free & (rng.random(n) < 0.5)
    inf_v = ~free & (rng.random(n) < 0.5)
    assert (~free & ~inf_u).any() and inf_u.any() and inf_v.any()
    rows = cuda_spmv.DivaRows(
        dev(np.where(mask, mesh.TriC, 0), torch.int64), dev(mask, torch.bool),
        dev(free, torch.bool), dev(inf_u, torch.bool), dev(inf_v, torch.bool))
    fields = (dev(1e9 * (1.0 + rng.random(n))),
              dev(1e4 * rng.standard_normal(n)),
              dev(1e4 * rng.standard_normal(n)), dev(1e3 * rng.random(n)))
    x = dev(300.0 * rng.standard_normal(2 * n))
    return S, rows, fields, x


def carved_front(mesh, x_front=400e3):
    """The ocean-pressure front of a slab of ice 200-1,200 m thick with the
    ice removed beyond x = x_front (as the JAX package's front test carves
    it), from the port's calc_front in f64 on the card: (is_front, off,
    n_x, n_y)."""
    from ufemism2_tpu_torch.core.ice.ssadiva import calc_front
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    md = build_mesh_data(mesh, dtype=torch.float64, device="cuda")
    rng = np.random.default_rng(400)
    V = mesh.V
    Hi = np.where(V[:, 0] > x_front, 0.0, 200.0 + 1000.0 * rng.random(len(V)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    Hi, Hb = t(Hi), t(-500.0 * np.ones(len(V)))
    f = calc_front(md, Hi, Hb, torch.zeros_like(Hi),
                   md.M_map_a_b.exact_matvec(Hi))
    assert bool(f.is_front.any()) and bool(f.off.any())
    return f[:4]


def diva_case(name, mesh, m2, dtype, round_x, rng, front=None):
    """One diva_apply comparison on random operands (with an ocean-pressure
    front when `front` is given, cast to `dtype`): see diva_check."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    S, rows, fields, x = diva_operands(mesh, m2, dtype, rng)
    if front is not None:
        front = tuple(f.to(dtype) if f.is_floating_point() else f
                      for f in front)
    A = cuda_spmv.DivaOperator(S.op, rows, *fields, round_x_bf16=round_x,
                               front=front)
    return diva_check(name, A, x, [m.tocsr() for m in m2])


def diva_check(name, A, x, m2=None):
    """The kernel behind the operator A (a DivaOperator on the card)
    against its plain version on the flat operand x, plus timings and the
    roofline bound for this data. With an ocean-pressure front every row
    must equal the plain version to the bit (that instance sums the
    derivatives in the plain version's order, without fused multiply-adds).
    Without one, the rows whose arithmetic has one order - the boundary
    rows (copies and three-term sums of the unrounded operand, added in the
    plain version's order) - must equal it to the bit, and the free rows
    must agree to a few ulps of the largest result (the infinite-slab
    instance sums the derivatives with fused multiply-adds)."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    S, rows, n = A.stack, A.rows, A.n
    dtype = x.dtype
    n0 = cuda_spmv.diva_launches
    y = A.flat(x)
    yu, yv = A((x[:n], x[n:]))
    torch.cuda.synchronize()
    assert cuda_spmv.diva_launches == n0 + 2
    assert torch.equal(torch.cat([yu, yv]), y)
    plain = lambda: cuda_spmv.diva_apply_plain(
        (S.cols, S.vals), rows, *A.fields, x[:n], x[n:], A.round, A.front)
    y_ref = torch.cat(plain())
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape and y.dtype == dtype
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * scale
    one_order = ~rows.free
    n_front = n_off = 0
    if A.front is not None:
        is_front, off = A.front[0], A.front[1]
        one_order = (one_order & ~is_front) | off
        n_front, n_off = int(is_front.sum()), int(off.sum())
    one_order = torch.cat([one_order, one_order])
    err_one = float((y - y_ref)[one_order].abs().max()) \
        if bool(one_order.any()) else 0.0
    bit_equal = bool(torch.equal(y, y_ref))
    ok = bool(torch.isfinite(y).all()) and err <= tol and err_one == 0.0 \
        and (bit_equal or A.front is None)

    ms = time_ms(lambda: A.flat(x), REPS)
    n1 = cuda_spmv.diva_launches
    device_ms = graph_ms(lambda: A.flat(x), REPS)
    assert cuda_spmv.diva_launches == n1 + REPS + 3
    plain_ms = time_ms(plain, max(REPS // 10, 5))

    size = x.element_size()
    if m2 is not None:
        nnz = int(sum(abs(m) for m in m2).tocsr().nnz)
    else:          # the stored pattern: entries with a coefficient
        nnz = int((S.vals != 0).any(dim=0).sum())
    n_bdry = int((~rows.free).sum())
    # in: the shared index table and five coefficient tables, u, v, four
    # fields, the row code (the operator's own with a front) and the
    # boundary rows' neighbour table, the normals of the front rows;
    # out: Au, Av
    nbytes = (nnz * 4 + 5 * nnz * size + 6 * n * size + n
              + n_bdry * 12 + 2 * n_front * size + 2 * n * size)
    flops = 2 * 5 * nnz * 2 + 30 * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[dtype] * 1e3
    out = dict(case=name, n_rows=n, K=S.K, nnz=nnz, boundary_rows=n_bdry,
               front_rows=n_front, off_rows=n_off,
               dtype=str(dtype).replace("torch.", ""), round_x_bf16=A.round,
               max_abs_err=err, tol=tol, max_abs_y=scale,
               max_abs_err_one_order_rows=err_one, bit_equal=bit_equal,
               ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=None, bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               ok=ok)
    say("diva_case", **out)
    if not ok:
        raise SystemExit(f"diva_apply disagrees with its plain version in "
                         f"case {name}: err {err:.3e} > tol {tol:.3e}, or "
                         f"rows of one order differ by {err_one:.3e}, or "
                         f"with a front not bit-equal ({bit_equal})")
    return out


def heat_operands(nV, zeta, dtype, rng, device="cuda", unstable=True):
    """Operands of one heat_columns comparison: physical columns at the
    mesh's size (ice 5-3,000 m thick, temperatures below the melting
    point, advection and strain heating of the sizes the model makes),
    with a tenth made unstable on purpose (infinite or huge heating: the
    Robin fallback) unless `unstable` is False, grounded, floating,
    grounding-line (subgrid mix) and ice-free columns, and thin-ice
    columns."""
    from ufemism2_tpu_torch.ops import cuda_heat
    from ufemism2_tpu_torch.ops.tridiag import zeta_tridiag_operators
    from ufemism2_tpu_torch.utils.constants import T0
    nz = len(zeta)
    zeta = np.asarray(zeta, np.float32 if dtype == torch.float32
                      else np.float64)
    dev = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=device)
    H = rng.uniform(5.0, 3000.0, nV)
    pmp = dev(T0 - 8.7e-4 * H[:, None] * zeta[None, :])
    Ti = dev(np.minimum(240.0 + 30.0 * rng.random((nV, nz)),
                        pmp.double().cpu().numpy()))
    c_dd = rng.standard_normal((nV, nz)) * 3e-4
    c_dd = dev(c_dd * (1.0 + 1e3 * ((rng.random((nV, 1)) < 0.1) & unstable)))
    c_d2 = dev(-36.0 / H[:, None] ** 2 * (1.0 + rng.random((nV, nz))))
    rhs = rng.standard_normal((nV, nz)) * 1e-2
    rhs[(rng.random(nV) < 0.05) & unstable] = np.inf
    rhs[(rng.random(nV) < 0.05) & unstable] *= 1e6
    kind = rng.integers(0, 4, nV)     # grounded, floating, GL, ice-free
    masks = [dev(m, torch.bool) for m in (
        kind == 0, kind == 1, (kind == 2) | (rng.random(nV) < 0.05),
        H < 10.0 + 290.0 * (rng.random(nV) < 0.05))]
    zrows = cuda_heat.zeta_rows(zeta_tridiag_operators(zeta), device)
    # a surface above T0 caps the top row at T0 rounded to the fields'
    # type, which in float32 lies above T0 and fails the stability test
    t_surf = rng.uniform(230.0, 280.0 if unstable else 270.0, nV)
    ops = (Ti, c_dd, c_d2, dev(rhs), dev(t_surf),
           dev(-rng.uniform(0.5, 5.0, nV), torch.float64),
           pmp[:, -1].contiguous(), pmp, *masks[:3],
           dev(rng.random(nV)), masks[3],
           dev(240.0 + 20.0 * rng.random((nV, nz)), torch.float64), zrows)
    return (*ops, 1.0, "subgrid")


def heat_bound(args):
    """Bytes and f64 operations that one heat_columns call on `args` must
    move and do, with the counts of grounding-line columns that mix both
    boundary conditions and of unstable columns.

    Every column reads its thin flag and T_surf and writes its row; a thin
    column reads its Ti_pmp row besides, nothing else. A solved column
    reads Ti, c_dd, c_d2, rhs and Ti_pmp, the masks that decide its
    boundary condition and only the basal values that condition needs
    (q_base for the flux one, T_base_float for the pmp one, fraction_gr
    for the mix); only an unstable column reads its T_robin row. Which
    columns are unstable: the plain version with a NaN Robin profile is
    NaN there and only there (a stable column is finite)."""
    from ufemism2_tpu_torch.ops import cuda_heat
    nV, nz = args[0].shape
    size = args[0].element_size()
    grounded, floating, gl, thin = (args[j].cpu().numpy()
                                    for j in (8, 9, 10, 12))
    robin_nan = torch.full_like(args[13], float("nan"))
    probe, _ = cuda_heat.heat_columns_plain(*args[:13], robin_nan, *args[14:])
    unstable = (torch.isnan(probe).any(1) & ~args[12]).cpu().numpy()
    sel = np.where(gl, cuda_heat.GL_BC.get(args[16], 2),
                   np.where(grounded, 0, np.where(floating, 1, 0)))
    solved = ~thin
    n_masks = nV + solved.sum() + (solved & ~gl).sum() \
        + (solved & ~gl & ~grounded).sum()
    nbytes = int(nV * (size + nz * 8)                 # T_surf, out
                 + thin.sum() * nz * size             # Ti_pmp of thin ones
                 + solved.sum() * 5 * nz * size       # the [n, nz] fields
                 + (solved & (sel != 1)).sum() * 8    # q_base
                 + (solved & (sel != 0)).sum() * size     # T_base_float
                 + (solved & (sel == 2)).sum() * size     # fraction_gr
                 + n_masks + unstable.sum() * nz * 8      # masks, T_robin
                 + 6 * nz * 8 + 4)                        # zrows, count
    # f64 operations per solved column: 8 a row for the sub/super-diagonal
    # and the dt-free parts of the diagonal; a level 5 a row (the diagonal,
    # then den and cp once); a substep 7 a row (b, the dp sweep, the back
    # substitution), and for a mixed column 5 a row more (the second back
    # substitution and the mix). Counted as the least the kernel can do on
    # this data: a stable column one level of one substep, an unstable one
    # five levels of one substep each (the non-finite exit). A column
    # first stable at a later level, an unstable one whose carry stays
    # finite and the speculative level 4 of a stable column do more.
    mixed = solved & (sel == 2)
    levels = np.where(unstable, 5, 1)
    per_col = 8 * nz + (5 + np.where(mixed, 12, 7)) * nz * levels
    flops = int(per_col[solved].sum())
    return nbytes, flops, int(mixed.sum()), int(unstable.sum())


def heat_case(name, args):
    """One heat_columns comparison on the arguments `args` of a call:
    kernel against its plain version on the card (to the bit), with
    timings, the bound and the library yardstick (62 dense batched
    solves)."""
    from ufemism2_tpu_torch.ops import cuda_heat
    nV, nz = args[0].shape
    n0 = cuda_heat.launches
    out, n_un = cuda_heat.heat_columns(*args)
    torch.cuda.synchronize()
    assert cuda_heat.launches == n0 + 1
    ref, n_ref = cuda_heat.heat_columns_plain(*args)
    torch.cuda.synchronize()
    thin = args[12].cpu().numpy()
    n_unstable, n_unstable_plain = int(n_un), int(n_ref)
    bit_equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    ok = bit_equal and n_unstable == n_unstable_plain \
        and bool(torch.isfinite(out).all())

    ms = time_ms(lambda: cuda_heat.heat_columns(*args), REPS)
    n1 = cuda_heat.launches
    device_ms = graph_ms(lambda: cuda_heat.heat_columns(*args), REPS)
    assert cuda_heat.launches == n1 + REPS + 3
    plain_ms = time_ms(lambda: cuda_heat.heat_columns_plain(*args), 3, 1)

    # library yardstick: one level's tridiagonal systems as dense [nz, nz]
    # matrices, solved by torch.linalg.solve; the kernel's work is 62 such
    # solves at most (31 substeps, both boundary conditions)
    Ti = args[0]
    A = torch.diag_embed(3.0 + torch.rand(nV, nz, dtype=torch.float64,
                                          device="cuda"))
    A = A + torch.diag_embed(torch.rand(nV, nz - 1, dtype=torch.float64,
                                        device="cuda"), 1) \
        + torch.diag_embed(torch.rand(nV, nz - 1, dtype=torch.float64,
                                      device="cuda"), -1)
    b = Ti.double()[..., None]
    library_ms = 62.0 * time_ms(lambda: torch.linalg.solve(A, b), 20, 5)

    nbytes, flops, n_mixed, n_unst = heat_bound(args)
    assert n_unst == n_unstable_plain
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[torch.float64] * 1e3
    out_d = dict(case=name, n_columns=nV, nz=nz,
                 dtype=str(Ti.dtype).replace("torch.", ""), dt=args[15],
                 gl_bc=args[16],
                 thin_columns=int(thin.sum()), mixed_columns=n_mixed,
                 unstable_columns=n_unst,
                 n_unstable=n_unstable, n_unstable_plain=n_unstable_plain,
                 bit_equal=bit_equal, max_abs_err=err, ms=ms,
                 device_ms=device_ms, plain_ms=plain_ms,
                 library_ms=library_ms, bytes=nbytes, flops=flops,
                 bound_ms=max(t_bytes, t_flops),
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 ok=ok)
    say("heat_case", **out_d)
    if not ok:
        raise SystemExit(f"heat_columns disagrees with its plain version in "
                         f"case {name}: max err {err:.3e}, n_unstable "
                         f"{n_unstable} against {n_unstable_plain}")
    return out_d


def small_phase(phase, Cs, mesh_s, then=None):
    """The coarse f64 configuration on the card (kernels) and on the CPU
    (plain versions), SMALL_YR model years: the same steps and viscosity
    iterations, fields within the gaps of two f64 runs that differ in
    summation order. `then`, if given, is called with both regions at
    the end."""
    from ufemism2_tpu_torch.main.region import ModelRegion
    t0 = time.perf_counter()
    r_cpu = ModelRegion(Cs, "ANT", mesh=mesh_s, device="cpu")
    r_cpu.run_to(SMALL_YR)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_gpu = ModelRegion(Cs, "ANT", mesh=mesh_s, device="cuda")
    r_gpu.run_to(SMALL_YR)
    t_gpu = time.perf_counter() - t0
    sc, sg = r_cpu.state, r_gpu.state
    gaps = {}
    for name in ("Hi", "u_vav_b", "v_vav_b", "Ti"):
        a, b = getattr(sc, name), getattr(sg, name).cpu()
        gaps[name] = float((a - b).abs().max() / a.abs().max())
    say(phase, nV=mesh_s.nV, nTri=mesh_s.nTri,
        steps=r_gpu.n_dt_ice, n_visc_its=[sc.n_visc_its, sg.n_visc_its],
        n_Axb_its=[sc.n_Axb_its, sg.n_Axb_its], rel_gap=gaps,
        thermo_steps=[r_cpu.thermo_steps, r_gpu.thermo_steps],
        seconds_cpu=t_cpu, seconds_card=t_gpu)
    # GMRES at rtol 1e-7 bounds the velocity gap
    assert r_cpu.n_dt_ice == r_gpu.n_dt_ice
    assert sc.n_visc_its == sg.n_visc_its
    assert abs(sc.n_Axb_its - sg.n_Axb_its) <= 0.02 * sc.n_Axb_its
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps
    assert r_cpu.thermo_steps == r_gpu.thermo_steps
    assert gaps["Ti"] <= 1e-12, gaps
    if then is not None:
        then({"cpu": r_cpu, "cuda": r_gpu})
    return gaps


def small_mismipplus_phase(workdir):
    """MP_SMALL through program.main on the card (kernels, the front
    instance of diva_apply) and with --device cpu (plain versions), f64:
    the same ice steps and viscosity iterations, the same tuned flow
    factor, fields within small_phase's gaps. Ties the card's front,
    Weertman and tuning path to the CPU path that the CPU tests hold to
    the JAX package."""
    from ufemism2_tpu_torch.main import program
    from ufemism2_tpu_torch.ops import cuda_spmv
    cfg = write_namelist(os.path.join(workdir, "mismipplus_small.cfg"),
                         MP_SMALL)
    runs, seconds = {}, {}
    for dev in ("cpu", "cuda"):
        n0 = cuda_spmv.diva_launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            runs[dev] = program.main([cfg, "--output-dir", os.path.join(
                workdir, f"mismipplus_small_{dev}"), "--device", dev])["ANT"]
        seconds[dev] = time.perf_counter() - t0
    launches = cuda_spmv.diva_launches - n0
    rc, rg = runs["cpu"], runs["cuda"]
    sc, sg = rc.state, rg.state
    gaps = {}
    for name in ("Hi", "u_vav_b", "v_vav_b"):
        a, b = getattr(sc, name), getattr(sg, name).cpu()
        gaps[name] = float((a - b).abs().max() / a.abs().max())
    scale = [float(r.md.x("glen_A_scale")) for r in (rc, rg)]
    x_GL = [program.mismipplus_x_GL(r.C, r) for r in (rc, rg)]
    out = dict(nV=rg.mesh.nV, nTri=rg.mesh.nTri, steps=[rc.n_dt_ice,
               rg.n_dt_ice], n_visc_its=[sc.n_visc_its, sg.n_visc_its],
               n_Axb_its=[sc.n_Axb_its, sg.n_Axb_its], rel_gap=gaps,
               glen_A_scale=scale,
               x_GL_km=[None if x is None else x / 1e3 for x in x_GL],
               tune_gain=[rc._mismip_tune["gain"], rg._mismip_tune["gain"]],
               diva_apply_launches_card=launches,
               seconds_cpu=seconds["cpu"], seconds_card=seconds["cuda"])
    say("small_mismipplus", **out)
    assert rg.md.device.type == "cuda" and rc.md.device.type == "cpu"
    assert launches > 0, "the card's run did not go through diva_apply"
    assert rc.n_dt_ice == rg.n_dt_ice >= 3
    assert sc.n_visc_its == sg.n_visc_its
    assert abs(sc.n_Axb_its - sg.n_Axb_its) <= 0.02 * sc.n_Axb_its
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps
    # the tuning fired, on both devices alike (tests/test_torch_program.py
    # holds the CPU's factor to the JAX package's within 1e-9)
    assert None not in x_GL and scale[0] != 1.0
    assert rc._mismip_tune["gain"] == rg._mismip_tune["gain"]
    assert abs(scale[1] - scale[0]) <= 1e-9 * scale[0], scale
    return out


def drive_full(C, mesh, tag, after_construct=None, after_warm=None):
    """Construct the region on the card (the initial solve), run the
    start-up transient and the measured window - the two phases of the JAX
    package's bench.py, shortened - with the GMRES calls counted and every
    kernel count set to 0 before and read after. `after_construct(region)`
    and `after_warm()` may install timers and read them. Returns (region,
    state, numbers)."""
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.ops import cuda_spmv

    with counted_gmres() as gm:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        region = ModelRegion(C, "ANT", mesh=mesh)  # device defaults to cuda
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_its, init_calls = gm["its"], gm["calls"]
        say(f"{tag}initial_solve", seconds=init_s, gmres_its=init_its,
            gmres_calls=init_calls,
            stack_spmv_launches=cuda_spmv.launches,
            diva_apply_launches=cuda_spmv.diva_launches,
            max_speed=float(torch.sqrt(region.state.u_vav_b ** 2
                                       + region.state.v_vav_b ** 2).max()))
        if after_construct is not None:
            after_construct(region)
        t0 = time.perf_counter()
        region.run_to(T_WARM)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm = dict(steps=region.n_dt_ice, n_visc=region.state.n_visc_its,
                    n_axb=region.state.n_Axb_its, gmres=gm["its"],
                    t=region.time)
        say(f"{tag}warm_up", t_model_yr=region.time, steps=warm["steps"],
            wall_s=warm_s, n_visc_its=warm["n_visc"],
            n_Axb_its=warm["n_axb"], dt_ice=region.state.dt_ice)
        if after_warm is not None:
            after_warm()
        t0 = time.perf_counter()
        state = region.run_to(T_WARM + WINDOW)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()

    n_tensors = check_state(state, "cuda")
    volume = float((state.Hi * region.md.A).sum())
    w_axb = state.n_Axb_its - warm["n_axb"]
    w_steps = region.n_dt_ice - warm["steps"]
    out = dict(
        nV=mesh.nV, nTri=mesh.nTri, precision=C.tpu_precision,
        initial_solve_s=init_s,
        initial_solve_ms_per_krylov_it=init_s * 1e3 / max(init_its, 1),
        initial_gmres_its=init_its,
        warm_up_s=warm_s, window_yr=region.time - warm["t"],
        window_steps=w_steps, wall_s=run_s,
        sim_yr_per_hr=(region.time - warm["t"]) / run_s * 3600.0,
        s_per_step=run_s / max(w_steps, 1),
        n_visc_its=state.n_visc_its - warm["n_visc"], n_Axb_its=w_axb,
        gmres_its=gm["its"] - warm["gmres"],
        ms_per_krylov_it=run_s * 1e3 / max(w_axb, 1),
        dt_ice=state.dt_ice, x_GL_km=find_x_GL(mesh, state.TAF) / 1e3,
        steps_total=region.n_dt_ice, n_Axb_its_total=state.n_Axb_its,
        gmres_its_total=gm["its"], gmres_calls_total=gm["calls"], **counts,
        ice_volume_m3=volume, state_tensors_checked=n_tensors,
        peak_device_MiB=torch.cuda.max_memory_allocated() / 2 ** 20)
    assert w_steps >= 1 and warm["steps"] >= 1, "no ice step was taken"
    assert volume > 0.0, "ice volume is not positive"
    assert w_axb > 0 and state.n_visc_its > warm["n_visc"]
    # GMRES applies the operator once per counted iteration and once more
    # per solve (the residual before the first cycle); every viscosity
    # iteration (one GMRES solve each) makes 16 single-operator applies
    assert counts["diva_apply_launches"] == gm["its"] + gm["calls"] \
        and gm["its"] > 0, f"the {tag}path did not go through diva_apply"
    assert counts["stack_spmv_launches"] > 16 * gm["calls"] > 0, \
        f"the {tag}path did not go through stack_spmv"
    assert region.md.device.type == "cuda"
    return region, state, out


@contextlib.contextmanager
def last_heat_call():
    """Within the block, the dict it yields holds under "args" the operands
    of the last heat_columns call of the thermodynamics step."""
    from ufemism2_tpu_torch.core.ice import thermodynamics
    last, inner = {}, thermodynamics.heat_columns

    def recorded(*a):
        last["args"] = a
        return inner(*a)
    thermodynamics.heat_columns = recorded
    try:
        yield last
    finally:
        thermodynamics.heat_columns = inner


def thermo_path(C, mesh):
    """The FULL configuration with thermodynamics on (FULL_THERMO), driven
    like the main path, each thermodynamics step timed by itself between
    two synchronisations; then the kernel on the operands of the path's
    last heat_columns call."""
    from ufemism2_tpu_torch.core.ice.thermodynamics import \
        calc_pressure_melting_point
    from ufemism2_tpu_torch.utils.constants import T0

    th = {"n": 0, "s": 0.0, "window": None}

    def time_thermo_steps(region):
        step = region._thermo_step

        def thermo_timed(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            th["s"] += time.perf_counter() - t
            th["n"] += 1
            return out
        region._thermo_step = thermo_timed

    def window_starts():
        th["window"] = (th["n"], th["s"])

    with last_heat_call() as last:
        region, state, out = drive_full(C, mesh, "thermo_",
                                        time_thermo_steps, window_starts)

    Ti = state.Ti
    pmp = calc_pressure_melting_point(region.md, state.Hi_eff)
    ice = state.Hi_eff >= C.Hi_min_thermo
    at_pmp = ice & (Ti[:, -1] >= pmp[:, -1] - 1e-3)
    w_n, w_s = th["window"]
    T0_run = float(torch.tensor(T0, dtype=Ti.dtype))
    out.update(
        thermo_steps=region.thermo_steps,
        thermo_ms_per_step=th["s"] * 1e3 / max(th["n"], 1),
        window_thermo_steps=th["n"] - w_n, window_thermo_s=th["s"] - w_s,
        window_thermo_share=(th["s"] - w_s) / out["wall_s"],
        Ti_min=float(Ti.min()), Ti_max=float(Ti.max()),
        basal_at_pmp_share=float(at_pmp.sum()) / max(int(ice.sum()), 1),
        n_unstable_total=int(region.thermo_n_unstable))
    say("thermo_path", **out)
    assert out["heat_columns_launches"] == region.thermo_steps > 0, \
        "the thermodynamics path did not go through heat_columns"
    assert bool(torch.isfinite(Ti).all()) and float(Ti.min()) >= 180.0 \
        and float(Ti.max()) <= T0_run, (float(Ti.min()), float(Ti.max()))
    init_its, w_axb = out["initial_gmres_its"], out["n_Axb_its"]
    assert (init_its, w_axb) == (TH_INIT_GMRES_ITS, TH_WINDOW_AXB_ITS) \
        and abs(out["x_GL_km"] - TH_X_GL_KM) < 0.01, \
        (f"the f32 thermodynamics trajectory moved: {init_its} initial "
         f"GMRES iterations, {w_axb} Krylov iterations in the window, "
         f"x_GL {out['x_GL_km']:.3f} km (expected {TH_INIT_GMRES_ITS}, "
         f"{TH_WINDOW_AXB_ITS}, {TH_X_GL_KM}): the rounding of the "
         "operators or of the heat solve changed")
    # the kernel on the path's own operands: those of its last call
    return out, heat_case("heat_columns_thermo_path_last_step", last["args"])


def halfar_phase():
    """The Halfar dome (SIA, thermodynamics on) in f64 on the card to
    HALFAR_T_END model years, against the analytical solution."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.analytical import halfar_H
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.ops import cuda_heat
    C = Config(**HALFAR)
    with last_heat_call() as last:
        cuda_heat.launches = 0
        t0 = time.perf_counter()
        region = ModelRegion(C, "ANT")
        state = region.run_to(HALFAR_T_END)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    V = region.mesh.V
    H_exact = halfar_H(C.uniform_Glens_flow_factor,
                       C.Glens_flow_law_exponent,
                       C.refgeo_idealised_Halfar_H0,
                       C.refgeo_idealised_Halfar_R0, V[:, 0], V[:, 1],
                       HALFAR_T_END)
    Hi = state.Hi.double().cpu().numpy()
    rmse = float(np.sqrt(((Hi - H_exact) ** 2).mean()))
    out = dict(nV=region.mesh.nV, nTri=region.mesh.nTri,
               precision=C.tpu_precision, t_model_yr=region.time,
               steps=region.n_dt_ice, wall_s=wall_s, rmse_m=rmse,
               rmse_limit_m=HALFAR_RMSE_M, H_max_m=float(Hi.max()),
               H_exact_max_m=float(H_exact.max()),
               thermo_steps=region.thermo_steps,
               heat_columns_launches=cuda_heat.launches)
    say("halfar", **out)
    check_state(state, "cuda")
    assert region.n_dt_ice > 10 and rmse < HALFAR_RMSE_M, rmse
    assert cuda_heat.launches == region.thermo_steps > 0
    # the kernel on the operands of the phase's last heat_columns call
    return out, heat_case("heat_columns_halfar_last_step", last["args"])


def write_namelist(path, values):
    """`values` as a reference-style `&CONFIG ... /` namelist file."""
    def lit(v):
        if isinstance(v, bool):
            return ".TRUE." if v else ".FALSE."
        return f"'{v}'" if isinstance(v, str) else repr(v)
    lines = [f"  {k}_config = {lit(v)}" for k, v in values.items()]
    with open(path, "w") as f:
        f.write("\n".join(["&CONFIG", *lines, "/"]) + "\n")
    return path


def mismipplus_phase(workdir):
    """The MISMIP+ stand-in through the program's entry point on the card
    (python -m ufemism2_tpu_torch <cfg> --output-dir DIR), with every
    kernel count set to 0 before and read after; the GMRES calls counted
    and the last one's operator and operands kept. Wall times come from
    the program's own resource_tracking.jsonl."""
    from ufemism2_tpu_torch.main import program
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.utils.logging_utils import get_tracker
    cfg = write_namelist(os.path.join(workdir, "mismipplus_standin.cfg"),
                         MISMIPPLUS)
    out_dir = os.path.join(workdir, "mismipplus_out")
    run_to_inner = ModelRegion.run_to
    get_tracker().reset()         # earlier phases' routines
    with counted_gmres() as gm:
        gm.update(first_calls=None, first_its=None)

        def run_to_marked(self, *a, **kw):
            # the GMRES work before the first run_to is the initial solve
            if gm["first_its"] is None:
                gm["first_its"], gm["first_calls"] = gm["its"], gm["calls"]
            return run_to_inner(self, *a, **kw)
        ModelRegion.run_to = run_to_marked
        try:
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                regions = program.main([cfg, "--output-dir", out_dir])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = read_counts()
        finally:
            ModelRegion.run_to = run_to_inner
        last = {k: gm[k] for k in ("A", "b", "x0", "x", "kw")}
    region = regions["ANT"]
    state = region.state
    with open(os.path.join(out_dir, "resource_tracking.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    run_s = sum(r["routines"].get("run_model_region", {}).get("tcomp", 0.0)
                for r in recs)
    init_s = recs[0]["routines"]["initialise_model_region"]["tcomp"]
    n_axb, n_visc = state.n_Axb_its, state.n_visc_its
    A = last["A"]
    front_rows = int(A.front[0].sum()) if A.front is not None else 0
    x_GL = program.mismipplus_x_GL(region.C, region)
    volume = float((state.Hi.double() * region.md.A.double()).sum())
    years = region.time - MISMIPPLUS["start_time_of_run"]
    out = dict(
        nV=region.mesh.nV, nTri=region.mesh.nTri,
        precision=region.C.tpu_precision, t_model_yr=region.time,
        steps=region.n_dt_ice, wall_s=wall_s, initialise_s=init_s,
        run_s=run_s, sim_yr_per_hr=years / run_s * 3600.0,
        ms_per_krylov_it=run_s * 1e3 / max(n_axb, 1),
        n_visc_its=n_visc, n_Axb_its=n_axb, dt_ice=state.dt_ice,
        gmres_calls=gm["calls"], gmres_its=gm["its"],
        initial_gmres_its=gm["first_its"],
        initial_gmres_calls=gm["first_calls"],
        x_GL_km=None if x_GL is None else x_GL / 1e3,
        ice_volume_m3=volume, front_rows=front_rows,
        off_rows=int(A.front[1].sum()) if A.front is not None else 0,
        glen_A_scale=float(region.md.x("glen_A_scale")),
        scalars=region.scalars_history[-1], coupling_records=len(recs),
        **counts)
    say("mismipplus", **out)
    check_state(state, "cuda")
    assert region.md.device.type == "cuda" and front_rows > 0
    assert region.n_dt_ice >= 3 and volume > 0.0 and n_axb > 0
    assert counts["diva_apply_launches"] == gm["its"] + gm["calls"] > 0, \
        "the MISMIP+ path did not go through diva_apply"
    assert counts["stack_spmv_launches"] > 16 * gm["calls"], \
        "the MISMIP+ path did not go through stack_spmv"
    assert counts["heat_columns_launches"] == 0
    for name in (cfg, os.path.join(out_dir, "run_manifest.json")):
        assert os.path.exists(name), name
    assert len(recs) == 4
    pins = (MP_INIT_GMRES_ITS, MP_AXB_ITS, MP_ICE_VOLUME_M3)
    assert (out["initial_gmres_its"], n_axb) == pins[:2] \
        and abs(volume - pins[2]) <= 1e-6 * pins[2], \
        (f"the f32 MISMIP+ trajectory moved: {out['initial_gmres_its']} "
         f"initial GMRES iterations, {n_axb} Krylov iterations, ice "
         f"volume {volume:.6e} m^3 (expected {pins}): the rounding of "
         "the operator changed")
    return region, last, out


def precond_solves(region, last):
    """One stress-balance linear solve on the MISMIP+ phase's last system
    with each preconditioner, in f64 on the card (the operator's kernel in
    f64, its tables, fields, front and rhs cast from the run's f32), built
    as the program builds it (ssadiva.make_preconditioner), by GMRES at the
    program's restart (tpu_stress_balance_krylov_restart) and at
    MP_PRECOND_RESTART. At the program's restart exactly the
    preconditioners in MP_CONVERGE_AT_RESTART must converge; at
    MP_PRECOND_RESTART each of MP_PRECONDS. A converged solve must be
    finite, below GMRES's iteration cap, with the true residual,
    recomputed with the plain operator in f64, within the stopping rule
    (||M (b - A x)|| <= max(rtol ||M b||, abstol))."""
    from ufemism2_tpu_torch.core.ice import ssadiva
    from ufemism2_tpu_torch.ops import cuda_spmv, krylov
    C, md = region.C, region.md
    A32 = last["A"]
    d = torch.float64
    stack = cuda_spmv.StackOperator(A32.stack.cols, A32.stack.vals.to(d))
    fields = tuple(f.to(d) for f in A32.fields)
    front = (A32.front[0], A32.front[1], A32.front[2].to(d),
             A32.front[3].to(d))
    A = cuda_spmv.DivaOperator(stack, A32.rows, *fields, front=front)
    b = tuple(t.to(d) for t in last["b"])
    x0 = tuple(t.to(d) for t in last["x0"])
    ssadiva.register_bjdense_static(md._host_mesh, md)
    ssadiva.register_two_level_static(md._host_mesh, md)
    rtol, abstol = C.stress_balance_PETSc_rtol, C.stress_balance_PETSc_abstol
    degree = C.tpu_stress_balance_precond_degree
    program_restart = int(C.tpu_stress_balance_krylov_restart)
    out = []
    for restart in (program_restart, MP_PRECOND_RESTART):
        for kind in ("block_jacobi",) + MP_PRECONDS:
            torch.cuda.synchronize()
            n0 = cuda_spmv.diva_launches
            t0 = time.perf_counter()
            Mp = ssadiva.make_preconditioner(kind, md, A, fields, front,
                                             degree, b)
            res = krylov.gmres(A, b, x0=x0, M=Mp, rtol=rtol, abstol=abstol,
                               restart=restart)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = cuda_spmv.diva_launches - n0
            xu, xv = res.x
            r = tuple(bi - ai for bi, ai in zip(
                b, cuda_spmv.diva_apply_plain(
                    (stack.cols, stack.vals), A.rows, *fields, xu, xv,
                    front=front)))
            mnorm = lambda t: float(torch.sqrt(sum((c ** 2).sum()
                                                   for c in Mp(t))))
            norm = lambda t: float(torch.sqrt(sum((c ** 2).sum()
                                                  for c in t)))
            res_M, b_M = mnorm(r), mnorm(b)
            row = dict(preconditioner=kind, degree=degree
                       if kind in ("chebyshev", "neumann") else None,
                       restart=restart, program_restart=program_restart,
                       gmres_its=res.n_iter, converged=res.converged,
                       wall_s=wall_s,
                       ms_per_it=wall_s * 1e3 / max(res.n_iter, 1),
                       diva_apply_launches=launches,
                       true_rel_residual_M=res_M / b_M,
                       true_rel_residual=norm(r) / norm(b),
                       stopping_tol_M=max(rtol * b_M, abstol) / b_M,
                       finite=bool(torch.isfinite(xu).all()
                                   and torch.isfinite(xv).all()))
            say("precond_solve", **row)
            out.append(row)
            assert launches >= res.n_iter, row
            if res.converged:
                assert row["finite"] \
                    and res.n_iter < krylov.MAXIT_DEFAULT, row
                assert res_M <= 1.01 * max(rtol * b_M, abstol), row
    converged = lambda rs: tuple(r["preconditioner"] for r in out
                                 if r["restart"] == rs and r["converged"])
    assert converged(program_restart) == MP_CONVERGE_AT_RESTART, \
        (f"at the program's restart of {program_restart} "
         f"{converged(program_restart)} converged, expected "
         f"{MP_CONVERGE_AT_RESTART}")
    assert set(MP_PRECONDS) <= set(converged(MP_PRECOND_RESTART)), out
    return out


@contextlib.contextmanager
def counted_gmres(module=None):
    """Within the block, the dict it yields counts the stress-balance
    GMRES calls ("calls") and iterations ("its") of `module` (ssadiva by
    default; bpa, hybrid), the calls that stopped above their tolerance
    ("unconverged": at the iteration cap or by stagnation), and holds the
    last call's operator, preconditioner, operands and options ("A", "M",
    "b", "x0", "x", "kw")."""
    if module is None:
        from ufemism2_tpu_torch.core.ice import ssadiva as module
    gm = {"calls": 0, "its": 0, "unconverged": 0}
    inner = module.gmres

    def counted(A, b, x0=None, M=None, **kw):
        res = inner(A, b, x0=x0, M=M, **kw)
        gm["calls"] += 1
        gm["its"] += res.n_iter
        gm["unconverged"] += not res.converged
        gm.update(A=A, M=M, b=b, x0=x0, x=res.x, kw=kw)
        return res
    module.gmres = counted
    try:
        yield gm
    finally:
        module.gmres = inner


def zero_counts():
    from ufemism2_tpu_torch.ops import (cuda_bpa, cuda_heat, cuda_laddie,
                                        cuda_spmv)
    cuda_laddie.launches = 0
    cuda_laddie.kernel_launches = 0
    cuda_spmv.launches = 0
    cuda_spmv.diva_launches = 0
    cuda_heat.launches = 0
    cuda_bpa.launches = 0
    cuda_bpa.thomas_launches = 0


def read_counts():
    from ufemism2_tpu_torch.ops import (cuda_bpa, cuda_heat, cuda_laddie,
                                        cuda_spmv)
    return dict(laddie_stage_launches=cuda_laddie.launches,
                laddie_kernel_launches=cuda_laddie.kernel_launches,
                stack_spmv_launches=cuda_spmv.launches,
                diva_apply_launches=cuda_spmv.diva_launches,
                heat_columns_launches=cuda_heat.launches,
                bpa_apply_launches=cuda_bpa.launches,
                line_thomas_launches=cuda_bpa.thomas_launches)


def ell_widths(md):
    """ELL width K of every operator of a MeshData."""
    from ufemism2_tpu_torch.ops.sparse import EllStack
    return {k: v.K for k, v in vars(md).items() if isinstance(v, EllStack)}


def time_first_step_after_remesh(region, rec):
    """Make the region's next update_mesh time the first ice step on the
    new mesh (its cold solves) into rec["first_step_s"]."""
    update = region.update_mesh

    def update_then_time():
        update()
        step = region.pc_step

        def first_step(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            rec.append(time.perf_counter() - t)
            region.pc_step = step
            return out
        region.pc_step = first_step
    region.update_mesh = update_then_time


def step_n(region, n):
    """At least n more ice steps, one run_to per prediction window."""
    n0 = region.n_dt_ice
    while region.n_dt_ice < n0 + n:
        region.run_to(region.state.t_Hi_next + 1e-6)


def remesh_phase(mesh):
    """FULL_REMESH at full width on the card in f32: the initial solve,
    the start-up transient and the 20 -> 60 yr window, across the first
    mesh-fitness check at 50 yr. If the check does not update the mesh,
    update_mesh() is called at the window's end; either way at least
    RM_STEPS_AFTER ice steps run on the new mesh. Then diva_apply on the
    last operator apply of the remeshed mesh and stack_spmv on its
    five-operator stack, against their plain versions, with their ELL
    widths."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    C = Config(**FULL_REMESH)
    first = []
    with counted_gmres() as gm:
        zero_counts()
        t0 = time.perf_counter()
        region = ModelRegion(C, "ANT", mesh=mesh)
        time_first_step_after_remesh(region, first)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_its = gm["its"]
        region.run_to(T_WARM)
        torch.cuda.synchronize()
        n_warm, axb_warm = region.n_dt_ice, region.state.n_Axb_its
        t_warm = region.time
        t0 = time.perf_counter()
        region.run_to(T_WARM + WINDOW)
        forced = region.n_mesh_updates == 0
        if forced:
            time_first_step_after_remesh(region, first)
            region.update_mesh()
        n_at_remesh = region.n_dt_ice if forced else None
        step_n(region, RM_STEPS_AFTER if forced else 0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        last = {"A": gm["A"], "x": gm["x"]}
    state = region.state
    check_state(state, "cuda")
    w_axb = state.n_Axb_its - axb_warm
    years = region.time - t_warm
    timing = dict(region.remesh_timings[0], first_step_s=first[0])
    out = dict(
        nV_before=mesh.nV, nTri_before=mesh.nTri,
        nV_after=region.mesh.nV, nTri_after=region.mesh.nTri,
        n_mesh_updates=region.n_mesh_updates, forced=forced,
        remesh_s=timing, remesh_total_s=sum(timing.values()),
        initial_solve_s=init_s, initial_gmres_its=init_its,
        window_yr=years, window_steps=region.n_dt_ice - n_warm,
        wall_s=run_s, sim_yr_per_hr=years / run_s * 3600.0,
        n_Axb_its=w_axb, ms_per_krylov_it=run_s * 1e3 / max(w_axb, 1),
        x_GL_km=find_x_GL(region.mesh, state.TAF) / 1e3,
        ice_volume_m3=float((state.Hi.double()
                             * region.md.A.double()).sum()),
        ell_widths=ell_widths(region.md), diva_K=last["A"].stack.K,
        gmres_its=gm["its"], gmres_calls=gm["calls"], **counts)
    say("remesh", **out)
    assert region.n_mesh_updates >= 1 and region.md.device.type == "cuda"
    assert not forced or region.n_dt_ice >= n_at_remesh + RM_STEPS_AFTER
    assert region.md.nV == region.mesh.nV != mesh.nV
    assert counts["diva_apply_launches"] == gm["its"] + gm["calls"] > 0, \
        "the remesh path did not go through diva_apply"
    assert counts["stack_spmv_launches"] > 16 * gm["calls"], \
        "the remesh path did not go through stack_spmv"
    # the kernels on the remeshed mesh: the last operator apply, and the
    # five-operator stack at the main path's precision
    ops = region.mesh.operators
    m2 = [ops.M2_ddx_b_b, ops.M2_ddy_b_b, ops.M2_d2dx2_b_b,
          ops.M2_d2dxdy_b_b, ops.M2_d2dy2_b_b]
    diva = diva_check("diva_apply_remesh_last_apply", last["A"],
                      torch.cat(last["x"]), [m.tocsr() for m in m2])
    rng = np.random.default_rng(6)
    stack = kernel_case(
        "M2_stack_5ops_d2_remeshed_float32_bf16x", m2,
        rng.standard_normal((region.mesh.nTri, 2)) * 300.0, torch.float32,
        True)
    assert ((region.mesh.nV, region.mesh.nTri), w_axb) \
        == (RM_MESH, RM_WINDOW_AXB_ITS) \
        and abs(out["x_GL_km"] - RM_X_GL_KM) < 0.01, \
        (f"the f32 remesh trajectory moved: mesh "
         f"{(region.mesh.nV, region.mesh.nTri)}, {w_axb} Krylov "
         f"iterations in the window, x_GL {out['x_GL_km']:.3f} km "
         f"(expected {RM_MESH}, {RM_WINDOW_AXB_ITS}, {RM_X_GL_KM})")
    return out, diva, stack


def small_remesh_run(mesh_s, dev, out_dir):
    """SMALL_REMESH in f64 on `dev` with outputs: four ice steps, one
    forced update_mesh(), the steps after it; the numbers small_remesh
    compares (the fields on the host)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    t0 = time.perf_counter()
    r = ModelRegion(Config(**SMALL_REMESH), "ANT", mesh=mesh_s, device=dev,
                    output_dir=out_dir)
    for t in (0.15, 0.35):
        r.run_to(t)
    r.update_mesh()
    n_at, axb_at = r.n_dt_ice, r.state.n_Axb_its
    visc_at = r.state.n_visc_its
    for t in (0.45, 0.55, 0.7):
        r.run_to(t)
    r.write_output()
    s = r.state
    return dict(nV=r.mesh.nV, nTri=r.mesh.nTri, V=np.asarray(r.mesh.V),
                steps_after=r.n_dt_ice - n_at,
                n_visc_its_after=s.n_visc_its - visc_at,
                n_Axb_its_after=s.n_Axb_its - axb_at,
                remesh_s=r.remesh_timings[0],
                gens=sorted(p for p in os.listdir(out_dir)
                            if p.startswith("main_output_ANT_0")),
                seconds=time.perf_counter() - t0,
                **{k: getattr(s, k).double().cpu() for k in RESUME_FIELDS})


def cpu_small_remesh(workdir, snapshot_path):
    """small_remesh_run on the CPU (plain versions) on SMALL's mesh, built
    here as main() builds it, saved to snapshot_path; run in a process of
    its own on one thread (as cpu_resume_snapshot)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    torch.set_num_threads(1)
    mesh_s = build_mesh_from_config(Config(**SMALL), "ANT")
    with contextlib.redirect_stdout(sys.stderr):
        snap = small_remesh_run(mesh_s, "cpu", workdir)
    torch.save(snap, snapshot_path)


def start_small_remesh_cpu(workdir):
    """The CPU's run that small_remesh_phase holds the card to, started in
    a process of its own: (process, the path of its result)."""
    cpu_out = os.path.join(workdir, "small_remesh_cpu.pt")
    return start_cpu_job("cpu_small_remesh",
                         os.path.join(workdir, "remesh_cpu"),
                         cpu_out), cpu_out


def small_remesh_phase(workdir, mesh_s, cpu_job):
    """SMALL_REMESH in f64 with one forced update_mesh() after four ice
    steps, on the card (kernels) and on the CPU (plain versions; cpu_job,
    from start_small_remesh_cpu), with outputs: both devices build the
    same new mesh (equal nV and nTri, vertices within 1e-6 m) and then take
    the same steps, viscosity and Krylov iterations, with fields within
    small_phase's gaps; the mesh output reaches generation 00002."""
    cpu, cpu_out = cpu_job
    try:
        zero_counts()
        card = small_remesh_run(mesh_s, "cuda",
                                os.path.join(workdir, "remesh_cuda"))
        counts = read_counts()
        host, cpu_wait_s = finish_cpu_job(cpu, cpu_out, "small_remesh")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    runs = {"cpu": host, "cuda": card}
    gaps = {}
    for name in RESUME_FIELDS:
        a, b = host[name], card[name]
        gaps[name] = float((a - b).abs().max() / a.abs().max())
    same_mesh = (host["nV"], host["nTri"]) == (card["nV"], card["nTri"])
    v_gap = float(np.abs(host["V"] - card["V"]).max()) if same_mesh \
        else None
    keys = ("nV", "nTri", "steps_after", "n_visc_its_after",
            "n_Axb_its_after")
    out = dict(nV_before=mesh_s.nV,
               **{(k + "_after" if k in ("nV", "nTri") else k):
                  [host[k], card[k]] for k in keys},
               V_gap_m=v_gap, rel_gap=gaps, mesh_output_files=card["gens"],
               remesh_s=card["remesh_s"], seconds_cpu=host["seconds"],
               seconds_card=card["seconds"], cpu_wait_s=cpu_wait_s,
               **counts)
    say("small_remesh", **out)
    assert same_mesh and v_gap <= 1e-6, out
    assert host["steps_after"] == card["steps_after"] >= 3
    assert host["n_visc_its_after"] == card["n_visc_its_after"]
    assert host["n_Axb_its_after"] == card["n_Axb_its_after"]
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps
    for dev, run in runs.items():
        assert run["gens"] == ["main_output_ANT_00001.nc",
                               "main_output_ANT_00002.nc"], (dev, run)
    assert counts["diva_apply_launches"] > 0 \
        and counts["stack_spmv_launches"] > 0
    return out


def resume_region(C, path, device, out_dir):
    """A region on the mesh of the restart at `path`, resumed from it with
    the spin-up's flow-factor scale (the gate's resume of the JAX package,
    ufemism2_tpu/validation/integrated_tests.py:389-420)."""
    from ufemism2_tpu_torch.io.output_files import mesh_from_restart
    from ufemism2_tpu_torch.main.region import ModelRegion
    r = ModelRegion(C, "ANT", mesh=mesh_from_restart(path, C), device=device,
                    output_dir=out_dir)
    e = r.md.extras["glen_A_scale"]
    e.arr = torch.tensor(MP_GLEN_A_SCALE, dtype=e.arr.dtype,
                         device=e.arr.device)
    r.resume_from_restart(path)
    return r


def read_outputs(out_dir, n_events):
    """Every NetCDF file of a run read back through the port's ncio (no
    h5py): finite Hi, one time entry per output event."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    names = sorted(n for n in os.listdir(out_dir) if n.endswith(".nc"))
    frames = 0
    for n in names:
        nc = NCFile(os.path.join(out_dir, n))
        if n.startswith("main_output_ANT_0"):
            assert np.isfinite(nc.read("Hi")).all(), n
            frames += nc.dims()["time"]
        if n.startswith("scalar_output"):
            assert nc.dims()["time"] == n_events, (n, nc.dims())
    assert frames == n_events, (names, frames, n_events)
    return names


RESUME_FIELDS = ("Hi", "u_vav_b", "v_vav_b")


def resume_snapshot(r):
    """Steps, counts and fields (f64, on the host) of a resumed region."""
    return dict(steps=r.n_dt_ice, n_visc_its=r.state.n_visc_its,
                n_Axb_its=r.state.n_Axb_its,
                **{k: getattr(r.state, k).double().cpu()
                   for k in RESUME_FIELDS})


def cpu_resume_snapshot(out_dir, t_cmp, snapshot_path,
                        cfg="MP_RESUME_RUN"):
    """The f64 resume of MP_RESTART under the configuration named `cfg`
    (MP_RESUME_RUN, or MP_ICE1R or MP_FAVIER with the retreat leg's
    start-up) on the CPU (plain versions) to t_cmp, its snapshot and the
    first BMB field saved to snapshot_path; run in a process of its own
    (the card's runs go on beside it), on one thread: the 632-vertex
    mesh's tensors are below torch's grain for a parallel loop, so more
    threads would only take cores from the card's host thread."""
    from ufemism2_tpu_torch.config import Config
    torch.set_num_threads(1)
    C = Config(**dict(globals()[cfg], tpu_precision="f64"))
    t0 = time.perf_counter()
    r = resume_region(C, MP_RESTART, "cpu", out_dir)
    bmb0 = r.BMB.clone()
    if cfg != "MP_RESUME_RUN":
        ice1r_start(r)
    n0, axb0 = r.n_dt_ice, r.state.n_Axb_its
    with contextlib.redirect_stdout(sys.stderr):
        r.run_to(float(t_cmp))
    snap = resume_snapshot(r)
    snap["BMB_first"] = bmb0
    snap["run"] = dict(seconds=time.perf_counter() - t0,
                       steps=r.n_dt_ice - n0,
                       n_Axb_its=r.state.n_Axb_its - axb0,
                       outputs=read_outputs(out_dir, len(r.scalars_history)))
    torch.save(snap, snapshot_path)


def start_resume_cpu(workdir):
    """The CPU's f64 run that mismipplus_resume_phase holds the card to,
    started in a process of its own: (process, the path of its result)."""
    t_cmp = MP_RESUME_RUN["start_time_of_run"] + MP_CMP_YR
    cpu_out = os.path.join(workdir, "resume_f64_cpu.pt")
    return start_cpu_job("cpu_resume_snapshot",
                         os.path.join(workdir, "resume_f64_cpu"),
                         repr(t_cmp), cpu_out), cpu_out


def mismipplus_resume_phase(workdir, cpu_job):
    """The JAX package's MISMIP+ 5 km spin-up state resumed on the card
    (MP_RESUME_RUN: half a model year through run_to, outputs, restarts
    and remeshing on), in f32 and in f64. The f64 run is held to the same
    run on the CPU over its first MP_CMP_YR model years (equal steps and
    counts, fields within small_phase's gaps), and to a fresh region
    resumed from the port's own restart written halfway (equal steps and
    counts, fields within 1e-12 at the end). Beside it a third f64 run
    whose thickness starts 1e-15 (relative) away measures how far one
    rounding carries by the end on this state. Every output file
    is read back through the port's ncio, without h5py."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.io.ncio import NCFile
    from ufemism2_tpu_torch.main import program
    t_start, t_end = MP_RESUME_RUN["start_time_of_run"], \
        MP_RESUME_RUN["end_time_of_run"]
    t_cmp, t_mid = t_start + MP_CMP_YR, 0.5 * (t_start + t_end)

    def gaps(a, b):
        return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max())
                for k in RESUME_FIELDS}

    res, snaps = {}, {}
    # the CPU's run goes in a process of its own (start_resume_cpu),
    # beside the card's runs
    cpu, cpu_out = cpu_job
    try:
        zero_counts()
        for tag, prec in (("f32", "f32"), ("f64", "f64"),
                          ("f64_perturbed", "f64")):
            C = Config(**dict(MP_RESUME_RUN, tpu_precision=prec))
            out_dir = os.path.join(workdir, f"resume_{tag}")
            r = resume_region(C, MP_RESTART, "cuda", out_dir)
            if tag == "f64_perturbed":
                s = r.state
                r.state = s.replace(Hi_prev=s.Hi_prev * (1.0 + 1e-15),
                                    Hi_next=s.Hi_next * (1.0 + 1e-15))
            n0, axb0 = r.n_dt_ice, r.state.n_Axb_its
            visc0 = r.state.n_visc_its
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                if tag == "f32":
                    r.run_to(t_end)
                else:
                    r.run_to(t_cmp)
                    snaps[tag] = resume_snapshot(r)
                    r.run_to(t_mid)
                    if tag == "f64":
                        shutil.copy(
                            os.path.join(out_dir, "restart_ANT_00001.nc"),
                            os.path.join(workdir, "restart_mid.nc"))
                    r.run_to(t_end)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            s = r.state
            axb = s.n_Axb_its - axb0
            x_GL = program.mismipplus_x_GL(C, r)
            res[tag] = dict(
                region=r, t_end=r.time, steps=r.n_dt_ice - n0,
                n_visc_its=s.n_visc_its - visc0, n_Axb_its=axb, wall_s=run_s,
                sim_yr_per_hr=(r.time - t_start) / run_s * 3600.0,
                ms_per_krylov_it=run_s * 1e3 / max(axb, 1),
                x_GL_km=None if x_GL is None else x_GL / 1e3,
                ice_volume_m3=float((s.Hi.double() * r.md.A.double()).sum()),
                n_mesh_updates=r.n_mesh_updates, nV=r.mesh.nV,
                outputs=read_outputs(out_dir, len(r.scalars_history)))
        # a fresh region resumed from the f64 card run's halfway restart
        C = Config(**dict(MP_RESUME_RUN, tpu_precision="f64"))
        rr = resume_region(C, os.path.join(workdir, "restart_mid.nc"), "cuda",
                           os.path.join(workdir, "resume_from_mid"))
        n0 = rr.n_dt_ice
        assert abs(rr.time - t_mid) < 1e-9
        with contextlib.redirect_stdout(sys.stderr):
            rr.run_to(t_end)
        counts = read_counts()
        t0 = time.perf_counter()
        assert cpu.wait(timeout=900) == 0, "the CPU's resume run failed"
        cpu_wait_s = time.perf_counter() - t0
    finally:
        if cpu.poll() is None:          # the card's runs failed first
            cpu.kill()
            cpu.wait()
    snaps["f64_cpu"] = torch.load(cpu_out)
    cpu_run = snaps["f64_cpu"].pop("run")
    ru = res["f64"]["region"]
    mid_restart = NCFile(os.path.join(workdir, "restart_mid.nc"))
    assert abs(float(mid_restart.read("time")[0]) - t_mid) < 1e-9
    gaps_cpu = gaps(snaps["f64_cpu"], snaps["f64"])
    gaps_resumed = gaps(resume_snapshot(rr), resume_snapshot(ru))
    gaps_perturbed = gaps(resume_snapshot(res["f64_perturbed"]["region"]),
                          resume_snapshot(ru))
    printed = {tag: {k: v for k, v in d.items() if k != "region"}
               for tag, d in res.items()}
    out = dict(restart=os.path.relpath(MP_RESTART), nV=res["f32"]["nV"],
               runs=printed,
               card_cpu_f64=dict(t=t_cmp, **{
                   k: [snaps[t][k] for t in ("f64_cpu", "f64")]
                   for k in ("steps", "n_visc_its", "n_Axb_its")},
                   rel_gap=gaps_cpu, cpu_run=cpu_run,
                   cpu_wait_s=cpu_wait_s),
               perturbed_1e15_rel_gap_at_end=gaps_perturbed,
               resumed_from_mid=dict(
                   steps=rr.n_dt_ice - n0, n_dt_ice=[rr.n_dt_ice,
                                                     ru.n_dt_ice],
                   n_Axb_its=[rr.state.n_Axb_its, ru.state.n_Axb_its],
                   rel_gap=gaps_resumed),
               h5py_available=importlib.util.find_spec("h5py") is not None,
               **counts)
    say("mismipplus_resume", **out)
    for d in res.values():
        check_state(d["region"].state, "cuda")
        assert d["steps"] >= 2 and d["ice_volume_m3"] > 0.0
    assert res["f32"]["region"].state.Hi.dtype == torch.float32
    assert abs(res["f64"]["t_end"] - t_end) < 1e-9 \
        and abs(res["f32"]["t_end"] - t_end) < 1e-9
    a, b = snaps["f64_cpu"], snaps["f64"]
    assert [a[k] for k in ("steps", "n_visc_its", "n_Axb_its")] \
        == [b[k] for k in ("steps", "n_visc_its", "n_Axb_its")], out
    assert gaps_cpu["Hi"] < 1e-6 and gaps_cpu["u_vav_b"] < 1e-5 \
        and gaps_cpu["v_vav_b"] < 1e-5, gaps_cpu
    assert rr.n_dt_ice == ru.n_dt_ice and rr.n_dt_ice > n0
    assert rr.state.n_visc_its == ru.state.n_visc_its
    assert rr.state.n_Axb_its == ru.state.n_Axb_its
    assert max(gaps_resumed.values()) <= 1e-12, gaps_resumed
    assert counts["diva_apply_launches"] > 0 \
        and counts["stack_spmv_launches"] > 0
    return out


def start_cpu_job(fn, *args):
    """chip_smoke.<fn>(*args) in a process of its own (the CPU runs that
    the card's runs are held to go on beside them); its output goes to
    standard error."""
    return subprocess.Popen(
        [sys.executable, "-c", "import importlib.util, sys; "
         "spec = importlib.util.spec_from_file_location('chip_smoke', "
         "sys.argv[1]); m = importlib.util.module_from_spec(spec); "
         "spec.loader.exec_module(m); getattr(m, sys.argv[2])(*sys.argv[3:])",
         os.path.abspath(__file__), fn, *args],
        stdout=sys.stderr, stderr=sys.stderr)


def finish_cpu_job(proc, path, what, timeout=900):
    """Wait for a start_cpu_job process; its saved result and the wait."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, f"the CPU's {what} run failed"
    # a file this script's own child process wrote (numpy arrays in it)
    return torch.load(path, weights_only=False), time.perf_counter() - t0


def ice1r_start(r):
    """The start of the retreat leg after a resume, as the JAX package's
    harness makes it (integrated_tests.py:582-597): the prediction window
    collapsed onto the resumed thickness, so that the first step resolves
    the new melt at once, and the leg's own stability counters."""
    s = r.state
    r.state = s.replace(Hi_prev=s.Hi, Hi_next=s.Hi, t_Hi_prev=r.time,
                        t_Hi_next=r.time, n_visc_its=0, n_Axb_its=0)


def x_GL_westeast(r):
    """The grounding line [m] on the westeast transect at 1 km, as the
    harness measures every leg of MISMIP+ (integrated_tests.py:423-427)."""
    from ufemism2_tpu_torch.models.transects import Transect
    tr = Transect.named(r.mesh, "westeast", dx=1e3)
    taf = tr.sample_vertices(r.state.TAF.double().cpu().numpy())
    return tr.zero_crossing_distance(taf) + r.mesh.xmin


def melt_m3_per_yr(r):
    """The BMB integrated over the mesh [m^3 ice / yr], negative for melt."""
    return float((r.BMB.double() * r.md.A.double()).sum())


def start_retreat_cpu(phase, cfg_name, workdir):
    """The CPU's f64 run that retreat_phase holds the card to, started in
    a process of its own: (process, the path of its result)."""
    t_cmp = globals()[cfg_name]["start_time_of_run"] + MP_CMP_YR
    cpu_out = os.path.join(workdir, f"{phase}_f64_cpu.pt")
    return start_cpu_job("cpu_resume_snapshot",
                         os.path.join(workdir, f"{phase}_f64_cpu"),
                         repr(t_cmp), cpu_out, cfg_name), cpu_out


def retreat_phase(phase, cfg_name, years, workdir, cpu_job):
    """MP_RESTART resumed under `cfg_name` (MP_ICE1R or MP_FAVIER) on the
    card: the retreat leg's start-up, then `years` model years in f32, one
    run_to a year (the last at `years`), the grounding line read on the
    westeast transect at each, the kernels' launches counted around it;
    the same start in f64
    to MP_CMP_YR, held to the CPU's run (cpu_job, from start_retreat_cpu)
    in counts, in fields within small_phase's gaps and in the first BMB
    field within 1e-12. Every output file (the transect file among them,
    where the configuration asks for it) is read back through the port's
    ncio, without h5py."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.io.ncio import NCFile
    cfg = globals()[cfg_name]
    t_start = cfg["start_time_of_run"]
    t_cmp = t_start + MP_CMP_YR
    cpu, cpu_out = cpu_job
    try:
        C = Config(**dict(cfg, tpu_precision="f32"))
        out_dir = os.path.join(workdir, f"{phase}_f32")
        r = resume_region(C, MP_RESTART, "cuda", out_dir)
        ice1r_start(r)
        n0 = r.n_dt_ice
        x_GL, melt = [x_GL_westeast(r)], [melt_m3_per_yr(r)]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            for y in range(1, int(np.ceil(years)) + 1):
                r.run_to(t_start + min(y, years))
                x_GL.append(x_GL_westeast(r))
                melt.append(melt_m3_per_yr(r))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        s = r.state
        f32 = dict(
            steps=r.n_dt_ice - n0, n_visc_its=s.n_visc_its,
            n_Axb_its=s.n_Axb_its, wall_s=run_s,
            sim_yr_per_hr=years / run_s * 3600.0,
            ms_per_krylov_it=run_s * 1e3 / max(s.n_Axb_its, 1),
            x_GL_km=[x / 1e3 for x in x_GL], melt_m3_per_yr=melt,
            ice_volume_m3=float((s.Hi.double() * r.md.A.double()).sum()),
            n_mesh_updates=r.n_mesh_updates, nV=r.mesh.nV,
            outputs=read_outputs(out_dir, len(r.scalars_history)), **counts)
        check_state(s, "cuda")
        if C.transects_ANT:
            tf = NCFile(os.path.join(out_dir, "transect_westeast.nc"))
            gl = tf.read("grounding_line_distance_from_start")
            f32["transect_file"] = dict(
                frames=tf.dims()["time"], n=tf.dims()["n"],
                x_GL_km=[float(v) / 1e3 for v in gl])
            assert tf.dims()["time"] == len(r.scalars_history)
            assert np.isfinite(gl).all()
        # f64 on the card over the compared years
        C64 = Config(**dict(cfg, tpu_precision="f64"))
        r64 = resume_region(C64, MP_RESTART, "cuda",
                            os.path.join(workdir, f"{phase}_f64"))
        bmb64 = r64.BMB.double().cpu()
        ice1r_start(r64)
        with contextlib.redirect_stdout(sys.stderr):
            r64.run_to(t_cmp)
        card = resume_snapshot(r64)
        cpu_snap, cpu_wait_s = finish_cpu_job(cpu, cpu_out, phase)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    cpu_run = cpu_snap.pop("run")
    bmb_cpu = cpu_snap.pop("BMB_first")
    gaps = {k: float((cpu_snap[k] - card[k]).abs().max()
                     / cpu_snap[k].abs().max()) for k in RESUME_FIELDS}
    bmb_gap = float((bmb_cpu - bmb64).abs().max()
                    / max(float(bmb_cpu.abs().max()), 1e-300))
    out = dict(restart=os.path.relpath(MP_RESTART), years=years, f32=f32,
               card_cpu_f64=dict(t=t_cmp, **{
                   k: [cpu_snap[k], card[k]]
                   for k in ("steps", "n_visc_its", "n_Axb_its")},
                   rel_gap=gaps, first_BMB_rel_gap=bmb_gap,
                   first_BMB_max_melt=float(-bmb_cpu.min()),
                   cpu_run=cpu_run, cpu_wait_s=cpu_wait_s))
    say(phase, **out)
    assert f32["steps"] >= years and f32["ice_volume_m3"] > 0.0
    assert counts["diva_apply_launches"] > 0 \
        and counts["stack_spmv_launches"] > 0, \
        f"the {phase} path did not go through the kernels"
    assert all(np.isfinite(x) for x in x_GL) and melt[-1] < 0.0
    assert [cpu_snap[k] for k in ("steps", "n_visc_its", "n_Axb_its")] \
        == [card[k] for k in ("steps", "n_visc_its", "n_Axb_its")], out
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps
    assert bmb_gap < 1e-12 and float(bmb_cpu.min()) < 0.0, bmb_gap
    return out


def berends_roughness(V):
    """The experiment-II till friction angle [degrees] at points V [n, 2]
    (a Gaussian trough on the channel axis; the JAX package's
    integrated_tests.py _berends_exp_II_roughness, from the reference's
    AA_create_experiment_II_data.m:20-26)."""
    phi_min, phi_max = 0.2, 2.0
    x_c, sig_x, sig_y = 400e3, 150e3, 15e3
    return phi_max - (phi_max - phi_min) * np.exp(
        -0.5 * (((V[:, 0] - x_c) / sig_x) ** 2 + (V[:, 1] / sig_y) ** 2))


def write_berends_roughness(path, resolution):
    """The true roughness as an x/y NetCDF classic file at half the
    resolution (as the harness writes it)."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    gx = np.arange(0.0, 800e3 + 1, resolution / 2)
    gy = np.arange(-40e3, 40e3 + 1, resolution / 2)
    GX, GY = np.meshgrid(gx, gy, indexing="ij")
    phi = berends_roughness(np.stack([GX.ravel(), GY.ravel()], 1))
    with NCFile(path, "w") as nc:
        nc.def_dim("x", len(gx))
        nc.def_dim("y", len(gy))
        nc.def_var("x", ("x",), units="m")
        nc.put("x", gx)
        nc.def_var("y", ("y",), units="m")
        nc.put("y", gy)
        nc.def_var("till_friction_angle", ("x", "y"), units="degrees")
        nc.put("till_friction_angle", phi.reshape(GX.shape))
    return path


def p95(x):
    """95 % of |x| lies within this (the harness's _p95)."""
    return float(np.percentile(np.abs(np.asarray(x)), 95))


def r95(target, inverted):
    """95 % of the inverted values lie within this factor of their target
    (the harness's _r95)."""
    ratio = np.asarray(inverted, float) / np.asarray(target, float)
    ratio = np.maximum(ratio, 1.0 / np.maximum(ratio, 1e-30))
    return float(np.percentile(ratio, 95))


def exp2_chain(base, legs, device, workdir, timed=False):
    """Berends et al. (2023) experiment II, 'dHdt_invfric_invBMB', as the
    JAX package's harness chains it (integrated_tests.py:1142-1260): three
    regions on one mesh, each started from the previous leg's thickness.
    Returns (per-leg numbers, the harness's metrics, the last region, the
    fields the card is held to). `timed`: time every nudging event and
    count its launches."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice.geometry import (
        ice_surface_elevation, thickness_above_flotation)
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.ops import cuda_spmv
    os.makedirs(workdir, exist_ok=True)
    rough = write_berends_roughness(
        os.path.join(workdir, "exp_II_bed_roughness.nc"),
        base["maximum_resolution_uniform"])
    leg1 = dict(base, choice_bed_roughness="read_from_file",
                filename_bed_roughness_ANT=rough)
    mesh = build_mesh_from_config(Config(**leg1), "ANT")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def start_from(r, Hi0):
        Hi = torch.as_tensor(Hi0, dtype=r.md.A.dtype, device=r.device)
        Hs = ice_surface_elevation(Hi, r.state.Hb, r.state.SL)
        r.state = r.state.replace(
            Hi=Hi, Hi_prev=Hi, Hi_next=Hi, Hs=Hs, Hib=Hs - Hi,
            TAF=thickness_above_flotation(Hi, r.state.Hb, r.state.SL))

    def run_leg(name, over, years, prepare=None):
        C = Config(**dict(leg1 if name != "leg3" else base, **over,
                          end_time_of_run=years))
        r = ModelRegion(C, "ANT", mesh=mesh, device=device)
        if prepare is not None:
            prepare(r)
        nudge = {"n": 0, "s": 0.0, "launches": 0}
        if timed and r.do_nudging:
            inner = r._nudge_bed_roughness

            def nudge_timed(*a):
                sync()
                n0 = cuda_spmv.launches + cuda_spmv.diva_launches
                t = time.perf_counter()
                inner(*a)
                sync()
                nudge["s"] += time.perf_counter() - t
                nudge["n"] += 1
                nudge["launches"] += (cuda_spmv.launches
                                      + cuda_spmv.diva_launches - n0)
            r._nudge_bed_roughness = nudge_timed
        sync()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            r.run_to(years)
        sync()
        wall = time.perf_counter() - t0
        s = r.state
        legs_out[name] = dict(
            years=years, steps=r.n_dt_ice, n_visc_its=s.n_visc_its,
            n_Axb_its=s.n_Axb_its, wall_s=wall,
            sim_yr_per_hr=years / wall * 3600.0,
            ms_per_krylov_it=wall * 1e3 / max(s.n_Axb_its, 1),
            nudging_events=r.nudging_events, **read_counts())
        if timed and r.do_nudging:
            legs_out[name].update(nudging_s=nudge["s"],
                                  nudging_launches=nudge["launches"])
        return r

    legs_out = {}
    r1 = run_leg("leg1", {}, legs[0])
    phi_true = r1.state.bed_roughness.double().cpu().numpy()
    host = {k: getattr(r1.state, k).double().cpu().numpy()
            for k in ("Hi", "Hb", "Hs")}
    mask_a = (host["Hs"] > 2.0) \
        & r1.state.mask_grounded_ice.cpu().numpy()
    r2 = run_leg("leg2", dict(choice_BMB_model_ANT="idealised",
                              choice_BMB_model_idealised="MISMIP+"),
                 legs[1], lambda r: start_from(r, host["Hi"]))
    Hi_ret = r2.state.Hi.double().cpu().numpy()
    dHdt_ret = r2.state.dHi_dt.double().cpu().numpy()
    BMB_ret = r2.BMB.double().cpu().numpy()

    def leg3_start(r):
        r.refgeo_PD = (Hi_ret, host["Hb"])
        start_from(r, Hi_ret)
        r.state = r.state.replace(dHi_dt_target=torch.as_tensor(
            dHdt_ret, dtype=r.md.A.dtype, device=r.device))

    r3 = run_leg("leg3", dict(
        choice_bed_roughness="uniform",
        slid_ZI_phi_fric_uniform=float(phi_true.mean()),
        do_bed_roughness_nudging=True,
        choice_bed_roughness_nudging_method="H_dHdt_flowline",
        choice_BMB_model_ANT="inverted", do_target_dHi_dt=True),
        legs[2], leg3_start)
    phi_inv = r3.state.bed_roughness.double().cpu().numpy()
    BMB_inv = r3.BMB.double().cpu().numpy()
    shelf = r3.state.mask_floating_ice.cpu().numpy()
    Hs_ret = ice_surface_elevation(
        torch.from_numpy(Hi_ret), torch.from_numpy(host["Hb"]),
        r3.state.SL.double().cpu()).numpy()
    # the harness's metrics over grounded ice above 2 m at the end of leg
    # 1 (none where the cut spin-up has no such ice)
    grounded = mask_a.any()
    metrics = dict(
        grounded_vertices=int(mask_a.sum()),
        r95_till_friction_angle=r95(phi_true[mask_a], phi_inv[mask_a])
        if grounded else None,
        p95_ice_thickness=p95(r3.state.Hs.double().cpu().numpy()[mask_a]
                              - Hs_ret[mask_a]) if grounded else None,
        p95_BMB_shelf=p95(BMB_inv[shelf] - BMB_ret[shelf])
        if shelf.any() else None)
    fields = dict(phi_true=phi_true, phi_inv=phi_inv, BMB_inv=BMB_inv,
                  BMB_ret=BMB_ret, Hi=r3.state.Hi.double().cpu().numpy(),
                  u_vav_b=r3.state.u_vav_b.double().cpu().numpy())
    return dict(nV=mesh.nV, nTri=mesh.nTri, legs=legs_out), metrics, r3, \
        fields


def cpu_exp2_snapshot(workdir, snapshot_path):
    """SMALL_EXP2's chain on the CPU (plain versions), its numbers and
    fields saved to snapshot_path; small_berends_phase runs this in a
    process of its own, on one thread (as cpu_resume_snapshot)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    numbers, metrics, _, fields = exp2_chain(SMALL_EXP2, SMALL_EXP2_LEGS,
                                             "cpu", workdir)
    torch.save(dict(numbers=numbers, metrics=metrics, fields=fields,
                    seconds=time.perf_counter() - t0), snapshot_path)


def berends_exp2_phase(workdir):
    """EXP2 on the card in f32: the three legs with their steps, counts,
    wall and launches, the nudging events timed with their launches, and
    the harness's metrics (reported; the legs are cut, so no limit)."""
    d = os.path.join(workdir, "berends_exp2")
    os.makedirs(d, exist_ok=True)
    numbers, metrics, r3, _ = exp2_chain(EXP2, EXP2_LEGS, "cuda", d,
                                         timed=True)
    out = dict(numbers, metrics=metrics, legs_years=EXP2_LEGS)
    say("berends_exp2", **out)
    check_state(r3.state, "cuda")
    legs = numbers["legs"]
    for name, leg in legs.items():
        assert leg["steps"] >= 1 and leg["diva_apply_launches"] > 0 \
            and leg["stack_spmv_launches"] > 0, (name, leg)
    assert legs["leg3"]["nudging_events"] \
        == int(EXP2_LEGS[2] // EXP2["bed_roughness_nudging_dt"]) > 0
    assert metrics["grounded_vertices"] > 0
    return out


def start_small_berends_cpu(workdir):
    """The CPU's chain that small_berends_phase holds the card to, started
    in a process of its own: (process, the path of its result)."""
    d = os.path.join(workdir, "small_berends")
    os.makedirs(d, exist_ok=True)
    cpu_out = os.path.join(d, "cpu.pt")
    return start_cpu_job("cpu_exp2_snapshot", os.path.join(d, "cpu"),
                         cpu_out), cpu_out


def small_berends_phase(workdir, cpu_job):
    """SMALL_EXP2's chain on the card and on the CPU (cpu_job, from
    start_small_berends_cpu), f64: equal steps and counts in every leg,
    the nudged roughness and the inverted BMB within 1e-10 relative,
    thickness and velocity within small_phase's gaps."""
    d = os.path.join(workdir, "small_berends")
    cpu, cpu_out = cpu_job
    try:
        t0 = time.perf_counter()
        numbers, metrics, r3, fields = exp2_chain(
            SMALL_EXP2, SMALL_EXP2_LEGS, "cuda", os.path.join(d, "card"))
        card_s = time.perf_counter() - t0
        snap, cpu_wait_s = finish_cpu_job(cpu, cpu_out, "small_berends")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()

    def gap(k):
        a, b = snap["fields"][k], fields[k]
        return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))
    gaps = {k: gap(k) for k in ("phi_true", "phi_inv", "BMB_inv", "Hi",
                                "u_vav_b")}
    keys = ("steps", "n_visc_its", "n_Axb_its", "nudging_events")
    counts = {leg: {k: [snap["numbers"]["legs"][leg][k],
                        numbers["legs"][leg][k]] for k in keys}
              for leg in numbers["legs"]}
    out = dict(nV=numbers["nV"], nTri=numbers["nTri"],
               legs_years=SMALL_EXP2_LEGS, counts=counts, rel_gap=gaps,
               metrics=[snap["metrics"], metrics], seconds_card=card_s,
               seconds_cpu=snap["seconds"], cpu_wait_s=cpu_wait_s,
               launches={leg: {k: numbers["legs"][leg][k] for k in (
                   "diva_apply_launches", "stack_spmv_launches")}
                   for leg in numbers["legs"]})
    say("small_berends", **out)
    check_state(r3.state, "cuda")
    for leg, c in counts.items():
        assert all(a == b for a, b in c.values()), (leg, c)
    assert numbers["legs"]["leg3"]["nudging_events"] > 0
    assert float(np.abs(fields["BMB_inv"]).max()) > 0.0
    assert max(gaps["phi_inv"], gaps["BMB_inv"], gaps["phi_true"]) \
        <= 1e-10, gaps
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5, gaps
    return out


def synthetic_geothermal_flux(path):
    """A global lon/lat geothermal heat flux file [W m^-2] in the layout
    and with the field of tools/gen_antarctica_synthetic.py, written as
    NetCDF classic."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    lon = np.linspace(0.0, 358.0, 180)
    lat = np.linspace(-90.0, 90.0, 91)
    LON, LAT = np.meshgrid(lon, lat, indexing="ij")
    hflux = (0.054 + 0.012 * np.cos(np.deg2rad(LAT))
             + 0.008 * np.sin(2 * np.deg2rad(LON)) * np.cos(np.deg2rad(LAT)))
    with NCFile(path, "w") as nc:
        nc.def_dim("lon", len(lon))
        nc.def_dim("lat", len(lat))
        nc.def_var("lon", ("lon",))
        nc.put("lon", lon)
        nc.def_var("lat", ("lat",))
        nc.put("lat", lat)
        nc.def_var("hflux", ("lon", "lat"))
        nc.put("hflux", hflux)
    return path


def synthetic_smb(path):
    """An x/y SMB file [m ice / yr] over SMALL's domain: accumulation
    falling towards the margin."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    x = np.linspace(-1000e3, 1000e3, 81)
    y = np.linspace(-1000e3, 1000e3, 61)
    X, Y = np.meshgrid(x, y, indexing="ij")
    smb = 0.5 - 0.4 * np.hypot(X, Y) / 1.5e6
    with NCFile(path, "w") as nc:
        nc.def_dim("x", len(x))
        nc.def_dim("y", len(y))
        nc.def_var("x", ("x",))
        nc.put("x", x)
        nc.def_var("y", ("y",))
        nc.put("y", y)
        nc.def_var("SMB", ("y", "x"))
        nc.put("SMB", smb.T)
    return path


def small_thermo_files_phase(workdir, mesh_s):
    """SMALL_THERMO with the geothermal flux read from a lon/lat file and
    the SMB from an x/y file, card against CPU as small_phase holds them;
    heat_columns' launches counted on the card's run."""
    from ufemism2_tpu_torch.config import Config
    Cs = Config(**dict(
        SMALL_THERMO, choice_geothermal_heat_flux="read_from_file",
        filename_geothermal_heat_flux=synthetic_geothermal_flux(
            os.path.join(workdir, "ghf_lonlat.nc")),
        choice_SMB_model_ANT="prescribed",
        filename_SMB_prescribed_ANT=synthetic_smb(
            os.path.join(workdir, "smb_xy.nc"))))
    zero_counts()
    small_phase("small_thermo_files", Cs, mesh_s)
    counts = read_counts()
    say("small_thermo_files_launches", **counts)
    assert counts["heat_columns_launches"] > 0 \
        and counts["diva_apply_launches"] > 0, counts
    return counts




# -- the realistic Antarctica stand-in and the climate chain -----------------
# The reference's flagship realistic test, Ant_init_20kyr_invBMB_invfric_40km
# (ufemism2_tpu/validation/integrated_tests.py:1343-1400
# run_antarctica_40km), whose config.cfg is not in the repository, written
# inline with every choice the harness names (its comment block and
# overrides): geometry from a file as the initial, present-day and
# GIA-equilibrium reference; the 'realistic' climate (a RACMO-style
# snapshot) with lapse-rate corrections; the prescribed SMB; the geothermal
# flux from a (lon/lat) file; the dHi_dt target from a file; Zoet-Iverson
# sliding with H_dHdt_flowline roughness nudging; the inverted BMB; 3-D
# thermodynamics (Huybrechts 1992 rheology, Robin initial temperatures);
# adaptive remeshing; 40 km on grounded ice and at the grounding line, 80 km
# on floating ice and at the calving front, 400 km elsewhere, on the
# domain +-3,040 km of the synthetic data. The data: the port's writer
# (ufemism2_tpu_torch/tools/antarctica_synthetic.py, the repository's
# synthetic continent on its 20 km grid, seeded), not BedMachine and RACMO.
# Cut against the reference: ANT_INIT_YEARS model years (the reference runs
# 20,000) with one forced remesh at their end (the first fitness check
# comes 50 years in) and ANT_STEPS_AFTER steps on the new mesh; the
# schema's solver settings (the reference config's are unknown); f32; the
# output files off (a restart is written for antarctica_itm).
ANT_DX = 20e3


def ant_init_cfg(files, res=40e3, **over):
    return dict(dict(
        choice_refgeo_init_ANT="read_from_file",
        choice_refgeo_PD_ANT="read_from_file",
        choice_refgeo_GIAeq_ANT="read_from_file",
        filename_refgeo_init_ANT=str(files["topo"]),
        filename_refgeo_PD_ANT=str(files["topo"]),
        filename_refgeo_GIAeq_ANT=str(files["topo"]),
        xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
        choice_climate_model_ANT="realistic",
        choice_climate_model_realistic="snapshot",
        filename_climate_snapshot_ANT=str(files["climate"]),
        do_lapse_rate_corrections_ANT=True,
        choice_SMB_model_ANT="prescribed",
        filename_SMB_prescribed_ANT=str(files["SMB"]),
        choice_geothermal_heat_flux="read_from_file",
        filename_geothermal_heat_flux=str(files["ghf"]),
        do_target_dHi_dt=True,
        filename_dHi_dt_target_ANT=str(files["dHdt"]),
        choice_sliding_law="Zoet-Iverson",
        do_bed_roughness_nudging=True,
        choice_bed_roughness_nudging_method="H_dHdt_flowline",
        choice_BMB_model_ANT="inverted",
        choice_thermo_model="3D_heat_equation",
        choice_ice_rheology_Glen="Huybrechts1992",
        choice_initial_ice_temperature_ANT="Robin",
        allow_mesh_updates=True,
        maximum_resolution_uniform=400e3,
        maximum_resolution_grounded_ice=res,
        maximum_resolution_grounding_line=res, grounding_line_width=res,
        maximum_resolution_floating_ice=2 * res,
        maximum_resolution_calving_front=2 * res,
        calving_front_width=2 * res,
        maximum_resolution_ice_front=2 * res, ice_front_width=2 * res,
        nit_Lloyds_algorithm=2, tpu_precision="f32",
        start_time_of_run=0.0, end_time_of_run=100.0), **over)


# 2 model years (6 before the LADDIE slice, whose phases took the time;
# --ant-init-years 12 still runs into the hard regime past year 4)
ANT_INIT_YEARS = 2.0
ANT_WINDOW_YEARS = 2.0
ANT_STEPS_AFTER = 3
# the f32 trajectory of antarctica_init on the card: (steps, n_visc_its,
# n_Axb_its) at the window's end and after the steps on the new mesh
ANT_INIT_PINS = (23, 88, 12328)


# The second leg, from antarctica_init's restart: the rest of the climate
# chain at the same width, f32 - the snapshot climate with a transient
# deltaT (the synthetic dT_atmosphere series) and the CC correction, the
# realistic insolation (a synthetic Laskar-layout file), IMAU-ITM with
# uniform firn, ELRA bed deformation and the GlacialIndex LMB (a synthetic
# glacial-index series), every component event every model year (GIA
# every two); ANT_ITM_YEARS model years before and after a forced remesh
# (20 would not fit the script's time), so that the firn, the
# albedo and dHb cross it.
def ant_itm_cfg(files, t0, **over):
    return ant_init_cfg(
        files,
        choice_climate_model_ANT="snapshot_plus_transient_deltaT",
        filename_atmosphere_dT_ANT=str(files["dT_atm"]),
        choice_insolation_forcing="realistic",
        filename_insolation=str(files["insolation"]),
        choice_SMB_model_ANT="IMAU-ITM",
        choice_SMB_IMAUITM_init_firn_ANT="uniform",
        choice_GIA_model="ELRA", dt_GIA=2.0,
        choice_LMB_model_ANT="GlacialIndex",
        filename_LMB_GI_ANT=str(files["GI"]),
        warm_LMB_ANT=0.0, cold_LMB_ANT=-2.0,
        dt_climate=1.0, dt_SMB=1.0, dt_LMB=1.0,
        start_time_of_run=t0, end_time_of_run=t0 + 100.0, **over)


ANT_ITM_YEARS = (1.0, 1.0)
ANT_ITM_PINS = (43, 368, 49245)


@contextlib.contextmanager
def timed_events(region, names=("climate", "smb", "gia", "lmb")):
    """Within the block, each component runner of `region` named in
    `names` is timed call by call (synchronised); yields {name: [s, ...]}.
    The runners are restored on exit (a remesh needs them unwrapped)."""
    times = {n: [] for n in names}
    orig = {n: getattr(region, f"run_{n}") for n in names}

    def timed(n, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[n].append(time.perf_counter() - t)
            return out
        return call
    for n in names:
        setattr(region, f"run_{n}", timed(n, orig[n]))
    try:
        yield times
    finally:
        for n in names:
            setattr(region, f"run_{n}", orig[n])


def event_summary(times):
    return {f"{n}_event_ms": (1e3 * float(np.mean(v)) if v else None)
            for n, v in times.items()} | {
        f"{n}_events": len(v) for n, v in times.items()}


def event_launches(call):
    """Kernel launches of one call of `call()` (torch.profiler's count of
    the runtime's launch calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"))


def ant_window(region, t_end, tag):
    """run_to(t_end) with the kernels' launches and the GMRES calls
    counted and the component events timed: (the numbers of the window,
    the last GMRES call's operator and solution)."""
    with counted_gmres() as gm, timed_events(region) as ev:
        zero_counts()
        s0 = region.state
        steps0, visc0, axb0 = region.n_dt_ice, s0.n_visc_its, s0.n_Axb_its
        thermo0 = region.thermo_steps
        t0_model = region.time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = region.run_to(t_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    axb = state.n_Axb_its - axb0
    out = dict(t_model_yr=region.time, window_yr=region.time - t0_model,
               steps=region.n_dt_ice - steps0,
               n_visc_its=state.n_visc_its - visc0, n_Axb_its=axb,
               gmres_its=gm["its"], gmres_calls=gm["calls"],
               gmres_unconverged=gm["unconverged"],
               thermo_steps=region.thermo_steps - thermo0, wall_s=wall,
               ms_per_krylov_it=wall * 1e3 / max(axb, 1),
               sim_yr_per_hr=(region.time - t0_model) / wall * 3600.0,
               dt_ice=state.dt_ice, **counts, **event_summary(ev))
    say(tag, **out)
    assert out["steps"] >= 1 and axb > 0, f"{tag}: no ice step was taken"
    assert counts["diva_apply_launches"] == gm["its"] + gm["calls"] > 0, \
        f"{tag}: the path did not go through diva_apply"
    assert counts["stack_spmv_launches"] > 16 * gm["calls"], \
        f"{tag}: the path did not go through stack_spmv"
    return out, {"A": gm["A"], "x": gm["x"]}


def ant_scalars(region):
    """Ice volume and the harness's score, RMSE(Hi - Hi_init) over the
    vertices (Hi_init: the present-day reference, which is the initial
    geometry, on the current mesh)."""
    Hi = region.state.Hi.double().cpu().numpy()
    Hi_init = np.asarray(region.refgeo_PD[0])
    return dict(ice_volume_m3=float((region.state.Hi * region.md.A).sum()),
                rmse_Hi_vs_init_m=float(np.sqrt(((Hi - Hi_init) ** 2)
                                                .mean())))


def antarctica_init_phase(files, workdir, years=ANT_INIT_YEARS):
    """The stand-in's construction (mesh from the geometry file, the
    reads, the initial solve), `years` model years in windows of
    ANT_WINDOW_YEARS, a forced remesh and steps on the new mesh, on the card
    in f32; writes the restart antarctica_itm resumes from. Then the
    kernels on the phase's operands: diva_apply on the last operator apply
    (after the remesh), stack_spmv on the new mesh's five-operator stack,
    heat_columns on the last call. Returns (numbers, restart path, kernel
    cases)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.io.output_files import write_restart_file
    from ufemism2_tpu_torch.main.region import ModelRegion
    C = Config(**ant_init_cfg(files))
    heat_calls = contextlib.ExitStack()
    last_heat = heat_calls.enter_context(last_heat_call())
    zero_counts()
    t0 = time.perf_counter()
    region = ModelRegion(C, "ANT")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = read_counts()
    say("antarctica_init_construct", nV=region.mesh.nV,
        nTri=region.mesh.nTri, seconds=init_s,
        initial_visc_its=region.state.n_visc_its, **init_launches,
        **ant_scalars(region))
    t_end = region.time + years
    windows = []
    while region.time < t_end - 1e-6:
        windows.append(ant_window(
            region, min(region.time + ANT_WINDOW_YEARS, t_end),
            "antarctica_init_window")[0])
    window = {k: sum(w[k] for w in windows) for k in (
        "window_yr", "steps", "n_visc_its", "n_Axb_its", "gmres_its",
        "gmres_calls", "gmres_unconverged", "thermo_steps", "wall_s",
        "diva_apply_launches", "stack_spmv_launches",
        "heat_columns_launches", "bpa_apply_launches",
        "line_thomas_launches", "laddie_stage_launches",
        "laddie_kernel_launches")}
    window.update(
        ms_per_krylov_it=window["wall_s"] * 1e3 / window["n_Axb_its"],
        sim_yr_per_hr=window["window_yr"] / window["wall_s"] * 3600.0,
        n_visc_its_by_window=[w["n_visc_its"] for w in windows],
        wall_s_by_window=[w["wall_s"] for w in windows])
    t0 = time.perf_counter()
    region.update_mesh()
    torch.cuda.synchronize()
    remesh_s = time.perf_counter() - t0
    n0 = region.n_dt_ice
    with counted_gmres() as gm:
        zero_counts()
        t0 = time.perf_counter()
        step_n(region, ANT_STEPS_AFTER)
        torch.cuda.synchronize()
        after_s = time.perf_counter() - t0
        after = read_counts()
        last = {"A": gm["A"], "x": gm["x"]}
    heat_calls.close()
    state = region.state
    check_state(state, "cuda")
    pins = (region.n_dt_ice, state.n_visc_its, state.n_Axb_its)
    out = dict(nV=region.mesh.nV,
               nTri=region.mesh.nTri, construct_s=init_s,
               window=window, remesh_s=remesh_s,
               remesh_parts_s=region.remesh_timings[-1],
               steps_after=region.n_dt_ice - n0, after_s=after_s,
               after_launches=after, gmres_its_after=gm["its"],
               counts=pins, **ant_scalars(region),
               launches={k: window[k] + after[k] for k in after})
    say("antarctica_init", **out)
    assert out["ice_volume_m3"] > 0.0
    assert region.n_mesh_updates == 1
    for k in ("diva_apply_launches", "stack_spmv_launches",
              "heat_columns_launches"):
        assert out["launches"][k] > 0, (k, out["launches"])
    assert window["heat_columns_launches"] == window["thermo_steps"], \
        "one heat_columns launch a thermodynamics step"
    if years == ANT_INIT_YEARS:
        assert pins == ANT_INIT_PINS, \
            f"the f32 antarctica_init trajectory moved: {pins}"
    path = os.path.join(workdir, "antarctica_init_restart.nc")
    write_restart_file(path, region.mesh, region.state, region.time,
                       host_counters={"n_dt_ice": int(region.n_dt_ice)})
    # the kernels on this phase's operands: the continent's ocean-pressure
    # front, Zoet-Iverson sliding and the remeshed mesh
    ops = region.mesh.operators
    m2 = [ops.M2_ddx_b_b, ops.M2_ddy_b_b, ops.M2_d2dx2_b_b,
          ops.M2_d2dxdy_b_b, ops.M2_d2dy2_b_b]
    rng = np.random.default_rng(11)
    kernel_cases = dict(
        diva=diva_check("diva_apply_antarctica_init_last_apply", last["A"],
                        torch.cat(last["x"]), [m.tocsr() for m in m2]),
        stack=kernel_case(
            "M2_stack_5ops_d2_antarctica_float32_bf16x", m2,
            rng.standard_normal((region.mesh.nTri, 2)) * 300.0,
            torch.float32, True),
        heat=heat_case("heat_columns_antarctica_init_last_call",
                       last_heat["args"]))
    return out, path, kernel_cases


def antarctica_itm_phase(files, restart, check_pins=True):
    """The second leg, resumed from antarctica_init's restart on its
    mesh: ANT_ITM_YEARS model years before and after a forced remesh, the
    component events timed, the launches of one event of each after the
    measurement; then diva_apply on the last operator apply (after the
    remesh) and heat_columns on the last call against their plain
    versions. Returns (numbers, kernel cases)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.io.output_files import mesh_from_restart
    from ufemism2_tpu_torch.io.ncio import NCFile
    from ufemism2_tpu_torch.main.region import ModelRegion
    with NCFile(restart) as nc:
        t_restart = float(np.asarray(nc.read("time")).reshape(-1)[-1])
    C = Config(**ant_itm_cfg(files, t_restart))
    heat_calls = contextlib.ExitStack()
    last_heat = heat_calls.enter_context(last_heat_call())
    t0 = time.perf_counter()
    region = ModelRegion(C, "ANT", mesh=mesh_from_restart(restart, C))
    region.resume_from_restart(restart)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    smb = region.run_smb
    legs = [ant_window(region, region.time + ANT_ITM_YEARS[0],
                       "antarctica_itm_before_remesh")[0]]
    firn_before = float(region.run_smb.FirnDepth.mean())
    t0 = time.perf_counter()
    region.update_mesh()
    torch.cuda.synchronize()
    remesh_s = time.perf_counter() - t0
    assert region.run_smb is not smb and region.run_smb.calls > smb.calls
    leg, last = ant_window(region, region.time + ANT_ITM_YEARS[1],
                           "antarctica_itm_after_remesh")
    legs.append(leg)
    heat_calls.close()
    state = region.state
    check_state(state, "cuda")
    smb = region.run_smb
    pins = (region.n_dt_ice, state.n_visc_its, state.n_Axb_its)
    out = dict(nV=region.mesh.nV, nTri=region.mesh.nTri, resume_s=resume_s,
               t_model_yr=region.time, legs=legs, remesh_s=remesh_s,
               remesh_parts_s=region.remesh_timings[-1], counts=pins,
               smb_calls=smb.calls, gia_events=region.gia_events,
               integrated_SMB_m3_per_yr=float((region.SMB
                                               * region.md.A).sum()),
               max_abs_dHb_m=float(state.dHb.abs().max()),
               mean_firn_m=float(smb.FirnDepth.mean()),
               mean_firn_before_remesh_m=firn_before,
               LMB_min=float(region.LMB.min()), **ant_scalars(region),
               heat_last_call_after_remesh=leg["heat_columns_launches"] > 0,
               launches={k: sum(leg[k] for leg in legs) for k in (
                   "diva_apply_launches", "stack_spmv_launches",
                   "heat_columns_launches")})
    # one more event of each, profiled, after everything measured (the
    # SMB and the matrix climate advance their state on every call)
    s, t = state, region.time
    masks = region._masks_fracs(s.Hi, s.Hb, s.SL)[0]
    out["event_launches"] = dict(
        climate=event_launches(lambda: region.run_climate(t, s)),
        smb=event_launches(lambda: region.run_smb(t, s,
                                                  climate=region.climate)),
        gia=event_launches(lambda: region.run_gia(t, s, C.dt_GIA)),
        lmb=event_launches(lambda: region.run_lmb(t, s, masks)))
    say("antarctica_itm", **out)
    assert region.gia_events >= 1 and out["max_abs_dHb_m"] > 0.0
    assert np.isfinite(out["integrated_SMB_m3_per_yr"])
    assert out["ice_volume_m3"] > 0.0
    for k, v in out["launches"].items():
        assert v > 0, (k, out["launches"])
    if check_pins:
        assert pins == ANT_ITM_PINS, \
            f"the f32 antarctica_itm trajectory moved: {pins}"
    kernel_cases = dict(
        diva=diva_check("diva_apply_antarctica_itm_last_apply", last["A"],
                        torch.cat(last["x"])),
        heat=heat_case("heat_columns_antarctica_itm_last_call",
                       last_heat["args"]))
    return out, kernel_cases


# small_climate: a coarse Antarctica (600 km on grounded ice) in f64 on the
# writer's 80 km grid, card against a CPU process, through two steps, a
# forced remesh and two more, every component event every 0.2 years: the
# matrix climate (PD = the RACMO-style snapshot, the synthetic PI, warm and
# cold snapshots with winds, CO2 and insolation) with IMAU-ITM, ELRA and
# the GlacialIndex LMB; and snapshot_plus_anomalies for both the climate
# and the SMB. tests/test_torch_antarctica.py holds the JAX package to the
# port on the first pattern's mesh.
SMALL_CLIMATE_DX = 80e3
SMALL_CLIMATE_TIMES = ((0.2, 0.4), (0.6, 0.8))


def small_climate_cfg(files, which):
    res = 600e3
    base = dict(
        choice_refgeo_init_ANT="read_from_file",
        choice_refgeo_PD_ANT="read_from_file",
        choice_refgeo_GIAeq_ANT="read_from_file",
        filename_refgeo_init_ANT=str(files["topo"]),
        filename_refgeo_PD_ANT=str(files["topo"]),
        filename_refgeo_GIAeq_ANT=str(files["topo"]),
        xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        choice_thermo_model="none", allow_mesh_updates=True,
        maximum_resolution_uniform=800e3,
        maximum_resolution_grounded_ice=res,
        maximum_resolution_grounding_line=res, grounding_line_width=res,
        maximum_resolution_floating_ice=2 * res,
        maximum_resolution_calving_front=2 * res,
        calving_front_width=2 * res,
        maximum_resolution_ice_front=2 * res, ice_front_width=2 * res,
        nit_Lloyds_algorithm=2, tpu_precision="f64", visc_it_nit=3,
        pc_nit_max=2, dt_climate=0.2, dt_SMB=0.2, dt_LMB=0.2, dt_GIA=0.2,
        start_time_of_run=0.0, end_time_of_run=1.0)
    if which == "matrix":
        return dict(
            base, choice_climate_model_ANT="matrix",
            climate_matrix_filename_PD_obs_climate=str(files["climate"]),
            climate_matrix_filename_climate_snapshot_PI=str(files["PI"]),
            climate_matrix_filename_climate_snapshot_warm=str(files["warm"]),
            climate_matrix_filename_climate_snapshot_cold=str(files["cold"]),
            climate_matrix_biascorrect_warm=True,
            climate_matrix_biascorrect_cold=True,
            choice_matrix_forcing="CO2_direct",
            filename_CO2_record=str(files["CO2"]),
            choice_insolation_forcing="realistic",
            filename_insolation=str(files["insolation"]),
            climate_matrix_warm_orbit_time=0.0,
            climate_matrix_cold_orbit_time=-21000.0,
            choice_SMB_model_ANT="IMAU-ITM", choice_GIA_model="ELRA",
            choice_LMB_model_ANT="GlacialIndex",
            filename_LMB_GI_ANT=str(files["GI"]),
            warm_LMB_ANT=0.0, cold_LMB_ANT=-2.0)
    return dict(
        base, choice_climate_model_ANT="snapshot_plus_anomalies",
        climate_snp_p_anml_filename_snapshot_ANT=str(files["climate"]),
        climate_snp_p_anml_filename_anomalies_ANT=str(files["clim_anom"]),
        choice_SMB_model_ANT="snapshot_plus_anomalies",
        SMB_snp_p_anml_filename_snapshot_SMB=str(files["SMB"]),
        SMB_snp_p_anml_filename_anomalies=str(files["SMB_anom"]))


def small_climate_run(files, which, device):
    """One small_climate configuration on `device`: the counts after each
    run_to and the end's fields, as host numbers and f64 arrays."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    r = ModelRegion(Config(**small_climate_cfg(files, which)), "ANT",
                    device=device)
    counts = []
    t0 = time.perf_counter()
    for k, times in enumerate(SMALL_CLIMATE_TIMES):
        if k:
            r.update_mesh()
        for t in times:
            s = r.run_to(t)
            counts.append((r.n_dt_ice, s.n_visc_its, s.n_Axb_its))
    seconds = time.perf_counter() - t0

    def host(x):
        return x.double().cpu().numpy()
    fields = {k: host(getattr(r.state, k)) for k in (
        "Hi", "Hb", "dHb", "u_vav_b", "v_vav_b")}
    fields.update(SMB=host(r.SMB), LMB=host(r.LMB),
                  T2m=host(r.climate["T2m"]),
                  Precip=host(r.climate["Precip"]))
    smb_calls = getattr(r.run_smb, "calls", None)
    climate_calls = getattr(r.run_climate, "calls", None)
    if smb_calls is not None:
        fields["FirnDepth"] = host(r.run_smb.FirnDepth)
    orbits = None
    if climate_calls is not None:
        fields["albedo"] = host(r.run_climate._albedo)
        orbits = matrix_orbits(r.run_climate)
    return dict(nV=r.mesh.nV, counts=counts, fields=fields,
                seconds=seconds, smb_calls=smb_calls,
                climate_calls=climate_calls, gia_events=r.gia_events,
                orbits=orbits)


def matrix_orbits(m):
    """Which insolation frame each orbit of the matrix climate `m` reads
    (its times clamped to the preloaded window, as the JAX package does;
    ROADMAP.md C) and how far apart the warm and the cold snapshot's
    absorbed insolation lie, relative to the warm one's: the denominator
    of the insolation weight."""
    t0, t1 = float(m.insol._t[0]), float(m.insol._t[-1])
    read = {k: min(max(getattr(m.C, f"climate_matrix_{k}_orbit_time"), t0),
                   t1) for k in ("warm", "cold")}
    w, c = m.warm["I_abs"].sum(), m.cold["I_abs"].sum()
    return dict(frame_read=read, I_abs_apart=float((w - c).abs() / w))


def cpu_small_climate(data_dir, out):
    """The CPU's small_climate runs (start_cpu_job), saved to `out`."""
    torch.set_num_threads(2)
    from ufemism2_tpu_torch.tools.antarctica_synthetic import NAMES
    files = {k: os.path.join(data_dir, n) for k, n in NAMES.items()}
    torch.save({w: small_climate_run(files, w, "cpu")
                for w in ("matrix", "anomalies")}, out)


def small_climate_phase(files, cpu_job):
    """small_climate on the card against the CPU process: equal counts
    after every run_to, the same number of stateful calls, thickness and
    velocity within small's gaps, the climate, the SMB and dHb within
    1e-10 of their largest value."""
    proc, cpu_out = cpu_job
    card = {w: small_climate_run(files, w, "cuda")
            for w in ("matrix", "anomalies")}
    cpu, cpu_wait_s = finish_cpu_job(proc, cpu_out, "small_climate")
    for w in card:
        a, b = cpu[w], card[w]
        gaps = {k: float(np.abs(a["fields"][k] - b["fields"][k]).max()
                         / max(np.abs(a["fields"][k]).max(), 1e-300))
                for k in b["fields"]}
        say(f"small_climate_{w}", nV=b["nV"],
            counts=[a["counts"], b["counts"]], rel_gap=gaps,
            smb_calls=[a["smb_calls"], b["smb_calls"]],
            climate_calls=[a["climate_calls"], b["climate_calls"]],
            gia_events=[a["gia_events"], b["gia_events"]],
            orbits=b["orbits"],
            seconds_cpu=a["seconds"], seconds_card=b["seconds"],
            cpu_wait_s=cpu_wait_s)
        assert a["counts"] == b["counts"], (w, a["counts"], b["counts"])
        assert (a["smb_calls"], a["climate_calls"], a["gia_events"]) == \
            (b["smb_calls"], b["climate_calls"], b["gia_events"])
        assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
            and gaps["v_vav_b"] < 1e-5, (w, gaps)
        for k in ("T2m", "Precip", "SMB", "dHb", "FirnDepth", "albedo"):
            if k in gaps:
                assert gaps[k] <= 1e-10, (w, k, gaps)
    assert card["matrix"]["gia_events"] > 0
    return card


def check_state(state, device_type):
    """Every tensor of the state finite and on the device."""
    import dataclasses
    n = 0
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            n += check_state(v, device_type)
        elif isinstance(v, torch.Tensor):
            assert v.device.type == device_type, (f.name, v.device)
            if v.is_floating_point():
                assert bool(torch.isfinite(v).all()), f"{f.name} not finite"
            n += 1
        elif isinstance(v, float):
            assert np.isfinite(v), f"{f.name} not finite"
    return n


def find_x_GL(mesh, TAF, dx=500.0):
    """Grounding-line position [m] along the y = 0 centreline: the last
    sign change of the thickness above flotation (as bench.py of the JAX
    package finds it)."""
    from scipy.interpolate import LinearNDInterpolator
    interp = LinearNDInterpolator(mesh.V, TAF.double().cpu().numpy(),
                                  fill_value=-1.0)
    xs = np.arange(0.0, mesh.xmax + dx / 2, dx)
    taf = interp(np.column_stack([xs, np.zeros_like(xs)]))
    ix = np.flatnonzero((taf[:-1] > 0) & (taf[1:] <= 0))
    if len(ix) == 0:
        return float("nan")
    i = ix[-1]
    lam = taf[i] / (taf[i] - taf[i + 1])
    return float((1 - lam) * xs[i] + lam * xs[i + 1])


def profile_steps(region, n_steps, table_path=None):
    """The next `n_steps` ice steps twice from the same state (a step is
    a pure function of the state): once timed without the profiler, once
    under torch.profiler. Prints the device's busy share of the
    unprofiled wall time and the kernels by device time."""
    from torch.profiler import profile, ProfilerActivity

    def steps():
        state = region.state
        for _ in range(n_steps):
            state = region.pc_step(region.md, state, region.C.dt_ice_max,
                                   SMB=region.SMB, BMB=region.BMB,
                                   LMB=region.LMB)
        torch.cuda.synchronize()
        return state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = steps()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    if busy_ms <= 0:
        raise SystemExit("profile: the profiler saw no device time")
    n_axb = state.n_Axb_its - region.state.n_Axb_its
    n_kernels = sum(r[1] for r in rows)
    say("profile", steps=n_steps, wall_ms=wall_ms,
        profiled_wall_ms=profiled_wall_ms, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms, device_kernels=n_kernels,
        n_Axb_its=n_axb, kernels_per_krylov_it=n_kernels / max(n_axb, 1),
        device_ms_per_krylov_it=busy_ms / max(n_axb, 1),
        wall_ms_per_krylov_it=wall_ms / max(n_axb, 1),
        top=[{"kernel": k[:80], "count": c, "ms": ms,
              "share_of_busy": ms / busy_ms} for k, c, ms in rows[:12]])
    if table_path:
        os.makedirs(os.path.dirname(table_path) or ".", exist_ok=True)
        with open(table_path, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=40))


# ---------------------------------------------------------------------------
# ISMIP-HOM: the BPA and hybrid DIVA/BPA stress balances
# ---------------------------------------------------------------------------

# Stand-ins for the reference's config_ISMIP_HOM_<exp>_<L>_<approx>.cfg
# (ufemism2_tpu/validation/integrated_tests.py:242-243), which are not in
# the repository, from the protocol of Pattyn et al. (2008, The Cryosphere
# 2:95-108) and the schema: experiment A (the idealised geometry
# ISMIP-HOM_A: the surface sloping at 0.5 degrees, the bed's 500 m
# sinusoid, no slip) or C (ISMIP-HOM_C: 0.1 degrees, flat-bottomed slab on
# the idealised ISMIP-HOM_C friction), uniform A 1e-16 Pa^-3 yr^-1, n 3,
# 'periodic_ISMIP-HOM' on every side, nz 12 (regular zeta), a uniform mesh
# at L/40 on [-L, L]^2 (the domain the harness's transect implies: x in
# [xmin/2, xmax/2], y = ymin/4, integrated_tests.py:249-252), no SMB, BMB
# or thermodynamics (the experiments are diagnostic), the schema's
# block_jacobi (the line preconditioner) and viscosity loop (visc_it_nit
# 50); one ice step of dt_ice_min (0.1 yr) after the region's initial
# solve.
IH_L = 20e3
IH_T_END = 0.1


def ismip_hom_cfg(experiment, L, res, **over):
    geo = f"ISMIP-HOM_{experiment}"
    kw = dict(
        choice_refgeo_init_ANT="idealised", choice_refgeo_init_idealised=geo,
        choice_refgeo_PD_ANT="idealised", choice_refgeo_PD_idealised=geo,
        refgeo_idealised_ISMIP_HOM_L=L, choice_mask_noice="none",
        choice_stress_balance_approximation="BPA",
        choice_sliding_law="no_sliding",
        choice_ice_rheology_Glen="uniform", uniform_Glens_flow_factor=1e-16,
        Glens_flow_law_exponent=3.0, nz=12, choice_zeta_grid="regular",
        choice_thermo_model="none",
        choice_initial_ice_temperature_ANT="uniform",
        choice_SMB_model_ANT="uniform", uniform_SMB=0.0,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        xmin_ANT=-L, xmax_ANT=L, ymin_ANT=-L, ymax_ANT=L,
        maximum_resolution_uniform=res,
        maximum_resolution_grounded_ice=res,
        maximum_resolution_floating_ice=res,
        maximum_resolution_grounding_line=res, grounding_line_width=res,
        maximum_resolution_calving_front=res, calving_front_width=res,
        maximum_resolution_ice_front=res, ice_front_width=res,
        nit_Lloyds_algorithm=2, allow_mesh_updates=False,
        tpu_precision="f32", do_ANT=True, start_time_of_run=0.0,
        end_time_of_run=IH_T_END, dt_coupling=IH_T_END,
        **{f"BC_{c}_{s}": "periodic_ISMIP-HOM" for c in "uv"
           for s in ("north", "south", "east", "west")})
    if experiment == "C":
        kw.update(choice_sliding_law="idealised",
                  choice_idealised_sliding_law="ISMIP-HOM_C")
    kw.update(over)
    return kw


ISMIP_A = ismip_hom_cfg("A", IH_L, IH_L / 40)
ISMIP_C = ismip_hom_cfg("C", IH_L, IH_L / 40)
ISMIP_A_2KM = ismip_hom_cfg("A", IH_L, 2e3)
# the hybrid: BPA where x > 0, the mask read from a file that the phase
# writes (mask_BPA on an x/y grid)
ISMIP_A_HYBRID = dict(ISMIP_A,
                      choice_stress_balance_approximation="hybrid DIVA/BPA",
                      choice_hybrid_DIVA_BPA_mask_ANT="read_from_file")
ISMIP_A_DIVA = dict(ISMIP_A, choice_stress_balance_approximation="DIVA")
# card against CPU: experiments A and C and the hybrid at L = 80 km on an
# 8 km mesh, f64, the viscosity loop cut to 3 iterations a solve
SMALL_ISMIP = {k: dict(ismip_hom_cfg(e, 80e3, 8e3, tpu_precision="f64",
                                     visc_it_nit=2), **over)
               for k, e, over in (
                   ("A_BPA", "A", {}), ("C_BPA", "C", {}),
                   ("A_hybrid", "A", dict(
                       choice_stress_balance_approximation="hybrid DIVA/BPA",
                       choice_hybrid_DIVA_BPA_mask_ANT="read_from_file")))}
# the JAX package's scoreboard for experiment A, BPA, L = 20 km
# (scoreboard/it_ideal_ISMIP_HOM_experiment_A_BPA_L020_284866f.json): its
# resolution and configuration are not known; printed for context only
IH_SCOREBOARD_L020 = dict(u_surf_min=0.5627511657083119,
                          u_surf_max=6.347638505949138,
                          u_surf_mean=3.837554433271286,
                          n_visc_its=231, n_Axb_its=35402)


def write_bpa_mask(path, L):
    """mask_BPA = 1 where x > 0 on an x/y grid over [-1.5 L, 1.5 L]^2,
    [y, x], written through the port's NetCDF writer."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    x = np.linspace(-1.5 * L, 1.5 * L, 61)
    y = np.linspace(-1.5 * L, 1.5 * L, 41)
    with NCFile(path, "w") as nc:
        nc.def_dim("x", len(x))
        nc.def_dim("y", len(y))
        for name, dims, data in (
                ("x", ("x",), x), ("y", ("y",), y),
                ("mask_BPA", ("y", "x"),
                 (x[None, :] > 0.0) * np.ones((len(y), 1)))):
            nc.def_var(name, dims)
            nc.put(name, data)
    return path


def ismip_u_surf(mesh, u_3D_b):
    """u_surf on the JAX package's ISMIP-HOM transect: 100 points, x in
    [xmin/2, xmax/2], y = ymin/4 (integrated_tests.py:249-252)."""
    from ufemism2_tpu_torch.models.transects import Transect
    xt = np.linspace(mesh.xmin / 2, mesh.xmax / 2, 100)
    yt = np.full_like(xt, mesh.ymin / 4)
    tr = Transect(mesh, np.stack([xt, yt], 1), "ISMIP-HOM")
    return tr.sample_triangles(u_3D_b.double().cpu().numpy())[:, 0]


def bpa_rows_mixed(md):
    """Lateral row tables with every kind at once: free rows, 'zero'
    (identity) rows and neighbour-mean rows, u and v of one row of
    different kinds."""
    from ufemism2_tpu_torch.ops.cuda_spmv import DivaRows
    free = md.x("bpa_rows").free
    x, y = md.TriGC[:, 0], md.TriGC[:, 1]
    return DivaRows(md.TriC, md.mask_TriC, free, ~free & (x > 0),
                    ~free & (y > 0))


def bpa_operands(md, nz, dtype, rng):
    """Random coefficient fields of the BPA operator at md's size and nz
    layers, of the magnitudes a viscosity iteration makes (ice 500-1,500 m
    thick, eta 1e13-1e14 Pa yr, slopes of a few 1e-3), and (u, v) of tens
    of m/yr, all on the card in `dtype`."""
    from ufemism2_tpu_torch.ops.cuda_bpa import BpaCoeffs
    n = md.nTri
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    dzeta = 1.0 / (nz - 1)
    H = 500.0 + 1000.0 * rng.random(n)
    zz = -1.0 / H
    slope = 1e-2 * rng.standard_normal((n, 1))
    eta = 10.0 ** (13.0 + rng.random((n, nz)))
    qfac = 2.0 / dzeta ** 2 * zz ** 2
    eta_z = 1e-2 * eta * rng.standard_normal((n, nz))
    c = BpaCoeffs(
        zx=t(slope + 1e-3 * rng.standard_normal((n, nz))),
        zy=t(-slope + 1e-3 * rng.standard_normal((n, nz))),
        eta=t(eta), eta_x=t(1e-3 * eta * rng.standard_normal((n, nz))),
        eta_y=t(1e-3 * eta * rng.standard_normal((n, nz))), eta_z=t(eta_z),
        zz=t(zz), zz2=t(zz ** 2), dh_dx=t(1e-2 * rng.standard_normal(n)),
        dh_dy=t(1e-2 * rng.standard_normal(n)),
        db_dx=t(5e-2 * rng.standard_normal(n)),
        db_dy=t(5e-2 * rng.standard_normal(n)), dzz=t(dzeta / zz),
        qfac=t(qfac), qb=t(qfac * eta[:, -1]),
        rb=t(2 * eta[:, -1] / dzeta * zz + eta_z[:, -1]),
        ratio=t(1e3 * rng.random(n) / eta[:, -1]))
    uv = [t(30.0 * rng.standard_normal((n, nz))) for _ in range(2)]
    return c, dzeta, uv


def bpa_bound(A):
    """(bytes, flops) that one apply of the BPA operator A needs: the index
    table and the two coefficient tables, u and v, the coefficient fields,
    the row codes and the neighbour tables of the lateral rows read once,
    Au and Av written once; some 20 K + 80 operations a row and layer."""
    n, nz, K = A.n, A.nz, A.stack.K
    size = A.stack.vals.element_size()
    n_bdry = int((~A.rows.free).sum())
    nbytes = (K * n * 4 + 2 * K * n * size + 2 * n * nz * size
              + 6 * n * nz * size + 11 * n * size + n + n_bdry * 12
              + 2 * n * nz * size)
    return nbytes, n * nz * (20 * K + 80)


def bpa_check(name, A, x):
    """The kernel behind the BPA operator A (a BpaOperator on the card)
    against its plain version on the flat operand x, to the bit, with its
    times and bound."""
    from ufemism2_tpu_torch.ops import cuda_bpa
    n, nz = A.n, A.nz
    m = n * nz
    dtype = x.dtype
    uv = (x[:m].view(n, nz), x[m:].view(n, nz))
    n0 = cuda_bpa.launches
    y = A.flat(x)
    yu, yv = A(uv)
    torch.cuda.synchronize()
    assert cuda_bpa.launches == n0 + 4
    assert torch.equal(torch.cat([yu.reshape(-1), yv.reshape(-1)]), y)
    ref = torch.cat([t.reshape(-1) for t in A.plain(*uv)])
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(y, ref))
    err = float((y - ref).abs().max())
    ok = bit_equal and bool(torch.isfinite(y).all())
    ms = time_ms(lambda: A.flat(x), REPS)
    n1 = cuda_bpa.launches
    device_ms = graph_ms(lambda: A.flat(x), REPS)
    assert cuda_bpa.launches == n1 + 2 * (REPS + 3)
    n1 = cuda_bpa.launches
    cold_ms, flush_ms = graph_ms_cold(lambda: A.flat(x), REPS)
    assert cuda_bpa.launches == n1 + 2 * (REPS + 3)
    plain_ms = time_ms(lambda: A.plain(*uv), 5, 2)
    nbytes, flops = bpa_bound(A)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[dtype] * 1e3
    bound_ms = max(t_bytes, t_flops)
    out = dict(case=name, n_rows=n, nz=nz, K=A.stack.K,
               boundary_rows=int((~A.rows.free).sum()),
               dtype=str(dtype).replace("torch.", ""), round_x_bf16=A.round,
               no_sliding=A.no_sliding, bit_equal=bit_equal,
               max_abs_err=err, max_abs_y=float(ref.abs().max()), ms=ms,
               device_ms=device_ms, device_ms_cold=cold_ms,
               flush_ms=flush_ms, plain_ms=plain_ms, library_ms=None,
               bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               share_of_bound=bound_ms / device_ms,
               share_of_bound_cold=bound_ms / cold_ms, ok=ok)
    say("bpa_case", **out)
    if not ok:
        raise SystemExit(f"bpa_apply disagrees with its plain version in "
                         f"case {name}: max err {err:.3e}")
    return out


def thomas_check(name, M, r):
    """The kernel behind the line preconditioner M (a LineThomas on the
    card) against its plain version on the flat operand r, to the bit,
    with its times, bound and the library yardstick (one batched dense
    torch.linalg.solve of the same systems for both right-hand sides)."""
    from ufemism2_tpu_torch.ops import cuda_bpa
    n, nz = M.n, M.nz
    m = n * nz
    dtype = r.dtype
    rr = (r[:m].view(n, nz), r[m:].view(n, nz))
    n0 = cuda_bpa.thomas_launches
    x = M.flat(r)
    xu, xv = M(rr)
    torch.cuda.synchronize()
    assert cuda_bpa.thomas_launches == n0 + 2
    assert torch.equal(torch.cat([xu.reshape(-1), xv.reshape(-1)]), x)
    ref = torch.cat([t.reshape(-1) for t in M.plain(*rr)])
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(x, ref))
    err = float((x - ref).abs().max())
    ok = bit_equal and bool(torch.isfinite(x).all())
    ms = time_ms(lambda: M.flat(r), REPS)
    n1 = cuda_bpa.thomas_launches
    device_ms = graph_ms(lambda: M.flat(r), REPS)
    assert cuda_bpa.thomas_launches == n1 + REPS + 3
    n1 = cuda_bpa.thomas_launches
    cold_ms, flush_ms = graph_ms_cold(lambda: M.flat(r), REPS)
    assert cuda_bpa.thomas_launches == n1 + REPS + 3
    plain_ms = time_ms(lambda: M.plain(*rr), 5, 2)
    dense = (torch.diag_embed(M.dia) + torch.diag_embed(M.sup, 1)
             + torch.diag_embed(M.sub, -1))
    B = torch.stack(rr, dim=-1)
    lib_x = torch.linalg.solve(dense, B)
    lib_err = float((lib_x[..., 0].reshape(-1) - ref[:m]).abs().max())
    library_ms = time_ms(lambda: torch.linalg.solve(dense, B), 20, 5)
    size = r.element_size()
    nbytes = (2 * n * (nz - 1) + n * nz + 4 * n * nz) * size
    flops = 13 * n * nz
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[dtype] * 1e3
    bound_ms = max(t_bytes, t_flops)
    out = dict(case=name, n_columns=n, nz=nz,
               dtype=str(dtype).replace("torch.", ""), bit_equal=bit_equal,
               max_abs_err=err, max_abs_x=float(ref.abs().max()),
               library_max_abs_diff=lib_err, ms=ms, device_ms=device_ms,
               device_ms_cold=cold_ms, flush_ms=flush_ms,
               plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
               flops=flops, bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               share_of_bound=bound_ms / device_ms,
               share_of_bound_cold=bound_ms / cold_ms, ok=ok)
    say("thomas_case", **out)
    if not ok:
        raise SystemExit(f"line_thomas disagrees with its plain version in "
                         f"case {name}: max err {err:.3e}")
    return out


def off16(x):
    """A copy of the flat x one element into a larger buffer, so that it and
    both its halves lie off a 16-byte boundary (as the hybrid's 3-D slice
    of its Krylov vector does on a mesh of an odd number of triangles)."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y.copy_(x)
    m = x.numel() // 2
    assert y.data_ptr() % 16 and y[m:].data_ptr() % 16
    return y


def bpa_kernel_cases(md32, md64):
    """bpa_apply and line_thomas against their plain versions to the bit
    on the ISMIP-HOM mesh: f32 with and without the rounding of x, f64;
    with and without sliding; periodic (neighbour-mean) and mixed zero /
    infinite lateral rows; nz 12 and 7; f32 rounded and f64 also with the
    operands off a 16-byte boundary (the kernels' unaligned forms).
    Returns (bpa cases, thomas cases)."""
    from ufemism2_tpu_torch.ops.cuda_bpa import BpaOperator, LineThomas
    rng = np.random.default_rng(9)
    bpa_cases, thomas_cases = [], []
    for nz in (12, 7):
        for dtype, rnd in ((torch.float32, True), (torch.float32, False),
                           (torch.float64, False)):
            md = md32 if dtype == torch.float32 else md64
            c, dzeta, (u, v) = bpa_operands(md, nz, dtype, rng)
            x = torch.cat([u.reshape(-1), v.reshape(-1)])
            tag = f"nz{nz}_{str(dtype)[-7:]}{'_bf16x' if rnd else ''}"
            for rows_name, rows in (("periodic", md.x("bpa_rows")),
                                    ("mixed", bpa_rows_mixed(md))):
                for ns in (False, True):
                    if nz == 7 and (rows_name, ns) != ("mixed", False):
                        continue
                    A = BpaOperator(md.M2_stack.op, rows, c, dzeta, ns, rnd)
                    bpa_cases.append(bpa_check(
                        f"bpa_apply_{tag}_{rows_name}_"
                        f"{'no_slip' if ns else 'sliding'}", A, x))
            if rnd or dtype == torch.float64:
                bpa_cases.append(bpa_check(
                    f"bpa_apply_{tag}_mixed_"
                    f"{'no_slip' if A.no_sliding else 'sliding'}_off16", A,
                    off16(x)))
            if rnd:
                continue
            n = md.nTri
            t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
            sub = t(rng.standard_normal((n, nz - 1)) * 1e13)
            sup = t(rng.standard_normal((n, nz - 1)) * 1e13)
            dia = t(-(4.0 + rng.random((n, nz))) * 1e13)
            M = LineThomas(sub, dia, sup)
            r = t(rng.standard_normal(2 * n * nz) * 1e5)
            tag = f"line_thomas_nz{nz}_{str(dtype)[-7:]}"
            thomas_cases.append(thomas_check(tag, M, r))
            thomas_cases.append(thomas_check(f"{tag}_off16", M, off16(r)))
    return bpa_cases, thomas_cases


def profile_last_solve(gm, maxiter=180):
    """The last GMRES system of a run solved again for at most `maxiter`
    iterations under torch.profiler: device kernels and device time per
    Krylov iteration, the device's busy share of the wall."""
    from torch.profiler import profile, ProfilerActivity
    from ufemism2_tpu_torch.ops.krylov import gmres
    kw = dict(gm["kw"], maxiter=maxiter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmres(gm["A"], gm["b"], x0=gm["x0"], M=gm["M"], **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = gmres(gm["A"], gm["b"], x0=gm["x0"], M=gm["M"], **kw)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    busy_ms = sum(r[2] for r in rows)
    if busy_ms <= 0:
        raise SystemExit("profile: the profiler saw no device time")
    n_kernels = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[2])
    its = max(res.n_iter, 1)
    # the port's BPA kernels by name: their share of a Krylov iteration
    port = {}
    for name in ("bpa_first_kernel", "bpa_rows_kernel",
                 "line_thomas_kernel"):
        sel = [r for r in rows if name in r[0]]
        ms = sum(r[2] for r in sel)
        port[name] = dict(count=sum(r[1] for r in sel), ms=ms,
                          ms_per_krylov_it=ms / its,
                          share_of_device=ms / busy_ms)
    return dict(krylov_its=res.n_iter, wall_ms=wall_ms,
                device_kernels=n_kernels,
                kernels_per_krylov_it=n_kernels / its,
                device_ms_per_krylov_it=busy_ms / its,
                wall_ms_per_krylov_it=wall_ms / its,
                device_busy_share=busy_ms / wall_ms, port_kernels=port,
                top=[{"kernel": k[:60], "count": c, "ms": ms}
                     for k, c, ms in rows[:6]])


def ismip_run(tag, cfg, mesh, device="cuda", module=None,
              program_dir=None):
    """One ISMIP-HOM run of the config dict `cfg`: ModelRegion on `device`
    (the initial solve), then run_to one ice step, or the same through
    program.main on the config written as a .cfg into program_dir; the
    GMRES calls of `module` (default bpa) and every kernel counted.
    Returns (region, numbers, the GMRES record, u_surf on the transect)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice import bpa
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.main import program
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with counted_gmres(module or bpa) as gm:
        zero_counts()
        t0 = time.perf_counter()
        init = None
        if program_dir is None:
            region = ModelRegion(Config(**cfg), "ANT", mesh=mesh,
                                 device=device)
            sync()
            init = dict(seconds=time.perf_counter() - t0,
                        visc=gm["calls"], its=gm["its"])
            region.run_to(IH_T_END)
        else:
            os.makedirs(program_dir, exist_ok=True)
            path = write_namelist(os.path.join(program_dir, f"{tag}.cfg"),
                                  cfg)
            with contextlib.redirect_stdout(sys.stderr):
                region = program.main([path, "--output-dir", os.path.join(
                    program_dir, "out"), "--device", device])["ANT"]
        sync()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
    s = region.state
    u_surf = ismip_u_surf(region.mesh, s.u_3D_b)
    its = gm["its"]
    out = dict(nV=region.mesh.nV, nTri=region.mesh.nTri,
               precision=region.C.tpu_precision,
               approximation=region.C.choice_stress_balance_approximation,
               steps=region.n_dt_ice, wall_s=wall_s, initial_solve=init,
               n_visc_its=s.n_visc_its, n_Axb_its=s.n_Axb_its,
               gmres_calls=gm["calls"], gmres_its=its,
               gmres_unconverged=gm["unconverged"],
               ms_per_krylov_it=wall_s * 1e3 / max(its, 1),
               u_surf_min=float(u_surf.min()), u_surf_max=float(u_surf.max()),
               u_surf_mean=float(u_surf.mean()), **counts)
    return region, out, gm, u_surf


def ismip_phase(tag, cfg, mesh, module=None, program_dir=None):
    """An ISMIP-HOM configuration on the card, held to its launch counts:
    bpa_apply twice per operator apply (GMRES applies its operator once per
    counted iteration and once more per solve), line_thomas once per
    preconditioner apply (once per counted iteration and twice more per
    solve) with the line preconditioner alone; finite fields."""
    region, out, gm, u_surf = ismip_run(tag, cfg, mesh, module=module,
                                        program_dir=program_dir)
    C = region.C
    out.update(jax_scoreboard_L020=IH_SCOREBOARD_L020)
    say(tag, **out)
    check_state(region.state, "cuda")
    assert np.isfinite(u_surf).all() and np.abs(u_surf).max() > 0.01
    calls, its = gm["calls"], gm["its"]
    assert calls > 0 and its > 0 and region.n_dt_ice == 1
    approx = C.choice_stress_balance_approximation
    if approx in ("BPA", "hybrid DIVA/BPA"):
        assert out["bpa_apply_launches"] == 2 * (its + calls), out
    if approx == "BPA" and C.tpu_stress_balance_precond == "block_jacobi":
        assert out["line_thomas_launches"] == its + 2 * calls, out
    return region, out, gm, u_surf


def small_ismip_snapshot(workdir, snapshot_path):
    """SMALL_ISMIP's three cases on the CPU (plain versions): counts and
    fields saved to snapshot_path (small_ismip_phase runs this in a
    process of its own)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice import bpa, hybrid
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    mask = write_bpa_mask(os.path.join(workdir, "mask_small.nc"), 80e3)
    snap = {}
    mesh = None
    for name, kw in SMALL_ISMIP.items():
        kw = dict(kw, filename_hybrid_DIVA_BPA_mask_ANT=mask)
        mesh = mesh or build_mesh_from_config(Config(**kw), "ANT")
        t0 = time.perf_counter()
        r, out, _, _ = ismip_run(name, kw, mesh, device="cpu",
                                 module=hybrid if "hybrid" in name else bpa)
        snap[name] = dict(n_visc_its=out["n_visc_its"],
                          n_Axb_its=out["n_Axb_its"],
                          gmres_its=out["gmres_its"],
                          u_3D_b=r.state.u_3D_b.numpy(),
                          v_3D_b=r.state.v_3D_b.numpy(),
                          Hi=r.state.Hi.numpy(),
                          seconds=time.perf_counter() - t0)
    torch.save(snap, snapshot_path)


def start_small_ismip_cpu(workdir):
    d = os.path.join(workdir, "small_ismip")
    os.makedirs(d, exist_ok=True)
    out = os.path.join(d, "cpu.pt")
    return start_cpu_job("small_ismip_snapshot", d, out), out


def small_ismip_phase(workdir, cpu_job):
    """SMALL_ISMIP on the card and on the CPU (cpu_job): equal viscosity
    and Krylov iteration counts, fields within small_phase's gaps."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice import bpa, hybrid
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    d = os.path.join(workdir, "small_ismip")
    cpu, cpu_out = cpu_job
    mask = write_bpa_mask(os.path.join(d, "mask_small_card.nc"), 80e3)
    card, mesh = {}, None
    try:
        for name, kw in SMALL_ISMIP.items():
            kw = dict(kw, filename_hybrid_DIVA_BPA_mask_ANT=mask)
            mesh = mesh or build_mesh_from_config(Config(**kw), "ANT")
            r, out, _, _ = ismip_run(name, kw, mesh, module=hybrid
                                     if "hybrid" in name else bpa)
            card[name] = (r, out)
        snap, cpu_wait_s = finish_cpu_job(cpu, cpu_out, "small_ismip")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    res = {}
    for name, (r, out) in card.items():
        sc = snap[name]
        gaps = {}
        for k in ("u_3D_b", "v_3D_b", "Hi"):
            a, b = sc[k], getattr(r.state, k).cpu().numpy()
            gaps[k] = float(np.abs(a - b).max() / max(np.abs(a).max(),
                                                      1e-300))
        res[name] = dict(n_visc_its=[sc["n_visc_its"], out["n_visc_its"]],
                         n_Axb_its=[sc["n_Axb_its"], out["n_Axb_its"]],
                         gmres_its=[sc["gmres_its"], out["gmres_its"]],
                         rel_gap=gaps, seconds_cpu=sc["seconds"],
                         seconds_card=out["wall_s"],
                         bpa_apply_launches=out["bpa_apply_launches"],
                         line_thomas_launches=out["line_thomas_launches"])
    say("small_ismip", nV=mesh.nV, nTri=mesh.nTri, cpu_wait_s=cpu_wait_s,
        cases=res)
    for name, c in res.items():
        assert c["n_visc_its"][0] == c["n_visc_its"][1], (name, c)
        assert c["n_Axb_its"][0] == c["n_Axb_its"][1], (name, c)
        assert c["gmres_its"][0] == c["gmres_its"][1], (name, c)
        assert c["rel_gap"]["Hi"] < 1e-6 and c["rel_gap"]["u_3D_b"] < 1e-5 \
            and c["rel_gap"]["v_3D_b"] < 1e-5, (name, c)
        assert c["bpa_apply_launches"] > 0
    return res


def ismip_hom_phases(mesh_ih, workdir, cpu_job):
    """The slice's phases: ismip_hom_a_bpa (f32 through the region and
    through program.main, f64), ismip_hom_c_bpa, ismip_hom_a_hybrid with
    DIVA on the same stand-in (the harness's crosscheck), then
    small_ismip; returns (launches by path, the last BPA operator and
    preconditioner of ismip_hom_a_bpa with the operands of their last
    calls, the ISMIP numbers)."""
    from ufemism2_tpu_torch.core.ice import bpa, hybrid, ssadiva
    nums = {}
    # experiment A, BPA, f32: the region, then program.main on a .cfg
    r_a, nums["ismip_hom_a_bpa"], gm_a, u_a = ismip_phase(
        "ismip_hom_a_bpa", ISMIP_A, mesh_ih)
    last = dict(A=gm_a["A"], M=gm_a["M"], x=gm_a["x"], b=gm_a["b"])
    prof = profile_last_solve(gm_a)
    nums["ismip_hom_a_bpa"]["profile_last_solve"] = prof
    say("ismip_hom_a_bpa_profile", **prof)
    _, p_a, _, u_p = ismip_phase(
        "ismip_hom_a_bpa_program", ISMIP_A, mesh_ih,
        program_dir=os.path.join(workdir, "ismip_hom_a_program"))
    nums["ismip_hom_a_bpa_program"] = p_a
    # the same code on the same card and data: the same trajectory
    assert (p_a["n_visc_its"], p_a["n_Axb_its"]) == (
        nums["ismip_hom_a_bpa"]["n_visc_its"],
        nums["ismip_hom_a_bpa"]["n_Axb_its"]), p_a
    _, nums["ismip_hom_a_bpa_f64"], _, _ = ismip_phase(
        "ismip_hom_a_bpa_f64", dict(ISMIP_A, tpu_precision="f64"), mesh_ih)
    # the same experiment on a 2 km mesh: the resolution at which the
    # viscosity loop's GMRES solves converge (PERF.md, section 7)
    _, nums["ismip_hom_a_bpa_2km"], _, _ = ismip_phase(
        "ismip_hom_a_bpa_2km", ISMIP_A_2KM, None)
    _, nums["ismip_hom_c_bpa"], _, _ = ismip_phase(
        "ismip_hom_c_bpa", ISMIP_C, mesh_ih)
    mask = write_bpa_mask(os.path.join(workdir, "mask_BPA.nc"), IH_L)
    _, nums["ismip_hom_a_hybrid"], gm_h, u_h = ismip_phase(
        "ismip_hom_a_hybrid", dict(ISMIP_A_HYBRID,
                                   filename_hybrid_DIVA_BPA_mask_ANT=mask),
        mesh_ih, module=hybrid)
    prof_h = profile_last_solve(gm_h)
    nums["ismip_hom_a_hybrid"]["profile_last_solve"] = prof_h
    say("ismip_hom_a_hybrid_profile", **prof_h)
    _, nums["ismip_hom_a_diva"], _, u_d = ismip_phase(
        "ismip_hom_a_diva", ISMIP_A_DIVA, mesh_ih, module=ssadiva)
    rmse = lambda u: float(np.sqrt(((u - u_a) ** 2).mean()))
    say("ismip_hom_crosscheck", rmse_DIVA_vs_BPA=rmse(u_d),
        rmse_hybrid_vs_BPA=rmse(u_h))
    nums["small_ismip"] = small_ismip_phase(workdir, cpu_job)
    return nums, last


def bpa_slice_start():
    """The ISMIP-HOM stand-in's mesh on the host (its MeshData in f32 and
    f64 on the card) and bpa_kernel_cases on it."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice.bpa import register_bpa_static
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    C = Config(**ISMIP_A)
    t0 = time.perf_counter()
    mesh = build_mesh_from_config(C, "ANT")
    mds = [build_mesh_data(mesh, dtype=dt, device="cuda")
           for dt in (torch.float32, torch.float64)]
    for md in mds:
        register_bpa_static(C, mesh, md)
    say("ismip_hom_mesh", nV=mesh.nV, nTri=mesh.nTri, L_m=IH_L,
        resolution_m=IH_L / 40, nz=C.nz, K_M2=mds[0].M2_stack.K,
        seconds=time.perf_counter() - t0)
    bpa_cases, thomas_cases = bpa_kernel_cases(*mds)
    return dict(mesh=mesh, bpa_cases=bpa_cases, thomas_cases=thomas_cases)


def bpa_slice_finish(ih, workdir):
    """The ISMIP-HOM phases, then bpa_apply and line_thomas on the last
    operator and preconditioner of ismip_hom_a_bpa; returns (the phases'
    numbers, the two kernels' entries of the kernels line)."""
    cpu_job = start_small_ismip_cpu(workdir)
    try:
        nums, last = ismip_hom_phases(ih["mesh"], workdir, cpu_job)
    finally:
        if cpu_job[0].poll() is None:
            cpu_job[0].kill()
            cpu_job[0].wait()
    A, M = last["A"], last["M"]
    x = torch.cat([t.reshape(-1) for t in last["x"]])
    hot_bpa = bpa_check("bpa_apply_ismip_hom_a_last_apply", A, x)
    r = torch.cat([t.reshape(-1) for t in last["b"]]) - A.flat(x)
    hot_th = thomas_check("line_thomas_ismip_hom_a_last_apply", M, r)
    paths = ("ismip_hom_a_bpa", "ismip_hom_a_bpa_program",
             "ismip_hom_a_bpa_f64", "ismip_hom_c_bpa", "ismip_hom_a_hybrid")

    def by_path(key):
        out = {p: nums[p][key] for p in paths}
        out.update({f"small_ismip_{k}": v[key]
                    for k, v in nums["small_ismip"].items()})
        return out

    def entry(name, hot, cases, replaces, key):
        return {"name": name, "route": "cuda",
                "source": "ufemism2_tpu_torch/csrc/bpa.cu",
                "replaces": replaces,
                "replaces_kind": "XLA-lowered code, no pallas_call",
                "launches": nums["ismip_hom_a_bpa"][key],
                "launches_by_path": by_path(key),
                "max_abs_err": hot["max_abs_err"], "ms": hot["ms"],
                "device_ms": hot["device_ms"],
                "device_ms_cold": hot["device_ms_cold"],
                "share_of_bound": hot["share_of_bound"],
                "plain_ms": hot["plain_ms"],
                "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
                "library_ms": hot["library_ms"], "timed_case": hot["case"],
                "cases": cases + [hot]}
    return nums, [
        entry("bpa_apply", hot_bpa, ih["bpa_cases"],
              "ufemism2_tpu/core/ice/bpa.py:208", "bpa_apply_launches"),
        entry("line_thomas", hot_th, ih["thomas_cases"],
              "ufemism2_tpu/core/ice/bpa.py:299", "line_thomas_launches")]


def antarctica_phases(workdir, years=ANT_INIT_YEARS):
    """antarctica_init (its window `years` model years), antarctica_itm and
    small_climate, with the CPU's small_climate runs going on beside the
    card's from the start; the synthetic data written by the port's writer
    into workdir. Returns (init numbers, itm numbers, kernel cases of
    each)."""
    from ufemism2_tpu_torch.tools.antarctica_synthetic import write_all
    t0 = time.perf_counter()
    files = write_all(os.path.join(workdir, "ant20"), ANT_DX)
    small = write_all(os.path.join(workdir, "ant80"), SMALL_CLIMATE_DX)
    say("antarctica_data", seconds=time.perf_counter() - t0,
        grid_km=[ANT_DX / 1e3, SMALL_CLIMATE_DX / 1e3],
        files=sorted(files))
    cpu_out = os.path.join(workdir, "small_climate_cpu.pt")
    proc = start_cpu_job("cpu_small_climate",
                         os.path.join(workdir, "ant80"), cpu_out)
    try:
        ant_init, restart, init_cases = antarctica_init_phase(
            files, workdir, years)
        ant_itm, itm_cases = antarctica_itm_phase(
            files, restart, check_pins=years == ANT_INIT_YEARS)
        small_climate_phase(small, (proc, cpu_out))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ant_hydro = antarctica_hydro_phase(files, restart, workdir,
                                       check_pins=years == ANT_INIT_YEARS)
    return ant_init, ant_itm, (init_cases, itm_cases), (ant_hydro, small)


def start_card_job(fn, *args):
    """chip_smoke.<fn>(*args) in a process of its own on the card, in a
    session of its own (stop_card_job ends it and every process it
    started): its result lines go to standard output on this process's
    clock, each with the job's name (`job`), so that phases whose runs
    are host-bound go on beside this process's. Returns the process."""
    t0_epoch = time.time() - (time.perf_counter() - _T0)
    return subprocess.Popen(
        [sys.executable, "-c", "import importlib.util, sys; "
         "spec = importlib.util.spec_from_file_location('chip_smoke', "
         "sys.argv[1]); m = importlib.util.module_from_spec(spec); "
         "spec.loader.exec_module(m); m.card_job(*sys.argv[2:])",
         os.path.abspath(__file__), fn, repr(t0_epoch), *args],
        stdout=sys.stdout, stderr=sys.stderr, start_new_session=True)


def card_job(fn, t0_epoch, *args):
    """The body of a start_card_job process: the parent's clock, the
    libraries the parent built, then fn(*args)."""
    global _T0, _JOB
    _T0 = time.perf_counter() - (time.time() - float(t0_epoch))
    _JOB = fn
    from ufemism2_tpu_torch.ops import (cuda_bpa, cuda_heat, cuda_laddie,
                                        cuda_spmv)
    for m in (cuda_spmv, cuda_heat, cuda_bpa, cuda_laddie):
        m.load_kernels()
    say("job_start", pid=os.getpid())
    globals()[fn](*args)


def stop_card_job(proc):
    """Kill a start_card_job process and its session if it still runs (a
    job that ends stops the processes it started itself)."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()


def finish_card_job(proc, path, what, timeout=1200):
    """Wait for a start_card_job process; its saved result and the wait."""
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        stop_card_job(proc)
    assert rc == 0, f"the card job {what} failed (exit code {rc})"
    # a file this script's own child process wrote
    return torch.load(path, weights_only=False), time.perf_counter() - t0


def antarctica_laddie_job(workdir, out_path, years=repr(ANT_INIT_YEARS)):
    """antarctica_phases (antarctica_init's window `years`), then
    laddie_phases on their 80 km data, as a card job (the whole run starts
    it with phase 10, so that these host-bound runs go on beside phases
    10-25), both results saved to out_path. Two torch threads: the host's
    cores are shared with the phases beside it."""
    torch.set_num_threads(2)
    ant = antarctica_phases(workdir, float(years))
    torch.save((ant, laddie_phases(workdir, ant[3][1])), out_path)


def ant_launches(ant_init, ant_itm, key):
    """launches_by_path entries of the two Antarctica phases."""
    return {"antarctica_init": ant_init["launches"][key],
            "antarctica_itm": ant_itm["launches"][key]}


# -- the LADDIE slice: the plume and its kernel, Salle2025 hydrology, the
# tracers and the regions of interest ----------------------------------------

LADDIE_REPS = 100       # eager and graph-replay timings of a stage
LADDIE_PLAIN_REPS = 5   # the plain stage: some 300 eager launches a call
LADDIE_LEG_STEPS = 100  # the leg held kernel against plain
ROIS = "Pine_Island_Glacier,Thwaites_Glacier"


@contextlib.contextmanager
def record_laddie_legs():
    """Within the block, the list it yields gets the operands (tables,
    params, scheme, state, masks, forcing, n_steps) of every laddie_leg
    call (make_laddie_step's `leg` calls the module's function)."""
    from ufemism2_tpu_torch.ops import cuda_laddie
    legs, inner = [], cuda_laddie.laddie_leg

    def recorded(*a):
        legs.append(a)
        return inner(*a)
    cuda_laddie.laddie_leg = recorded
    try:
        yield legs
    finally:
        cuda_laddie.laddie_leg = inner


def last_stage_operands(leg):
    """(tables, params, old, ref, masks, forcing) of the last stage of an
    fbrk3 leg, as the stage entry would have been called: the leg less its
    last step by the leg entry, then that step's first two stages by the
    stage entry (the leg entry runs no stage call of its own)."""
    from ufemism2_tpu_torch.ops import cuda_laddie as cl
    tab, P, sch, state, lm, fc, n = leg
    assert sch.kind == "fbrk3"
    now = cl.laddie_leg(tab, P, sch, state, lm, fc, n - 1)[0] if n > 1 \
        else state
    st = now
    for dt_i, visc, kind, coefs in sch.stages()[:2]:
        st = cl.laddie_stage(tab, P, st, st, lm, fc, dt_i, visc,
                             (kind, coefs, now.H))[0]
    return tab, P, st, st, lm, fc


def laddie_retype(tab, lm, fc, states, dtype):
    """A stage's operands in another floating type (the tables, the forcing
    and the states cast; the masks and index tables as they are)."""
    import dataclasses
    from ufemism2_tpu_torch.ops.cuda_laddie import _Ell
    cast = lambda t: t.to(dtype) if torch.is_floating_point(t) else t
    kw = {}
    for f in dataclasses.fields(tab):
        v = getattr(tab, f.name)
        if isinstance(v, _Ell):
            v = _Ell(v.cols, v.idx, v.vals.to(dtype))
        elif isinstance(v, torch.Tensor):
            v = cast(v)
        elif f.name in ("desc",):
            v = None
        elif f.name == "consts":
            v = {}
        kw[f.name] = v
    fc2 = {k: cast(v) if isinstance(v, torch.Tensor) else v
           for k, v in fc.items()}
    return (type(tab)(**kw), lm, fc2,
            [type(s)(*(cast(t).contiguous() for t in s)) for s in states])


def laddie_bytes(tab, fc, post, visc):
    """The bytes one stage must move: every table, mask, forcing field and
    state read once, every output written once. An ELL row counts its
    length and the entries the kernel reads: its stored ones and, where
    the row is padded, one padding entry (the rest add nothing)."""
    nV, nTri = tab.nV, tab.nTri
    size = tab.LcA.element_size()
    Kc = tab.C.shape[1]
    nE = tab.EV.shape[0]
    nd = fc["z_ocean"].shape[0]
    ell = 0
    for pre, M in (("ba", tab.M_map_b_a), ("ab", tab.M_map_a_b),
                   ("dx", tab.M_ddx_a_b), ("dy", tab.M_ddy_a_b)):
        m = tab.k32[f"{pre}_len"]
        read = int(m.sum()) + int((m < M.cols.shape[0]).sum())
        ell += read * (4 + size) + m.numel() * 4
    tables = (2 * nV * Kc * 4 + 3 * nV * Kc * size + nTri * 3 * 4 * 3
              + nE * 2 * 4 * 2 + nTri * 3 * size * 4 + 2 * nTri * size + ell)
    masks = 3 * nV + 3 * nTri
    forcing = 3 * nV * size + 2 * nTri * size + nd * size \
        + 2 * nV * nd * size
    states = 2 * (3 * nV + 2 * nTri) * size + nV * size
    kind = None if post is None else post[0]
    outs = (4 + 10) * nV * size + 2 * nTri * size \
        + (nV * size if kind in ("blend", "blend3") else 0) \
        + ((3 * nV + 2 * nTri) * size if kind == "lfra" else 0)
    return tables + masks + forcing + states + outs


def laddie_equal(a, b):
    """(bit-equal, max |a - b|) of two tensors (NaN where both are NaN
    counts as equal)."""
    same = (a == b) | (a.isnan() & b.isnan())
    d = (a.double() - b.double()).abs()
    d = torch.where(same, 0.0, d)
    return bool(same.all()), float(d.max()) if d.numel() else 0.0


def laddie_case(name, tab, P, old, ref, lm, fc, dt_i, visc, post):
    """laddie_stage against laddie_stage_plain on the same operands on the
    card: every output compared to the bit; the eager and the graph-replay
    (device) time of a stage, the plain version's and the bound."""
    from ufemism2_tpu_torch.ops import cuda_laddie as cl
    args = (tab, P, old, ref, lm, fc, dt_i, visc, post)
    k_state, k_filt, k_ph = cl.laddie_stage(*args)
    p_state, p_filt, p_ph = cl.laddie_stage_plain(*args)
    torch.cuda.synchronize()
    pairs = list(zip(k_state, p_state)) + [(k_ph[n], p_ph[n])
                                           for n in cl.PH_FIELDS]
    if k_filt is not None:
        pairs += list(zip(k_filt, p_filt))
    eq = [laddie_equal(a, b) for a, b in pairs]
    bit_equal = all(e for e, _ in eq)
    max_err = max(m for _, m in eq)
    ms = time_ms(lambda: cl.laddie_stage(*args), LADDIE_REPS, warm=10)
    device_ms = graph_ms(lambda: cl.laddie_stage(*args), LADDIE_REPS)
    plain_ms = time_ms(lambda: cl.laddie_stage_plain(*args),
                       LADDIE_PLAIN_REPS, warm=1)
    nbytes = laddie_bytes(tab, fc, post, visc)
    out = dict(case=name, nV=tab.nV, nTri=tab.nTri,
               dtype=str(ref.H.dtype)[6:],
               lanes=cl.row_lanes(tab, fc, ref.H.dtype),
               longest_ell_row=max(int(tab.k32[f"{p}_len"].max())
                                   for p in ("ba", "ab", "dx", "dy")),
               launches_a_stage=2,
               bit_equal=bit_equal, max_abs_err=max_err, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bytes=nbytes,
               bound_ms=nbytes / 3.35e12 * 1e3, bound_by="bytes",
               library_ms=None)
    say("laddie_case", **out)
    return out


def events_ms(fn):
    """The device time of fn() in ms (CUDA events around one call)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def plain_leg(tab, P, sch, state, lm, fc, n_steps):
    """The loop of plain stages over n_steps pseudo-steps on the card:
    one step captured in a CUDA graph and replayed, its inputs copied from
    its outputs between replays (the plain version's own kernels, without
    the host's launch cost of a few hundred eager operations a stage).
    (state, melt of the last stage)."""
    from ufemism2_tpu_torch.ops import cuda_laddie as cl
    from ufemism2_tpu_torch.ops.cuda_laddie import LaddieState
    now = LaddieState(*(t.clone() for t in state))
    nm1 = LaddieState(*(t.clone() for t in state))
    step = lambda: cl.laddie_step(tab, P, sch, (now, nm1), lm, fc,
                                  cl.laddie_stage_plain)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (out_now, out_nm1), ph = step()
    for _ in range(n_steps):
        graph.replay()
        for a, b in zip(now + nm1, out_now + out_nm1):
            a.copy_(b)
    return now, ph["melt"]


def laddie_leg_check(name, tab, P, sch, state, lm, fc, n_steps,
                     plain=True):
    """A leg of n_steps pseudo-steps three ways on the card: the leg entry
    (one cooperative launch), the stage entry's loop (laddie_step with
    laddie_stage) and, with `plain`, the loop of plain stages (plain_leg);
    the states and the last stage's melt bit-equal. The ms a pseudo-step
    of each (the plain loop's from its graph replay), the leg's grid, and
    the floor of its grid barriers alone on that grid (an empty persistent
    kernel, two a stage)."""
    from ufemism2_tpu_torch.ops import cuda_laddie as cl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = (state, state)
    for _ in range(n_steps):
        carry, ph = cl.laddie_step(tab, P, sch, carry, lm, fc,
                                   cl.laddie_stage)
    torch.cuda.synchronize()
    runs = {"stage": (carry[0], ph["melt"],
                      (time.perf_counter() - t0) * 1e3 / n_steps)}
    if plain:
        plain_ms, (p_state, p_melt) = events_ms(
            lambda: plain_leg(tab, P, sch, state, lm, fc, n_steps))
        runs["plain"] = (p_state, p_melt, plain_ms / n_steps)
    cl.laddie_leg(tab, P, sch, state, lm, fc, 2)          # warm
    leg_ms, (leg_state, leg_melt) = events_ms(
        lambda: cl.laddie_leg(tab, P, sch, state, lm, fc, n_steps))
    grid = cl.last_leg_grid
    floor_ms, _ = events_ms(lambda: cl.leg_barriers(
        tab, P, sch, state, lm, fc, n_steps))
    ref_state, ref_melt, _ = runs["plain" if plain else "stage"]
    eq = [laddie_equal(a, b) for a, b in
          list(zip(leg_state, ref_state)) + [(leg_melt, ref_melt)]]
    if plain:
        eq += [laddie_equal(a, b) for a, b in
               list(zip(runs["stage"][0], ref_state))
               + [(runs["stage"][1], ref_melt)]]
    n_stages = len(sch.stages())
    out = dict(case=name, nV=tab.nV, nTri=tab.nTri,
               dtype=str(state.H.dtype)[6:], scheme=sch.kind,
               lanes=cl.row_lanes(tab, fc, state.H.dtype),
               beta=list(sch.beta), steps=n_steps,
               bit_equal=all(e for e, _ in eq),
               max_abs_err=max(m for _, m in eq),
               leg_ms_a_step=leg_ms / n_steps,
               leg_ms_a_stage=leg_ms / n_steps / n_stages,
               stage_entry_ms_a_step=runs["stage"][2],
               plain_ms_a_step=runs["plain"][2] if plain else None,
               grid_blocks=grid,
               barrier_floor_ms_a_step=floor_ms / n_steps,
               bytes_bound_ms_a_step=n_stages * laddie_bytes(
                   tab, fc, sch.stages()[-1][2:], True) / 3.35e12 * 1e3)
    say("laddie_leg", **out)
    return out


def laddie_kernel_cases(legs, md_io, C_io, standalone):
    """The laddie_kernel phase: laddie_stage against its plain version on
    the operands of the iceocean1r path's last stage (its compact shelf
    mesh, f32; `legs` are its recorded legs) and of the 2 km standalone
    set-up (f64), in f32 and f64, for fbrk3's first and third stage with
    the default and a non-zero beta, euler, lfra, Jenkins1991 gamma with
    the ice temperature, and the idealised subglacial discharge; then the
    leg entry against the stage entry's loop and the plain loop over
    LADDIE_LEG_STEPS on both meshes, f32 and f64, for fbrk3 with the
    default and a non-zero beta, euler and lfra; and the leg entry against
    the stage entry over the whole initial leg of the compact mesh."""
    from ufemism2_tpu_torch.ops.cuda_laddie import LaddieScheme, LaddieState
    tab0, P0, old0, ref0, lm0, fc0 = last_stage_operands(legs[-1])
    dt = C_io.dt_laddie
    cases = []

    def variants(tag, tab, lm, fc, ref, md_y):
        # a state away from the leg's: U, V and T perturbed, and an old
        # level of its own for lfra
        g = torch.Generator(device="cpu").manual_seed(3)
        noise = lambda t, s: t + s * torch.randn(
            t.shape, generator=g, dtype=torch.float64).to(t)
        ref = LaddieState(H=noise(ref.H, 0.5).abs() + 2.0,
                          U=noise(ref.U, 0.02), V=noise(ref.V, 0.02),
                          T=noise(ref.T, 0.05), S=noise(ref.S, 0.02))
        old = LaddieState(*(noise(t, 0.01) for t in ref))
        Pu = dataclasses_replace(P0, jenkins=False)
        Pj = dataclasses_replace(P0, jenkins=True)
        # the idealised discharge: 72 m^3/s over the shelf vertices of the
        # 5 km band on the channel's axis
        band = lm.a & (md_y.abs() < 2500.0)
        sgd = torch.where(band, 72.0 / max(int(band.sum()), 1)
                          / 1e6, 0.0).to(fc["Hib"])
        fc_ti = dict(fc, use_Ti=True,
                     Ti_base=torch.full_like(fc["Hib"], -18.0))
        fc_sgd = dict(fc_ti, SGD=sgd)
        b = (0.5, 0.5, 0.344)
        for name, P, o, f, dti, visc, post in (
                ("fbrk3_s1", Pu, ref, fc, dt / 3, False,
                 ("blend", (0.0, 1.0), ref.H)),
                ("fbrk3_s3", Pu, old, fc, dt, True,
                 ("blend3", (0.0, 1.0, 0.0), ref.H)),
                ("fbrk3_beta_s1", Pu, ref, fc, dt / 3, False,
                 ("blend", (b[0], 1 - b[0]), ref.H)),
                ("fbrk3_beta_s3", Pu, old, fc, dt, True,
                 ("blend3", (b[2], 1 - 2 * b[2], b[2]), ref.H)),
                ("euler", Pu, ref, fc, dt, True, None),
                ("lfra", Pu, old, fc, dt, True, ("lfra", 0.1)),
                ("jenkins_Ti", Pj, ref, fc_ti, dt, True, None),
                ("jenkins_Ti_sgd", Pj, ref, fc_sgd, dt, True, None)):
            cases.append(laddie_case(f"{tag}_{name}", tab, P, o, ref, lm,
                                     f, dti, visc, post))

    for dtype in (torch.float32, torch.float64):
        tab, lm, fc, (ref,) = laddie_retype(tab0, lm0, fc0, [ref0], dtype)
        y = md_io.V[:, 1].to(dtype)
        variants(f"iceocean1r_{str(dtype)[6:]}", tab, lm, fc, ref, y)
    C_sa, md_sa, lm_sa, fc_sa, st_sa, step_sa = standalone
    tab_sa = step_sa.tables
    for dtype in (torch.float64, torch.float32):
        tab, lm, fc, (ref,) = laddie_retype(tab_sa, lm_sa, fc_sa, [st_sa],
                                            dtype)
        variants(f"standalone2km_{str(dtype)[6:]}", tab, lm, fc, ref,
                 md_sa.V[:, 1].to(dtype))
    # the leg entry: every scheme on both meshes, f32 and f64
    base = LaddieScheme.from_config(C_io)
    schemes = (("fbrk3", base),
               ("fbrk3_beta", dataclasses_replace(base,
                                                  beta=(0.5, 0.5, 0.344))),
               ("euler", dataclasses_replace(base, kind="euler")),
               ("lfra", dataclasses_replace(base, kind="lfra")))
    steps = []
    for mesh_tag, (tab_m, lm_m, fc_m, st_m) in (
            ("iceocean1r", (tab0, lm0, fc0, LaddieState(*ref0))),
            ("standalone2km", (tab_sa, lm_sa, fc_sa, st_sa))):
        for dtype in (torch.float32, torch.float64):
            tab, lm, fc, (st,) = laddie_retype(tab_m, lm_m, fc_m, [st_m],
                                               dtype)
            for name, sch in schemes:
                if mesh_tag == "standalone2km":
                    sch = dataclasses_replace(sch, dt=C_sa.dt_laddie)
                steps.append(laddie_leg_check(
                    f"{mesh_tag}_{str(dtype)[6:]}_{name}", tab, P0, sch, st,
                    lm, fc, LADDIE_LEG_STEPS))
    # the whole initial leg of the compact mesh, leg entry against the
    # stage entry
    first = next(l for l in legs if l[6] == leg_steps_of(C_io, True))
    steps.append(laddie_leg_check("iceocean1r_initial_leg", *first,
                                  plain=False))
    bad = [c["case"] for c in cases + steps if not c["bit_equal"]]
    say("laddie_kernel", cases=len(cases), legs=len(steps),
        not_bit_equal=bad)
    assert not bad, f"laddie_stage differs from its plain version: {bad}"
    return cases, steps


def leg_steps_of(C, initial):
    """The pseudo-steps of the initial or of a later LADDIE leg of C."""
    from ufemism2_tpu_torch.models.laddie import leg_steps
    return leg_steps(C, C.time_duration_laddie_init if initial
                     else C.time_duration_laddie)


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


# tests/test_laddie.py's standalone configuration at 2 km, with the
# schema's dt_laddie (360 s) and 30-day initial leg, one output leg
LADDIE_STANDALONE = dict(
    choice_refgeo_init_ANT="idealised", choice_refgeo_PD_ANT="idealised",
    choice_refgeo_PD_idealised="MISMIPplus",
    choice_refgeo_init_idealised="MISMIPplus",
    refgeo_idealised_MISMIPplus_Hi_init=100.0,
    xmin_ANT=0.0, xmax_ANT=800e3, ymin_ANT=-40e3, ymax_ANT=40e3,
    maximum_resolution_uniform=2e3, nit_Lloyds_algorithm=1,
    choice_ocean_model_ANT="idealised",
    choice_ocean_model_idealised="MISMIPplus_WARM")


def standalone_operands():
    """The 2 km standalone set-up in this process (for the kernel cases):
    (C, md, LADDIE masks, forcing, initial plume state, step)."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.laddie_program import standalone_setup
    C = Config(**LADDIE_STANDALONE)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        mesh, md, _, lm, fc, step, st = standalone_setup(C, "ANT", "cuda")
    say("laddie_standalone_setup", nV=md.nV, nTri=md.nTri,
        shelf=int(lm.a.sum()), seconds=time.perf_counter() - t0)
    return C, md, lm, fc, st, step


def laddie_standalone_phase(workdir):
    """python -m ufemism2_tpu_torch laddie <cfg> on the card, in a process
    of its own: its wall, the shelf, ms a pseudo-step, the mean melt; both
    output files exist and their fields are finite."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    from ufemism2_tpu_torch.main.laddie_program import (MESH_FIELDS,
                                                        SCALAR_FIELDS)
    cfg = write_namelist(os.path.join(workdir, "laddie_2km.cfg"),
                         LADDIE_STANDALONE)
    out_dir = os.path.join(workdir, "laddie_2km")
    code = ("import json, sys, time; t0 = time.perf_counter(); "
            "from ufemism2_tpu_torch.main import program; "
            "from ufemism2_tpu_torch.main.laddie_program import "
            "run_laddie_standalone as r; "
            "from ufemism2_tpu_torch.ops import cuda_laddie; "
            "program.main(['laddie', sys.argv[1], '--output-dir', "
            "sys.argv[2]]); "
            "print('LADDIE_RESULT ' + json.dumps(dict(r.last, "
            "launches=cuda_laddie.launches, "
            "kernel_launches=cuda_laddie.kernel_launches, "
            "process_s=time.perf_counter() - t0)), flush=True)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, cfg, out_dir],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    assert proc.returncode == 0, "the standalone LADDIE run failed"
    line = [l for l in proc.stdout.splitlines()
            if l.startswith("LADDIE_RESULT ")][-1]
    res = json.loads(line.split(" ", 1)[1])
    files = {}
    for name, fields in (("laddie_output_fields_mesh.nc", MESH_FIELDS),
                         ("laddie_scalar_output.nc", SCALAR_FIELDS)):
        path = os.path.join(out_dir, name)
        with NCFile(path) as nc:
            frames = len(nc.read("time"))
            finite = all(np.isfinite(nc.read(f)).all() for f in fields)
        files[name] = dict(frames=frames, finite=finite)
    out = dict(nV=res["nV"], nTri=res["nTri"], shelf=res["shelf"],
               steps=res["steps"], leg_wall_s=res["wall_s"],
               ms_a_step=res["wall_s"] * 1e3 / res["steps"],
               mean_melt_m_yr=res["mean_melt"],
               laddie_stage_launches=res["launches"],
               laddie_kernel_launches=res["kernel_launches"],
               process_s=res["process_s"], subprocess_wall_s=wall,
               files=files)
    say("laddie_standalone", **out)
    assert res["shelf"] > 0 and res["mean_melt"] > 0.0
    assert res["launches"] >= 3 * res["steps"] - 3
    # each output leg one launch of the leg entry and its diagnostic step
    # two a stage
    assert res["kernel_launches"] == 7 * res["legs"], res
    assert all(f["frames"] >= 1 and f["finite"] for f in files.values())
    return out


def iceocean1r_phase(workdir):
    """MP_RESTART resumed under MP_ICEOCEAN1R on the card in f32 (the
    retreat leg's start-up, then IO_YEARS model years, one run_to a year):
    the counts, the yearly grounding line on the westeast transect, the
    integrated melt and the mean and max melt on the shelf, every LADDIE
    leg (wall, pseudo-steps, stages, kernel launches, the seconds of the
    compact mesh's rebuild before it, max |dH| of the plume, whether it was
    an initial leg), the launches of every kernel counted around the
    years. Returns (numbers, the recorded legs' operands, region)."""
    from ufemism2_tpu_torch.config import Config
    C = Config(**dict(MP_ICEOCEAN1R, tpu_precision="f32"))
    t_start = MP_ICEOCEAN1R["start_time_of_run"]
    out_dir = os.path.join(workdir, "iceocean1r_f32")
    with record_laddie_legs() as rec:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            r = resume_region(C, MP_RESTART, "cuda", out_dir)
        resume_s = time.perf_counter() - t0
        ice1r_start(r)
        n0 = r.n_dt_ice
        legs0 = len(r.run_bmb.legs)
        x_GL, melt, shelf = [x_GL_westeast(r)], [melt_m3_per_yr(r)], []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            for y in range(1, IO_YEARS + 1):
                r.run_to(t_start + y)
                x_GL.append(x_GL_westeast(r))
                melt.append(melt_m3_per_yr(r))
                fl = r._masks_fracs(r.state.Hi, r.state.Hb, r.state.SL)[0][
                    "mask_floating_ice"]
                m = -r.BMB[fl].double()
                shelf.append(dict(mean=float(m.mean()), max=float(m.max()),
                                  n=int(fl.sum())))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
    s = r.state
    legs = r.run_bmb.legs
    f32 = dict(
        steps=r.n_dt_ice - n0, n_visc_its=s.n_visc_its,
        n_Axb_its=s.n_Axb_its, wall_s=run_s, resume_s=resume_s,
        sim_yr_per_hr=IO_YEARS / run_s * 3600.0,
        x_GL_km=[x / 1e3 for x in x_GL], melt_m3_per_yr=melt,
        shelf_melt_m_yr=shelf,
        laddie_legs=[dict(l, ms_a_step=l["wall_s"] * 1e3 / l["steps"])
                     for l in legs],
        laddie_legs_wall_s=sum(l["wall_s"] for l in legs[legs0:]),
        compact_rebuild_s=[l["compact_rebuild_s"] for l in legs[legs0:]],
        legs_in_window=len(legs) - legs0,
        initial_legs=sum(l["initial"] for l in legs),
        n_mesh_updates=r.n_mesh_updates,
        remesh_reran_initial_leg=(r.n_mesh_updates > 0 and sum(
            l["initial"] for l in legs[legs0:]) > 0),
        plume_dH_max=[l["dH_max"] for l in legs],
        ice_volume_m3=float((s.Hi.double() * r.md.A.double()).sum()),
        nV=r.mesh.nV, compact_nV=legs[-1]["nV"], compact_nTri=legs[-1]["nTri"],
        **counts)
    check_state(s, "cuda")
    say("mismipplus_iceocean1r", restart=os.path.relpath(MP_RESTART),
        years=IO_YEARS, f32=f32)
    assert f32["steps"] >= IO_YEARS and f32["ice_volume_m3"] > 0.0
    assert counts["laddie_stage_launches"] > 0 \
        and counts["diva_apply_launches"] > 0, \
        "the iceocean1r path did not go through the kernels"
    assert counts["laddie_stage_launches"] == sum(
        l["stage_launches"] for l in legs[legs0:])
    # a leg is one kernel launch
    assert counts["laddie_kernel_launches"] == len(legs) - legs0 \
        and all(l["kernel_launches"] == 1 for l in legs), \
        "a LADDIE leg was not one launch of the leg entry"
    assert all(np.isfinite(x) for x in x_GL) and melt[-1] < 0.0
    got = (f32["steps"], f32["n_visc_its"], f32["n_Axb_its"])
    assert got == (IO_STEPS, IO_VISC_ITS, IO_AXB_ITS), \
        f"the f32 iceocean1r trajectory moved: {got}"
    return f32, rec, r


# MP_SMALL with the LADDIE melt under the ISOMIP+ WARM ocean and the
# idealised discharge on the channel's axis, in f64; a BMB event every
# coupling interval, the legs cut to 1 and 0.5 days (the CPU's plain stage
# would take minutes over the schema's 30 and 6)
SMALL_IO = dict(MP_SMALL, choice_BMB_model_ANT="laddie",
                choice_ocean_model_ANT="idealised",
                choice_ocean_model_idealised="ISOMIP",
                choice_ocean_isomip_scenario="WARM",
                choice_laddie_SGD="idealised",
                choice_laddie_SGD_idealised="MISMIPplus_PC",
                start_time_of_applying_SGD=-1e9, dt_ocean=0.1, dt_BMB=0.1,
                time_duration_laddie_init=1.0, time_duration_laddie=0.5,
                tpu_precision="f64")


def small_iceocean_run(workdir, dev):
    """SMALL_IO through program.main on `dev`: the region."""
    from ufemism2_tpu_torch.main import program
    cfg = write_namelist(os.path.join(workdir, f"small_iceocean_{dev}.cfg"),
                         SMALL_IO)
    with contextlib.redirect_stdout(sys.stderr):
        return program.main([cfg, "--output-dir", os.path.join(
            workdir, f"small_iceocean_{dev}"), "--device", dev])["ANT"]


def cpu_small_iceocean(workdir, out):
    """The CPU's SMALL_IO run (start_cpu_job, one thread: the compact
    shelf mesh's tensors are small), its numbers saved to `out`."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    r = small_iceocean_run(workdir, "cpu")
    s = r.state
    torch.save(dict(steps=r.n_dt_ice, n_visc_its=s.n_visc_its,
                    n_Axb_its=s.n_Axb_its, legs=len(r.run_bmb.legs),
                    Hi=s.Hi, u_vav_b=s.u_vav_b, v_vav_b=s.v_vav_b,
                    BMB=r.BMB, seconds=time.perf_counter() - t0), out)


def small_iceocean_phase(workdir, cpu_job):
    """SMALL_IO through program.main on the card, held to the same run on
    the CPU (cpu_job, from start_cpu_job: cpu_small_iceocean): the same
    steps and counts, small's gaps, the melt within 1e-10."""
    from ufemism2_tpu_torch.ops import cuda_laddie
    n0 = cuda_laddie.launches
    t0 = time.perf_counter()
    rg = small_iceocean_run(workdir, "cuda")
    t_card = time.perf_counter() - t0
    launches = cuda_laddie.launches - n0
    proc, out = cpu_job
    rc, cpu_wait_s = finish_cpu_job(proc, out, "small_iceocean")
    sg = rg.state
    gaps = {n: float((rc[n] - getattr(sg, n).cpu()).abs().max()
                     / rc[n].abs().max())
            for n in ("Hi", "u_vav_b", "v_vav_b")}
    bmb_gap = float((rc["BMB"] - rg.BMB.cpu()).abs().max()
                    / rc["BMB"].abs().max())
    out = dict(nV=rg.mesh.nV, steps=[rc["steps"], rg.n_dt_ice],
               n_visc_its=[rc["n_visc_its"], sg.n_visc_its],
               n_Axb_its=[rc["n_Axb_its"], sg.n_Axb_its], rel_gap=gaps,
               melt_rel_gap=bmb_gap, max_melt=float(-rg.BMB.min()),
               legs=[rc["legs"], len(rg.run_bmb.legs)],
               laddie_stage_launches_card=launches,
               seconds_cpu=rc["seconds"], seconds_card=t_card,
               cpu_wait_s=cpu_wait_s)
    say("small_iceocean", **out)
    assert launches > 0, "the card's run did not go through laddie_stage"
    assert rc["steps"] == rg.n_dt_ice >= 3
    assert rc["n_visc_its"] == sg.n_visc_its
    assert abs(rc["n_Axb_its"] - sg.n_Axb_its) <= 0.02 * rc["n_Axb_its"]
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps
    assert bmb_gap <= 1e-10 and out["max_melt"] > 0.0, bmb_gap
    return out


def small_hydro_cfg(files):
    """The coarse Antarctica of small_climate (the writer's 80 km data,
    600 km on grounded ice), f64, with Zoet-Iverson sliding on the
    Salle2025 effective pressure, the particles and the two regions of
    interest; every event every 0.2 years, the legs to 0.02 years."""
    return dict(
        choice_refgeo_init_ANT="read_from_file",
        choice_refgeo_PD_ANT="read_from_file",
        filename_refgeo_init_ANT=str(files["topo"]),
        filename_refgeo_PD_ANT=str(files["topo"]),
        xmin_ANT=-3040e3, xmax_ANT=3040e3, ymin_ANT=-3040e3, ymax_ANT=3040e3,
        choice_SMB_model_ANT="uniform", uniform_SMB=0.3,
        choice_BMB_model_ANT="uniform", uniform_BMB=0.0,
        choice_sliding_law="Zoet-Iverson",
        choice_basal_hydrology_model="Salle2025", dt_basal_hydro=0.2,
        basal_hydro_equil_time=0.02,
        choice_tracer_tracking_model="particles",
        tractrackpart_dt_coupling=0.2, choice_regions_of_interest=ROIS,
        choice_thermo_model="none", allow_mesh_updates=True,
        maximum_resolution_uniform=800e3,
        maximum_resolution_grounded_ice=600e3,
        maximum_resolution_floating_ice=1200e3,
        maximum_resolution_grounding_line=600e3, grounding_line_width=600e3,
        maximum_resolution_calving_front=1200e3,
        calving_front_width=1200e3,
        maximum_resolution_ice_front=1200e3, ice_front_width=1200e3,
        ROI_maximum_resolution_uniform=400e3,
        ROI_maximum_resolution_grounding_line=600e3,
        ROI_maximum_resolution_calving_front=1200e3,
        nit_Lloyds_algorithm=2, tpu_precision="f64", visc_it_nit=3,
        pc_nit_max=2, dt_output=0.2, start_time_of_run=0.0,
        end_time_of_run=1.0)


def small_hydro_phase(files, workdir):
    """small_hydro_cfg on the card and on the CPU, through a forced remesh:
    equal counts, the same sub-steps in every hydrology leg, N_til and
    W_til within 1e-10, the same live particles, the per-ROI scalars."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    C = Config(**small_hydro_cfg(files))
    runs = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            r = ModelRegion(C, "ANT", device=dev,
                            output_dir=os.path.join(workdir, f"hydro_{dev}"))
            r.run_to(0.2)
            r.run_to(0.4)
            r.update_mesh()
            r.run_to(0.6)
        runs[dev] = (r, time.perf_counter() - t0)
    (rc, tc), (rg, tg) = runs["cpu"], runs["cuda"]
    rel = lambda a, b: float((a.double().cpu() - b.double().cpu()).abs()
                             .max() / max(float(a.abs().max()), 1e-300))
    gaps = dict(Hi=rel(rc.state.Hi, rg.state.Hi),
                u_vav_b=rel(rc.state.u_vav_b, rg.state.u_vav_b),
                W_til=rel(rc.hydro_state.W_til, rg.hydro_state.W_til),
                N_til=rel(rc.md.x("hydro_N_eff"), rg.md.x("hydro_N_eff")),
                x=rel(rc.tracer_state.x, rg.tracer_state.x))
    roi = {k: [h[-1]["ice_volume"] for h in (rc.roi_history[k],
                                              rg.roi_history[k])]
           for k in rc.roi_history}
    roi_gap = max(abs(a - b) / max(abs(a), 1e-300) for a, b in roi.values())
    alive = [int(r.tracer_state.alive.sum()) for r in (rc, rg)]
    same_alive = bool((rc.tracer_state.alive
                       == rg.tracer_state.alive.cpu()).all())
    out = dict(nV=[rc.mesh.nV, rg.mesh.nV], steps=[rc.n_dt_ice, rg.n_dt_ice],
               n_visc_its=[rc.state.n_visc_its, rg.state.n_visc_its],
               n_Axb_its=[rc.state.n_Axb_its, rg.state.n_Axb_its],
               hydro_substeps=[rc.hydro_substeps, rg.hydro_substeps],
               rel_gap=gaps, alive=alive, same_alive=same_alive,
               roi_volume=roi, roi_rel_gap=roi_gap,
               seconds_cpu=tc, seconds_card=tg)
    say("small_hydro", **out)
    assert rc.n_dt_ice == rg.n_dt_ice and rc.n_mesh_updates == 1
    assert rc.state.n_visc_its == rg.state.n_visc_its
    assert abs(rc.state.n_Axb_its - rg.state.n_Axb_its) \
        <= 0.02 * rc.state.n_Axb_its
    assert rc.hydro_substeps == rg.hydro_substeps
    assert gaps["W_til"] <= 1e-10 and gaps["N_til"] <= 1e-10, gaps
    assert same_alive and alive[0] > 0 and gaps["x"] <= 1e-10, gaps
    assert roi_gap <= 1e-10 and all(v[0] > 0 for v in roi.values()), roi
    return out


ANT_HYDRO_YEARS = 1.0
# the f32 trajectory of antarctica_hydro on the card (steps, n_visc_its,
# n_Axb_its), fixed by the first run of the phase on an NVIDIA H100 80GB
# HBM3
ANT_HYDRO_PINS = (8, 225, 37228)


def antarctica_hydro_phase(files, restart, workdir, check_pins=True):
    """Resumed from antarctica_init's restart with the Salle2025 hydrology
    (a leg every model year), the particles (an event every model year)
    and the two regions' scalar files, ANT_HYDRO_YEARS in f32 at full
    width: the hydrology legs' sub-steps and wall, the live particles, the
    per-ROI volume, the counts pinned by ANT_HYDRO_PINS."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.io.output_files import mesh_from_restart
    from ufemism2_tpu_torch.io.ncio import NCFile
    from ufemism2_tpu_torch.main.region import ModelRegion
    with NCFile(restart) as nc:
        t0_run = float(np.asarray(nc.read("time")).reshape(-1)[-1])
    C = Config(**ant_init_cfg(
        files, choice_basal_hydrology_model="Salle2025", dt_basal_hydro=1.0,
        choice_tracer_tracking_model="particles",
        tractrackpart_dt_coupling=1.0, choice_regions_of_interest=ROIS,
        dt_output=0.5, start_time_of_run=t0_run,
        end_time_of_run=t0_run + 100.0))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        region = ModelRegion(C, "ANT", mesh=mesh_from_restart(restart, C),
                             output_dir=os.path.join(workdir, "ant_hydro"))
        region.resume_from_restart(restart)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    hydro_s = []
    inner = region._run_hydrology

    def timed(s, masks):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(s, masks)
        torch.cuda.synchronize()
        hydro_s.append(time.perf_counter() - t)
    region._run_hydrology = timed
    n0 = region.n_dt_ice
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        region.run_to(t0_run + ANT_HYDRO_YEARS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    s = region.state
    out = dict(nV=region.mesh.nV, steps=region.n_dt_ice - n0,
               n_visc_its=s.n_visc_its, n_Axb_its=s.n_Axb_its,
               resume_s=resume_s, wall_s=run_s,
               hydro_substeps=region.hydro_substeps, hydro_leg_s=hydro_s,
               N_til_mean=float(region.md.x("hydro_N_eff").double().mean()),
               W_til_max=float(region.hydro_state.W_til.max()),
               alive_particles=int(region.tracer_state.alive.sum()),
               roi_volume={k: [h["ice_volume"] for h in v]
                           for k, v in region.roi_history.items()},
               **counts)
    say("antarctica_hydro", **out)
    check_state(s, "cuda")
    assert len(region.hydro_substeps) >= 1 and out["alive_particles"] > 0
    assert all(v and v[-1] > 0.0 for v in out["roi_volume"].values())
    assert counts["diva_apply_launches"] > 0
    if check_pins:
        got = (out["steps"], out["n_visc_its"], out["n_Axb_its"])
        assert got == ANT_HYDRO_PINS, \
            f"the f32 antarctica_hydro trajectory moved: {got}"
    return out


def laddie_phases(workdir, ant_files=None):
    """The slice's card phases: mismipplus_iceocean1r, laddie_kernel,
    laddie_standalone, small_iceocean and small_hydro (the latter on the
    writer's 80 km data in ant_files' directory, written here if None).
    Returns (numbers by phase, the laddie_stage kernels entry's parts)."""
    cpu_out = os.path.join(workdir, "small_iceocean_cpu.pt")
    cpu_job = (start_cpu_job("cpu_small_iceocean", workdir, cpu_out),
               cpu_out)
    try:
        return _laddie_phases(workdir, ant_files, cpu_job)
    finally:
        if cpu_job[0].poll() is None:
            cpu_job[0].kill()
            cpu_job[0].wait()


def _laddie_phases(workdir, ant_files, cpu_job):
    io, rec, r_io = iceocean1r_phase(workdir)
    md_io = r_io.run_bmb.state["md_c"]
    C_io = r_io.C
    sa = standalone_operands()
    cases, steps = laddie_kernel_cases(rec, md_io, C_io, sa)
    del r_io
    sa_run = laddie_standalone_phase(workdir)
    small_io = small_iceocean_phase(workdir, cpu_job)
    if ant_files is None:
        from ufemism2_tpu_torch.tools.antarctica_synthetic import write_all
        ant_files = write_all(os.path.join(workdir, "ant80h"),
                              SMALL_CLIMATE_DX)
    hydro = small_hydro_phase(ant_files, workdir)
    return dict(iceocean1r=io, standalone=sa_run, small_iceocean=small_io,
                small_hydro=hydro), (cases, steps)


def laddie_kernel_entry(nums, cases, steps, ant_hydro=None):
    """The laddie_stage entry of the kernels line: the hot case is the
    iceocean1r path's own f32 fbrk3 third stage."""
    hot = next(c for c in cases if c["case"] == "iceocean1r_float32_fbrk3_s3")
    leg = next(c for c in steps if c["case"] == "iceocean1r_float32_fbrk3")
    return {
        "name": "laddie_stage", "route": "cuda",
        "source": "ufemism2_tpu_torch/csrc/laddie.cu",
        "replaces": "ufemism2_tpu/models/laddie.py:373",
        "replaces_kind": "XLA-lowered code (make_laddie_step stage, run "
                         "as one jitted lax.fori_loop), no pallas_call",
        "launches": nums["iceocean1r"]["laddie_stage_launches"],
        "launches_by_path": {
            "mismipplus_iceocean1r":
                nums["iceocean1r"]["laddie_stage_launches"],
            "laddie_standalone":
                nums["standalone"]["laddie_stage_launches"],
            "small_iceocean":
                nums["small_iceocean"]["laddie_stage_launches_card"]},
        "launches_unit": "stages (in a leg one launch of the leg entry, "
                         "else two a stage)",
        "kernel_launches_by_path": {
            "mismipplus_iceocean1r":
                nums["iceocean1r"]["laddie_kernel_launches"],
            "laddie_standalone":
                nums["standalone"]["laddie_kernel_launches"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases + steps),
        "ms": hot["ms"], "device_ms": hot["device_ms"],
        "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"], "library_ms": None,
        "timed_case": hot["case"],
        "leg": {k: leg[k] for k in (
            "case", "leg_ms_a_step", "leg_ms_a_stage", "stage_entry_ms_a_step",
            "plain_ms_a_step", "barrier_floor_ms_a_step",
            "bytes_bound_ms_a_step", "grid_blocks")},
        "cases": cases, "steps": steps}


# ---------------------------------------------------------------------------
# Multi-device runs (A.19): the FULL configuration sharded over 2 and 4
# ranks of one card, joined by gloo
# ---------------------------------------------------------------------------

MD_PS = (2, 4)                       # ranks, all on cuda:0, over gloo
# f64 with thermodynamics (a step every 0.1 model year, so that the
# window's one ice step is followed by one) and GMRES(300): at the schema's
# GMRES(60) the block-Jacobi f64 solves on this mesh end at the
# 2,000-iteration cap or by stagnation (the initial solve's four: 8,184
# iterations, none converged, on the CPU), and where rounding ends each
# of them moves the sharded step's count by an iteration from one
# device's; at GMRES(300) every solve converges (3,813 iterations)
MD_F64 = dict(FULL_THERMO, tpu_precision="f64", dt_thermodynamics=0.1,
              tpu_stress_balance_krylov_restart=300)
MD_F32 = FULL
MD_WINDOW_YR = 0.1                   # the f64 window: one ice step
MD_AFTER_REMESH_YR = 0.1             # f32, sharded on the new mesh
MD_F32_YR = 0.2                      # the f32 window of P = 1, 2, 4
MD_PROFILE_STEPS = 1                 # profiled after it (rank 0)
MD_STEP_TOL = 1e-9                   # sharded against one device, f64
MD_WINDOW_TOL = 1e-8                 # of the largest value, f64 window
# the f32 window against P = 1: its solves end at their precision floor,
# so the reduction order over ranks moves the velocities by a few per cent
# and a margin vertex may keep or lose its 100 m of ice (on the CPU, over
# 0.2 years: 3 vertices beyond 1 m); held: the ice volume and the mean
# |dHi| against the largest Hi, both within 1e-3
MD_F32_TOL = 1e-3
MD_KERNEL_REPS = 20
MD_DEVICE = "cuda:0"                 # every rank's device, and the P = 1 runs'
MD_GATE_WAIT_S = 1500                # the longest a rank waits for the phase


def md_sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def md_gather(x, group, n, dim=0):
    """The ranks' blocks of x along `dim`, concatenated, first n rows."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x.contiguous(), group=group.group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)


def md_sharded_kernels(md, md_loc, block, g, dtype, rnd):
    """stack_spmv and diva_apply on this rank's extended block (random
    operands from one seed, the same on every rank), gathered, against
    the single-device kernel to the bit, and the plain versions on the
    same operands: diva_apply's sharded plain version (its sums in one
    written-out order) against the single-device one to the bit,
    stack_spmv's (a torch reduction, whose order follows the tensor's
    size) within the kernel cases' tolerance; the single-device kernel
    against its plain version within that tolerance."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    from ufemism2_tpu_torch.parallel import comm
    dev, n = g.device, md.nTri
    rng = np.random.default_rng(14)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    x = t(rng.standard_normal((n, 2)) * 300.0)
    fields = (t(1e9 * (1.0 + rng.random(n))), t(1e4 * rng.standard_normal(n)),
              t(1e4 * rng.standard_normal(n)), t(1e3 * rng.random(n)))
    S, Sl = md.M2_stack, md_loc.M2_stack
    tol = (1e-5 if dtype == torch.float32 else 1e-12)
    out = {}
    # the five-operator stack
    y1 = S.apply(x, exact=not rnd)
    y1p = cuda_spmv.stack_spmv_plain(S.cols, S.vals, x, rnd)
    with comm.rank_ctx(g):
        xb = block(x, "Tri")
        n0 = cuda_spmv.launches
        yk = md_gather(Sl.apply(xb, exact=not rnd), g, n, dim=1)
        launched = cuda_spmv.launches - n0
        xe = md_loc.ext_Tri(xb)
        yp = md_gather(cuda_spmv.stack_spmv_plain(Sl.cols, Sl.vals, xe, rnd),
                       g, n, dim=1)
        ms = time_ms(lambda: Sl.apply(xb, exact=not rnd), MD_KERNEL_REPS, 3)
    out["stack_spmv"] = dict(
        n_rows_local=Sl.n_rows, n_cols_local=Sl.n_cols, K=Sl.K,
        launches=launched, bit_equal_kernel=bool(torch.equal(yk, y1)),
        bit_equal_plain=bool(torch.equal(yp, y1p)),
        plain_vs_plain=float((yp - y1p).abs().max() / y1p.abs().max()),
        kernel_vs_plain=float((y1 - y1p).abs().max()
                              / y1p.abs().max()), tol=tol,
        sharded_ms=ms)
    # the DIVA operator
    rows, rows_l = md.x("ssa_diva_rows"), md_loc.x("ssa_diva_rows")
    A1 = cuda_spmv.DivaOperator(S.op, rows, *fields, round_x_bf16=rnd)
    Al = cuda_spmv.DivaOperator(Sl.op, rows_l,
                                *(block(f, "Tri") for f in fields),
                                round_x_bf16=rnd, n_cols=Sl.n_cols,
                                extend=md_loc.ext_Tri)
    u, v = x[:, 0].contiguous(), x[:, 1].contiguous()
    y1 = A1.flat(torch.cat([u, v]))
    y1p = torch.cat(cuda_spmv.diva_apply_plain(
        (S.cols, S.vals), rows, *A1.fields, u, v, rnd))
    nL = Al.n
    with comm.rank_ctx(g):
        ub, vb = block(u, "Tri"), block(v, "Tri")
        n0 = cuda_spmv.diva_launches
        yl = Al.flat(torch.cat([ub, vb]))
        launched = cuda_spmv.diva_launches - n0
        yk = torch.cat([md_gather(yl[:nL], g, n), md_gather(yl[nL:], g, n)])
        ext = md_loc.ext_Tri(torch.stack([ub, vb], dim=1))
        pu, pv = cuda_spmv.diva_apply_plain(
            (Sl.cols, Sl.vals), rows_l, *Al.fields, ext[:, 0], ext[:, 1], rnd)
        yp = torch.cat([md_gather(pu, g, n), md_gather(pv, g, n)])
        xl = torch.cat([ub, vb])
        ms = time_ms(lambda: Al.flat(xl), MD_KERNEL_REPS, 3)
    out["diva_apply"] = dict(
        n_rows_local=nL, n_cols_local=Al.n_cols, launches=launched,
        bit_equal_kernel=bool(torch.equal(yk, y1)),
        bit_equal_plain=bool(torch.equal(yp, y1p)),
        kernel_vs_plain=float((y1 - y1p).abs().max() / y1p.abs().max()),
        tol=tol, sharded_ms=ms)
    return out


def md_window(region, t_end):
    """run_to(t_end) with every kernel count set to 0 just before and
    read just after, the stress-balance GMRES calls counted."""
    with counted_gmres() as gm:
        zero_counts()
        s0 = region.state
        n0, v0, a0, th0 = (region.n_dt_ice, s0.n_visc_its, s0.n_Axb_its,
                           region.thermo_steps)
        md_sync(region.device)
        t0 = time.perf_counter()
        s = region.run_to(t_end)
        md_sync(region.device)
        wall = time.perf_counter() - t0
        counts = read_counts()
    axb = s.n_Axb_its - a0
    return dict(steps=region.n_dt_ice - n0, n_visc_its=s.n_visc_its - v0,
                n_Axb_its=axb, thermo_steps=region.thermo_steps - th0,
                gmres_its=gm["its"], gmres_calls=gm["calls"], wall_s=wall,
                ms_per_krylov_it=wall * 1e3 / max(axb, 1), **counts)


@contextlib.contextmanager
def md_ranged_collectives():
    """Within the block every torch.distributed.all_reduce and all_gather
    is one torch.profiler range ("md_all_reduce", "md_all_gather"), from
    the call to its return (the gloo work and the wait for it)."""
    import torch.distributed as dist
    from torch.profiler import record_function
    inner = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def ranged(name):
        def call(*a, **kw):
            with record_function(f"md_{name}"):
                return inner[name](*a, **kw)
        return call
    for n in inner:
        setattr(dist, n, ranged(n))
    try:
        yield
    finally:
        for n, f in inner.items():
            setattr(dist, n, f)


def md_profile(advance, device):
    """advance() (a few more ice steps) under torch.profiler (the host's
    activity: the collectives block the host): the wall, and the time in
    the collectives (their ranges, md_ranged_collectives) with the
    profiler's own gloo and c10d keys beside it."""
    from torch.profiler import ProfilerActivity, profile
    md_sync(device)
    with md_ranged_collectives(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        advance()
        md_sync(device)
        wall = time.perf_counter() - t0
    keys = {}
    for e in prof.key_averages():
        k = e.key.lower()
        if any(w in k for w in ("gloo", "c10d", "md_all")):
            keys[e.key] = (e.count, e.cpu_time_total / 1e6)
    coll_s = sum(s for k, (_, s) in keys.items() if k.startswith("md_all"))
    return dict(wall_s=wall, collectives_s=coll_s,
                collectives_share=coll_s / wall if wall > 0 else 0.0,
                keys={k: [c, round(s, 4)] for k, (c, s) in keys.items()})


def md_run(D, region, s0, t_stop, thermo=False):
    """The sharded steps of run_to's loop from the full state s0 to
    t_stop (D.multistep, what run_to calls; the thermodynamics fused when
    `thermo`), counted as md_window counts; returns (numbers, full state
    at the end)."""
    from ufemism2_tpu_torch.core.ice.pc import interpolate_ice_to_time
    blk = D.pad_field_V
    with counted_gmres() as gm:
        zero_counts()
        md_sync(D.device)
        t0 = time.perf_counter()
        sd, n, _, n_th, _ = D.multistep(
            D.to_dist(s0), t_stop, region.C.dt_ice_max,
            SMB=blk(region.SMB), BMB=blk(region.BMB), LMB=blk(region.LMB),
            T_surf=blk(region._T_surf) if thermo else None,
            t_th=region.t_thermo_next)
        # the thickness at t_stop inside the last window, as run_to ends
        s = interpolate_ice_to_time(D.from_dist(sd), t_stop)
        md_sync(D.device)
        wall = time.perf_counter() - t0
        counts = read_counts()
    axb = s.n_Axb_its - s0.n_Axb_its
    return dict(steps=n, n_visc_its=s.n_visc_its - s0.n_visc_its,
                n_Axb_its=axb, thermo_steps=n_th, gmres_its=gm["its"],
                gmres_calls=gm["calls"], wall_s=wall,
                ms_per_krylov_it=wall * 1e3 / max(axb, 1), **counts), s


def md_gate(gate):
    """Wait, idle, for the phase's go (True) or the script's abort (False)
    in the directory `gate`."""
    t0 = time.time()
    while time.time() - t0 < MD_GATE_WAIT_S:
        if os.path.exists(os.path.join(gate, "abort")):
            return False
        if os.path.exists(os.path.join(gate, "go")):
            return True
        time.sleep(0.1)
    return False


def multidevice_rank(group, mesh, with_f64_step, gate):
    """One rank of the multidevice phase (its own process; its output
    goes to standard error). The group has max(MD_PS) ranks; each P of
    MD_PS runs on its first P (the whole group's region through run_to,
    the smaller groups through a ShardedModel of that region over a
    subgroup, from the same state), the smaller P first while the other
    ranks wait. The ranks start ahead of the phase (multidevice_start)
    and wait, idle, for its go in the directory `gate`. f32: the kernels
    under sharding, the short window and the
    collectives' share profiled after it. f64: the kernels under sharding
    (on the mesh data alone); with `with_f64_step` also an f64 region with
    thermodynamics and a window of one step with the thermodynamics step
    fused, the step held against the same step on one device (this rank's
    own, from the same state and forcing) and the window's end against
    that step followed by the thermodynamics step on one device. Last, on
    the f32 region, a forced update_mesh and a sharded step on the new
    mesh."""
    sys.stdout = sys.stderr
    start_epoch = time.time()
    if not md_gate(gate):
        return {}
    import torch.distributed as dist
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice.pc import interpolate_ice_to_time
    from ufemism2_tpu_torch.core.ice.ssadiva import register_ssadiva_static
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.parallel.dist import (ShardedModel,
                                                  build_dist_md)
    from ufemism2_tpu_torch.parallel.sharding import RankGroup
    world, rank, dev = group.world, group.rank, group.device
    T = time.perf_counter()
    subs = {P: group.group if P == world
            else dist.new_group(list(range(P))) for P in MD_PS}
    mine = sorted(P for P in MD_PS if rank < P)
    rgs = {P: RankGroup(subs[P], rank, P, dev) for P in mine}
    out = {P: {} for P in mine}

    def sharded(region):
        """This rank's ShardedModel of `region` for each of its P."""
        return {P: region._dist if P == world else ShardedModel(
            region.C, region, P, rgs[P]) for P in mine}

    def in_turn(fn):
        """fn(P) for each P of MD_PS, the smaller first, on its ranks."""
        for P in sorted(MD_PS):
            dist.barrier(group=group.group)
            if rank < P:
                fn(P)
        dist.barrier(group=group.group)

    # f32: construction, kernels, the timed windows and their profiles
    t0 = time.perf_counter()
    r32 = ModelRegion(Config(**MD_F32, tpu_n_devices=world), "ANT",
                      mesh=mesh, device=dev)
    md_sync(dev)
    f32_construct_s = time.perf_counter() - t0
    Ds, s0 = sharded(r32), r32.state
    for P in mine:
        out[P]["kernels_f32"] = md_sharded_kernels(
            r32.md, Ds[P].md, Ds[P]._block, rgs[P], torch.float32, True)
        out[P]["halo_stats"] = Ds[P].halo_stats()

    def f32_window(P):
        if P == world:
            w, s = md_window(r32, MD_F32_YR), r32.state
            prof = md_profile(lambda: r32.run_to(
                r32.time + MD_PROFILE_STEPS * s.dt_ice * 1.05), dev)
        else:
            w, s = md_run(Ds[P], r32, s0, MD_F32_YR)
            prof = md_profile(lambda: md_run(
                Ds[P], r32, s, s.t_Hi_next + MD_PROFILE_STEPS * s.dt_ice
                * 1.05), dev)
        w["Hi"] = s.Hi.cpu().numpy() if rank == 0 else None
        w["volume"] = float((s.Hi.double() * r32.md.A.double()).sum())
        out[P].update(f32_window=w, f32_profile=prof if rank == 0 else None,
                      f32_construct_s=f32_construct_s)
    in_turn(f32_window)

    # f64: the kernels on the mesh data alone
    C64 = Config(**MD_F64)
    md64 = build_mesh_data(mesh, dtype=torch.float64, device=dev)
    register_ssadiva_static(C64, mesh, md64)
    for P in mine:
        dm = build_dist_md(mesh, md64, P)
        nL = {sp: dm.spaces[sp].nL for sp in dm.spaces}

        def block(x, sp, nL=nL):
            b = x.new_zeros((nL[sp],) + tuple(x.shape[1:]))
            part = x[rank * nL[sp]:(rank + 1) * nL[sp]]
            b[:part.shape[0]] = part
            return b
        out[P]["kernels_f64"] = md_sharded_kernels(
            md64, dm.local(rank, dev), block, rgs[P], torch.float64, False)
    del md64
    if not with_f64_step:
        return md_remesh(r32, sharded, in_turn, dev, out, mine, T,
                         start_epoch)

    # f64: the step and the window with the thermodynamics fused
    t0 = time.perf_counter()
    r = ModelRegion(Config(**MD_F64, tpu_n_devices=world), "ANT", mesh=mesh,
                    device=dev)
    md_sync(dev)
    f64_construct_s = time.perf_counter() - t0
    Ds, s0 = sharded(r), r.state
    # one device: the window's step and thermodynamics step
    s1 = r.pc_step(r.md, s0, r.C.dt_ice_max, SMB=r.SMB, BMB=r.BMB,
                   LMB=r.LMB)
    Ti1, _ = r._thermo_step(r.md, interpolate_ice_to_time(
        s1, r.t_thermo_next), r._T_surf, r.SMB, r.BMB)
    ref = dict(interpolate_ice_to_time(s1, MD_WINDOW_YR).__dict__, Ti=Ti1)
    gap = lambda a, b: float((a - b).abs().max()
                             / a.abs().max().clamp(min=1e-30))

    def f64_window(P):
        if P == world:
            w, s2 = md_window(r, MD_WINDOW_YR), r.state
        else:
            w, s2 = md_run(Ds[P], r, s0, MD_WINDOW_YR, thermo=True)
        out[P]["f64_step"] = dict(
            counts_single=(s1.n_visc_its, s1.n_Axb_its),
            counts_sharded=(s2.n_visc_its, s2.n_Axb_its),
            dt_single=s1.dt_ice, dt_sharded=s2.dt_ice,
            gaps={k: gap(getattr(s1, k), getattr(s2, k))
                  for k in ("Hi_next", "u_vav_b", "v_vav_b", "u_3D_b")},
            masks_equal=bool(torch.equal(s1.mask, s2.mask)
                             and torch.equal(s1.mask_grounded_ice,
                                             s2.mask_grounded_ice)))
        w["gaps"] = {k: gap(ref[k], getattr(s2, k))
                     for k in ("Hi", "Ti", "u_vav_b")}
        w["reference_steps"] = 1 if s1.t_Hi_next >= MD_WINDOW_YR - 1e-9 \
            else 0
        out[P].update(f64_window=w, f64_construct_s=f64_construct_s)
    in_turn(f64_window)
    del r, Ds
    return md_remesh(r32, sharded, in_turn, dev, out, mine, T, start_epoch)


def md_remesh(r32, sharded, in_turn, dev, out, mine, T, start_epoch):
    """The end of multidevice_rank: the f32 region remeshed, then a
    sharded step on the new mesh for each P."""
    world = r32._dist.group.world
    t0 = time.perf_counter()
    r32.update_mesh()
    remesh_s = time.perf_counter() - t0
    Ds, s_rm = sharded(r32), r32.state

    def after_remesh(P):
        if P == world:
            rm, s = md_window(r32, r32.time + MD_AFTER_REMESH_YR), r32.state
        else:
            rm, s = md_run(Ds[P], r32, s_rm, r32.time + MD_AFTER_REMESH_YR)
        rm.update(nV=r32.mesh.nV, nTri=r32.mesh.nTri,
                  finite=check_state(s, dev.type) > 0,
                  Hi_min=float(s.Hi.min()), Hi_max=float(s.Hi.max()))
        out[P].update(after_remesh=rm, remesh_s=remesh_s)
    in_turn(after_remesh)
    for P in mine:
        out[P].update(seconds=time.perf_counter() - T,
                      start_epoch=start_epoch, end_epoch=time.time())
    return out


def multidevice_start(mesh, with_f64_step):
    """Start the phase's max(MD_PS) ranks now, so that their processes'
    start-up (imports, CUDA contexts, the process group) goes on beside
    the phases before it; they wait, idle, for multidevice_phase's go.
    multidevice_stop must follow, whatever happens in between."""
    from ufemism2_tpu_torch.parallel.launch import spawn
    gate = tempfile.TemporaryDirectory()
    pool = ThreadPoolExecutor(1)
    epoch0 = time.time()
    job = pool.submit(spawn, multidevice_rank, max(MD_PS), "gloo",
                      [MD_DEVICE] * max(MD_PS),
                      args=(mesh, with_f64_step, gate.name),
                      timeout_s=MD_GATE_WAIT_S)
    return dict(mesh=mesh, with_f64_step=with_f64_step, gate=gate, pool=pool,
                job=job, epoch0=epoch0)


def multidevice_stop(md):
    """Release the ranks (with an abort if the phase never began) and join
    them."""
    gate = md["gate"].name
    if not os.path.exists(os.path.join(gate, "go")):
        open(os.path.join(gate, "abort"), "w").close()
    try:
        md["job"].result()
    except Exception:          # raised already where the phase reads it
        pass
    md["pool"].shutdown()
    md["gate"].cleanup()


def multidevice_phase(md):
    """The FULL configuration over P = 2 and 4 gloo ranks on the one card
    (every collective staged through the host: what one card pays for the
    run mode, not a multi-GPU scaling figure), against the single-device
    runs of the same windows; the f64 step and window only with
    `with_f64_step` (--multidevice-only: they take the ranks about 90 s
    more, the f64 region's cold initial solve most of it). Returns the
    ranks' summed kernel launches on the sharded paths and the
    kernel-under-sharding records. `md` is multidevice_start's."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    mesh, with_f64_step = md["mesh"], md["with_f64_step"]
    t_phase = time.perf_counter()
    # P = 1: the f32 window on one device
    r = ModelRegion(Config(**MD_F32), "ANT", mesh=mesh, device=MD_DEVICE)
    f32 = {1: md_window(r, MD_F32_YR)}
    Hi32 = r.state.Hi.double()
    vol32 = float((Hi32 * r.md.A.double()).sum())
    del r
    say("multidevice_reference", f32_window=f32[1])

    # one group of max(MD_PS) ranks, started ahead: every P on its first P
    # ranks, in turn (two groups at once share the card's time slices and
    # run slower than one after the other, and every process costs its
    # start-up)
    t0 = time.perf_counter()
    open(os.path.join(md["gate"].name, "go"), "w").close()
    all_runs, epoch0 = md["job"].result(), md["epoch0"]
    spawn_s, epoch1 = time.perf_counter() - t0, time.time()
    launches, cases = {}, []
    for P in MD_PS:
        runs = [x[P] for x in all_runs[:P]]
        r0 = runs[0]
        # f64 step, and window with the thermodynamics fused, against one
        # device
        st, w = r0.get("f64_step"), r0.get("f64_window")
        ok_step = not with_f64_step or all(
            x["f64_step"]["counts_single"] == x["f64_step"]["counts_sharded"]
            and x["f64_step"]["masks_equal"]
            and max(x["f64_step"]["gaps"].values()) <= MD_STEP_TOL
            for x in runs)
        ok_window = not with_f64_step or all(
            x["f64_window"]["steps"] == x["f64_window"]["reference_steps"]
            == 1 and x["f64_window"]["thermo_steps"] == 1
            and max(x["f64_window"]["gaps"].values()) <= MD_WINDOW_TOL
            for x in runs)
        rm = r0["after_remesh"]
        ok_remesh = all(x["after_remesh"]["finite"]
                        and x["after_remesh"]["Hi_min"] >= 0.0
                        and x["after_remesh"]["nV"] == rm["nV"]
                        and x["after_remesh"]["steps"] >= 1 for x in runs)
        kern = {prec: {name: {k: [x[prec][name][k] for x in runs]
                              for k in ("bit_equal_kernel", "bit_equal_plain",
                                        "launches", "kernel_vs_plain",
                                        "sharded_ms")
                              + (("plain_vs_plain",)
                                 if name == "stack_spmv" else ())}
                       for name in ("stack_spmv", "diva_apply")}
                for prec in ("kernels_f64", "kernels_f32")}
        ok_kern = all(all(v["bit_equal_kernel"])
                      and (all(v["bit_equal_plain"]) or name == "stack_spmv"
                           and all(e <= runs[0][prec][name]["tol"]
                                   for e in v["plain_vs_plain"]))
                      and all(e <= runs[0][prec][name]["tol"]
                              for e in v["kernel_vs_plain"])
                      and all(n == 1 for n in v["launches"])
                      for prec, d in kern.items() for name, v in d.items())
        # the paths' launches, every rank's summed; the rules of the
        # single-device paths hold on each rank
        paths = {"f32_window": "f32", "after_remesh": "f32_after_remesh"}
        if with_f64_step:
            paths["f64_window"] = "f64"
        for key, tag in paths.items():
            for name in ("stack_spmv_launches", "diva_apply_launches",
                         "heat_columns_launches"):
                launches.setdefault(name, {})[f"multidevice_{tag}_P{P}"] = \
                    sum(x[key][name] for x in runs)
        ok_launch = all(
            x[k]["diva_apply_launches"] == x[k]["gmres_its"]
            + x[k]["gmres_calls"] and x[k]["gmres_its"] > 0
            and x[k]["stack_spmv_launches"] > 16 * x[k]["gmres_calls"]
            for x in runs for k in paths) and (not with_f64_step or all(
                x["f64_window"]["heat_columns_launches"]
                == x["f64_window"]["thermo_steps"] > 0 for x in runs))
        w32 = r0["f32_window"]
        f32[P] = {k: w32[k] for k in w32 if k != "Hi"}
        dHi = (torch.as_tensor(w32["Hi"], device=MD_DEVICE).double()
               - Hi32).abs()
        f32_gaps = dict(volume=abs(w32["volume"] - vol32) / vol32,
                        mean_abs_Hi=float(dHi.mean() / Hi32.abs().max()),
                        max_abs_Hi=float(dHi.max() / Hi32.abs().max()),
                        vertices_over_1m=int((dHi > 1.0).sum()))
        ok_f32 = (f32_gaps["volume"] <= MD_F32_TOL
                  and f32_gaps["mean_abs_Hi"] <= MD_F32_TOL)
        say(f"multidevice_P{P}", ranks=P, backend="gloo", devices=MD_DEVICE,
            spawn_s=spawn_s, rank_seconds=[x["seconds"] for x in runs],
            start_up_s=max(x["start_epoch"] for x in runs) - epoch0,
            tear_down_s=epoch1 - min(x["end_epoch"] for x in runs),
            f64_construct_s=r0.get("f64_construct_s"),
            f32_construct_s=r0["f32_construct_s"],
            f64_step=st, f64_window=w,
            remesh_s=r0["remesh_s"], after_remesh=rm,
            kernels=kern, f32_window=f32[P], f32_gaps_vs_P1=f32_gaps,
            f32_profile=r0["f32_profile"], halo_stats=r0["halo_stats"],
            ok=dict(step=ok_step, window=ok_window, remesh=ok_remesh,
                    kernels=ok_kern, launches=ok_launch, f32=ok_f32))
        if not (ok_step and ok_window and ok_remesh and ok_kern and ok_launch
                and ok_f32):
            raise SystemExit(f"multidevice over {P} ranks failed: step "
                             f"{ok_step}, window {ok_window}, remesh "
                             f"{ok_remesh}, kernels {ok_kern}, launches "
                             f"{ok_launch}, f32 {ok_f32}")
        for prec, d in kern.items():
            for name, v in d.items():
                cases.append(dict(case=f"{name}_sharded_P{P}_{prec[8:]}",
                                  kernel=name, ranks=P,
                                  **{k: v[k] for k in v},
                                  n_rows_local=runs[0][prec][name][
                                      "n_rows_local"],
                                  n_cols_local=runs[0][prec][name][
                                      "n_cols_local"]))
    say("multidevice", seconds=time.perf_counter() - t_phase,
        f32_by_ranks={P: dict(n_Axb_its=v["n_Axb_its"],
                              n_visc_its=v["n_visc_its"], steps=v["steps"],
                              wall_s=v["wall_s"],
                              ms_per_krylov_it=v["ms_per_krylov_it"])
                      for P, v in f32.items()})
    return launches, cases


# -- 35. the validation harness --------------------------------------------
# Stand-ins for the reference's integrated-test configs that the quick tier
# reads (REF_TESTS of ufemism2_tpu_torch/validation/integrated_tests.py;
# the reference's files are not in the repository), written as namelists
# into the reference's layout under the work directory. The reference's
# configs carry no tpu_precision, so the schema's f64 holds in all four.
# The Halfar dome of HALFAR at 40 km (the schema's 3-D heat equation),
# 500 model years (the harness's quick tier runs 50)
VAL_HALFAR = dict({k: v for k, v in HALFAR.items()},
                  maximum_resolution_uniform=40e3,
                  maximum_resolution_grounded_ice=40e3,
                  maximum_resolution_ice_front=40e3, ice_front_width=40e3,
                  end_time_of_run=500.0)
# Schoof's (2006, J. Fluid Mech. 556) ice stream with the parameters
# Bueler and Brown (2009, J. Geophys. Res. 114, F03008) publish for it as
# their test I: H 2000 m, a surface slope of 0.001 (the bed falling in
# +x), L 40 km, m 10, B 3.7e8 Pa s^(1/3) (A = B^-3 = 6.23e-19 Pa^-3
# yr^-1); the reference's boundaries (u and v copied across the x sides,
# zero on the y sides), SSA with the idealised plastic till, a 32 km mesh
# on +-150 km, one 0.1-year step after the initial solve; the viscosity
# settings the JAX harness names (integrated_tests.py:157-159:
# visc_it_nit 5000 at a tolerance of 5e-8)
VAL_SSA = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="SSA_icestream",
    refgeo_idealised_SSA_icestream_Hi=2000.0,
    refgeo_idealised_SSA_icestream_dhdx=-0.001,
    refgeo_idealised_SSA_icestream_L=40e3,
    refgeo_idealised_SSA_icestream_m=10.0,
    choice_ice_rheology_Glen="uniform",
    uniform_Glens_flow_factor=3.7e8 ** -3 * 31556926.0,
    choice_stress_balance_approximation="SSA",
    choice_sliding_law="idealised",
    choice_idealised_sliding_law="SSA_icestream",
    choice_thermo_model="none", choice_initial_ice_temperature_ANT="uniform",
    choice_SMB_model_ANT="uniform", uniform_SMB=0.0,
    BC_u_west="infinite_SSA_icestream", BC_v_west="infinite_SSA_icestream",
    BC_u_east="infinite_SSA_icestream", BC_v_east="infinite_SSA_icestream",
    BC_u_north="zero", BC_v_north="zero",
    BC_u_south="zero", BC_v_south="zero",
    xmin_ANT=-150e3, xmax_ANT=150e3, ymin_ANT=-150e3, ymax_ANT=150e3,
    maximum_resolution_uniform=32e3, maximum_resolution_grounded_ice=32e3,
    nit_Lloyds_algorithm=2, allow_mesh_updates=False,
    start_time_of_run=0.0, end_time_of_run=0.1,
    visc_it_nit=5000, visc_it_norm_dUV_tol=5e-8)
# ISMIP-HOM A at L = 160 km with DIVA (ismip_hom_cfg; a mesh of L/40)
VAL_ISMIP = {k: v for k, v in ismip_hom_cfg(
    "A", 160e3, 160e3 / 40,
    choice_stress_balance_approximation="DIVA").items()
    if k != "tpu_precision"}
# the MISMIP+ spin-up stand-in: MISMIPPLUS without its tpu_precision (f64,
# as the reference's configs have it), cut to run the quick tier's 20
# model years from 500 m of ice (the tier also sets 16 km at the grounding
# line and 32 km on grounded ice) within the script's time: 32 km
# everywhere else, GMRES(300) (at GMRES(60) these f64 solves stagnate, as
# MD_F64's do), the viscosity loop at 3 iterations and the corrector at 2
# (the CPU tests' cut, as in SMALL and MP_SMALL). Uncut (nV 1,663, f64) the
# tier's MISMIP+ ran past 1,400 s on the card, and in f32 with 32 km
# elsewhere and 16 km at the front (nV 351) past 1,100 s: its 500 m slab's
# solves stagnate from the third model year on (the JAX package's own
# record of the tier has 826,944 Krylov iterations, scoreboard/).
VAL_MISMIPPLUS = dict(
    {k: v for k, v in MISMIPPLUS.items() if k != "tpu_precision"},
    maximum_resolution_uniform=32e3, maximum_resolution_floating_ice=32e3,
    maximum_resolution_calving_front=32e3, calving_front_width=32e3,
    maximum_resolution_ice_front=32e3, ice_front_width=32e3,
    tpu_stress_balance_krylov_restart=300, visc_it_nit=3, pc_nit_max=2)
VAL_STANDINS = {
    "idealised/Halfar_dome/config_Halfar_40km.cfg": VAL_HALFAR,
    "idealised/SSA_icestream/config_01_32km.cfg": VAL_SSA,
    "idealised/ISMIP-HOM/config_ISMIP_HOM_A_160_DIVA.cfg": VAL_ISMIP,
    "idealised/MISMIPplus/config_01_5km_spinup_part0.cfg": VAL_MISMIPPLUS,
}
VAL_HALFAR_RMSE_M = 60.0        # tests/test_integrated_quick.py's limits
VAL_HALFAR_MIN_STEPS = 10
VAL_PATHS = {"run_halfar": "validation_halfar",
             "run_ssa_icestream": "validation_ssa_icestream",
             "run_ismip_hom": "validation_ismip_hom_a_diva_l160",
             "run_mismipplus": "validation_mismipplus_quick"}
DEMO_TOL_A = 1e-12


def write_standins(root):
    """VAL_STANDINS as namelists under root, each marked a stand-in."""
    for rel, values in VAL_STANDINS.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_namelist(path, values)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(f"! stand-in for the reference's {os.path.basename(rel)}"
                    " (chip_smoke.py VAL_STANDINS)\n" + text)
    return root


def scoreboard_entries(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            e = json.load(f)
        out[name] = {c["name"]: c["value"] for c in e["cost_functions"]}
    return out


def validation_component(sb):
    """The component tests' default suite through program.main on the
    card; the launches of the mass-conservation tier (the only tier on
    the device) counted."""
    from ufemism2_tpu_torch.main import program
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        runs = program.main(["component_tests", "--output-dir", sb])
    torch.cuda.synchronize()
    counts = read_counts()
    entries = scoreboard_entries(sb)
    say("validation_component_tests", seconds=time.perf_counter() - t0,
        n_entries=len(entries), entries=entries, **counts)
    assert len(runs) == len(entries) == 24, len(entries)
    for name, cfs in entries.items():
        assert all(np.isfinite(v) for v in cfs.values()), name
    mass = [e for n, e in entries.items() if "mass_conservation" in n]
    assert len(mass) == 3 and all(len(e) == 4 for e in mass)
    return counts


def validation_integrated(sb):
    """The quick tier through program.main on the card, each runner
    wrapped: the kernels' launches counted around it, its wall, the
    MISMIP+ run's last GMRES operator and the Halfar run's last
    heat_columns call kept. Returns (runners, kept, entries, runs)."""
    from ufemism2_tpu_torch.main import program
    from ufemism2_tpu_torch.validation import integrated_tests as it
    per, inner = {}, {n: getattr(it, n) for n in VAL_PATHS}
    kept = {}

    def wrapped(name):
        def run(*a, **kw):
            zero_counts()
            t0 = time.perf_counter()
            with counted_gmres() as gm, last_heat_call() as last:
                r = inner[name](*a, **kw)
                torch.cuda.synchronize()
            per[name] = dict(read_counts(), seconds=time.perf_counter() - t0,
                             gmres_calls=gm["calls"], gmres_its=gm["its"])
            say("validation_runner", runner=name, summary=r.summary(),
                **per[name])
            if name == "run_mismipplus":
                kept["diva"] = (gm["A"], torch.cat(gm["x"]))
            if name == "run_halfar":
                kept["heat"] = last.get("args")
            return r
        return run
    for name in VAL_PATHS:
        setattr(it, name, wrapped(name))
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            runs = program.main(["integrated_tests", "--output-dir", sb])
        seconds = time.perf_counter() - t0
    finally:
        for name, fn in inner.items():
            setattr(it, name, fn)
    entries = scoreboard_entries(sb)
    runs = [dict(name=r.name, cost_functions={
        c["name"]: c["value"] for c in r.cost_functions}) for r in runs]
    return dict(per, seconds=seconds), kept, entries, runs


def check_integrated(per, entries, runs):
    """The quick tier's entries held: finite, with the stability counters;
    the Halfar dome within the JAX test's limits, the SSA stream and
    ISMIP-HOM scored, the quick MISMIP+ with a grounding line; every
    runner of the tier through its kernels."""
    say("validation_integrated_tests", seconds=per["seconds"],
        entries=entries, runners={k: v for k, v in per.items()
                                  if k != "seconds"})
    assert [r["name"] for r in runs] == ["Halfar_40km", "SSA_icestream",
                                         "experiment_A_DIVA_L160",
                                         "MISMIPplus_quick"], runs
    for r in runs:
        cf = r["cost_functions"]
        assert all(np.isfinite(v) for v in cf.values()), (r["name"], cf)
        assert {"n_dt_ice", "n_visc_its", "n_Axb_its"} <= set(cf), r["name"]
    hal, ssa, ih, mp = (r["cost_functions"] for r in runs)
    assert hal["rmse"] < VAL_HALFAR_RMSE_M \
        and hal["n_dt_ice"] > VAL_HALFAR_MIN_STEPS, hal
    assert per["run_halfar"]["heat_columns_launches"] > 0
    assert 0.0 < ssa["RMSE_32km"] and ssa["n_visc_its"] > 0, ssa
    assert 0.0 < ih["u_surf_min"] < ih["u_surf_max"], ih
    # the quick MISMIP+ spin-up has a grounding line to score
    assert 0.0 < mp["x_GL_km"] < 800.0, mp
    for name in ("run_ssa_icestream", "run_ismip_hom", "run_mismipplus"):
        assert per[name]["diva_apply_launches"] > 0, name


def point_harness(workdir):
    """VAL_STANDINS written under workdir in the reference's layout and
    the harness's REF_TESTS, MISMIP_MOD_DIR and ANT_CFG pointed there."""
    from ufemism2_tpu_torch.validation import integrated_tests as it
    root = write_standins(os.path.join(
        workdir, "reference", "automated_testing", "integrated_tests"))
    it.REF_TESTS = pathlib.Path(root)
    it.MISMIP_MOD_DIR = it.REF_TESTS / "idealised/MISMIP_mod"
    it.ANT_CFG = it.REF_TESTS / ("realistic/Antarctica/initialisation/"
                                 "Ant_init_20kyr_invBMB_invfric_40km/"
                                 "config.cfg")
    return root


def validation_integrated_job(workdir, out_path):
    """The quick tier in a process of its own on the card (started with
    phase 10's CPU runs, so that its runs, host-bound as the others, go on
    beside phases 10-19): the stand-ins, program.main(["integrated_tests", ...]), then
    diva_apply on the quick MISMIP+ run's last apply and heat_columns on
    the Halfar run's last call against their plain versions; everything
    saved to out_path for phase 35 to hold. One torch thread at the
    lowest priority: the host's cores go first to the phases beside it,
    whose times the script reports; it has until phase 35."""
    from ufemism2_tpu_torch.ops import (cuda_bpa, cuda_heat, cuda_laddie,
                                        cuda_spmv)
    os.nice(19)
    torch.set_num_threads(1)
    for m in (cuda_spmv, cuda_heat, cuda_bpa, cuda_laddie):
        m.load_kernels()           # the libraries the parent built
    point_harness(workdir)
    per, kept, entries, runs = validation_integrated(
        os.path.join(workdir, "scoreboard_integrated"))
    A, x = kept["diva"]
    cases = {"diva": diva_check(
        "diva_apply_validation_mismipplus_quick_last_apply", A, x),
        "heat": heat_case("heat_columns_validation_halfar_last_step",
                          kept["heat"])}
    torch.save(dict(per=per, entries=entries, runs=runs, cases=cases),
               out_path)


def stop_job(proc, workdir=None):
    """Kill `proc` if it still runs; remove workdir."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    if workdir is not None:
        shutil.rmtree(workdir, ignore_errors=True)


def start_validation_job(workdir):
    """validation_integrated_job in a process of its own on the card."""
    path = os.path.join(workdir, "validation_integrated.pt")
    return start_cpu_job("validation_integrated_job", workdir, path), path


def validation_demo(res=20e3):
    """The demo model, both variants, on the card against the CPU: 20 model
    years, a remap onto a finer mesh, a restart round trip and 5 years
    more."""
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.mesh import build_uniform_mesh
    from ufemism2_tpu_torch.models.demo import DemoModel
    m1 = build_uniform_mesh(-100e3, 100e3, -100e3, 100e3, res)
    m2 = build_uniform_mesh(-100e3, 100e3, -100e3, 100e3, 0.75 * res)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for choice in ("a", "b"):
            ends = {}
            for dev in ("cpu", "cuda"):
                md1 = build_mesh_data(m1, torch.float64, device=dev)
                md2 = build_mesh_data(m2, torch.float64, device=dev)
                demo = DemoModel(choice)
                s = demo.run(demo.initialise(md1), 20.0)
                s = demo.remap(s, m1, m2, md2)
                path = os.path.join(d, f"demo_{choice}_{dev}.nc")
                demo.write_restart(path, m2, s)
                s2 = demo.read_restart(path, md2)
                assert torch.equal(s2.phi, s.phi) and s2.t == s.t
                ends[dev] = demo.run(s2, 25.0)
                assert ends[dev].phi.device.type == dev
            a, b = ends["cpu"].phi, ends["cuda"].phi.cpu()
            gap = float((a - b).abs().max() / a.abs().max())
            out[choice] = dict(rel_gap=gap, bit_equal=bool(torch.equal(a, b)),
                               t=ends["cuda"].t)
    say("validation_demo", nV=[m1.nV, m2.nV], **out)
    assert out["a"]["rel_gap"] <= DEMO_TOL_A, out
    assert out["b"]["bit_equal"], out
    return out


def validation_sanitizer(regions=None):
    """do_check_for_NaN on the card: a SMALL region on the card and on the
    CPU (`regions` by device, or built here) passes clean, then, with a
    NaN put into the ice thickness at its thickest vertex and the check
    on, raises NaNDetected after its next dispatch, naming the same fields
    on both."""
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.utils.sanitizer import (NaNDetected,
                                                    check_state_for_nan)
    C = Config(**dict(SMALL, do_check_for_NaN=True))
    if regions is None:
        mesh = build_mesh_from_config(C, "ANT")
        regions = {dev: ModelRegion(C, "ANT", mesh=mesh, device=dev)
                   for dev in ("cpu", "cuda")}
    msgs = {}
    for dev, r in regions.items():
        r.C = C        # SMALL with the check on
        check_state_for_nan(r.state)
        top = int(r.state.Hi.argmax())
        Hi = r.state.Hi.clone()
        Hi[top] = float("nan")
        r.state = r.state.replace(Hi=Hi)
        try:
            r.run_to(r.time + SMALL_YR)
            msgs[dev] = None
        except NaNDetected as e:
            msgs[dev] = str(e)
    say("validation_sanitizer", message_card=msgs["cuda"],
        message_cpu=msgs["cpu"])
    assert msgs["cuda"] is not None and msgs["cuda"] == msgs["cpu"], msgs
    assert "'Hi'" in msgs["cuda"]


def validation_tools(out_dir):
    """tools/ on a program.main output directory of this run: Run's meshes,
    fields and times, diagnose_run's summary, analyse_resources' top
    routines."""
    from ufemism2_tpu_torch.tools import analyse_resources, diagnose_run
    from ufemism2_tpu_torch.tools.run import Run
    t0 = time.perf_counter()
    run = Run(os.path.join(out_dir, "ANT"))
    mo = run.get_mesh(-1)
    Hi = mo.read("Hi", -1)
    scal = run.scalars()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        diagnose_run.main([os.path.join(out_dir, "ANT")])
    recs = analyse_resources.load_records(
        os.path.join(out_dir, "resource_tracking.jsonl"))
    agg = analyse_resources.aggregate(recs)
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:5]
    say("validation_tools", dir=os.path.basename(out_dir),
        meshes=run.n_meshes, nV=mo.nV, times=[float(t) for t in mo.time],
        variables=mo.variables, Hi_max=float(np.nanmax(Hi)),
        scalars=sorted(scal), final_ice_volume=float(scal["ice_volume"][-1]),
        intervals=len(recs),
        top_routines=[[k, tc, nc] for k, (tc, nc) in top],
        diagnose_lines=len(buf.getvalue().splitlines()),
        seconds=time.perf_counter() - t0)
    assert run.regions == ["ANT"] and run.n_meshes >= 1
    assert len(mo.time) >= 2 and np.isfinite(Hi).all() and Hi.max() > 0
    assert "final scalars:" in buf.getvalue() and len(recs) >= 1
    assert any(k.endswith("run_model_region") for k, _ in top)


def validation_phase(workdir, job, tools_dir=None):
    """Phase 35: the component tests through program.main on the card,
    the quick tier's results from its process (`job`, started by
    start_validation_job) held, the demo model, the NaN sanitizer and
    (given an output directory of program.main) the run tools. Returns
    the launches by path and the kernel cases of the tier's last calls."""
    t0 = time.perf_counter()
    launches = {"validation_mass_conservation": validation_component(
        os.path.join(workdir, "scoreboard_component"))}
    validation_demo()
    if tools_dir is not None:       # --validation-only
        validation_sanitizer()
        validation_tools(tools_dir)
    proc, path = job
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, "the quick tier's process on the card failed"
    waited = time.perf_counter() - t_wait
    # a file this script's own child process wrote
    res = torch.load(path, weights_only=False)
    check_integrated(res["per"], res["entries"], res["runs"])
    for name, path_name in VAL_PATHS.items():
        launches[path_name] = res["per"][name]
    for c in res["cases"].values():
        say("validation_case", **c)
    say("validation", seconds=time.perf_counter() - t0,
        waited_for_quick_tier_s=waited)
    return launches, res["cases"]

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile this many further ice steps")
    ap.add_argument("--profile-out", default=None, metavar="FILE",
                    help="write the profiler's table of operators here")
    ap.add_argument("--antarctica-only", action="store_true",
                    help="build the kernels and run the Antarctica phases "
                         "alone (no result line)")
    ap.add_argument("--laddie-only", action="store_true",
                    help="build the kernels and run the LADDIE slice's "
                         "phases 29-33 alone (no result line)")
    ap.add_argument("--multidevice-only", action="store_true",
                    help="build the kernels and the 8 km mesh and run the "
                         "multidevice phase alone (no result line)")
    ap.add_argument("--validation-only", action="store_true",
                    help="build the kernels and run the validation "
                         "harness's phase 35 alone (no result line)")
    ap.add_argument("--ant-init-years", type=float, default=ANT_INIT_YEARS,
                    metavar="Y", help="antarctica_init's window in model "
                    "years (pins held only at the default)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ufemism2_tpu_torch.ops import cuda_spmv     # sets TF32 off
    from ufemism2_tpu_torch.ops import cuda_heat, cuda_bpa, cuda_laddie
    from ufemism2_tpu_torch.ops._build import SOURCES, build_kernel
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.mesh.zeta import setup_zeta_grid
    assert torch.backends.cuda.matmul.allow_tf32 is False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    say("device", card=card_line, torch=torch.__version__,
        cuda=torch.version.cuda, cpu_count=os.cpu_count(),
        cpus_usable=len(os.sched_getaffinity(0)),
        torch_threads=torch.get_num_threads())

    # -- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()

    def build_timed(name):
        build_kernel(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(build_timed, SOURCES)))
    cuda_spmv.load_kernels()
    cuda_heat.load_kernels()
    cuda_bpa.load_kernels()
    cuda_laddie.load_kernels()
    say("build", seconds=time.perf_counter() - t0,
        sources={f"ufemism2_tpu_torch/csrc/{n}.cu": s
                 for n, s in built.items()})
    if args.antarctica_only:
        with tempfile.TemporaryDirectory() as workdir:
            antarctica_phases(workdir, args.ant_init_years)
        say("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.laddie_only:
        with tempfile.TemporaryDirectory() as workdir:
            nums, (cases, steps) = laddie_phases(workdir)
            say("laddie_kernel_entry", **laddie_kernel_entry(nums, cases,
                                                             steps))
        say("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.validation_only:
        with tempfile.TemporaryDirectory() as workdir:
            # an output directory of program.main for the run tools:
            # MP_SMALL on the card, a few seconds
            cfg = write_namelist(os.path.join(workdir, "tools_run.cfg"),
                                 MP_SMALL)
            tools_dir = os.path.join(workdir, "tools_run")
            job = start_validation_job(workdir)
            try:
                from ufemism2_tpu_torch.main import program
                with contextlib.redirect_stdout(sys.stderr):
                    program.main([cfg, "--output-dir", tools_dir])
                validation_phase(workdir, job, tools_dir)
            finally:
                stop_job(job[0])
        say("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.multidevice_only:
        from ufemism2_tpu_torch.mesh.operators import \
            build_all_matrix_operators
        mesh = build_mesh_from_config(Config(**FULL), "ANT")
        mesh.operators = build_all_matrix_operators(mesh)
        md = multidevice_start(mesh, with_f64_step=True)
        try:
            multidevice_phase(md)
        finally:
            multidevice_stop(md)
        say("done", seconds=time.perf_counter() - t_start)
        return 0

    # -- the ISMIP-HOM mesh (host) and the BPA kernels -----------------------
    ih = bpa_slice_start()

    # -- 3. mesh (host) ----------------------------------------------------
    C = Config(**FULL)
    t0 = time.perf_counter()
    mesh = build_mesh_from_config(C, "ANT")
    from ufemism2_tpu_torch.mesh.operators import build_all_matrix_operators
    mesh.operators = build_all_matrix_operators(mesh)
    mesh_s = time.perf_counter() - t0
    say("mesh", nV=mesh.nV, nTri=mesh.nTri, nE=mesh.nE, seconds=mesh_s,
        stand_in_for="config_MISMIP_8km_spinup_for_scaling.cfg "
                     "(nV 13735, nTri 27308)")

    # -- 4. kernels --------------------------------------------------------
    ops = mesh.operators
    rng = np.random.default_rng(0)
    m2 = [ops.M2_ddx_b_b, ops.M2_ddy_b_b, ops.M2_d2dx2_b_b,
          ops.M2_d2dxdy_b_b, ops.M2_d2dy2_b_b]
    x_uv = rng.standard_normal((mesh.nTri, 2)) * 300.0      # m/yr
    x_a = rng.standard_normal(mesh.nV) * 1000.0
    x_3d = rng.standard_normal((mesh.nTri, C.nz))
    cases = []
    for dtype, rounds in ((torch.float32, (True, False)),
                          (torch.float64, (False,))):
        for rnd in rounds:
            tag = f"{str(dtype)[-7:]}{'_bf16x' if rnd else ''}"
            cases.append(kernel_case(f"M2_stack_5ops_d2_{tag}", m2, x_uv,
                                     dtype, rnd))
            cases.append(kernel_case(f"M_map_a_b_1op_d1_{tag}",
                                     [ops.M_map_a_b], x_a, dtype, rnd))
            cases.append(kernel_case(f"M_map_b_a_1op_d{C.nz}_{tag}",
                                     [ops.M_map_b_a], x_3d, dtype, rnd))
    diva_cases = [diva_case(f"diva_apply_{tag}", mesh, m2, dtype, rnd, rng)
                  for tag, dtype, rnd in (
                      ("float32_bf16x", torch.float32, True),
                      ("float32", torch.float32, False),
                      ("float64", torch.float64, False))]
    # the operator with an ocean-pressure front carved at x = 400 km, random
    # operands: every row bit-equal to the plain version
    front8 = carved_front(mesh)
    rng_f = np.random.default_rng(5)
    for tag, dtype, rnd in (("float32_bf16x", torch.float32, True),
                            ("float32", torch.float32, False),
                            ("float64", torch.float64, False)):
        diva_cases.append(diva_case(f"diva_apply_front_{tag}", mesh, m2,
                                    dtype, rnd, rng_f, front=front8))
    # the calls the main path makes: the fused operator once per Krylov
    # iteration, and of the single-operator applies the largest
    hot_diva = diva_cases[0]
    hot = next(c for c in cases
               if c["case"] == f"M_map_b_a_1op_d{C.nz}_float32_bf16x")

    # heat_columns at the 8 km shapes: fields in f32 (f64 systems) and f64
    heat_cases = [heat_case(f"heat_columns_{str(dt)[6:]}",
                            heat_operands(mesh.nV, mesh.zeta, dt, rng))
                  for dt in (torch.float32, torch.float64)]
    # without the unstable columns: most columns stable at level 0
    heat_cases.append(heat_case("heat_columns_stable_f32", heat_operands(
        mesh.nV, mesh.zeta, torch.float32, rng, unstable=False)))
    # every nz but 12 takes the kernel's run-time-nz form: held to the bit
    # at old_15_layer_zeta's 15 layers and at an odd 7
    for choice, nz_x in (("old_15_layer_zeta", 15), ("irregular_log", 7)):
        zeta_x = setup_zeta_grid(choice, nz_x)[0]
        heat_cases += [heat_case(f"heat_columns_nz{nz_x}_{str(dt)[6:]}",
                                 heat_operands(mesh.nV, zeta_x, dt, rng))
                       for dt in (torch.float32, torch.float64)]
    # the edge operands of the design's CPU test at the mesh's size: inf
    # (-inf in the last case) and NaN in every operand that can carry one,
    # a level-0 pivot at the 1e-300 clamp and an overflowing cp
    # (loaded by its path: another package named `tests` may be installed)
    spec = importlib.util.spec_from_file_location(
        "heat_design", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "test_torch_heat_design.py"))
    design = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(design)
    for nz_x, dt, inf in ((12, torch.float32, np.inf),
                          (7, torch.float64, np.inf),
                          (12, torch.float64, -np.inf)):
        rng_e = np.random.default_rng(nz_x)
        edge = design.place_every(design.operands(
            nz_x, dt, "subgrid", 1.0, rng_e, n=mesh.nV), rng_e, inf)
        heat_cases.append(heat_case(
            f"heat_columns_edges_nz{nz_x}_{str(dt)[6:]}"
            f"{'_neg' if inf < 0 else ''}",
            [a.cuda() if isinstance(a, torch.Tensor) else a for a in edge]))

    # -- the multidevice phase's ranks start here: their start-up goes on
    # beside phases 5-9, and they wait, idle, for 9b
    md = multidevice_start(mesh, with_f64_step=False)
    try:
        # -- 5. small configuration: card (kernels) against CPU (plain) ----
        mesh_s_small = build_mesh_from_config(Config(**SMALL), "ANT")
        # 35's NaN sanitizer on this phase's two regions once they are done
        small_phase("small", Config(**SMALL), mesh_s_small,
                    then=validation_sanitizer)
        small_phase("small_thermo", Config(**SMALL_THERMO), mesh_s_small)
        with tempfile.TemporaryDirectory() as workdir:
            small_mismipplus_phase(workdir)

        # -- 6. main path at full width ------------------------------------
        region, state, main = drive_full(C, mesh, "")
        say("main_path", mesh_build_s=mesh_s, **main)
        init_its, w_axb, x_GL_km = (main["initial_gmres_its"],
                                    main["n_Axb_its"], main["x_GL_km"])
        assert main["heat_columns_launches"] == 0
        assert (init_its, w_axb) == (INIT_GMRES_ITS, WINDOW_AXB_ITS) \
            and abs(x_GL_km - X_GL_KM) < 0.01, \
            (f"the f32 trajectory moved: {init_its} initial GMRES "
             f"iterations, {w_axb} Krylov iterations in the window, x_GL "
             f"{x_GL_km:.3f} km "
             f"(expected {INIT_GMRES_ITS}, {WINDOW_AXB_ITS}, {X_GL_KM}): the "
             "rounding or the summation order of the operator changed")

        # -- 7. profile (optional) -----------------------------------------
        if args.profile > 0:
            profile_steps(region, args.profile, args.profile_out)

        # -- 8. thermodynamics path at full width, 9. Halfar dome (SIA) ----
        th, hot_heat = thermo_path(Config(**FULL_THERMO), mesh)
        halfar, halfar_heat = halfar_phase()
        heat_cases += [hot_heat, halfar_heat]

        # -- 9b. multi-device runs: the 8 km path over 2 and 4 gloo ranks -----
        md_launches, md_cases = multidevice_phase(md)
    finally:
        multidevice_stop(md)

    # -- 10. MISMIP+ through the program's entry point, 11. preconditioners,
    # 12. remeshing at full width, 13. small_remesh, 14. the MISMIP+
    # spin-up resumed, 15. Berends et al. (2023) experiment II, 16. MISMIP+
    # ice1r, 17. Favier et al. (2019) melt, 18. the experiment II chain at
    # 40 km card against CPU, 19. thermodynamics and SMB from files; the
    # CPU runs that 13, 14, 16, 17 and 18 are held to go on beside the
    # card's runs from the start of 10, one thread each
    # 35's quick tier: a process of its own on the card from here on, its
    # host-bound runs beside those of 10-19 as the CPU jobs are (stopped
    # and removed however the run ends)
    val_dir = tempfile.mkdtemp()
    val_job = start_validation_job(val_dir)
    atexit.register(stop_job, val_job[0], val_dir)
    # 26-33 (Antarctica, the climate chain, antarctica_hydro and the
    # LADDIE slice): a card job from here on, beside 10-25
    ant_dir = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, ant_dir, True)
    ant_out = os.path.join(ant_dir, "antarctica_laddie.pt")
    ant_job = start_card_job("antarctica_laddie_job", ant_dir, ant_out,
                             repr(args.ant_init_years))
    atexit.register(stop_card_job, ant_job)
    with tempfile.TemporaryDirectory() as workdir:
        jobs = dict(
            small_remesh=start_small_remesh_cpu(workdir),
            resume=start_resume_cpu(workdir),
            ice1r=start_retreat_cpu("mismipplus_ice1r", "MP_ICE1R", workdir),
            favier=start_retreat_cpu("mismipplus_favier", "MP_FAVIER",
                                     workdir),
            small_berends=start_small_berends_cpu(workdir))
        try:
            mp_dir = os.path.join(workdir, "mismipplus")
            os.makedirs(mp_dir)
            mp_region, mp_last, mp = mismipplus_phase(mp_dir)
            # 35's run tools, on this phase's output directory
            validation_tools(os.path.join(mp_dir, "mismipplus_out"))
            mp_A = mp_last["A"]
            diva_cases.append(diva_check("diva_apply_mismipplus_last_apply",
                                         mp_A, torch.cat(mp_last["x"])))
            mp_precond = precond_solves(mp_region, mp_last)
            rm, rm_diva, rm_stack = remesh_phase(mesh)
            diva_cases.append(rm_diva)
            cases.append(rm_stack)
            small_remesh_phase(workdir, mesh_s_small, jobs["small_remesh"])
            mpr = mismipplus_resume_phase(workdir, jobs["resume"])
            ex2 = berends_exp2_phase(workdir)
            ir = retreat_phase("mismipplus_ice1r", "MP_ICE1R", IR_YEARS,
                               workdir, jobs["ice1r"])
            fav = retreat_phase("mismipplus_favier", "MP_FAVIER",
                                FAVIER_YEARS, workdir, jobs["favier"])
            small_berends_phase(workdir, jobs["small_berends"])
            stf = small_thermo_files_phase(workdir, mesh_s_small)
        finally:
            for proc, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    # -- 20-25. ISMIP-HOM: BPA and the hybrid DIVA/BPA ----------------------
    with tempfile.TemporaryDirectory() as workdir:
        ih_nums, ih_kernels = bpa_slice_finish(ih, workdir)
    # -- 26-28. the realistic Antarctica stand-in, the climate chain, and
    # antarctica_hydro (from 26's restart); 29-33. the LADDIE slice:
    # MISOMIP iceocean1r, the laddie_stage cases, the standalone plume,
    # small_iceocean and small_hydro (on 28's 80 km data): the card job's
    # results ------------------------------------------------------------
    ((ant_init, ant_itm, (init_cases, itm_cases), (ant_hydro, _)),
     (lad_nums, (lad_cases, lad_steps))), ant_wait_s = finish_card_job(
        ant_job, ant_out, "antarctica_laddie_job")
    say("antarctica_laddie_job_wait", seconds=ant_wait_s)
    shutil.rmtree(ant_dir, ignore_errors=True)
    # -- 35. the validation harness: component and quick integrated tests
    # through program.main, the demo model, the NaN sanitizer ------------
    try:
        val_launches, val_cases = validation_phase(val_dir, val_job)
    finally:
        stop_job(val_job[0], val_dir)
    diva_cases.append(val_cases["diva"])
    heat_cases.append(val_cases["heat"])
    diva_cases += [init_cases["diva"], itm_cases["diva"]]
    cases.append(init_cases["stack"])
    heat_cases += [init_cases["heat"], itm_cases["heat"]]
    ir_pins = (IR_STEPS, IR_VISC_ITS, IR_AXB_ITS)
    ir_got = tuple(ir["f32"][k] for k in ("steps", "n_visc_its",
                                          "n_Axb_its"))
    assert ir_got == ir_pins, \
        (f"the f32 ice1r trajectory moved: {ir_got} (expected {ir_pins})")
    new_paths = {"mismipplus_ice1r": ir["f32"], "mismipplus_favier":
                 fav["f32"], **{f"berends_exp2_{k}": v for k, v in
                                ex2["legs"].items()}}

    kernels = [{
        "name": "stack_spmv", "route": "cuda",
        "source": "ufemism2_tpu_torch/csrc/stack_spmv.cu",
        "replaces": "ufemism2_tpu/ops/pallas_spmv.py:57",
        "launches": main["stack_spmv_launches"],
        "launches_by_path": {"main_path": main["stack_spmv_launches"],
                             "thermo_path": th["stack_spmv_launches"],
                             "mismipplus": mp["stack_spmv_launches"],
                             "remesh": rm["stack_spmv_launches"],
                             "mismipplus_resume":
                                 mpr["stack_spmv_launches"],
                             **{k: v["stack_spmv_launches"]
                                for k, v in new_paths.items()},
                             "small_thermo_files":
                                 stf["stack_spmv_launches"],
                             **ant_launches(ant_init, ant_itm,
                                            "stack_spmv_launches")},
        "max_abs_err": hot["max_abs_err"], "ms": hot["ms"],
        "device_ms": hot["device_ms"],
        "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"], "library_ms": hot["library_ms"],
        "timed_case": hot["case"], "cases": cases,
    }, {
        "name": "diva_apply", "route": "cuda",
        "source": "ufemism2_tpu_torch/csrc/stack_spmv.cu",
        "replaces": "ufemism2_tpu/ops/pallas_spmv.py:57",
        "fuses": "ufemism2_tpu/core/ice/ssadiva.py:208",
        "launches": main["diva_apply_launches"],
        "launches_by_path": {"main_path": main["diva_apply_launches"],
                             "thermo_path": th["diva_apply_launches"],
                             "mismipplus": mp["diva_apply_launches"],
                             "remesh": rm["diva_apply_launches"],
                             "mismipplus_resume":
                                 mpr["diva_apply_launches"],
                             **{k: v["diva_apply_launches"]
                                for k, v in new_paths.items()},
                             "small_thermo_files":
                                 stf["diva_apply_launches"],
                             **ant_launches(ant_init, ant_itm,
                                            "diva_apply_launches")},
        "max_abs_err": hot_diva["max_abs_err"], "ms": hot_diva["ms"],
        "device_ms": hot_diva["device_ms"],
        "plain_ms": hot_diva["plain_ms"], "bound_ms": hot_diva["bound_ms"],
        "bound_by": hot_diva["bound_by"], "library_ms": None,
        "timed_case": hot_diva["case"], "cases": diva_cases,
    }, {
        "name": "heat_columns", "route": "cuda",
        "source": "ufemism2_tpu_torch/csrc/heat_columns.cu",
        "replaces": "ufemism2_tpu/core/ice/thermodynamics.py:267",
        "replaces_kind": "XLA-lowered code (make_heat_solver + "
                         "ops/tridiag.py thomas_batched), no pallas_call",
        "launches": th["heat_columns_launches"],
        "launches_by_path": {"thermo_path": th["heat_columns_launches"],
                             "halfar": halfar["heat_columns_launches"],
                             "remesh": rm["heat_columns_launches"],
                             "mismipplus_resume":
                                 mpr["heat_columns_launches"],
                             "small_thermo_files":
                                 stf["heat_columns_launches"],
                             **ant_launches(ant_init, ant_itm,
                                            "heat_columns_launches")},
        "max_abs_err": hot_heat["max_abs_err"], "ms": hot_heat["ms"],
        "device_ms": hot_heat["device_ms"],
        "plain_ms": hot_heat["plain_ms"], "bound_ms": hot_heat["bound_ms"],
        "bound_by": hot_heat["bound_by"],
        "library_ms": hot_heat["library_ms"],
        "timed_case": hot_heat["case"], "cases": heat_cases,
    }]
    kernels[0]["launches_by_path"]["ismip_hom_a_bpa"] = \
        ih_nums["ismip_hom_a_bpa"]["stack_spmv_launches"]
    kernels[1]["launches_by_path"]["ismip_hom_a_diva"] = \
        ih_nums["ismip_hom_a_diva"]["diva_apply_launches"]
    for i, key in ((0, "stack_spmv_launches"), (1, "diva_apply_launches"),
                   (2, "heat_columns_launches")):
        by_path = kernels[i]["launches_by_path"]
        if i < 2:
            by_path["mismipplus_iceocean1r"] = lad_nums["iceocean1r"][key]
        by_path["antarctica_hydro"] = ant_hydro[key]
    for i, key in ((0, "stack_spmv_launches"), (1, "diva_apply_launches"),
                   (2, "heat_columns_launches")):
        kernels[i]["launches_by_path"].update(md_launches[key])
        kernels[i]["launches_by_path"].update(
            {path: c[key] for path, c in val_launches.items()})
    cases += [c for c in md_cases if c["kernel"] == "stack_spmv"]
    diva_cases += [c for c in md_cases if c["kernel"] == "diva_apply"]
    kernels.append(laddie_kernel_entry(lad_nums, lad_cases, lad_steps))
    print(json.dumps({"kernels": kernels + ih_kernels}), flush=True)
    print(card_line, flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
