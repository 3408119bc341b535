#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile STEPS] [--profile-out FILE]

Needs one CUDA device and nvcc; exits non-zero without them. Phases, each
of which ends the run with a non-zero exit if it fails:

1. device   - the card's name and power limit; TF32 must be off.
2. build    - compiles ufemism2_tpu_torch/csrc/*.cu from source.
3. mesh     - builds the MISMIP_mod 8 km mesh on the host (a stand-in for
              config_MISMIP_8km_spinup_for_scaling.cfg, which is not in
              the repository: same geometry, physics choices and
              grounding-line resolution, written inline).
4. kernels  - stack_spmv and diva_apply (the DIVA operator fused onto it)
              against their plain tensor versions on the card at the 8 km
              shapes, with timings and the bound; torch.sparse.mm is the
              library yardstick of stack_spmv (no one PyTorch call computes
              diva_apply).
5. small    - the coarse 64 km configuration in f64 on the card (CUDA
              kernel) against the same run on the CPU (plain version).
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

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, NVIDIA H100 SXM data sheet
H100_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.float64: 33.5e12}    # f64 outside the tensor cores
T_WARM = 20.0      # model years of start-up transient before the window
WINDOW = 40.0      # model years of the measured window
REPS = 200         # launches per kernel timing
# GMRES iterations of the initial solve and Krylov iterations of the window
# on the FULL configuration, and the grounding line after it [km]
INIT_GMRES_ITS, WINDOW_AXB_ITS, X_GL_KM = 3286, 1568, 457.457

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
# the coarse configuration of the CPU parity tests
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


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_ms(fn, reps):
    """Mean time of fn() in ms over `reps` back-to-back eager calls (CUDA
    events): what a caller in a Python loop pays per call, host work
    included."""
    for _ in range(50):
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


def diva_case(name, mesh, m2, dtype, round_x, rng):
    """One diva_apply comparison: kernel vs plain on the same operands,
    plus the roofline bound for this data."""
    from ufemism2_tpu_torch.ops import cuda_spmv
    S, rows, fields, x = diva_operands(mesh, m2, dtype, rng)
    n = mesh.nTri
    A = cuda_spmv.DivaOperator(S.op, rows, *fields, round_x_bf16=round_x)
    n0 = cuda_spmv.diva_launches
    y = A.flat(x)
    yu, yv = A((x[:n], x[n:]))
    torch.cuda.synchronize()
    assert cuda_spmv.diva_launches == n0 + 2
    assert torch.equal(torch.cat([yu, yv]), y)
    plain = lambda: cuda_spmv.diva_apply_plain(
        (S.cols, S.vals), rows, *fields, x[:n], x[n:], round_x)
    y_ref = torch.cat(plain())
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape and y.dtype == dtype
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    # the kernel's k-loop, its fused multiply-adds and the plain version's
    # reductions sum in different orders: a few ulps of the largest result
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * scale
    # rows that are not free hold copies and three-term sums of the
    # unrounded operand, added in the plain version's order: equal to it
    # to the bit
    bdry = torch.cat([~rows.free, ~rows.free])
    err_bdry = float((y - y_ref)[bdry].abs().max())
    ok = bool(torch.isfinite(y).all()) and err <= tol and err_bdry == 0.0

    ms = time_ms(lambda: A.flat(x), REPS)
    n1 = cuda_spmv.diva_launches
    device_ms = graph_ms(lambda: A.flat(x), REPS)
    assert cuda_spmv.diva_launches == n1 + REPS + 3
    plain_ms = time_ms(plain, max(REPS // 10, 5))

    size = x.element_size()
    nnz = int(sum(abs(m) for m in m2).tocsr().nnz)
    n_bdry = int((~rows.free).sum())
    # in: the shared index table and five coefficient tables, u, v, four
    # fields, the row code and the boundary rows' neighbour table;
    # out: Au, Av
    nbytes = (nnz * 4 + 5 * nnz * size + 6 * n * size + n
              + n_bdry * 12 + 2 * n * size)
    flops = 2 * 5 * nnz * 2 + 30 * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FLOPS[dtype] * 1e3
    out = dict(case=name, n_rows=n, K=S.K, nnz=nnz, boundary_rows=n_bdry,
               dtype=str(dtype).replace("torch.", ""), round_x_bf16=round_x,
               max_abs_err=err, tol=tol, max_abs_y=scale,
               max_abs_err_boundary=err_bdry, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=None, bytes=nbytes, flops=flops,
               bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               ok=ok)
    say("diva_case", **out)
    if not ok:
        raise SystemExit(f"diva_apply disagrees with its plain version in "
                         f"case {name}: err {err:.3e} > tol {tol:.3e} or "
                         f"boundary rows differ by {err_bdry:.3e}")
    return out


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="profile this many further ice steps")
    ap.add_argument("--profile-out", default=None, metavar="FILE",
                    help="write the profiler's table of operators here")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ufemism2_tpu_torch.ops import cuda_spmv     # sets TF32 off
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.main.region import ModelRegion
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.core.ice import ssadiva
    assert torch.backends.cuda.matmul.allow_tf32 is False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    say("device", card=card_line, torch=torch.__version__,
        cuda=torch.version.cuda)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_spmv.load_kernels()
    say("build", seconds=time.perf_counter() - t0,
        source="ufemism2_tpu_torch/csrc/stack_spmv.cu")

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
    # the calls the main path makes: the fused operator once per Krylov
    # iteration, and of the single-operator applies the largest
    hot_diva = diva_cases[0]
    hot = next(c for c in cases
               if c["case"] == f"M_map_b_a_1op_d{C.nz}_float32_bf16x")

    # -- 5. small configuration: card (kernel) against CPU (plain) ---------
    Cs = Config(**SMALL)
    mesh_s_small = build_mesh_from_config(Cs, "ANT")
    t0 = time.perf_counter()
    r_cpu = ModelRegion(Cs, "ANT", mesh=mesh_s_small, device="cpu")
    r_cpu.run_to(0.35)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_gpu = ModelRegion(Cs, "ANT", mesh=mesh_s_small, device="cuda")
    r_gpu.run_to(0.35)
    t_gpu = time.perf_counter() - t0
    sc, sg = r_cpu.state, r_gpu.state
    gaps = {}
    for name in ("Hi", "u_vav_b", "v_vav_b"):
        a, b = getattr(sc, name), getattr(sg, name).cpu()
        gaps[name] = float((a - b).abs().max() / a.abs().max())
    say("small", nV=mesh_s_small.nV, nTri=mesh_s_small.nTri,
        steps=r_gpu.n_dt_ice, n_visc_its=[sc.n_visc_its, sg.n_visc_its],
        n_Axb_its=[sc.n_Axb_its, sg.n_Axb_its], rel_gap=gaps,
        seconds_cpu=t_cpu, seconds_card=t_gpu)
    # two f64 runs that differ only in the summation order of the SpMV
    # and of the reductions: GMRES at rtol 1e-7 bounds the velocity gap
    assert r_cpu.n_dt_ice == r_gpu.n_dt_ice
    assert sc.n_visc_its == sg.n_visc_its
    assert abs(sc.n_Axb_its - sg.n_Axb_its) <= 0.02 * sc.n_Axb_its
    assert gaps["Hi"] < 1e-6 and gaps["u_vav_b"] < 1e-5 \
        and gaps["v_vav_b"] < 1e-5, gaps

    # -- 6. main path at full width ----------------------------------------
    gm = {"calls": 0, "its": 0}
    gmres_inner = ssadiva.gmres

    def gmres_counted(*a, **kw):
        res = gmres_inner(*a, **kw)
        gm["calls"] += 1
        gm["its"] += res.n_iter
        return res
    ssadiva.gmres = gmres_counted

    cuda_spmv.launches = 0
    cuda_spmv.diva_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    region = ModelRegion(C, "ANT", mesh=mesh)      # device defaults to cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_its, init_calls = gm["its"], gm["calls"]
    say("initial_solve", seconds=init_s, gmres_its=init_its,
        gmres_calls=init_calls,
        stack_spmv_launches=cuda_spmv.launches,
        diva_apply_launches=cuda_spmv.diva_launches,
        max_speed=float(torch.sqrt(region.state.u_vav_b ** 2
                                   + region.state.v_vav_b ** 2).max()))
    # start-up transient (dt grows from dt_ice_min), then the measured
    # window: the two phases of the JAX package's bench.py, shortened
    t0 = time.perf_counter()
    region.run_to(T_WARM)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = dict(steps=region.n_dt_ice, n_visc=region.state.n_visc_its,
                n_axb=region.state.n_Axb_its, gmres=gm["its"],
                t=region.time)
    say("warm_up", t_model_yr=region.time, steps=warm["steps"],
        wall_s=warm_s, n_visc_its=warm["n_visc"], n_Axb_its=warm["n_axb"],
        dt_ice=region.state.dt_ice)
    t0 = time.perf_counter()
    state = region.run_to(T_WARM + WINDOW)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = cuda_spmv.launches
    diva_launches = cuda_spmv.diva_launches
    ssadiva.gmres = gmres_inner

    n_tensors = check_state(state, "cuda")
    volume = float((state.Hi * region.md.A).sum())
    w_axb = state.n_Axb_its - warm["n_axb"]
    w_steps = region.n_dt_ice - warm["steps"]
    x_GL_km = find_x_GL(mesh, state.TAF) / 1e3
    say("main_path", nV=mesh.nV, nTri=mesh.nTri, mesh_build_s=mesh_s,
        precision=C.tpu_precision, initial_solve_s=init_s,
        initial_solve_ms_per_krylov_it=init_s * 1e3 / max(init_its, 1),
        warm_up_s=warm_s, window_yr=region.time - warm["t"],
        window_steps=w_steps, wall_s=run_s,
        sim_yr_per_hr=(region.time - warm["t"]) / run_s * 3600.0,
        s_per_step=run_s / max(w_steps, 1),
        n_visc_its=state.n_visc_its - warm["n_visc"], n_Axb_its=w_axb,
        gmres_its=gm["its"] - warm["gmres"],
        ms_per_krylov_it=run_s * 1e3 / max(w_axb, 1),
        dt_ice=state.dt_ice, x_GL_km=x_GL_km,
        steps_total=region.n_dt_ice, n_Axb_its_total=state.n_Axb_its,
        gmres_its_total=gm["its"],
        gmres_calls_total=gm["calls"],
        stack_spmv_launches=launches, diva_apply_launches=diva_launches,
        ice_volume_m3=volume, state_tensors_checked=n_tensors,
        peak_device_MiB=torch.cuda.max_memory_allocated() / 2 ** 20)
    assert w_steps >= 1 and warm["steps"] >= 1, "no ice step was taken"
    assert volume > 0.0, "ice volume is not positive"
    assert w_axb > 0 and state.n_visc_its > warm["n_visc"]
    # GMRES applies the operator once per counted iteration and once more
    # per solve (the residual before the first cycle); every viscosity
    # iteration (one GMRES solve each) makes 16 single-operator applies
    assert diva_launches == gm["its"] + gm["calls"] and gm["its"] > 0, \
        "the main path did not go through diva_apply"
    assert launches > 16 * gm["calls"] > 0, \
        "the main path did not go through stack_spmv"
    assert region.md.device.type == "cuda"
    assert (init_its, w_axb) == (INIT_GMRES_ITS, WINDOW_AXB_ITS) \
        and abs(x_GL_km - X_GL_KM) < 0.01, \
        (f"the f32 trajectory moved: {init_its} initial GMRES iterations, "
         f"{w_axb} Krylov iterations in the window, x_GL {x_GL_km:.3f} km "
         f"(expected {INIT_GMRES_ITS}, {WINDOW_AXB_ITS}, {X_GL_KM}): the "
         "rounding or the summation order of the operator changed")

    # -- 7. profile (optional) ---------------------------------------------
    if args.profile > 0:
        profile_steps(region, args.profile, args.profile_out)

    kernels = [{
        "name": "stack_spmv", "route": "cuda",
        "source": "ufemism2_tpu_torch/csrc/stack_spmv.cu",
        "replaces": "ufemism2_tpu/ops/pallas_spmv.py:57",
        "launches": launches,
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
        "launches": diva_launches,
        "max_abs_err": hot_diva["max_abs_err"], "ms": hot_diva["ms"],
        "device_ms": hot_diva["device_ms"],
        "plain_ms": hot_diva["plain_ms"], "bound_ms": hot_diva["bound_ms"],
        "bound_by": hot_diva["bound_by"], "library_ms": None,
        "timed_case": hot_diva["case"], "cases": diva_cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line, flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
