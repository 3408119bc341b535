"""Variants of the LADDIE kernel (ufemism2_tpu_torch/csrc/laddie.cu), timed
in turns on one card.

Each variant is a copy of csrc/laddie.cu, written under build/variants/,
with other values of its UF_* constants or with a part patched by exact
text (the committed source is the design's choice and carries no switch
for its alternatives); a probe is such a copy that breaks the result on
purpose to time one part of the work. Every variant runs the same
operands through the same wrappers of ops/cuda_laddie.py (only the
library differs): the leg entry (`laddie_leg`, ms a pseudo-step over a
leg of --steps, CUDA events) and the stage entry (`laddie_stage`, device
ms by graph replay), in rounds that run the variants in order and then in
reverse order; a variant that is not a probe is held to the loop of plain
stages to the bit over 20 pseudo-steps. Operands: the 2 km standalone
set-up of chip_smoke.py (LADDIE_STANDALONE, 38,853 rows) and the compact
shelf mesh (the shelf and 3 rings, padded to 256 rows, as the model's path
cuts it: about 1,000 rows and ELL rows past 100 entries) of the shelf of
tests/test_torch_laddie_design.py on a uniform mesh of 100 km square at 4
km, the plume perturbed with seeded noise, fbrk3 with non-zero beta, f32
and f64.

    python3 tools/laddie_kernel_variants.py [--only NAME,...]
        [--rounds N] [--steps N] [--small-only] [--out FILE]

Needs one CUDA card and nvcc. Prints one JSON line a measurement, the
compiler's register and spill counts of every variant, the card's name
and power limit, and a summary line last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> {constant: value} set in the copy; "design" is the source as
# committed
VARIANTS = {
    "design": {},
    "threads64": {"UF_LADDIE_THREADS": 64},
    "threads256": {"UF_LADDIE_THREADS": 256},
}

# patches of the copy: name -> [(text, replacement)]; a text the source no
# longer holds raises. The variants are bit-equal; the probes time a part
# of the work alone and are never bit-equal.
PATCHES = {
    # the edge means divided by their count (1 or 2), not
    # multiplied by its exact reciprocal
    "b_to_c_div": [("return mul(add(v0, v1), n > 1 ? T(0.5) : T(1));",
                    "return dvd(add(v0, v1), (T)(n > 1 ? n : 1));")],
    # one lane a row (every gather of a row on one thread); 32 lanes a row
    # on every mesh, the 2 km one too
    "lanes1": [("    return one_wave<T, 32>(d) ? 32 : 1;",
                "    return d.nV < 0 ? 32 : 1;")],
    "lanes32_always": [("    return one_wave<T, 32>(d) ? 32 : 1;",
                        "    return d.nV >= 0 ? 32 : 1;")],
    # every ELL row summed over its whole width, padding and all
    "ell_full_rows": [("        m = __ldg(lens + r);",
                       "        m = __ldg(lens + r) > 0 ? K : K;")],
    # fixed tables, masks and forcing through plain loads
    "no_ldg": [("    return __ldg((const X*)p + i);",
                "    return ((const X*)p)[i];")],
}
PROBES = {
    # (an empty statement keeps the grid barrier out of the row loop)
    "no_triangle_pass": [("                triangle_row<T, L>(d, s, q / L, "
                          "grp);\n", "                ;\n")],
    "no_vertex_pass": [("                vertex_row<T, L>(d, s, z, q / L, "
                        "grp);\n", "                ;\n")],
    "no_voronoi": [("    voronoi_div<T, L>(d, s, i, Hr, Tr, Sr, g, dQH, "
                    "dQT, dQS);\n", "    dQH = dQT = dQS = T(0);\n")],
    "no_neighbours": [("        neighbour_terms<T>(d, s, k, r, g.lane < 3 ? "
                       "g.lane : 0, Hstar_b, Ur,\n                        "
                       "   Vr, TriA, fU, fV, gU, gV);\n",
                       "        fU = fV = gU = gV = T(0);\n")],
    # divisions made multiplications: what the divisions cost
    "no_div": [("return __fdiv_rn(a, b);", "return __fmul_rn(a, b);"),
               ("return __ddiv_rn(a, b);", "return __dmul_rn(a, b);")],
}
PATCHES.update(PROBES)


T_START = time.perf_counter()


def say(what, **kv):
    print(json.dumps({"what": what, **kv,
                      "at_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


def ptxas_summary(text):
    """(kernel, registers, spill stores, spill loads) from nvcc's
    -Xptxas=-v output, one entry a compiled leg kernel."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if "leg_kernel" in name:
                out.append([re.sub(r"^_Z\d+", "", name)[:40],
                            int(m.group(1)), *spill])
            name = None
    return out


def variant_source(name, source, build):
    """The copy of `source` for a variant or a probe, written under
    `build`."""
    text = source.read_text()
    for a, b in PATCHES.get(name, []):
        if a not in text:
            raise ValueError(f"{name}: the source has no {a!r}")
        text = text.replace(a, b)
    for const, value in VARIANTS.get(name, {}).items():
        text, hits = re.subn(rf"^#define {const} \S+", f"#define {const} "
                             f"{value}", text, flags=re.M)
        if hits != 1:
            raise ValueError(f"{name}: the source has no #define {const}")
    path = build / f"laddie_{name}.cu"
    path.write_text(text)
    return path


def nvcc(source, lib):
    """nvcc `source` into `lib` with ops/_build.py's flags and the
    compiler's register report; returns its output."""
    from ufemism2_tpu_torch.ops import _build
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    r = subprocess.run([exe, *_build._NVCC_FLAGS, "-Xptxas=-v", "-o",
                        str(lib), str(source)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def build_all(names):
    from ufemism2_tpu_torch.ops import _build, cuda_laddie
    build = _build._BUILD / "variants"
    build.mkdir(parents=True, exist_ok=True)
    jobs = {n: variant_source(n, _build._CSRC / "laddie.cu", build)
            for n in names}

    def one(item):
        name, src = item
        lib = build / f"libladdie_{name}.so"
        t0 = time.perf_counter()
        return name, lib, nvcc(src, lib), time.perf_counter() - t0

    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
        built = list(pool.map(one, jobs.items()))
    libs, builds = {}, []
    for name, lib, text, secs in built:
        cuda_laddie._lib = None
        real = cuda_laddie.build_kernel
        cuda_laddie.build_kernel = lambda _n, lib=lib: lib
        try:
            libs[name] = cuda_laddie.load_kernels()
        finally:
            cuda_laddie.build_kernel = real
            cuda_laddie._lib = None
        builds.append(dict(variant=name, seconds=secs,
                           leg_kernels=ptxas_summary(text)))
        say("build", **builds[-1])
    return libs, builds


def operands(small_only=False):
    """{case: (step, state, masks, forcing)}: the 2 km standalone set-up
    (not with `small_only`) and the compact mesh of the 4 km shelf, fbrk3
    with non-zero beta, in f32 and f64."""
    import chip_smoke as cs
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice.masks import determine_masks
    from ufemism2_tpu_torch.core.ice.state import init_ice_state
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.mesh import build_uniform_mesh
    from ufemism2_tpu_torch.models import laddie as tl
    from ufemism2_tpu_torch.models.ocean import (make_run_ocean,
                                                 ocean_depth_axis)
    from ufemism2_tpu_torch.ops.cuda_laddie import LaddieState
    beta = dict(laddie_fbrk3_beta1=0.5, laddie_fbrk3_beta2=0.5,
                laddie_fbrk3_beta3=0.344)
    sets = {}
    if not small_only:
        with contextlib.redirect_stdout(sys.stderr):
            C2, md2, lm2, fc2, st2, _ = cs.standalone_operands()
        sets["standalone2km"] = (Config(**dict(cs.LADDIE_STANDALONE,
                                               **beta)), md2, lm2, fc2, st2)
    C = Config(dt_laddie=360.0, choice_ocean_model_ANT="idealised",
               choice_ocean_model_idealised="MISMIPplus_WARM", **beta)
    mesh = build_uniform_mesh(-50e3, 50e3, -50e3, 50e3, 4e3)
    md = build_mesh_data(mesh, dtype=torch.float64, device="cuda")
    x = mesh.V[:, 0]
    Hb = np.where(x < -20e3, 100.0, -600.0)
    Hi = np.where(x < 20e3, np.where(x < -20e3, 500.0, 300.0), 0.0)
    s = init_ice_state(md, Hi, Hb, np.zeros_like(Hi), nz=4, dt_init=0.1)
    masks = determine_masks(md, s.Hi, s.Hb, s.SL)
    oc = make_run_ocean(C, md, "ANT")(0.0, s)
    fc = {"Hib": s.Hib, "dHib_dx_b": md.M_ddx_a_b @ s.Hib,
          "dHib_dy_b": md.M_ddy_a_b @ s.Hib, "Ti_base": s.Ti[:, 0] - 273.15,
          "use_Ti": False, "z_ocean": torch.as_tensor(
              ocean_depth_axis(C), dtype=torch.float64, device="cuda"),
          "T_ocean": oc["T"], "S_ocean": oc["S"],
          "SGD": torch.zeros(md.nV, dtype=torch.float64, device="cuda")}
    st = tl.init_laddie_state(C, md, tl.laddie_masks(md, masks), fc)
    # the compact shelf mesh, as make_run_bmb_laddie cuts it
    mdc, (Vk, _), (Tk, _), _ = tl.build_compact_laddie_md(
        md, masks["mask_floating_ice"].cpu().numpy())
    iV, iT = (torch.as_tensor(Vk, device="cuda"),
              torch.as_tensor(Tk, device="cuda"))
    lmc = tl.laddie_masks(mdc, {k: masks[k][iV] for k in (
        "mask_floating_ice", "mask_grounded_ice", "mask_icefree_land",
        "mask_icefree_ocean")})
    fcc = {k: (v[iT] if k.startswith("dHib") else v[iV])
           if isinstance(v, torch.Tensor) and k != "z_ocean" else v
           for k, v in fc.items()}
    sets["compact4km"] = (C, mdc, lmc, fcc, LaddieState(
        H=st.H[iV], U=st.U[iT], V=st.V[iT], T=st.T[iV], S=st.S[iV]))
    rng = np.random.default_rng(4)
    out = {}
    for tag, (C, md, lm, fc, st) in sets.items():
        for dtype in (torch.float32, torch.float64):
            cast = lambda t: t.to(dtype).contiguous() \
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                else t
            mdt = md if md.A.dtype == dtype else build_mesh_data(
                md._host_mesh, dtype=dtype, device="cuda")
            step = tl.make_laddie_step(C, mdt)
            n = lambda k, s: torch.as_tensor(
                s * rng.standard_normal(k)).to(dtype).cuda()
            state = LaddieState(H=cast(st.H) + n(md.nV, 0.5).abs(),
                                U=cast(st.U) + n(md.nTri, 0.02),
                                V=cast(st.V) + n(md.nTri, 0.02),
                                T=cast(st.T), S=cast(st.S))
            out[f"{tag}_{str(dtype)[6:]}"] = (
                step, state, lm, {k: cast(v) for k, v in fc.items()})
    return out


def measure(case, ops, name, lib, steps, reps):
    import chip_smoke as cs
    from ufemism2_tpu_torch.ops import cuda_laddie as cl
    step, state, lm, fc = ops
    tab, P, sch = step.tables, step.params, step.scheme
    cl._lib = lib
    try:
        bit_equal = None
        if name not in PROBES:
            leg = cl.laddie_leg(tab, P, sch, state, lm, fc, 20)
            carry = (state, state)
            for _ in range(20):
                carry, ph = cl.laddie_step(tab, P, sch, carry, lm, fc,
                                           cl.laddie_stage_plain)
            bit_equal = all(bool(torch.equal(a, b)) for a, b in zip(
                list(leg[0]) + [leg[1]], list(carry[0]) + [ph["melt"]]))
        cl.laddie_leg(tab, P, sch, state, lm, fc, 10)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        cl.laddie_leg(tab, P, sch, state, lm, fc, steps)
        e1.record()
        torch.cuda.synchronize()
        leg_ms = e0.elapsed_time(e1) / steps
        dt_i, visc, kind, coefs = sch.stages()[-1]
        stage_ms = cs.graph_ms(lambda: cl.laddie_stage(
            tab, P, state, state, lm, fc, dt_i, visc,
            (kind, coefs, state.H)), reps)
    finally:
        cl._lib = None
    out = dict(case=case, variant=name, nV=tab.nV, bit_equal=bit_equal,
               leg_ms_a_step=leg_ms, stage_device_ms=stage_ms)
    say("time", **out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant or probe names (default: "
                         "all)")
    ap.add_argument("--small-only", action="store_true",
                    help="the compact 4 km shelf alone (no 2 km standalone "
                         "set-up)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("laddie_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    names = args.only.split(",") if args.only else [*VARIANTS, *PATCHES]
    t0 = time.perf_counter()
    libs, builds = build_all(names)
    say("built", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cases = operands(args.small_only)
    say("operands", seconds=time.perf_counter() - t0,
        rows={k: v[0].tables.nV for k, v in cases.items()})
    results = []
    for rnd in range(args.rounds):
        seq = names if rnd % 2 == 0 else names[::-1]
        for name in seq:
            for case, ops in cases.items():
                results.append(measure(case, ops, name, libs[name],
                                       args.steps, args.reps))
    summary = {}
    for r in results:
        s = summary.setdefault(f"{r['case']}/{r['variant']}",
                               dict(leg=[], stage=[], bit_equal=True))
        s["leg"].append(r["leg_ms_a_step"])
        s["stage"].append(r["stage_device_ms"])
        s["bit_equal"] &= r["bit_equal"] is not False
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, builds=builds, results=results,
                           summary=summary), f, indent=1)
    print(card, flush=True)
    say("summary", **{k: dict(leg_ms_a_step=min(v["leg"]),
                              leg_max=max(v["leg"]),
                              stage_device_ms=min(v["stage"]),
                              bit_equal=v["bit_equal"])
                      for k, v in summary.items()})
    return 0 if all(v["bit_equal"] for v in summary.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
