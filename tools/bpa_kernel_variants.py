"""Variants of the BPA kernels (ufemism2_tpu_torch/csrc/bpa.cu), timed in
turns on one card at the ISMIP-HOM stand-in's full width.

Each variant is a copy of csrc/bpa.cu, written under build/variants/,
with other values of its UF_* constants or with a part of the design
patched out (the committed source is the design's choice, and carries no
switch for its alternatives); a probe is such a copy that breaks the
result on purpose to time one part of the work. `--old PATH` adds another
bpa.cu with the same C interface (an earlier version of the source) as
one more variant. Every variant runs the same operands through the same
`BpaOperator` / `LineThomas` (only the library function differs), is held
to the plain version to the bit, and is timed by chip_smoke.py's
`graph_ms` (L2 hot) and `graph_ms_cold` (a 64 MiB buffer written before
each call, its own time subtracted), in rounds that run the variants in
order and then in reverse order. Operands: chip_smoke.py's ISMIP_A mesh
(26,500 rows), random coefficient fields of chip_smoke.py's
`bpa_operands` at nz 12 (f32 with and without the rounding of x, f64)
and nz 7 (f32, rounded), and random diagonally dominant bands for
line_thomas; with `--ismip` also the last operator and preconditioner of
chip_smoke.py's ismip_hom_a_bpa on their last operands.

    python3 tools/bpa_kernel_variants.py [--old PATH] [--rounds N]
        [--only NAME,...] [--out FILE]

Needs one CUDA card and nvcc. Prints one JSON line a measurement, the
compiler's register and spill counts of every variant, the card's name
and power limit, and a summary line last.
"""

from __future__ import annotations

import argparse
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
    "run4": {"UF_BPA_RUN": 4},
    "run1": {"UF_BPA_RUN": 1},
    "run64_2": {"UF_BPA_RUN64": 2},
    "threads256": {"UF_BPA_THREADS": 256, "UF_BPA_MIN_BLOCKS": 3,
                   "UF_BPA_MIN_BLOCKS64": 3},
    "min_blocks4": {"UF_BPA_MIN_BLOCKS": 4, "UF_BPA_MIN_BLOCKS64": 4},
    "min_blocks8": {"UF_BPA_MIN_BLOCKS": 8, "UF_BPA_MIN_BLOCKS64": 8},
    "thomas_cols16": {"UF_THOMAS_COLS": 16},
    "thomas_cols64": {"UF_THOMAS_COLS": 64},
}


# patches of the copy: name -> [(text, replacement)]; a text the source no
# longer holds raises. "no_bf16_copy" is a variant (bit-equal): pass 1
# writes no bfloat16 copy, and pass 2 gathers the exact first derivatives
# and rounds each of them again. The others are probes, timing only, never
# bit-equal.
_FIRST_LAUNCH = ("bpa_first_kernel<T, ROUND, KT, NZ, R><<<blocks, threads, "
                 "0, stream>>>(\n        f, u, v);")
_ROWS_LAUNCH = "    bpa_rows_kernel<T, ROUND, KT, NZ, R><<<"
_BPA_START = "    const int nz = NZ > 0 ? NZ : f.nz;\n    int r, k0;"
_THOMAS_START = "    extern __shared__ __align__(16) unsigned char smem[];"
PATCHES = {
    "no_bf16_copy": [
        ("    st<T, 4 * R>(f.d1 + 4 * o, d);\n    if constexpr (ROUND) {",
         "    st<T, 4 * R>(f.d1 + 4 * o, d);\n    if constexpr (false) {"),
        ("        if constexpr (ROUND) {              // the copy rounded "
         "once\n",
         "        if constexpr (false) {\n"),
        ("            ld<T, 4 * R>(f.d1 + 4 * co, g);\n",
         "            ld<T, 4 * R>(f.d1 + 4 * co, g);\n"
         "            if (ROUND) round_bf16<4 * R>(g);\n")],
}
PROBES = {
    # launch and drain of bpa_apply's two kernels, no work
    "empty": [(_BPA_START, "    if (f.n >= 0) return;\n" + _BPA_START)],
    "pass1_only": [(_ROWS_LAUNCH, "    return 0;\n" + _ROWS_LAUNCH)],
    "pass2_only": [(_FIRST_LAUNCH, "")],
    # every gather from the thread's own row: the most local gathers
    "own_row": [("const int c = __ldg(f.cols + ek);",
                 "const int c = (__ldg(f.cols + ek) & 0) + r;")],
    # line_thomas launched with no work
    "thomas_empty": [(_THOMAS_START,
                      _THOMAS_START + "\n    if (n >= 0) return;")],
    # line_thomas's zero dividends through the IEEE division
    "thomas_zero_div": [("const bool z = a == 0.0f &&",
                         "const bool z = false && a == 0.0f &&"),
                        ("const bool z = a == 0.0 &&",
                         "const bool z = false && a == 0.0 &&")],
    # divisions made multiplications: what the divisions cost
    "no_div": [("return __fdiv_rn(a, b);", "return __fmul_rn(a, b);"),
               ("return __ddiv_rn(a, b);", "return __dmul_rn(a, b);"),
               ("= __fdiv_rn(z ? b : a, b);", "= __fmul_rn(z ? b : a, b);"),
               ("= __ddiv_rn(z ? b : a, b);", "= __dmul_rn(z ? b : a, b);")],
}
PATCHES.update(PROBES)


def say(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def ptxas_summary(text):
    """(kernel, registers, spill stores, spill loads) from nvcc's
    -Xptxas=-v output, one entry a compiled function."""
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
            short = re.sub(r"^_Z\d+", "", name)[:48]
            out.append([short, int(m.group(1)), *spill])
            name = None
    return out


def variant_source(name, source, build):
    """The copy of `source` for a variant or a probe, written under
    `build`; a probe's name may carry a variant's after a '+'
    (no_div+run1)."""
    first, _, base = name.partition("+")
    patches = PATCHES.get(first, [])
    consts = VARIANTS[base or "design"] if first in PATCHES \
        else VARIANTS[first]
    text = source.read_text()
    for a, b in patches:
        if a not in text:
            raise ValueError(f"{first}: the source has no {a!r}")
        text = text.replace(a, b)
    for const, value in consts.items():
        text, hits = re.subn(rf"^#define {const} \S+", f"#define {const} "
                             f"{value}", text, flags=re.M)
        if hits != 1:
            raise ValueError(f"{name}: the source has no #define {const}")
    path = build / f"bpa_{name.replace('+', '_')}.cu"
    path.write_text(text)
    return path


def nvcc(source, lib):
    """nvcc `source` into the shared library `lib` with the flags of
    ops/_build.py and the compiler's register report; returns its
    output."""
    from ufemism2_tpu_torch.ops import _build
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    r = subprocess.run([exe, *_build._NVCC_FLAGS, "-Xptxas=-v", "-o",
                        str(lib), str(source)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def build_all(names, old):
    from ufemism2_tpu_torch.ops import _build
    build = _build._BUILD / "variants"
    build.mkdir(parents=True, exist_ok=True)
    jobs = {n: variant_source(n, _build._CSRC / "bpa.cu", build)
            for n in names}
    if old:
        jobs["old"] = old

    def one(item):
        name, src = item
        lib = build / f"libbpa_{name.replace('+', '_')}.so"
        t0 = time.perf_counter()
        text = nvcc(src, lib)
        return name, lib, text, time.perf_counter() - t0

    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
        built = list(pool.map(one, jobs.items()))
    libs, builds = {}, []
    import ctypes
    for name, lib, text, secs in built:
        so = ctypes.CDLL(str(lib))
        for fn in (so.bpa_apply_f32, so.bpa_apply_f64, so.line_thomas_f32,
                   so.line_thomas_f64):
            fn.argtypes = [ctypes.c_void_p] * 6
            fn.restype = ctypes.c_int
        libs[name] = so
        builds.append(dict(variant=name, seconds=secs,
                           kernels=ptxas_summary(text)))
        say("build", **builds[-1])
    return libs, builds


def operands():
    """The ISMIP_A mesh's MeshData in f32 and f64 on the card, and the
    operator and preconditioner cases."""
    import chip_smoke as cs
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.core.ice.bpa import register_bpa_static
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.mesh import build_mesh_from_config
    from ufemism2_tpu_torch.ops.cuda_bpa import BpaOperator, LineThomas
    C = Config(**cs.ISMIP_A)
    mesh = build_mesh_from_config(C, "ANT")
    mds = {}
    for dt in (torch.float32, torch.float64):
        mds[dt] = build_mesh_data(mesh, dtype=dt, device="cuda")
        register_bpa_static(C, mesh, mds[dt])
    rng = np.random.default_rng(9)
    bpa, thomas = {}, {}
    for nz, dtype, rnd in ((12, torch.float32, True),
                           (12, torch.float32, False),
                           (12, torch.float64, False),
                           (7, torch.float32, True)):
        md = mds[dtype]
        c, dzeta, (u, v) = cs.bpa_operands(md, nz, dtype, rng)
        A = BpaOperator(md.M2_stack.op, md.x("bpa_rows"), c, dzeta, False,
                        rnd)
        tag = f"nz{nz}_{str(dtype)[-7:]}{'_bf16x' if rnd else ''}"
        bpa[tag] = (A, torch.cat([u.reshape(-1), v.reshape(-1)]))
        if rnd and nz == 12:
            continue
        n = md.nTri
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        M = LineThomas(t(rng.standard_normal((n, nz - 1)) * 1e13),
                       t(-(4.0 + rng.random((n, nz))) * 1e13),
                       t(rng.standard_normal((n, nz - 1)) * 1e13))
        thomas[f"nz{nz}_{str(dtype)[-7:]}"] = (
            M, t(rng.standard_normal(2 * n * nz) * 1e5))
    return mesh, bpa, thomas


def ismip_operands(mesh):
    """The last operator and preconditioner of chip_smoke.py's
    ismip_hom_a_bpa (its initial solve and one step) with the operands of
    their last calls, as chip_smoke.py's bpa_slice_finish times them."""
    import chip_smoke as cs
    _, _, gm, _ = cs.ismip_run("ismip_hom_a_bpa", cs.ISMIP_A, mesh)
    A, M = gm["A"], gm["M"]
    x = torch.cat([t.reshape(-1) for t in gm["x"]])
    r = torch.cat([t.reshape(-1) for t in gm["b"]]) - A.flat(x)
    m = A.n * A.nz
    say("ismip_operands", **{
        f"{name}_{what}": v for name, t in (("x", x), ("r", r))
        for what, v in (("zeros", int((t == 0).sum())),
                        ("min_abs_nonzero", float(t[t != 0].abs().min())),
                        ("max_abs", float(t.abs().max())))},
        rows=A.n, nz=A.nz, vector=2 * m)
    return {"ismip_last": (A, x)}, {"ismip_last": (M, r)}


def measure(kind, case, op, x, name, lib, reps):
    import chip_smoke as cs
    op._fn = getattr(lib, f"{kind}_f{32 if op.dtype == torch.float32 else 64}")
    m = op.n * op.nz
    ref = torch.cat([t.reshape(-1) for t in op.plain(
        x[:m].view(op.n, op.nz), x[m:].view(op.n, op.nz))])
    y = op.flat(x)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(y, ref))
    hot = cs.graph_ms(lambda: op.flat(x), reps)
    cold, flush = cs.graph_ms_cold(lambda: op.flat(x), reps)
    out = dict(kernel=kind, case=case, variant=name, bit_equal=bit_equal,
               max_abs_err=float((y - ref).abs().max()), device_ms=hot,
               device_ms_cold=cold, flush_ms=flush)
    say("time", **out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="another bpa.cu to time as the variant 'old'")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names (default: all "
                         "of VARIANTS); a patch is PATCH or PATCH+VARIANT")
    ap.add_argument("--cases", default=None,
                    help="comma-separated kernel/case names to time "
                         "(default: all)")
    ap.add_argument("--ismip", action="store_true",
                    help="also the last operator and preconditioner of "
                         "chip_smoke.py's ismip_hom_a_bpa (case "
                         "ismip_last)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bpa_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    names = (args.only.split(",") if args.only
             else [*VARIANTS, "no_bf16_copy"])
    t0 = time.perf_counter()
    libs, builds = build_all(names, args.old)
    say("built", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh, bpa, thomas = operands()
    if args.ismip:
        a, m = ismip_operands(mesh)
        bpa.update(a)
        thomas.update(m)
    want = set(args.cases.split(",")) if args.cases else None
    bpa = {k: v for k, v in bpa.items()
           if want is None or f"bpa_apply/{k}" in want}
    thomas = {k: v for k, v in thomas.items()
              if want is None or f"line_thomas/{k}" in want}
    say("operands", nTri=mesh.nTri, seconds=time.perf_counter() - t0)
    order = list(libs)
    results = []
    for rnd in range(args.rounds):
        seq = order if rnd % 2 == 0 else order[::-1]
        for name in seq:
            for case, (A, x) in bpa.items():
                results.append(measure("bpa_apply", case, A, x, name,
                                       libs[name], args.reps))
            for case, (M, r) in thomas.items():
                results.append(measure("line_thomas", case, M, r, name,
                                       libs[name], args.reps))
    summary = {}
    for r in results:
        key = f"{r['kernel']}/{r['case']}/{r['variant']}"
        s = summary.setdefault(key, dict(hot=[], cold=[], bit_equal=True))
        s["hot"].append(r["device_ms"])
        s["cold"].append(r["device_ms_cold"])
        s["bit_equal"] &= r["bit_equal"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, builds=builds, results=results,
                           summary=summary), f, indent=1)
    print(card, flush=True)
    say("summary", **{k: dict(hot=min(v["hot"]), cold=min(v["cold"]),
                              hot_max=max(v["hot"]),
                              bit_equal=v["bit_equal"])
                      for k, v in summary.items()})
    return 0 if all(v["bit_equal"] for k, v in summary.items()
                    if k.split("/")[2].partition("+")[0] not in PROBES) else 2


if __name__ == "__main__":
    sys.exit(main())
