// heat_columns: the column solves of the 3-D heat equation, for sm_90a.
//
// For every vertical column (one thread each) it does what the reference's
// make_heat_solver `solve` does once the coefficient fields are formed
// (ufemism2_tpu/core/ice/thermodynamics.py:302-369, on top of
// ufemism2_tpu/ops/tridiag.py:16-54 thomas_batched):
//
//   - the stability ladder: level lev takes 2^lev implicit substeps of
//     dt / 2^lev (levels 0..4, 31 substeps), each substep a tridiagonal
//     (Thomas) solve with the grounded (flux) and/or the floating (pressure
//     melting point) basal boundary condition, mixed for grounding-line
//     columns as choice_GL_temperature_BC says (grounded / pmp / subgrid);
//   - the choice of the column's first stable level (all values finite and
//     in [180 K, T0]); a column stable at no level takes the Robin profile
//     (computed by the caller) and counts in n_unstable;
//   - thin ice (Hi_eff < Hi_min_thermo) takes the surface temperature;
//   - the cap at the pressure-melting point.
//
// It replaces XLA-lowered code, not a Pallas kernel: in eager PyTorch the
// same work is a Python loop of about 140 small launches per Thomas solve,
// 62 solves a step, some 10,000 launches per thermodynamics step; here it
// is one. The reference computes every level for every column and then
// selects; this kernel stops a column at its first stable level, which
// selects the same level and the same values.
//
// Bound: a solved column reads five [nz] rows of its type and writes one
// f64 row, a thin column reads one and writes one; on the 8 km mesh
// (13.7k columns x nz 12) that is 4-6 MB, 1.5-2 us at 3.35 TB/s
// (chip_smoke.py counts it from each case's masks). The real limit is
// latency: 13.7k threads, each walking a
// chain of dependent f64 divisions (two per row of each solve), fill
// about three warps an SM. Columns whose level 0 is unstable walk all five
// levels (31 or 62 solves). A simple kernel that is right comes first;
// spreading (column, level, boundary condition) over threads is later work.
//
// Rounding contract: the result equals the plain version
// (ops/cuda_heat.py heat_columns_plain, run on the card) to the bit. Every
// operation is rounded as the plain version's tensor operation is -
// __dadd_rn / __dmul_rn / __ddiv_rn (and the f32 forms), never a
// contracted multiply-add - in the same order, and the dtype flow of the
// reference is kept: the zeta operator rows are f64, so the systems are
// formed and solved in f64 even for f32 fields; in the first substep of a
// level the right-hand side rhs + Ti / dt and the basal row are rounded to
// the fields' type T (they are T arrays there), in later substeps they are
// f64. min() propagates NaN, as torch.minimum does.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef UF_HEAT_THREADS
#define UF_HEAT_THREADS 64      // 13.7k columns: every SM gets a block
#endif
#define UF_HEAT_MAX_NZ 64       // column limit of the run-time-nz kernel

struct HeatDesc {               // ops/cuda_heat.py::_HeatDesc
    const void* Ti;             // [n, nz] T   temperature at the step's start
    const void* c_dd;           // [n, nz] T   coefficient of d/dzeta
    const void* c_d2;           // [n, nz] T   coefficient of d2/dzeta2
    const void* rhs;            // [n, nz] T   advection and strain heating
    const void* T_surf;         // [n] T
    const double* q_base;       // [n] f64     flux term of the grounded row
    const void* T_base_float;   // [n] T
    const void* Ti_pmp;         // [n, nz] T
    const void* fraction_gr;    // [n] T
    const uint8_t* grounded;    // [n] bool
    const uint8_t* floating;    // [n] bool
    const uint8_t* gl_gr;       // [n] bool
    const uint8_t* thin;        // [n] bool
    const double* T_robin;      // [n, nz] f64
    const double* zrows;        // [6, nz] f64 rows l1 d1 u1 l2 d2 u2
    double* out;                // [n, nz] f64
    int* n_unstable;            // [1]
    int n;
    int nz;
    int gl_bc;                  // 0 grounded, 1 pmp, 2 subgrid
    double dt;
};

#define UF_T0 273.16            // utils/constants.py T0 [K]

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    return a < b ? a : b;
}

// One implicit substep for one basal boundary condition: x solves
// (diag, lo, up) x = b, with b formed from Tin as described above.
template <typename T, int M>
__device__ __forceinline__ void solve_column(
        int nz, bool first, bool flux, const double (&Tin)[M],
        const double (&rh)[M], const double (&lo)[M], const double (&up)[M],
        const double (&diag)[M], double dt_i, T ts, T tbf, T pmp_base,
        double q, double (&x)[M]) {
    double b[M], cp[M], dp[M];
    const T dt_t = (T)dt_i;
#pragma unroll (M <= 16 ? M : 1)
    for (int k = 0; k < M; ++k) {
        if (k < nz) {
            b[k] = first ? (double)add_rn((T)rh[k], div_rn((T)Tin[k], dt_t))
                         : add_rn(rh[k], div_rn(Tin[k], dt_i));
        }
    }
    // surface row: T = min(T_surf, T0); basal row: the boundary condition
    b[0] = (double)min_nan(ts, (T)UF_T0);
    const double tb = flux
        ? min_nan((double)pmp_base, add_rn(Tin[nz - 2], -q))
        : (double)min_nan(tbf, pmp_base);
    b[nz - 1] = first ? (double)(T)tb : tb;

    // forward sweep, then back substitution (thomas_batched)
    double cprev = 0.0, dprev = 0.0;
#pragma unroll (M <= 16 ? M : 1)
    for (int k = 0; k < M; ++k) {
        if (k < nz) {
            double den = add_rn(diag[k], -mul_rn(lo[k], cprev));
            if (fabs(den) < 1e-300) den = 1e-300;
            cprev = div_rn(up[k], den);
            dprev = div_rn(add_rn(b[k], -mul_rn(lo[k], dprev)), den);
            cp[k] = cprev;
            dp[k] = dprev;
        }
    }
    double xn = 0.0;
#pragma unroll (M <= 16 ? M : 1)
    for (int k = M - 1; k >= 0; --k) {
        if (k < nz) {
            xn = add_rn(dp[k], -mul_rn(cp[k], xn));
            x[k] = xn;
        }
    }
}

template <typename T, int NZ>
__global__ void __launch_bounds__(UF_HEAT_THREADS)
heat_columns_kernel(const HeatDesc d) {
    constexpr int M = NZ > 0 ? NZ : UF_HEAT_MAX_NZ;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= d.n) return;
    const int nz = NZ > 0 ? NZ : d.nz;
    const size_t o = (size_t)i * nz;
    const T* pmp = static_cast<const T*>(d.Ti_pmp) + o;
    double* out = d.out + o;
    const T ts = static_cast<const T*>(d.T_surf)[i];

    if (d.thin[i]) {                        // no solve: surface temperature
        for (int k = 0; k < nz; ++k)
            out[k] = min_nan((double)ts, (double)pmp[k]);
        return;
    }

    const T* Ti = static_cast<const T*>(d.Ti) + o;
    const T* cdd = static_cast<const T*>(d.c_dd) + o;
    const T* cd2 = static_cast<const T*>(d.c_d2) + o;
    const T* rhs = static_cast<const T*>(d.rhs) + o;
    const double* l1 = d.zrows;
    const double* d1 = d.zrows + nz;
    const double* u1 = d.zrows + 2 * nz;
    const double* l2 = d.zrows + 3 * nz;
    const double* d2 = d.zrows + 4 * nz;
    const double* u2 = d.zrows + 5 * nz;

    // coefficients that do not depend on dt: the sub- and super-diagonal
    // (zero in the boundary rows) and the two dt-free parts of the diagonal.
    // T -> f64 is exact, so T values are kept as f64 and cast back exactly.
    double lo[M], up[M], p1[M], p2[M], rh[M], T0v[M];
#pragma unroll (M <= 16 ? M : 1)
    for (int k = 0; k < M; ++k) {
        if (k < nz) {
            const double a = (double)cdd[k], c = (double)cd2[k];
            p1[k] = mul_rn(a, d1[k]);
            p2[k] = mul_rn(c, d2[k]);
            lo[k] = (k >= 1 && k <= nz - 2)
                ? add_rn(mul_rn(a, l1[k - 1]), mul_rn(c, l2[k - 1])) : 0.0;
            up[k] = (k >= 1 && k <= nz - 2)
                ? add_rn(mul_rn(a, u1[k]), mul_rn(c, u2[k])) : 0.0;
            rh[k] = (double)rhs[k];
            T0v[k] = (double)Ti[k];
        }
    }

    const T tbf = static_cast<const T*>(d.T_base_float)[i];
    const T pmp_base = pmp[nz - 1];
    const T fg = static_cast<const T*>(d.fraction_gr)[i];
    const double fg_g = (double)fg;
    const double fg_f = (double)add_rn((T)1, -fg);
    const double q = d.q_base[i];
    // which boundary condition(s) the column's mask needs: 0 the grounded
    // (flux) one, 1 the floating (pmp) one, 2 both, mixed by fraction_gr
    const int sel = d.gl_gr[i] ? d.gl_bc
                  : (d.grounded[i] ? 0 : (d.floating[i] ? 1 : 0));

    double Tc[M], Tg[M], Tf[M], diag[M];
    bool ok = false;
    double scale = 1.0;
    for (int lev = 0; lev < 5 && !ok; ++lev, scale *= 0.5) {
        const double dt_i = d.dt * scale;           // dt * 0.5**lev
        const double inv_dt = div_rn(1.0, dt_i);
#pragma unroll (M <= 16 ? M : 1)
        for (int k = 0; k < M; ++k) {
            if (k < nz) {
                diag[k] = add_rn(add_rn(inv_dt, p1[k]), p2[k]);
                Tc[k] = T0v[k];
            }
        }
        diag[0] = 1.0;
        diag[nz - 1] = 1.0;
        for (int s = 0; s < (1 << lev); ++s) {
            const bool first = s == 0;
            if (sel != 1)
                solve_column<T, M>(nz, first, true, Tc, rh, lo, up, diag, dt_i,
                                   ts, tbf, pmp_base, q, Tg);
            if (sel != 0)
                solve_column<T, M>(nz, first, false, Tc, rh, lo, up, diag,
                                   dt_i, ts, tbf, pmp_base, q, Tf);
#pragma unroll (M <= 16 ? M : 1)
            for (int k = 0; k < M; ++k) {
                if (k < nz) {
                    Tc[k] = sel == 0 ? Tg[k]
                         : sel == 1 ? Tf[k]
                         : add_rn(mul_rn(fg_g, Tg[k]), mul_rn(fg_f, Tf[k]));
                }
            }
        }
        bool stable = true;
#pragma unroll (M <= 16 ? M : 1)
        for (int k = 0; k < M; ++k) {
            if (k < nz) {
                const double v = Tc[k];
                stable = stable && isfinite(v) && v >= 180.0 && v <= UF_T0;
            }
        }
        ok = stable;
    }

    const double* robin = d.T_robin + o;
    if (!ok) atomicAdd(d.n_unstable, 1);
    for (int k = 0; k < nz; ++k)
        out[k] = min_nan(ok ? Tc[k] : robin[k], (double)pmp[k]);
}

template <typename T>
static int heat_columns(const HeatDesc& d, cudaStream_t stream) {
    if (d.n == 0) return 0;
    if (d.nz < 3 || d.nz > UF_HEAT_MAX_NZ || d.gl_bc < 0 || d.gl_bc > 2)
        return (int)cudaErrorInvalidValue;
    const int blocks = (d.n + UF_HEAT_THREADS - 1) / UF_HEAT_THREADS;
    switch (d.nz) {             // the schema's nz unrolled, any other at run time
        case 12:
            heat_columns_kernel<T, 12><<<blocks, UF_HEAT_THREADS, 0, stream>>>(d);
            break;
        default:
            heat_columns_kernel<T, 0><<<blocks, UF_HEAT_THREADS, 0, stream>>>(d);
    }
    return (int)cudaGetLastError();
}

extern "C" int heat_columns_f32(const HeatDesc* d, void* stream) {
    return heat_columns<float>(*d, (cudaStream_t)stream);
}

extern "C" int heat_columns_f64(const HeatDesc* d, void* stream) {
    return heat_columns<double>(*d, (cudaStream_t)stream);
}
