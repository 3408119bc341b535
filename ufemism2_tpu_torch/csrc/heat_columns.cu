// heat_columns: the column solves of the 3-D heat equation, for sm_90a.
//
// For every vertical column it does what the reference's make_heat_solver
// `solve` does once the coefficient fields are formed
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
// is one.
//
// Bound: a solved column reads five [nz] rows of its type and writes one
// f64 row; on the 8 km mesh (13.7k columns x nz 12) that is 4-6 MB,
// 1.5-2 us at 3.35 TB/s, far above the f64 operations' time
// (chip_smoke.py heat_bound counts both from each case's data). What
// limits the kernel is latency: each substep is a chain of nz dependent
// f64 divisions (__ddiv_rn is a multi-instruction sequence), and a column
// has up to 31 substeps. The design cuts the chain and the work on it:
//
//   - levels in parallel: two lanes of one warp per column. Lane A walks
//     levels 0-3 (15 substeps) and stops at the first stable one; lane B
//     walks level 4 (16 substeps) speculatively and stops as soon as lane
//     A is stable (a shuffle). Every level starts again from Ti, so the
//     levels are independent; the chain is 16 substeps, not 31, and a
//     column stable at level 0 still costs one substep.
//   - one factorisation per level: the matrix of a level is the same in
//     every substep and for both boundary conditions, so den (clamped at
//     1e-300) and cp are formed once, fused into the level's first sweep,
//     and kept in registers; a later substep is one dp sweep (one
//     division a row) and the back substitution.
//   - one right-hand side a substep: the two boundary conditions differ in
//     the basal row only, so the forward sweep is shared and splits into
//     two values there, followed by two independent back substitutions
//     (instruction-level parallelism). The basal value is chosen per lane,
//     so grounded, floating and mixed columns run the same instructions.
//   - the non-finite exit: once a level's carry holds a non-finite value
//     in an interior row, b_k, then dp_k, then x_k are non-finite in every
//     later substep of the level, for both conditions and their mix (the
//     boundary rows take their value from interior rows or from fixed
//     operands), so the level is unstable: it stops there. The output is
//     the same (tests/test_torch_heat_design.py proves it on the plain
//     recurrence).
//   - registers: the level-invariant rows (lo, up, the two dt-free parts
//     of the diagonal, rhs, the start Ti) live once per column in shared
//     memory; a lane keeps four [nz] arrays (carry, den, cp, dp). The
//     run-time-nz form keeps them in local memory.
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

#define UF_HEAT_THREADS 64      // 32 columns a block, two lanes each
#define UF_HEAT_MAX_NZ 64       // column limit of the run-time-nz kernel
#define UF_FULL 0xffffffffu

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

// the per-column rows in shared memory, [row][k][column of the block]
enum { ROW_LO, ROW_UP, ROW_P1, ROW_P2, ROW_RH, ROW_TI, N_ROWS };

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

template <typename T, int NZ>
__global__ void __launch_bounds__(UF_HEAT_THREADS)
heat_columns_kernel(const HeatDesc d) {
    constexpr int M = NZ > 0 ? NZ : UF_HEAT_MAX_NZ;
    extern __shared__ double rows[];
    const int nz = NZ > 0 ? NZ : d.nz;
    const int cols = blockDim.x >> 1;
    const int c = threadIdx.x >> 1;
    const int lane = threadIdx.x & 1;       // 0: levels 0-3, 1: level 4
    const int i = blockIdx.x * cols + c;
    const bool valid = i < d.n;
    const size_t o = (size_t)i * nz;
#define ROW(r, k) rows[((r) * nz + (k)) * cols + c]

    const T* pmp = static_cast<const T*>(d.Ti_pmp) + o;
    double* out = d.out + o;
    const bool thin = !valid || d.thin[i];
    if (valid) {
        const T ts = static_cast<const T*>(d.T_surf)[i];
        if (thin) {                         // no solve: surface temperature
            for (int k = lane; k < nz; k += 2)
                out[k] = min_nan((double)ts, (double)pmp[k]);
        } else {
            // coefficients that do not depend on dt: the sub- and
            // super-diagonal (zero in the boundary rows) and the two dt-free
            // parts of the diagonal, then rhs and the start Ti. T -> f64 is
            // exact, so T values are kept as f64 and cast back exactly.
            const T* Ti = static_cast<const T*>(d.Ti) + o;
            const T* cdd = static_cast<const T*>(d.c_dd) + o;
            const T* cd2 = static_cast<const T*>(d.c_d2) + o;
            const T* rhs = static_cast<const T*>(d.rhs) + o;
            const double* z = d.zrows;      // l1 d1 u1 l2 d2 u2, [nz] each
            // unrolled, so that all of a lane's loads are in flight at once
#pragma unroll (NZ > 0 ? NZ : 1)
            for (int k0 = 0; k0 < nz; k0 += 2) {
                const int k = k0 + lane;
                if (k >= nz) break;
                const double a = (double)cdd[k], b = (double)cd2[k];
                const bool inner = k >= 1 && k <= nz - 2;
                ROW(ROW_LO, k) = inner ? add_rn(mul_rn(a, z[k - 1]),
                                                mul_rn(b, z[3 * nz + k - 1]))
                                       : 0.0;
                ROW(ROW_UP, k) = inner ? add_rn(mul_rn(a, z[2 * nz + k]),
                                                mul_rn(b, z[5 * nz + k]))
                                       : 0.0;
                ROW(ROW_P1, k) = mul_rn(a, z[nz + k]);
                ROW(ROW_P2, k) = mul_rn(b, z[4 * nz + k]);
                ROW(ROW_RH, k) = (double)rhs[k];
                ROW(ROW_TI, k) = (double)Ti[k];
            }
        }
    }
    __syncthreads();

    // the column's constants: surface row, boundary values, mix weights
    double b_surf = 0.0, base_f = 0.0, pmp_base = 0.0, q = 0.0;
    double fg_g = 0.0, fg_f = 0.0;
    int sel = 0;
    if (!thin) {
        const T ts = static_cast<const T*>(d.T_surf)[i];
        const T pb = pmp[nz - 1];
        const T fg = static_cast<const T*>(d.fraction_gr)[i];
        b_surf = (double)min_nan(ts, (T)UF_T0);
        base_f = (double)min_nan(static_cast<const T*>(d.T_base_float)[i], pb);
        pmp_base = (double)pb;
        q = d.q_base[i];
        fg_g = (double)fg;
        fg_f = (double)add_rn((T)1, -fg);
        // which boundary condition(s) the column's mask needs: 0 the
        // grounded (flux) one, 1 the floating (pmp) one, 2 both, mixed by
        // fraction_gr
        sel = d.gl_gr[i] ? d.gl_bc
            : (d.grounded[i] ? 0 : (d.floating[i] ? 1 : 0));
    }

    double Tc[M], den[M], cp[M], dp[M];
    bool done = thin, found = false;
    int lev = lane ? 4 : 0, s = 0;
    double dt_i = 0.0, inv_dt = 0.0;
    while (__any_sync(UF_FULL, !done)) {
        if (!done) {
            const bool first = s == 0;
            if (first) {                    // a level starts again from Ti
                dt_i = mul_rn(d.dt, 1.0 / (double)(1 << lev));
                inv_dt = div_rn(1.0, dt_i);
#pragma unroll (NZ > 0 ? NZ : 1)
                for (int k = 0; k < nz; ++k) Tc[k] = ROW(ROW_TI, k);
            }
            // the basal values, from the carry before it is overwritten;
            // in the first substep they are rounded to T (b is a T array)
            const double tg = min_nan(pmp_base, add_rn(Tc[nz - 2], -q));
            const double tb1 = sel == 1 ? base_f
                             : (first ? (double)(T)tg : tg);
            const double tb2 = base_f;

            // forward sweep over the rows above the basal one, shared by
            // both boundary conditions; the level's first sweep also forms
            // den and cp (thomas_batched's operations in its order)
            double cprev = 0.0, dprev = 0.0;
#pragma unroll (NZ > 0 ? NZ : 1)
            for (int k = 0; k < nz - 1; ++k) {
                const double bk = k == 0 ? b_surf
                    : first ? (double)add_rn((T)ROW(ROW_RH, k),
                                             div_rn((T)Tc[k], (T)dt_i))
                            : add_rn(ROW(ROW_RH, k), div_rn(Tc[k], dt_i));
                const double lk = ROW(ROW_LO, k);
                if (first) {
                    const double diag = k == 0 ? 1.0
                        : add_rn(add_rn(inv_dt, ROW(ROW_P1, k)),
                                 ROW(ROW_P2, k));
                    double dn = add_rn(diag, -mul_rn(lk, cprev));
                    if (fabs(dn) < 1e-300) dn = 1e-300;
                    cprev = div_rn(ROW(ROW_UP, k), dn);
                    den[k] = dn;
                    cp[k] = cprev;
                }
                dprev = div_rn(add_rn(bk, -mul_rn(lk, dprev)), den[k]);
                dp[k] = dprev;
            }
            // the basal row (diag 1), once per boundary condition
            const int kb = nz - 1;
            const double lb = ROW(ROW_LO, kb);
            if (first) {
                double dn = add_rn(1.0, -mul_rn(lb, cprev));
                if (fabs(dn) < 1e-300) dn = 1e-300;
                den[kb] = dn;
                cp[kb] = div_rn(ROW(ROW_UP, kb), dn);
            }
            const double m = mul_rn(lb, dprev);
            double x1 = div_rn(add_rn(tb1, -m), den[kb]);
            double x2 = div_rn(add_rn(tb2, -m), den[kb]);
            x1 = add_rn(x1, -mul_rn(cp[kb], 0.0));
            x2 = add_rn(x2, -mul_rn(cp[kb], 0.0));
            Tc[kb] = sel == 2 ? add_rn(mul_rn(fg_g, x1), mul_rn(fg_f, x2))
                              : x1;
            // two back substitutions side by side
#pragma unroll (NZ > 0 ? NZ : 1)
            for (int k = nz - 2; k >= 0; --k) {
                x1 = add_rn(dp[k], -mul_rn(cp[k], x1));
                x2 = add_rn(dp[k], -mul_rn(cp[k], x2));
                Tc[k] = sel == 2 ? add_rn(mul_rn(fg_g, x1), mul_rn(fg_f, x2))
                                 : x1;
            }
            ++s;

            // the non-finite exit, and the level's end
            bool fin = true;
#pragma unroll (NZ > 0 ? NZ : 1)
            for (int k = 1; k < nz - 1; ++k) fin = fin && isfinite(Tc[k]);
            if (!fin || s == (1 << lev)) {
                bool stable = fin;
#pragma unroll (NZ > 0 ? NZ : 1)
                for (int k = 0; k < nz; ++k) {
                    const double v = Tc[k];
                    stable = stable && isfinite(v) && v >= 180.0 && v <= UF_T0;
                }
                if (stable) {
                    found = true;
                    done = true;
                } else if (lane == 0 && lev < 3) {
                    ++lev;
                    s = 0;
                } else {
                    done = true;
                }
            }
        }
        // lane B's level 4 is needed only if lane A finds no stable level
        if (__shfl_xor_sync(UF_FULL, found, 1) && lane == 1) done = true;
    }

    // the first stable level wins: lane A's if it found one, else lane B's
    const bool other = __shfl_xor_sync(UF_FULL, found, 1);
    const bool a_found = lane ? other : found;
    const bool ok = found || other;
    if (!thin) {
        if (found && (lane == 0 || !a_found)) {
#pragma unroll (NZ > 0 ? NZ : 1)
            for (int k = 0; k < nz; ++k)
                out[k] = min_nan(Tc[k], (double)pmp[k]);
        } else if (!ok) {
            const double* robin = d.T_robin + o;
            for (int k = lane; k < nz; k += 2)
                out[k] = min_nan(robin[k], (double)pmp[k]);
        }
    }
    const unsigned unstable = __ballot_sync(UF_FULL, !thin && !ok && lane == 0);
    if ((threadIdx.x & 31) == 0 && unstable)
        atomicAdd(d.n_unstable, __popc(unstable));
#undef ROW
}

template <typename T>
static int heat_columns(const HeatDesc& d, cudaStream_t stream) {
    if (d.n == 0) return 0;
    if (d.nz < 3 || d.nz > UF_HEAT_MAX_NZ || d.gl_bc < 0 || d.gl_bc > 2)
        return (int)cudaErrorInvalidValue;
    // shared rows within the 48 KB a block gets without opting in
    const int threads = d.nz <= 32 ? UF_HEAT_THREADS : UF_HEAT_THREADS / 2;
    const int cols = threads / 2;
    const size_t smem = (size_t)N_ROWS * d.nz * cols * sizeof(double);
    const int blocks = (d.n + cols - 1) / cols;
    switch (d.nz) {             // the schema's nz unrolled, any other at run time
        case 12:
            heat_columns_kernel<T, 12><<<blocks, threads, smem, stream>>>(d);
            break;
        default:
            heat_columns_kernel<T, 0><<<blocks, threads, smem, stream>>>(d);
    }
    return (int)cudaGetLastError();
}

extern "C" int heat_columns_f32(const HeatDesc* d, void* stream) {
    return heat_columns<float>(*d, (cudaStream_t)stream);
}

extern "C" int heat_columns_f64(const HeatDesc* d, void* stream) {
    return heat_columns<double>(*d, (cudaStream_t)stream);
}
