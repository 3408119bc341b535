// The BPA operator and the vertical-line preconditioner, for sm_90a.
//
//   bpa_apply:   (Au, Av)[r, k] of the Blatter-Pattyn momentum operator on
//                the 3-D velocities (u, v) [n_rows, nz] (row-major: the
//                layers of a triangle are neighbours), in two launches:
//                the first derivatives ux, uy, vx, vy into a scratch
//                [n_rows, nz, 4], then every row of the operator (interior
//                layers, the surface row with its ghost point eliminated,
//                the base row for sliding or no-slip, the lateral rows);
//   line_thomas: the tridiagonal systems of every column of the line
//                preconditioner solved for two right-hand sides.
//
// Neither has a Pallas counterpart. bpa_apply replaces the XLA-lowered
// closure A_op of ufemism2_tpu/core/ice/bpa.py:208-297 (a composition of
// single-operator SpMVs, M2_ddx_b_b @ f and M2_ddy_b_b @ f on [n, nz]
// fields, with zeta differences); line_thomas the closure M_pre of
// bpa.py:299-328 on ufemism2_tpu/ops/tridiag.py thomas_batched. Eager
// PyTorch would run them as some 230 and 260 launches.
//
// What bounds them. The bound counts bytes: at the ISMIP-HOM stand-in
// (26,500 rows, nz 12, K 10, f32) an apply reads 17.1 MB once and
// line_thomas 8.7 MB. In the solver's loop the operands stay in the 50 MB
// L2 between calls, so the hot time is set by the launches, the
// instructions issued and the latency of dependent loads, not by HBM.
// bpa_apply's two launches alone take 0.003 ms; its arithmetic is fixed by
// the bit equality (some 200 multiplies and adds a row and layer in the
// plain version's order, no fused multiply-add, and ten IEEE divisions by
// the zeta spacing); what the card measures of it is in PERF.md (the
// variants and probes of tools/bpa_kernel_variants.py).
//
// bpa_apply, what the design does about it:
// - A thread takes a run of R = UF_BPA_RUN layers of one row (2 in f32,
//   1 in f64, where registers are the limit), the runs of a row on
//   neighbouring lanes. Each stencil entry's index and two coefficients
//   are loaded once a run, not once a layer, and each gather is one
//   vector load. The zeta neighbours at a run's edge are read from the
//   row's own column, which its neighbouring lanes have just brought
//   into L1.
// - Pass 1 rounds the gathered u and v to bfloat16 with the conversion
//   instruction (two values an instruction). In f32 with the rounding it
//   also writes the first derivatives rounded once to bfloat16,
//   interleaved [n, nz, 4] (ux, uy, vx, vy): pass 2 gathers one entry's
//   four fields over a run as one 16-byte load and widens them exactly,
//   instead of rounding every value again for each of its ten readers.
//   The exact first derivatives [n, nz, 4] stay for the own row, whose
//   zeta differences and boundary rows use them unrounded.
// - The surface layer can only be the first of a row's first run and the
//   base layer the last of its last run, so the layers of a run branch at
//   compile time but for those two; the lateral rows leave early.
// - __launch_bounds__ keeps 6 blocks of 128 an SM in flight (7 in f64):
//   the K-10 loop is unrolled, and without the bound the compiler spends
//   up to 128 registers on loads it hoists, and fewer warps hide less of
//   the index -> gather latency.
// - The ELL width (10 on the meshes of chip_smoke.py) and nz 12 are
//   template parameters. Any other nz from 3 to 64, and operands not on
//   16-byte boundaries (a view into a larger vector), take the run-time
//   form: runs of one layer, scalar loads, the same arithmetic.
// - What changes once per viscosity iteration is formed by the caller:
//   dzeta/dz and its square, dzeta / dzeta/dz of the surface row, the
//   base row's Q, R and beta / eta_base. The kernel divides only by the
//   zeta spacing, as the plain version does.
//
// line_thomas, what the design does about it: a block takes
// UF_THOMAS_COLS neighbouring columns, whose bands and right-hand sides
// are contiguous slabs; it copies them into shared memory with 16-byte
// cp.async (a thread's copies all in flight at once, no registers);
// solves each column on two lanes, one a right-hand side, each forming the
// same pivots by the same operations (26,500 columns make 53,000 lanes
// over all 132 SMs); and writes the solutions back with 16-byte stores.
// The slabs keep their own column stride (11 and 12 words), which costs
// the solve two- to four-way bank conflicts at nz 12 (more at a run-time
// nz with more factors of two); an odd stride avoids them but must be
// staged a value a copy, and measured slower (PERF.md). A zero dividend
// sends the IEEE division down its slow path; the solve meets one in
// every column's last c' and, on the solver's operands, in the lateral
// rows' identity columns and the no-slip base rows, so div_z answers a
// zero over a finite nonzero pivot with its exact signed zero.
//
// Every product, sum and quotient is rounded once, in the order of the
// plain version's tensor operations (ops/cuda_bpa.py bpa_apply_plain,
// line_thomas_plain), never contracted into a fused multiply-add: the
// f32 GMRES solves end at their precision floor, where the iteration
// counts follow the operator's last bit, so the kernels are held to their
// plain versions to the bit (chip_smoke.py; the decomposition is
// specified on the CPU by tests/test_torch_bpa_design.py).
//
// ROUND (f32 only) rounds the gathered operand of a stencil sum to
// bfloat16 (round to nearest even) and back, as the reference's f32
// matvec rounds its x: u and v in pass 1, the first derivatives in pass 2.
// The zeta differences and the boundary rows use the values as they are.
//
// The UF_* constants below are the design's measured choices; PERF.md
// gives the alternatives' times, and tools/bpa_kernel_variants.py builds
// them from a copy of this source.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define UF_BPA_RUN 2          // layers a thread takes at nz 12 in f32
#define UF_BPA_RUN64 1        // the same in f64
#define UF_BPA_THREADS 128    // bpa_apply's block
#define UF_BPA_MIN_BLOCKS 6   // blocks an SM the registers must allow
#define UF_BPA_MIN_BLOCKS64 7 // the same in f64
#define UF_BPA_BLOCKS(T) \
    (sizeof(T) == 4 ? UF_BPA_MIN_BLOCKS : UF_BPA_MIN_BLOCKS64)
#define UF_THOMAS_COLS 32     // columns a line_thomas block solves

#define UF_ROW_INF_U 2        // row codes of ops/cuda_spmv.py DivaRows
#define UF_ROW_INF_V 4
#define UF_NZ_MAX 64          // layers of a column at most
#define UF_K_MAX 64           // stencil entries of a row at most

__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// a / b, where a zero a over a finite nonzero b gives the zero with the
// product of the signs, exactly as the IEEE division does, without taking
// the division's slow path (which a zero dividend enters): the division
// then runs on b / b, and selects pick the result, so that a warp's lanes
// do not part.
__device__ __forceinline__ float div_z(float a, float b) {
    const bool z = a == 0.0f && fabsf(b) > 0.0f
                   && fabsf(b) < __int_as_float(0x7f800000);
    const float q = __fdiv_rn(z ? b : a, b);
    return z ? __int_as_float((__float_as_int(a) ^ __float_as_int(b))
                              & 0x80000000)
             : q;
}
__device__ __forceinline__ double div_z(double a, double b) {
    const bool z = a == 0.0 && fabs(b) > 0.0
                   && fabs(b) < __longlong_as_double(0x7ff0000000000000LL);
    const double q = __ddiv_rn(z ? b : a, b);
    return z ? __longlong_as_double(
                   (__double_as_longlong(a) ^ __double_as_longlong(b))
                   & (long long)0x8000000000000000ULL)
             : q;
}

// The pivot clamp of thomas_batched, |d| < 1e-300 -> 1e-300, in the
// plain version's type: 1e-300 is 0 in f32, where the clamp never acts.
template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() {
    return 0.0f;
}
template <> __device__ __forceinline__ double tiny_pivot<double>() {
    return 1e-300;
}

// -- bfloat16: a and b rounded to nearest even, packed a low, b high ----

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_bf16(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// x[0 .. N-1] rounded to bfloat16 and widened back (exact)
template <int N>
__device__ __forceinline__ void round_bf16(float* x) {
    if constexpr (N == 1) {
        x[0] = __bfloat162float(__float2bfloat16_rn(x[0]));
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            const uint32_t w = pack_bf16(x[i], x[i + 1]);
            x[i] = lo_bf16(w);
            x[i + 1] = hi_bf16(w);
        }
    }
}
template <int N>
__device__ __forceinline__ void round_bf16(double*) {}

// -- vector loads and stores of N values, 16 bytes at most a piece; p on
// a boundary of the piece's width ----------------------------------------

template <int B> struct Piece;
template <> struct Piece<4> { typedef unsigned int type; };
template <> struct Piece<8> { typedef uint2 type; };
template <> struct Piece<16> { typedef uint4 type; };

template <typename T, int N>
__device__ __forceinline__ void ld(const T* __restrict__ p, T* x) {
    constexpr int B = N * (int)sizeof(T);
    constexpr int W = B >= 16 ? 16 : B;
    constexpr int E = W / (int)sizeof(T);
    static_assert(B % W == 0, "a run of whole pieces");
    typedef typename Piece<W>::type V;
    union { V v; T t[E]; } w;
#pragma unroll
    for (int i = 0; i < B / W; ++i) {
        w.v = __ldg(reinterpret_cast<const V*>(p) + i);
#pragma unroll
        for (int j = 0; j < E; ++j) x[i * E + j] = w.t[j];
    }
}

template <typename T, int N>
__device__ __forceinline__ void st(T* p, const T* x) {
    constexpr int B = N * (int)sizeof(T);
    constexpr int W = B >= 16 ? 16 : B;
    constexpr int E = W / (int)sizeof(T);
    static_assert(B % W == 0, "a run of whole pieces");
    typedef typename Piece<W>::type V;
    union { V v; T t[E]; } w;
#pragma unroll
    for (int i = 0; i < B / W; ++i) {
#pragma unroll
        for (int j = 0; j < E; ++j) w.t[j] = x[i * E + j];
        reinterpret_cast<V*>(p)[i] = w.v;
    }
}

struct BpaDesc {            // mirrored by ops/cuda_bpa.py::_BpaDesc
    const int* cols;        // [K, n_rows]
    const void* vals;       // [n_ops, K, n_rows]: ops 0 (d/dx), 1 (d/dy)
    const void* zx;         // [n_rows, nz] each: dzeta/dx, dzeta/dy,
    const void* zy;         //   eta and its x, y, z derivatives
    const void* eta;
    const void* eta_x;
    const void* eta_y;
    const void* eta_z;
    const void* zz;         // [n_rows] each: dzeta/dz and its square,
    const void* zz2;        //   the surface and bed slopes, dzeta / zz,
    const void* dh_dx;      //   Q_fac, the base row's Q and R, and
    const void* dh_dy;      //   beta / eta_base
    const void* db_dx;
    const void* db_dy;
    const void* dzz;
    const void* qfac;
    const void* qb;
    const void* rb;
    const void* ratio;
    const int* tric;        // [n_rows, 3], -1: no neighbour
    const unsigned char* code;
    void* scratch;          // [n_rows, nz, 4]: ux, uy, vx, vy
    double dzeta, two_dzeta, dzeta_sq;
    int n_rows, K, nz, round_x_bf16, no_sliding;
    void* scratch_bf16;     // [n_rows, nz, 4] bfloat16: the same rounded
};

struct ThomasDesc {         // mirrored by ops/cuda_bpa.py::_ThomasDesc
    const void* sub;        // [n_rows, nz - 1]
    const void* dia;        // [n_rows, nz]
    const void* sup;        // [n_rows, nz - 1]
    int n_rows, nz;
};

template <typename T>
struct Fields {             // BpaDesc with its types, passed by value
    const int* __restrict__ cols;
    const T* __restrict__ vals;
    const T* __restrict__ zx;
    const T* __restrict__ zy;
    const T* __restrict__ eta;
    const T* __restrict__ eta_x;
    const T* __restrict__ eta_y;
    const T* __restrict__ eta_z;
    const T* __restrict__ zz;
    const T* __restrict__ zz2;
    const T* __restrict__ dh_dx;
    const T* __restrict__ dh_dy;
    const T* __restrict__ db_dx;
    const T* __restrict__ db_dy;
    const T* __restrict__ dzz;
    const T* __restrict__ qfac;
    const T* __restrict__ qb;
    const T* __restrict__ rb;
    const T* __restrict__ ratio;
    const int* __restrict__ tric;
    const unsigned char* __restrict__ code;
    T* d1;                  // the scratch
    uint32_t* d1h;          // its bfloat16 copy (f32 with ROUND), 2 words
    T dz, two_dz, dz2;      //   a layer
    int n, K, nz;
};

// This thread's row r and the first layer k0 of its run of R layers
// (nz / R runs a row, on neighbouring lanes).
template <int R>
__device__ __forceinline__ bool run_of(int nz, int n, int& r, int& k0) {
    const int runs = nz / R;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)n * runs) return false;
    r = (int)(gid / runs);
    k0 = (int)(gid - (long long)r * runs) * R;
    return true;
}

// The run k0 .. k0+R-1 of a column with its neighbours at the edges:
// c[1 + i] = col[k0 + i], c[0] = col[k0 - 1], c[R + 1] = col[k0 + R]
// (0 past the column's ends, where ddz_at does not read them).
template <typename T, int R>
__device__ __forceinline__ void column_run(const T* __restrict__ col, int k0,
                                           int nz, T* c) {
    ld<T, R>(col + k0, c + 1);
    c[0] = k0 > 0 ? __ldg(col + k0 - 1) : T(0);
    c[R + 1] = k0 + R < nz ? __ldg(col + k0 + R) : T(0);
}

// d/dzeta at layer k, held at c[S (i + 1)] with its neighbours at
// c[S i] and c[S (i + 2)]: central inside, one-sided at the ends
// (bpa.py:114-120)
template <typename T, int S>
__device__ __forceinline__ T ddz_at(const T* c, int i, int k, int nz, T dz,
                                    T two_dz) {
    if (k == 0) return div_rn(sub_rn(c[S * (i + 2)], c[S * (i + 1)]), dz);
    if (k == nz - 1) return div_rn(sub_rn(c[S * (i + 1)], c[S * i]), dz);
    return div_rn(sub_rn(c[S * (i + 2)], c[S * i]), two_dz);
}

// sum over slots 0, 1, 2 of x[neighbour, k] (0 where there is none),
// minus n_neighbours * x[r, k], for the run's layers
template <typename T, int R>
__device__ __forceinline__ void nbr_residual(const T* __restrict__ x,
                                             const int* __restrict__ t,
                                             int k0, int nz, const T* xr,
                                             T* out) {
    T g[3][R];
    int n = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        const int ts = __ldg(t + s);
        if (ts >= 0) {
            ld<T, R>(x + (size_t)ts * nz + k0, g[s]);
            ++n;
        } else {
#pragma unroll
            for (int i = 0; i < R; ++i) g[s][i] = T(0);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
        out[i] = sub_rn(add_rn(add_rn(g[0][i], g[1][i]), g[2][i]),
                        mul_rn(T(n), xr[i]));
}

// a1 + a2 + ... left to right
template <typename T>
__device__ __forceinline__ T sum7(T a1, T a2, T a3, T a4, T a5, T a6,
                                  T a7) {
    T s = add_rn(a1, a2);
    s = add_rn(s, a3);
    s = add_rn(s, a4);
    s = add_rn(s, a5);
    s = add_rn(s, a6);
    return add_rn(s, a7);
}
template <typename T>
__device__ __forceinline__ T sum9(T a1, T a2, T a3, T a4, T a5, T a6,
                                  T a7, T a8, T a9) {
    return add_rn(add_rn(sum7(a1, a2, a3, a4, a5, a6, a7), a8), a9);
}

// Pass 1: ux, uy, vx, vy at (r, k) for the run's layers = stencil sums of
// the (rounded) u, v at layer k over the entries in turn from 0, plus
// dzeta/dx(y) times the zeta difference; with ROUND also their copy
// rounded once to bfloat16.
template <typename T, bool ROUND, int KT, int NZ, int R>
__global__ void __launch_bounds__(UF_BPA_THREADS, UF_BPA_BLOCKS(T))
bpa_first_kernel(Fields<T> f, const T* __restrict__ u,
                 const T* __restrict__ v) {
    const int nz = NZ > 0 ? NZ : f.nz;
    int r, k0;
    if (!run_of<R>(nz, f.n, r, k0)) return;
    const int n = f.n;
    const int K = KT > 0 ? KT : f.K;
    const T* vx_ = f.vals;
    const T* vy_ = f.vals + (size_t)K * n;
    T sxu[R], syu[R], sxv[R], syv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sxu[i] = syu[i] = sxv[i] = syv[i] = T(0);
#pragma unroll
    for (int e = 0; e < (KT > 0 ? KT : UF_K_MAX); ++e) {
        if (KT == 0 && e >= K) break;
        const size_t ek = (size_t)e * n + r;
        const int c = __ldg(f.cols + ek);
        const T ax = __ldg(vx_ + ek), ay = __ldg(vy_ + ek);
        T xu[R], xv[R];
        ld<T, R>(u + (size_t)c * nz + k0, xu);
        ld<T, R>(v + (size_t)c * nz + k0, xv);
        if (ROUND) {
            round_bf16<R>(xu);
            round_bf16<R>(xv);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
            sxu[i] = add_rn(sxu[i], mul_rn(ax, xu[i]));
            syu[i] = add_rn(syu[i], mul_rn(ay, xu[i]));
            sxv[i] = add_rn(sxv[i], mul_rn(ax, xv[i]));
            syv[i] = add_rn(syv[i], mul_rn(ay, xv[i]));
        }
    }
    const size_t o = (size_t)r * nz + k0;
    T uc[R + 2], vc[R + 2], zx[R], zy[R], d[4 * R];
    column_run<T, R>(u + (size_t)r * nz, k0, nz, uc);
    column_run<T, R>(v + (size_t)r * nz, k0, nz, vc);
    ld<T, R>(f.zx + o, zx);
    ld<T, R>(f.zy + o, zy);
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int k = k0 + i;
        const T du = ddz_at<T, 1>(uc, i, k, nz, f.dz, f.two_dz);
        const T dv = ddz_at<T, 1>(vc, i, k, nz, f.dz, f.two_dz);
        d[4 * i] = add_rn(sxu[i], mul_rn(zx[i], du));
        d[4 * i + 1] = add_rn(syu[i], mul_rn(zy[i], du));
        d[4 * i + 2] = add_rn(sxv[i], mul_rn(zx[i], dv));
        d[4 * i + 3] = add_rn(syv[i], mul_rn(zy[i], dv));
    }
    st<T, 4 * R>(f.d1 + 4 * o, d);
    if constexpr (ROUND) {
        uint32_t h[2 * R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            h[2 * i] = pack_bf16(d[4 * i], d[4 * i + 1]);
            h[2 * i + 1] = pack_bf16(d[4 * i + 2], d[4 * i + 3]);
        }
        st<uint32_t, 2 * R>(f.d1h + 2 * o, h);
    }
}

// Pass 2: the operator's rows at (r, k) for the run's layers.
template <typename T, bool ROUND, int KT, int NZ, int R>
__global__ void __launch_bounds__(UF_BPA_THREADS, UF_BPA_BLOCKS(T))
bpa_rows_kernel(Fields<T> f, const T* __restrict__ u,
                const T* __restrict__ v, T* __restrict__ Au,
                T* __restrict__ Av, int no_sliding) {
    const int nz = NZ > 0 ? NZ : f.nz;
    int r, k0;
    if (!run_of<R>(nz, f.n, r, k0)) return;
    const int n = f.n;
    const size_t o = (size_t)r * nz + k0;
    const T* ucol = u + (size_t)r * nz;
    const T* vcol = v + (size_t)r * nz;

    const int cd = f.code[r];
    if (cd != 0) {                          // lateral rows, whole column
        const int* t = f.tric + (size_t)r * 3;
        T ur[R], vr[R], au[R], av[R];
        ld<T, R>(ucol + k0, ur);
        ld<T, R>(vcol + k0, vr);
#pragma unroll
        for (int i = 0; i < R; ++i) {
            au[i] = ur[i];
            av[i] = vr[i];
        }
        if (cd & UF_ROW_INF_U) nbr_residual<T, R>(u, t, k0, nz, ur, au);
        if (cd & UF_ROW_INF_V) nbr_residual<T, R>(v, t, k0, nz, vr, av);
        st<T, R>(Au + o, au);
        st<T, R>(Av + o, av);
        return;
    }

    const int K = KT > 0 ? KT : f.K;
    const T* vx_ = f.vals;
    const T* vy_ = f.vals + (size_t)K * n;
    T s_xxu[R], s_xyu[R], s_yyu[R], s_xxv[R], s_xyv[R], s_yyv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
        s_xxu[i] = s_xyu[i] = s_yyu[i] = s_xxv[i] = s_xyv[i] = s_yyv[i] =
            T(0);
#pragma unroll
    for (int e = 0; e < (KT > 0 ? KT : UF_K_MAX); ++e) {
        if (KT == 0 && e >= K) break;
        const size_t ek = (size_t)e * n + r;
        const int c = __ldg(f.cols + ek);
        const T ax = __ldg(vx_ + ek), ay = __ldg(vy_ + ek);
        const size_t co = (size_t)c * nz + k0;
        T g[4 * R];                         // ux, uy, vx, vy a layer
        if constexpr (ROUND) {              // the copy rounded once
            uint32_t h[2 * R];
            ld<uint32_t, 2 * R>(f.d1h + 2 * co, h);
#pragma unroll
            for (int j = 0; j < 2 * R; ++j) {
                g[2 * j] = lo_bf16(h[j]);
                g[2 * j + 1] = hi_bf16(h[j]);
            }
        } else {
            ld<T, 4 * R>(f.d1 + 4 * co, g);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
            s_xxu[i] = add_rn(s_xxu[i], mul_rn(ax, g[4 * i]));
            s_xyu[i] = add_rn(s_xyu[i], mul_rn(ay, g[4 * i]));
            s_yyu[i] = add_rn(s_yyu[i], mul_rn(ay, g[4 * i + 1]));
            s_xxv[i] = add_rn(s_xxv[i], mul_rn(ax, g[4 * i + 2]));
            s_xyv[i] = add_rn(s_xyv[i], mul_rn(ay, g[4 * i + 2]));
            s_yyv[i] = add_rn(s_yyv[i], mul_rn(ay, g[4 * i + 3]));
        }
    }

    // the own row: first derivatives (exact) at k0-1 .. k0+R, u and v
    T D[4 * (R + 2)], uc[R + 2], vc[R + 2];
#pragma unroll
    for (int j = 0; j < 4; ++j) D[j] = D[4 * (R + 1) + j] = T(0);
    const T* d1 = f.d1;
    ld<T, 4 * R>(d1 + 4 * o, D + 4);
    if (k0 > 0) ld<T, 4>(d1 + 4 * (o - 1), D);
    if (k0 + R < nz) ld<T, 4>(d1 + 4 * (o + R), D + 4 * (R + 1));
    column_run<T, R>(ucol, k0, nz, uc);
    column_run<T, R>(vcol, k0, nz, vc);
    T zx[R], zy[R], et[R], etx[R], ety[R], etz[R], au[R], av[R];
    ld<T, R>(f.zx + o, zx);
    ld<T, R>(f.zy + o, zy);
    ld<T, R>(f.eta + o, et);
    ld<T, R>(f.eta_x + o, etx);
    ld<T, R>(f.eta_y + o, ety);
    ld<T, R>(f.eta_z + o, etz);
    const T two = T(2);

#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int k = k0 + i;
        // nz is a multiple of R: the surface is the first layer of run 0,
        // the base the last layer of the last run
        const bool surface = i == 0 && k0 == 0;
        const bool base = i == R - 1 && k0 + R == nz;
        if (base && no_sliding) {           // no-slip base: u = v = 0
            au[i] = uc[i + 1];
            av[i] = vc[i + 1];
            continue;
        }
        const T dux = ddz_at<T, 4>(D, i, k, nz, f.dz, f.two_dz);
        const T duy = ddz_at<T, 4>(D + 1, i, k, nz, f.dz, f.two_dz);
        const T dvx = ddz_at<T, 4>(D + 2, i, k, nz, f.dz, f.two_dz);
        const T dvy = ddz_at<T, 4>(D + 3, i, k, nz, f.dz, f.two_dz);
        const T uxx = add_rn(s_xxu[i], mul_rn(zx[i], dux));
        const T uxy = add_rn(s_xyu[i], mul_rn(zy[i], dux));
        const T uyy = add_rn(s_yyu[i], mul_rn(zy[i], duy));
        const T vxx = add_rn(s_xxv[i], mul_rn(zx[i], dvx));
        const T vxy = add_rn(s_xyv[i], mul_rn(zy[i], dvx));
        const T vyy = add_rn(s_yyv[i], mul_rn(zy[i], dvy));
        const T ux = D[4 * (i + 1)], uy = D[4 * (i + 1) + 1];
        const T vx = D[4 * (i + 1) + 2], vy = D[4 * (i + 1) + 3];

        const T e = et[i], ex = etx[i], ey = ety[i], ez = etz[i];
        // 4, 2 times a field are exact; 3 times one is rounded once
        const T e4 = mul_rn(T(4), e), e3 = mul_rn(T(3), e);
        const T ex4 = mul_rn(T(4), ex), ex2 = mul_rn(T(2), ex);
        const T ey4 = mul_rn(T(4), ey), ey2 = mul_rn(T(2), ey);
        if (surface) {
            // zero stress, the ghost point eliminated (bpa.py:226-248)
            const T dhx = __ldg(f.dh_dx + r), dhy = __ldg(f.dh_dy + r);
            const T Su = add_rn(mul_rn(mul_rn(two, dhx),
                                       add_rn(mul_rn(two, ux), vy)),
                                mul_rn(dhy, add_rn(uy, vx)));
            const T Sv = add_rn(mul_rn(mul_rn(two, dhy),
                                       add_rn(mul_rn(two, vy), ux)),
                                mul_rn(dhx, add_rn(vx, uy)));
            const T q = __ldg(f.qfac + r), dzz = __ldg(f.dzz + r);
            const T uzz0 = mul_rn(q, sub_rn(sub_rn(uc[i + 2], uc[i + 1]),
                                            mul_rn(dzz, Su)));
            const T vzz0 = mul_rn(q, sub_rn(sub_rn(vc[i + 2], vc[i + 1]),
                                            mul_rn(dzz, Sv)));
            au[i] = sum9(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                         mul_rn(ey, uy), mul_rn(e, uzz0), mul_rn(ez, Su),
                         mul_rn(e3, vxy), mul_rn(ex2, vy), mul_rn(ey, vx));
            av[i] = sum9(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                         mul_rn(ex, vx), mul_rn(e, vzz0), mul_rn(ez, Sv),
                         mul_rn(e3, uxy), mul_rn(ey2, ux), mul_rn(ex, uy));
        } else if (base) {
            // sliding (bpa.py:250-282)
            const T dbx = __ldg(f.db_dx + r), dby = __ldg(f.db_dy + r);
            const T rat = __ldg(f.ratio + r);
            const T ub = uc[i + 1], vb = vc[i + 1];
            const T Pu = add_rn(add_rn(mul_rn(mul_rn(two, dbx),
                                              add_rn(mul_rn(two, ux), vy)),
                                       mul_rn(dby, add_rn(uy, vx))),
                                mul_rn(rat, ub));
            const T Pv = add_rn(add_rn(mul_rn(mul_rn(two, dby),
                                              add_rn(mul_rn(two, vy), ux)),
                                       mul_rn(dbx, add_rn(vx, uy))),
                                mul_rn(rat, vb));
            const T qb = __ldg(f.qb + r), rb = __ldg(f.rb + r);
            T a = sum7(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                       mul_rn(ey, uy), mul_rn(e3, vxy), mul_rn(ex2, vy),
                       mul_rn(ey, vx));
            a = add_rn(a, mul_rn(qb, sub_rn(uc[i], ub)));
            au[i] = add_rn(a, mul_rn(rb, Pu));
            T b = sum7(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                       mul_rn(ex, vx), mul_rn(e3, uxy), mul_rn(ey2, ux),
                       mul_rn(ex, uy));
            b = add_rn(b, mul_rn(qb, sub_rn(vc[i], vb)));
            av[i] = add_rn(b, mul_rn(rb, Pv));
        } else {
            const T zz = __ldg(f.zz + r), zz2 = __ldg(f.zz2 + r);
            const T uz = mul_rn(zz, ddz_at<T, 1>(uc, i, k, nz, f.dz,
                                                 f.two_dz));
            const T vz = mul_rn(zz, ddz_at<T, 1>(vc, i, k, nz, f.dz,
                                                 f.two_dz));
            const T uzz = mul_rn(zz2, div_rn(sub_rn(add_rn(uc[i + 2],
                                                           uc[i]),
                                                    mul_rn(two, uc[i + 1])),
                                             f.dz2));
            const T vzz = mul_rn(zz2, div_rn(sub_rn(add_rn(vc[i + 2],
                                                           vc[i]),
                                                    mul_rn(two, vc[i + 1])),
                                             f.dz2));
            au[i] = sum9(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                         mul_rn(ey, uy), mul_rn(e, uzz), mul_rn(ez, uz),
                         mul_rn(e3, vxy), mul_rn(ex2, vy), mul_rn(ey, vx));
            av[i] = sum9(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                         mul_rn(ex, vx), mul_rn(e, vzz), mul_rn(ez, vz),
                         mul_rn(e3, uxy), mul_rn(ey2, ux), mul_rn(ex, uy));
        }
    }
    st<T, R>(Au + o, au);
    st<T, R>(Av + o, av);
}

// -- line_thomas ----------------------------------------------------------

// One value, or 16 bytes, from global to shared memory, not through
// registers: a thread's copies stay in flight together until
// cp_async_wait.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(B));
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// count contiguous values from src to dst, in 16-byte pieces where `vec`
// (src on a 16-byte boundary; dst always is)
template <typename T>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, int count,
                                           bool vec) {
    constexpr int E = 16 / (int)sizeof(T);
    int e0 = 0;
    if (vec) {
        for (int q = threadIdx.x; q < count / E; q += blockDim.x)
            cp_async<16>(dst + q * E, src + q * E);
        e0 = count / E * E;
    }
    for (int e = e0 + threadIdx.x; e < count; e += blockDim.x)
        cp_async<sizeof(T)>(dst + e, src + e);
}

// UF_THOMAS_COLS columns a block, two lanes a column (lane 2c + s solves
// right-hand side s of column c), in shared memory as the slabs lie in
// global memory (copied in 16-byte pieces): the bands, the pivots' c'
// and the two right-hand sides one slab after the other, which the
// forward sweep overwrites with d' and the back substitution with x. Both
// lanes of a column form the same pivots by the same operations and
// write the same c'. The recurrence is that of ops/tridiag.py
// thomas_batched (pivots below 1e-300 in magnitude clamped to 1e-300; in
// f32 that constant is 0 and the clamp never acts, as in the plain
// version).
template <typename T, int NZ>
__global__ void __launch_bounds__(2 * UF_THOMAS_COLS)
line_thomas_kernel(const T* __restrict__ sub, const T* __restrict__ dia,
                   const T* __restrict__ sup, const T* __restrict__ ru,
                   const T* __restrict__ rv, T* __restrict__ xu,
                   T* __restrict__ xv, int n, int nz_rt, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int C = UF_THOMAS_COLS;
    const int nz = NZ > 0 ? NZ : nz_rt;
    T* s_sub = reinterpret_cast<T*>(smem);      // [C][nz - 1]
    T* s_sup = s_sub + C * (nz - 1);            // [C][nz - 1]
    T* s_dia = s_sup + C * (nz - 1);            // [C][nz]
    T* s_cp = s_dia + C * nz;                   // [C][nz]
    T* s_b = s_cp + C * nz;                     // [2][C][nz]
    const int c0 = blockIdx.x * C;
    const int nc = min(C, n - c0);
    const size_t o1 = (size_t)c0 * (nz - 1), o = (size_t)c0 * nz;
    stage_slab<T>(s_sub, sub + o1, nc * (nz - 1), vec);
    stage_slab<T>(s_sup, sup + o1, nc * (nz - 1), vec);
    stage_slab<T>(s_dia, dia + o, nc * nz, vec);
    stage_slab<T>(s_b, ru + o, nc * nz, vec);
    stage_slab<T>(s_b + C * nz, rv + o, nc * nz, vec);
    cp_async_wait();
    __syncthreads();

    const int col = threadIdx.x >> 1, side = threadIdx.x & 1;
    if (col < nc) {
        const T* l = s_sub + col * (nz - 1);
        const T* dg = s_dia + col * nz;
        const T* up = s_sup + col * (nz - 1);
        T* cp = s_cp + col * nz;
        T* b = s_b + (side * C + col) * nz;
        const T tiny = tiny_pivot<T>();
        T c_prev = T(0), d_prev = T(0);
#pragma unroll
        for (int k = 0; k < nz; ++k) {
            const T lk = k == 0 ? T(0) : l[k - 1];
            const T uk = k == nz - 1 ? T(0) : up[k];
            T den = sub_rn(dg[k], mul_rn(lk, c_prev));
            if (abs_of(den) < tiny) den = tiny;
            // zero dividends, kept off the division's slow path: c' at the
            // last level and on identity columns (the lateral rows, whose
            // bands are 0), d' at the no-slip base rows' last level
            const T num = sub_rn(b[k], mul_rn(lk, d_prev));
            c_prev = div_z(uk, den);
            d_prev = k == nz - 1 ? div_z(num, den) : div_rn(num, den);
            cp[k] = c_prev;
            b[k] = d_prev;
        }
        T x = T(0);
#pragma unroll
        for (int k = nz - 1; k >= 0; --k) {
            x = sub_rn(b[k], mul_rn(cp[k], x));
            b[k] = x;
        }
    }
    __syncthreads();

    // the solutions back, in 16-byte pieces where the slabs allow
    constexpr int E = 16 / (int)sizeof(T);
    const int count = nc * nz;
    for (int s = 0; s < 2; ++s) {
        T* dst = (s ? xv : xu) + o;
        const T* src = s_b + s * C * nz;
        int e0 = 0;
        if (vec) {
            for (int q = threadIdx.x; q < count / E; q += blockDim.x)
                *reinterpret_cast<uint4*>(dst + q * E) =
                    *reinterpret_cast<const uint4*>(src + q * E);
            e0 = count / E * E;
        }
        for (int e = e0 + threadIdx.x; e < count; e += blockDim.x)
            dst[e] = src[e];
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

static inline bool on16(const void* p) {
    return ((uintptr_t)p & 15u) == 0;
}

template <typename T>
static Fields<T> fields_of(const BpaDesc& d) {
    Fields<T> f;
    f.cols = d.cols;
    f.vals = static_cast<const T*>(d.vals);
    f.zx = static_cast<const T*>(d.zx);
    f.zy = static_cast<const T*>(d.zy);
    f.eta = static_cast<const T*>(d.eta);
    f.eta_x = static_cast<const T*>(d.eta_x);
    f.eta_y = static_cast<const T*>(d.eta_y);
    f.eta_z = static_cast<const T*>(d.eta_z);
    f.zz = static_cast<const T*>(d.zz);
    f.zz2 = static_cast<const T*>(d.zz2);
    f.dh_dx = static_cast<const T*>(d.dh_dx);
    f.dh_dy = static_cast<const T*>(d.dh_dy);
    f.db_dx = static_cast<const T*>(d.db_dx);
    f.db_dy = static_cast<const T*>(d.db_dy);
    f.dzz = static_cast<const T*>(d.dzz);
    f.qfac = static_cast<const T*>(d.qfac);
    f.qb = static_cast<const T*>(d.qb);
    f.rb = static_cast<const T*>(d.rb);
    f.ratio = static_cast<const T*>(d.ratio);
    f.tric = d.tric;
    f.code = d.code;
    f.d1 = static_cast<T*>(d.scratch);
    f.d1h = static_cast<uint32_t*>(d.scratch_bf16);
    f.dz = T(d.dzeta);
    f.two_dz = T(d.two_dzeta);
    f.dz2 = T(d.dzeta_sq);
    f.n = d.n_rows;
    f.K = d.K;
    f.nz = d.nz;
    return f;
}

template <typename T, bool ROUND, int KT, int NZ, int R>
static int launch_bpa(const Fields<T>& f, const T* u, const T* v, T* Au,
                      T* Av, int no_sliding, cudaStream_t stream) {
    const unsigned threads = UF_BPA_THREADS;
    const long long items = (long long)f.n * (f.nz / R);
    const unsigned blocks = (unsigned)((items + threads - 1) / threads);
    bpa_first_kernel<T, ROUND, KT, NZ, R><<<blocks, threads, 0, stream>>>(
        f, u, v);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    bpa_rows_kernel<T, ROUND, KT, NZ, R><<<blocks, threads, 0, stream>>>(
        f, u, v, Au, Av, no_sliding);
    return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
static int bpa_apply(const BpaDesc& d, const T* u, const T* v, T* Au, T* Av,
                     cudaStream_t stream) {
    if ((long long)d.n_rows * d.nz == 0) return 0;
    if (d.nz < 3 || d.nz > UF_NZ_MAX || d.K < 1 || d.K > UF_K_MAX)
        return (int)cudaErrorInvalidValue;
    if (ROUND && d.scratch_bf16 == nullptr)
        return (int)cudaErrorInvalidValue;
    const Fields<T> f = fields_of<T>(d);
    const int ns = d.no_sliding;
    // the runs of UF_BPA_RUN layers need nz 12 and every [n, nz] operand
    // on a 16-byte boundary; otherwise runs of one layer
    const bool runs = d.nz == 12 && on16(u) && on16(v) && on16(Au) &&
                      on16(Av) && on16(d.zx) && on16(d.zy) && on16(d.eta) &&
                      on16(d.eta_x) && on16(d.eta_y) && on16(d.eta_z) &&
                      on16(d.scratch) && on16(d.scratch_bf16);
    constexpr int R = sizeof(T) == 4 ? UF_BPA_RUN : UF_BPA_RUN64;
    if (runs && d.K == 10)
        return launch_bpa<T, ROUND, 10, 12, R>(f, u, v, Au, Av, ns, stream);
    if (runs)
        return launch_bpa<T, ROUND, 0, 12, R>(f, u, v, Au, Av, ns, stream);
    if (d.K == 10)
        return launch_bpa<T, ROUND, 10, 0, 1>(f, u, v, Au, Av, ns, stream);
    return launch_bpa<T, ROUND, 0, 0, 1>(f, u, v, Au, Av, ns, stream);
}

template <typename T, int NZ>
static int launch_thomas(const ThomasDesc& d, const T* ru, const T* rv,
                         T* xu, T* xv, int vec, cudaStream_t stream) {
    const size_t bytes = (size_t)UF_THOMAS_COLS * (6 * d.nz - 2) * sizeof(T);
    if (bytes > 48 * 1024) {
        const int err = (int)cudaFuncSetAttribute(
            line_thomas_kernel<T, NZ>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != 0) return err;
    }
    const unsigned blocks = (unsigned)((d.n_rows + UF_THOMAS_COLS - 1)
                                       / UF_THOMAS_COLS);
    line_thomas_kernel<T, NZ><<<blocks, 2 * UF_THOMAS_COLS, bytes, stream>>>(
        static_cast<const T*>(d.sub), static_cast<const T*>(d.dia),
        static_cast<const T*>(d.sup), ru, rv, xu, xv, d.n_rows, d.nz, vec);
    return (int)cudaGetLastError();
}

template <typename T>
static int line_thomas(const ThomasDesc& d, const T* ru, const T* rv, T* xu,
                       T* xv, cudaStream_t stream) {
    if (d.n_rows == 0) return 0;
    if (d.nz < 3 || d.nz > UF_NZ_MAX) return (int)cudaErrorInvalidValue;
    const int vec = on16(d.sub) && on16(d.dia) && on16(d.sup) && on16(ru) &&
                    on16(rv) && on16(xu) && on16(xv);
    if (d.nz == 12)
        return launch_thomas<T, 12>(d, ru, rv, xu, xv, vec, stream);
    return launch_thomas<T, 0>(d, ru, rv, xu, xv, vec, stream);
}

extern "C" int bpa_apply_f32(const BpaDesc* d, const float* u,
                             const float* v, float* Au, float* Av,
                             void* stream) {
    if (d->round_x_bf16)
        return bpa_apply<float, true>(*d, u, v, Au, Av, (cudaStream_t)stream);
    return bpa_apply<float, false>(*d, u, v, Au, Av, (cudaStream_t)stream);
}

extern "C" int bpa_apply_f64(const BpaDesc* d, const double* u,
                             const double* v, double* Au, double* Av,
                             void* stream) {
    if (d->round_x_bf16) return (int)cudaErrorInvalidValue;
    return bpa_apply<double, false>(*d, u, v, Au, Av, (cudaStream_t)stream);
}

extern "C" int line_thomas_f32(const ThomasDesc* d, const float* ru,
                               const float* rv, float* xu, float* xv,
                               void* stream) {
    return line_thomas<float>(*d, ru, rv, xu, xv, (cudaStream_t)stream);
}

extern "C" int line_thomas_f64(const ThomasDesc* d, const double* ru,
                               const double* rv, double* xu, double* xv,
                               void* stream) {
    return line_thomas<double>(*d, ru, rv, xu, xv, (cudaStream_t)stream);
}
