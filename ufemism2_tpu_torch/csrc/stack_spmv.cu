// Stack SpMV and the DIVA operator fused onto it, for sm_90a.
//
//   stack_spmv:  y[o, r, j] = sum_k vals[o, k, r] * x[cols[k, r], j]
//   diva_apply:  (Au, Av)[r] of the linearised SSA/DIVA momentum operator,
//                from the same sum for the five b-grid derivative operators
//                applied to (u, v), scaled by the per-triangle fields, with
//                the boundary rows - and, with an ocean-pressure calving
//                front, the front rows and the identity rows off the ice -
//                written in the same launch.
//
// for n_ops operators that share one sparsity pattern (padded ELL).
//
// stack_spmv replaces the Pallas kernel
// ufemism2_tpu/ops/pallas_spmv.py::_group_kernel (launched by
// grouped_apply_pallas): with n_ops = 5 the b-grid derivative stack, with
// n_ops = 1 every single-operator mesh apply. diva_apply has no Pallas
// counterpart: around that kernel XLA fuses the scaling, the boundary rows
// and the (u, v) packing of ufemism2_tpu/core/ice/ssadiva.py::make_A into
// a few loops; eager PyTorch runs them as some fifty launches, and on this
// card the launch, not the byte, is the unit of cost.
//
// Bound: bytes. At the MISMIP 8 km size (27.3k rows, ~10 entries a row,
// 5 operators, d = 2, f32) one call moves about 8 MB - 5.5 MB of
// coefficients, 1.1 MB of indices, 0.2 MB of x, 1.1 MB of y (diva_apply:
// no y; u, v, four fields, the row code and Au, Av instead, 0.9 MB) - which
// the card's 3.35 TB/s could stream in about 2.4 us; the arithmetic
// (5.4 MFLOP) is three orders of magnitude below the f32 peak. All of it
// fits the 50 MB L2, so repeated applies inside a Krylov solve never reach
// HBM, and a launch (about 2.4 us inside a CUDA graph) costs as much as the
// data movement. Shared-memory staging, TMA and wgmma have nothing to bite
// on: the gathers are 4 to 16 bytes wide and each loaded coefficient feeds
// two flops.
//
// What the design does about it:
// - Layout: the index table is shared by all operators (read once for n_ops
//   products) and both tables are entry-major ([K, n_rows] /
//   [n_ops, K, n_rows]), so the threads of a warp, which handle neighbouring
//   rows, read neighbouring addresses. The tile slab, the row-block buckets
//   and the bf16 (hi, lo) coefficient split of the TPU kernel answer to that
//   machine's slow element gathers and its bf16 matrix unit; none of it is
//   carried over - coefficients are plain f32/f64.
// - One lane group per (row, chunk of W columns of x): the W columns come
//   in one vector load of up to 16 bytes, so for d = 2 the index and the
//   coefficients of an entry are read once per row and not once per column.
// - The ELL width K is a template parameter for the widths the 8 km mesh
//   has (3 and 10): the loop is unrolled, all index loads are started first,
//   then all coefficient loads and gathers, then the FMAs, so one thread
//   has its whole row in flight. Any other K takes a run-time loop.
// - LANES lanes share the K entries of a row and add their n_ops * W
//   partial sums with __shfl_xor_sync: more loads in flight when one thread
//   a row leaves the SMs short of threads. Each kernel has one lane count,
//   fixed below from its times on the card.
//
// ROUND (f32 only) rounds the gathered x operand to bfloat16 (round to
// nearest even) and back, reproducing the reference's default f32 matvec
// arithmetic, in which the x side is rounded and the coefficients are not.
// In diva_apply only the derivative terms see the rounded value: beta * u,
// the boundary rows and the rows off the ice use u and v as they are; the
// front rows are made of derivative terms alone. A front adds to the bytes
// the row codes of the solve (one byte a row, as the static ones) and the
// two normals of each front row.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ T round_bf16(T v) { return v; }

template <>
__device__ __forceinline__ float round_bf16<float>(float v) {
    uint32_t u = __float_as_uint(v);
    if ((u & 0x7fffffffu) > 0x7f800000u) return v;          // NaN stays NaN
    u += 0x7fffu + ((u >> 16) & 1u);                        // nearest even
    return __uint_as_float(u & 0xffff0000u);
}

// W consecutive elements in one read-only load / one store
__device__ __forceinline__ void ldg_vec(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
}
__device__ __forceinline__ void ldg_vec(const float* p, float (&v)[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void ldg_vec(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldg_vec(const double* p, double (&v)[1]) {
    v[0] = __ldg(p);
}
__device__ __forceinline__ void ldg_vec(const double* p, double (&v)[2]) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[1]) {
    p[0] = v[0];
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double (&v)[1]) {
    p[0] = v[0];
}
__device__ __forceinline__ void st_vec(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Products and sums rounded once each, never contracted into a fused
// multiply-add: the scaling of a diva_apply row is then, term for term and
// rounding for rounding, what one tensor operation per term computes from
// the same derivatives, so the fused operator and the plain version differ
// only in the order of the derivative sums (and, in the instance with a
// calving front, whose derivative sums are formed the same way, not at
// all). That matters because the f32 GMRES solves end at their precision
// floor, where the iteration counts follow every rounding: with one lane a
// row the infinite-slab operator gives the model run the same trajectory,
// to the bit, as the stack kernel followed by separate launches for the
// scaling.
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

// The operand of a row sum: W values for a column index c.
template <typename T, int W>
struct ColumnsOfX {            // W neighbouring columns of row c of x
    const T* __restrict__ x;
    size_t ldx;
    __device__ __forceinline__ void load(int c, T (&v)[W]) const {
        ldg_vec(x + (size_t)c * ldx, v);
    }
};
template <typename T>
struct PairUV {                // (u[c], v[c]) of two vectors
    const T* __restrict__ u;
    const T* __restrict__ v;
    __device__ __forceinline__ void load(int c, T (&o)[2]) const {
        o[0] = __ldg(u + c);
        o[1] = __ldg(v + c);
    }
};

// acc[o][w] = sum over this lane's entries of row r of
// vals[o, k, r] * X(cols[k, r])[w]; then the sum over the LANES lanes of
// the row, left in every lane. KT > 0: K is KT, unrolled. EXACT (one lane
// a row): each product and each sum rounded once, k = 0, 1, ... in turn
// from 0 - the order of diva_apply_plain's derivative sums; otherwise the
// compiler contracts them into fused multiply-adds.
template <typename T, int NOPS, bool ROUND, int KT, int W, int LANES,
          bool EXACT = false, typename X>
__device__ __forceinline__ void row_sums(const int* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const X& x, int n_rows, int K,
                                         int r, int lane, T (&acc)[NOPS][W]) {
    static_assert(!EXACT || LANES == 1, "one order needs one lane a row");
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[o][w] = T(0);

    if constexpr (KT > 0) {
        constexpr int PER = (KT + LANES - 1) / LANES;    // entries a lane
        int c[PER];
        T a[NOPS][PER];
        T xv[PER][W];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int k = lane + i * LANES;
            c[i] = 0;
            if (k < KT) c[i] = __ldg(cols + (size_t)k * n_rows + r);
        }
#pragma unroll
        for (int o = 0; o < NOPS; ++o)
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int k = lane + i * LANES;
                a[o][i] = T(0);
                if (k < KT)
                    a[o][i] = __ldg(vals + ((size_t)o * KT + k) * n_rows + r);
            }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int k = lane + i * LANES;
#pragma unroll
            for (int w = 0; w < W; ++w) xv[i][w] = T(0);
            if (k < KT) x.load(c[i], xv[i]);
        }
#pragma unroll
        for (int i = 0; i < PER; ++i)
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const T xr = ROUND ? round_bf16<T>(xv[i][w]) : xv[i][w];
#pragma unroll
                for (int o = 0; o < NOPS; ++o) {
                    if constexpr (EXACT)
                        acc[o][w] = add_rn(acc[o][w], mul_rn(a[o][i], xr));
                    else
                        acc[o][w] += a[o][i] * xr;
                }
            }
    } else {
#pragma unroll 4
        for (int k = lane; k < K; k += LANES) {
            const size_t e = (size_t)k * n_rows + r;
            const int ck = __ldg(cols + e);
            T xk[W];
            x.load(ck, xk);
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const T xr = ROUND ? round_bf16<T>(xk[w]) : xk[w];
#pragma unroll
                for (int o = 0; o < NOPS; ++o) {
                    const T a = __ldg(vals + (size_t)o * K * n_rows + e);
                    if constexpr (EXACT)
                        acc[o][w] = add_rn(acc[o][w], mul_rn(a, xr));
                    else
                        acc[o][w] += a * xr;
                }
            }
        }
    }
    if (LANES > 1) {
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
#pragma unroll
            for (int o = 0; o < NOPS; ++o)
#pragma unroll
                for (int w = 0; w < W; ++w)
                    acc[o][w] += __shfl_xor_sync(0xffffffffu, acc[o][w], off);
    }
}

// One group of LANES lanes per (row, chunk of W columns); the chunks of a
// row lie in neighbouring groups, so x rows and y rows are read and written
// whole. Groups past the end work on row 0 and store nothing: every lane
// of a warp reaches the shuffles.
template <typename T, int NOPS, bool ROUND, int KT, int W, int LANES>
__global__ void stack_spmv_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x,
                                  T* __restrict__ y,
                                  int n_rows, int K, int d) {
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = (int)(gid % LANES);
    const long long item = gid / LANES;
    const int n_chunks = d / W;
    const bool live = item < (long long)n_rows * n_chunks;
    const int r = live ? (int)(item / n_chunks) : 0;
    const int j = live ? (int)(item - (long long)r * n_chunks) * W : 0;

    T acc[NOPS][W];
    const ColumnsOfX<T, W> xj{x + j, (size_t)d};
    row_sums<T, NOPS, ROUND, KT, W, LANES>(cols, vals, xj, n_rows, K, r,
                                           lane, acc);
    if (live && lane == 0) {
#pragma unroll
        for (int o = 0; o < NOPS; ++o)
            st_vec(y + ((size_t)o * n_rows + r) * d + j, acc[o]);
    }
}

// t1 + t2 + t3 + t4 - t5 + t6 + t7 + t8 with a1..a8 * b1..b8, left to right
template <typename T>
__device__ __forceinline__ T row_expr(T a1, T b1, T a2, T b2, T a3, T b3,
                                      T a4, T b4, T a5, T b5, T a6, T b6,
                                      T a7, T b7, T a8, T b8) {
    T s = add_rn(mul_rn(a1, b1), mul_rn(a2, b2));
    s = add_rn(s, mul_rn(a3, b3));
    s = add_rn(s, mul_rn(a4, b4));
    s = add_rn(s, -mul_rn(a5, b5));
    s = add_rn(s, mul_rn(a6, b6));
    s = add_rn(s, mul_rn(a7, b7));
    return add_rn(s, mul_rn(a8, b8));
}

// Row codes of diva_apply: 0 is a free row; on any other row bit 1 says
// that the u row is the 'infinite' form and bit 2 that the v row is
// (otherwise the identity). With a calving front, bit 3 marks a front row
// and bit 4 a row off the ice; off wins over front, front over the rest.
#define UF_ROW_INF_U 2
#define UF_ROW_INF_V 4
#define UF_ROW_FRONT 8
#define UF_ROW_OFF 16

// The ocean-pressure front row (solve_linearised_SSA_DIVA_ocean_pressure
// .f90:445-560, ufemism2_tpu/core/ice/ssadiva.py:218-231):
//   4 N nx dp/dx + N ny dp/dy + 2 N nx dq/dy + N ny dq/dx
// with (p, q, nx, ny) = (u, v, n_x, n_y) for Au and (v, u, n_y, n_x) for
// Av, each product formed left to right and the four added left to right,
// every operation rounded once, as the plain version's tensor operations.
template <typename T>
__device__ __forceinline__ T front_row(T Nr, T fx, T fy, T dpx, T dpy,
                                       T dqy, T dqx) {
    T s = add_rn(mul_rn(mul_rn(T(4) * Nr, fx), dpx),
                 mul_rn(mul_rn(Nr, fy), dpy));
    s = add_rn(s, mul_rn(mul_rn(T(2) * Nr, fx), dqy));
    return add_rn(s, mul_rn(mul_rn(Nr, fy), dqx));
}

// sum(x[nbrs]) - n * x over the up to three neighbour triangles (-1: none).
// The three are added as (x0 + x2) + x1, the order torch.sum takes over a
// last axis of three on the card, so that the row is the plain version's
// to the bit (chip_smoke.py holds the boundary rows to a difference of 0).
template <typename T>
__device__ __forceinline__ T nbr_residual(const T* __restrict__ x,
                                          const int* __restrict__ t, T xr) {
    T g[3];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int ti = __ldg(t + i);
        g[i] = T(0);
        if (ti >= 0) { g[i] = __ldg(x + ti); ++n; }
    }
    return add_rn(add_rn(add_rn(g[0], g[2]), g[1]), -mul_rn(T(n), xr));
}

// The operands u and v are two vectors (the two halves of the flat Krylov
// vector, or two tensors), gathered entry by entry; one group of LANES
// lanes per triangle row, ten sums in registers, Au and Av written once.
// FRONT: the operator has an ocean-pressure front (per-solve row codes and
// outward normals fx, fy), and its derivative sums are EXACT, so that every
// row equals the plain version's to the bit; without it the instance is
// the infinite-slab operator's instruction stream, unchanged.
template <typename T, bool ROUND, int KT, int LANES, bool FRONT>
__global__ void diva_apply_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ u,
                                  const T* __restrict__ v,
                                  const T* __restrict__ N,
                                  const T* __restrict__ dNx,
                                  const T* __restrict__ dNy,
                                  const T* __restrict__ beta,
                                  const int* __restrict__ tric,
                                  const unsigned char* __restrict__ code,
                                  const T* __restrict__ fx,
                                  const T* __restrict__ fy,
                                  T* __restrict__ Au, T* __restrict__ Av,
                                  int n_rows, int K) {
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = (int)(gid % LANES);
    const long long item = gid / LANES;
    const bool live = item < n_rows;
    const int r = live ? (int)item : 0;

    // [operator: ddx, ddy, dxx, dxy, dyy][0: of u, 1: of v]
    T dd[5][2];
    const PairUV<T> uv{u, v};
    row_sums<T, 5, ROUND, KT, 2, LANES, FRONT>(cols, vals, uv, n_rows, K, r,
                                               lane, dd);
    if (!live || lane != 0) return;

    const T ur = __ldg(u + r), vr = __ldg(v + r);
    const int cd = code[r];
    if (FRONT && (cd & UF_ROW_OFF)) {          // identity off the ice
        Au[r] = ur;
        Av[r] = vr;
        return;
    }
    if (FRONT && (cd & UF_ROW_FRONT)) {        // derivatives of rounded x
        const T Nr = __ldg(N + r), nxr = __ldg(fx + r), nyr = __ldg(fy + r);
        Au[r] = front_row<T>(Nr, nxr, nyr, dd[0][0], dd[1][0], dd[1][1],
                             dd[0][1]);
        Av[r] = front_row<T>(Nr, nyr, nxr, dd[1][1], dd[0][1], dd[0][0],
                             dd[1][0]);
        return;
    }
    if (cd == 0) {
        const T Nr = __ldg(N + r), nx = __ldg(dNx + r), ny = __ldg(dNy + r);
        const T be = __ldg(beta + r);
        const T ddx_u = dd[0][0], ddy_u = dd[1][0], dxx_u = dd[2][0],
                dxy_u = dd[3][0], dyy_u = dd[4][0];
        const T ddx_v = dd[0][1], ddy_v = dd[1][1], dxx_v = dd[2][1],
                dxy_v = dd[3][1], dyy_v = dd[4][1];
        // 4, 3 and 2 times a field are exact to one rounding
        Au[r] = row_expr<T>(T(4) * Nr, dxx_u, T(4) * nx, ddx_u, Nr, dyy_u,
                            ny, ddy_u, be, ur, T(3) * Nr, dxy_v,
                            T(2) * nx, ddy_v, ny, ddx_v);
        Av[r] = row_expr<T>(T(4) * Nr, dyy_v, T(4) * ny, ddy_v, Nr, dxx_v,
                            nx, ddx_v, be, vr, T(3) * Nr, dxy_u,
                            T(2) * ny, ddx_u, nx, ddy_u);
    } else {
        const int* t = tric + (size_t)r * 3;
        Au[r] = (cd & UF_ROW_INF_U) ? nbr_residual<T>(u, t, ur) : ur;
        Av[r] = (cd & UF_ROW_INF_V) ? nbr_residual<T>(v, t, vr) : vr;
    }
}

// ---------------------------------------------------------------------------
// Host side: pick the instance for (n_ops, K, d, alignment of x). What
// belongs to the operator comes in one descriptor that the caller fills
// once; a call passes its own pointers beside it.
// ---------------------------------------------------------------------------

// Lanes a row, from the times on the card (PERF.md): two lanes nearly halve
// the five-operator stack's time; on the single operators and on diva_apply
// they gain under a tenth, and one lane keeps the order of the sums - and
// with it, to the bit, the f32 trajectory of the model run (chip_smoke.py
// asserts its iteration counts) - of a plain loop over the entries of a row.
#define UF_LANES_STACK5 2
#define UF_LANES_SINGLE 1
#define UF_LANES_DIVA 1
#define UF_THREADS 128

struct StackDesc {          // mirrored by ops/cuda_spmv.py::_StackDesc
    const int* cols;        // [K, n_rows]
    const void* vals;       // [n_ops, K, n_rows]
    int n_ops, n_rows, K;
};

struct DivaDesc {           // mirrored by ops/cuda_spmv.py::_DivaDesc
    const int* cols;
    const void* vals;       // [5, K, n_rows]
    const void* N;          // [n_rows] each
    const void* dNx;
    const void* dNy;
    const void* beta;
    const int* tric;        // [n_rows, 3], -1: no neighbour
    const unsigned char* code;
    const void* fx;         // [n_rows] outward front normal; null: no front
    const void* fy;
    int n_rows, K, round_x_bf16;
};

static inline unsigned n_blocks(long long groups, int lanes) {
    return (unsigned)((groups * lanes + UF_THREADS - 1) / UF_THREADS);
}

template <typename T, int NOPS, bool ROUND, int KT, int W>
static int launch_spmv(const StackDesc& op, const T* x, T* y, int d,
                       cudaStream_t stream) {
    // the unrolled K = 10 rows are long enough to share; any other row
    // takes one lane
    constexpr int LANES =
        KT < 4 ? 1 : (NOPS == 5 ? UF_LANES_STACK5 : UF_LANES_SINGLE);
    const long long groups = (long long)op.n_rows * (d / W);
    stack_spmv_kernel<T, NOPS, ROUND, KT, W, LANES>
        <<<n_blocks(groups, LANES), UF_THREADS, 0, stream>>>(
            op.cols, static_cast<const T*>(op.vals), x, y, op.n_rows, op.K, d);
    return (int)cudaGetLastError();
}

template <typename T, int NOPS, bool ROUND, int W>
static int launch_spmv_k(const StackDesc& op, const T* x, T* y, int d,
                         cudaStream_t stream) {
    switch (op.K) {
        case 3: return launch_spmv<T, NOPS, ROUND, 3, W>(op, x, y, d, stream);
        case 10: return launch_spmv<T, NOPS, ROUND, 10, W>(op, x, y, d, stream);
        default: return launch_spmv<T, NOPS, ROUND, 0, W>(op, x, y, d, stream);
    }
}

template <typename T, bool ROUND>
static int stack_spmv(const StackDesc& op, const T* x, T* y, int d,
                      cudaStream_t stream) {
    if ((long long)op.n_rows * d == 0) return 0;
    // widest vector of x columns, at most 16 bytes, that divides d and
    // that x and y are aligned for
    constexpr int WMAX = 16 / (int)sizeof(T);
    int W = 1;
    for (int w = WMAX; w > 1; w >>= 1)
        if (d % w == 0 && (uintptr_t)x % (w * sizeof(T)) == 0
            && (uintptr_t)y % (w * sizeof(T)) == 0) { W = w; break; }
#define UF_W(NOPS, WW)                                                      \
    return launch_spmv_k<T, NOPS, ROUND, WW>(op, x, y, d, stream)
    if (op.n_ops == 1) {
        if (W == 4) UF_W(1, WMAX);         // 4 only where WMAX is
        if (W >= 2) UF_W(1, 2);
        UF_W(1, 1);
    }
    if (op.n_ops == 5) {
        if (W >= 2) UF_W(5, 2);
        UF_W(5, 1);
    }
#undef UF_W
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool ROUND>
static int diva_apply(const DivaDesc& op, const T* u, const T* v, T* Au,
                      T* Av, cudaStream_t stream) {
    if (op.n_rows == 0) return 0;
#define UF_GO(KT, L, F)                                                     \
    diva_apply_kernel<T, ROUND, KT, L, F>                                   \
        <<<n_blocks(op.n_rows, L), UF_THREADS, 0, stream>>>(                \
            op.cols, static_cast<const T*>(op.vals), u, v,                  \
            static_cast<const T*>(op.N), static_cast<const T*>(op.dNx),     \
            static_cast<const T*>(op.dNy), static_cast<const T*>(op.beta),  \
            op.tric, op.code, static_cast<const T*>(op.fx),                 \
            static_cast<const T*>(op.fy), Au, Av, op.n_rows, op.K)
    const bool front = op.fx != nullptr;
    if (op.K == 10) {
        if (front) { UF_GO(10, UF_LANES_DIVA, true); }
        else { UF_GO(10, UF_LANES_DIVA, false); }
    } else {
        if (front) { UF_GO(0, 1, true); }
        else { UF_GO(0, 1, false); }
    }
#undef UF_GO
    return (int)cudaGetLastError();
}

extern "C" int stack_spmv_f32(const StackDesc* op, const float* x, float* y,
                              int d, int round_x_bf16, void* stream) {
    if (round_x_bf16)
        return stack_spmv<float, true>(*op, x, y, d, (cudaStream_t)stream);
    return stack_spmv<float, false>(*op, x, y, d, (cudaStream_t)stream);
}

extern "C" int stack_spmv_f64(const StackDesc* op, const double* x, double* y,
                              int d, int round_x_bf16, void* stream) {
    if (round_x_bf16) return (int)cudaErrorInvalidValue;
    return stack_spmv<double, false>(*op, x, y, d, (cudaStream_t)stream);
}

extern "C" int diva_apply_f32(const DivaDesc* op, const float* u,
                              const float* v, float* Au, float* Av,
                              void* stream) {
    if (op->round_x_bf16)
        return diva_apply<float, true>(*op, u, v, Au, Av,
                                       (cudaStream_t)stream);
    return diva_apply<float, false>(*op, u, v, Au, Av, (cudaStream_t)stream);
}

extern "C" int diva_apply_f64(const DivaDesc* op, const double* u,
                              const double* v, double* Au, double* Av,
                              void* stream) {
    if (op->round_x_bf16) return (int)cudaErrorInvalidValue;
    return diva_apply<double, false>(*op, u, v, Au, Av, (cudaStream_t)stream);
}
