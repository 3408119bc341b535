// The BPA operator and the vertical-line preconditioner, for sm_90a.
//
//   bpa_apply:   (Au, Av)[r, k] of the Blatter-Pattyn momentum operator on
//                the 3-D velocities (u, v) [n_rows, nz] (row-major: the
//                layers of a triangle are neighbours), in two launches:
//                the first derivatives ux, uy, vx, vy into a scratch
//                [4, n_rows, nz], then every row of the operator (interior
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
// PyTorch would run them as some 230 and 260 launches; on this card the
// launch, not the byte, is the unit of cost at these sizes.
//
// Bound: bytes. One apply at the ISMIP-HOM L = 20 km mesh (12.8k rows,
// nz 12, ~10 stencil entries a row, f32) reads about 13 MB once - the
// index table and two coefficient tables, u and v, six [n, nz]
// coefficient fields, eleven [n] fields - and writes Au, Av (1.2 MB); the
// arithmetic (some 250 operations a row and layer, 40 MFLOP) is far
// below the f32 peak. The scratch of the first derivatives (2.5 MB) and
// the gathers stay in the 50 MB L2.
//
// What the design does about it:
// - One thread per (row, layer), the layer fastest: the threads of a warp
//   read the layers of a few rows, so the gathers of a stencil entry
//   (x[c, k] for neighbouring k) and the row's own fields are read in
//   whole sectors; the zeta differences read the neighbouring layers the
//   warp has just loaded.
// - The second derivatives need the neighbours' first derivatives, so the
//   work splits there: pass 1 writes ux, uy, vx, vy, pass 2 gathers them.
//   Pass 2 reads each stencil entry's index and two coefficients once for
//   its six sums (ddx and ddy of ux, ddy of uy, ddx and ddy of vx, ddy of
//   vy; both cross terms are d/dy of an x-derivative, as in bpa.py).
// - The ELL width (10 on the meshes of chip_smoke.py) and nz 12 are
//   template parameters: unrolled stencil loop, constant index
//   arithmetic. Any other width, and any nz from 3 to 64, runs at run
//   time.
// - What changes once per viscosity iteration is formed by the caller:
//   dzeta/dz and its square, dzeta / dzeta/dz of the surface row, the
//   base row's Q, R and beta / eta_base. The kernel divides only by the
//   zeta spacing, as the plain version does.
//
// Every product, sum and quotient is rounded once, in the order of the
// plain version's tensor operations (ops/cuda_bpa.py bpa_apply_plain,
// line_thomas_plain), never contracted into a fused multiply-add: the
// f32 GMRES solves end at their precision floor, where the iteration
// counts follow the operator's last bit, so the kernels are held to their
// plain versions to the bit (chip_smoke.py).
//
// ROUND (f32 only) rounds the gathered operand of a stencil sum to
// bfloat16 (round to nearest even) and back, as the reference's f32
// matvec rounds its x: u and v in pass 1, the first derivatives in pass 2.
// The zeta differences and the boundary rows use the values as they are.
//
// line_thomas: one thread per column, both right-hand sides; the forward
// sweep forms each pivot once for the two. Its bound is bytes too (the
// three bands and the two right-hand sides read once, the two solutions
// written once: 3.7 MB at 12.8k columns of 12, f32), the sweep a chain of
// dependent divisions that the SMs' many columns hide.

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

#define UF_ROW_INF_U 2     // row codes of ops/cuda_spmv.py DivaRows
#define UF_ROW_INF_V 4
#define UF_THREADS 128
#define UF_NZ_MAX 64       // layers of a column at most
#define UF_K_MAX 64        // stencil entries of a row at most

// The pivot clamp of thomas_batched, |d| < 1e-300 -> 1e-300, in the
// plain version's type: 1e-300 is 0 in f32, where the clamp never acts.
template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() {
    return 0.0f;
}
template <> __device__ __forceinline__ double tiny_pivot<double>() {
    return 1e-300;
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
    void* scratch;          // [4, n_rows, nz]: ux, uy, vx, vy
    double dzeta, two_dzeta, dzeta_sq;
    int n_rows, K, nz, round_x_bf16, no_sliding;
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
    T dz, two_dz, dz2;
    int n, K, nz;
};

// d/dzeta at layer k of the column col[0 .. nz-1]: central inside,
// one-sided at the ends (bpa.py:114-120)
template <typename T>
__device__ __forceinline__ T ddzeta(const T* col, int k, int nz, T dz,
                                    T two_dz) {
    if (k == 0) return div_rn(sub_rn(col[1], col[0]), dz);
    if (k == nz - 1) return div_rn(sub_rn(col[nz - 1], col[nz - 2]), dz);
    return div_rn(sub_rn(col[k + 1], col[k - 1]), two_dz);
}

// sum over slots 0, 1, 2 of x[neighbour, k] (0 where there is none),
// minus n_neighbours * x[r, k]
template <typename T>
__device__ __forceinline__ T nbr_residual(const T* __restrict__ x,
                                          const int* __restrict__ t, int k,
                                          int nz, T xr) {
    T g[3];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int ti = __ldg(t + i);
        g[i] = T(0);
        if (ti >= 0) { g[i] = __ldg(x + (size_t)ti * nz + k); ++n; }
    }
    return sub_rn(add_rn(add_rn(g[0], g[1]), g[2]), mul_rn(T(n), xr));
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

// Pass 1: ux, uy, vx, vy at (r, k) = stencil sums of the (rounded) u, v
// at layer k over the entries in turn from 0, plus dzeta/dx(y) times the
// zeta difference.
template <typename T, bool ROUND, int KT, int NZ>
__global__ void bpa_first_kernel(Fields<T> f, const T* __restrict__ u,
                                 const T* __restrict__ v) {
    const int nz = NZ > 0 ? NZ : f.nz;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)f.n * nz) return;
    const int r = (int)(gid / nz);
    const int k = (int)(gid - (long long)r * nz);
    const int n = f.n;
    const int K = KT > 0 ? KT : f.K;
    const T* vx_ = f.vals;
    const T* vy_ = f.vals + (size_t)K * n;
    T sxu = T(0), syu = T(0), sxv = T(0), syv = T(0);
#pragma unroll
    for (int e = 0; e < (KT > 0 ? KT : UF_K_MAX); ++e) {
        if (KT == 0 && e >= K) break;
        const size_t ek = (size_t)e * n + r;
        const int c = __ldg(f.cols + ek);
        const T ax = __ldg(vx_ + ek), ay = __ldg(vy_ + ek);
        T xu = __ldg(u + (size_t)c * nz + k);
        T xv = __ldg(v + (size_t)c * nz + k);
        if (ROUND) { xu = round_bf16<T>(xu); xv = round_bf16<T>(xv); }
        sxu = add_rn(sxu, mul_rn(ax, xu));
        syu = add_rn(syu, mul_rn(ay, xu));
        sxv = add_rn(sxv, mul_rn(ax, xv));
        syv = add_rn(syv, mul_rn(ay, xv));
    }
    const size_t i = (size_t)r * nz + k;
    const T zx = __ldg(f.zx + i), zy = __ldg(f.zy + i);
    const T du = ddzeta<T>(u + (size_t)r * nz, k, nz, f.dz, f.two_dz);
    const T dv = ddzeta<T>(v + (size_t)r * nz, k, nz, f.dz, f.two_dz);
    const size_t m = (size_t)n * nz;
    f.d1[i] = add_rn(sxu, mul_rn(zx, du));
    f.d1[m + i] = add_rn(syu, mul_rn(zy, du));
    f.d1[2 * m + i] = add_rn(sxv, mul_rn(zx, dv));
    f.d1[3 * m + i] = add_rn(syv, mul_rn(zy, dv));
}

// Pass 2: the operator's rows at (r, k).
template <typename T, bool ROUND, int KT, int NZ>
__global__ void bpa_rows_kernel(Fields<T> f, const T* __restrict__ u,
                                const T* __restrict__ v, T* __restrict__ Au,
                                T* __restrict__ Av, int no_sliding) {
    const int nz = NZ > 0 ? NZ : f.nz;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)f.n * nz) return;
    const int r = (int)(gid / nz);
    const int k = (int)(gid - (long long)r * nz);
    const int n = f.n;
    const size_t i = (size_t)r * nz + k;
    const T* uc = u + (size_t)r * nz;      // the row's columns
    const T* vc = v + (size_t)r * nz;

    const int cd = f.code[r];
    if (cd != 0) {                          // lateral rows, whole column
        const int* t = f.tric + (size_t)r * 3;
        const T ur = __ldg(uc + k), vr = __ldg(vc + k);
        Au[i] = (cd & UF_ROW_INF_U) ? nbr_residual<T>(u, t, k, nz, ur) : ur;
        Av[i] = (cd & UF_ROW_INF_V) ? nbr_residual<T>(v, t, k, nz, vr) : vr;
        return;
    }
    const int kb = nz - 1;
    if (no_sliding && k == kb) {            // no-slip base: u = v = 0
        Au[i] = __ldg(uc + kb);
        Av[i] = __ldg(vc + kb);
        return;
    }

    const size_t m = (size_t)n * nz;
    const T* d_ux = f.d1;
    const T* d_uy = f.d1 + m;
    const T* d_vx = f.d1 + 2 * m;
    const T* d_vy = f.d1 + 3 * m;
    const int K = KT > 0 ? KT : f.K;
    const T* vx_ = f.vals;
    const T* vy_ = f.vals + (size_t)K * n;
    T s_xxu = T(0), s_xyu = T(0), s_yyu = T(0);
    T s_xxv = T(0), s_xyv = T(0), s_yyv = T(0);
#pragma unroll
    for (int e = 0; e < (KT > 0 ? KT : UF_K_MAX); ++e) {
        if (KT == 0 && e >= K) break;
        const size_t ek = (size_t)e * n + r;
        const int c = __ldg(f.cols + ek);
        const T ax = __ldg(vx_ + ek), ay = __ldg(vy_ + ek);
        const size_t ck = (size_t)c * nz + k;
        T gux = d_ux[ck], guy = d_uy[ck], gvx = d_vx[ck], gvy = d_vy[ck];
        if (ROUND) {
            gux = round_bf16<T>(gux); guy = round_bf16<T>(guy);
            gvx = round_bf16<T>(gvx); gvy = round_bf16<T>(gvy);
        }
        s_xxu = add_rn(s_xxu, mul_rn(ax, gux));
        s_xyu = add_rn(s_xyu, mul_rn(ay, gux));
        s_yyu = add_rn(s_yyu, mul_rn(ay, guy));
        s_xxv = add_rn(s_xxv, mul_rn(ax, gvx));
        s_xyv = add_rn(s_xyv, mul_rn(ay, gvx));
        s_yyv = add_rn(s_yyv, mul_rn(ay, gvy));
    }
    const size_t rc = (size_t)r * nz;
    const T zx = __ldg(f.zx + i), zy = __ldg(f.zy + i);
    const T dux = ddzeta<T>(d_ux + rc, k, nz, f.dz, f.two_dz);
    const T duy = ddzeta<T>(d_uy + rc, k, nz, f.dz, f.two_dz);
    const T dvx = ddzeta<T>(d_vx + rc, k, nz, f.dz, f.two_dz);
    const T dvy = ddzeta<T>(d_vy + rc, k, nz, f.dz, f.two_dz);
    const T uxx = add_rn(s_xxu, mul_rn(zx, dux));
    const T uxy = add_rn(s_xyu, mul_rn(zy, dux));
    const T uyy = add_rn(s_yyu, mul_rn(zy, duy));
    const T vxx = add_rn(s_xxv, mul_rn(zx, dvx));
    const T vxy = add_rn(s_xyv, mul_rn(zy, dvx));
    const T vyy = add_rn(s_yyv, mul_rn(zy, dvy));
    const T ux = d_ux[i], uy = d_uy[i], vx = d_vx[i], vy = d_vy[i];

    const T e = __ldg(f.eta + i), ex = __ldg(f.eta_x + i);
    const T ey = __ldg(f.eta_y + i), ez = __ldg(f.eta_z + i);
    // 4, 2 times a field are exact; 3 times one is rounded once
    const T e4 = mul_rn(T(4), e), e3 = mul_rn(T(3), e);
    const T ex4 = mul_rn(T(4), ex), ex2 = mul_rn(T(2), ex);
    const T ey4 = mul_rn(T(4), ey), ey2 = mul_rn(T(2), ey);
    const T two = T(2);
    T au, av;
    if (k == 0) {
        // surface: zero stress, the ghost point eliminated (bpa.py:226-248)
        const T dhx = __ldg(f.dh_dx + r), dhy = __ldg(f.dh_dy + r);
        const T Su = add_rn(mul_rn(mul_rn(two, dhx),
                                   add_rn(mul_rn(two, ux), vy)),
                            mul_rn(dhy, add_rn(uy, vx)));
        const T Sv = add_rn(mul_rn(mul_rn(two, dhy),
                                   add_rn(mul_rn(two, vy), ux)),
                            mul_rn(dhx, add_rn(vx, uy)));
        const T q = __ldg(f.qfac + r), dzz = __ldg(f.dzz + r);
        const T uzz0 = mul_rn(q, sub_rn(sub_rn(__ldg(uc + 1), __ldg(uc)),
                                        mul_rn(dzz, Su)));
        const T vzz0 = mul_rn(q, sub_rn(sub_rn(__ldg(vc + 1), __ldg(vc)),
                                        mul_rn(dzz, Sv)));
        au = sum9(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                  mul_rn(ey, uy), mul_rn(e, uzz0), mul_rn(ez, Su),
                  mul_rn(e3, vxy), mul_rn(ex2, vy), mul_rn(ey, vx));
        av = sum9(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                  mul_rn(ex, vx), mul_rn(e, vzz0), mul_rn(ez, Sv),
                  mul_rn(e3, uxy), mul_rn(ey2, ux), mul_rn(ex, uy));
    } else if (k == kb) {
        // base: sliding (bpa.py:250-282)
        const T dbx = __ldg(f.db_dx + r), dby = __ldg(f.db_dy + r);
        const T rat = __ldg(f.ratio + r);
        const T ub = __ldg(uc + kb), vb = __ldg(vc + kb);
        const T Pu = add_rn(add_rn(mul_rn(mul_rn(two, dbx),
                                          add_rn(mul_rn(two, ux), vy)),
                                   mul_rn(dby, add_rn(uy, vx))),
                            mul_rn(rat, ub));
        const T Pv = add_rn(add_rn(mul_rn(mul_rn(two, dby),
                                          add_rn(mul_rn(two, vy), ux)),
                                   mul_rn(dbx, add_rn(vx, uy))),
                            mul_rn(rat, vb));
        const T qb = __ldg(f.qb + r), rb = __ldg(f.rb + r);
        au = sum7(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                  mul_rn(ey, uy), mul_rn(e3, vxy), mul_rn(ex2, vy),
                  mul_rn(ey, vx));
        au = add_rn(au, mul_rn(qb, sub_rn(__ldg(uc + kb - 1), ub)));
        au = add_rn(au, mul_rn(rb, Pu));
        av = sum7(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                  mul_rn(ex, vx), mul_rn(e3, uxy), mul_rn(ey2, ux),
                  mul_rn(ex, uy));
        av = add_rn(av, mul_rn(qb, sub_rn(__ldg(vc + kb - 1), vb)));
        av = add_rn(av, mul_rn(rb, Pv));
    } else {
        const T zz = __ldg(f.zz + r), zz2 = __ldg(f.zz2 + r);
        const T uz = mul_rn(zz, ddzeta<T>(uc, k, nz, f.dz, f.two_dz));
        const T vz = mul_rn(zz, ddzeta<T>(vc, k, nz, f.dz, f.two_dz));
        const T uk = __ldg(uc + k), vk = __ldg(vc + k);
        const T uzz = mul_rn(zz2, div_rn(sub_rn(add_rn(__ldg(uc + k + 1),
                                                       __ldg(uc + k - 1)),
                                                mul_rn(two, uk)), f.dz2));
        const T vzz = mul_rn(zz2, div_rn(sub_rn(add_rn(__ldg(vc + k + 1),
                                                       __ldg(vc + k - 1)),
                                                mul_rn(two, vk)), f.dz2));
        au = sum9(mul_rn(e4, uxx), mul_rn(ex4, ux), mul_rn(e, uyy),
                  mul_rn(ey, uy), mul_rn(e, uzz), mul_rn(ez, uz),
                  mul_rn(e3, vxy), mul_rn(ex2, vy), mul_rn(ey, vx));
        av = sum9(mul_rn(e4, vyy), mul_rn(ey4, vy), mul_rn(e, vxx),
                  mul_rn(ex, vx), mul_rn(e, vzz), mul_rn(ez, vz),
                  mul_rn(e3, uxy), mul_rn(ey2, ux), mul_rn(ex, uy));
    }
    Au[i] = au;
    Av[i] = av;
}

// One column a thread, both right-hand sides: the recurrence of
// ops/tridiag.py thomas_batched (pivots below 1e-300 in magnitude clamped
// to 1e-300; in f32 that constant is 0 and the clamp never acts, as in
// the plain version).
template <typename T, int NZ>
__global__ void line_thomas_kernel(const T* __restrict__ sub,
                                   const T* __restrict__ dia,
                                   const T* __restrict__ sup,
                                   const T* __restrict__ ru,
                                   const T* __restrict__ rv,
                                   T* __restrict__ xu, T* __restrict__ xv,
                                   int n, int nz_rt) {
    constexpr int M = NZ > 0 ? NZ : UF_NZ_MAX;
    const int nz = NZ > 0 ? NZ : nz_rt;
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const T* sb = sub + (size_t)r * (nz - 1);
    const T* sp = sup + (size_t)r * (nz - 1);
    const T* dg = dia + (size_t)r * nz;
    const T* bu = ru + (size_t)r * nz;
    const T* bv = rv + (size_t)r * nz;
    T cp[M], du[M], dv[M];
    T c_prev = T(0), du_prev = T(0), dv_prev = T(0);
    const T tiny = tiny_pivot<T>();
#pragma unroll
    for (int k = 0; k < M; ++k) {
        if (NZ == 0 && k >= nz) break;
        const T lk = k == 0 ? T(0) : __ldg(sb + k - 1);
        const T uk = k == nz - 1 ? T(0) : __ldg(sp + k);
        T den = sub_rn(__ldg(dg + k), mul_rn(lk, c_prev));
        if (abs_of(den) < tiny) den = tiny;
        c_prev = div_rn(uk, den);
        du_prev = div_rn(sub_rn(__ldg(bu + k), mul_rn(lk, du_prev)), den);
        dv_prev = div_rn(sub_rn(__ldg(bv + k), mul_rn(lk, dv_prev)), den);
        cp[k] = c_prev;
        du[k] = du_prev;
        dv[k] = dv_prev;
    }
    T xnu = T(0), xnv = T(0);
    T* ou = xu + (size_t)r * nz;
    T* ov = xv + (size_t)r * nz;
#pragma unroll
    for (int j = 0; j < M; ++j) {
        const int k = (NZ > 0 ? NZ : nz) - 1 - j;
        if (NZ == 0 && k < 0) break;
        xnu = sub_rn(du[k], mul_rn(cp[k], xnu));
        xnv = sub_rn(dv[k], mul_rn(cp[k], xnv));
        ou[k] = xnu;
        ov[k] = xnv;
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

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
    f.dz = T(d.dzeta);
    f.two_dz = T(d.two_dzeta);
    f.dz2 = T(d.dzeta_sq);
    f.n = d.n_rows;
    f.K = d.K;
    f.nz = d.nz;
    return f;
}

template <typename T, bool ROUND, int KT, int NZ>
static int launch_bpa(const Fields<T>& f, const T* u, const T* v, T* Au,
                      T* Av, int no_sliding, cudaStream_t stream) {
    const long long items = (long long)f.n * f.nz;
    const unsigned blocks = (unsigned)((items + UF_THREADS - 1) / UF_THREADS);
    bpa_first_kernel<T, ROUND, KT, NZ><<<blocks, UF_THREADS, 0, stream>>>(
        f, u, v);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    bpa_rows_kernel<T, ROUND, KT, NZ><<<blocks, UF_THREADS, 0, stream>>>(
        f, u, v, Au, Av, no_sliding);
    return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
static int bpa_apply(const BpaDesc& d, const T* u, const T* v, T* Au, T* Av,
                     cudaStream_t stream) {
    if ((long long)d.n_rows * d.nz == 0) return 0;
    if (d.nz < 3 || d.nz > UF_NZ_MAX || d.K < 1 || d.K > UF_K_MAX)
        return (int)cudaErrorInvalidValue;
    const Fields<T> f = fields_of<T>(d);
    const int ns = d.no_sliding;
    if (d.K == 10 && d.nz == 12)
        return launch_bpa<T, ROUND, 10, 12>(f, u, v, Au, Av, ns, stream);
    if (d.K == 10) return launch_bpa<T, ROUND, 10, 0>(f, u, v, Au, Av, ns,
                                                      stream);
    if (d.nz == 12) return launch_bpa<T, ROUND, 0, 12>(f, u, v, Au, Av, ns,
                                                       stream);
    return launch_bpa<T, ROUND, 0, 0>(f, u, v, Au, Av, ns, stream);
}

template <typename T>
static int line_thomas(const ThomasDesc& d, const T* ru, const T* rv, T* xu,
                       T* xv, cudaStream_t stream) {
    if (d.n_rows == 0) return 0;
    if (d.nz < 3 || d.nz > UF_NZ_MAX) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((d.n_rows + UF_THREADS - 1)
                                       / UF_THREADS);
    const T* sub = static_cast<const T*>(d.sub);
    const T* dia = static_cast<const T*>(d.dia);
    const T* sup = static_cast<const T*>(d.sup);
    if (d.nz == 12)
        line_thomas_kernel<T, 12><<<blocks, UF_THREADS, 0, stream>>>(
            sub, dia, sup, ru, rv, xu, xv, d.n_rows, d.nz);
    else
        line_thomas_kernel<T, 0><<<blocks, UF_THREADS, 0, stream>>>(
            sub, dia, sup, ru, rv, xu, xv, d.n_rows, d.nz);
    return (int)cudaGetLastError();
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
