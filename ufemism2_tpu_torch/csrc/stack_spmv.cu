// Stack SpMV for sm_90a: y[o, r, j] = sum_k vals[o, k, r] * x[cols[k, r], j]
// for n_ops operators that share one sparsity pattern (padded ELL).
//
// Replaces the Pallas kernel ufemism2_tpu/ops/pallas_spmv.py::_group_kernel
// (launched by grouped_apply_pallas): the five-operator b-grid derivative
// stack that the SSA/DIVA operator applies once per Krylov iteration, and,
// with n_ops = 1, every single-operator mesh apply.
//
// Bound: bytes. At the MISMIP 8 km size (27.3k rows, ~10 entries a row,
// 5 operators, d = 2, f32) one call moves about 8 MB - 5.5 MB of
// coefficients, 1.1 MB of indices, 0.2 MB of x, 1.1 MB of y - which the
// card's 3.35 TB/s could stream in about 2.4 us; the arithmetic (5.4 MFLOP)
// is three orders of magnitude below the f32 peak. All of it fits the
// 50 MB L2, so repeated applies inside a Krylov solve never reach HBM and a
// kernel launch costs more than the data movement.
//
// What the layout does about it: the index table is shared by all
// operators (read once for n_ops products) and both tables are stored
// entry-major ([K, n_rows] / [n_ops, K, n_rows]), so the threads of a warp,
// which handle neighbouring rows, read neighbouring addresses. The tile
// slab, the row-block buckets and the bf16 (hi, lo) coefficient split of
// the TPU kernel answer to that machine's slow element gathers and its bf16
// matrix unit; none of it is carried over - coefficients are plain f32/f64.
//
// One thread per (row, column of x); a loop over the K entries of the row
// with n_ops accumulators in registers. No shared memory. Instantiated for
// the operator counts the model uses: n_ops = 1 and n_ops = 5.
//
// ROUND (f32 only) rounds the gathered x operand to bfloat16 (round to
// nearest even) and back, reproducing the reference's default f32 matvec
// arithmetic, in which the x side is rounded and the coefficients are not.

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

template <typename T, int NOPS, bool ROUND>
__global__ void stack_spmv_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x,
                                  T* __restrict__ y,
                                  int n_rows, int K, int d) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)n_rows * d;
    if (idx >= total) return;
    const int r = (int)(idx / d);
    const int j = (int)(idx - (long long)r * d);

    T acc[NOPS];
#pragma unroll
    for (int o = 0; o < NOPS; ++o) acc[o] = T(0);

    for (int k = 0; k < K; ++k) {
        const long long e = (long long)k * n_rows + r;
        const int c = cols[e];
        T xv = x[(long long)c * d + j];
        if (ROUND) xv = round_bf16<T>(xv);
#pragma unroll
        for (int o = 0; o < NOPS; ++o)
            acc[o] += vals[(long long)o * K * n_rows + e] * xv;
    }
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
        y[((long long)o * n_rows + r) * d + j] = acc[o];
}

template <typename T, bool ROUND>
static int launch(const int* cols, const T* vals, const T* x, T* y,
                  int n_ops, int n_rows, int K, int d, cudaStream_t stream) {
    const long long total = (long long)n_rows * d;
    if (total == 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
#define UF_CASE(N)                                                          \
    case N:                                                                 \
        stack_spmv_kernel<T, N, ROUND><<<blocks, threads, 0, stream>>>(     \
            cols, vals, x, y, n_rows, K, d);                                \
        break;
    switch (n_ops) {
        UF_CASE(1) UF_CASE(5)
        default: return (int)cudaErrorInvalidValue;
    }
#undef UF_CASE
    return (int)cudaGetLastError();
}

extern "C" int stack_spmv_f32(const int* cols, const float* vals,
                              const float* x, float* y, int n_ops,
                              int n_rows, int K, int d, int round_x_bf16,
                              void* stream) {
    if (round_x_bf16)
        return launch<float, true>(cols, vals, x, y, n_ops, n_rows, K, d,
                                   (cudaStream_t)stream);
    return launch<float, false>(cols, vals, x, y, n_ops, n_rows, K, d,
                                (cudaStream_t)stream);
}

extern "C" int stack_spmv_f64(const int* cols, const double* vals,
                              const double* x, double* y, int n_ops,
                              int n_rows, int K, int d, void* stream) {
    return launch<double, false>(cols, vals, x, y, n_ops, n_rows, K, d,
                                 (cudaStream_t)stream);
}
