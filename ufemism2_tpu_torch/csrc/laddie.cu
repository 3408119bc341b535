// laddie_stage and laddie_leg: the LADDIE plume's pseudo-time integration,
// for sm_90a.
//
// A stage computes what the JAX package's make_laddie_step `stage`
// computes (ufemism2_tpu/models/laddie.py:373-470: compute_H_npx,
// compute_UV_npx and compute_TS_npx of the reference's
// laddie_integration.f90), for the scheme's (old, ref) states, and the
// scheme's update after it: the fbrk3 beta-blend of the thickness, or the
// lfra Robert-Asselin filter. It replaces XLA-lowered code, not a Pallas
// kernel: the JAX package runs a whole leg as one jitted lax.fori_loop.
// A stage is two passes over the rows:
//
//   - the vertex pass, one thread a vertex: U_a, V_a through the rows of
//     M_map_b_a; u*, the gammas, the melt, T_base; the ambient T and S by
//     a bisection over z_ocean in shared memory; the buoyancy and the
//     entrainment; the upwind thickness divergence and the two tracer
//     divergences over the Voronoi neighbours, with the c-grid velocity of
//     each edge from its (one or two) triangles as map_b_to_c forms it;
//     the corrected entr, entr_dmin and detr; H, T and S of the stage, the
//     blended H, the filtered H, T and S; the masked physics fields (ph)
//     and detr for the triangle pass.
//   - the triangle pass, one thread a triangle: the masked a->b means of
//     H_new, H_ref, H_old and H*drho (and of H_ref at the three neighbour
//     triangles), the a->c means at its three edges; detr_b, the drho and
//     H gradients through the rows of M_map_a_b and M_ddx/ddy_a_b; the
//     pressure gradient with its edge-triangle form; the upstream momentum
//     advection over TriC and TriE; the viscosity in the stages that have
//     it; Coriolis and drag; U and V of the stage with the speed limit;
//     the filtered U and V.
//
// Two entries run them. `laddie_stage` is one stage in two launches (a
// single step: the standalone program's diagnostic step, the tests).
// `laddie_leg` runs a whole leg of n pseudo-steps in one cooperative
// launch: each stage is the vertex pass over the rows (grid-stride), a
// grid barrier, the triangle pass, a grid barrier. The grid is the
// co-resident maximum of blocks, cut to the blocks the rows need, so that
// a barrier waits for no idle block. The states live in four buffer sets
// allocated once a leg and rotated (leg_stage below): fbrk3 writes np13
// and np12 into two fixed sets and np1 into the other of a ping-pong pair
// from `now`, which stays whole until the step's third stage has read it;
// euler ping-pongs; lfra writes (np1, filtered) into one pair while it
// reads (now, nm1) from the other.
//
// Bound: a stage moves a few hundred kB on the compact shelf meshes of the
// model's path (512-768 rows), well under a microsecond at 3.35 TB/s, and
// tens of MB at 2 km. It is bound by the latency of each row's chain of
// dependent loads and of the divisions and square roots on it, and, in
// the leg, by the two grid barriers a stage. The design cuts the chains:
//   - A row takes L lanes: a whole warp when the rows at 32 lanes all fit
//     in one co-resident wave (the compact shelf meshes), else one (at 2
//     km, where the card is full and lanes would only repeat each row's
//     arithmetic). Lane l gathers and forms the terms of entries l,
//     l + L, ... of each ELL row and Voronoi cell (of neighbour l in the
//     triangle pass), with indices past the row clamped to its last so
//     that every load issues at once, and every lane adds them k = 0, 1,
//     ... in turn from the lanes that hold them (__shfl_sync); the rest
//     of the row is formed by every lane alike and stored by the first.
//   - An ELL row adds only its stored entries one by one (a table of each
//     row's count, built once a mesh): its padding is column 0 and value
//     +0, every padding product is the same +-0 or NaN, and adding one
//     more of them leaves the sum as it was, so one addition stands for
//     all. This matters on the compact meshes, whose padded columns (the
//     pad rows repeat row 0) make rows of up to 174 entries where most
//     have 3 to 10. A row of more than 12 entries (288 with 32 lanes)
//     takes the run-time form.
//   - Rows that share columns load them once (U_a and V_a; d/dx and d/dy
//     of drho and of H); tables built once a mesh give each connection's
//     and each neighbour's triangles and vertices directly (VET, TriET,
//     TriEV, TriCV), which cuts the chains VE -> ETri -> U, TriE -> ETri
//     -> U, TriE -> EV -> a, H and TriC -> Tri -> a, H to two loads each.
//   - The edge means divide by a count of 1 or 2 as a product with its
//     exact reciprocal (the same rounding); the depth search bisects
//     z_ocean in shared memory.
//   - Tables, masks and forcing go through the read-only path (__ldg). A
//     state, ph, detr or H_new is written inside a leg and is read only
//     by plain loads: a non-coherent load could return a line from before
//     the barrier. Every row stores only after its last load.
// tools/laddie_kernel_variants.py times the alternatives (fewer lanes, the
// divided edge means, plain loads) and probes that drop a part.
//
// The pad rows of the compact shelf mesh (copies of row 0 with -1
// connectivity) are computed like every other row; the caller drops them.
//
// Rounding contract: the result equals the plain version
// (ops/cuda_laddie.py laddie_stage_plain, run on the card) to the bit, in
// both entries. Every operation is rounded as the plain version's tensor
// operation is - __f*_rn / __d*_rn, never a contracted multiply-add - in
// the same order: a Python scalar enters as its value rounded to T; a
// tensor divided by a Python scalar is multiplied by the reciprocal of the
// scalar rounded to T (the reciprocal formed on the host in T, as PyTorch
// forms it); a Python scalar divided by a tensor is the tensor's
// reciprocal times the scalar; x ** 2 and x ** 3 are products; clamp and
// where are PyTorch's (a NaN passes a clamp); the ELL rows and the
// neighbour sums are added k = 0, 1, ... in turn, as `_ell` and `_rsum`
// add them, the ELL operand rounded to bfloat16 in float32; the depth
// search is torch.searchsorted's (side left: a NaN depth gives 0). One
// operation is not an IEEE operation: log, in the Jenkins1991 gamma, is
// the CUDA math library's logf / log, as PyTorch's torch.log on the card
// calls it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define UF_LADDIE_THREADS 128
#define UF_LADDIE_MAX_ND 4096      // z_ocean levels in shared memory

// constants (LaddieParams and the stage's scalars), each already the value
// the plain version's tensor operation uses: see ops/cuda_laddie.py
// _constants, which fills them in this order
enum {
    K_CD_TOP, K_TIDAL2, K_GT, K_INV35,
    K_INV_NU0, K_EPS, K_212, K_KT, K_KS, K_868,
    K_L1, K_L2, K_L3, K_INV_L1,
    K_LF, K_CPI, K_CPO, K_CTIL, K_CHAT, K_CHAT_CTIL,
    K_FOUR, K_HALF, K_DTHR,
    K_BETA, K_ALPHA, K_DRHO_MIN, K_ENTR, K_HFLOOR, K_ENTR_MIN, K_DRHO_DEF,
    K_DEPTH_FLOOR,
    K_HMIN, K_HMAX, K_DT, K_INV_DT,
    K_GRAV, K_HALF_GRAV, K_NEG_GRAV, K_FCOR, K_CD_MOM, K_VISC, K_INV100,
    K_VMAX, K_SPEED_FLOOR,
    K_C1, K_C2, K_C3, K_HALF_NU, K_TWO,
    N_K
};

// a stage's own scalars, in the leg's descriptor (the rest of the
// constants are the same in every stage of a leg)
enum { SK_DT, SK_INV_DT, SK_C1, SK_C2, SK_C3, SK_HALF_NU, N_SK };

enum { PH_MELT, PH_ENTR, PH_DETR, PH_GAMMA_T, PH_GAMMA_S, PH_T_BASE,
       PH_T_AMB, PH_S_AMB, PH_DRHO_AMB, PH_HDRHO_AMB, N_PH };

enum { POST_NONE, POST_BLEND, POST_BLEND3, POST_LFRA };

enum { SCHEME_FBRK3, SCHEME_EULER, SCHEME_LFRA };

struct LaddieDesc {            // ops/cuda_laddie.py::_LaddieDesc
    // static tables of the mesh
    const int* C;              // [nV, Kc] neighbour vertex, -1 where none
    const int* VET;            // [nV, Kc, 2] the triangles of each
                               // connection's edge (of edge 0 where
                               // none), -1 where none
    const void* LcA;           // [nV, Kc] T  Cw / A
    const void* Dx_D;          // [nV, Kc] T  D_x / D
    const void* Dy_D;          // [nV, Kc] T  D_y / D
    const int* Tri;            // [nTri, 3]
    const int* TriC;           // [nTri, 3] -1 where none
    const int* TriET;          // [nTri, 3, 2] the triangles of each edge,
                               // -1 where none
    const int* TriEV;          // [nTri, 3, 2] the vertices of each edge
    const int* TriCV;          // [nTri, 3, 3] Tri of each neighbour (of 0
                               // where none)
    const void* TDx_D;         // [nTri, 3] T
    const void* TDy_D;         // [nTri, 3] T
    const void* TriD;          // [nTri, 3] T
    const void* TriCw;         // [nTri, 3] T
    const void* TriA;          // [nTri] T
    const void* nb_border;     // [nTri] T
    const int* ba_cols; const void* ba_vals;   // M_map_b_a [Kba, nV]
    const int* ab_cols; const void* ab_vals;   // M_map_a_b [Kab, nTri]
    const int* dx_cols; const void* dx_vals;   // M_ddx_a_b [Kdx, nTri]
    const int* dy_cols; const void* dy_vals;   // M_ddy_a_b [Kdy, nTri]
    // each ELL row's stored entries (at least 1); the rest of the row is
    // padding, column 0 and value +0
    const int *ba_len, *ab_len, *dx_len, *dy_len;
    // masks (bool)
    const uint8_t *a, *gr_a, *oc_a;            // [nV]
    const uint8_t *b, *gl_b, *cf_b;            // [nTri]
    // forcing
    const void *Hib, *Ti_base, *SGD;           // [nV] T
    const void *dHib_dx_b, *dHib_dy_b;         // [nTri] T
    const void *z_ocean;                       // [nd] T
    const void *T_ocean, *S_ocean;             // [nV, nd] T
    // states
    const void *oH, *oU, *oV, *oT, *oS;        // old
    const void *rH, *rU, *rV, *rT, *rS;        // ref
    const void *nowH;                          // the step's starting H
    // outputs
    void *Hn, *Hs, *Tn, *Sn, *detr, *ph;       // [nV], ph [N_PH, nV]
    void *Un, *Vn;                             // [nTri]
    void *fH, *fU, *fV, *fT, *fS;              // the lfra filter
    int nV, nTri, Kc, Kba, Kab, Kdx, Kdy, nd;
    int jenkins, use_Ti, visc, post;
    double k[N_K];
};

struct StatePtrs { void *H, *U, *V, *T, *S; };

struct LegDesc {               // ops/cuda_laddie.py::_LegDesc
    LaddieDesc d;              // tables, masks, forcing, the constants
    StatePtrs in;              // the leg's initial state (read only)
    StatePtrs buf[4];          // the rotated state sets
    void *Hn, *detr, *ph;      // a stage's scratch
    int n_steps, scheme, n_stages;
    int visc[3], post[3];      // each stage's
    double sk[3][N_SK];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float log_lib(float a) { return logf(a); }
__device__ __forceinline__ double log_lib(double a) { return log(a); }

// torch.clamp(x, min=lo) / clamp(x, max=hi): a NaN passes
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
    return isnan(x) ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) {
    return isnan(x) ? x : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T round_x(T v) { return v; }
template <>
__device__ __forceinline__ float round_x<float>(float v) {   // to bfloat16
    uint32_t u = __float_as_uint(v);
    if ((u & 0x7fffffffu) > 0x7f800000u) return v;
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
}

// a fixed table, mask or forcing field: the read-only path
template <typename X>
__device__ __forceinline__ X ro(const void* p, size_t i) {
    return __ldg((const X*)p + i);
}

// a row's L lanes and the slots each lane holds: an ELL row of up to L * J
// entries and a Voronoi cell of up to L * JC connections in registers, a
// longer one in the run-time form. With 32 lanes an ELL row takes up to
// 288 entries, the longest a compact shelf mesh makes (its pad rows, up to
// 255, repeat one column)
template <int L> struct Lanes;
template <> struct Lanes<1> { static constexpr int J = 12, JC = 12; };
template <> struct Lanes<32> { static constexpr int J = 9, JC = 1; };

// a row's group of L lanes: this thread's lane, and the group's lanes in
// the warp (the shuffles' mask)
struct Group {
    int lane;
    unsigned mask;
};

template <int L>
__device__ __forceinline__ Group group_of(int q) {
    const int base = (threadIdx.x & 31) & ~(L - 1);
    return Group{q % L, (L == 32 ? 0xffffffffu : ((1u << L) - 1u)) << base};
}

// lane src's value of v (every lane of the group gets it)
template <int L, typename T>
__device__ __forceinline__ T from_lane(T v, int src, const Group& g) {
    if constexpr (L == 1) return v;
    else return __shfl_sync(g.mask, v, src, L);
}

// A row of an ELL operator applied to NV vectors over one load of its
// columns and coefficients, each sum added k = 0, 1, ... in turn as `_ell`
// adds it. Only the row's m stored entries are added one by one: the
// padding after them is column 0 and value +0, so each of its products is
// the same +-0 (or NaN), and adding one more of them leaves the sum as it
// was (x + p + p = x + p for p = +-0 or NaN): one addition of the first
// padding product stands for all of them. Lane l of the row's L lanes
// gathers and forms the products of entries l, l + L, ... (its J slots),
// and every lane adds them in order from the lanes that hold them.
template <typename T, int L, int NV>
struct EllRow {
    static constexpr int J = Lanes<L>::J;
    const int* cols;
    const T* vals;
    int K, n, r, m;
    const T* x[NV];
    T p[NV][J];
    T acc[NV];

    // the count, and whether the row fits in the lanes' slots
    __device__ __forceinline__ bool fits(const int* lens) {
        m = __ldg(lens + r);
        return m <= L * J;
    }

    // the products of this lane's slots; with 32 lanes a warp is one row,
    // so the slots past its count are skipped, else every slot is formed
    // (indices clamped to the row's last entry)
    __device__ __forceinline__ void products(const Group& g) {
        int c[J];
        T v[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if (L == 32 && j * L >= m) break;
            const int k = j * L + g.lane;
            const size_t e = (size_t)(k < m ? k : m - 1) * n + r;
            c[j] = __ldg(cols + e);
            v[j] = __ldg(vals + e);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if (L == 32 && j * L >= m) break;
#pragma unroll
            for (int q = 0; q < NV; ++q)
                p[q][j] = mul(v[j], round_x<T>(x[q][c[j]]));
        }
    }

    // entry k (slot j, lane q) into the sums
    __device__ __forceinline__ void take(int k, int j, int q,
                                         const Group& g) {
#pragma unroll
        for (int w = 0; w < NV; ++w) {
            const T s = from_lane<L>(p[w][j], q, g);
            acc[w] = k == 0 ? s : (k < m ? add(acc[w], s) : acc[w]);
        }
    }

    // the next slot's products into slot 0
    __device__ __forceinline__ void shift() {
#pragma unroll
        for (int w = 0; w < NV; ++w)
#pragma unroll
            for (int j = 0; j + 1 < J; ++j) p[w][j] = p[w][j + 1];
    }

    // a row past the slots: the run-time form
    __device__ __forceinline__ void serial() {
        for (int k = 0; k < m; ++k) {
            const size_t e = (size_t)k * n + r;
            const int c = __ldg(cols + e);
            const T v = __ldg(vals + e);
#pragma unroll
            for (int w = 0; w < NV; ++w) {
                const T s = mul(v, round_x<T>(x[w][c]));
                acc[w] = k == 0 ? s : add(acc[w], s);
            }
        }
    }

    // the padding, one addition for all of it
    __device__ __forceinline__ void padding() {
        if (m >= K) return;
        const size_t e = (size_t)m * n + r;
        const int c = __ldg(cols + e);
        const T v = __ldg(vals + e);
#pragma unroll
        for (int w = 0; w < NV; ++w)
            acc[w] = add(acc[w], mul(v, round_x<T>(x[w][c])));
    }
};

// the sums of up to three ELL rows, their entries taken in turn and the
// rows' sums interleaved: with 32 lanes (a warp one row) the longest count
// bounds the loop, else the widest width (the same for every row of a
// warp), and a select leaves out each row's entries past its count
template <typename T, int L, int NA, int NB = 1, int NC = 1>
__device__ __forceinline__ void ell_sums(EllRow<T, L, NA>& a,
                                         EllRow<T, L, NB>* b,
                                         EllRow<T, L, NC>* c,
                                         const Group& g) {
    constexpr int J = Lanes<L>::J;
    int bound = L == 32 ? a.m : a.K;
    if (b) bound = max(bound, L == 32 ? b->m : b->K);
    if (c) bound = max(bound, L == 32 ? c->m : c->K);
    bound = min(bound, L * J);
    if constexpr (L == 32) {
        // a slot at a time, the next slot's products then moved into
        // slot 0: a loop of one slot's code, not J slots' (the code of J
        // slots unrolled overflows the instruction cache)
        for (int j = 0; j * L < bound; ++j) {
#pragma unroll
            for (int q = 0; q < L; ++q) {
                const int k = j * L + q;
                a.take(k, 0, q, g);
                if (b) b->take(k, 0, q, g);
                if (c) c->take(k, 0, q, g);
            }
            a.shift();
            if (b) b->shift();
            if (c) c->shift();
        }
    } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if (j * L >= bound) break;
#pragma unroll
            for (int q = 0; q < L; ++q) {
                const int k = j * L + q;
                a.take(k, j, q, g);
                if (b) b->take(k, j, q, g);
                if (c) c->take(k, j, q, g);
            }
        }
    }
}

// one ELL row's sums alone, before its padding
template <typename T, int L, int NV>
__device__ __forceinline__ void ell_alone(EllRow<T, L, NV>& a, bool fit,
                                          const Group& g) {
    if (fit) {
        a.products(g);
        ell_sums<T, L, NV>(a, (EllRow<T, L, 1>*)nullptr,
                           (EllRow<T, L, 1>*)nullptr, g);
    } else {
        a.serial();
    }
}

// map_b_to_c at an edge of triangles (t0, t1), -1 where none: their mean.
// The count is 1 or 2, so the quotient is the product with its reciprocal
// to the bit (both round the same exact value once)
template <typename T>
__device__ __forceinline__ T b_to_c(int t0, int t1, const T* u) {
    const T u0 = u[t0 >= 0 ? t0 : 0], u1 = u[t1 >= 0 ? t1 : 0];
    const T v0 = t0 >= 0 ? u0 : T(0);
    const T v1 = t1 >= 0 ? u1 : T(0);
    const int n = (t0 >= 0) + (t1 >= 0);
    return mul(add(v0, v1), n > 1 ? T(0.5) : T(1));
}

// the active-masked mean of H at three vertices of weights w (map_H_a_b)
template <typename T>
__device__ __forceinline__ T mean3(const T* H, const int* v, const T* w,
                                   T H_min) {
    T s = mul(H[v[0]], w[0]);
    s = add(s, mul(H[v[1]], w[1]));
    s = add(s, mul(H[v[2]], w[2]));
    const T n = add(add(w[0], w[1]), w[2]);
    return n > T(0) ? dvd(s, n < T(1) ? T(1) : n) : H_min;
}

// the active-masked a->c mean of H at the edge of vertices v0, v1
template <typename T>
__device__ __forceinline__ T mean2(const T* H, int v0, int v1, T w0, T w1,
                                   T H_min) {
    const T s = add(mul(H[v0], w0), mul(H[v1], w1));
    const T n = add(w0, w1);
    return n > T(0) ? dvd(s, n < T(1) ? T(1) : n) : H_min;
}

// a stage's states, outputs and own scalars
template <typename T>
struct Stage {
    const T *oH, *oU, *oV, *oT, *oS;
    const T *rH, *rU, *rV, *rT, *rS;
    const T *nowH;
    T *Hn, *Hs, *Tn, *Sn, *detr, *ph, *Un, *Vn;
    T *fH, *fU, *fV, *fT, *fS;
    T dt, inv_dt, c1, c2, c3, half_nu;
    int visc, post;
};

// the flux terms of one Voronoi connection (laddie_thickness.f90:143,
// laddie_tracers.f90): connection e of vertex i to c (-1 where none)
// through the edge of triangles (t0, t1)
template <typename T>
__device__ __forceinline__ void conn_flux(const LaddieDesc& d,
                                          const Stage<T>& s, size_t e,
                                          int c, int t0, int t1, T Hr, T Tr,
                                          T Sr, T& fH, T& fT, T& fS) {
    const int cc = c >= 0 ? c : 0;
    const T Uc = b_to_c<T>(t0, t1, s.rU);
    const T Vc = b_to_c<T>(t0, t1, s.rV);
    const T u_perp = add(mul(Uc, ro<T>(d.Dx_D, e)), mul(Vc, ro<T>(d.Dy_D, e)));
    const bool on = c >= 0 && !ro<uint8_t>(d.gr_a, cc);
    const bool oc = ro<uint8_t>(d.oc_a, cc);
    const T up = clamp_lo(u_perp, T(0));
    const T dn = clamp_hi(u_perp, T(0));
    const T LcA = ro<T>(d.LcA, e);
    const T H_j = s.rH[cc], T_j = s.rT[cc], S_j = s.rS[cc];
    fH = on ? mul(LcA, add(mul(up, Hr), mul(dn, oc ? T(0) : H_j))) : T(0);
    fT = on ? mul(LcA, add(mul(mul(up, Hr), Tr),
                           mul(dn, oc ? T(0) : mul(H_j, T_j)))) : T(0);
    fS = on ? mul(LcA, add(mul(mul(up, Hr), Sr),
                           mul(dn, oc ? T(0) : mul(H_j, S_j)))) : T(0);
}

// the upwind divergences of H, HT and HS over the Voronoi cell of vertex
// i, the connections added in turn (lane l forms the terms of connections
// l, l + L, ...; the indices of a connection past the row's width clamped
// to its last, so that every load issues at once)
template <typename T, int L>
__device__ __forceinline__ void voronoi_div(const LaddieDesc& d,
                                            const Stage<T>& s, int i, T Hr,
                                            T Tr, T Sr, const Group& g,
                                            T& dQH, T& dQT, T& dQS) {
    const int Kc = d.Kc;
    const size_t row = (size_t)i * Kc;
    constexpr int J = Lanes<L>::JC;
    if (Kc <= L * J) {
        int c[J], t0[J], t1[J];
        T fH[J], fT[J], fS[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int kk = j * L + g.lane;
            const size_t e = row + (kk < Kc ? kk : Kc - 1);
            c[j] = __ldg(d.C + e);
            t0[j] = __ldg(d.VET + 2 * e);
            t1[j] = __ldg(d.VET + 2 * e + 1);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int kk = j * L + g.lane;
            conn_flux<T>(d, s, row + (kk < Kc ? kk : Kc - 1), c[j], t0[j],
                         t1[j], Hr, Tr, Sr, fH[j], fT[j], fS[j]);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int q = 0; q < L; ++q) {
                const int kk = j * L + q;
                if (kk >= Kc) break;
                const T qH = from_lane<L>(fH[j], q, g);
                const T qT = from_lane<L>(fT[j], q, g);
                const T qS = from_lane<L>(fS[j], q, g);
                if (kk == 0) { dQH = qH; dQT = qT; dQS = qS; }
                else {
                    dQH = add(dQH, qH); dQT = add(dQT, qT);
                    dQS = add(dQS, qS);
                }
            }
        }
    } else {                   // a wider row: the run-time form
        dQH = dQT = dQS = T(0);
        for (int kk = 0; kk < Kc; ++kk) {
            const size_t e = row + kk;
            T fH, fT, fS;
            conn_flux<T>(d, s, e, __ldg(d.C + e), __ldg(d.VET + 2 * e),
                         __ldg(d.VET + 2 * e + 1), Hr, Tr, Sr, fH, fT, fS);
            if (kk == 0) { dQH = fH; dQT = fT; dQS = fS; }
            else { dQH = add(dQH, fH); dQT = add(dQT, fT); dQS = add(dQS, fS); }
        }
    }
}

// torch.searchsorted(z, depth) side left, by bisection over z [nd] in
// shared memory: the number of levels below depth (z is ascending), 0 for
// a NaN depth
template <typename T>
__device__ __forceinline__ int search_left(const T* z, int nd, T depth) {
    int lo = 0, hi = nd;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (z[mid] < depth) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

template <typename T, int L>
__device__ __forceinline__ void vertex_row(const LaddieDesc& d,
                                           const Stage<T>& s, const T* z,
                                           int i, const Group& g) {
    T k[N_K];
#pragma unroll
    for (int j = 0; j < N_K; ++j) k[j] = (T)d.k[j];
    const T Hr = s.rH[i], Tr = s.rT[i], Sr = s.rS[i];
    const T Hib = ro<T>(d.Hib, i);
    const bool act = ro<uint8_t>(d.a, i);

    // -- physics at the ref state (laddie_physics.f90) --
    EllRow<T, L, 2> ba{d.ba_cols, (const T*)d.ba_vals, d.Kba, d.nV, i, 0,
                       {s.rU, s.rV}, {}, {}};
    ell_alone<T, L, 2>(ba, ba.fits(d.ba_len), g);
    ba.padding();
    const T U_a = ba.acc[0], V_a = ba.acc[1];
    const T u_star = sqrt_rn(mul(k[K_CD_TOP],
                                 add(add(mul(U_a, U_a), mul(V_a, V_a)),
                                     k[K_TIDAL2])));
    T gamma_T, gamma_S;
    if (d.jenkins) {
        const T AA = mul(k[K_212], log_lib(add(mul(mul(u_star, Hr),
                                                   k[K_INV_NU0]), k[K_EPS])));
        gamma_T = dvd(u_star, sub(add(AA, k[K_KT]), k[K_868]));
        gamma_S = dvd(u_star, sub(add(AA, k[K_KS]), k[K_868]));
    } else {
        gamma_T = mul(u_star, k[K_GT]);
        gamma_S = mul(mul(u_star, k[K_GT]), k[K_INV35]);
    }
    const T That = add(mul(k[K_L3], Hib), k[K_L2]);
    T Chat, L_eff, Chat_Ctil;
    if (d.use_Ti) {
        L_eff = sub(k[K_LF], mul(k[K_CPI], ro<T>(d.Ti_base, i)));
        Chat = mul(dvd(T(1), L_eff), k[K_CPO]);
        Chat_Ctil = mul(Chat, k[K_CTIL]);
    } else {
        L_eff = k[K_LF];
        Chat = k[K_CHAT];
        Chat_Ctil = k[K_CHAT_CTIL];
    }
    const T l1S = mul(k[K_L1], Sr);
    const T That_T = sub(That, Tr);
    const T Bval = add(mul(mul(Chat, gamma_T), That_T),
                       mul(gamma_S, add(mul(Chat_Ctil, add(That, l1S)), T(1))));
    const T Cval = mul(mul(mul(Chat, gamma_T), gamma_S), add(That_T, l1S));
    const T disc = sub(mul(Bval, Bval), mul(k[K_FOUR], Cval));
    const T melt = disc < T(0) ? T(0)
        : mul(k[K_HALF], add(-Bval, sqrt_rn(clamp_lo(disc, T(0)))));
    const T Dval = sub(mul(melt, k[K_CPI]), mul(k[K_CPO], gamma_T));
    const T T_freeze = add(add(l1S, k[K_L2]), mul(k[K_L3], Hib));
    const T T_base = fabs(Dval) < k[K_DTHR] ? T_freeze
        : dvd(sub(mul(melt, L_eff), mul(mul(k[K_CPO], gamma_T), Tr)), Dval);

    // ambient T, S at the layer base: the search is side left
    const int nd = d.nd;
    const T depth_abs = clamp_lo(-sub(Hib, Hr), T(0));
    int idx = search_left<T>(z, nd, depth_abs) - 1;
    idx = idx < 0 ? 0 : (idx > nd - 2 ? nd - 2 : idx);
    const T w = clamp_hi(clamp_lo(dvd(sub(depth_abs, z[idx]),
                              clamp_lo(sub(z[idx + 1], z[idx]),
                                   k[K_DEPTH_FLOOR])), T(0)), T(1));
    const T one_w = sub(T(1), w);
    const size_t io = (size_t)i * nd + idx;
    const T T_amb = add(mul(ro<T>(d.T_ocean, io), one_w),
                        mul(ro<T>(d.T_ocean, io + 1), w));
    const T S_amb = add(mul(ro<T>(d.S_ocean, io), one_w),
                        mul(ro<T>(d.S_ocean, io + 1), w));
    T drho_amb = sub(mul(k[K_BETA], sub(S_amb, Sr)),
                     mul(k[K_ALPHA], sub(T_amb, Tr)));
    drho_amb = clamp_lo(drho_amb, k[K_DRHO_MIN]);
    const T Hdrho_amb = mul(Hr, drho_amb);

    // entrainment (Gaspar 1988)
    const T S_base = mul(sub(sub(T_base, k[K_L2]), mul(k[K_L3], Hib)),
                         k[K_INV_L1]);
    const T drho_base = sub(mul(k[K_BETA], sub(Sr, S_base)),
                            mul(k[K_ALPHA], sub(Tr, T_base)));
    const T u3 = mul(mul(u_star, u_star), u_star);
    T entr0 = sub(dvd(mul(k[K_ENTR], u3), mul(clamp_lo(Hr, k[K_HFLOOR]), drho_amb)),
                  mul(dvd(drho_base, drho_amb), melt));
    entr0 = clamp_lo(entr0, k[K_ENTR_MIN]);
    const T detr0 = -clamp_hi(entr0, T(0));

    const T p_melt = act ? melt : T(0);
    const T p_entr = act ? entr0 : T(0);
    const T p_gT = act ? gamma_T : T(0);
    const T p_Tb = act ? T_base : T(0);
    const T p_Ta = act ? T_amb : T(0);
    const T p_Sa = act ? S_amb : T(0);

    // -- the upwind divergences of H, HT and HS over the Voronoi cell --
    T dQH, dQT, dQS;
    voronoi_div<T, L>(d, s, i, Hr, Tr, Sr, g, dQH, dQT, dQS);
    dQH = act ? dQH : T(0);
    dQT = act ? dQT : T(0);
    dQS = act ? dQS : T(0);

    // -- thickness --
    const T sgd = ro<T>(d.SGD, i);
    const T oH = s.oH[i];
    const T oT = s.oT[i], oS = s.oS[i];
    const T now = s.post == POST_BLEND || s.post == POST_BLEND3 ? s.nowH[i]
                                                                : T(0);
    const T dHdt0 = add(add(add(-dQH, p_melt), p_entr), sgd);
    const T H_guess = add(oH, mul(dHdt0, s.dt));
    const T entr_dmin = mul(clamp_lo(sub(k[K_HMIN], H_guess), T(0)), s.inv_dt);
    T entr = add(p_entr, mul(clamp_hi(sub(k[K_HMAX], H_guess), T(0)),
                             s.inv_dt));
    entr = entr_dmin > T(0) ? clamp_lo(entr, T(0)) : entr;
    const T detr = -clamp_hi(entr, T(0));
    const T dHdt = add(add(add(add(-dQH, p_melt), entr), entr_dmin), sgd);
    const T H_new = act ? add(oH, mul(dHdt, s.dt)) : oH;

    // -- tracers --
    const T entr_p = clamp_lo(entr, T(0));
    const T detr_p = clamp_lo(detr, T(0));
    T dHTdt = add(-dQT, mul(p_melt, p_Tb));
    dHTdt = sub(dHTdt, mul(p_gT, sub(Tr, p_Tb)));
    dHTdt = add(dHTdt, mul(entr_p, p_Ta));
    dHTdt = sub(dHTdt, mul(detr_p, Tr));
    dHTdt = add(dHTdt, mul(entr_dmin, p_Ta));
    dHTdt = add(dHTdt, mul(sgd, add(mul(k[K_L3], Hib), k[K_L2])));
    T dHSdt = add(-dQS, mul(entr_p, p_Sa));
    dHSdt = sub(dHSdt, mul(detr_p, Sr));
    dHSdt = add(dHSdt, mul(entr_dmin, p_Sa));
    const T Hn = clamp_lo(H_new, k[K_HFLOOR]);
    const T T_new = act ? dvd(add(mul(oT, oH), mul(dHTdt, s.dt)), Hn) : oT;
    const T S_new = act ? dvd(add(mul(oS, oH), mul(dHSdt, s.dt)), Hn) : oS;

    // -- the stores, after the row's last load; by the row's first lane --
    if (g.lane != 0) return;
    T* ph = s.ph;
    const size_t nV = d.nV;
    ph[PH_MELT * nV + i] = p_melt;
    ph[PH_ENTR * nV + i] = p_entr;
    ph[PH_DETR * nV + i] = act ? detr0 : T(0);
    ph[PH_GAMMA_T * nV + i] = p_gT;
    ph[PH_GAMMA_S * nV + i] = act ? gamma_S : T(0);
    ph[PH_T_BASE * nV + i] = p_Tb;
    ph[PH_T_AMB * nV + i] = p_Ta;
    ph[PH_S_AMB * nV + i] = p_Sa;
    ph[PH_DRHO_AMB * nV + i] = act ? drho_amb : k[K_DRHO_DEF];
    ph[PH_HDRHO_AMB * nV + i] = act ? Hdrho_amb : T(0);
    s.Hn[i] = H_new;
    s.detr[i] = detr;
    s.Tn[i] = T_new;
    s.Sn[i] = S_new;

    // -- the scheme's update --
    if (s.post == POST_BLEND) {
        s.Hs[i] = add(mul(s.c1, H_new), mul(s.c2, now));
    } else if (s.post == POST_BLEND3) {
        s.Hs[i] = add(add(mul(s.c1, H_new), mul(s.c2, oH)), mul(s.c3, now));
    } else if (s.post == POST_LFRA) {
        // c + 0.5 nu (p + f - 2 c): c = ref, p = old, f = new
        s.fH[i] = add(Hr, mul(s.half_nu, sub(add(oH, H_new), mul(k[K_TWO], Hr))));
        s.fT[i] = add(Tr, mul(s.half_nu, sub(add(oT, T_new), mul(k[K_TWO], Tr))));
        s.fS[i] = add(Sr, mul(s.half_nu, sub(add(oS, S_new), mul(k[K_TWO], Sr))));
    }
}

// the terms of the upstream momentum advection and the viscosity of
// neighbour j of triangle r: all formed, a select keeps the ones the plain
// version adds
template <typename T>
__device__ __forceinline__ void neighbour_terms(
        const LaddieDesc& d, const Stage<T>& s, const T* k, int r, int j,
        T Hstar_b, T Ur, T Vr, T TriA, T& fU, T& fV, T& gU, T& gV) {
    const T* rH = s.rH;
    const T* rU = s.rU;
    const T* rV = s.rV;
    const T H_min = k[K_HMIN];
    const size_t rj = 3 * (size_t)r + j;
    const int tc = __ldg(d.TriC + rj);
    const int t = tc >= 0 ? tc : 0;
    const T TDx = ro<T>(d.TDx_D, rj), TDy = ro<T>(d.TDy_D, rj);
    const T TCw = ro<T>(d.TriCw, rj);
    const int t0 = __ldg(d.TriET + 2 * rj), t1 = __ldg(d.TriET + 2 * rj + 1);
    const T Uc = b_to_c<T>(t0, t1, rU);
    const T Vc = b_to_c<T>(t0, t1, rV);
    const T u_perp = add(mul(Uc, TDx), mul(Vc, TDy));
    const T out_f = clamp_lo(u_perp, T(0));
    const T in_f = clamp_hi(u_perp, T(0));
    const T Uj = rU[t], Vj = rV[t];
    int vn[3];
    T wn[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        vn[q] = __ldg(d.TriCV + 3 * rj + q);
        wn[q] = ro<uint8_t>(d.a, vn[q]) ? T(1) : T(0);
    }
    const T Hb_j = mean3<T>(rH, vn, wn, H_min);
    const T oHf = mul(out_f, Hstar_b), iH = mul(in_f, Hb_j);
    const bool adv = tc >= 0 && !ro<uint8_t>(d.gl_b, t);
    fU = adv ? dvd(mul(TCw, add(mul(oHf, Ur), mul(iH, Uj))), TriA) : T(0);
    fV = adv ? dvd(mul(TCw, add(mul(oHf, Vr), mul(iH, Vj))), TriA) : T(0);
    gU = gV = T(0);
    if (s.visc) {
        const int e0 = __ldg(d.TriEV + 2 * rj);
        const int e1 = __ldg(d.TriEV + 2 * rj + 1);
        const T Hc = mean2<T>(rH, e0, e1,
                              ro<uint8_t>(d.a, e0) ? T(1) : T(0),
                              ro<uint8_t>(d.a, e1) ? T(1) : T(0), H_min);
        const T dUn = sub(Uj, Ur), dVn = sub(Vj, Vr);
        const T dUabs = sqrt_rn(add(mul(dUn, dUn), mul(dVn, dVn)));
        const T Ah = mul(mul(mul(k[K_VISC], dUabs), TCw), k[K_INV100]);
        const T coef = dvd(mul(dvd(mul(Ah, Hc), TriA), TCw),
                           ro<T>(d.TriD, rj));
        const bool vis = tc >= 0 && !ro<uint8_t>(d.cf_b, t);
        gU = vis ? mul(coef, dUn) : T(0);
        gV = vis ? mul(coef, dVn) : T(0);
    }
}

template <typename T, int L>
__device__ __forceinline__ void triangle_row(const LaddieDesc& d,
                                             const Stage<T>& s, int r,
                                             const Group& g) {
    T k[N_K];
#pragma unroll
    for (int j = 0; j < N_K; ++j) k[j] = (T)d.k[j];
    const T* rH = s.rH;
    const T* rU = s.rU;
    const T* rV = s.rV;
    const size_t nV = d.nV;
    const T* Hdrho = s.ph + PH_HDRHO_AMB * nV;
    const T* drho = s.ph + PH_DRHO_AMB * nV;
    const T H_min = k[K_HMIN];

    // the own vertices, their active weights, and the a->b means
    int v[3];
    T w[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        v[j] = __ldg(d.Tri + 3 * r + j);
        w[j] = ro<uint8_t>(d.a, v[j]) ? T(1) : T(0);
    }
    const T H_new_b = mean3<T>(s.Hn, v, w, H_min);
    const T Hstar_b = mean3<T>(rH, v, w, H_min);
    const T Hdrho_b = mean3<T>(Hdrho, v, w, H_min);
    const T H_old_b = mean3<T>(s.oH, v, w, H_min);

    // the three ELL rows, their five sums interleaved; d/dx and d/dy of
    // drho and of H share their columns
    EllRow<T, L, 1> ab{d.ab_cols, (const T*)d.ab_vals, d.Kab, d.nTri, r, 0,
                       {s.detr}, {}, {}};
    EllRow<T, L, 2> dx{d.dx_cols, (const T*)d.dx_vals, d.Kdx, d.nTri, r, 0,
                       {drho, rH}, {}, {}};
    EllRow<T, L, 2> dy{d.dy_cols, (const T*)d.dy_vals, d.Kdy, d.nTri, r, 0,
                       {drho, rH}, {}, {}};
    const bool fit_ab = ab.fits(d.ab_len), fit_dx = dx.fits(d.dx_len),
               fit_dy = dy.fits(d.dy_len);
    if (fit_ab && fit_dx && fit_dy) {
        ab.products(g);
        dx.products(g);
        dy.products(g);
        ell_sums<T, L, 1, 2, 2>(ab, &dx, &dy, g);
    } else {
        ell_alone<T, L, 1>(ab, fit_ab, g);
        ell_alone<T, L, 2>(dx, fit_dx, g);
        ell_alone<T, L, 2>(dy, fit_dy, g);
    }
    ab.padding();
    dx.padding();
    dy.padding();
    const T detr_b = ab.acc[0];
    const T ddrho_dx = dx.acc[0], dH_dx = dx.acc[1];
    const T ddrho_dy = dy.acc[0], dH_dy = dy.acc[1];
    const T dHib_dx = ro<T>(d.dHib_dx_b, r);
    const T dHib_dy = ro<T>(d.dHib_dy_b, r);

    // the pressure gradient
    const T gHd = mul(k[K_GRAV], Hdrho_b);
    const T hgH2 = mul(k[K_HALF_GRAV], mul(Hstar_b, Hstar_b));
    const T ngHd = mul(k[K_NEG_GRAV], Hdrho_b);
    const bool edge_tri = ro<uint8_t>(d.cf_b, r) || ro<uint8_t>(d.gl_b, r);
    const T PGF_x = edge_tri
        ? sub(mul(gHd, dHib_dx), mul(hgH2, ddrho_dx))
        : sub(add(mul(ngHd, dH_dx), mul(gHd, dHib_dx)), mul(hgH2, ddrho_dx));
    const T PGF_y = edge_tri
        ? sub(mul(gHd, dHib_dy), mul(hgH2, ddrho_dy))
        : sub(add(mul(ngHd, dH_dy), mul(gHd, dHib_dy)), mul(hgH2, ddrho_dy));

    // upstream momentum advection and viscosity over the three neighbours,
    // added in turn (with lanes, lane j forms neighbour j's terms)
    const T Ur = rU[r], Vr = rV[r];
    const T TriA = ro<T>(d.TriA, r);
    T dQU, dQV, vU, vV;
    if constexpr (L == 1) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            T fU, fV, gU, gV;
            neighbour_terms<T>(d, s, k, r, j, Hstar_b, Ur, Vr, TriA, fU, fV,
                               gU, gV);
            if (j == 0) { dQU = fU; dQV = fV; vU = gU; vV = gV; }
            else {
                dQU = add(dQU, fU); dQV = add(dQV, fV);
                vU = add(vU, gU); vV = add(vV, gV);
            }
        }
    } else {
        static_assert(L >= 3, "a lane for each neighbour");
        T fU, fV, gU, gV;
        neighbour_terms<T>(d, s, k, r, g.lane < 3 ? g.lane : 0, Hstar_b, Ur,
                           Vr, TriA, fU, fV, gU, gV);
        dQU = from_lane<L>(fU, 0, g); dQV = from_lane<L>(fV, 0, g);
        vU = from_lane<L>(gU, 0, g); vV = from_lane<L>(gV, 0, g);
#pragma unroll
        for (int j = 1; j < 3; ++j) {
            dQU = add(dQU, from_lane<L>(fU, j, g));
            dQV = add(dQV, from_lane<L>(fV, j, g));
            vU = add(vU, from_lane<L>(gU, j, g));
            vV = add(vV, from_lane<L>(gV, j, g));
        }
    }
    const bool b = ro<uint8_t>(d.b, r);
    dQU = b ? dQU : T(0);
    dQV = b ? dQV : T(0);

    const T speed_ref = sqrt_rn(add(mul(Ur, Ur), mul(Vr, Vr)));
    const T fH = mul(k[K_FCOR], Hstar_b);
    T dHUdt = add(-dQU, PGF_x);
    dHUdt = add(dHUdt, mul(fH, Vr));
    dHUdt = sub(dHUdt, mul(mul(k[K_CD_MOM], Ur), speed_ref));
    dHUdt = sub(dHUdt, mul(detr_b, Ur));
    T dHVdt = add(-dQV, PGF_y);
    dHVdt = sub(dHVdt, mul(fH, Ur));
    dHVdt = sub(dHVdt, mul(mul(k[K_CD_MOM], Vr), speed_ref));
    dHVdt = sub(dHVdt, mul(detr_b, Vr));
    if (s.visc) {
        // no slip at missing neighbours
        const T nb = ro<T>(d.nb_border, r);
        vU = sub(vU, mul(dvd(mul(mul(Ur, k[K_VISC]), Hstar_b), TriA), nb));
        vV = sub(vV, mul(dvd(mul(mul(Vr, k[K_VISC]), Hstar_b), TriA), nb));
        dHUdt = add(dHUdt, b ? vU : T(0));
        dHVdt = add(dHVdt, b ? vV : T(0));
    }

    const T oU = s.oU[r], oV = s.oV[r];
    const T HU = add(mul(oU, H_old_b), mul(dHUdt, s.dt));
    const T HV = add(mul(oV, H_old_b), mul(dHVdt, s.dt));
    const T Hn_b = clamp_lo(H_new_b, k[K_HFLOOR]);
    T U_new = b ? dvd(HU, Hn_b) : T(0);
    T V_new = b ? dvd(HV, Hn_b) : T(0);
    const T speed = sqrt_rn(add(mul(U_new, U_new), mul(V_new, V_new)));
    const T lim = clamp_hi(mul(dvd(T(1), clamp_lo(speed, k[K_SPEED_FLOOR])),
                           k[K_VMAX]), T(1));
    U_new = mul(U_new, lim);
    V_new = mul(V_new, lim);
    if (g.lane != 0) return;
    s.Un[r] = U_new;
    s.Vn[r] = V_new;
    if (s.post == POST_LFRA) {
        s.fU[r] = add(Ur, mul(s.half_nu, sub(add(oU, U_new), mul(k[K_TWO], Ur))));
        s.fV[r] = add(Vr, mul(s.half_nu, sub(add(oV, V_new), mul(k[K_TWO], Vr))));
    }
}

// z_ocean into the block's shared memory
template <typename T>
__device__ __forceinline__ const T* stage_z(const LaddieDesc& d) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* z = (T*)smem;
    for (int j = threadIdx.x; j < d.nd; j += blockDim.x)
        z[j] = ro<T>(d.z_ocean, j);
    __syncthreads();
    return z;
}

// -- the stage entry: two launches ------------------------------------------

template <typename T>
__device__ __forceinline__ Stage<T> stage_of(const LaddieDesc& d) {
    Stage<T> s;
    s.oH = (const T*)d.oH; s.oU = (const T*)d.oU; s.oV = (const T*)d.oV;
    s.oT = (const T*)d.oT; s.oS = (const T*)d.oS;
    s.rH = (const T*)d.rH; s.rU = (const T*)d.rU; s.rV = (const T*)d.rV;
    s.rT = (const T*)d.rT; s.rS = (const T*)d.rS;
    s.nowH = (const T*)d.nowH;
    s.Hn = (T*)d.Hn; s.Hs = (T*)d.Hs; s.Tn = (T*)d.Tn; s.Sn = (T*)d.Sn;
    s.detr = (T*)d.detr; s.ph = (T*)d.ph; s.Un = (T*)d.Un; s.Vn = (T*)d.Vn;
    s.fH = (T*)d.fH; s.fU = (T*)d.fU; s.fV = (T*)d.fV; s.fT = (T*)d.fT;
    s.fS = (T*)d.fS;
    s.dt = (T)d.k[K_DT]; s.inv_dt = (T)d.k[K_INV_DT];
    s.c1 = (T)d.k[K_C1]; s.c2 = (T)d.k[K_C2]; s.c3 = (T)d.k[K_C3];
    s.half_nu = (T)d.k[K_HALF_NU];
    s.visc = d.visc;
    s.post = d.post;
    return s;
}

template <typename T, int L>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_vertex_pass(const __grid_constant__ LaddieDesc d) {
    const T* z = stage_z<T>(d);
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q / L < d.nV)
        vertex_row<T, L>(d, stage_of<T>(d), z, q / L, group_of<L>(q));
}

template <typename T, int L>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_triangle_pass(const __grid_constant__ LaddieDesc d) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q / L < d.nTri)
        triangle_row<T, L>(d, stage_of<T>(d), q / L, group_of<L>(q));
}

// threads a block of the stage entry: blocks of one warp while the rows
// do not give every SM a block of 128, so that a small mesh spreads over
// as many SMs as its rows can
static int stage_threads(int rows, int sms) {
    const int per_sm = (rows + sms - 1) / sms;
    int th = (per_sm + 31) / 32 * 32;
    return th < 32 ? 32 : (th > UF_LADDIE_THREADS ? UF_LADDIE_THREADS : th);
}

static int num_sms() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
}

template <typename T, int L>
static int stage_launch(const LaddieDesc& d, cudaStream_t stream) {
    const int sms = num_sms();
    const size_t smem = (size_t)d.nd * sizeof(T);
    if (d.nV > 0) {
        const int n = d.nV * L, th = stage_threads(n, sms);
        laddie_vertex_pass<T, L><<<(n + th - 1) / th, th, smem, stream>>>(d);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (d.nTri > 0) {
        const int n = d.nTri * L, th = stage_threads(n, sms);
        laddie_triangle_pass<T, L><<<(n + th - 1) / th, th, 0, stream>>>(d);
    }
    return (int)cudaGetLastError();
}

template <typename T, int L>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_leg_kernel(const __grid_constant__ LegDesc g);

// whether the rows at L lanes each fit in one co-resident wave of the leg
// kernel
template <typename T, int L>
static bool one_wave(const LaddieDesc& d) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, laddie_leg_kernel<T, L>, UF_LADDIE_THREADS,
            (size_t)d.nd * sizeof(T)) != cudaSuccess)
        return false;
    const long rows = d.nV > d.nTri ? d.nV : d.nTri;
    return rows * L <= (long)per_sm * num_sms() * UF_LADDIE_THREADS;
}

// a row's lanes: a warp when the rows at 32 lanes fit in one co-resident
// wave, else one. On a small mesh latency sets the time, and the lanes
// shorten each row's chains; on a large one the card is full, and lanes
// would only repeat each row's arithmetic
template <typename T>
static int lanes_for(const LaddieDesc& d) {
    return one_wave<T, 32>(d) ? 32 : 1;
}

// FN<T, L>(...) for the mesh's lanes
#define UF_BY_LANES(d, FN, T, ...)                                       \
    return lanes_for<T>(d) == 32 ? FN<T, 32>(__VA_ARGS__)                 \
                                 : FN<T, 1>(__VA_ARGS__);

// the lanes a row takes on this mesh
extern "C" int laddie_lanes_f32(const LaddieDesc* d) {
    return lanes_for<float>(*d);
}

extern "C" int laddie_lanes_f64(const LaddieDesc* d) {
    return lanes_for<double>(*d);
}

extern "C" int laddie_stage_f32(const LaddieDesc* d, void* stream) {
    if (d->nd > UF_LADDIE_MAX_ND) return (int)cudaErrorInvalidValue;
    UF_BY_LANES(*d, stage_launch, float, *d, (cudaStream_t)stream)
}

extern "C" int laddie_stage_f64(const LaddieDesc* d, void* stream) {
    if (d->nd > UF_LADDIE_MAX_ND) return (int)cudaErrorInvalidValue;
    UF_BY_LANES(*d, stage_launch, double, *d, (cudaStream_t)stream)
}

// -- the leg entry: one cooperative launch ------------------------------------

__device__ __forceinline__ StatePtrs leg_buf(const LegDesc& g, int j) {
    switch (j) {               // constant indices: no copy of the parameters
        case 0: return g.buf[0];
        case 1: return g.buf[1];
        case 2: return g.buf[2];
        default: return g.buf[3];
    }
}

// scalar j of stage st
__device__ __forceinline__ double leg_sk(const LegDesc& g, int st, int j) {
    return st == 0 ? g.sk[0][j] : (st == 1 ? g.sk[1][j] : g.sk[2][j]);
}

// stage st of pseudo-step `step`: its states, outputs and scalars, from the
// scheme's rotation of the buffer sets (make_laddie_step's `step`)
template <typename T>
__device__ __forceinline__ Stage<T> leg_stage(const LegDesc& g, int step,
                                              int st) {
    const StatePtrs prev = step == 0 ? g.in : leg_buf(g, (step - 1) & 1);
    const StatePtrs next = leg_buf(g, step & 1);
    StatePtrs old = prev, ref = prev, out = next, filt = next;
    T* Hn = (T*)next.H;
    if (g.scheme == SCHEME_FBRK3) {
        // now -> np13 (set 2) -> np12 (set 3) -> np1 (next); H_new apart
        if (st >= 1) old = ref = leg_buf(g, st + 1);
        out = st < 2 ? leg_buf(g, st + 2) : next;
        Hn = (T*)g.Hn;
    } else if (g.scheme == SCHEME_LFRA) {
        // (ref, old) = (now, nm1) -> (np1, filtered)
        old = step == 0 ? g.in : leg_buf(g, 2 + ((step - 1) & 1));
        filt = leg_buf(g, 2 + (step & 1));
    }
    Stage<T> s;
    s.oH = (const T*)old.H; s.oU = (const T*)old.U; s.oV = (const T*)old.V;
    s.oT = (const T*)old.T; s.oS = (const T*)old.S;
    s.rH = (const T*)ref.H; s.rU = (const T*)ref.U; s.rV = (const T*)ref.V;
    s.rT = (const T*)ref.T; s.rS = (const T*)ref.S;
    s.nowH = (const T*)prev.H;
    s.Hn = Hn; s.Hs = (T*)out.H; s.Tn = (T*)out.T; s.Sn = (T*)out.S;
    s.Un = (T*)out.U; s.Vn = (T*)out.V;
    s.detr = (T*)g.detr; s.ph = (T*)g.ph;
    s.fH = (T*)filt.H; s.fU = (T*)filt.U; s.fV = (T*)filt.V;
    s.fT = (T*)filt.T; s.fS = (T*)filt.S;
    s.dt = (T)leg_sk(g, st, SK_DT); s.inv_dt = (T)leg_sk(g, st, SK_INV_DT);
    s.c1 = (T)leg_sk(g, st, SK_C1); s.c2 = (T)leg_sk(g, st, SK_C2);
    s.c3 = (T)leg_sk(g, st, SK_C3); s.half_nu = (T)leg_sk(g, st, SK_HALF_NU);
    s.visc = st == 0 ? g.visc[0] : (st == 1 ? g.visc[1] : g.visc[2]);
    s.post = st == 0 ? g.post[0] : (st == 1 ? g.post[1] : g.post[2]);
    return s;
}

template <typename T, int L>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_leg_kernel(const __grid_constant__ LegDesc g) {
    const LaddieDesc& d = g.d;
    const T* z = stage_z<T>(d);
    cg::grid_group grid = cg::this_grid();
    // L lanes a row; the stride is a multiple of L, so a thread keeps its
    // lane
    const int stride = gridDim.x * blockDim.x;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const Group grp = group_of<L>(tid);
    for (int step = 0; step < g.n_steps; ++step) {
        for (int st = 0; st < g.n_stages; ++st) {
            const Stage<T> s = leg_stage<T>(g, step, st);
            for (int q = tid; q < d.nV * L; q += stride)
                vertex_row<T, L>(d, s, z, q / L, grp);
            grid.sync();
            for (int q = tid; q < d.nTri * L; q += stride)
                triangle_row<T, L>(d, s, q / L, grp);
            grid.sync();
        }
    }
}

// the leg's barriers alone: the same grid, two grid barriers a stage
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_barrier_kernel(int n_barriers) {
    cg::grid_group grid = cg::this_grid();
    for (int j = 0; j < n_barriers; ++j) grid.sync();
}

// the leg's grid: the co-resident maximum of blocks (the cooperative
// launch's limit), cut to the blocks its rows need
template <typename T, int L>
static int leg_blocks(const LaddieDesc& d, int* blocks) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, laddie_leg_kernel<T, L>, UF_LADDIE_THREADS,
        (size_t)d.nd * sizeof(T));
    if (err != cudaSuccess) return (int)err;
    const int rows = (d.nV > d.nTri ? d.nV : d.nTri) * L;
    const int need = (rows + UF_LADDIE_THREADS - 1) / UF_LADDIE_THREADS;
    const int most = per_sm * num_sms();
    *blocks = need < most ? need : most;
    return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, int L>
static int leg_launch(const LegDesc& g, cudaStream_t stream, int* blocks) {
    int err = leg_blocks<T, L>(g.d, blocks);
    if (err != 0) return err;
    void* args[] = {(void*)&g};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)laddie_leg_kernel<T, L>, dim3(*blocks),
        dim3(UF_LADDIE_THREADS), args, (size_t)g.d.nd * sizeof(T), stream);
}

// the floor of a leg's barriers: laddie_barrier_kernel on the grid the leg
// takes, 2 x n_stages x n_steps barriers
template <typename T, int L>
static int floor_launch(const LegDesc& g, cudaStream_t stream, int* blocks) {
    int err = leg_blocks<T, L>(g.d, blocks);
    if (err != 0) return err;
    int n = 2 * g.n_stages * g.n_steps;
    void* args[] = {(void*)&n};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)laddie_barrier_kernel, dim3(*blocks),
        dim3(UF_LADDIE_THREADS), args, 0, stream);
}

// `blocks` returns the grid the launch took
extern "C" int laddie_leg_f32(const LegDesc* g, void* stream, int* blocks) {
    if (g->d.nd > UF_LADDIE_MAX_ND) return (int)cudaErrorInvalidValue;
    UF_BY_LANES(g->d, leg_launch, float, *g, (cudaStream_t)stream, blocks)
}

extern "C" int laddie_leg_f64(const LegDesc* g, void* stream, int* blocks) {
    if (g->d.nd > UF_LADDIE_MAX_ND) return (int)cudaErrorInvalidValue;
    UF_BY_LANES(g->d, leg_launch, double, *g, (cudaStream_t)stream, blocks)
}

extern "C" int laddie_leg_floor_f32(const LegDesc* g, void* stream,
                                    int* blocks) {
    UF_BY_LANES(g->d, floor_launch, float, *g, (cudaStream_t)stream, blocks)
}

extern "C" int laddie_leg_floor_f64(const LegDesc* g, void* stream,
                                    int* blocks) {
    UF_BY_LANES(g->d, floor_launch, double, *g, (cudaStream_t)stream, blocks)
}
