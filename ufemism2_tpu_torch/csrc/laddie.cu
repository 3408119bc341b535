// laddie_stage: one stage of the LADDIE plume's pseudo-time integration,
// for sm_90a.
//
// It computes what the JAX package's make_laddie_step `stage` computes
// (ufemism2_tpu/models/laddie.py:373-470: compute_H_npx, compute_UV_npx and
// compute_TS_npx of the reference's laddie_integration.f90), for the
// scheme's (old, ref) states, and the scheme's update after it: the fbrk3
// beta-blend of the thickness, or the lfra Robert-Asselin filter. It
// replaces XLA-lowered code, not a Pallas kernel: the JAX package runs a
// whole leg as one jitted lax.fori_loop, and in eager PyTorch a stage is a
// few hundred small launches (the physics, two upwind divergences, the
// momentum advection, the viscosity and the a->b maps), some 3 x 10^6 for
// the 30-day initial leg. Here a stage is two launches:
//
//   - the vertex pass, one thread a vertex: U_a, V_a through the rows of
//     M_map_b_a; u*, the gammas, the melt, T_base; the ambient T and S by
//     the depth search over z_ocean; the buoyancy and the entrainment; the
//     upwind thickness divergence and the two tracer divergences over the
//     Voronoi neighbours, with the c-grid velocity of each edge from its
//     (one or two) triangles as map_b_to_c forms it; the corrected entr,
//     entr_dmin and detr; H, T and S of the stage, the blended H, the
//     filtered H, T and S; the masked physics fields (ph) and detr for the
//     triangle pass.
//   - the triangle pass, one thread a triangle: the masked a->b means of
//     H_new, H_ref, H_old and H*drho (and of H_ref at the three neighbour
//     triangles), the a->c means at its three edges; detr_b, the drho and
//     H gradients through the rows of M_map_a_b and M_ddx/ddy_a_b; the
//     pressure gradient with its edge-triangle form; the upstream momentum
//     advection over TriC and TriE; the viscosity in the stages that have
//     it; Coriolis and drag; U and V of the stage with the speed limit;
//     the filtered U and V.
//
// The pad rows of the compact shelf mesh (copies of row 0 with -1
// connectivity) are computed like every other row; the caller drops them.
//
// Bound: a vertex reads its state rows, its forcing (with the ambient
// profile, nd values of T and of S), about 10 connections of geometry and
// 2 triangles an edge; a triangle reads 3 vertices, 3 edges and 3
// neighbours and 4 ELL rows of about 10 entries. At the compact meshes of
// the model's path (a few thousand rows) that is a few hundred kB a stage,
// well under a microsecond at 3.35 TB/s: the stage is bound by the
// latency of two dependent launches and of the divisions and square roots
// on each row's chain, not by bytes (chip_smoke.py laddie_bound counts the
// bytes of each case).
//
// Rounding contract: the result equals the plain version
// (ops/cuda_laddie.py laddie_stage_plain, run on the card) to the bit.
// Every operation is rounded as the plain version's tensor operation is -
// __f*_rn / __d*_rn, never a contracted multiply-add - in the same order:
// a Python scalar enters as its value rounded to T; a tensor divided by a
// Python scalar is multiplied by the reciprocal of the scalar rounded to T
// (the reciprocal formed on the host in T, as PyTorch forms it); a Python
// scalar divided by a tensor is the tensor's reciprocal times the scalar;
// x ** 2 and x ** 3 are products; clamp and where are PyTorch's (a NaN
// passes a clamp); the ELL rows and the neighbour sums are added k = 0, 1,
// ... in turn, as `_ell` and `_rsum` add them, the ELL operand rounded to
// bfloat16 in float32. One operation is not an IEEE operation: log, in
// the Jenkins1991 gamma, is the CUDA math library's logf / log, as
// PyTorch's torch.log on the card calls it (chip_smoke.py reports the gap
// if the two libraries differ).

#include <cuda_runtime.h>
#include <stdint.h>

#define UF_LADDIE_THREADS 128

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

enum { PH_MELT, PH_ENTR, PH_DETR, PH_GAMMA_T, PH_GAMMA_S, PH_T_BASE,
       PH_T_AMB, PH_S_AMB, PH_DRHO_AMB, PH_HDRHO_AMB, N_PH };

enum { POST_NONE, POST_BLEND, POST_BLEND3, POST_LFRA };

struct LaddieDesc {            // ops/cuda_laddie.py::_LaddieDesc
    // static tables of the mesh
    const int* C;              // [nV, Kc] neighbour vertex, -1 where none
    const int* VE;             // [nV, Kc] edge of each connection (pad 0)
    const void* LcA;           // [nV, Kc] T  Cw / A
    const void* Dx_D;          // [nV, Kc] T  D_x / D
    const void* Dy_D;          // [nV, Kc] T  D_y / D
    const int* Tri;            // [nTri, 3]
    const int* EV;             // [nE, 2]
    const int* ETri;           // [nE, 2] -1 where none
    const int* TriC;           // [nTri, 3] -1 where none
    const int* TriE;           // [nTri, 3] (pad 0)
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

// one row of an ELL operator applied to x: k = 0, 1, ... in turn
template <typename T>
__device__ __forceinline__ T ell_row(const int* cols, const T* vals, int K,
                                     int n, int r, const T* x) {
    T acc = mul(vals[r], round_x<T>(x[cols[r]]));
    for (int k = 1; k < K; ++k) {
        const size_t e = (size_t)k * n + r;
        acc = add(acc, mul(vals[e], round_x<T>(x[cols[e]])));
    }
    return acc;
}

// map_b_to_c at edge e: the mean of its (one or two) triangles
template <typename T>
__device__ __forceinline__ T b_to_c(const int* ETri, int e, const T* u) {
    const int t0 = ETri[2 * e], t1 = ETri[2 * e + 1];
    const T v0 = t0 >= 0 ? u[t0] : T(0);
    const T v1 = t1 >= 0 ? u[t1] : T(0);
    const int n = (t0 >= 0) + (t1 >= 0);
    return dvd(add(v0, v1), (T)(n > 1 ? n : 1));
}

// the active-masked a->b mean at triangle t (map_H_a_b)
template <typename T>
__device__ __forceinline__ T map_a_b(const int* Tri, const uint8_t* a, int t,
                                     const T* H, T H_min) {
    const int v0 = Tri[3 * t], v1 = Tri[3 * t + 1], v2 = Tri[3 * t + 2];
    const T w0 = a[v0] ? T(1) : T(0);
    const T w1 = a[v1] ? T(1) : T(0);
    const T w2 = a[v2] ? T(1) : T(0);
    T s = mul(H[v0], w0);
    s = add(s, mul(H[v1], w1));
    s = add(s, mul(H[v2], w2));
    const T n = add(add(w0, w1), w2);
    return n > T(0) ? dvd(s, n < T(1) ? T(1) : n) : H_min;
}

// the active-masked a->c mean at edge e (map_H_a_c)
template <typename T>
__device__ __forceinline__ T map_a_c(const int* EV, const uint8_t* a, int e,
                                     const T* H, T H_min) {
    const int v0 = EV[2 * e], v1 = EV[2 * e + 1];
    const T w0 = a[v0] ? T(1) : T(0);
    const T w1 = a[v1] ? T(1) : T(0);
    const T s = add(mul(H[v0], w0), mul(H[v1], w1));
    const T n = add(w0, w1);
    return n > T(0) ? dvd(s, n < T(1) ? T(1) : n) : H_min;
}

template <typename T>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_vertex_pass(const LaddieDesc d) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= d.nV) return;
    T k[N_K];
#pragma unroll
    for (int j = 0; j < N_K; ++j) k[j] = (T)d.k[j];
    const T* rH = (const T*)d.rH;  const T* rU = (const T*)d.rU;
    const T* rV = (const T*)d.rV;  const T* rT = (const T*)d.rT;
    const T* rS = (const T*)d.rS;
    const T Hr = rH[i], Tr = rT[i], Sr = rS[i];
    const T Hib = ((const T*)d.Hib)[i];
    const bool act = d.a[i];

    // -- physics at the ref state (laddie_physics.f90) --
    const T U_a = ell_row<T>(d.ba_cols, (const T*)d.ba_vals, d.Kba, d.nV, i, rU);
    const T V_a = ell_row<T>(d.ba_cols, (const T*)d.ba_vals, d.Kba, d.nV, i, rV);
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
        L_eff = sub(k[K_LF], mul(k[K_CPI], ((const T*)d.Ti_base)[i]));
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
    const T* z = (const T*)d.z_ocean;
    const int nd = d.nd;
    const T depth_abs = clamp_lo(-sub(Hib, Hr), T(0));
    int pos = 0;
    while (pos < nd && z[pos] < depth_abs) ++pos;
    int idx = pos - 1;
    idx = idx < 0 ? 0 : (idx > nd - 2 ? nd - 2 : idx);
    const T w = clamp_hi(clamp_lo(dvd(sub(depth_abs, z[idx]),
                              clamp_lo(sub(z[idx + 1], z[idx]),
                                   k[K_DEPTH_FLOOR])), T(0)), T(1));
    const T one_w = sub(T(1), w);
    const T* To = (const T*)d.T_ocean + (size_t)i * nd;
    const T* So = (const T*)d.S_ocean + (size_t)i * nd;
    const T T_amb = add(mul(To[idx], one_w), mul(To[idx + 1], w));
    const T S_amb = add(mul(So[idx], one_w), mul(So[idx + 1], w));
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
    T* ph = (T*)d.ph;
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

    // -- the upwind divergences of H, HT and HS over the Voronoi cell --
    const uint8_t* gr_a = d.gr_a;
    const uint8_t* oc_a = d.oc_a;
    const int Kc = d.Kc;
    T dQH = T(0), dQT = T(0), dQS = T(0);
    for (int kk = 0; kk < Kc; ++kk) {
        const size_t e = (size_t)i * Kc + kk;
        const int c = d.C[e];
        const int cc = c >= 0 ? c : 0;
        const int ed = d.VE[e];
        const T Uc = b_to_c<T>(d.ETri, ed, rU);
        const T Vc = b_to_c<T>(d.ETri, ed, rV);
        const T u_perp = add(mul(Uc, ((const T*)d.Dx_D)[e]),
                             mul(Vc, ((const T*)d.Dy_D)[e]));
        const bool on = c >= 0 && !gr_a[cc];
        const bool oc = oc_a[cc];
        const T up = clamp_lo(u_perp, T(0));
        const T dn = clamp_hi(u_perp, T(0));
        const T LcA = ((const T*)d.LcA)[e];
        const T H_j = rH[cc];
        const T fH = on ? mul(LcA, add(mul(up, Hr), mul(dn, oc ? T(0) : H_j)))
                        : T(0);
        const T fT = on ? mul(LcA, add(mul(mul(up, Hr), Tr),
                                       mul(dn, oc ? T(0) : mul(H_j, rT[cc]))))
                        : T(0);
        const T fS = on ? mul(LcA, add(mul(mul(up, Hr), Sr),
                                       mul(dn, oc ? T(0) : mul(H_j, rS[cc]))))
                        : T(0);
        if (kk == 0) { dQH = fH; dQT = fT; dQS = fS; }
        else { dQH = add(dQH, fH); dQT = add(dQT, fT); dQS = add(dQS, fS); }
    }
    dQH = act ? dQH : T(0);
    dQT = act ? dQT : T(0);
    dQS = act ? dQS : T(0);

    // -- thickness --
    const T sgd = ((const T*)d.SGD)[i];
    const T oH = ((const T*)d.oH)[i];
    const T dHdt0 = add(add(add(-dQH, p_melt), p_entr), sgd);
    const T H_guess = add(oH, mul(dHdt0, k[K_DT]));
    const T entr_dmin = mul(clamp_lo(sub(k[K_HMIN], H_guess), T(0)), k[K_INV_DT]);
    T entr = add(p_entr, mul(clamp_hi(sub(k[K_HMAX], H_guess), T(0)),
                             k[K_INV_DT]));
    entr = entr_dmin > T(0) ? clamp_lo(entr, T(0)) : entr;
    const T detr = -clamp_hi(entr, T(0));
    const T dHdt = add(add(add(add(-dQH, p_melt), entr), entr_dmin), sgd);
    const T H_new = act ? add(oH, mul(dHdt, k[K_DT])) : oH;
    ((T*)d.Hn)[i] = H_new;
    ((T*)d.detr)[i] = detr;

    // -- tracers --
    const T oT = ((const T*)d.oT)[i], oS = ((const T*)d.oS)[i];
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
    const T T_new = act ? dvd(add(mul(oT, oH), mul(dHTdt, k[K_DT])), Hn) : oT;
    const T S_new = act ? dvd(add(mul(oS, oH), mul(dHSdt, k[K_DT])), Hn) : oS;
    ((T*)d.Tn)[i] = T_new;
    ((T*)d.Sn)[i] = S_new;

    // -- the scheme's update --
    if (d.post == POST_BLEND) {
        const T now = ((const T*)d.nowH)[i];
        ((T*)d.Hs)[i] = add(mul(k[K_C1], H_new), mul(k[K_C2], now));
    } else if (d.post == POST_BLEND3) {
        const T now = ((const T*)d.nowH)[i];
        ((T*)d.Hs)[i] = add(add(mul(k[K_C1], H_new), mul(k[K_C2], oH)),
                            mul(k[K_C3], now));
    } else if (d.post == POST_LFRA) {
        // c + 0.5 nu (p + f - 2 c): c = ref, p = old, f = new
        ((T*)d.fH)[i] = add(Hr, mul(k[K_HALF_NU],
                                    sub(add(oH, H_new), mul(k[K_TWO], Hr))));
        ((T*)d.fT)[i] = add(Tr, mul(k[K_HALF_NU],
                                    sub(add(oT, T_new), mul(k[K_TWO], Tr))));
        ((T*)d.fS)[i] = add(Sr, mul(k[K_HALF_NU],
                                    sub(add(oS, S_new), mul(k[K_TWO], Sr))));
    }
}

template <typename T>
__global__ void __launch_bounds__(UF_LADDIE_THREADS)
laddie_triangle_pass(const LaddieDesc d) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= d.nTri) return;
    T k[N_K];
#pragma unroll
    for (int j = 0; j < N_K; ++j) k[j] = (T)d.k[j];
    const uint8_t* a = d.a;
    const T* rH = (const T*)d.rH;
    const T* rU = (const T*)d.rU;
    const T* rV = (const T*)d.rV;
    const T* ph = (const T*)d.ph;
    const size_t nV = d.nV;
    const T H_min = k[K_HMIN];

    const T H_new_b = map_a_b<T>(d.Tri, a, r, (const T*)d.Hn, H_min);
    const T Hstar_b = map_a_b<T>(d.Tri, a, r, rH, H_min);
    const T Hdrho_b = map_a_b<T>(d.Tri, a, r, ph + PH_HDRHO_AMB * nV, H_min);
    const T detr_b = ell_row<T>(d.ab_cols, (const T*)d.ab_vals, d.Kab,
                                d.nTri, r, (const T*)d.detr);
    const T* drho = ph + PH_DRHO_AMB * nV;
    const T ddrho_dx = ell_row<T>(d.dx_cols, (const T*)d.dx_vals, d.Kdx,
                                  d.nTri, r, drho);
    const T ddrho_dy = ell_row<T>(d.dy_cols, (const T*)d.dy_vals, d.Kdy,
                                  d.nTri, r, drho);
    const T dH_dx = ell_row<T>(d.dx_cols, (const T*)d.dx_vals, d.Kdx,
                               d.nTri, r, rH);
    const T dH_dy = ell_row<T>(d.dy_cols, (const T*)d.dy_vals, d.Kdy,
                               d.nTri, r, rH);
    const T dHib_dx = ((const T*)d.dHib_dx_b)[r];
    const T dHib_dy = ((const T*)d.dHib_dy_b)[r];

    // the pressure gradient
    const T gHd = mul(k[K_GRAV], Hdrho_b);
    const T hgH2 = mul(k[K_HALF_GRAV], mul(Hstar_b, Hstar_b));
    const T ngHd = mul(k[K_NEG_GRAV], Hdrho_b);
    const bool edge_tri = d.cf_b[r] || d.gl_b[r];
    const T PGF_x = edge_tri
        ? sub(mul(gHd, dHib_dx), mul(hgH2, ddrho_dx))
        : sub(add(mul(ngHd, dH_dx), mul(gHd, dHib_dx)), mul(hgH2, ddrho_dx));
    const T PGF_y = edge_tri
        ? sub(mul(gHd, dHib_dy), mul(hgH2, ddrho_dy))
        : sub(add(mul(ngHd, dH_dy), mul(gHd, dHib_dy)), mul(hgH2, ddrho_dy));

    // upstream momentum advection over the three neighbours
    const T Ur = rU[r], Vr = rV[r];
    const T TriA = ((const T*)d.TriA)[r];
    const T* TDx = (const T*)d.TDx_D + 3 * (size_t)r;
    const T* TDy = (const T*)d.TDy_D + 3 * (size_t)r;
    const T* TCw = (const T*)d.TriCw + 3 * (size_t)r;
    const T* TD = (const T*)d.TriD + 3 * (size_t)r;
    T dQU = T(0), dQV = T(0), vU = T(0), vV = T(0);
    for (int j = 0; j < 3; ++j) {
        const int tc = d.TriC[3 * r + j];
        const int t = tc >= 0 ? tc : 0;
        const int e = d.TriE[3 * r + j];
        const T Uc = b_to_c<T>(d.ETri, e, rU);
        const T Vc = b_to_c<T>(d.ETri, e, rV);
        const T u_perp = add(mul(Uc, TDx[j]), mul(Vc, TDy[j]));
        const T out_f = clamp_lo(u_perp, T(0));
        const T in_f = clamp_hi(u_perp, T(0));
        const T Uj = rU[t], Vj = rV[t];
        T fU = T(0), fV = T(0);
        if (tc >= 0 && !d.gl_b[t]) {
            const T Hb_j = map_a_b<T>(d.Tri, a, t, rH, H_min);
            const T oH = mul(out_f, Hstar_b), iH = mul(in_f, Hb_j);
            fU = dvd(mul(TCw[j], add(mul(oH, Ur), mul(iH, Uj))), TriA);
            fV = dvd(mul(TCw[j], add(mul(oH, Vr), mul(iH, Vj))), TriA);
        }
        T gU = T(0), gV = T(0);
        if (d.visc && tc >= 0 && !d.cf_b[t]) {
            const T Hc = map_a_c<T>(d.EV, a, e, rH, H_min);
            const T dUn = sub(Uj, Ur), dVn = sub(Vj, Vr);
            const T dUabs = sqrt_rn(add(mul(dUn, dUn), mul(dVn, dVn)));
            const T Ah = mul(mul(mul(k[K_VISC], dUabs), TCw[j]), k[K_INV100]);
            const T coef = dvd(mul(dvd(mul(Ah, Hc), TriA), TCw[j]), TD[j]);
            gU = mul(coef, dUn);
            gV = mul(coef, dVn);
        }
        if (j == 0) { dQU = fU; dQV = fV; vU = gU; vV = gV; }
        else {
            dQU = add(dQU, fU); dQV = add(dQV, fV);
            vU = add(vU, gU); vV = add(vV, gV);
        }
    }
    const bool b = d.b[r];
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
    if (d.visc) {
        // no slip at missing neighbours
        const T nb = ((const T*)d.nb_border)[r];
        vU = sub(vU, mul(dvd(mul(mul(Ur, k[K_VISC]), Hstar_b), TriA), nb));
        vV = sub(vV, mul(dvd(mul(mul(Vr, k[K_VISC]), Hstar_b), TriA), nb));
        dHUdt = add(dHUdt, b ? vU : T(0));
        dHVdt = add(dHVdt, b ? vV : T(0));
    }

    const T H_old_b = map_a_b<T>(d.Tri, a, r, (const T*)d.oH, H_min);
    const T oU = ((const T*)d.oU)[r], oV = ((const T*)d.oV)[r];
    const T HU = add(mul(oU, H_old_b), mul(dHUdt, k[K_DT]));
    const T HV = add(mul(oV, H_old_b), mul(dHVdt, k[K_DT]));
    const T Hn_b = clamp_lo(H_new_b, k[K_HFLOOR]);
    T U_new = b ? dvd(HU, Hn_b) : T(0);
    T V_new = b ? dvd(HV, Hn_b) : T(0);
    const T speed = sqrt_rn(add(mul(U_new, U_new), mul(V_new, V_new)));
    const T lim = clamp_hi(mul(dvd(T(1), clamp_lo(speed, k[K_SPEED_FLOOR])),
                           k[K_VMAX]), T(1));
    U_new = mul(U_new, lim);
    V_new = mul(V_new, lim);
    ((T*)d.Un)[r] = U_new;
    ((T*)d.Vn)[r] = V_new;
    if (d.post == POST_LFRA) {
        ((T*)d.fU)[r] = add(Ur, mul(k[K_HALF_NU],
                                    sub(add(oU, U_new), mul(k[K_TWO], Ur))));
        ((T*)d.fV)[r] = add(Vr, mul(k[K_HALF_NU],
                                    sub(add(oV, V_new), mul(k[K_TWO], Vr))));
    }
}

template <typename T>
static int laddie_stage(const LaddieDesc& d, cudaStream_t stream) {
    const int th = UF_LADDIE_THREADS;
    if (d.nV > 0)
        laddie_vertex_pass<T><<<(d.nV + th - 1) / th, th, 0, stream>>>(d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (d.nTri > 0)
        laddie_triangle_pass<T><<<(d.nTri + th - 1) / th, th, 0, stream>>>(d);
    return (int)cudaGetLastError();
}

extern "C" int laddie_stage_f32(const LaddieDesc* d, void* stream) {
    return laddie_stage<float>(*d, (cudaStream_t)stream);
}

extern "C" int laddie_stage_f64(const LaddieDesc* d, void* stream) {
    return laddie_stage<double>(*d, (cudaStream_t)stream);
}
