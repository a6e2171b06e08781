// pair_math.cuh: the closed-form NOMA pair power allocation and SIC rates
// as device functions, shared by pairscore.cu and planner.cu so the two
// kernels evaluate one expression and cannot drift apart.
//
// Device twin of `_pair_math` (src/repro/kernels/pairscore.py). For a
// (strong g_i, weak g_j) pair:
//
//   y*  = 2 P g_i N0B / (N0B + sqrt(N0B^2 + 4 P g_i N0B))
//   p_j = min(y* / max(g_j, 1e-30), P)           p_i = P
//   R_i = B log1p(p_i g_i / (p_j g_j + N0B)) / ln2
//   R_j = B log1p(p_j g_j / N0B) / ln2
//
// and, with `oma`, full power for both users on half the bandwidth.
//
// Every operation is an explicitly rounded IEEE intrinsic (`__fmul_rn` and
// friends are never contracted into FMAs, and the build uses no fast-math),
// in the expression order of the reference, so the fp32 results track the
// plain PyTorch version and the JAX twin. `y*` depends on the strong gain
// alone, so a caller that sweeps one strong user against many weak ones
// computes it once (`strong_root`) and passes it to `pair_from_root`, or
// with p_i g_i to `noma_from_strong`; an OMA rate depends on one gain
// (`oma_rate`).
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct PairConsts {
  float two_pmax;   // fp32(2 * P)
  float four_pmax;  // fp32(4 * P)
  float pmax;       // fp32(P)
  float n0b;        // fp32(N0 B)
  float n0b_sq;     // fp32(N0B * N0B)
  float bw;         // fp32(B)
  float half_bw;    // fp32(0.5 * B)
  float ln2;        // fp32(ln 2)
  float tiny;       // fp32(1e-30)
};

struct PairOut {
  float p_i, p_j, r_i, r_j;
};

static __device__ __forceinline__ float rate(float scale, float snr,
                                             float ln2) {
  return __fdiv_rn(__fmul_rn(scale, log1pf(snr)), ln2);
}

// y*(g_i), the strong user's root (unused under OMA).
static __device__ __forceinline__ float strong_root(float g_i,
                                                    const PairConsts& k) {
  const float num = __fmul_rn(__fmul_rn(k.two_pmax, g_i), k.n0b);
  const float disc =
      __fadd_rn(k.n0b_sq, __fmul_rn(__fmul_rn(k.four_pmax, g_i), k.n0b));
  return __fdiv_rn(num, __fadd_rn(k.n0b, __fsqrt_rn(disc)));
}

// R of a user alone at full power on half the bandwidth (OMA): both users
// of an OMA pair take it, each from its own gain.
static __device__ __forceinline__ float oma_rate(float g,
                                                 const PairConsts& k) {
  return rate(k.half_bw, __fdiv_rn(__fmul_rn(k.pmax, g), k.n0b), k.ln2);
}

// The NOMA pair from what depends on the strong user alone, its root
// y*(g_i) and p_i g_i = fp32(P g_i), and the weak gain g_j.
static __device__ __forceinline__ PairOut noma_from_strong(
    float y, float pig, float g_j, const PairConsts& k) {
  PairOut o;
  o.p_j = fminf(__fdiv_rn(y, fmaxf(g_j, k.tiny)), k.pmax);
  o.p_i = k.pmax;
  const float pjgj = __fmul_rn(o.p_j, g_j);
  o.r_i = rate(k.bw, __fdiv_rn(pig, __fadd_rn(pjgj, k.n0b)), k.ln2);
  o.r_j = rate(k.bw, __fdiv_rn(pjgj, k.n0b), k.ln2);
  return o;
}

static __device__ __forceinline__ PairOut pair_from_root(float y, float g_i,
                                                         float g_j,
                                                         const PairConsts& k,
                                                         int oma) {
  if (oma)
    return PairOut{k.pmax, k.pmax, oma_rate(g_i, k), oma_rate(g_j, k)};
  return noma_from_strong(y, __fmul_rn(k.pmax, g_i), g_j, k);
}

static __device__ __forceinline__ PairOut pair_math(float g_i, float g_j,
                                                    const PairConsts& k,
                                                    int oma) {
  return pair_from_root(oma ? 0.0f : strong_root(g_i, k), g_i, g_j, k, oma);
}

}  // namespace repro
