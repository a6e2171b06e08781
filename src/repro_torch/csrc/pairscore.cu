// pairscore_kernel: closed-form NOMA pair power allocation + SIC rates.
//
// Replaces `_pairscore_kernel` (src/repro/kernels/pairscore.py:75, launched
// by `pairscore_pallas` at :115). For every (strong g_i, weak g_j) pair:
//
//   y*  = 2 P g_i N0B / (N0B + sqrt(N0B^2 + 4 P g_i N0B))
//   p_j = min(y* / max(g_j, 1e-30), P)           p_i = P
//   R_i = B log1p(p_i g_i / (p_j g_j + N0B)) / ln2
//   R_j = B log1p(p_j g_j / N0B) / ln2
//
// and, with `oma`, full power for both users on half the bandwidth.
//
// Bound on the H100: 8 bytes read and 16 written per element (24 B) against
// ~25 fp32 operations, so the bytes bound it (3.35 TB/s) at any size. The
// TPU version padded the pair axis to (8, 128) tiles; here the axis stays
// flat, one element per thread over a grid-stride loop with a masked tail,
// so no padding is read or written. At the shapes the FL round gives it
// (5 pairs) the launch itself is the cost.
//
// The pair math itself is `repro::pair_math` in pair_math.cuh, shared with
// the planner kernel (planner.cu).
#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace {

using repro::PairConsts;

__global__ void pairscore_kernel(const float* __restrict__ gi,
                                 const float* __restrict__ gj,
                                 float* __restrict__ pi,
                                 float* __restrict__ pj,
                                 float* __restrict__ ri,
                                 float* __restrict__ rj, int64_t n,
                                 PairConsts k, int oma) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n; t += stride) {
    const repro::PairOut o = repro::pair_math(gi[t], gj[t], k, oma);
    pi[t] = o.p_i;
    pj[t] = o.p_j;
    ri[t] = o.r_i;
    rj[t] = o.r_j;
  }
}

}  // namespace

extern "C" int repro_pairscore(const float* gi, const float* gj, float* pi,
                               float* pj, float* ri, float* rj, int64_t n,
                               float two_pmax, float four_pmax, float pmax,
                               float n0b, float n0b_sq, float bw,
                               float half_bw, float ln2, float tiny, int oma,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  PairConsts k{two_pmax, four_pmax, pmax, n0b, n0b_sq, bw, half_bw, ln2,
               tiny};
  pairscore_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(gi, gj, pi, pj, ri,
                                                          rj, n, k, oma);
  return static_cast<int>(cudaGetLastError());
}
