// planner_kernel: the fused round-planner tables over gain-sorted candidates.
//
// Replaces `_planner_kernel` (src/repro/kernels/planner.py:47, launched by
// `planner_tables_pallas` at :124). For each batch row b and ranks p
// (strong) and q (weak) of its c candidates:
//
//   comp[p, q]  = max(t[p] + S / max(R_i, 1e-9), t[q] + S / max(R_j, 1e-9))
//   table[p, q] = bf16(comp[p, q])                 round to nearest even
//   row_min[p]  = min over q != p of comp[p, q]    from fp32, before the cast
//   t_sw        = max over p < m of comp[p, c_pair - 1 - p]   (fp32; 0 if m=0)
//
// with c_pair = c - c % 2, m = c_pair / 2, and R_i, R_j from the shared
// `repro::pair_math` (pair_math.cuh), so the table prices a pair exactly as
// the pairscore kernel does. The diagonal is computed and stored, as in the
// reference, and left out of row_min.
//
// Bound on the H100: it moves B (8c + 4) bytes in, 2 B c^2 + 4 B c + 4 B
// out, against B c^2 pair evaluations of about 30 fp32 operations each. By
// those counts the bytes bound it (at B=64, c=256: 8.6 MB, 2.6 us at
// 3.35 TB/s, against 1.9 us of operations at 67 TFLOP/s), but the
// operations include two log1p and seven IEEE divides per pair (and a
// sqrt per row), each many instructions, so in practice the arithmetic is
// the wall. The design takes the per-row work out of the column loop: the
// strong user's root y* depends on g[p] alone, so each warp computes it
// once per row, and the warp's lanes stride over q with one pair
// evaluation each. The bf16 table is stored row-contiguous (coalesced
// 2-byte stores), and the row minimum is a warp-shuffle reduction.
//
// The Pallas kernel carried row_min and t_sw across the sequential column
// steps of its grid. CUDA blocks run in no order, so here one warp owns a
// whole row (no cross-block row reduction), each strong row p < m writes
// its anti-diagonal entry to a (B, m) scratch, and a second tiny kernel
// reduces that scratch to t_sw. No padding to 128 lanes: tails are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "pair_math.cuh"

namespace {

using repro::PairConsts;
using repro::PairOut;

constexpr int kWarpsPerBlock = 8;

__global__ void planner_kernel(const float* __restrict__ g,
                               const float* __restrict__ t,
                               const float* __restrict__ mb,
                               __nv_bfloat16* __restrict__ table,
                               float* __restrict__ row_min,
                               float* __restrict__ anti, int64_t rows, int c,
                               int c_pair, int m, PairConsts k, float eps,
                               int oma) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int64_t b = row / c;
  const int p = static_cast<int>(row - b * c);
  const float* gb = g + b * c;
  const float* tb = t + b * c;
  const float g_i = gb[p];
  const float t_i = tb[p];
  const float s = mb[b];
  const float y = oma ? 0.0f : repro::strong_root(g_i, k);
  const int q_sw = c_pair - 1 - p;  // p's strong_weak partner
  __nv_bfloat16* out = table + row * c;
  float rmin = INFINITY;
  for (int q = lane; q < c; q += 32) {
    const PairOut o = repro::pair_from_root(y, g_i, gb[q], k, oma);
    const float comp =
        fmaxf(__fadd_rn(t_i, __fdiv_rn(s, fmaxf(o.r_i, eps))),
              __fadd_rn(tb[q], __fdiv_rn(s, fmaxf(o.r_j, eps))));
    out[q] = __float2bfloat16_rn(comp);
    if (q != p) rmin = fminf(rmin, comp);
    if (p < m && q == q_sw) anti[b * m + p] = comp;
  }
  for (int off = 16; off > 0; off >>= 1)
    rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, off));
  if (lane == 0) row_min[row] = rmin;
}

__global__ void planner_tsw_kernel(const float* __restrict__ anti,
                                   float* __restrict__ t_sw, int64_t batch,
                                   int m) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= batch) return;
  float v = m > 0 ? -INFINITY : 0.0f;
  for (int p = 0; p < m; ++p) v = fmaxf(v, anti[b * m + p]);
  t_sw[b] = v;
}

}  // namespace

extern "C" int repro_planner(const float* g, const float* t, const float* mb,
                             void* table, float* row_min, float* t_sw,
                             float* anti, int64_t batch, int c,
                             float two_pmax, float four_pmax, float pmax,
                             float n0b, float n0b_sq, float bw,
                             float half_bw, float ln2, float tiny, float eps,
                             int oma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c_pair = c - c % 2;
  const int m = c_pair / 2;
  const int64_t rows = batch * c;
  PairConsts k{two_pmax, four_pmax, pmax, n0b, n0b_sq, bw, half_bw, ln2,
               tiny};
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  planner_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                   st>>>(g, t, mb, static_cast<__nv_bfloat16*>(table),
                         row_min, anti, rows, c, c_pair, m, k, eps, oma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  planner_tsw_kernel<<<static_cast<unsigned>((batch + threads - 1) /
                                             threads),
                       threads, 0, st>>>(anti, t_sw, batch, m);
  return static_cast<int>(cudaGetLastError());
}
