// planner.cu: the fused round-planner tables over gain-sorted candidates.
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
// out, against B c^2 pair evaluations. By the bytes, 2.56 us at B=64,
// c=256 (8.6 MB at 3.35 TB/s). Under NOMA every pair still needs seven
// correctly rounded divides and two log1pf that depend on both users
// (p_j = y*/g_j, the two SINRs, the two rates' / ln 2, the two S/R), each
// a sequence of many instructions, so there the instruction issue is the
// wall: the column loop is 217 SASS instructions a pair for even c (the
// first, two-launch version's: 330, its untaken OMA branch included),
// seven divides of ~11
// (MUFU.RCP, its refinement, FCHK and a slow-path branch) and two log1pf
// of ~30 being most of it (cuobjdump -sass; PERF.md §6). Under OMA
// both rates depend on one gain each, so the table is max(v_p, v_q) of a
// per-candidate v_q = t_q + S / max(R(g_q), 1e-9) and the bytes bound it.
//
// The design (the first version took two launches and a (B, m) scratch):
//
// * One launch a call, no scratch, no atomics. t_sw is a max, exact and
//   independent of order, so it is reduced inside the kernel, in one of
//   two shapes picked on the host:
//   - c <= 32 (the FL and Monte-Carlo c = 10, the policies' c = 32),
//     `planner_small`: a CTA holds min(32 / c, B) whole batch rows, one
//     warp a matrix row and one lane a column, so the row's g and t stay in
//     the registers that loaded them (shuffled to the row's lanes). The lane
//     that holds a strong row's anti-diagonal entry puts it in shared
//     memory, and one warp a batch row takes their max.
//   - c > 32 (the engine cell's c = 256), `planner_rows`: a CTA of 8 warps
//     takes 8 matrix rows of one batch row (16 under OMA), so a batch row
//     spans c / 8 CTAs, several waves that even out over the SMs; the
//     staged columns are padded to a multiple of 32, so no lane clamps.
//     The row's first CTA also computes the m anti-diagonal entries itself
//     (m pair evaluations, 1/c of the row's work; the same arithmetic on
//     the same inputs gives the table's bits) and writes t_sw. A
//     thread-block cluster a batch row, each CTA pushing its partial max
//     to rank 0 over distributed shared memory, was as fast (within 4 %)
//     at B=64, c=256 and 1.7-3.8x slower at other B (one wave of large
//     CTAs lands unevenly on the SMs; clusters of 8 did not all fit at
//     once); PERF.md has the numbers.
//   - c > 16384, where a row's g and t pass 128 KB of shared memory:
//     `planner_rows` unstaged, its lanes reading g and t from global
//     memory (the L1 and L2 hold them) and OMA's v computed a pair. The
//     same arithmetic on the same inputs, so the same bits; c is bound
//     only by 2^31 - 1 CTAs (batch * c / 8).
// * What depends on one index is computed once. Under NOMA, per row:
//   y* = `strong_root(g_p)`, p_i g_p and t_p; the per-pair work is
//   `noma_from_strong`, the same intrinsics in the same order as
//   `pair_from_root`, so the three outputs are bitwise the first
//   version's (PERF.md §6). Under OMA, v is computed once a
//   column (a CTA) and the pair is one fmaxf.
// * One column a lane: the divides' slow paths are calls, which keep two
//   independent chains in one lane from overlapping, so a second column a
//   lane only halves the warps. The even lanes store two bf16 at a time
//   (`__nv_bfloat162`, the odd neighbour's by shuffle) when c is even;
//   for odd c, rows start at odd elements and each lane stores its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "pair_math.cuh"

// The constants of a call, converted to fp32 once on the host and passed by
// pointer (kernels/planner.py::PlannerConsts mirrors this layout).
struct PlannerConsts {
  float two_pmax, four_pmax, pmax, n0b, n0b_sq, bw, half_bw, ln2, tiny, eps;
};

namespace {

using repro::PairConsts;

constexpr int kSmallC = 32;   // c up to this: whole batch rows a CTA
constexpr int kRowWarps = 8;  // c > 32: warps a CTA, its matrix rows (NOMA)
constexpr int kOmaRows = 16;  // c > 32: matrix rows a CTA under OMA
constexpr int kMaxStagedC = 16384;  // 128 KB of staged g and t a row

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// comp[p, q] under NOMA from the strong row's y*, p_i g_p and t_p and the
// weak column's g_q and t_q.
__device__ __forceinline__ float noma_comp(float y, float pig, float t_p,
                                           float g_q, float t_q, float s,
                                           const PairConsts& k, float eps) {
  const repro::PairOut o = repro::noma_from_strong(y, pig, g_q, k);
  return fmaxf(__fadd_rn(t_p, __fdiv_rn(s, fmaxf(o.r_i, eps))),
               __fadd_rn(t_q, __fdiv_rn(s, fmaxf(o.r_j, eps))));
}

// v_q = t_q + S / max(R(g_q), eps): under OMA comp[p, q] = max(v_p, v_q).
__device__ __forceinline__ float oma_side(float g_q, float t_q, float s,
                                          const PairConsts& k, float eps) {
  return __fadd_rn(t_q, __fdiv_rn(s, fmaxf(repro::oma_rate(g_q, k), eps)));
}

// A warp's columns q = q0 + lane of row `out`: the bf16 entries (in pairs
// from the even lanes when c is even, so every pair is 4-byte aligned),
// and the row min over q != p folded in. Every lane calls it.
__device__ __forceinline__ void emit(__nv_bfloat16* out, int q, int c, int p,
                                     float comp, float& rmin) {
  const float hi = __shfl_down_sync(0xffffffffu, comp, 1);
  if (q < c) {
    if (c % 2)
      out[q] = __float2bfloat16_rn(comp);
    else if (!(q & 1))
      *reinterpret_cast<__nv_bfloat162*>(out + q) =
          __floats2bfloat162_rn(comp, hi);
    if (q != p) rmin = fminf(rmin, comp);
  }
}

// c <= 32: a warp a matrix row p, lane q its column q; nb <= 32 / c batch
// rows a CTA. The row's g and t stay in the lanes that loaded them. Lane
// c_pair - 1 - p of a strong row's warp holds its anti-diagonal entry.
template <bool kOma>
__global__ void __launch_bounds__(1024)
    planner_small(const float* __restrict__ g, int64_t ldg,
                  const float* __restrict__ t, int64_t ldt,
                  const float* __restrict__ mb, int64_t ldmb,
                  __nv_bfloat16* __restrict__ table,
                  float* __restrict__ row_min, float* __restrict__ t_sw,
                  int64_t batch, int c, PairConsts k, float eps) {
  __shared__ float anti[32];  // by warp: its row's anti-diagonal entry
  const int nb = blockDim.x / (32 * c);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bl = warp / c;
  const int p = warp - bl * c;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * nb;
  const int m = c / 2;
  if (b0 + bl < batch) {  // whole warps
    const int64_t b = b0 + bl;
    const int qc = min(lane, c - 1);  // lanes past c repeat column c - 1
    const float g_q = g[b * ldg + qc];
    const float t_q = t[b * ldt + qc];
    const float s = mb[b * ldmb];
    float comp;
    if (kOma) {
      const float v_q = oma_side(g_q, t_q, s, k, eps);
      comp = fmaxf(__shfl_sync(0xffffffffu, v_q, p), v_q);
    } else {
      const float g_p = __shfl_sync(0xffffffffu, g_q, p);
      const float t_p = __shfl_sync(0xffffffffu, t_q, p);
      comp = noma_comp(repro::strong_root(g_p, k), __fmul_rn(k.pmax, g_p),
                       t_p, g_q, t_q, s, k, eps);
    }
    const int64_t row = b * c + p;
    float rmin = INFINITY;
    emit(table + row * c, lane, c, p, comp, rmin);
    if (p < m && lane == 2 * m - 1 - p) anti[warp] = comp;
    rmin = warp_min(rmin);
    if (lane == 0) row_min[row] = rmin;
  }
  __syncthreads();
  if (warp < nb && b0 + warp < batch) {  // warp bl: batch row bl's t_sw
    const float v = warp_max(lane < m ? anti[warp * c + lane] : -INFINITY);
    if (lane == 0) t_sw[b0 + warp] = m ? v : 0.0f;
  }
}

// c > 32: CTA `chunk` of batch row b takes its matrix rows [chunk * rows,
// chunk * rows + rows), its warps looping over them and their lanes over
// the columns; g and t (OMA: v) of the row are staged in shared memory
// (kStaged), or, for c past kMaxStagedC, read from global memory, where a
// lane past the row repeats column c - 1 and OMA's v is computed a pair.
// The row's first CTA also writes t_sw, from the m anti-diagonal entries
// it computes again itself (the same arithmetic on the same inputs, so the
// same bits as the table's).
template <bool kOma, bool kStaged>
__global__ void __launch_bounds__(32 * kRowWarps)
    planner_rows(const float* __restrict__ g, int64_t ldg,
                 const float* __restrict__ t, int64_t ldt,
                 const float* __restrict__ mb, int64_t ldmb,
                 __nv_bfloat16* __restrict__ table,
                 float* __restrict__ row_min, float* __restrict__ t_sw,
                 int c, int rows, PairConsts k, float eps) {
  // kStaged: g[cp] then t[cp] (OMA: v[cp]), cp = c rounded up to 32
  // columns, the tail zero: a warp's columns need no clamp
  extern __shared__ float stage[];
  __shared__ float warp_part[kRowWarps];
  const int cp = (c + 31) & ~31;
  const int chunks = (c + rows - 1) / rows;
  const int64_t b = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - b * chunks);
  const float s = mb[b * ldmb];
  const float* gb = g + b * ldg;
  const float* tb = t + b * ldt;
  if (kStaged) {
    for (int q = threadIdx.x; q < cp; q += blockDim.x) {
      const float g_q = q < c ? gb[q] : 0.0f;
      const float t_q = q < c ? tb[q] : 0.0f;
      if (kOma) {
        stage[q] = oma_side(g_q, t_q, s, k, eps);
      } else {
        stage[q] = g_q;
        stage[cp + q] = t_q;
      }
    }
    __syncthreads();
  }
  // column q's g, t and (OMA) v
  auto g_at = [&](int q) { return kStaged ? stage[q] : gb[min(q, c - 1)]; };
  auto t_at = [&](int q) {
    return kStaged ? stage[cp + q] : tb[min(q, c - 1)];
  };
  auto v_at = [&](int q) {
    return kStaged ? stage[q]
                   : oma_side(gb[min(q, c - 1)], tb[min(q, c - 1)], s, k,
                              eps);
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p_end = min(c, (chunk + 1) * rows);
  for (int p = chunk * rows + warp; p < p_end; p += kRowWarps) {
    const int64_t row = b * c + p;
    const float x_p = kOma ? v_at(p) : g_at(p);
    const float t_p = kOma ? 0.0f : t_at(p);
    const float y = kOma ? 0.0f : repro::strong_root(x_p, k);
    const float pig = kOma ? 0.0f : __fmul_rn(k.pmax, x_p);
    __nv_bfloat16* out = table + row * c;
    float rmin = INFINITY;
    for (int q = lane; q < cp; q += 32) {
      const float comp =
          kOma ? fmaxf(x_p, v_at(q))
               : noma_comp(y, pig, t_p, g_at(q), t_at(q), s, k, eps);
      emit(out, q, c, p, comp, rmin);
    }
    rmin = warp_min(rmin);
    if (lane == 0) row_min[row] = rmin;
  }
  if (chunk) return;  // whole CTAs

  // t_sw = max over p < m of comp[p, c_pair - 1 - p] (c > 32: m > 0)
  const int c_pair = c - c % 2;
  float v = -INFINITY;
  for (int i = threadIdx.x; i < c_pair / 2; i += blockDim.x) {
    const int j = c_pair - 1 - i;
    if (kOma) {
      v = fmaxf(v, fmaxf(v_at(i), v_at(j)));
    } else {
      v = fmaxf(v, noma_comp(repro::strong_root(g_at(i), k),
                             __fmul_rn(k.pmax, g_at(i)), t_at(i), g_at(j),
                             t_at(j), s, k, eps));
    }
  }
  v = warp_max(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRowWarps; ++w) v = fmaxf(v, warp_part[w]);
    t_sw[b] = v;
  }
}

template <bool kOma, bool kStaged>
cudaError_t launch_rows(int64_t batch, int c, const float* g, int64_t ldg,
                        const float* t, int64_t ldt, const float* mb,
                        int64_t ldmb, __nv_bfloat16* table, float* row_min,
                        float* t_sw, const PairConsts& k, float eps,
                        cudaStream_t stream) {
  const size_t smem = kStaged ? 2 * sizeof(float) * ((c + 31) & ~31) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        planner_rows<kOma, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows = kOma ? kOmaRows : kRowWarps;
  const int64_t chunks = (c + rows - 1) / rows;
  planner_rows<kOma, kStaged><<<static_cast<unsigned>(batch * chunks),
                                32 * kRowWarps, smem, stream>>>(
      g, ldg, t, ldt, mb, ldmb, table, row_min, t_sw, c, rows, k, eps);
  return cudaGetLastError();
}

template <bool kOma>
cudaError_t launch(int64_t batch, int c, const float* g, int64_t ldg,
                   const float* t, int64_t ldt, const float* mb, int64_t ldmb,
                   void* table, float* row_min, float* t_sw,
                   const PlannerConsts& pc, cudaStream_t stream) {
  auto* tab = static_cast<__nv_bfloat16*>(table);
  const PairConsts k{pc.two_pmax, pc.four_pmax, pc.pmax, pc.n0b, pc.n0b_sq,
                     pc.bw,       pc.half_bw,   pc.ln2,  pc.tiny};
  if (c <= kSmallC) {
    const int nb = static_cast<int>(std::min<int64_t>(kSmallC / c, batch));
    planner_small<kOma><<<static_cast<unsigned>((batch + nb - 1) / nb),
                          32 * nb * c, 0, stream>>>(
        g, ldg, t, ldt, mb, ldmb, tab, row_min, t_sw, batch, c, k, pc.eps);
    return cudaGetLastError();
  }
  return c <= kMaxStagedC
             ? launch_rows<kOma, true>(batch, c, g, ldg, t, ldt, mb, ldmb,
                                       tab, row_min, t_sw, k, pc.eps, stream)
             : launch_rows<kOma, false>(batch, c, g, ldg, t, ldt, mb, ldmb,
                                        tab, row_min, t_sw, k, pc.eps,
                                        stream);
}

}  // namespace

// g, t: (batch, c) fp32 rows at strides ldg, ldt (unit column stride);
// S of batch row b is mb[b * ldmb] (ldmb 0: one S for all); table
// (batch, c, c) bf16, row_min (batch, c) and t_sw (batch,) fp32, all
// contiguous. Returns a cudaError_t.
extern "C" int repro_planner(const float* g, int64_t ldg, const float* t,
                             int64_t ldt, const float* mb, int64_t ldmb,
                             void* table, float* row_min, float* t_sw,
                             int64_t batch, int c,
                             const PlannerConsts* consts, int oma,
                             int device, void* stream) {
  // at most 2^31 - 1 CTAs: c / 8 a batch row
  if (batch <= 0 || c <= 0 ||
      batch * ((c + kRowWarps - 1) / kRowWarps) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  err = oma ? launch<true>(batch, c, g, ldg, t, ldt, mb, ldmb, table,
                           row_min, t_sw, *consts, st)
            : launch<false>(batch, c, g, ldg, t, ldt, mb, ldmb, table,
                            row_min, t_sw, *consts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
