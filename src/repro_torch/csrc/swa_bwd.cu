// swa_bwd: the gradient of swa (csrc/swa.cu), causal sliding-window
// attention with GQA, the prefix-LM band and the tanh softcap. With the
// forward's scores s_ij = cap * tanh((q_i . k_j) * scale / cap) (no cap:
// s_ij = (q_i . k_j) * scale) over the band i - W < j, (j <= i or j < P):
//
//   lse_i = log sum_j exp(s_ij)          P_ij = exp(s_ij - lse_i)
//   O_i   = sum_j P_ij v_j               D_i  = dO_i . O_i
//   dP_ij = dO_i . v_j                   dS_ij = P_ij (dP_ij - D_i)
//   dS_ij *= 1 - (s_ij / cap)^2          (the softcap's derivative)
//   dq_i = scale * sum_j dS_ij k_j       dk_j = scale * sum_i dS_ij q_i
//   dv_j = sum_i P_ij dO_i
//
// dk and dv sum over the query heads of the KV head's group. q, dout, dq
// (B, S, H, hd), k, v, dk, dv (B, S, KH, hd), all contiguous and of one
// type, fp32 or bf16; every sum is in fp32.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel, its
// gradients of `layers.flash_attention` (src/repro/models/layers.py:214)
// come from JAX's autodiff of the jnp path. It is the backward of the port's
// `swa` under autograd (kernels/swa.py), so that the hybrid family and the
// windowed dense, moe and vlm models train on the card.
//
// Bound on the H100: per (query, key) pair of the band the gradient needs
// q.k, dO.v, dS k, dS q and P dO, 5 products of hd FMAs (10 hd
// operations), at 989 TFLOP/s for bf16 inputs; against one read of q, k,
// v, dout, the forward's output and lse, one write of dq, dk, dv, and (bf16)
// the D and lse scratch and, under GQA, the fp32 partials of dk and dv
// written and read once. At hymba's and paligemma's training shapes the
// operations bound it.
//
// Which path runs is set by the dtype, as in swa.cu:
//
// bf16 (`swa_bwd_dq_wgmma`, `swa_bwd_dkv_wgmma`, `swa_bwd_group_sum`), the
// training path, on the tensor cores. The forward wrote each row's lse
// under autograd (swa.cu), so nothing of the forward is recomputed. Three
// launches on the caller's stream, deterministic (no atomics: two calls
// give the same bits):
//  (a) dq, one CTA per (b, query head, 64 rows per consumer warpgroup; two
//      warpgroups, one at hd 256) and one producer warp. It first forms
//      D = dO . O in fp32 from dO and the forward's bf16 output, as
//      FlashAttention-2/3 do, and writes D and lse (log2 domain, +inf past
//      S) into (B, H, S rounded up to 64) scratch. Then K and V tiles of 64
//      keys arrive by TMA into a ring of stages, as in `swa_wgmma`; a tile
//      takes S = Q K^T and dP = dO V^T (wgmma, both operands from shared
//      memory, K-major), P = exp2(s scale log2e - lse log2e) (the softcap's
//      tanh first), dS = P (dP - D) (1 - (s/cap)^2) in fp32 registers, and
//      dQ += dS K (wgmma with dS packed to bf16 in the accumulator's layout
//      as the forward packs P, K read with the transpose bit): 3 products a
//      pair. Only the band's edge tiles take the mask.
//  (b) dk, dv, one CTA per (b, query head, key tile) with two consumer
//      warpgroups. The producer loads the K and V tiles once, then walks
//      the query tiles that see them (from query 0 for a prefix key, from
//      the key to key + W - 1 otherwise): Q and dO by TMA, the tile's lse
//      and D from (a)'s scratch by bulk copy. Each takes S^T = K Q^T and
//      dP^T = V dO^T, forms P^T and dS^T in registers, and accumulates
//      dV += P^T dO and dK += dS^T Q with dO and Q read transposed: 4
//      products a pair, dK and dV in fp32 registers for the whole walk.
//      Every product has the shape of one of the forward's two, so its
//      descriptors carry over (csrc/hopper.cuh).
//  (c) the group sum, only when H > KH: (b) writes each query head's dk
//      and dv as fp32 partials (B, S, H, hd), and one short launch sums
//      each KV head's group in a fixed order and writes bf16. When H == KH
//      (b) writes bf16 itself.
// Tiles: 64 rows a consumer warpgroup. At hd 128 and 256 (b)'s dK and dV
// are 128 fp32 registers a thread, so its producer is a warpgroup that
// gives its registers up (setmaxnreg 24, the consumers 240), as swa.cu's
// head_dim-256 forward and FlashAttention-3 do; at hd 256 its two
// warpgroups share one 64-key tile and split dK's and dV's 256 columns
// (128 each), each computing the tile's S^T and dP^T. Every product adds
// its k16 steps' descriptor offsets inside the asm (swa.cu on spills).
//
// What the design does about the four costs of the CUDA-core version
// below, which bf16 took until the forward wrote lse: (1) every product is
// bf16 on the tensor cores with fp32 accumulators; (2) 5 products a pair
// in place of 9 (lse from the forward, D from its output; (a) 3, (b) 4 of
// which q.k and dO.v are repeated); (3) 64-row tiles at every head dim,
// not 32 at hd 256; (4) (b) gives each query head its own CTAs (8x the
// CTAs at paligemma's MQA, 25 x 32 at hymba's shape in place of 5 x 32)
// and moves the group's sum into (c).
//
// fp32 (`swa_bwd_dq`, `swa_bwd_dkv`), the model-level checks' path, on the
// CUDA cores, two launches:
//  (a) `swa_bwd_dq`, grid (query tiles, B * H): a first walk over the
//      tile's band recomputes the row max, the row sum and O in fp32, and
//      writes lse and D into (B, H, S) fp32 scratch; a second walk forms P,
//      dP and dS and accumulates dq.
//  (b) `swa_bwd_dkv`, grid (key tiles, B * KH): for each query head of the
//      group, the query tiles that see the key tile (i in [j, j + W) for a
//      key j >= P, i < j + W for a prefix key) recompute P and dS from
//      (a)'s lse and D, and accumulate dv = P^T dO and dk = dS^T q.
// Both compute the scores with the same loop in the same order from the
// same scaled q, so (b)'s P matches (a)'s lse bit for bit. One CTA of 256
// threads (16 row groups x 16 column lanes) per 64 rows (32 at hd 256, so
// that the four fp32 tiles of a CTA fit in shared memory), fp32 tiles
// padded by one word a row, a 4 x 4 (2 x 2) register tile of scores a
// thread, as the forward's `swa_fp32`: 9 products a pair at the 67 TFLOP/s
// fp32 rate.
#include "hopper.cuh"

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 256;      // threads: 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

template <int HD>
struct Tiles {
  static constexpr int T = HD == 256 ? 32 : 64;   // rows (queries, keys)
  static constexpr int R = T / 16;                // a thread's rows
  static constexpr int HP = HD + 1;               // padded fp32 row
  static constexpr int DJ = HD / 16;              // a thread's columns
  static constexpr int PP = T + 1;                // padded row of P, dS
};

// rows r0 .. r0 + T - 1 of one head of a (B, S, heads, HD) tensor (src at
// (b, 0, head, 0)), times mul, into dst [T][HP] fp32; rows past S are 0
template <int HD, typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          int64_t row, int r0, int S,
                                          float mul) {
  constexpr int T = Tiles<HD>::T, HP = Tiles<HD>::HP;
  for (int e = threadIdx.x; e < T * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int p = r0 + r;
    dst[r * HP + d] = p < S ? to_f(src[p * row + d]) * mul : 0.0f;
  }
}

// s[i][j] = a[ty R + i] . b[tx + 16 j] over HD, in order
template <int HD>
__device__ __forceinline__ void dots(float (&s)[Tiles<HD>::R][Tiles<HD>::R],
                                     const float* a, const float* b, int ty,
                                     int tx) {
  constexpr int R = Tiles<HD>::R, HP = Tiles<HD>::HP;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty * R + i) * HP + d];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * HP + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

__device__ __forceinline__ bool in_band(int qp, int kp, int S, int W,
                                        int P) {
  return qp < S && kp < S && (kp <= qp || kp < P) && kp > qp - W;
}

__device__ __forceinline__ float capped(float x, float cap) {
  return cap > 0.0f ? cap * tanhf(x / cap) : x;
}

// dS from the capped score x, P and dP - D
__device__ __forceinline__ float dscore(float p, float dp_minus_d, float x,
                                        float cap) {
  float g = p * dp_minus_d;
  if (cap > 0.0f) {
    const float t = x / cap;
    g *= 1.0f - t * t;
  }
  return g;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename E, int HD>
__global__ void __launch_bounds__(NT)
swa_bwd_dq(const E* __restrict__ q, const E* __restrict__ k,
           const E* __restrict__ v, const E* __restrict__ dout,
           E* __restrict__ dq, float* __restrict__ lse_out,
           float* __restrict__ dd_out, int S, int H, int KH, int W, int P,
           float scale, float cap) {
  using Ti = Tiles<HD>;
  constexpr int T = Ti::T, R = Ti::R, HP = Ti::HP, DJ = Ti::DJ,
                PP = Ti::PP;
  extern __shared__ float smem[];
  float* qs = smem;                   // [T][HP] q * scale
  float* os = qs + T * HP;            // [T][HP] dO
  float* ks = os + T * HP;            // [T][HP]
  float* vs = ks + T * HP;            // [T][HP]
  float* ps = vs + T * HP;            // [T][PP] P, then dS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * T;
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t kv_row = static_cast<int64_t>(KH) * HD;
  const int64_t qoff = static_cast<int64_t>(b) * S * q_row + h * HD;
  const int64_t kvoff = static_cast<int64_t>(b) * S * kv_row + kvh * HD;

  load_tile<HD>(qs, q + qoff, q_row, q0, S, scale);
  load_tile<HD>(os, dout + qoff, q_row, q0, S, 1.0f);

  const int q_last = min(q0 + T - 1, S - 1);
  const int lo = max(0, q0 - W + 1);
  const int hi = max(q_last, min(P, S) - 1);    // the prefix's keys

  // walk 1: the forward's online softmax, O in fp32
  float m[R], l[R], acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = lo; k0 <= hi; k0 += T) {
    __syncthreads();
    load_tile<HD>(ks, k + kvoff, kv_row, k0, S, 1.0f);
    load_tile<HD>(vs, v + kvoff, kv_row, k0, S, 1.0f);
    __syncthreads();
    float s[R][R];
    dots<HD>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      bool valid[R];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        valid[j] = in_band(qp, k0 + tx + 16 * j, S, W, P);
        s[i][j] = capped(s[i][j], cap);
        if (valid[j]) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = isinf(m_new) ? 0.0f : m_new;
      const float corr = isinf(m[i]) ? 0.0f : expf(m[i] - m_safe);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.0f;
        ps[(ty * R + i) * PP + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * corr + sum16(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();     // a row's P is written and read by its own lanes
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float pv[R], vv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = ps[(ty * R + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * HP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j],
                                                      acc[i][j]);
    }
    __syncwarp();
  }

  // lse and D = dO . O of each row
  float lse[R], dd[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty * R + i;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      part = fmaf(os[row * HP + tx + 16 * j], acc[i][j] * inv, part);
    dd[i] = sum16(part);
    lse[i] = l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
    const int qp = q0 + row;
    if (tx == 0 && qp < S) {
      lse_out[static_cast<int64_t>(bh) * S + qp] = lse[i];
      dd_out[static_cast<int64_t>(bh) * S + qp] = dd[i];
    }
  }

  // walk 2: dS and dq
  float g[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) g[i][j] = 0.0f;
  for (int k0 = lo; k0 <= hi; k0 += T) {
    __syncthreads();
    load_tile<HD>(ks, k + kvoff, kv_row, k0, S, 1.0f);
    load_tile<HD>(vs, v + kvoff, kv_row, k0, S, 1.0f);
    __syncthreads();
    float s[R][R], dp[R][R];
    dots<HD>(s, qs, ks, ty, tx);
    dots<HD>(dp, os, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = capped(s[i][j], cap);
        const float p = in_band(qp, k0 + tx + 16 * j, S, W, P)
                            ? expf(x - lse[i]) : 0.0f;
        ps[(ty * R + i) * PP + tx + 16 * j] =
            dscore(p, dp[i][j] - dd[i], x, cap);
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float sv[R], kv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = ps[(ty * R + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * HP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) g[i][j] = fmaf(sv[i], kv[j], g[i][j]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      put(dq + qoff + qp * q_row + tx + 16 * j, g[i][j] * scale);
  }
}

template <typename E, int HD>
__global__ void __launch_bounds__(NT)
swa_bwd_dkv(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            E* __restrict__ dk, E* __restrict__ dv, int S, int H, int KH,
            int W, int P, float scale, float cap) {
  using Ti = Tiles<HD>;
  constexpr int T = Ti::T, R = Ti::R, HP = Ti::HP, DJ = Ti::DJ,
                PP = Ti::PP;
  extern __shared__ float smem[];
  float* ks = smem;                   // [T][HP]
  float* vs = ks + T * HP;            // [T][HP]
  float* qs = vs + T * HP;            // [T][HP] q * scale
  float* os = qs + T * HP;            // [T][HP] dO
  float* ps = os + T * HP;            // [T][PP] P   (query rows, key cols)
  float* ss = ps + T * PP;            // [T][PP] dS
  float* ls = ss + T * PP;            // [T] lse
  float* ds = ls + T;                 // [T] D

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / KH, kvh = bkv % KH;
  const int G = H / KH;
  const int k0 = blockIdx.x * T;
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t kv_row = static_cast<int64_t>(KH) * HD;
  const int64_t kvoff = static_cast<int64_t>(b) * S * kv_row + kvh * HD;

  load_tile<HD>(ks, k + kvoff, kv_row, k0, S, 1.0f);
  load_tile<HD>(vs, v + kvoff, kv_row, k0, S, 1.0f);

  // the queries that see a key of the tile: from the key (from 0 for a
  // prefix key) to W - 1 past the tile's last key
  const int k_last = min(k0 + T - 1, S - 1);
  const int qlo = k0 < P ? 0 : k0;
  const int qhi = static_cast<int>(
      min(static_cast<int64_t>(S) - 1, static_cast<int64_t>(k_last) + W - 1));

  float gk[R][DJ], gv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.0f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const int64_t qoff = static_cast<int64_t>(b) * S * q_row + h * HD;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* dd_h = dd + (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = qlo; q0 <= qhi; q0 += T) {
      __syncthreads();
      load_tile<HD>(qs, q + qoff, q_row, q0, S, scale);
      load_tile<HD>(os, dout + qoff, q_row, q0, S, 1.0f);
      for (int e = tid; e < T; e += NT) {
        const int qp = q0 + e;
        ls[e] = qp < S ? lse_h[qp] : INFINITY;
        ds[e] = qp < S ? dd_h[qp] : 0.0f;
      }
      __syncthreads();
      // rows: queries ty R + i; columns: keys tx + 16 j
      float s[R][R], dp[R][R];
      dots<HD>(s, qs, ks, ty, tx);
      dots<HD>(dp, os, vs, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = ty * R + i;
        const int qp = q0 + row;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int col = tx + 16 * j;
          const float x = capped(s[i][j], cap);
          const float p = in_band(qp, k0 + col, S, W, P)
                              ? expf(x - ls[row]) : 0.0f;
          ps[row * PP + col] = p;
          ss[row * PP + col] = dscore(p, dp[i][j] - ds[row], x, cap);
        }
      }
      __syncthreads();
      // keys ty R + i, columns tx + 16 j: dv += P^T dO, dk += dS^T q
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        float pc[R], sc[R], oc[DJ], qc[DJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pc[i] = ps[c * PP + ty * R + i];
          sc[i] = ss[c * PP + ty * R + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          oc[j] = os[c * HP + tx + 16 * j];
          qc[j] = qs[c * HP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            gv[i][j] = fmaf(pc[i], oc[j], gv[i][j]);
            gk[i][j] = fmaf(sc[i], qc[j], gk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      put(dk + kvoff + kp * kv_row + tx + 16 * j, gk[i][j]);
      put(dv + kvoff + kp * kv_row + tx + 16 * j, gv[i][j]);
    }
  }
}

template <typename E, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* lse, float* dd, int B, int S, int H, int KH, int W,
                   int P, float scale, float cap, cudaStream_t stream) {
  using Ti = Tiles<HD>;
  constexpr int T = Ti::T;
  const size_t smem_a = sizeof(float) * (4 * T * Ti::HP + T * Ti::PP);
  const size_t smem_b =
      sizeof(float) * (4 * T * Ti::HP + 2 * T * Ti::PP + 2 * T);
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(swa_bwd_dkv<E, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return err;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* oe = static_cast<const E*>(dout);
  swa_bwd_dq<E, HD><<<dim3((S + T - 1) / T, B * H), NT, smem_a, stream>>>(
      qe, ke, ve, oe, static_cast<E*>(dq), lse, dd, S, H, KH, W, P, scale,
      cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  swa_bwd_dkv<E, HD><<<dim3((S + T - 1) / T, B * KH), NT, smem_b, stream>>>(
      qe, ke, ve, oe, lse, dd, static_cast<E*>(dk), static_cast<E*>(dv), S,
      H, KH, W, P, scale, cap);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_fp32(int hd, const void* q, const void* k,
                          const void* v, const void* dout, void* dq, void* dk,
                          void* dv, float* lse, float* dd, int B, int S,
                          int H, int KH, int W, int P, float scale, float cap,
                          cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<E, 16>(q, k, v, dout, dq, dk, dv, lse, dd, B, S, H, KH,
                           W, P, scale, cap, s);
    case 64:
      return launch<E, 64>(q, k, v, dout, dq, dk, dv, lse, dd, B, S, H, KH,
                           W, P, scale, cap, s);
    case 128:
      return launch<E, 128>(q, k, v, dout, dq, dk, dv, lse, dd, B, S, H, KH,
                            W, P, scale, cap, s);
    case 256:
      return launch<E, 256>(q, k, v, dout, dq, dk, dv, lse, dd, B, S, H, KH,
                            W, P, scale, cap, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int WR = 64;       // rows of a warpgroup's accumulator tile
constexpr int TN = 64;       // rows of a streamed tile (keys in (a), queries
                             // in (b))

// A bf16 tile of HD columns is SLABS swizzled slabs of COLS columns side by
// side, as in swa.cu's `Smem`: [rows][COLS] each, 128-byte rows (32 at
// head_dim 16), one TMA box a slab.
template <int HD>
struct Slabs {
  static constexpr int COLS = HD < 64 ? HD : 64;
  static constexpr int SLABS = HD / COLS;
  static constexpr int ROW = COLS * 2;              // bytes of a slab row
  static constexpr uint32_t MODE = ROW == 128 ? 1 : 3;
  static constexpr uint32_t ATOM = 8 * ROW;         // 8 rows of one swizzle
  static constexpr int TILE = TN * HD * 2;          // one streamed tile
  static constexpr int SLAB = TN * ROW;             // one slab of it
};

// d (m64 n64) = A B^T over HD, both K-major: k16 step KK lies in slab
// KK / (COLS / 16), 32 bytes a step along the slab row; ASLAB and BSLAB
// are the two tiles' slab strides. The offsets are added inside the asm
// (wgmma_ss_at), so the steps hold two descriptor registers.
template <int HD, int ASLAB, int BSLAB, int KK = 0>
__device__ __forceinline__ void ss_hd(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  if constexpr (KK < HD / 16) {
    constexpr int CPS = Slabs<HD>::COLS / 16;
    constexpr int SL = KK / CPS, IN = KK % CPS;
    wgmma_ss_at<((SL * ASLAB) >> 4) + 2 * IN, ((SL * BSLAB) >> 4) + 2 * IN>(
        d, a, b, KK > 0);
    ss_hd<HD, ASLAB, BSLAB, KK + 1>(d, a, b);
  }
}

// d (m64 n{64 NSL}) += A (registers, four k16 steps of 16 rows of B) times
// B (a streamed tile, MN-major, read with the transpose bit), over NSL
// slabs of 64 columns from the descriptor's slab on: slab j into d's
// registers 32 j .. 32 j + 31
template <int NSL, int I = 0, int N>
__device__ __forceinline__ void rs_hd(float (&d)[N], const uint32_t (&a)[4][4],
                                      uint64_t b) {
  if constexpr (I < 4 * NSL) {
    constexpr int KK = I / NSL, J = I % NSL;
    wgmma_rs_at<((J * Slabs<64>::SLAB + 16 * 128 * KK) >> 4)>(
        *reinterpret_cast<float(*)[32]>(d + 32 * J), a[KK], b);
    rs_hd<NSL, I + 1>(d, a, b);
  }
}

// the same at head_dim 16 (one slab of 16 columns, 32-byte rows): m64n16
__device__ __forceinline__ void rs_hd16(float (&d)[8],
                                        const uint32_t (&a)[4][4],
                                        uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk], b + ((16 * Slabs<16>::ROW * kk) >> 4));
}

// the k16 steps' A fragments from a 64-column fp32 accumulator, packed to
// bf16 as swa.cu packs P: columns 16 kk .. 16 kk + 15 are registers
// 8 kk .. 8 kk + 7
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// P and dS of one score: x is the score from the wgmma (q . k unscaled),
// l2 the row's lse in the log2 domain, dpd = dP - D. Returns P (0 off the
// band) and sets ds = P (dP - D), times the softcap's derivative.
__device__ __forceinline__ float grad_score(float x, float l2, float dpd,
                                            bool in, float scale_log2,
                                            float cap, float& ds) {
  float p, f = 1.0f;
  if (cap > 0.0f) {
    // the forward's capped score, in the log2 domain (swa.cu)
    const float capl = cap * LOG2E;
    const float t = tanhf(x * (scale_log2 / capl));
    p = ex2(fmaf(capl, t, -l2));
    f = 1.0f - t * t;
  } else {
    p = ex2(fmaf(x, scale_log2, -l2));
  }
  p = in ? p : 0.0f;
  ds = p * f * dpd;
  return p;
}

// (a) dq: one CTA per (b, h, TQ queries), a consumer warpgroup per 64 of
// them, one producer warp. At head_dim 256 one consumer warpgroup (the
// Q and dO tiles and a two-stage ring of K and V are 192 KB).
template <int HD>
struct DqCfg {
  using L = Slabs<HD>;
  static constexpr int NWG = HD == 256 ? 1 : 2;
  static constexpr int TQ = WR * NWG;
  static constexpr int NS = HD == 256 ? 2 : 4;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int QSLAB = TQ * L::ROW;       // slab stride of Q, dO
  static constexpr int Q = 0;                     // SLABS x [TQ][COLS]
  static constexpr int DO = Q + TQ * HD * 2;
  static constexpr int K = DO + TQ * HD * 2;      // NS x SLABS x [TN][COLS]
  static constexpr int V = K + NS * L::TILE;
  static constexpr int ROWS = V + NS * L::TILE;   // [TQ] lse2, [TQ] D
  static constexpr int BAR = ROWS + TQ * 8;       // full[NS], empty[NS], q
  static constexpr int BYTES = BAR + 8 * (2 * NS + 1);
};

template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 1)
swa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ dout,
                 const __nv_bfloat16* __restrict__ out,
                 const float* __restrict__ lse, float* __restrict__ lse2_out,
                 float* __restrict__ dd_out, __nv_bfloat16* __restrict__ dq,
                 int S, int SP, int H, int KH, int W, int P,
                 float scale_log2, float scale, float cap) {
  using C = DqCfg<HD>;
  using L = Slabs<HD>;
  constexpr int NS = C::NS, NWG = C::NWG, TQ = C::TQ;
  static_assert(HD == 16 || HD == 64 || HD == 128 || HD == 256,
                "head_dim 16, 64, 128 or 256");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::BAR;
  const uint32_t empty0 = full0 + 8 * NS;
  const uint32_t qbar = empty0 + 8 * NS;

  // as the forward: the g query heads of one KV head innermost, then the
  // query blocks from the latest (heaviest) down, then (b, kvh)
  const int g = H / KH;
  const int nqb = (S + TQ - 1) / TQ;
  int idx = blockIdx.x;
  const int hg = idx % g;
  idx /= g;
  const int qb = nqb - 1 - idx % nqb;
  idx /= nqb;
  const int kvh = idx % KH;
  const int b = idx / KH;
  const int h = kvh * g + hg;
  const int q0 = qb * TQ;
  const int q_last = min(q0 + TQ - 1, S - 1);
  const int p_last = min(P, S) - 1;
  const int t_lo = max(0, q0 - W + 1) / TN;
  const int n_tiles = max(q_last, p_last) / TN - t_lo + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * NWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // producer: the Q and dO tiles once, then the band's K and V tiles
    if (tid == NWG * 128) {
      mbar_expect_tx(qbar, 2 * TQ * HD * 2);
      for (int j = 0; j < L::SLABS; ++j) {
        const int col = h * HD + j * L::COLS;
        tma_load(base + C::Q + j * C::QSLAB, &qmap, col, q0, b, qbar);
        tma_load(base + C::DO + j * C::QSLAB, &omap, col, q0, b, qbar);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        mbar_wait(empty0 + 8 * st, ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * st, 2 * L::TILE);
        const int k0 = (t_lo + t) * TN;
        for (int j = 0; j < L::SLABS; ++j) {
          const int col = kvh * HD + j * L::COLS;
          tma_load(base + C::K + st * L::TILE + j * L::SLAB, &kmap, col, k0,
                   b, full0 + 8 * st);
          tma_load(base + C::V + st * L::TILE + j * L::SLAB, &vmap, col, k0,
                   b, full0 + 8 * st);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int row = 16 * ((tid / 32) % 4) + lane / 4;   // and row + 8
  const int r0 = q0 + WR * wg;
  const int qp0 = r0 + row, qp1 = qp0 + 8;
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  // D = dO . O of the warpgroup's 64 rows in fp32 from the forward's bf16
  // output, two threads a row, and lse in the log2 domain (+inf past S, so
  // that P is 0 there); both also go to (B, H, SP) scratch for (b)
  float* rows = reinterpret_cast<float*>(smem + C::ROWS);
  {
    const int r = (tid % 128) / 2, half = tid % 2;
    const int qp = r0 + r;
    float part = 0.0f;
    if (qp < S) {
      const int64_t off = (static_cast<int64_t>(b) * S + qp) * q_row +
                          h * HD + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 y = *reinterpret_cast<const uint4*>(out + off + c);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(x2[e]);
          const float2 o = __bfloat1622float2(y2[e]);
          part = fmaf(a.x, o.x, part);
          part = fmaf(a.y, o.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const float l2 = qp < S ? lse[bh * S + qp] * LOG2E : INFINITY;
      rows[WR * wg + r] = l2;
      rows[TQ + WR * wg + r] = part;
      if (qp < SP) {
        lse2_out[bh * SP + qp] = l2;
        dd_out[bh * SP + qp] = part;
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }
  const float l2a = rows[WR * wg + row], l2b = rows[WR * wg + row + 8];
  const float da = rows[TQ + WR * wg + row];
  const float db = rows[TQ + WR * wg + row + 8];

  const int my_lo = max(0, r0 - W + 1) / TN - t_lo;
  const int my_hi =
      r0 < S ? max(min(r0 + WR - 1, S - 1), p_last) / TN - t_lo : -1;
  const uint64_t qdesc = make_desc(base + C::Q + wg * WR * L::ROW, 16,
                                   L::ATOM, L::MODE);
  const uint64_t odesc = make_desc(base + C::DO + wg * WR * L::ROW, 16,
                                   L::ATOM, L::MODE);
  float gq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) gq[i] = 0.0f;
  float s[32] = {}, dp[32] = {};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    mbar_wait(full0 + 8 * st, (t / NS) & 1);
    if (t >= my_lo && t <= my_hi) {
      // S = Q K^T and dP = dO V^T, one commit group
      const uint32_t kt = base + C::K + st * L::TILE;
      const uint32_t vt = base + C::V + st * L::TILE;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_hd<HD, C::QSLAB, L::SLAB>(s, qdesc,
                                   make_desc(kt, 16, L::ATOM, L::MODE));
      ss_hd<HD, C::QSLAB, L::SLAB>(dp, odesc,
                                   make_desc(vt, 16, L::ATOM, L::MODE));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // s[4j + e] is row (e < 2 ? row : row + 8), key k0 + 8j + 2 quad +
      // (e & 1); only the band's edge tiles take the mask
      const int k0 = (t_lo + t) * TN;
      const bool edge = k0 + TN - 1 > r0 || k0 <= r0 + WR - 1 - W ||
                        k0 + TN > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        const bool lo = (i & 2) == 0;
        const bool in = !edge || in_band(lo ? qp0 : qp1, kp, S, W, P);
        float ds;
        grad_score(s[i], lo ? l2a : l2b, dp[i] - (lo ? da : db), in,
                   scale_log2, cap, ds);
        s[i] = ds;
      }
      uint32_t a[4][4];
      pack_frags(a, s);

      // dQ += dS K: K [key][hd] MN-major, read with the transpose bit
      fence_regs(gq);
      wgmma_fence();
      const uint64_t kdesc = make_desc(kt, L::ATOM, L::ATOM, L::MODE);
      if constexpr (HD == 16)
        rs_hd16(gq, a, kdesc);
      else
        rs_hd<L::SLABS>(gq, a, kdesc);
      wgmma_commit();
      wgmma_wait();
      fence_regs(gq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // dq = scale dQ in bf16: register 4j + e is column 8j + 2 quad + (e & 1)
  __nv_bfloat16* d0 = dq + (static_cast<int64_t>(b) * S + qp0) * q_row +
                      h * HD + 2 * quad;
  __nv_bfloat16* d1 = d0 + 8 * q_row;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (qp0 < S)
      *reinterpret_cast<uint32_t*>(d0 + 8 * j) =
          pack_bf16(gq[4 * j] * scale, gq[4 * j + 1] * scale);
    if (qp1 < S)
      *reinterpret_cast<uint32_t*>(d1 + 8 * j) =
          pack_bf16(gq[4 * j + 2] * scale, gq[4 * j + 3] * scale);
  }
}

// (b) dk, dv: one CTA per (b, query head, TKB keys), two consumer
// warpgroups. At head_dim <= 128 each owns 64 keys; at 256 both take the
// same 64 keys and split the 256 columns of dK and dV (128 each), and the
// producer is a warpgroup that gives its registers up (setmaxnreg), as in
// swa.cu at head_dim 256; so also at 128, where dK and dV are 128
// registers a thread.
template <int HD>
struct DkvCfg {
  using L = Slabs<HD>;
  static constexpr bool SPLIT = HD == 256;
  static constexpr bool WGP = HD >= 128;     // producer warpgroup
  static constexpr int NWG = 2;
  static constexpr int TKB = SPLIT ? WR : WR * NWG;
  static constexpr int NC = SPLIT ? HD / 2 : HD;   // columns a warpgroup
  static constexpr int NS = HD == 256 ? 2 : 4;
  static constexpr int THREADS = NWG * 128 + (WGP ? 128 : 32);
  static constexpr int KSLAB = TKB * L::ROW;       // slab stride of K, V
  static constexpr int K = 0;                      // SLABS x [TKB][COLS]
  static constexpr int V = K + TKB * HD * 2;
  static constexpr int Q = V + TKB * HD * 2;       // NS x SLABS x [TN][COLS]
  static constexpr int DO = Q + NS * L::TILE;
  static constexpr int LD = DO + NS * L::TILE;     // NS x ([TN] lse2, [TN] D)
  static constexpr int BAR = LD + NS * TN * 8;     // full[NS], empty[NS], kv
  static constexpr int BYTES = BAR + 8 * (2 * NS + 1);
};

template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::THREADS, 1)
swa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap omap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ lse2, const float* __restrict__ dd,
                  float* __restrict__ dk_part, float* __restrict__ dv_part,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int S, int SP, int H,
                  int KH, int W, int P, float scale_log2, float scale,
                  float cap) {
  using C = DkvCfg<HD>;
  using L = Slabs<HD>;
  constexpr int NS = C::NS, NWG = C::NWG, TKB = C::TKB, NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::BAR;
  const uint32_t empty0 = full0 + 8 * NS;
  const uint32_t kvbar = empty0 + 8 * NS;

  // the key tiles of one (b, h) innermost, so that neighbouring CTAs walk
  // overlapping query tiles of one head
  const int nkt = (S + TKB - 1) / TKB;
  int idx = blockIdx.x;
  const int kt = idx % nkt;
  idx /= nkt;
  const int h = idx % H;
  const int b = idx / H;
  const int kvh = h / (H / KH);
  const int k0 = kt * TKB;
  const int k_last = min(k0 + TKB - 1, S - 1);
  // the query tiles that see a key of the CTA: from the key (from 0 for a
  // prefix key) to W - 1 past the last key
  const int c_lo = (k0 < P ? 0 : k0) / TN;
  const int c_hi = static_cast<int>(min(static_cast<int64_t>(S) - 1,
                                        static_cast<int64_t>(k_last) + W - 1))
                   / TN;
  const int n_tiles = c_hi - c_lo + 1;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * NWG);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // producer: the K and V tiles once, then each query tile's Q, dO and
    // its rows' lse and D (written by (a), padded to SP rows)
    if constexpr (C::WGP)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == NWG * 128) {
      mbar_expect_tx(kvbar, 2 * TKB * HD * 2);
      for (int j = 0; j < L::SLABS; ++j) {
        const int col = kvh * HD + j * L::COLS;
        tma_load(base + C::K + j * C::KSLAB, &kmap, col, k0, b, kvbar);
        tma_load(base + C::V + j * C::KSLAB, &vmap, col, k0, b, kvbar);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        mbar_wait(empty0 + 8 * st, ((t / NS) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * L::TILE + TN * 8);
        const int c0 = (c_lo + t) * TN;
        for (int j = 0; j < L::SLABS; ++j) {
          const int col = h * HD + j * L::COLS;
          tma_load(base + C::Q + st * L::TILE + j * L::SLAB, &qmap, col, c0,
                   b, full);
          tma_load(base + C::DO + st * L::TILE + j * L::SLAB, &omap, col, c0,
                   b, full);
        }
        const uint32_t ld = base + C::LD + st * TN * 8;
        bulk_load(ld, lse2 + bh * SP + c0, TN * 4, full);
        bulk_load(ld + TN * 4, dd + bh * SP + c0, TN * 4, full);
      }
    }
    return;
  }

  if constexpr (C::WGP)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int row = 16 * ((tid / 32) % 4) + lane / 4;   // and row + 8
  // this warpgroup's keys a0 .. a0 + 63 and its columns of dK, dV
  const int a0 = C::SPLIT ? k0 : k0 + WR * wg;
  const int col0 = C::SPLIT ? NC * wg : 0;
  const int kp0 = a0 + row, kp1 = kp0 + 8;
  const int my_lo = (a0 < P ? 0 : a0) / TN - c_lo;
  const int my_hi =
      a0 < S ? static_cast<int>(min(static_cast<int64_t>(S) - 1,
                                    static_cast<int64_t>(a0) + WR + W - 2))
                       / TN - c_lo
             : -1;
  const int arow = C::SPLIT ? 0 : WR * wg;
  const uint64_t kdesc = make_desc(base + C::K + arow * L::ROW, 16, L::ATOM,
                                   L::MODE);
  const uint64_t vdesc = make_desc(base + C::V + arow * L::ROW, 16, L::ATOM,
                                   L::MODE);
  float gk[NC / 2], gv[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) gk[i] = gv[i] = 0.0f;
  float s[32] = {}, dp[32] = {};

  mbar_wait(kvbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    mbar_wait(full0 + 8 * st, (t / NS) & 1);
    if (t >= my_lo && t <= my_hi) {
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      const uint32_t qt = base + C::Q + st * L::TILE;
      const uint32_t ot = base + C::DO + st * L::TILE;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_hd<HD, C::KSLAB, L::SLAB>(s, kdesc,
                                   make_desc(qt, 16, L::ATOM, L::MODE));
      ss_hd<HD, C::KSLAB, L::SLAB>(dp, vdesc,
                                   make_desc(ot, 16, L::ATOM, L::MODE));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // s[4j + e] is key (e < 2 ? kp0 : kp1), query c0 + 8j + 2 quad +
      // (e & 1), whose lse and D the stage holds
      const int c0 = (c_lo + t) * TN;
      const bool edge = !(c0 + TN - 1 < S && a0 + WR - 1 < S &&
                          (a0 + WR - 1 <= c0 || a0 + WR - 1 < P) &&
                          c0 + TN - 1 - W < a0);
      const float* ld = reinterpret_cast<const float*>(
          smem + C::LD + st * TN * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ld + 8 * j + 2 * quad);
        const float2 d2 =
            *reinterpret_cast<const float2*>(ld + TN + 8 * j + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int qp = c0 + 8 * j + 2 * quad + (e & 1);
          const bool in =
              !edge || in_band(qp, (e & 2) ? kp1 : kp0, S, W, P);
          float ds;
          s[i] = grad_score(s[i], (e & 1) ? l2.y : l2.x,
                            dp[i] - ((e & 1) ? d2.y : d2.x), in, scale_log2,
                            cap, ds);
          dp[i] = ds;
        }
      }
      uint32_t pa[4][4], sa[4][4];
      pack_frags(pa, s);
      pack_frags(sa, dp);

      // dV += P^T dO and dK += dS^T Q: dO and Q [query][hd] MN-major, read
      // with the transpose bit, from this warpgroup's first column on
      const uint32_t coff = (col0 / L::COLS) * L::SLAB;
      fence_regs(gv);
      fence_regs(gk);
      wgmma_fence();
      const uint64_t odesc = make_desc(ot + coff, L::ATOM, L::ATOM, L::MODE);
      const uint64_t qdesc = make_desc(qt + coff, L::ATOM, L::ATOM, L::MODE);
      if constexpr (HD == 16) {
        rs_hd16(gv, pa, odesc);
        rs_hd16(gk, sa, qdesc);
      } else {
        rs_hd<NC / 64>(gv, pa, odesc);
        rs_hd<NC / 64>(gk, sa, qdesc);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(gv);
      fence_regs(gk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // dk = scale dK, dv = dV: bf16 into (B, S, KH, hd) when each KV head has
  // one query head, else fp32 partials (B, S, H, hd) for the group sum (c)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= S) continue;
    if (dk_part == nullptr) {
      const int64_t off = (static_cast<int64_t>(b) * S + kp) * KH * HD +
                          kvh * HD + col0 + 2 * quad;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(
            gk[4 * j + 2 * half] * scale, gk[4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(gv[4 * j + 2 * half], gv[4 * j + 2 * half + 1]);
      }
    } else {
      const int64_t off = ((static_cast<int64_t>(b) * S + kp) * H + h) * HD +
                          col0 + 2 * quad;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        *reinterpret_cast<float2*>(dk_part + off + 8 * j) = make_float2(
            gk[4 * j + 2 * half] * scale, gk[4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + off + 8 * j) =
            make_float2(gv[4 * j + 2 * half], gv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// (c) the group sum: dk, dv of KV head kvh = the sum of its g query heads'
// partials in the order h = kvh g, ..., kvh g + g - 1, rounded to bf16
// once; four columns a thread
__global__ void __launch_bounds__(256)
swa_bwd_group_sum(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int64_t n4, int KH, int g,
                  int HD) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const int64_t e = 4 * i;                      // (b s, kvh, d) of dk
  const int d = static_cast<int>(e % HD);
  const int64_t rest = e / HD;
  const int kvh = static_cast<int>(rest % KH);
  const int64_t src = (rest / KH * KH * g + kvh * g) * HD + d;
  float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
  for (int j = 0; j < g; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + src + j * HD);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + src + j * HD);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  uint2 ok, ov;
  ok.x = pack_bf16(sk.x, sk.y);
  ok.y = pack_bf16(sk.z, sk.w);
  ov.x = pack_bf16(sv.x, sv.y);
  ov.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + e) = ok;
  *reinterpret_cast<uint2*>(dv + e) = ov;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* out, const float* lse,
                         void* dq, void* dk, void* dv, float* lse2, float* dd,
                         float* dk_part, float* dv_part, int B, int S, int H,
                         int KH, int W, int P, float scale, float cap,
                         cudaStream_t stream) {
  using A = DqCfg<HD>;
  using Bk = DkvCfg<HD>;
  CUtensorMap qa, oa, ka, va, qb, ob, kb, vb;
  if (!encode(&qa, q, B, S, H, HD, A::TQ) ||
      !encode(&oa, dout, B, S, H, HD, A::TQ) ||
      !encode(&ka, k, B, S, KH, HD, TN) || !encode(&va, v, B, S, KH, HD, TN) ||
      !encode(&qb, q, B, S, H, HD, TN) ||
      !encode(&ob, dout, B, S, H, HD, TN) ||
      !encode(&kb, k, B, S, KH, HD, Bk::TKB) ||
      !encode(&vb, v, B, S, KH, HD, Bk::TKB))
    return cudaErrorInvalidValue;
  const int smem_a = A::BYTES + 1024, smem_b = Bk::BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(swa_bwd_dkv_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return err;
  const int SP = (S + TN - 1) / TN * TN;
  const int64_t ctas_a = static_cast<int64_t>(B) * H * ((S + A::TQ - 1) /
                                                        A::TQ);
  const int64_t ctas_b = static_cast<int64_t>(B) * H * ((S + Bk::TKB - 1) /
                                                        Bk::TKB);
  if (ctas_a > 0x7fffffff || ctas_b > 0x7fffffff)
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  swa_bwd_dq_wgmma<HD><<<static_cast<unsigned>(ctas_a), A::THREADS, smem_a,
                         stream>>>(
      qa, oa, ka, va, static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), lse, lse2, dd,
      static_cast<__nv_bfloat16*>(dq), S, SP, H, KH, W, P, scale_log2, scale,
      cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool grouped = H > KH;
  swa_bwd_dkv_wgmma<HD><<<static_cast<unsigned>(ctas_b), Bk::THREADS, smem_b,
                          stream>>>(
      qb, ob, kb, vb, lse2, dd, grouped ? dk_part : nullptr,
      grouped ? dv_part : nullptr, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, SP, H, KH, W, P, scale_log2, scale,
      cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !grouped) return err;
  const int64_t n4 = static_cast<int64_t>(B) * S * KH * HD / 4;
  swa_bwd_group_sum<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                      stream>>>(dk_part, dv_part,
                                static_cast<__nv_bfloat16*>(dk),
                                static_cast<__nv_bfloat16*>(dv), n4, KH,
                                H / KH, HD);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, shared by q, k, v, dout, out, dq, dk, dv. hd
// in {16, 64, 128, 256}; H % KH == 0; W >= 1; P >= 0 prefix positions;
// cap <= 0: no softcap.
//  fp32: out, lse, dk_part, dv_part null; ws_lse and ws_dd (B, H, S) fp32
//        scratch; B * H <= 65535.
//  bf16: out (B, S, H, hd) and lse (B, H, S) fp32 from the forward
//        (repro_swa with its lse pointer); ws_lse and ws_dd (B, H, S
//        rounded up to 64) fp32 scratch; dk_part and dv_part (B, S, H, hd)
//        fp32 scratch when H > KH (else unused); q, k, v, dout, out 16-byte
//        aligned.
extern "C" int repro_swa_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* out,
                             const float* lse, void* dq, void* dk, void* dv,
                             float* ws_lse, float* ws_dd, float* dk_part,
                             float* dv_part, int dtype, int B, int S, int H,
                             int KH, int hd, int W, int P, float scale,
                             float cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || W < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (static_cast<int64_t>(B) * H > 65535 || out != nullptr ||
        lse != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    err = dispatch_fp32<float>(hd, q, k, v, dout, dq, dk, dv, ws_lse, ws_dd,
                               B, S, H, KH, W, P, scale, cap, s);
  } else if (dtype == 1) {
    if (out == nullptr || lse == nullptr ||
        (H > KH && (dk_part == nullptr || dv_part == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto launch = hd == 256 ? launch_wgmma<256>
                        : hd == 128 ? launch_wgmma<128>
                        : hd == 64 ? launch_wgmma<64>
                        : hd == 16 ? launch_wgmma<16> : nullptr;
    err = launch == nullptr
              ? cudaErrorInvalidValue
              : launch(q, k, v, dout, out, lse, dq, dk, dv, ws_lse, ws_dd,
                       dk_part, dv_part, B, S, H, KH, W, P, scale, cap, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
