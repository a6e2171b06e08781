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
// Two launches on the caller's stream, deterministic (no atomics):
//  (a) `swa_bwd_dq`, grid (query tiles, B * H): a first walk over the
//      tile's band recomputes the row max, the row sum and O in fp32 (O is
//      not taken from the forward's output, which bf16 rounded), and
//      writes lse and D into (B, H, S) fp32 scratch; a second walk forms P,
//      dP and dS and accumulates dq.
//  (b) `swa_bwd_dkv`, grid (key tiles, B * KH): for each query head of the
//      group, the query tiles that see the key tile (i in [j, j + W) for a
//      key j >= P, i < j + W for a prefix key) recompute P and dS from
//      (a)'s lse and D, and accumulate dv = P^T dO and dk = dS^T q.
// Both compute the scores with the same loop in the same order from the
// same scaled q, so (b)'s P matches (a)'s lse bit for bit.
//
// Tiles: one CTA of 256 threads (16 row groups x 16 column lanes) per 64
// rows (32 at hd 256, so that the four fp32 tiles of a CTA fit in shared
// memory: 140 KB at hd 256, 166 KB at hd 128), fp32 tiles padded by one
// word a row, a 4 x 4 (2 x 2) register tile of scores a thread, as the
// forward's `swa_fp32`. All on the CUDA cores in fp32.
//
// Bound on the H100: per (query, key) pair of the band the gradient needs
// q.k, dO.v, dS k and dS q and P dO, 5 products of hd FMAs (10 hd
// operations, without the O the walk (a) recomputes), against one read of
// q, k, v, dout and one write of dq, dk, dv; at hymba's shape the
// operations bound it. This kernel does 9 products a pair ((a): q.k and
// P v in its first walk, q.k, dO.v and dS k in its second; (b): q.k, dO.v,
// P^T dO and dS^T q) on the CUDA cores at the 67 TFLOP/s fp32 rate; the
// tensor cores (989 TFLOP/s bf16) and a forward that writes lse are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;      // threads: 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* lse, float* dd, int B, int S, int H, int KH,
                     int W, int P, float scale, float cap, cudaStream_t s) {
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

}  // namespace

// dtype: 0 = fp32, 1 = bf16, shared by q, k, v, dout, dq, dk, dv. hd in
// {16, 64, 128, 256}; H % KH == 0; B * H <= 65535; W >= 1; P >= 0 prefix
// positions; cap <= 0: no softcap. lse and dd are (B, H, S) fp32 scratch.
extern "C" int repro_swa_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* lse, float* dd, int dtype, int B, int S,
                             int H, int KH, int hd, int W, int P,
                             float scale, float cap, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
      static_cast<int64_t>(B) * H > 65535 || W < 1 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(hd, q, k, v, dout, dq, dk, dv, lse, dd, B, S, H,
                          KH, W, P, scale, cap, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(hd, q, k, v, dout, dq, dk, dv, lse, dd, B,
                                  S, H, KH, W, P, scale, cap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
