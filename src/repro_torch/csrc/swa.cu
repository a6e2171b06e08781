// swa_kernel: causal sliding-window attention with GQA and an optional tanh
// softcap. Query i attends keys j with i - W < j <= i:
//
//   s[i, j] = (q_i * 1/sqrt(hd)) . k_j            (fp32)
//   s       = cap * tanh(s / cap)                  (when cap > 0)
//   out_i   = sum_j softmax_j(s[i, :]) v_j         (fp32, cast to q's type)
//
// q (B, S, H, hd), k/v (B, S, KH, hd), all contiguous, fp32 or bf16; query
// head h reads KV head (h % H) / (H / KH), which takes any group size
// (hymba's 25 heads over 5 KV heads, g = 5). The output has q's layout.
//
// Replaces `_swa_kernel` (src/repro/kernels/swa.py:27, launched by
// `swa_pallas` at :110). The Pallas grid walked a fixed number of KV blocks
// per query block, clamped at the left edge and masking the duplicate
// visits; it needed S % bq == 0, W % bk == 0 and bq % bk == 0. Here one
// CTA owns one (b*h, 64-query block) and loops over exactly the keys of
// its band, [max(0, q0 - W + 1), min(q0 + 63, S - 1)], in tiles of 64, so
// there are no duplicate visits and every tail (S, W, the band's edges) is
// masked element by element.
//
// Bound on the H100: 4 * hd operations per (query, key) pair of the band
// against (2 q + 2 kv + 1 out) bf16 reads and writes, so at hymba's prefill
// shape the operations bound it (at the bf16 tensor-core rate). This first
// kernel is plain fp32 on the CUDA cores: Q, K and V tiles in shared memory
// (rows padded by one word against bank conflicts), a 4 x 4 register tile of
// scores per thread, the running softmax (m, l) per row reduced with
// 16-lane shuffles, and a 4 x (hd / 16) register tile of the output. Fully
// masked rows are guarded as in the Pallas kernel (m = -inf -> exp base 0),
// and the output is acc / max(l, 1e-30). Tensor cores (mma / wgmma) and TMA
// are left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads: 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int S, int H,
           int KH, int W, float scale, float cap) {
  constexpr int HP = HD + 1;          // padded row of Q and K
  constexpr int DJ = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][HP], scaled q
  float* ks = qs + BQ * HP;           // [BK][HP]
  float* vs = ks + BK * HP;           // [BK][HD]
  float* ps = vs + BK * HD;           // [BQ][BK + 1] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;            // column lane
  const int ty = tid >> 4;            // row group: rows ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;

  const int64_t q_row = static_cast<int64_t>(H) * HD;     // stride of s in q
  const int64_t kv_row = static_cast<int64_t>(KH) * HD;   // and in k, v
  const T* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qp = q0 + r;
    qs[r * HP + d] = qp < S ? to_f(qb[qp * q_row + d]) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + BQ - 1, S - 1);
  const int lo = max(0, q0 - W + 1);
  for (int k0 = lo; k0 <= q_last; k0 += BK) {
    __syncthreads();                  // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int kp = k0 + r;
      const bool in = kp < S;
      ks[r * HP + d] = in ? to_f(kb[kp * kv_row + d]) : 0.0f;
      vs[r * HD + d] = in ? to_f(vb[kp * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * HP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * HP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool valid[4];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < S && kp <= qp && kp > qp - W;
        float x = s[i][j];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        s[i][j] = x;
        if (valid[j]) row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = isinf(m_new) ? 0.0f : m_new;
      const float corr = isinf(m[i]) ? 0.0f : expf(m[i] - m_safe);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.0f;
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();     // a row's probabilities are written by its own warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + static_cast<int64_t>(b) * S * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(&ob[qp * q_row + tx + 16 * j], acc[i][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KH, int W, float scale, float cap,
                   cudaStream_t stream) {
  constexpr int HP = HD + 1;
  const size_t smem =
      sizeof(float) * (BQ * HP + BK * HP + BK * HD + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  swa_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KH, W, scale,
      cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KH, int W,
                        float scale, float cap, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KH, W, scale, cap, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KH, W, scale, cap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out share it). hd in {16, 64} (the
// reduced and the full hymba); H % KH == 0; W >= 1; cap <= 0: no softcap.
extern "C" int repro_swa(const void* q, const void* k, const void* v,
                         void* out, int dtype, int B, int S, int H, int KH,
                         int hd, int W, float scale, float cap, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, out, B, S, H, KH, W, scale, cap, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KH, W, scale,
                                     cap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
