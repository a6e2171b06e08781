// wkv6_kernel: the RWKV6 WKV recurrence, chunkwise, with an initial state:
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(w_log_t))
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// r, k, v (B, H, T, C) fp32 or bf16; w_log (B, H, T, C) fp32, <= 0; u (H, C)
// fp32; s0 (B, H, C, C) fp32. Writes out (B, H, T, C) fp32 and the final
// state s_T (B, H, C, C) fp32.
//
// Replaces `_wkv6_kernel` (src/repro/kernels/wkv6.py:36, launched by
// `wkv6_pallas` at :87), which started from a zero state, returned no final
// state and needed T % chunk == 0; the model path (`rwkv.wkv6_chunked`,
// src/repro/models/rwkv.py:80) needs both states. Within a chunk of L steps
// it computes the formulas of `wkv6_chunked` (rwkv.py:96-117):
//
//   lp      = cumsum(w_log), lp_prev = lp - w_log   (sequential fp32 sum,
//             the order of torch.cumsum over a non-innermost dimension)
//   inter   = (r * exp(lp_prev)) @ S
//   A[t, s] = sum_c r_tc k_sc exp(min(lp_prev_tc - lp_sc, 0))    (s < t)
//   A[t, t] = sum_c r_tc u_c k_tc
//   out     = inter + A @ V
//   S      <- diag(exp(lp_L)) S + (K * exp(lp_L - lp))^T V
//
// w_log reaches -exp(4) per step, so lp falls to about -7000 over a chunk of
// 128: the factorised (r e^{lp_prev}) (k e^{-lp})^T form overflows fp32, so A
// keeps the pairwise difference, formed on the fly (no (L, L, C) tensor).
// The tail chunk is padded with zeros (w_log = 0, k = 0 leave the state and
// the cumulative decays unchanged), so T need not be a multiple of L.
//
// Bound on the H100: at least ~5 C^2 fp32 operations per token and head for
// the recurrence, against one read of r, k, v (bf16), w_log, u, s0 and one
// write of out and s_T, so bytes and operations bound it about equally at
// the rwkv6 prefill shape. This first kernel gives one CTA of 512 threads to
// each (b, h) and walks the chunks in order, the (C, C) state and the
// chunk's r, k, v, lp, lp_prev in shared memory (rows padded by one word
// against bank conflicts), A built C rows at a time; it runs B * H CTAs, so
// at B = 1, H = 64 it fills 64 of the 132 SMs. Splitting the chunks over
// CTAs (a state pass, then an output pass) is left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 512;
constexpr int LMAX = 128;     // longest chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E, int C>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_out, int H, int T,
            int L) {
  constexpr int CP = C + 1;             // padded row
  constexpr int RS = NT / C;            // row stride of a thread's rows
  constexpr int MAXR = LMAX / RS;       // rows per thread at most
  extern __shared__ float smem[];
  float* st = smem;                     // [C][C] state
  float* us = st + C * C;               // [C]
  float* rs = us + C;                   // [L][CP]
  float* ks = rs + L * CP;
  float* vs = ks + L * CP;
  float* lp = vs + L * CP;              // inclusive cumulative log-decay
  float* lpp = lp + L * CP;             // exclusive (lp - w_log)
  float* xs = lpp + L * CP;             // scratch: q_dec, A block, k_dec

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int64_t base = static_cast<int64_t>(bh) * T * C;
  const int d = tid % C;                // this thread's output column
  const int r0 = tid / C;               // and first row

  for (int e = tid; e < C * C; e += NT)
    st[e] = s0[static_cast<int64_t>(bh) * C * C + e];
  for (int e = tid; e < C; e += NT) us[e] = u[h * C + e];

  for (int c0 = 0; c0 < T; c0 += L) {
    const int lc = min(L, T - c0);
    __syncthreads();                    // previous chunk fully consumed
    for (int e = tid; e < L * C; e += NT) {
      const int t = e / C, c = e % C;
      const bool in = t < lc;
      const int64_t g = base + static_cast<int64_t>(c0 + t) * C + c;
      rs[t * CP + c] = in ? to_f(r[g]) : 0.0f;
      ks[t * CP + c] = in ? to_f(k[g]) : 0.0f;
      vs[t * CP + c] = in ? to_f(v[g]) : 0.0f;
      lpp[t * CP + c] = in ? w[g] : 0.0f;        // w_log, for the cumsum
    }
    __syncthreads();
    if (tid < C) {
      float acc = 0.0f;
      for (int t = 0; t < L; ++t) {
        const float wl = lpp[t * CP + tid];
        acc += wl;
        lp[t * CP + tid] = acc;
        lpp[t * CP + tid] = acc - wl;
      }
    }
    __syncthreads();

    // inter = (r * exp(lp_prev)) @ S
    for (int e = tid; e < L * C; e += NT) {
      const int t = e / C, c = e % C;
      xs[t * CP + c] = rs[t * CP + c] * expf(lpp[t * CP + c]);
    }
    __syncthreads();
    float inter[MAXR], av[MAXR];
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      inter[i] = 0.0f;
      av[i] = 0.0f;
      const int t = r0 + i * RS;
      if (t < L) {
#pragma unroll 8
        for (int c = 0; c < C; ++c)
          inter[i] = fmaf(xs[t * CP + c], st[c * C + d], inter[i]);
      }
    }

    // A @ V, A built C rows at a time into the scratch
    for (int tb0 = 0; tb0 < L; tb0 += C) {
      const int nb = min(C, L - tb0);
      __syncthreads();                  // scratch free
      for (int e = tid; e < nb * L; e += NT) {
        const int tt = e / L, s = e % L;
        const int t = tb0 + tt;
        if (s > t) continue;
        float a = 0.0f;
        if (s < t) {
#pragma unroll 8
          for (int c = 0; c < C; ++c)
            a = fmaf(rs[t * CP + c] * ks[s * CP + c],
                     expf(fminf(lpp[t * CP + c] - lp[s * CP + c], 0.0f)), a);
        } else {
#pragma unroll 8
          for (int c = 0; c < C; ++c)
            a = fmaf(rs[t * CP + c] * us[c], ks[t * CP + c], a);
        }
        xs[tt * L + s] = a;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        const int t = r0 + i * RS;
        if (t >= tb0 && t < tb0 + nb) {
          const float* arow = xs + (t - tb0) * L;
          for (int s = 0; s <= t; ++s)
            av[i] = fmaf(arow[s], vs[s * CP + d], av[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int t = r0 + i * RS;
      if (t < lc)
        out[base + static_cast<int64_t>(c0 + t) * C + d] = inter[i] + av[i];
    }
    __syncthreads();                    // scratch and state reads done

    // S <- diag(exp(lp_L)) S + (K * exp(lp_L - lp))^T V
    const float* lp_last = lp + (L - 1) * CP;
    for (int e = tid; e < L * C; e += NT) {
      const int s = e / C, c = e % C;
      xs[s * CP + c] = ks[s * CP + c] * expf(lp_last[c] - lp[s * CP + c]);
    }
    __syncthreads();
    for (int e = tid; e < C * C; e += NT) {
      const int c = e / C, dd = e % C;
      float acc = 0.0f;
      for (int s = 0; s < L; ++s)
        acc = fmaf(xs[s * CP + c], vs[s * CP + dd], acc);
      st[e] = expf(lp_last[c]) * st[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < C * C; e += NT)
    s_out[static_cast<int64_t>(bh) * C * C + e] = st[e];
}

template <typename E, int C>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* s_out, int B, int H, int T, int L,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (C * C + C + 6 * static_cast<size_t>(L) * (C + 1));
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<E, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_kernel<E, C><<<B * H, NT, smem, stream>>>(
      static_cast<const E*>(r), static_cast<const E*>(k),
      static_cast<const E*>(v), w, u, s0, out, s_out, H, T, L);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_c(int C, const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* s0,
                       float* out, float* s_out, int B, int H, int T, int L,
                       cudaStream_t s) {
  switch (C) {
    case 16: return launch<E, 16>(r, k, v, w, u, s0, out, s_out, B, H, T, L, s);
    case 64: return launch<E, 64>(r, k, v, w, u, s0, out, s_out, B, H, T, L, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = fp32, 1 = bf16. C in {16, 64} (the reduced and the
// full rwkv6); 1 <= chunk <= 128.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          float* out, float* s_out, int dtype, int B, int H,
                          int T, int C, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || T <= 0 || chunk < 1 || chunk > LMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_c<float>(C, r, k, v, w, u, s0, out, s_out, B, H, T, chunk,
                            s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, r, k, v, w, u, s0, out, s_out, B, H, T,
                                    chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
