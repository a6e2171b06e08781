// wkv6_bwd: the gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu)
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(w_log_t))
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// from dout (B, H, T, C) and ds_T (B, H, C, C) (null: zero). With
// G_t = dL/dS_t (G_T = ds_T), beta_t = v_t . do_t and a_t = sum_c r u k,
// for t = T .. 1:
//
//   dr_t[c]     = sum_d S_{t-1}[c,d] do_t[d] + u[c] k_t[c] beta_t
//   dk_t[c]     = sum_d G_t[c,d] v_t[d]      + u[c] r_t[c] beta_t
//   dv_t[d]     = sum_c k_t[c] G_t[c,d]      + a_t do_t[d]
//   dw_log_t[c] = w_t[c] sum_d S_{t-1}[c,d] G_t[c,d]
//   du[c]      += r_t[c] k_t[c] beta_t             (over b and t)
//   G_{t-1}     = diag(w_t) G_t + r_t do_t^T,      ds0 = G_0
//
// Every factor is a single step's decay (<= 1): the whole-chunk factorised
// exponent e^{-lp}, which overflows fp32 at the +4 clip (csrc/wkv6.cu's
// note), does not appear.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel, its
// gradient of `rwkv.wkv6_chunked` (src/repro/models/rwkv.py:80) comes from
// JAX's autodiff. It is the backward of the port's `wkv6` under autograd
// (kernels/wkv6.py), so that the ssm family trains on the card.
//
// The forward's scan (`wkv6_scan`) leaves each chunk's start state S_j in
// its scratch (B, H, chunks, C, C) fp32; the wrapper keeps it for the
// backward. Two launches on the caller's stream, deterministic (no
// atomics):
//  (a) `wkv6_bwd_scan`, grid (C / DB, B * H): the state's value columns d
//      evolve independently, so a CTA takes DB = 8 of them, one thread per
//      (c, d). It walks the chunks of L = 64 steps in reverse: loads the
//      chunk's r, k, w (all C) and v, do (its columns) into shared memory,
//      recomputes the 64 per-step states from S_j in registers, then walks
//      back through them carrying G[c, d]. Sums over d (dr, dk, dw) run
//      over the 8 lanes of a row by shuffles; the CTA's partial sums go to
//      scratch (3, C / DB, B * H, T, C) fp32, and du's to (C / DB, B * H,
//      C). dv sums over all c inside the CTA (shuffles over the warp's 4
//      rows, then over the warps through shared memory) and is written
//      whole, as is ds0.
//  (b) `wkv6_bwd_sum`: dr, dk, dw as the sums of the C / DB partials, in
//      block order, and du as the sum over blocks and b.
//
// Bound on the H100 at B = 1, H = 64, T = 4096, C = 64: one read of r, k,
// v, w_log, u, dout, ds_T and one write of dr, dk, dv, dw_log, du, ds0
// (0.40 GB, 0.12 ms at 3.35 TB/s) bounds it. The recurrence's 14 C^2
// operations a step and head (15.0 GFLOP: the recomputed state and G's
// update a multiply and an FMA each, dr, dk, dv, dw_log an FMA each),
// priced as the forward's are, three times over on the TF32 tensor cores
// at 495 TFLOP/s, take 0.09 ms (0.22 ms at the 67 TFLOP/s fp32 rate).
// This kernel runs them in fp32 on the CUDA cores, walks the steps in
// series and adds the partials' round trip (2 x 3 x 8 x 64 MiB at that
// shape); a chunked form on the tensor cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int L = 64;          // steps a chunk: csrc/wkv6.cu's chunk
constexpr int DB = 8;          // value columns a CTA of (a)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int C>
struct Smem {
  static constexpr int NWARP = C * DB / 32;
  static constexpr int RKW = L * C;          // r, k, w and dr, dk, dw
  static constexpr int VO = L * DB;          // v, do: the CTA's columns
  static constexpr int DVP = L * NWARP * DB; // dv's per-warp sums
  static constexpr int FLOATS = 6 * RKW + 2 * VO + DVP + 2 * L + C;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <typename E, int C>
__global__ void __launch_bounds__(C * DB, 1)
wkv6_bwd_scan(const E* __restrict__ r, const E* __restrict__ k,
              const E* __restrict__ v, const float* __restrict__ w_log,
              const float* __restrict__ u, const float* __restrict__ dout,
              const float* __restrict__ ds_t,
              const float* __restrict__ states, E* __restrict__ dv,
              float* __restrict__ ds0, float* __restrict__ part,
              float* __restrict__ du_part, int BH, int H, int T) {
  using Sm = Smem<C>;
  constexpr int NTH = C * DB;
  constexpr int NWARP = Sm::NWARP;
  extern __shared__ float smem[];
  float* rs = smem;                   // [L][C]
  float* ks = rs + Sm::RKW;           // [L][C]
  float* ws = ks + Sm::RKW;           // [L][C] exp(w_log)
  float* drs = ws + Sm::RKW;          // [L][C] this CTA's partial dr
  float* dks = drs + Sm::RKW;         // [L][C]
  float* dws = dks + Sm::RKW;         // [L][C]
  float* vs = dws + Sm::RKW;          // [L][DB]
  float* os = vs + Sm::VO;            // [L][DB] dout
  float* dvp = os + Sm::VO;           // [L][NWARP][DB]
  float* as = dvp + Sm::DVP;          // [L] a_t = sum_c r u k
  float* bs = as + L;                 // [L] beta_t over the CTA's columns
  float* us = bs + L;                 // [C]

  const int tid = threadIdx.x;
  const int c = tid / DB, dl = tid % DB;
  const int lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, bh = blockIdx.y;
  const int h = bh % H;
  const int d = blk * DB + dl;
  const int nch = (T + L - 1) / L;
  const int64_t base = static_cast<int64_t>(bh) * T * C;
  const int64_t cc_off = static_cast<int64_t>(bh) * C * C + c * C + d;
  const int64_t n = static_cast<int64_t>(BH) * T * C;   // one partial
  const int64_t pbase = static_cast<int64_t>(blk) * n + base;
  const int64_t pstride = static_cast<int64_t>(C / DB) * n;

  for (int e = tid; e < C; e += NTH) us[e] = u[h * C + e];
  float G = ds_t != nullptr ? ds_t[cc_off] : 0.0f;
  float du_acc = 0.0f;

  for (int j = nch - 1; j >= 0; --j) {
    const int t0 = j * L;
    const int lc = min(L, T - t0);
    __syncthreads();                  // the previous chunk is consumed
    for (int e = tid; e < L * C; e += NTH) {
      const int i = e / C;
      const bool in = i < lc;
      const int64_t g = base + static_cast<int64_t>(t0) * C + e;
      rs[e] = in ? to_f(r[g]) : 0.0f;
      ks[e] = in ? to_f(k[g]) : 0.0f;
      ws[e] = in ? expf(w_log[g]) : 1.0f;
    }
    for (int e = tid; e < L * DB; e += NTH) {
      const int i = e / DB, dd = e % DB;
      const bool in = i < lc;
      const int64_t g = base + static_cast<int64_t>(t0 + i) * C + blk * DB
                        + dd;
      vs[e] = in ? to_f(v[g]) : 0.0f;
      os[e] = in ? dout[g] : 0.0f;
    }
    __syncthreads();
    if (tid < L) {
      float a = 0.0f, bt = 0.0f;
      for (int x = 0; x < C; ++x)
        a = fmaf(rs[tid * C + x] * us[x], ks[tid * C + x], a);
#pragma unroll
      for (int x = 0; x < DB; ++x)
        bt = fmaf(vs[tid * DB + x], os[tid * DB + x], bt);
      as[tid] = a;
      bs[tid] = bt;
    }

    // the chunk's per-step states: hist[i] = S before step i
    float hist[L];
    float S = states[(static_cast<int64_t>(bh) * nch + j) * C * C
                     + c * C + d];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      hist[i] = S;
      if (i < lc) S = fmaf(ws[i * C + c], S, ks[i * C + c] * vs[i * DB + dl]);
    }
    __syncthreads();                  // as, bs

    const float uc = us[c];
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      if (i >= lc) continue;          // uniform over the CTA
      const float sp = hist[i];
      const float xo = os[i * DB + dl], xv = vs[i * DB + dl];
      const float rc = rs[i * C + c], kc = ks[i * C + c];
      const float wc = ws[i * C + c];
      float pr = sp * xo, pk = G * xv, pw = sp * G, pv = kc * G;
      G = fmaf(wc, G, rc * xo);
#pragma unroll
      for (int off = DB / 2; off > 0; off >>= 1) {   // over d: a row's lanes
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
        pk += __shfl_xor_sync(0xffffffffu, pk, off);
        pw += __shfl_xor_sync(0xffffffffu, pw, off);
      }
#pragma unroll
      for (int off = DB; off < 32; off <<= 1)        // over the warp's rows
        pv += __shfl_xor_sync(0xffffffffu, pv, off);
      if (dl == 0) {
        const float bt = bs[i];
        drs[i * C + c] = fmaf(uc * kc, bt, pr);
        dks[i * C + c] = fmaf(uc * rc, bt, pk);
        dws[i * C + c] = wc * pw;
        du_acc = fmaf(rc * kc, bt, du_acc);
      }
      if (lane < DB) dvp[(i * NWARP + warp) * DB + lane] = pv;
    }
    __syncthreads();
    for (int e = tid; e < lc * C; e += NTH) {
      const int64_t g = pbase + static_cast<int64_t>(t0) * C + e;
      part[g] = drs[e];
      part[pstride + g] = dks[e];
      part[2 * pstride + g] = dws[e];
    }
    for (int e = tid; e < lc * DB; e += NTH) {
      const int i = e / DB, dd = e % DB;
      float sum = as[i] * os[e];
      for (int x = 0; x < NWARP; ++x) sum += dvp[(i * NWARP + x) * DB + dd];
      put(dv + base + static_cast<int64_t>(t0 + i) * C + blk * DB + dd, sum);
    }
  }
  ds0[cc_off] = G;
  if (dl == 0)
    du_part[(static_cast<int64_t>(blk) * BH + bh) * C + c] = du_acc;
}

// dr, dk (in E), dw: sums of the C / DB partials; du (H, C): the sum of
// du_part over the blocks and b
template <typename E, int C>
__global__ void __launch_bounds__(256)
wkv6_bwd_sum(const float* __restrict__ part,
             const float* __restrict__ du_part, E* __restrict__ dr,
             E* __restrict__ dk, float* __restrict__ dw,
             float* __restrict__ du, int64_t n, int B, int H) {
  constexpr int NB = C / DB;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  for (int64_t e = first; e < n; e += stride) {
    float a = 0.0f, b = 0.0f, w = 0.0f;
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      a += part[x * n + e];
      b += part[(NB + x) * n + e];
      w += part[(2 * NB + x) * n + e];
    }
    put(dr + e, a);
    put(dk + e, b);
    dw[e] = w;
  }
  for (int64_t e = first; e < static_cast<int64_t>(H) * C; e += stride) {
    float s = 0.0f;
    for (int x = 0; x < NB; ++x)
      for (int b = 0; b < B; ++b)
        s += du_part[(static_cast<int64_t>(x) * B + b) * H * C + e];
    du[e] = s;
  }
}

template <typename E, int C>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* dout,
                   const float* ds_t, const float* states, void* dr,
                   void* dk, void* dv, float* dw, float* du, float* ds0,
                   float* part, float* du_part, int B, int H, int T,
                   cudaStream_t stream) {
  using Sm = Smem<C>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_scan<E, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sm::BYTES));
  if (err != cudaSuccess) return err;
  wkv6_bwd_scan<E, C><<<dim3(C / DB, B * H), C * DB, Sm::BYTES, stream>>>(
      static_cast<const E*>(r), static_cast<const E*>(k),
      static_cast<const E*>(v), w, u, dout, ds_t, states,
      static_cast<E*>(dv), ds0, part, du_part, B * H, H, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(B) * H * T * C;
  const int64_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  wkv6_bwd_sum<E, C><<<blocks, 256, 0, stream>>>(
      part, du_part, static_cast<E*>(dr), static_cast<E*>(dk), dw, du, n, B,
      H);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_c(int C, const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* dout,
                       const float* ds_t, const float* states, void* dr,
                       void* dk, void* dv, float* dw, float* du, float* ds0,
                       float* part, float* du_part, int B, int H, int T,
                       cudaStream_t s) {
  switch (C) {
    case 16:
      return launch<E, 16>(r, k, v, w, u, dout, ds_t, states, dr, dk, dv, dw,
                           du, ds0, part, du_part, B, H, T, s);
    case 64:
      return launch<E, 64>(r, k, v, w, u, dout, ds_t, states, dr, dk, dv, dw,
                           du, ds0, part, du_part, B, H, T, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v, dr, dk, dv: 0 = fp32, 1 = bf16. C in {16, 64}; B * H <=
// 65535; T >= 1. w (the log-decays), u, dout, ds_t (null: zero), states,
// dw, du, ds0 are fp32; states is the forward's (B, H, chunks, C, C) chunk
// start states, chunks = ceil(T / 64); part (3, C / 8, B, H, T, C) and
// du_part (C / 8, B, H, C) are fp32 scratch.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* dout, const float* ds_t,
                              const float* states, void* dr, void* dk,
                              void* dv, float* dw, float* du, float* ds0,
                              float* part, float* du_part, int dtype, int B,
                              int H, int T, int C, int chunks, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || T <= 0 || static_cast<int64_t>(B) * H > 65535 ||
      chunks != (T + L - 1) / L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_c<float>(C, r, k, v, w, u, dout, ds_t, states, dr, dk, dv,
                            dw, du, ds0, part, du_part, B, H, T, s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, r, k, v, w, u, dout, ds_t, states, dr,
                                    dk, dv, dw, du, ds0, part, du_part, B, H,
                                    T, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
