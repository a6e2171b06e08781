// Building blocks shared by the RWKV6 kernels, the forward (wkv6.cu) and
// its gradient (wkv6_bwd.cu): the chunk of L = 64 steps and its sub-chunks
// of 16, split-precision TF32 products on mma.sync.m16n8k8 (3xTF32),
// ex2, cp.async tile loads, the serial cumulative sum of the log-decays
// (the rounding the plain versions repeat) and the scan over chunks. See
// wkv6.cu's note for the algebra, the overflow argument and the rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int L = 64;          // steps a chunk
constexpr int SUB = 16;        // steps a sub-chunk, one warp's rows
constexpr int NW = L / SUB;    // sub-chunks a chunk
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2^x, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

struct FragA {          // 16 x 8, rows g, g + 8; columns q, q + 4
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

struct FragB {          // 8 x 8, rows q, q + 4; column g
  uint32_t hi[2], lo[2];
  // EXACT: b0, b1 are TF32 numbers already (bf16 values), lo is not used
  template <bool EXACT = false>
  __device__ __forceinline__ void set(float b0, float b1) {
    if (EXACT) {
      hi[0] = __float_as_uint(b0);
      hi[1] = __float_as_uint(b1);
    } else {
      split(b0, hi[0], lo[0]);
      split(b1, hi[1], lo[1]);
    }
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at fp32 accuracy; B_EXACT: b's lo part is zero
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  if (!B_EXACT) mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows x W elements (rows a multiple of 16 bytes) from src (row stride W)
// into dst (row stride `pitch`), by all threads of the CTA; rows >= valid
// are zero-filled
template <int W, typename T>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src, int rows,
                                          int valid) {
  constexpr int PIECES = W * static_cast<int>(sizeof(T)) / 16;
  static_assert(PIECES * 16 == W * static_cast<int>(sizeof(T)), "W");
  for (int e = threadIdx.x; e < rows * PIECES; e += blockDim.x) {
    const int row = e / PIECES, p = e % PIECES;
    char* d = reinterpret_cast<char*>(dst + row * pitch) + 16 * p;
    if (row < valid)
      cp_async16(d, reinterpret_cast<const char*>(src + row * W) + 16 * p);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// 4 consecutive values from shared memory, 16- (fp32) or 8-byte (bf16)
// aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

// shared-memory layout of one chunk, C columns, r/k/v of type E
template <typename E, int C>
struct Tile {
  static constexpr int PE = C + (sizeof(E) == 4 ? 4 : 8);  // r, k, v pitch
  static constexpr int PL = C + 4;                          // lp pitch
  static constexpr int PS = C + 8;                          // S pitch
  static constexpr size_t RKV = sizeof(E) * L * PE;
  static constexpr size_t LP = sizeof(float) * L * PL;
  static constexpr size_t S = sizeof(float) * C * PS;
};

// 2^(min(x, 0) log2(e)) = exp(min(x, 0))
__device__ __forceinline__ float expn(float x) {
  return ex2(fminf(x, 0.0f) * LOG2E);
}

// lp (holding w_log, rows padded with 0) <- base + cumsum(w_log) over its L
// rows, one thread a column adding in series in fp32 (the rounding of the
// plain version's torch.cumsum, see the note); lpp, if given, <- lp - w_log.
// Ends with __syncthreads.
template <int C>
__device__ __forceinline__ void cumsum(float* lp, float* lpp,
                                       const float* base) {
  constexpr int PL = C + 4;
  const int c = threadIdx.x;
  if (c < C) {
    float acc = base ? base[c] : 0.0f;
#pragma unroll 16
    for (int t = 0; t < L; ++t) {
      const float wl = lp[t * PL + c];
      acc = acc + wl;
      lp[t * PL + c] = acc;
      if (lpp) lpp[t * PL + c] = acc - wl;
    }
  }
  __syncthreads();
}

// The scan over chunks, a thread per 4 consecutive d of (b, h, c), as
// float4: in order over j (REVERSE: from the last chunk back), x = st[j];
// st[j] <- s; s = diag(exp(lp_end_j)) s + x, from s = s0; s_out <- s.
// The forward carries the state S (st: the chunks' dS, then their start
// states), the gradient dL/dS (st: the chunks' dG, then their G_end).
// DOT: also dot[j, c] <- exp(lp_end_j) sum_d other[j][c, d] s[c, d], with
// s the value written to st[j] (the gradient's Z = e^{lp_L - base} sum_d
// S_j G_end from the forward's start states), summed over the row's C / 4
// threads by shuffles.
template <int C, bool REVERSE, bool DOT = false>
__device__ __forceinline__ void scan_chunks(
    float* __restrict__ st, const float* __restrict__ lp_end,
    const float* __restrict__ s0, float* __restrict__ s_out, int nch,
    int64_t total, const float* __restrict__ other = nullptr,
    float* __restrict__ dot = nullptr) {
  constexpr int UNROLL = 16;
  constexpr int64_t STEP = C * C / 4;       // float4s a chunk
  const int64_t e = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                         threadIdx.x);
  if (e >= total) return;
  const int64_t bh = e / (C * C);
  const int cd = static_cast<int>(e % (C * C)), c = cd / C;
  float4* p = reinterpret_cast<float4*>(st + bh * nch * C * C + cd);
  const float* dp = lp_end + bh * nch * C + c;
  float4 s = *reinterpret_cast<const float4*>(s0 + e);
  for (int j0 = 0; j0 < nch; j0 += UNROLL) {
    float4 x[UNROLL], o[DOT ? UNROLL : 1];
    float dj[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int j = REVERSE ? nch - 1 - (j0 + i) : j0 + i;
      if (j0 + i < nch) {
        x[i] = p[j * STEP];
        dj[i] = expn(dp[j * C]);
        if constexpr (DOT)
          o[i] = *reinterpret_cast<const float4*>(
              other + (bh * nch + j) * C * C + cd);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int j = REVERSE ? nch - 1 - (j0 + i) : j0 + i;
      if (j0 + i < nch) {
        p[j * STEP] = s;
        if constexpr (DOT) {
          float z = o[i].x * s.x + o[i].y * s.y + o[i].z * s.z +
                    o[i].w * s.w;
#pragma unroll
          for (int m = C / 8; m > 0; m /= 2)
            z += __shfl_xor_sync(0xffffffffu, z, m);
          if (cd % C == 0) dot[(bh * nch + j) * C + c] = dj[i] * z;
        }
        s = make_float4(fmaf(dj[i], s.x, x[i].x), fmaf(dj[i], s.y, x[i].y),
                        fmaf(dj[i], s.z, x[i].z), fmaf(dj[i], s.w, x[i].w));
      }
    }
  }
  *reinterpret_cast<float4*>(s_out + e) = s;
}

}  // namespace
