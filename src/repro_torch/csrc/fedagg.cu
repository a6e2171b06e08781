// fedagg_kernel: FedAvg weighted sum of stacked client updates,
//
//   out[n] = sum_c w[c] * u[c, n]      (fp32 accumulation; u fp32 or bf16)
//
// Replaces `_fedagg_kernel` (src/repro/kernels/fedagg.py:24, launched by
// `fedagg_pallas` at :39), which ran each N-block as a (1, C) x (C, BN) MXU
// matmul over zero-padded blocks.
//
// Bound on the H100: one fp32 multiply-add per input element, so with fp32
// inputs the kernel moves (C + 1) * N * 4 bytes for 2 * C * N operations
// (0.5 op/byte) and the memory rate bounds it by two orders of magnitude.
// The design therefore streams: each thread owns VEC consecutive columns
// (one 16-byte load per row: 4 fp32 or 8 bf16), walks the C rows with the
// weights held in shared memory, accumulates in registers, and writes its
// VEC outputs once. Neighbouring threads read neighbouring 16-byte words,
// so every row is read in full cache lines, once, with an evict-first hint
// (the stream is read once). Nothing is padded: the columns past the last
// whole vector are finished one element per thread. When the rows are not
// 16-byte aligned the wrapper launches the VEC = 1 instantiation instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldcs(p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__global__ void fedagg_kernel(const T* __restrict__ u, int64_t ld,
                              const float* __restrict__ w,
                              float* __restrict__ out, int C, int64_t N) {
  extern __shared__ float ws[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) ws[c] = w[c];
  __syncthreads();

  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nvec = N / VEC;
  for (int64_t t = gid; t < nvec; t += stride) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    const T* p = u + t * VEC;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float v[VEC];
      Loader<T, VEC>::load(p + static_cast<int64_t>(c) * ld, v);
      const float wc = ws[c];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wc, v[k], acc[k]);
    }
    float* o = out + t * VEC;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        *reinterpret_cast<float4*>(o + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = acc[k];
    }
  }
  // masked tail: the N % VEC columns past the last whole vector
  const int64_t tail0 = nvec * VEC;
  if (gid < N - tail0) {
    const int64_t i = tail0 + gid;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(ws[c], to_float(u[static_cast<int64_t>(c) * ld + i]), acc);
    out[i] = acc;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* u, int64_t ld, const float* w, float* out,
                   int C, int64_t N, int sms, cudaStream_t stream) {
  const int threads = 256;
  const int64_t work = N / VEC > 0 ? N / VEC : 1;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  fedagg_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, smem,
                          stream>>>(static_cast<const T*>(u), ld, w, out, C,
                                    N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. vec: 1, or 16 bytes' worth (4 fp32 / 8 bf16),
// which needs 16-byte aligned rows (the wrapper checks).
extern "C" int repro_fedagg(const void* u, int dtype, int vec, int64_t ld,
                            const float* w, float* out, int C, int64_t N,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    err = launch<float, 4>(u, ld, w, out, C, N, sms, s);
  else if (dtype == 0 && vec == 1)
    err = launch<float, 1>(u, ld, w, out, C, N, sms, s);
  else if (dtype == 1 && vec == 8)
    err = launch<__nv_bfloat16, 8>(u, ld, w, out, C, N, sms, s);
  else if (dtype == 1 && vec == 1)
    err = launch<__nv_bfloat16, 1>(u, ld, w, out, C, N, sms, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
