// probe_kernel: y = x + 1 over a small fp32 array.
//
// Replaces the TPU probe `_probe_kernel` (src/repro/kernels/backend.py:59,
// launched from `compiled_flavor`). It computes nothing the system uses: a
// wrong answer or a failed launch means the hand-written kernels cannot run
// on this card, and the port raises (kernels/backend.py).
//
// Bound on the H100: 8 KiB moved, so launch latency and nothing else.
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" int repro_probe(const float* x, float* y, int n, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}
