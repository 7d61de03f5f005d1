// L2 read probe: how fast can one thread block (one SM) read an array that
// sits in the 50 MB L2?  The resident decode kernels (decode_resident.cuh)
// re-read all their weights from L2 every step on one SM a tile, so this
// rate over their per-step bytes is their one-SM floor.  chip_smoke.py runs
// it on arrays of B1's per-step bytes (5.01 MB f32, 2.51 MB bf16).
//
// One block of 512 threads reads the array `reps` times with 16-byte loads,
// 16 independent loads in flight per thread, and sums what it read (so the
// loads are not dropped); the host times the launch with CUDA events after
// a warm-up launch has brought the array into L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512, kInFlight = 16;

__global__ void __launch_bounds__(kThreads, 1)
    l2_read_kernel(const float4* __restrict__ data, long long n16, int reps, float* out) {
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    long long i = threadIdx.x;
    for (; i + (long long)(kInFlight - 1) * kThreads < n16; i += (long long)kInFlight * kThreads) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) v[u] = __ldcg(data + i + (long long)u * kThreads);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
    for (; i < n16; i += kThreads) {
      const float4 v = __ldcg(data + i);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  out[threadIdx.x] = acc;
}

}  // namespace

// Reads n16 16-byte chunks of `data` reps times on one block; `out` takes
// 512 floats.  Returns the CUDA error code of the launch; never synchronises.
extern "C" int l2_probe(const void* data, long long n16, int reps, void* out, void* stream) {
  cudaGetLastError();
  l2_read_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(data), n16, reps, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
