// Pieces shared by the fused decode kernels (wavenet_decode.cu,
// wavenet_ae_decode.cu and the weight-streaming kernels of
// decode_hbm.cuh): the working-dtype helpers, the block-wide
// matrix-vector products with float32 accumulation, Philox4x32-10 and the
// per-warp argmax.  All inline device code; each kernel is its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Working-dtype helpers: loads widen to float, round() is the rounding point
// of the TPU kernel's .astype(dtype), store() narrows for the rings.
template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// acc[s] += sum_{k < count} in[s*ld + k] * W[k*N + n]
template <typename T, int S>
__device__ __forceinline__ void accumulate(float (&acc)[S], const float* in, int ld,
                                           const T* __restrict__ W, int N, int n,
                                           int count) {
  int k = 0;
  if ((ld & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    for (; k + 4 <= count; k += 4) {
      const float w0 = Num<T>::load(W + (size_t)(k + 0) * N + n);
      const float w1 = Num<T>::load(W + (size_t)(k + 1) * N + n);
      const float w2 = Num<T>::load(W + (size_t)(k + 2) * N + n);
      const float w3 = Num<T>::load(W + (size_t)(k + 3) * N + n);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(in + s * ld + k);
        acc[s] = fmaf(v.x, w0, acc[s]);
        acc[s] = fmaf(v.y, w1, acc[s]);
        acc[s] = fmaf(v.z, w2, acc[s]);
        acc[s] = fmaf(v.w, w3, acc[s]);
      }
    }
  }
  for (; k < count; ++k) {
    const float w = Num<T>::load(W + (size_t)k * N + n);
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = fmaf(in[s * ld + k], w, acc[s]);
  }
}

// Partial sums of out[s][n] = sum_k [a | b][s][k] * W[k][n] (a: Ka columns,
// b: Kb columns, W: [Ka+Kb, N]).  When N < kThreads the K range is split
// over kThreads / N thread groups; partial ks of (s, n) goes to
// red[(ks*S + s)*N + n].  Returns the split count; after a
// __syncthreads(), red_sum() gives the total.
template <typename T, int S>
__device__ __forceinline__ int matvec_partial(const float* a, int lda, int Ka,
                                              const float* b, int ldb, int Kb,
                                              const T* __restrict__ W, int N,
                                              float* red) {
  const int tid = threadIdx.x;
  const int K = Ka + Kb;
  const int splits = N >= kThreads ? 1 : kThreads / N;
  const int kc = pad4((K + splits - 1) / splits);
  for (int item = tid; item < splits * N; item += kThreads) {
    const int ks = item / N, n = item - ks * N;
    const int k0 = min(K, ks * kc), k1 = min(K, k0 + kc);
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    if (k0 < Ka) accumulate<T, S>(acc, a + k0, lda, W + (size_t)k0 * N, N, n, min(k1, Ka) - k0);
    if (k1 > Ka) {
      const int kb = max(k0, Ka);
      accumulate<T, S>(acc, b + (kb - Ka), ldb, W + (size_t)kb * N, N, n, k1 - kb);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) red[(ks * S + s) * N + n] = acc[s];
  }
  return splits;
}

template <int S>
__device__ __forceinline__ float red_sum(const float* red, int splits, int N, int s, int n) {
  float v = 0.f;
  for (int ks = 0; ks < splits; ++ks) v += red[(ks * S + s) * N + n];
  return v;
}

// Philox4x32-10 (Random123 constants), as music_tpu_torch/ops/philox.py.
__device__ __forceinline__ void philox(uint32_t (&c)[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Index of the largest of v[0..Q) over one warp, the lowest index on ties;
// every lane returns it.
__device__ __forceinline__ int warp_argmax(const float* v, int Q, int lane) {
  float best = 0.f;
  int bi = Q;  // Q marks "no candidate yet"
  for (int q = lane; q < Q; q += 32) {
    if (bi == Q || v[q] > best) {
      best = v[q];
      bi = q;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (oi != Q && (bi == Q || ob > best || (ob == best && oi < bi))) {
      best = ob;
      bi = oi;
    }
  }
  return bi;
}

}  // namespace decode
