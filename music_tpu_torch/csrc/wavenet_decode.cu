// Fused WaveNet autoregressive decode for Hopper (sm_90a): the whole
// generation loop in one launch.
//
// Replaces music_tpu/kernels/wavenet_decode.py::_decode_kernel, the
// resident Pallas kernel.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_decode.py::decode_reference (same weight
// packs, ring layout, bf16 rounding points and Philox draws).
//
// Design: one thread block per tile of S streams (grid = stream groups),
// the loop over steps inside the block, __syncthreads() between dependent
// stages.  Each step: embed (current, previous) token by row gathers; for
// each of L layers read the ring tap, fg = [tap | x] @ fg[i], z =
// tanh(f) * sigmoid(g), write x into the ring slot, x += z @ dense[i]; then
// h = relu(z_all @ skip), h = relu(h @ post1), logits = h @ post2; argmax
// (lowest index on ties) or Gumbel-max from Philox4x32-10; emit the token.
// Activations (x, z_all, h) live in shared memory; products are FMA loops
// with float32 accumulation; each layer's ring [d_i, Cr] per stream lives
// in device memory.
//
// Bound: L2 -> SM weight traffic.  Weights stay in device memory (5.08 MB
// in f32 at the shipped width, resident in the 50 MB L2 across steps), and
// every block re-reads all of them every step.  On an H100 the step takes
// the same time with f32 and bf16 weights (~147 us for one stream, ~3 us
// of it per layer), so what bounds it is the latency of those reads -- two
// dependent rounds of loads and four barriers per layer -- more than their
// bandwidth.  More streams per block share the reads; more blocks run in
// parallel on other SMs.  A later design attacks it by prefetching the
// next layer's weights during the current one, wider loads, and splitting
// the layers over a thread block cluster (each SM keeping a slice of the
// weights in shared memory).

#include "decode_common.cuh"

namespace {

using namespace decode;

struct Args {
  int L, Cr, Cd, Cs, Q, ring_len, n_steps, sample_mode;
  float temperature;
  uint32_t seed;
  const int* dil;    // [L] dilations
  const int* s0;     // [B] first token (drawn on the host)
  const int* prev0;  // [B] last prime token
  int* out;          // [B, n_steps]
  // shared-memory carve, in floats from the base
  int off_zall, off_taps, off_h2, off_logits, off_red, off_int;
};

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const Args a, T* __restrict__ ring, const T* __restrict__ ecur,
                  const T* __restrict__ eprev, const T* __restrict__ fg,
                  const T* __restrict__ dense, const T* __restrict__ skip,
                  const T* __restrict__ post1, const T* __restrict__ post2) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, Cr = a.Cr, Cd = a.Cd, Cs = a.Cs, Q = a.Q, LCd = L * Cd;
  float* x = smem;                      // [S][Cr] residual stream
  float* zall = smem + a.off_zall;      // [S][L*Cd] gated activations, layer-major
  float* taps = smem + a.off_taps;      // [L][S][Cr] ring taps of this step
  float* h1 = taps;                     // [S][Cs] (reuses taps after the layers)
  float* h2 = smem + a.off_h2;          // [S][Cs]
  float* logits = smem + a.off_logits;  // [S][Q]
  float* red = smem + a.off_red;        // split partial sums
  int* cur = reinterpret_cast<int*>(smem + a.off_int);  // [S]
  int* prev = cur + S;                                  // [S]
  int* dil = prev + S;                                  // [L]
  int* off = dil + L;                                   // [L] first ring row

  const int b0 = blockIdx.x * S;
  T* ring_b = ring + (size_t)b0 * a.ring_len * Cr;
  if (tid < S) {
    cur[tid] = a.s0[b0 + tid];
    prev[tid] = a.prev0[b0 + tid];
    a.out[(size_t)(b0 + tid) * a.n_steps] = cur[tid];
  }
  if (tid == 0) {
    int o = 0;
    for (int i = 0; i < L; ++i) {
      dil[i] = a.dil[i];
      off[i] = o;
      o += dil[i];
    }
  }
  __syncthreads();

  for (int t = 0; t + 1 < a.n_steps; ++t) {
    // embedding of (current, previous) token, and every layer's ring tap:
    // slot t mod d holds that layer's input from step t - d
    for (int idx = tid; idx < S * Cr; idx += kThreads) {
      const int s = idx / Cr, c = idx - s * Cr;
      x[idx] = Num<T>::round(Num<T>::load(ecur + cur[s] * Cr + c) +
                             Num<T>::load(eprev + prev[s] * Cr + c));
    }
    for (int idx = tid; idx < L * S * Cr; idx += kThreads) {
      const int i = idx / (S * Cr), r = idx - i * S * Cr, s = r / Cr, c = r - s * Cr;
      taps[idx] = Num<T>::load(ring_b + ((size_t)s * a.ring_len + off[i] + t % dil[i]) * Cr + c);
    }
    __syncthreads();

    for (int i = 0; i < L; ++i) {
      // the tap of this slot was read above: overwrite it with the input
      const int slot = off[i] + t % dil[i];
      for (int idx = tid; idx < S * Cr; idx += kThreads) {
        const int s = idx / Cr, c = idx - s * Cr;
        ring_b[((size_t)s * a.ring_len + slot) * Cr + c] = Num<T>::store(x[idx]);
      }
      int sp = matvec_partial<T, S>(taps + i * S * Cr, Cr, Cr, x, Cr, Cr,
                                    fg + (size_t)i * 2 * Cr * 2 * Cd, 2 * Cd, red);
      __syncthreads();
      for (int idx = tid; idx < S * Cd; idx += kThreads) {
        const int s = idx / Cd, c = idx - s * Cd;
        const float f = red_sum<S>(red, sp, 2 * Cd, s, c);
        const float g = red_sum<S>(red, sp, 2 * Cd, s, Cd + c);
        zall[s * LCd + i * Cd + c] = Num<T>::round(tanhf(f) * (1.f / (1.f + expf(-g))));
      }
      __syncthreads();
      sp = matvec_partial<T, S>(zall + i * Cd, LCd, Cd, nullptr, 0, 0,
                                dense + (size_t)i * Cd * Cr, Cr, red);
      __syncthreads();
      for (int idx = tid; idx < S * Cr; idx += kThreads) {
        const int s = idx / Cr, c = idx - s * Cr;
        x[idx] = Num<T>::round(x[idx] + red_sum<S>(red, sp, Cr, s, c));
      }
      __syncthreads();
    }

    // skip projection of all layers at once, then the post stack
    int sp = matvec_partial<T, S>(zall, LCd, LCd, nullptr, 0, 0, skip, Cs, red);
    __syncthreads();
    for (int idx = tid; idx < S * Cs; idx += kThreads) {
      const int s = idx / Cs, n = idx - s * Cs;
      h1[idx] = Num<T>::round(fmaxf(red_sum<S>(red, sp, Cs, s, n), 0.f));
    }
    __syncthreads();
    sp = matvec_partial<T, S>(h1, Cs, Cs, nullptr, 0, 0, post1, Cs, red);
    __syncthreads();
    for (int idx = tid; idx < S * Cs; idx += kThreads) {
      const int s = idx / Cs, n = idx - s * Cs;
      h2[idx] = Num<T>::round(fmaxf(red_sum<S>(red, sp, Cs, s, n), 0.f));
    }
    __syncthreads();
    sp = matvec_partial<T, S>(h2, Cs, Cs, nullptr, 0, 0, post2, Q, red);
    __syncthreads();

    // scores: logits, or logits / temperature + Gumbel noise; four lanes
    // per Philox call, counter (lane block, token index), key (seed, row)
    const int Q4 = Q / 4;
    for (int idx = tid; idx < S * Q4; idx += kThreads) {
      const int s = idx / Q4, j = idx - s * Q4;
      float v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = red_sum<S>(red, sp, Q, s, 4 * j + m);
      if (a.sample_mode == 1) {
        uint32_t c[4] = {(uint32_t)j, (uint32_t)(t + 1), 0u, 0u};
        philox(c, a.seed, (uint32_t)(b0 + s));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float u = __uint_as_float((c[m] >> 9) | 0x3F800000u) - 1.f;
          v[m] = v[m] / a.temperature + (-logf(-logf(u + 1e-20f) + 1e-20f));
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) logits[s * Q + 4 * j + m] = v[m];
    }
    __syncthreads();

    // argmax per stream, one warp each; ties go to the lower index
    for (int s = warp; s < S; s += kWarps) {
      const int bi = warp_argmax(logits + s * Q, Q, lane);
      if (lane == 0) {
        prev[s] = cur[s];
        cur[s] = bi;
        a.out[(size_t)(b0 + s) * a.n_steps + t + 1] = bi;
      }
    }
    __syncthreads();
  }
}

// Shared-memory carve; returns the bytes needed.
size_t layout(Args& a, int S) {
  const int taps = pad4(a.L * S * a.Cr);
  const int post = 2 * pad4(S * a.Cs) + pad4(S * a.Q);
  const int widths[4] = {2 * a.Cd, a.Cr, a.Cs, a.Q};  // every matvec's N
  int max_n = kThreads;
  for (int n : widths) max_n = n > max_n ? n : max_n;
  a.off_zall = pad4(S * a.Cr);
  a.off_taps = a.off_zall + pad4(S * a.L * a.Cd);
  a.off_h2 = a.off_taps + pad4(S * a.Cs);
  a.off_logits = a.off_h2 + pad4(S * a.Cs);
  a.off_red = a.off_taps + (taps > post ? taps : post);
  a.off_int = a.off_red + pad4(S * max_n);
  return (size_t)a.off_int * sizeof(float) + (size_t)(2 * S + 2 * a.L) * sizeof(int);
}

template <typename T, int S>
cudaError_t launch(const Args& a, int G, size_t smem, void* ring, const void* const* w,
                   cudaStream_t stream) {
  auto kern = decode_kernel<T, S>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<G, kThreads, smem, stream>>>(
      a, static_cast<T*>(ring), static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]), static_cast<const T*>(w[4]),
      static_cast<const T*>(w[5]), static_cast<const T*>(w[6]));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int S, const Args& a, int G, size_t smem, void* ring,
                     const void* const* w, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<T, 1>(a, G, smem, ring, w, stream);
    case 2: return launch<T, 2>(a, G, smem, ring, w, stream);
    case 4: return launch<T, 4>(a, G, smem, ring, w, stream);
    case 8: return launch<T, 8>(a, G, smem, ring, w, stream);
    case 16: return launch<T, 16>(a, G, smem, ring, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  sample_mode: 0 argmax, 1 categorical.
// Returns the CUDA error code of the launch (0 on success); never
// synchronises.
extern "C" int wavenet_decode(int dtype, int S, int G, int L, int Cr, int Cd, int Cs, int Q,
                              int ring_len, const void* dil, void* ring, const void* s0,
                              const void* prev0, const void* ecur, const void* eprev,
                              const void* fg, const void* dense, const void* skip,
                              const void* post1, const void* post2, int n_steps,
                              int sample_mode, float temperature, uint32_t seed, void* out,
                              void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  Args a{};
  a.L = L;
  a.Cr = Cr;
  a.Cd = Cd;
  a.Cs = Cs;
  a.Q = Q;
  a.ring_len = ring_len;
  a.n_steps = n_steps;
  a.sample_mode = sample_mode;
  a.temperature = temperature;
  a.seed = seed;
  a.dil = static_cast<const int*>(dil);
  a.s0 = static_cast<const int*>(s0);
  a.prev0 = static_cast<const int*>(prev0);
  a.out = static_cast<int*>(out);
  const size_t smem = layout(a, S);
  const void* w[7] = {ecur, eprev, fg, dense, skip, post1, post2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(S, a, G, smem, ring, w, st);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(S, a, G, smem, ring, w, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" const char* wavenet_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
