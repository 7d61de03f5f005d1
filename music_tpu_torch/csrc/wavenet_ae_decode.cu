// Fused conditioned decode of the WaveNet autoencoder for Hopper (sm_90a):
// the whole reconstruction loop in one launch.
//
// Replaces music_tpu/kernels/wavenet_ae_decode.py::_ae_kernel_wrapper, the
// resident Pallas kernel.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_ae_decode.py::decode_reference (same
// weight packs, ring layout, conditioning tables and bf16 rounding points).
//
// Design: that of wavenet_decode.cu -- one thread block per tile of S
// streams (grid = stream groups), the loop over steps inside the block,
// weights in device memory (L2-resident across steps), one ring per layer
// in device memory, activations in shared memory, float32 accumulation --
// plus the autoencoder's conditioning.  Each step every stream computes
// its own frame, min((pos0[b] + t) / pool, F - 1), from its own clock;
// layer i adds row (b, frame) of cond_fg [B, F, L*2Cd] (columns i*2Cd ..)
// to its filter/gate pre-activation, and the post stack adds row (b,
// frame) of cond_post [B, F, Cs] after post1.  Those rows are read from
// device memory where they are added: a row is reused for `pool` steps,
// so it stays in L1/L2, and staging it in shared memory would not fit
// beside 16 streams' activations.  The gate is the autoencoder's:
// tanh(fg[Cd:]) * sigmoid(fg[:Cd]).  Argmax only, lowest index on ties.
//
// Bound: as wavenet_decode.cu, the latency of the dependent L2 weight
// reads and block barriers of 40 sequential layers, far above both the
// FLOP bound (~2.5 MFLOP a stream a step) and the bytes bound (5.08 MB of
// f32 weights once per launch).  The conditioning adds two loads per
// layer per stream that are independent of the products.

#include "decode_common.cuh"

namespace {

using namespace decode;

struct Args {
  int L, Cr, Cd, Cs, Q, ring_len, n_steps, F, pool;
  const int* dil;    // [L] dilations
  const int* s0;     // [B] first token (drawn on the host)
  const int* prev0;  // [B] last prime token
  const int* pos0;   // [B] absolute time of the token consumed at step 0
  int* out;          // [B, n_steps]
  // shared-memory carve, in floats from the base
  int off_zall, off_taps, off_h2, off_logits, off_red, off_int;
};

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 1)
    ae_decode_kernel(const Args a, T* __restrict__ ring, const T* __restrict__ ecur,
                     const T* __restrict__ eprev, const T* __restrict__ fg,
                     const T* __restrict__ dense, const T* __restrict__ skip,
                     const T* __restrict__ post1, const T* __restrict__ post2,
                     const T* __restrict__ cond_fg, const T* __restrict__ cond_post) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, Cr = a.Cr, Cd = a.Cd, Cs = a.Cs, Q = a.Q, LCd = L * Cd;
  const int LCd2 = 2 * LCd;
  float* x = smem;                      // [S][Cr] residual stream
  float* zall = smem + a.off_zall;      // [S][L*Cd] gated activations, layer-major
  float* taps = smem + a.off_taps;      // [L][S][Cr] ring taps of this step
  float* h1 = taps;                     // [S][Cs] (reuses taps after the layers)
  float* h2 = smem + a.off_h2;          // [S][Cs]
  float* logits = smem + a.off_logits;  // [S][Q]
  float* red = smem + a.off_red;        // split partial sums
  int* cur = reinterpret_cast<int*>(smem + a.off_int);  // [S]
  int* prev = cur + S;                                  // [S]
  int* frame = prev + S;                                // [S] this step's frame
  int* dil = frame + S;                                 // [L]
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
    // each stream's frame on its own clock; the embedding of (current,
    // previous) token; every layer's ring tap (slot t mod d holds that
    // layer's input from step t - d)
    if (tid < S) frame[tid] = min((a.pos0[b0 + tid] + t) / a.pool, a.F - 1);
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
        const T* cond = cond_fg + ((size_t)(b0 + s) * a.F + frame[s]) * LCd2 + i * 2 * Cd;
        const float g = red_sum<S>(red, sp, 2 * Cd, s, c) + Num<T>::load(cond + c);
        const float f = red_sum<S>(red, sp, 2 * Cd, s, Cd + c) + Num<T>::load(cond + Cd + c);
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

    // skip projection of all layers at once, then the conditioned post stack
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
      const float c = Num<T>::load(cond_post + ((size_t)(b0 + s) * a.F + frame[s]) * Cs + n);
      h2[idx] = Num<T>::round(fmaxf(red_sum<S>(red, sp, Cs, s, n) + c, 0.f));
    }
    __syncthreads();
    sp = matvec_partial<T, S>(h2, Cs, Cs, nullptr, 0, 0, post2, Q, red);
    __syncthreads();
    for (int idx = tid; idx < S * Q; idx += kThreads) {
      const int s = idx / Q, n = idx - s * Q;
      logits[idx] = red_sum<S>(red, sp, Q, s, n);
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
  return (size_t)a.off_int * sizeof(float) + (size_t)(3 * S + 2 * a.L) * sizeof(int);
}

template <typename T, int S>
cudaError_t launch(const Args& a, int G, size_t smem, void* ring, const void* const* w,
                   cudaStream_t stream) {
  auto kern = ae_decode_kernel<T, S>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<G, kThreads, smem, stream>>>(
      a, static_cast<T*>(ring), static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
      static_cast<const T*>(w[2]), static_cast<const T*>(w[3]), static_cast<const T*>(w[4]),
      static_cast<const T*>(w[5]), static_cast<const T*>(w[6]), static_cast<const T*>(w[7]),
      static_cast<const T*>(w[8]));
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

// dtype: 0 float32, 1 bfloat16.  Returns the CUDA error code of the launch
// (0 on success); never synchronises.
extern "C" int wavenet_ae_decode(int dtype, int S, int G, int L, int Cr, int Cd, int Cs, int Q,
                                 int ring_len, int F, int pool, const void* dil, void* ring,
                                 const void* s0, const void* prev0, const void* pos0,
                                 const void* ecur, const void* eprev, const void* fg,
                                 const void* dense, const void* skip, const void* post1,
                                 const void* post2, const void* cond_fg, const void* cond_post,
                                 int n_steps, void* out, void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  Args a{};
  a.L = L;
  a.Cr = Cr;
  a.Cd = Cd;
  a.Cs = Cs;
  a.Q = Q;
  a.ring_len = ring_len;
  a.n_steps = n_steps;
  a.F = F;
  a.pool = pool;
  a.dil = static_cast<const int*>(dil);
  a.s0 = static_cast<const int*>(s0);
  a.prev0 = static_cast<const int*>(prev0);
  a.pos0 = static_cast<const int*>(pos0);
  a.out = static_cast<int*>(out);
  const size_t smem = layout(a, S);
  const void* w[9] = {ecur, eprev, fg, dense, skip, post1, post2, cond_fg, cond_post};
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

extern "C" const char* wavenet_ae_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
