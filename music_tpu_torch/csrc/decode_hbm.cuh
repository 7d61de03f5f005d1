// The int8 modes of the weight-streaming fused decode shared by
// wavenet_decode_hbm.cu (the WaveNet decode, AE = false) and
// wavenet_ae_decode_hbm.cu (the autoencoder's conditioned decode, AE =
// true).  Each source's note says which TPU kernel it replaces and what
// bounds it.  Their working-dtype mode (mode 0) runs on the resident body
// with per-layer skip (decode_resident.cuh, LAYER_SKIP); hbm_entry routes
// each mode to its body.
//
// Design: one thread block per tile of S streams, the step loop inside
// the block, the weights and one ring per layer in device memory,
// activations in shared memory, every product over the whole block with
// split partial sums and a barrier, with what the scaled models need:
//
// - the skip projection is accumulated layer by layer into skip_acc [S, Cs]
//   (f32), and the block holds only the current layer's tap, so the
//   shared-memory carve no longer grows with L.  The carve is computed by
//   the Python wrapper (kernels/wavenet_decode_hbm.py::smem_layout) and
//   passed in Args; the wrapper refuses a tile it does not fit;
// - each layer reads its ring tap and writes its input into the same slot
//   in one pass, the same element by the same thread, so a read always
//   precedes the write of its slot (no prefetch, so no race for any d);
// - int8 weights with f32 scale rows per output column applied after the
//   product, activations in the working dtype (mode 1);
// - with Q8 (WaveNet only) the products are s8 x s8 sums in int32, plain
//   integer multiply-adds over int8 weights and int32 activation codes:
//   tap and x rows quantized per row (dynamic max|v| / 127, or a static
//   scale per layer), z as round(z * 127), h and h2 per row again.
//
// The scale multiplies and the adds that follow them use __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA: the plain version
// (torch) rounds the product first, as the TPU kernel does.

#pragma once

#include "decode_common.cuh"
#include "decode_resident.cuh"

namespace decode {

template <>
struct Num<int8_t> {
  static __device__ __forceinline__ float load(const int8_t* p) { return (float)*p; }
};

constexpr float kInv127 = (float)(1.0 / 127.0);  // f32 of 1/127, as music_tpu's 1.0 / 127.0

// Partial integer sums of out[s][n] = sum_k in[s*ld + k] * W[k*N + n], with
// int8 weights and int32 activation codes; the split of matvec_partial.
template <int S>
__device__ __forceinline__ int matvec_partial_i8(const int* in, int ld, int K,
                                                 const int8_t* __restrict__ W, int N,
                                                 int* red) {
  const int tid = threadIdx.x;
  const int splits = N >= kThreads ? 1 : kThreads / N;
  const int kc = (K + splits - 1) / splits;
  for (int item = tid; item < splits * N; item += kThreads) {
    const int ks = item / N, n = item - ks * N;
    const int k0 = min(K, ks * kc), k1 = min(K, k0 + kc);
    int acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0;
    for (int k = k0; k < k1; ++k) {
      const int w = W[(size_t)k * N + n];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] += in[s * ld + k] * w;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) red[(ks * S + s) * N + n] = acc[s];
  }
  return splits;
}

template <int S>
__device__ __forceinline__ int red_sum_i(const int* red, int splits, int N, int s, int n) {
  int v = 0;
  for (int ks = 0; ks < splits; ++ks) v += red[(ks * S + s) * N + n];
  return v;
}

// int8 codes of one activation row of n values, by one warp: with inv > 0
// (a static scale's inverse) q = round(clip(v * inv)); otherwise the row's
// own scale m / 127, m = max(max|v|, 1e-20), q = round(clip(v * (127 / m))),
// and lane 0 stores the scale (music_tpu's quant_rows).  q may alias v.
__device__ __forceinline__ void quant_row(const float* v, int* q, int n, float inv,
                                          float* scale, int lane) {
  if (inv <= 0.f) {
    float m = 0.f;
    for (int k = lane; k < n; k += 32) m = fmaxf(m, fabsf(v[k]));
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, 1e-20f);
    inv = __fdiv_rn(127.f, m);
    if (lane == 0) *scale = __fmul_rn(m, kInv127);
  }
  for (int k = lane; k < n; k += 32) {
    q[k] = __float2int_rn(fminf(fmaxf(__fmul_rn(v[k], inv), -127.f), 127.f));
  }
}

struct HbmArgs {
  int L, Cr, Cd, Cs, Q, ring_len, n_steps, sample_mode;
  float temperature;
  uint32_t seed;
  int F, pool;        // autoencoder: frames in the tables, pool size
  const int* dil;     // [L] dilations
  const int* s0;      // [B] first token (drawn on the host)
  const int* prev0;   // [B] last prime token
  const int* pos0;    // [B] autoencoder: absolute time of the token of step 0
  int* out;           // [B, n_steps]
  // shared-memory carve, in floats from the base (smem_layout in the wrapper)
  int off_tap, off_xq, off_z, off_acc, off_red_a, off_red_b, off_int;
  uint32_t row0;      // WaveNet: the global row of stream row 0 (Philox key)
};

struct HbmWeights {
  const void *ecur, *eprev;                      // working dtype
  const void *fg, *dense, *skip, *post1, *post2;  // int8
  // int8 weights: per-output-column f32 scales ([L, 2Cd], [L, Cr], [L, Cs],
  // [Cs], [Q]); with Q8 dense and skip already carry the 1/127 of z's codes
  const float *gscale, *dscale, *sscale, *p1scale, *p2scale;
  const float* act_inv;  // Q8 with static scales: [L] f32 inverses; else null
  const void *cond_fg, *cond_post;  // autoencoder: [B, F, L*2Cd], [B, F, Cs]
};

template <typename T, typename WT, int S, bool AE, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
    hbm_decode_kernel(const HbmArgs a, const HbmWeights w, T* __restrict__ ring) {
  static_assert(sizeof(WT) == 1, "int8 weights (the working dtype runs on decode_resident.cuh)");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, Cr = a.Cr, Cd = a.Cd, Cs = a.Cs, Q = a.Q, Cd2 = 2 * a.Cd;
  const T* ecur = static_cast<const T*>(w.ecur);
  const T* eprev = static_cast<const T*>(w.eprev);
  const WT* fg = static_cast<const WT*>(w.fg);
  const WT* dense = static_cast<const WT*>(w.dense);
  const WT* skip = static_cast<const WT*>(w.skip);
  const T* cond_fg = static_cast<const T*>(w.cond_fg);
  const T* cond_post = static_cast<const T*>(w.cond_post);
  float* x = smem;                      // [S][Cr] residual stream
  float* tap = smem + a.off_tap;        // [S][Cr] this layer's ring tap (codes with Q8)
  int* xq = reinterpret_cast<int*>(smem + a.off_xq);  // [S][Cr] codes of x (Q8)
  float* z = smem + a.off_z;            // [S][Cd] gated activation (codes with Q8)
  float* acc = smem + a.off_acc;        // [S][Cs] skip_acc, then h, then h2
  float* red_a = smem + a.off_red_a;    // partials: fg (tap part with Q8), dense; logits
  float* red_b = smem + a.off_red_b;    // partials: skip, post1, post2 (x part of fg)
  int* cur = reinterpret_cast<int*>(smem + a.off_int);  // [S]
  int* prev = cur + S;                                  // [S]
  int* frame = prev + S;                                // [S] this step's frame (AE)
  int* dil = frame + S;                                 // [L]
  int* off = dil + L;                                   // [L] first ring row
  float* rs = reinterpret_cast<float*>(off + L);        // [2][S] row scales (Q8)
  int* ia = reinterpret_cast<int*>(red_a);
  int* ib = reinterpret_cast<int*>(red_b);

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
    if (AE && tid < S) frame[tid] = min((a.pos0[b0 + tid] + t) / a.pool, a.F - 1);
    // embedding of (current, previous) token; layer 0's tap is read from
    // its slot (t mod d: the input of step t - d), then the input written
    const int slot0 = off[0] + t % dil[0];
    for (int idx = tid; idx < S * Cr; idx += kThreads) {
      const int s = idx / Cr, c = idx - s * Cr;
      const float xv = Num<T>::round(Num<T>::load(ecur + cur[s] * Cr + c) +
                                     Num<T>::load(eprev + prev[s] * Cr + c));
      x[idx] = xv;
      T* p = ring_b + ((size_t)s * a.ring_len + slot0) * Cr + c;
      tap[idx] = Num<T>::load(p);
      *p = Num<T>::store(xv);
    }
    for (int idx = tid; idx < S * Cs; idx += kThreads) acc[idx] = 0.f;
    __syncthreads();

    for (int i = 0; i < L; ++i) {
      // filter/gate pre-activation [tap | x] @ fg[i]
      const WT* fg_i = fg + (size_t)i * 2 * Cr * Cd2;
      int sp;
      if constexpr (Q8) {
        const float inv = w.act_inv ? w.act_inv[i] : 0.f;
        for (int s = warp; s < S; s += kWarps) {
          quant_row(tap + s * Cr, reinterpret_cast<int*>(tap) + s * Cr, Cr, inv, rs + s, lane);
          quant_row(x + s * Cr, xq + s * Cr, Cr, inv, rs + S + s, lane);
        }
        __syncthreads();
        sp = matvec_partial_i8<S>(reinterpret_cast<const int*>(tap), Cr, Cr,
                                  reinterpret_cast<const int8_t*>(fg_i), Cd2, ia);
        matvec_partial_i8<S>(xq, Cr, Cr, reinterpret_cast<const int8_t*>(fg_i) + Cr * Cd2,
                             Cd2, ib);
      } else {
        sp = matvec_partial<WT, S>(tap, Cr, Cr, x, Cr, Cr, fg_i, Cd2, red_a);
      }
      __syncthreads();

      // the gate; z in the working dtype, or its int8 code with Q8
      for (int idx = tid; idx < S * Cd; idx += kThreads) {
        const int s = idx / Cd, c = idx - s * Cd;
        float pre[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = h * Cd + c;
          float v;
          if constexpr (Q8) {
            const int at = red_sum_i<S>(ia, sp, Cd2, s, n), ax = red_sum_i<S>(ib, sp, Cd2, s, n);
            v = w.act_inv ? (float)(at + ax)
                          : __fadd_rn(__fmul_rn((float)at, rs[s]), __fmul_rn((float)ax, rs[S + s]));
          } else {
            v = red_sum<S>(red_a, sp, Cd2, s, n);
          }
          v = __fmul_rn(v, w.gscale[i * Cd2 + n]);
          if constexpr (AE) {
            v = __fadd_rn(v, Num<T>::load(cond_fg + ((size_t)(b0 + s) * a.F + frame[s]) * L * Cd2 +
                                          i * Cd2 + n));
          }
          pre[h] = v;
        }
        // WaveNet: tanh(fg[:Cd]) * sigmoid(fg[Cd:]); the autoencoder swaps them
        const float f = AE ? pre[1] : pre[0], g = AE ? pre[0] : pre[1];
        const float zf = tanhf(f) * (1.f / (1.f + expf(-g)));
        if constexpr (Q8) {
          reinterpret_cast<int*>(z)[idx] = __float2int_rn(zf * 127.f);
        } else {
          z[idx] = Num<T>::round(zf);
        }
      }
      __syncthreads();

      // this layer's dense and skip products
      int sk;
      if constexpr (Q8) {
        const int* zq = reinterpret_cast<const int*>(z);
        sp = matvec_partial_i8<S>(zq, Cd, Cd, reinterpret_cast<const int8_t*>(dense) +
                                  (size_t)i * Cd * Cr, Cr, ia);
        sk = matvec_partial_i8<S>(zq, Cd, Cd, reinterpret_cast<const int8_t*>(skip) +
                                  (size_t)i * Cd * Cs, Cs, ib);
      } else {
        sp = matvec_partial<WT, S>(z, Cd, Cd, nullptr, 0, 0, dense + (size_t)i * Cd * Cr, Cr,
                                   red_a);
        sk = matvec_partial<WT, S>(z, Cd, Cd, nullptr, 0, 0, skip + (size_t)i * Cd * Cs, Cs,
                                   red_b);
      }
      __syncthreads();

      // residual update; the next layer's tap read and its input written,
      // as for layer 0; skip accumulation
      const int slot = i + 1 < L ? off[i + 1] + t % dil[i + 1] : 0;
      for (int idx = tid; idx < S * Cr; idx += kThreads) {
        const int s = idx / Cr, c = idx - s * Cr;
        float v = Q8 ? (float)red_sum_i<S>(ia, sp, Cr, s, c) : red_sum<S>(red_a, sp, Cr, s, c);
        v = __fmul_rn(v, w.dscale[i * Cr + c]);
        const float xv = Num<T>::round(__fadd_rn(x[idx], v));
        x[idx] = xv;
        if (i + 1 < L) {
          T* p = ring_b + ((size_t)s * a.ring_len + slot) * Cr + c;
          tap[idx] = Num<T>::load(p);
          *p = Num<T>::store(xv);
        }
      }
      for (int idx = tid; idx < S * Cs; idx += kThreads) {
        const int s = idx / Cs, n = idx - s * Cs;
        float v = Q8 ? (float)red_sum_i<S>(ib, sk, Cs, s, n) : red_sum<S>(red_b, sk, Cs, s, n);
        v = __fmul_rn(v, w.sscale[i * Cs + n]);
        acc[idx] = __fadd_rn(acc[idx], v);
      }
      __syncthreads();
    }

    // post stack: h = relu(skip_acc), h2 = relu(h @ post1 [+ cond_post]),
    // logits = h2 @ post2
    for (int idx = tid; idx < S * Cs; idx += kThreads) {
      acc[idx] = Num<T>::round(fmaxf(acc[idx], 0.f));
    }
    __syncthreads();
    int sp;
    if constexpr (Q8) {
      for (int s = warp; s < S; s += kWarps) {
        quant_row(acc + s * Cs, reinterpret_cast<int*>(acc) + s * Cs, Cs, 0.f, rs + s, lane);
      }
      __syncthreads();
      sp = matvec_partial_i8<S>(reinterpret_cast<const int*>(acc), Cs, Cs,
                                static_cast<const int8_t*>(w.post1), Cs, ib);
    } else {
      sp = matvec_partial<WT, S>(acc, Cs, Cs, nullptr, 0, 0, static_cast<const WT*>(w.post1),
                                 Cs, red_b);
    }
    __syncthreads();
    for (int idx = tid; idx < S * Cs; idx += kThreads) {
      const int s = idx / Cs, n = idx - s * Cs;
      float v;
      if constexpr (Q8) {
        v = __fmul_rn(__fmul_rn((float)red_sum_i<S>(ib, sp, Cs, s, n), rs[s]), w.p1scale[n]);
      } else {
        v = __fmul_rn(red_sum<S>(red_b, sp, Cs, s, n), w.p1scale[n]);
      }
      if constexpr (AE) {
        v = __fadd_rn(v, Num<T>::load(cond_post + ((size_t)(b0 + s) * a.F + frame[s]) * Cs + n));
      }
      acc[idx] = Num<T>::round(fmaxf(v, 0.f));  // h2 over h: post1 has read it
    }
    __syncthreads();
    if constexpr (Q8) {
      for (int s = warp; s < S; s += kWarps) {
        quant_row(acc + s * Cs, reinterpret_cast<int*>(acc) + s * Cs, Cs, 0.f, rs + s, lane);
      }
      __syncthreads();
      sp = matvec_partial_i8<S>(reinterpret_cast<const int*>(acc), Cs, Cs,
                                static_cast<const int8_t*>(w.post2), Q, ib);
    } else {
      sp = matvec_partial<WT, S>(acc, Cs, Cs, nullptr, 0, 0, static_cast<const WT*>(w.post2),
                                 Q, red_b);
    }
    __syncthreads();

    // scores: logits, or logits / temperature + Gumbel noise (as B1)
    float* logits = red_a;
    const int Q4 = Q / 4;
    for (int idx = tid; idx < S * Q4; idx += kThreads) {
      const int s = idx / Q4, j = idx - s * Q4;
      float v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = 4 * j + m;
        if constexpr (Q8) {
          v[m] = __fmul_rn(__fmul_rn((float)red_sum_i<S>(ib, sp, Q, s, n), rs[s]), w.p2scale[n]);
        } else {
          v[m] = __fmul_rn(red_sum<S>(red_b, sp, Q, s, n), w.p2scale[n]);
        }
      }
      if (!AE && a.sample_mode == 1) {
        uint32_t c[4] = {(uint32_t)j, (uint32_t)(t + 1), 0u, 0u};
        philox(c, a.seed, a.row0 + (uint32_t)(b0 + s));
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

template <typename T, typename WT, int S, bool AE, bool Q8>
cudaError_t hbm_launch_one(const HbmArgs& a, const HbmWeights& w, int G, size_t smem,
                           void* ring, cudaStream_t stream) {
  auto kern = hbm_decode_kernel<T, WT, S, AE, Q8>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<G, kThreads, smem, stream>>>(a, w, static_cast<T*>(ring));
  return cudaGetLastError();
}

template <typename T, typename WT, bool AE, bool Q8>
cudaError_t hbm_dispatch_s(int S, const HbmArgs& a, const HbmWeights& w, int G, size_t smem,
                           void* ring, cudaStream_t stream) {
  switch (S) {
    case 1: return hbm_launch_one<T, WT, 1, AE, Q8>(a, w, G, smem, ring, stream);
    case 2: return hbm_launch_one<T, WT, 2, AE, Q8>(a, w, G, smem, ring, stream);
    case 4: return hbm_launch_one<T, WT, 4, AE, Q8>(a, w, G, smem, ring, stream);
    case 8: return hbm_launch_one<T, WT, 8, AE, Q8>(a, w, G, smem, ring, stream);
    case 16: return hbm_launch_one<T, WT, 16, AE, Q8>(a, w, G, smem, ring, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16.  mode: 1 int8 weights, 2 int8 weights and
// int8 products (WaveNet only).
template <typename T, bool AE>
cudaError_t hbm_dispatch_mode(int mode, int S, const HbmArgs& a, const HbmWeights& w, int G,
                              size_t smem, void* ring, cudaStream_t stream) {
  switch (mode) {
    case 1: return hbm_dispatch_s<T, int8_t, AE, false>(S, a, w, G, smem, ring, stream);
    case 2:
      if constexpr (AE) {
        return cudaErrorInvalidValue;
      } else {
        return hbm_dispatch_s<T, int8_t, AE, true>(S, a, w, G, smem, ring, stream);
      }
    default: return cudaErrorInvalidValue;
  }
}

template <bool AE>
cudaError_t hbm_dispatch(int dtype, int mode, int S, const HbmArgs& a, const HbmWeights& w,
                         int G, size_t smem, void* ring, cudaStream_t stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  if (dtype == 0) return hbm_dispatch_mode<float, AE>(mode, S, a, w, G, smem, ring, stream);
  if (dtype == 1) {
    return hbm_dispatch_mode<__nv_bfloat16, AE>(mode, S, a, w, G, smem, ring, stream);
  }
  return cudaErrorInvalidValue;
}

// The device pointers of a launch, in the order of POINTERS in
// kernels/wavenet_decode_hbm.py; null where a kernel takes none (pos0,
// cond_fg, cond_post for WaveNet; act_inv without static scales; the scale
// rows without int8 weights; spans unless the phases are timed).  In mode
// 0, fg and dense are the chain packs (kernels/wavenet_decode.py::chain_packs).
enum HbmPtr {
  kDil, kRing, kS0, kPrev0, kPos0, kEcur, kEprev, kFg, kDense, kSkip, kPost1, kPost2,
  kGscale, kDscale, kSscale, kP1scale, kP2scale, kActInv, kCondFg, kCondPost, kOut, kHbmSpans
};

// What both C entry points do: fill the arguments of the mode's body and
// launch.  dtype: 0 float32, 1 bfloat16.  mode: 0 weights in the working
// dtype (decode_resident.cuh with LAYER_SKIP), 1 int8 weights, 2 int8
// weights and products (WaveNet only).  dims: L, Cr, Cd, Cs, Q, ring_len,
// F, pool (F = pool = 1 for WaveNet), and for WaveNet row0 (the global row
// of the launch's first stream, the Philox key's row).  offs: the carve of
// the mode's body in floats (mode 0: resident_entry's 8, else 7),
// smem_bytes the carve's size.  sample_mode: 0 argmax, 1 categorical.  A spans pointer runs the
// phase-timed build (mode 0, WaveNet, float32, one stream a block).
// Returns the CUDA error code of the launch (0 on success); never
// synchronises.
template <bool AE>
int hbm_entry(int dtype, int mode, int S, int G, const int* dims, const int* offs,
              int smem_bytes, void* const* p, int n_steps, int sample_mode, float temperature,
              uint32_t seed, void* stream) {
  if (mode == 0) {
    void* rp[kResSpans + 1];
    rp[kResDil] = p[kDil];
    rp[kResRing] = p[kRing];
    rp[kResS0] = p[kS0];
    rp[kResPrev0] = p[kPrev0];
    rp[kResPos0] = p[kPos0];
    rp[kResEcur] = p[kEcur];
    rp[kResEprev] = p[kEprev];
    rp[kResFg] = p[kFg];
    rp[kResDense] = p[kDense];
    rp[kResSkip] = p[kSkip];
    rp[kResPost1] = p[kPost1];
    rp[kResPost2] = p[kPost2];
    rp[kResCondFg] = p[kCondFg];
    rp[kResCondPost] = p[kCondPost];
    rp[kResOut] = p[kOut];
    rp[kResSpans] = p[kHbmSpans];
    return resident_entry<AE, true>(dtype, S, G, dims, offs, smem_bytes, rp, n_steps,
                                    sample_mode, temperature, seed, stream);
  }
  if (p[kHbmSpans] != nullptr) return (int)cudaErrorInvalidValue;
  HbmArgs a{};
  a.L = dims[0];
  a.Cr = dims[1];
  a.Cd = dims[2];
  a.Cs = dims[3];
  a.Q = dims[4];
  a.ring_len = dims[5];
  a.F = dims[6];
  a.pool = dims[7];
  if constexpr (!AE) a.row0 = (uint32_t)dims[8];
  a.n_steps = n_steps;
  a.sample_mode = sample_mode;
  a.temperature = temperature;
  a.seed = seed;
  a.dil = static_cast<const int*>(p[kDil]);
  a.s0 = static_cast<const int*>(p[kS0]);
  a.prev0 = static_cast<const int*>(p[kPrev0]);
  a.pos0 = static_cast<const int*>(p[kPos0]);
  a.out = static_cast<int*>(p[kOut]);
  a.off_tap = offs[0];
  a.off_xq = offs[1];
  a.off_z = offs[2];
  a.off_acc = offs[3];
  a.off_red_a = offs[4];
  a.off_red_b = offs[5];
  a.off_int = offs[6];
  HbmWeights w{p[kEcur], p[kEprev], p[kFg], p[kDense], p[kSkip], p[kPost1], p[kPost2],
               static_cast<const float*>(p[kGscale]), static_cast<const float*>(p[kDscale]),
               static_cast<const float*>(p[kSscale]), static_cast<const float*>(p[kP1scale]),
               static_cast<const float*>(p[kP2scale]), static_cast<const float*>(p[kActInv]),
               p[kCondFg], p[kCondPost]};
  return (int)hbm_dispatch<AE>(dtype, mode, S, a, w, G, (size_t)smem_bytes, p[kRing],
                               static_cast<cudaStream_t>(stream));
}

}  // namespace decode
