// The resident fused decode shared by wavenet_decode.cu (the WaveNet
// decode, AE = false) and wavenet_ae_decode.cu (the autoencoder's
// conditioned decode, AE = true), and, with LAYER_SKIP, by the
// working-dtype mode of the weight-streaming kernels wavenet_decode_hbm.cu
// and wavenet_ae_decode_hbm.cu.  Each source's note says which TPU kernel
// it replaces and what bounds it.
//
// Design: one thread block of 512 threads per tile of S <= 16 streams
// (grid = stream groups), the loop over steps inside the block, weights and
// one ring per layer in device memory (L2-resident across steps).
//
// - The layer chain runs on one warp per stream: warp s < S runs stream s's
//   L layers.  Lane c computes f_c and g_c over [tap | x] (K = 2Cr), gates
//   them in the lane, writes z_c to zall, and after a __syncwarp computes
//   x_c += z @ dense[:, c] (columns c, c + 32, ... when a width exceeds 32).
//   No block barrier sits inside the gate-and-residual arithmetic.  The
//   tap half of [tap | x] @ fg does not depend on the chain: with a spare
//   warp per stream (S <= 8) and 3 or more stages, warp S + s computes
//   stream s's tap half of layer i + 1 while the chain runs layer i, and
//   the chain adds only the x half.
// - A ring of n_stages stages in shared memory holds the chain's operands of
//   one layer each: fg[i] and dense[i] transposed (a row per output column,
//   padded by 16 bytes: kernels/wavenet_decode.py::chain_packs), every
//   stream's ring tap of the layer and, for the autoencoder, its
//   conditioning row.  A lane reads its columns' rows with 16-byte loads.
//   The warps that run neither a chain nor a tap half (all warps at 16
//   streams) copy layer g + n_stages - 1 (counting layers across steps)
//   with 16-byte cp.async.cg while the chain computes layer g; at the top
//   of each layer one cp.async.wait_group and one __syncthreads(): one
//   barrier a layer.  A tap is read into its stage before the layer that
//   owns the slot overwrites it (slot t mod d is written at step t by its
//   own layer, after that layer's stage was complete), and a stage of the
//   next step is copied after the layer that last wrote its slot passed a
//   barrier, so d = 1 and d = 2 read the right rows.
// - skip, post1 and post2 are products over the whole tile with 4 adjacent
//   output columns a lane (8 for bf16 up to 4 streams), read with one
//   16-byte load a row (8-byte for 4 bf16); the lanes of a warp split K
//   and sum their partials with shuffles; each lane keeps 8 row loads in
//   flight (4 at 16 streams).  skip stays one product over zall after the
//   chain, so the rounding points are decode_reference's.
// - LAYER_SKIP (the weight-streaming kernels' working-dtype mode, S <= 4):
//   the skip projection is accumulated layer by layer, skip_acc [S][Cs] +=
//   z_i @ skip_i in float32, as their decode_reference does, in place of
//   one product over zall [S][L*Cd], which the scaled width's carve cannot
//   hold.  The chain writes z_i into a ring of two layers, z [2][S][Cd]
//   (slot i mod 2).  The copying warps, after issuing their copies at the
//   top of layer i, compute layer i - 1's skip product while the chain
//   runs layer i; layer L - 1's runs on the whole block after the last
//   barrier of the step, and the step ends with post alone.  Two slots
//   suffice with one barrier a layer: z_{i-1} is read between barrier i
//   and barrier i + 1, and the chain writes z_{i+1} into its slot only
//   after barrier i + 1.  Each (s, n) of skip_acc belongs to one lane in a
//   layer, which adds the layer's whole sum (its K-split partials summed
//   by shuffles first) with __fadd_rn, in layer order: decode_reference's
//   skip_acc = skip_acc + z @ skip_i.  Layer 0 assigns (0 + v = v), so
//   nothing is zeroed; skip_acc shares its space with h1, and layer L - 1
//   writes h1 = round(relu(skip_acc)) in its place.  The skip product
//   keeps 16 row loads in flight a lane.  With at most 2 streams a block two
//   warps run each stream's chain, each half of a layer's columns, with a
//   named barrier between them once z is written, which halves the chain's
//   time a layer at K = 2Cr = 128.
// - The shipped width (Cr = Cd = 32) has its own instantiation with the
//   widths known at compile time, and with LAYER_SKIP the scaled width
//   (Cr = Cd = 64); other widths read them from Args.
// - The carve (offsets, stage count) is computed by the Python wrapper
//   (kernels/wavenet_decode.py::smem_layout) and passed in; the wrapper
//   refuses a tile that it does not fit.
//
// With SPANS (float, one stream, WaveNet), thread 0 of block 0 (lane 0 of
// the chain warp) sums clock64 cycles per phase (kSpans); with LAYER_SKIP
// its skip phase is layer L - 1's product, the others' wait in the barrier.

#pragma once

#include <type_traits>

#include "decode_common.cuh"

namespace decode {

constexpr int kMaxStages = 4;
// Phases of the timed build: embedding and first stage, layer wait and
// barrier, layer copies issued, fg and gate, dense and residual, skip, post,
// sampling; then the whole loop.
constexpr int kSpans = 9;

struct ResArgs {
  int L, Cr, Cd, Cs, Q, ring_len, F, pool, n_steps, sample_mode;
  float temperature;
  uint32_t seed;
  // shared-memory carve, in floats from the base (x at 0)
  int off_zall, off_h1, off_h2, off_ptap, off_stage, stage_floats, n_stages, off_int;
  const int* dil;    // [L] dilations
  const int* s0;     // [B] first token (drawn on the host)
  const int* prev0;  // [B] last prime token
  const int* pos0;   // [B] absolute time of the token consumed at step 0 (AE)
  int* out;          // [B, n_steps]
  long long* spans;  // [kSpans] cycles per phase (SPANS)
};

struct ResWeights {
  const void *ecur, *eprev, *fg, *dense, *skip, *post1, *post2, *cond_fg, *cond_post;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's groups are pending (n < kMaxStages).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// VC adjacent weights of a row, one 16-byte (or, for 4 bf16, 8-byte) load:
// Raw is what the load returns, get() widens it to floats.
template <typename T, int VC>
struct Cols;
template <>
struct Cols<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void get(const Raw& r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
};
template <int VC>
struct Cols<__nv_bfloat16, VC> {
  static_assert(VC == 4 || VC == 8, "4 or 8 bf16 columns");
  using Raw = typename std::conditional<VC == 4, uint2, uint4>::type;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  static __device__ __forceinline__ void get(const Raw& r, float (&v)[VC]) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int j = 0; j < VC / 2; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};

// Columns a lane takes in the skip and post products: 16 bytes of weights
// a row while its accumulators fit (8 bf16 up to 4 streams), else 4.
template <typename T, int S>
constexpr int kCols = sizeof(T) == 2 && S <= 4 ? 8 : 4;
// Row loads a lane keeps in flight in those products.
template <int S>
constexpr int kInFlight = S >= 16 ? 4 : 8;

// out[s][n] = sum_k in[s*ld + k] * W[k*N + n] over warps w0 .. kWarps - 1
// (the whole block by default), N a multiple of VC = kCols: lane groups of
// VC adjacent columns, the lanes of a warp sharing a group split K (rows
// k = ks, ks + kw, ...) and sum by shuffles; epi(s, n, v[4]) gets the
// totals of columns n..n+3 (one lane per group calls it, VC / 4 times).
// U row loads in flight a lane, in batches of U (rows past the last full
// batch one by one).
template <typename T, int S, int U = kInFlight<S>, typename Epi>
__device__ __forceinline__ void matvec_cols(const float* in, int ld, int K,
                                            const T* __restrict__ W, int N, Epi epi,
                                            int w0 = 0) {
  constexpr int VC = kCols<T, S>;
  using C = Cols<T, VC>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0, nw = kWarps - w0;
  const int groups = N / VC;
  const int per = (groups + nw - 1) / nw;
  int gpw = 1;  // groups a warp takes at once: a power of two <= 32
  while (gpw < per && gpw < 32) gpw <<= 1;
  const int kw = 32 / gpw, gl = lane & (gpw - 1), ks = lane / gpw;
  for (int gb = warp * gpw; gb < groups; gb += nw * gpw) {  // uniform over the warp
    const int g = gb + gl;
    float acc[S][VC];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < VC; ++j) acc[s][j] = 0.f;
    }
    if (g < groups) {
      const T* wp = W + VC * g;
      int k = ks;
      for (; k + (U - 1) * kw < K; k += U * kw) {
        typename C::Raw r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = C::load(wp + (size_t)(k + u * kw) * N);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float w[VC];
          C::get(r[u], w);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float v = in[s * ld + k + u * kw];
#pragma unroll
            for (int j = 0; j < VC; ++j) acc[s][j] = fmaf(v, w[j], acc[s][j]);
          }
        }
      }
      for (; k < K; k += kw) {
        float w[VC];
        C::get(C::load(wp + (size_t)k * N), w);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float v = in[s * ld + k];
#pragma unroll
          for (int j = 0; j < VC; ++j) acc[s][j] = fmaf(v, w[j], acc[s][j]);
        }
      }
    }
    for (int o = gpw; o < 32; o <<= 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < VC; ++j) acc[s][j] += __shfl_xor_sync(0xffffffffu, acc[s][j], o);
      }
    }
    if (ks == 0 && g < groups) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int q = 0; q < VC; q += 4) {
          const float v[4] = {acc[s][q], acc[s][q + 1], acc[s][q + 2], acc[s][q + 3]};
          epi(s, VC * g + q, v);
        }
      }
    }
  }
}

// Eight values of a shared-memory row as floats (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// One chain lane's share of a layer product: acc[o][k % 4] += in[k] *
// rows[o][k] for k < K (K % 8 == 0), in and the rows in shared memory, both
// 16-byte aligned.  Eight k a batch, loaded with 16-byte loads, into 4
// partial sums per output; four batches unrolled, so at the shipped width
// (K = 32, known at compile time) every load of the product issues at once.
template <int NO, typename TI, typename TW>
__device__ __forceinline__ void chain_dot(float (&acc)[NO][4], const TI* in, int K,
                                          const TW* const (&rows)[NO]) {
#pragma unroll 4
  for (int k = 0; k < K; k += 8) {
    float v[8], w[NO][8];
    load8(in + k, v);
#pragma unroll
    for (int o = 0; o < NO; ++o) load8(rows[o] + k, w[o]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[o][j & 3] = fmaf(v[j], w[o][j], acc[o][j & 3]);
    }
  }
}

// With LAYER_SKIP, one layer's skip product on warps w0 .. kWarps - 1:
// acc[s][n] += (z @ skip_i)[s][n] for acc = h1 [S][Cs] (acc = the product
// for the first layer, so nothing is zeroed); for the last layer h1 =
// round(relu(acc)).  Each (s, n) is one lane's, which adds the layer's whole
// sum with __fadd_rn.
template <typename T, int S>
__device__ __forceinline__ void layer_skip(const float* z, const T* __restrict__ skip_i,
                                           float* h1, int Cd, int Cs, bool first, bool last,
                                           int w0) {
  matvec_cols<T, S, 16>(z, Cd, Cd, skip_i, Cs, [&](int s, int n, const float (&v)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* acc = h1 + s * Cs + n + j;
      const float r = first ? v[j] : __fadd_rn(*acc, v[j]);
      *acc = last ? Num<T>::round(fmaxf(r, 0.f)) : r;
    }
  }, w0);
}

// W: the chain width Cr = Cd when it is known at compile time (32, the
// shipped width; 64, the scaled width, with LAYER_SKIP), else 0 and the
// widths come from Args.  LAYER_SKIP: per-layer skip accumulation (above).
template <typename T, int S, bool AE, bool SPANS, int W, bool LAYER_SKIP>
__global__ void __launch_bounds__(kThreads, 1)
    resident_kernel(const ResArgs a, const ResWeights wt, T* __restrict__ ring) {
  static_assert(!LAYER_SKIP || S <= 4, "per-layer skip: at most 4 streams a block");
  // warps on each stream's chain: with LAYER_SKIP and at most 2 streams two,
  // each taking half of a layer's columns (a named barrier between them
  // once z is written), else one
  constexpr int CW = LAYER_SKIP && S <= 2 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Cr = W ? W : a.Cr, Cd = W ? W : a.Cd;
  const int L = a.L, Cs = a.Cs, Q = a.Q, LCd = L * Cd;
  const T* ecur = static_cast<const T*>(wt.ecur);
  const T* eprev = static_cast<const T*>(wt.eprev);
  const T* fg = static_cast<const T*>(wt.fg);
  const T* dense = static_cast<const T*>(wt.dense);
  const T* skip = static_cast<const T*>(wt.skip);
  const T* post1 = static_cast<const T*>(wt.post1);
  const T* post2 = static_cast<const T*>(wt.post2);
  const T* cond_fg = static_cast<const T*>(wt.cond_fg);
  const T* cond_post = static_cast<const T*>(wt.cond_post);
  float* x = smem;                  // [S][Cr] residual stream
  // [S][L*Cd] gated activations, layer-major; with LAYER_SKIP [2][S][Cd],
  // layer i in slot i mod 2
  float* zall = smem + a.off_zall;
  float* h1 = smem + a.off_h1;      // [S][Cs] (skip_acc before it with LAYER_SKIP)
  float* logits = h1;               // [S][Q] (h1 is dead once post1 is done)
  float* h2 = smem + a.off_h2;      // [S][Cs]
  float* ptap = smem + a.off_ptap;  // [2][S][2Cd] tap halves of fg, by layer parity
  float* stages = smem + a.off_stage;
  int* cur = reinterpret_cast<int*>(smem + a.off_int);  // [S]
  int* prev = cur + S;                                  // [S]
  int* pos = prev + S;                                  // [S] clocks (AE)
  int* dil = pos + S;                                   // [L]
  int* off = dil + L;                                   // [L] first ring row
  int* slot = off + L;                                  // [L] this step's ring row
  // a stage: fg^T [2Cd][2Cr + pad], dense^T [Cr][Cd + pad] (the packs of
  // decode_cuda: one row per output column, padded by 16 bytes so that the
  // lanes' 16-byte row loads fall in distinct banks), taps [S][Cr], cond
  // rows [S][2Cd]
  constexpr int pad = 16 / (int)sizeof(T);
  const int ld_fg = 2 * Cr + pad, ld_dense = Cd + pad;
  const int n_fg = 2 * Cd * ld_fg, n_dense = Cr * ld_dense;
  const int n_cond = AE ? 2 * Cd : 0;
  const int c_fg = n_fg * (int)sizeof(T) / 16, c_dense = n_dense * (int)sizeof(T) / 16;
  const int c_tap = Cr * (int)sizeof(T) / 16, c_cond = n_cond * (int)sizeof(T) / 16;
  const int c_total = c_fg + c_dense + S * (c_tap + c_cond);
  // With a spare warp per stream and 3 or more stages, warp S + s computes
  // stream s's tap half of fg for the next layer (its stage has landed one
  // layer earlier), so the chain computes only the x half.
  const bool helpers = (CW + 1) * S <= kWarps && a.n_stages >= 3;
  const int pending = a.n_stages - (helpers ? 3 : 2);  // groups left in flight at a layer's top
  // the tap half of layer gl's f_c and g_c, from its stage, for stream s
  auto tap_half = [&](int gl, int s, int c, float& lo, float& hi) {
    const T* st = reinterpret_cast<const T*>(stages + (size_t)(gl % a.n_stages) * a.stage_floats);
    const T* const rows[2] = {st + c * ld_fg, st + (Cd + c) * ld_fg};
    float acc[2][4] = {};
    chain_dot<2>(acc, st + n_fg + n_dense + s * Cr, Cr, rows);
    lo = (acc[0][0] + acc[0][1]) + (acc[0][2] + acc[0][3]);
    hi = (acc[1][0] + acc[1][1]) + (acc[1][2] + acc[1][3]);
  };
  auto helper_pass = [&](int gl) {  // by warps CW*S .. (CW+1)*S - 1
    if (helpers && warp >= CW * S && warp < (CW + 1) * S) {
      const int s = warp - CW * S;
      float* out = ptap + ((gl & 1) * S + s) * 2 * Cd;
      for (int c = lane; c < Cd; c += 32) tap_half(gl, s, c, out[c], out[Cd + c]);
    }
  };
  const int b0 = blockIdx.x * S;
  T* ring_b = ring + (size_t)b0 * a.ring_len * Cr;
  if (tid < S) {
    cur[tid] = a.s0[b0 + tid];
    prev[tid] = a.prev0[b0 + tid];
    if (AE) pos[tid] = a.pos0[b0 + tid];
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

  // Copy the chain operands of layer gl (counted across steps) into its
  // stage; one commit group per call, empty past the last step.  The warps
  // that run neither a chain nor a tap half copy when there are any, so
  // neither waits on the copies; the others copy nothing and commit nothing.
  const int w0 = helpers && (CW + 1) * S < kWarps ? (CW + 1) * S
                 : CW * S < kWarps ? CW * S : 0;  // first copying warp
  const int n_copy = kThreads - 32 * w0, copy_id = tid - 32 * w0;
  auto issue = [&](int gl) {
    const int tt = gl / L, i = gl - tt * L;
    if (warp < w0) return;
    if (tt + 1 < a.n_steps) {
      char* dst = reinterpret_cast<char*>(stages + (size_t)(gl % a.n_stages) * a.stage_floats);
      for (int q = copy_id; q < c_total; q += n_copy) {
        const char* src;
        if (q < c_fg) {
          src = reinterpret_cast<const char*>(fg + (size_t)i * n_fg) + 16 * q;
        } else if (q < c_fg + c_dense) {
          src = reinterpret_cast<const char*>(dense + (size_t)i * n_dense) + 16 * (q - c_fg);
        } else if (q < c_fg + c_dense + S * c_tap) {
          const int r = q - c_fg - c_dense, s = r / c_tap;
          const T* row = ring_b + ((size_t)s * a.ring_len + off[i] + tt % dil[i]) * Cr;
          src = reinterpret_cast<const char*>(row) + 16 * (r - s * c_tap);
        } else {
          const int r = q - c_fg - c_dense - S * c_tap, s = r / c_cond;
          const int frame = min((pos[s] + tt) / a.pool, a.F - 1);
          const T* row = cond_fg + ((size_t)(b0 + s) * a.F + frame) * 2 * LCd + i * n_cond;
          src = reinterpret_cast<const char*>(row) + 16 * (r - s * c_cond);
        }
        cp_async16(dst + 16 * q, src);
      }
    }
    cp_async_commit();
  };

  long long span[kSpans] = {};
  long long clk = 0, clk0 = 0;
  auto mark = [&](int phase) {
    if (SPANS && blockIdx.x == 0 && tid == 0) {
      const long long now = clock64();
      span[phase] += now - clk;
      clk = now;
    }
  };
  if (SPANS && blockIdx.x == 0 && tid == 0) clk0 = clk = clock64();

  for (int p = 0; p + 1 < a.n_stages; ++p) issue(p);
  if (helpers) {  // the tap half of the first layer
    cp_async_wait(a.n_stages - 2);
    __syncthreads();
    helper_pass(0);
  }
  for (int t = 0; t + 1 < a.n_steps; ++t) {
    for (int i = tid; i < L; i += kThreads) slot[i] = off[i] + t % dil[i];
    // the embedding of (current, previous) token, by each stream's chain warp
    if (warp < S) {
      const int s = warp;
      for (int c = lane; c < Cr; c += 32) {
        x[s * Cr + c] = Num<T>::round(Num<T>::load(ecur + cur[s] * Cr + c) +
                                      Num<T>::load(eprev + prev[s] * Cr + c));
      }
    }
    for (int i = 0; i < L; ++i) {
      const int gl = t * L + i;
      cp_async_wait(pending);  // this layer's stage (and with helpers the next) has landed ...
      __syncthreads();         // ... for every thread; layer i - 1 is done
      if (i == 0) {
        mark(0);
      } else {
        mark(1);
      }
      issue(gl + a.n_stages - 1);  // into the stage layer i - 1 used
      mark(2);
      if (warp >= CW * S) {
        helper_pass(gl + 1);
        if constexpr (LAYER_SKIP) {  // the copying warps: layer i - 1's skip
          if (i > 0 && warp >= w0) {
            layer_skip<T, S>(zall + ((i - 1) & 1) * S * Cd, skip + (size_t)(i - 1) * Cd * Cs,
                             h1, Cd, Cs, i == 1, false, w0);
          }
        }
        continue;
      }
      const int s = warp / CW, c0 = lane + 32 * (warp % CW);  // stream, first column
      const T* st = reinterpret_cast<const T*>(stages + (size_t)(gl % a.n_stages) * a.stage_floats);
      const T* Wfg = st;  // fg^T
      const T* Wd = st + n_fg;  // dense^T
      float* xs = x + s * Cr;
      float* zs = LAYER_SKIP ? zall + ((i & 1) * S + s) * Cd : zall + s * LCd + i * Cd;
      for (int c = c0; c < Cd; c += 32 * CW) {  // f_c and g_c: columns c and Cd + c
        float lo_t, hi_t;  // [tap | x] @ fg = tap half + x half
        if (helpers) {
          const float* h = ptap + ((gl & 1) * S + s) * 2 * Cd;
          lo_t = h[c];
          hi_t = h[Cd + c];
        } else {
          tap_half(gl, s, c, lo_t, hi_t);
        }
        float acc[2][4] = {};
        const T* const rows[2] = {Wfg + c * ld_fg + Cr, Wfg + (Cd + c) * ld_fg + Cr};
        chain_dot<2>(acc, xs, Cr, rows);
        const float lo = lo_t + ((acc[0][0] + acc[0][1]) + (acc[0][2] + acc[0][3]));
        const float hi = hi_t + ((acc[1][0] + acc[1][1]) + (acc[1][2] + acc[1][3]));
        float f, g;
        if constexpr (AE) {  // + the conditioning row; the gate is swapped
          const T* cond = Wd + n_dense + S * Cr + s * n_cond;  // after the taps
          g = lo + Num<T>::load(cond + c);
          f = hi + Num<T>::load(cond + Cd + c);
        } else {
          f = lo;
          g = hi;
        }
        zs[c] = Num<T>::round(tanhf(f) * (1.f / (1.f + expf(-g))));
      }
      mark(3);
      // z is complete, and every lane of the stream's chain has read x
      if constexpr (CW > 1) {
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + s), "r"(32 * CW) : "memory");
      } else {
        __syncwarp();
      }
      for (int c = c0; c < Cr; c += 32 * CW) {
        float acc[1][4] = {};
        const T* const rows[1] = {Wd + c * ld_dense};
        chain_dot<1>(acc, zs, Cd, rows);
        const float xo = xs[c];
        // the tap of this slot was staged before: overwrite it with the input
        ring_b[((size_t)s * a.ring_len + slot[i]) * Cr + c] = Num<T>::store(xo);
        xs[c] = Num<T>::round(xo + ((acc[0][0] + acc[0][1]) + (acc[0][2] + acc[0][3])));
      }
      mark(4);
    }
    __syncthreads();  // zall complete (LAYER_SKIP: z of the last layer, the skip before it)
    mark(1);

    // skip projection of all layers at once (LAYER_SKIP: of the last
    // layer, on the whole block), then the post stack
    if constexpr (LAYER_SKIP) {
      layer_skip<T, S>(zall + ((L - 1) & 1) * S * Cd, skip + (size_t)(L - 1) * Cd * Cs, h1, Cd,
                       Cs, L == 1, true, 0);
    } else {
      matvec_cols<T, S>(zall, LCd, LCd, skip, Cs, [&](int s, int n, const float (&v)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) h1[s * Cs + n + j] = Num<T>::round(fmaxf(v[j], 0.f));
      });
    }
    __syncthreads();
    mark(5);
    matvec_cols<T, S>(h1, Cs, Cs, post1, Cs, [&](int s, int n, const float (&v)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c = v[j];
        if constexpr (AE) {
          const int frame = min((pos[s] + t) / a.pool, a.F - 1);
          c += Num<T>::load(cond_post + ((size_t)(b0 + s) * a.F + frame) * Cs + n + j);
        }
        h2[s * Cs + n + j] = Num<T>::round(fmaxf(c, 0.f));
      }
    });
    __syncthreads();
    // logits, or logits / temperature + Gumbel noise; a lane's four columns
    // are one Philox call, counter (lane block, token index), key (seed, row)
    matvec_cols<T, S>(h2, Cs, Cs, post2, Q, [&](int s, int n, const float (&v)[4]) {
      float r[4] = {v[0], v[1], v[2], v[3]};
      if (!AE && a.sample_mode == 1) {
        uint32_t c[4] = {(uint32_t)(n >> 2), (uint32_t)(t + 1), 0u, 0u};
        philox(c, a.seed, (uint32_t)(b0 + s));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float u = __uint_as_float((c[m] >> 9) | 0x3F800000u) - 1.f;
          r[m] = r[m] / a.temperature + (-logf(-logf(u + 1e-20f) + 1e-20f));
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) logits[s * Q + n + m] = r[m];
    });
    __syncthreads();
    mark(6);

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
    mark(7);
  }
  cp_async_wait(0);
  if (SPANS && blockIdx.x == 0 && tid == 0) {
    span[kSpans - 1] = clock64() - clk0;
    for (int p = 0; p < kSpans; ++p) a.spans[p] = span[p];
  }
}

template <typename T, int S, bool AE, bool SPANS, bool LAYER_SKIP>
cudaError_t resident_launch_one(const ResArgs& a, const ResWeights& w, int G, size_t smem,
                                void* ring, cudaStream_t stream) {
  // the width with an instantiation of its own: shipped (B1/B3), scaled (B2/B4)
  constexpr int kW = LAYER_SKIP ? 64 : 32;
  auto kern = a.Cr == kW && a.Cd == kW ? resident_kernel<T, S, AE, SPANS, kW, LAYER_SKIP>
                                       : resident_kernel<T, S, AE, SPANS, 0, LAYER_SKIP>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<G, kThreads, smem, stream>>>(a, w, static_cast<T*>(ring));
  return cudaGetLastError();
}

// Streams a block: 1 to 16, to 4 with LAYER_SKIP (kernels/
// wavenet_decode_hbm.py::LAYER_SKIP_STREAMS says why).
template <typename T, bool AE, bool LAYER_SKIP>
cudaError_t resident_dispatch_s(int S, const ResArgs& a, const ResWeights& w, int G,
                                size_t smem, void* ring, cudaStream_t stream) {
  switch (S) {
    case 1: return resident_launch_one<T, 1, AE, false, LAYER_SKIP>(a, w, G, smem, ring, stream);
    case 2: return resident_launch_one<T, 2, AE, false, LAYER_SKIP>(a, w, G, smem, ring, stream);
    case 4: return resident_launch_one<T, 4, AE, false, LAYER_SKIP>(a, w, G, smem, ring, stream);
    case 8:
      if constexpr (!LAYER_SKIP) return resident_launch_one<T, 8, AE, false, false>(a, w, G, smem,
                                                                                   ring, stream);
      return cudaErrorInvalidValue;
    case 16:
      if constexpr (!LAYER_SKIP) return resident_launch_one<T, 16, AE, false, false>(a, w, G, smem,
                                                                                    ring, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// The device pointers of a launch, in the order of POINTERS in
// kernels/wavenet_decode.py; null where a kernel takes none (pos0, cond_fg,
// cond_post for WaveNet; spans unless the phases are timed).
enum ResPtr {
  kResDil, kResRing, kResS0, kResPrev0, kResPos0, kResEcur, kResEprev, kResFg, kResDense,
  kResSkip, kResPost1, kResPost2, kResCondFg, kResCondPost, kResOut, kResSpans
};

// What the C entry points do: fill ResArgs and ResWeights and launch.
// dtype: 0 float32, 1 bfloat16.  dims: L, Cr, Cd, Cs, Q, ring_len, F, pool
// (F = pool = 1 for WaveNet).  offs: zall (LAYER_SKIP: the z ring), h1, h2,
// ptap, stage, stage stride (in floats), stage count, ints.  smem_bytes:
// the carve's size.  sample_mode: 0 argmax, 1 categorical.  With a spans
// pointer the phase-timed build runs (WaveNet, float32, one stream a block
// only).  Returns the CUDA error code of the launch (0 on success); never
// synchronises.
template <bool AE, bool LAYER_SKIP>
int resident_entry(int dtype, int S, int G, const int* dims, const int* offs, int smem_bytes,
                   void* const* p, int n_steps, int sample_mode, float temperature,
                   uint32_t seed, void* stream) {
  cudaGetLastError();  // clear a stale error so the code returned is this launch's
  ResArgs a{};
  a.L = dims[0];
  a.Cr = dims[1];
  a.Cd = dims[2];
  a.Cs = dims[3];
  a.Q = dims[4];
  a.ring_len = dims[5];
  a.F = dims[6];
  a.pool = dims[7];
  a.n_steps = n_steps;
  a.sample_mode = sample_mode;
  a.temperature = temperature;
  a.seed = seed;
  a.off_zall = offs[0];
  a.off_h1 = offs[1];
  a.off_h2 = offs[2];
  a.off_ptap = offs[3];
  a.off_stage = offs[4];
  a.stage_floats = offs[5];
  a.n_stages = offs[6];
  a.off_int = offs[7];
  a.dil = static_cast<const int*>(p[kResDil]);
  a.s0 = static_cast<const int*>(p[kResS0]);
  a.prev0 = static_cast<const int*>(p[kResPrev0]);
  a.pos0 = static_cast<const int*>(p[kResPos0]);
  a.out = static_cast<int*>(p[kResOut]);
  a.spans = static_cast<long long*>(p[kResSpans]);
  if (a.n_stages < 2 || a.n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  const ResWeights w{p[kResEcur], p[kResEprev], p[kResFg], p[kResDense], p[kResSkip],
                     p[kResPost1], p[kResPost2], p[kResCondFg], p[kResCondPost]};
  const size_t smem = (size_t)smem_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.spans != nullptr) {
    if constexpr (AE) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (dtype != 0 || S != 1) return (int)cudaErrorInvalidValue;
      return (int)resident_launch_one<float, 1, false, true, LAYER_SKIP>(a, w, G, smem,
                                                                         p[kResRing], st);
    }
  }
  if (dtype == 0) {
    return (int)resident_dispatch_s<float, AE, LAYER_SKIP>(S, a, w, G, smem, p[kResRing], st);
  }
  if (dtype == 1) {
    return (int)resident_dispatch_s<__nv_bfloat16, AE, LAYER_SKIP>(S, a, w, G, smem,
                                                                   p[kResRing], st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
