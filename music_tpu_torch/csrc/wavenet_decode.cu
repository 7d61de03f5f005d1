// Fused WaveNet autoregressive decode for Hopper (sm_90a): the whole
// generation loop in one launch.
//
// Replaces music_tpu/kernels/wavenet_decode.py::_decode_kernel, the
// resident Pallas kernel.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_decode.py::decode_reference (same weight
// packs, ring layout, bf16 rounding points and Philox draws).
//
// Design (csrc/decode_resident.cuh, shared with wavenet_ae_decode.cu): one
// thread block per tile of S streams, the loop over steps inside the block.
// Each step: embed (current, previous) token by row gathers; the 40-layer
// chain on one warp per stream (lane c: f_c, g_c over [tap | x] @ fg[i],
// z_c = tanh(f) * sigmoid(g), then x_c += z @ dense[i][:, c] after a
// __syncwarp; the tap half of fg by a helper warp one layer ahead),
// reading each layer's weights and taps from a shared-memory stage that
// the spare warps filled with cp.async while the layers before it ran, one
// __syncthreads() a layer; then h = relu(z_all @
// skip), h = relu(h @ post1), logits = h @ post2 over the whole block with
// 4-column vector loads and K split over lanes; argmax (lowest index on
// ties) or Gumbel-max from Philox4x32-10; emit the token.  Activations live
// in shared memory, products accumulate in float32, rings in device memory.
//
// Bound: every block re-reads all its weights every step from the 50 MB L2
// (5.01 MB f32, 2.51 MB bf16 at the shipped width), so one SM's L2 read
// rate sets this design's floor: ~220 GB/s on an H100 (chip_smoke.py's
// probe, csrc/l2_probe.cu), 23 us a step in f32 and 12 in bf16.  The
// kernel takes ~2.4x that: the 40 dependent layers of the chain (two
// dependent products, a gate and a barrier each, ~0.75 us a layer, slowed
// by the stage copies landing beside the chain's shared-memory loads)
// take ~30 us of a ~56 us f32 step, and skip and post ~26, their row
// loads latency-bound at 8 in flight a lane.  The card's
// roofline (weights once a launch, 2.5 MFLOP a stream a step) is far below
// both.

#include "decode_resident.cuh"

using namespace decode;

// The launch (decode_resident.cuh::resident_entry has the arguments);
// returns the CUDA error code, 0 on success.
extern "C" int wavenet_decode(int dtype, int S, int G, const int* dims, const int* offs,
                              int smem_bytes, void* const* ptrs, int n_steps, int sample_mode,
                              float temperature, uint32_t seed, void* stream) {
  return resident_entry<false, false>(dtype, S, G, dims, offs, smem_bytes, ptrs, n_steps,
                                      sample_mode, temperature, seed, stream);
}

extern "C" const char* wavenet_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
