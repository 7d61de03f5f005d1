// Fused conditioned decode of the WaveNet autoencoder for Hopper (sm_90a):
// the whole reconstruction loop in one launch.
//
// Replaces music_tpu/kernels/wavenet_ae_decode.py::_ae_kernel_wrapper, the
// resident Pallas kernel.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_ae_decode.py::decode_reference (same
// weight packs, ring layout, conditioning tables and bf16 rounding points).
//
// Design: that of wavenet_decode.cu (csrc/decode_resident.cuh, the same
// body with AE = true) -- one warp per stream runs the 40-layer chain from
// shared-memory stages that all 512 threads fill with cp.async a few layers
// ahead, one __syncthreads() a layer, then the skip and post products over
// the block -- plus the autoencoder's conditioning.  Each step every stream
// takes its own frame, min((pos0[b] + t) / pool, F - 1), from its own
// clock; layer i adds row (b, frame) of cond_fg [B, F, L*2Cd] (columns
// i*2Cd ..) to its filter/gate pre-activation, and the post stack adds row
// (b, frame) of cond_post [B, F, Cs] after post1.  The cond_fg rows ride
// in the layer's stage beside its weights and taps, so the chain never
// waits on them.  The gate is the autoencoder's: tanh(fg[Cd:]) *
// sigmoid(fg[:Cd]).  Argmax only, lowest index on ties.
//
// Bound: as wavenet_decode.cu -- every block re-reads its 5.01 MB (f32) of
// weights a step from L2, so one SM's L2 read rate (~220 GB/s on an H100)
// sets a floor of ~23 us a step, and the 40 dependent layers of the chain
// a latency floor of their own; the kernel takes ~2.7x the first.  The
// conditioning adds 2Cd values a layer a stream to the stage copies and
// a sum to the gate, ~6 us a step over wavenet_decode.cu.

#include "decode_resident.cuh"

using namespace decode;

// The launch (decode_resident.cuh::resident_entry has the arguments);
// returns the CUDA error code, 0 on success.
extern "C" int wavenet_ae_decode(int dtype, int S, int G, const int* dims, const int* offs,
                                 int smem_bytes, void* const* ptrs, int n_steps, void* stream) {
  return resident_entry<true, false>(dtype, S, G, dims, offs, smem_bytes, ptrs, n_steps, 0,
                                     1.f, 0u, stream);
}

extern "C" const char* wavenet_ae_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
