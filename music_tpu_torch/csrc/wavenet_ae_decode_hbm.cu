// Weight-streaming conditioned decode of the WaveNet autoencoder for
// Hopper (sm_90a): the whole reconstruction loop in one launch, for
// decoders too large for the resident kernel's carve (the scaled decoder:
// 40 blocks, Cr = Cd = 64, Cs = 1024, Q = 256, 19.1 MB in f32).
//
// Replaces music_tpu/kernels/wavenet_ae_decode_hbm.py::_ae_kernel_hbm, the
// Pallas kernel that streams the decoder weights and the [F, S, C]
// conditioning tables from HBM to VMEM.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_ae_decode_hbm.py::decode_reference.
//
// It is wavenet_decode_hbm.cu's decode plus the conditioning of
// wavenet_ae_decode.cu -- each stream's frame min((pos0[b] + t) / pool,
// F - 1) from its own clock, row (b, frame) of cond_fg [B, F, L*2Cd] added
// to layer i's pre-activation (after the int8 column scale), row (b,
// frame) of cond_post [B, F, Cs] added after post1 (and its scale) -- and
// the swapped gate tanh(fg[Cd:]) * sigmoid(fg[:Cd]).  The tables stay in
// device memory (the TPU kernel's per-stream cur/nxt staging reaches the
// same frame).  Modes, each on its own body: 0, weights in the working
// dtype, on decode_resident.cuh with AE and LAYER_SKIP (the cond_fg rows
// ride in each layer's stage, as in wavenet_ae_decode.cu); 1, int8 weights
// (weight-only), on decode_hbm.cuh.  f32 or bf16 activations and tables;
// argmax only.
//
// Bound: as wavenet_decode_hbm.cu -- one SM's L2 read rate over the 19.1
// MB (f32) a block reads a step, plus the table rows (2Cd a layer a
// stream); the int8 mode by its dependent loads and barriers.

#include "decode_resident.cuh"
#include "decode_hbm.cuh"

using namespace decode;

// The launch (decode_hbm.cuh::hbm_entry has the arguments; argmax only, so
// sample_mode 0); returns the CUDA error code, 0 on success.
extern "C" int wavenet_ae_decode_hbm(int dtype, int mode, int S, int G, const int* dims,
                                     const int* offs, int smem_bytes, void* const* ptrs,
                                     int n_steps, int sample_mode, float temperature,
                                     uint32_t seed, void* stream) {
  return hbm_entry<true>(dtype, mode, S, G, dims, offs, smem_bytes, ptrs, n_steps, sample_mode,
                         temperature, seed, stream);
}

extern "C" const char* wavenet_ae_decode_hbm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
