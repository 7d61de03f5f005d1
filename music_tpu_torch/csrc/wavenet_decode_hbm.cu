// Weight-streaming WaveNet decode for Hopper (sm_90a): the whole
// generation loop in one launch, for models whose weights are too large for
// the resident kernel's carve (the 4.4x-scaled model: 40 blocks, Cr = Cd =
// 64, Cs = 1024, Q = 256, 19.1 MB in f32, 4.8 MB in int8).
//
// Replaces music_tpu/kernels/wavenet_decode_hbm.py::_decode_kernel_hbm, the
// Pallas kernel that streams each layer's weights from HBM to VMEM every
// step.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_decode_hbm.py::decode_reference (same
// packs, rounding points, quantization and Philox draws).
//
// Modes, each on its own body:
// - 0, weights in the working dtype (f32 or bf16): the resident body of
//   wavenet_decode.cu (decode_resident.cuh) with LAYER_SKIP -- one warp per
//   stream on the 40-layer chain, the chain's weights and taps staged in
//   shared memory with cp.async by the other warps, one barrier a layer --
//   and the skip product accumulated layer by layer, skip_acc += z_i @
//   skip_i in f32, by the copying warps one layer behind the chain; the
//   scaled width (Cr = Cd = 64) has its own instantiation, 1 to 8 streams
//   a block.
// - 1, int8 weights with per-output-column scales applied after each
//   product, and 2, int8 products too (s8 x s8 -> s32, plain integer
//   multiply-adds) with per-row dynamic activation scales or a static
//   scale per layer: decode_hbm.cuh, every product over the whole block
//   with split partials, four barriers a layer (five with int8 products).
// Argmax or categorical (Philox4x32-10, as wavenet_decode.cu).
//
// Bound: per step every block reads all weights (19.1 MB f32, 9.6 MB bf16,
// 4.8 MB int8) from L2 and does 4.75 M multiply-adds per stream; either
// term alone is a few microseconds for the card (3.35 TB/s, 67 TFLOP/s
// f32).  What bounds one block is one SM's L2 read rate (~220 GB/s,
// chip_smoke.py's probe): ~87 us a step in f32 at the scaled width, ~44 in
// bf16, against which mode 0 overlaps the chain's latency (two dependent
// products and a gate a layer, K = 128) with the skip reads (256 KB a
// layer in f32).  The int8 modes are bound by the latency of their
// dependent rounds of loads and barriers, 40 layers in sequence.

#include "decode_resident.cuh"
#include "decode_hbm.cuh"

using namespace decode;

// The launch (decode_hbm.cuh::hbm_entry has the arguments); returns the
// CUDA error code, 0 on success.
extern "C" int wavenet_decode_hbm(int dtype, int mode, int S, int G, const int* dims,
                                  const int* offs, int smem_bytes, void* const* ptrs,
                                  int n_steps, int sample_mode, float temperature, uint32_t seed,
                                  void* stream) {
  return hbm_entry<false>(dtype, mode, S, G, dims, offs, smem_bytes, ptrs, n_steps, sample_mode,
                          temperature, seed, stream);
}

extern "C" const char* wavenet_decode_hbm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
