// Weight-streaming WaveNet decode for Hopper (sm_90a): the whole
// generation loop in one launch, for models whose weights are too large for
// the resident kernel's carve (the 4.4x-scaled model: 40 blocks, Cr = Cd =
// 64, Cs = 1024, Q = 256, 19.1 MB in f32, 4.8 MB in int8).
//
// Replaces music_tpu/kernels/wavenet_decode_hbm.py::_decode_kernel_hbm, the
// Pallas kernel that streams each layer's weights from HBM to VMEM every
// step.  Its plain PyTorch version is
// music_tpu_torch/kernels/wavenet_decode_hbm.py::decode_reference (same
// packs, rounding points, quantization and Philox draws).  The kernel body
// is hbm_decode_kernel<.., AE = false, ..> in decode_hbm.cuh.
//
// Modes: f32 or bf16 activations (rings, embeddings and rounding points in
// the working dtype); weights in the working dtype or int8 with
// per-output-column scales applied after each product (weight-only);
// int8 products (s8 x s8 -> s32, plain integer multiply-adds) with
// per-row dynamic activation scales or a static scale per layer; argmax or
// categorical (Philox4x32-10, as wavenet_decode.cu).
//
// Bound: per step every block reads all weights (19.1 MB f32, 9.6 MB bf16,
// 4.8 MB int8) from device memory or L2 and does 4.75 M multiply-adds per
// stream; either term alone is a few microseconds (3.35 TB/s, 67 TFLOP/s
// f32).  What bounds this design is B1's: the latency of each layer's
// dependent rounds of weight loads and block barriers (four a layer, five
// with int8 products), 40 layers in sequence.  At the scaled width the
// weights no longer fit one SM's carve, so they stay in device memory and
// are read where they are used; int8 shrinks the bytes 4x but not the
// number of dependent loads.  A later design prefetches the next layer's
// weights during the current one (cp.async/TMA) and spreads the layers
// over a thread block cluster.

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
