// Weight-stream matmul probe for Hopper: out = w^T h, with w [I, O] and h
// [I, B] bf16, out [O, B] bf16 (an f32 sum rounded once).
//
// Replaces the TPU kernel pallas_mm of scripts/profile_mlp_stream.py:67-78
// (body :61-65), which asks whether a hand-written kernel streams the decode
// MLP's gate-up weights (I 2048, O 16384, B 256) faster than the library.
//
// What bounds it: a call reads 67.1 MB of weights and writes 8.4 MB (22.8 us
// at 3.35 TB/s) and does 17.2 GFLOP (17 us on the bf16 tensor cores), so the
// weight stream bounds it and has to cover the card.  A block owns block_o
// output rows (64, 128 or 256: the counterpart of the script's bo sweep, one
// template instance each) by 128 batch columns, and streams its [I, block_o]
// slice of w through the ring of mm_tile.cuh (w^T read as a column-major
// wmma operand).  The two batch tiles of one w slice are neighbouring blocks,
// so the second finds the slice in L2 and w crosses device memory about once.
#include "mm_tile.cuh"

// Plain C entry point (bound with ctypes).  Returns the CUDA error code of
// the launch, 0 on success.
extern "C" int dmi_stream_mm(const void* w, const void* h, void* out, int O, int B, int I,
                             int block_o, void* stream) {
  using dmi::mm::kTransA;
  using T = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_o == 64) return dmi::mm::launch<T, T, kTransA, 64>(w, h, out, O, B, I, st);
  if (block_o == 128) return dmi::mm::launch<T, T, kTransA, 128>(w, h, out, O, B, I, st);
  if (block_o == 256) return dmi::mm::launch<T, T, kTransA, 256>(w, h, out, O, B, I, st);
  return (int)cudaErrorInvalidValue;
}
