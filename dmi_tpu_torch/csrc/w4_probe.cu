// Packed-W4 matmul probes for Hopper: out [OUT, B] int32 = W^T h, with W
// [K, OUT] int4 weights stored two to a byte and h [K, B] int8.
//
// Replaces the two TPU kernels of scripts/profile_w4_matmul.py, which ask
// whether streaming the packed nibbles beats streaming int8 weights:
//   split-OUT  dot_w4_pallas :156-170 (body _w4_kernel :145-154): p [K, OUT/2],
//              byte (k, j) = column j (low nibble) and j + OUT/2 (high);
//   split-K    dot_w4_pallas_k :184-197 (body _w4k_kernel :174-182): p [K/2,
//              OUT], byte (k, n) = row k (low) and k + K/2 (high): the layout
//              of quant.pack_w4 and of kernel 7 (w4_matmul.cu), without its
//              rescale.
//
// What bounds it: at the probe's K 2048, OUT 16384, B 256 a call reads 16.8
// MB of packed weights and 0.5 MB of activations and writes 16.8 MB of int32
// (10.2 us at 3.35 TB/s); its 17.2 G int8 operations take 8.7 us at the
// tensor-core peak.  So the bytes bound it, half of them the output.  The
// kernel is mm_tile.cuh's s8 wmma tile fed from shared memory: each thread
// reads 16 packed bytes once, sign-extends both nibbles and stages them as
// two int8 rows (split-K) or column ranges (split-OUT) of the tile, which is
// what a tensor-core redesign of kernel 7 would do.  Integer sums are exact,
// so the result equals the int8 product bit for bit.
#include "mm_tile.cuh"

// Plain C entry point (bound with ctypes).  split_k: p [K/2, OUT], else p
// [K, OUT/2]; all contiguous.  Returns the CUDA error code of the launch, 0
// on success.
extern "C" int dmi_w4_probe(const void* p, const void* h, void* out, int OUT, int B, int K,
                            int split_k, void* stream) {
  using namespace dmi::mm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return split_k ? launch<signed char, int, kSplitK, 128>(p, h, out, OUT, B, K, st)
                 : launch<signed char, int, kSplitOut, 128>(p, h, out, OUT, B, K, st);
}
