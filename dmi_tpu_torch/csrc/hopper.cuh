// Hopper building blocks of the kernels that stream their weights through a
// ring of TMA boxes in shared memory: the decode MLP (decode_mlp.cu), the
// head + argmax (head_argmax.cu) and the int8 matmuls (w4_matmul.cu).  The
// mbarrier and TMA load wrappers and the driver's tensor-map encoder live in
// flash_mma.cuh, which the flash backward shares; this header adds
//   - tensor maps of 2-D row-major matrices (any element type, box and
//     swizzle), encoded on the host and cached by what they were made from;
//   - wgmma's shared-memory descriptors, fences and bf16 instructions, and
//     the row and column a fragment register holds;
//   - an L2 prefetch of a TMA box and the programmatic-dependent-launch
//     controls.
//
// Swizzled boxes: with CU_TENSOR_MAP_SWIZZLE_128B a box of 128-byte rows
// lands at a 1024-byte aligned address with 16-byte chunk c of row r stored
// at chunk c ^ (r % 8) (swz128 gives the byte offset).  wgmma reads such a
// tile through a descriptor: K-major (rows are M or N, 128 bytes of K each),
// or MN-major for 16-bit types (rows are K, 64 elements of M or N each).
#pragma once

#include <cudaTypedefs.h>
#include <stdint.h>

#include <mutex>

#include "flash_mma.cuh"

namespace dmi {
namespace hopper {

using flash::smem_addr;

constexpr int kSmemMax = 232448;  // 227 KB: the shared memory a block may use

// ---- host: tensor maps ----

// What a map is made from besides its base: a row-major matrix of `rows`
// rows of `cols` elements, row_bytes apart, cut into boxes of box_cols x
// box_rows elements that land `swizzle`d.
struct MapShape {
  CUtensorMapDataType dtype;
  uint64_t cols, rows, row_bytes;
  uint32_t box_cols, box_rows;
  CUtensorMapSwizzle swizzle;

  bool operator==(const MapShape& o) const {
    return dtype == o.dtype && cols == o.cols && rows == o.rows && row_bytes == o.row_bytes &&
           box_cols == o.box_cols && box_rows == o.box_rows && swizzle == o.swizzle;
  }
};

// The map of the matrix at base; false where the driver has no encoder or
// refuses the shape (a base or row stride off 16 bytes, a box over 256).
inline bool encode_map(CUtensorMap* m, const void* base, const MapShape& s) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = flash::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {s.cols, s.rows};
  const cuuint64_t strides[1] = {s.row_bytes};
  const cuuint32_t box[2] = {s.box_cols, s.box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(m, s.dtype, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, s.swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor maps by (base, shape), each encoded at its first use; when the
// cache is full the least recently used map is replaced.  A map holds only
// the address, shape and strides it was made from, so a new tensor at a
// freed address with the same key gets a map that is right for it.  A
// kernel keeps its weights' maps in one cache and its activations' (new
// addresses as the caching allocator hands them out) in another, so that
// activations never evict a weight.
template <int kEntries>
struct MapCache {
  struct Entry {
    const void* base;
    MapShape shape;
    uint64_t used;
    CUtensorMap map;
  };
  Entry entries[kEntries];
  int n = 0;
  uint64_t tick = 0;
  long long encodes = 0;
  std::mutex mu;

  // the map of (base, shape); false where it cannot be encoded
  bool get(CUtensorMap* out, const void* base, const MapShape& shape) {
    std::lock_guard<std::mutex> lock(mu);
    ++tick;
    Entry* lru = nullptr;
    for (int i = 0; i < n; ++i) {
      Entry& e = entries[i];
      if (e.base == base && e.shape == shape) {
        e.used = tick;
        *out = e.map;
        return true;
      }
      if (lru == nullptr || e.used < lru->used) lru = &e;
    }
    Entry& e = n < kEntries ? entries[n] : *lru;
    if (!encode_map(&e.map, base, shape)) return false;
    if (n < kEntries) ++n;  // e was entries[n]
    e.base = base, e.shape = shape, e.used = tick;
    ++encodes;
    *out = e.map;
    return true;
  }
};

// ---- device ----

// byte offset of (row, byte col) in a box of 128-byte rows, 128-byte swizzled
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023);
  return reinterpret_cast<unsigned char*>(a);
}

// the box of `map` at (column c0, row c1) into the L2 cache only
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

// Programmatic dependent launch: a kernel launched right after this one with
// the programmatic-serialization attribute may start (and run up to its
// griddep_wait) once every block of this one has called
// griddep_launch_dependents; griddep_wait returns when the kernel before has
// finished and its writes are visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A shared-memory matrix descriptor of a 128-byte swizzled tile: start
// address, leading byte offset (MN-major: between 64-element atoms along MN;
// K-major: not read, as one wgmma's K lies within a 128-byte row), stride
// byte offset 1024 (between 8-row groups: along K when MN-major, along M or
// N when K-major).  A K-major operand's later K steps start 32 bytes
// further within the swizzled rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  constexpr uint32_t kSbo = 1024;
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA (the
// async proxy): after the writes, before the barrier that orders the reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128 f32, the warpgroup's fragment) += A (64 x 16) * B (16 x 128),
// both bf16 by descriptor, scale-d 1; kTransA / kTransB: 1 for an MN-major
// operand, 0 for a K-major one
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64 f32) += A (64 x 16) * B (16 x 64), as wgmma_bf16_n128
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// Register r of a warpgroup thread t's m64nN fragment holds C[row, col]:
// warp w of the group owns rows 16 w .. 16 w + 15, as in mma.sync's m16n8
// C tile, one n8 tile per four registers.
__device__ __forceinline__ int frag_row(int r, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int r, int t) {
  return 8 * (r >> 2) + 2 * (t & 3) + (r & 1);
}

}  // namespace hopper
}  // namespace dmi
