// Where the time of a lora0 kernel goes: a standalone probe for one H100.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -DROWS=16 \
//        dmi_tpu_torch/csrc/probes/lora0_phases.cu -o /tmp/lora0_phases
//   /tmp/lora0_phases            # then again with -DROWS=4
//
// Not part of the library (the build takes csrc/*.cu only).  It holds the
// design that csrc/lora0.cu had before its clusters, at f32 with 16-byte
// loads: one block per 16 columns of lm and a row tile of up to ROWS rows,
// every block computing all of x @ A.  Each phase can be switched off:
// mode bit 1 runs x @ A, bit 2 the W0 stream, bit 4 the Bm product
// (mode 0 leaves the x load, the reductions and the epilogue); `rotate`
// starts each block at another row of A, to tell a hot line from L2
// throughput.  For each mode it prints the time per launch (CUDA events
// around 200 back-to-back launches, after a 2000-launch warm-up) and, from
// block 0, clock64() cycles over %globaltimer nanoseconds: the SM clock.
// Stage 2's call: B 4, mm 768, lm 2048, r 32; with ROWS 16 also B 64.
#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

#ifndef ROWS
#define ROWS 16
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;
constexpr int kRows = ROWS;
constexpr int kBatch = 8;

__device__ unsigned long long g_clock[4];  // block 0: cycles and ns at start, end

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// acc[i][v] += sum over k = s0, s0 + S, ... < n of src_s[i * ld + kk] *
// m[kk, col + v], kk = (k + rot) mod n; kBatch float4 loads in flight
__device__ __forceinline__ void accumulate(float (&acc)[kRows][4], const float* src_s, int ld,
                                           int rows, const float* __restrict__ m, int m_ld,
                                           int col, int s0, int S, int n, int rot) {
  for (int k0 = s0; k0 < n; k0 += kBatch * S) {
    float4 w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      int k = k0 + u * S + rot;
      if (k >= n) k -= n;
      if (k0 + u * S < n)
        w[u] = __ldg(reinterpret_cast<const float4*>(m + (size_t)k * m_ld + col));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      int k = k0 + u * S + rot;
      if (k >= n) k -= n;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < rows && k0 + u * S < n) {
          const float xv = src_s[i * ld + k];
          acc[i][0] = fmaf(xv, w[u].x, acc[i][0]);
          acc[i][1] = fmaf(xv, w[u].y, acc[i][1]);
          acc[i][2] = fmaf(xv, w[u].z, acc[i][2]);
          acc[i][3] = fmaf(xv, w[u].w, acc[i][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void warp_reduce(float (&acc)[kRows][4], int rows, int group) {
  for (int o = 16; o >= group; o >>= 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][v] += __shfl_xor_sync(0xffffffffu, acc[i][v], o);
}

__device__ __forceinline__ void zero(float (&acc)[kRows][4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
    lora0_phases(const float* __restrict__ x, const float* __restrict__ w0,
                 const float* __restrict__ b0, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ d,
                 float* __restrict__ out, int B, int mm, int lm, int r, int tb, int mode,
                 int rotate) {
  extern __shared__ float smem[];
  float* x_s = smem;               // [tb, mm]
  float* inter_s = x_s + tb * mm;  // [tb, r]
  float* red_s = inter_s + tb * r;
  const int row0 = blockIdx.y * tb, rows = min(tb, B - row0), c0 = blockIdx.x * kCols;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const bool timed = t == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  if (timed) g_clock[0] = clock64(), g_clock[1] = global_ns();
  x += (size_t)row0 * mm;
  out += (size_t)row0 * lm;

#pragma unroll 4
  for (int i = t; i < rows * mm; i += kThreads) x_s[i] = x[i];
  __syncthreads();

  {  // x @ A: thread on rank columns 4j..4j+3, mm slice t / (r / 4)
    const int groups = r / 4, j = t % groups;
    float acc[kRows][4];
    zero(acc);
    if (mode & 1)
      accumulate(acc, x_s, mm, rows, a, r, 4 * j, t / groups, kThreads / groups, mm,
                 rotate ? (blockIdx.x * 97) % mm : 0);
    warp_reduce(acc, rows, groups);
    if (lane < groups)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < rows)
#pragma unroll
          for (int v = 0; v < 4; ++v) red_s[(warp * tb + i) * r + 4 * j + v] = acc[i][v];
    __syncthreads();
    for (int idx = t; idx < rows * r; idx += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red_s[w * tb * r + idx];
      inter_s[idx] = sum;
    }
    __syncthreads();
  }

  // x @ W0[:, c0:c0+16] + inter @ Bm[:, c0:c0+16]
  constexpr int groups = kCols / 4, slices = kThreads / groups;
  const int c = t % groups, s = t / groups, col = c0 + 4 * c;
  float acc[kRows][4];
  zero(acc);
  if (col < lm) {
    if (mode & 2) accumulate(acc, x_s, mm, rows, w0, lm, col, s, slices, mm, 0);
    if (mode & 4) accumulate(acc, inter_s, r, rows, bm, lm, col, s, slices, r, 0);
  }
  warp_reduce(acc, rows, groups);
  if (lane < groups)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < rows)
#pragma unroll
        for (int v = 0; v < 4; ++v) red_s[(warp * tb + i) * kCols + 4 * c + v] = acc[i][v];
  __syncthreads();
  for (int idx = t; idx < rows * kCols; idx += kThreads) {
    const int i = idx / kCols, cc = idx % kCols, oc = c0 + cc;
    if (oc >= lm) continue;
    float sum = b0[oc] + d[oc];
    for (int w = 0; w < kWarps; ++w) sum += red_s[(w * tb + i) * kCols + cc];
    out[(size_t)i * lm + oc] = gelu_tanh(sum);
  }
  if (timed) g_clock[2] = clock64(), g_clock[3] = global_ns();
}

}  // namespace

int main() {
  const int mm = 768, lm = 2048, r = 32;
  std::vector<float> host(mm * lm);
  unsigned seed = 1;
  for (float& v : host) {
    seed = seed * 1664525u + 1013904223u;
    v = ((seed >> 8) / 16777216.f - 0.5f) * 0.05f;
  }
  for (int B : {4, 64}) {
    if (B > kRows && kRows < 16) continue;
    const int tb = B < kRows ? B : kRows;
    float *x, *w0, *b0, *a, *bm, *d, *out;
    cudaMalloc(&x, B * mm * 4), cudaMalloc(&w0, mm * lm * 4), cudaMalloc(&b0, lm * 4);
    cudaMalloc(&a, mm * r * 4), cudaMalloc(&bm, r * lm * 4), cudaMalloc(&d, lm * 4);
    cudaMalloc(&out, B * lm * 4);
    cudaMemcpy(w0, host.data(), mm * lm * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(x, host.data(), B * mm * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(a, host.data(), mm * r * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(bm, host.data(), r * lm * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(b0, host.data(), lm * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(d, host.data(), lm * 4, cudaMemcpyHostToDevice);
    const int smem = (tb * (mm + r) + kThreads * tb) * 4;
    cudaFuncSetAttribute(lora0_phases, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid(lm / kCols, (B + tb - 1) / tb);
    auto launch = [&](int mode, int rotate) {
      lora0_phases<<<grid, kThreads, smem>>>(x, w0, b0, a, bm, d, out, B, mm, lm, r, tb, mode,
                                             rotate);
    };
    for (int i = 0; i < 2000; ++i) launch(7, 0);
    const struct { const char* name; int mode, rotate; } modes[] = {
        {"all phases", 7, 0},         {"all phases, A rotated", 7, 1},
        {"x load and epilogue", 0, 0}, {"x @ A", 1, 0},
        {"x @ A, rotated", 1, 1},      {"W0 stream", 2, 0},
        {"W0 and Bm", 6, 0}};
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0), cudaEventCreate(&e1);
    for (const auto& m : modes) {
      for (int i = 0; i < 20; ++i) launch(m.mode, m.rotate);
      cudaEventRecord(e0);
      for (int i = 0; i < 200; ++i) launch(m.mode, m.rotate);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      unsigned long long c[4];
      cudaMemcpyFromSymbol(c, g_clock, sizeof(c));
      printf("ROWS %d B %d %-22s %8.2f us/launch (%s); block 0: %llu cycles in %llu ns, %.3f GHz\n",
             kRows, B, m.name, ms * 1e3 / 200, cudaGetErrorString(cudaGetLastError()),
             c[2] - c[0], c[3] - c[1], double(c[2] - c[0]) / double(c[3] - c[1]));
    }
    cudaFree(x), cudaFree(w0), cudaFree(b0), cudaFree(a), cudaFree(bm), cudaFree(d);
    cudaFree(out);
  }
  return 0;
}
