// The Bouzidi correction over a list of linked slots in one cooperative
// launch, shared by K2 (bouzidi.cu, the signed single array S) and K6
// (bouzidi_ab.cu, the two arrays A and B).  Each encoding gives a Link: its
// arrays and two device members,
//
//   value(f, i)  link i's corrected value from the uncorrected f, in float32
//   dst(i)       the element of f it is stored to (slot j of its cell)
//
// (reference: src/bouzidi_kernel.jl:38-88).  f* is the UNCORRECTED
// post-collision f: where the fluid gap is thin, or a cell has links in both
// directions, one link reads a slot another link writes.  So the launch
// runs in two phases with one barrier between them:
//   phase 1: every thread computes its links' values from f and keeps them,
//     the first REG in registers, the rest in the plan's float32 scratch
//     (one value per link);
//   the barrier: a cooperative launch (every block resident) and
//     `this_grid().sync()` order every read before any write;
//   phase 2: the same threads store their values into f, in the storage
//     type (bf16 rounded to nearest even).
// No snapshot tensor, no allocation per call (so a CUDA graph can hold
// it); any link count works, since threads stride over the links.  A
// thread-block cluster (one launch of 16 blocks of 1,024 threads, the
// barrier `cluster.sync()`) was as right and slower on the device: 8.2-8.4
// against 5.2-5.4 us per application of K2 on the bench box, replayed from a
// CUDA graph (PERF.md), so the grid barrier stays.
//
// What bounds it on an H100: the links' bytes are a few hundred kB (two
// reads and one write of f and 13-17 B of link data each), under a
// microsecond at the card's memory rate, so a call is its launch and the
// latency of its two dependent loads (the link, then f) and the barrier.
// The lists are sorted by slot, then by cell: a warp's loads and stores of
// f run along z.

#pragma once

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bzlinks {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int REG = 4;  // link values a thread keeps in registers

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, class Link>
__global__ void __launch_bounds__(THREADS)
link_kernel(const Link link, T* f, float* scratch, int n) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  float keep[REG];
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int i = first + r * stride;
    if (i < n) keep[r] = link.value(f, i);
  }
  for (int i = first + REG * stride; i < n; i += stride)
    scratch[i] = link.value(f, i);
  grid.sync();  // every link read before any is written
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int i = first + r * stride;
    if (i < n) st(f, link.dst(i), keep[r]);
  }
  for (int i = first + REG * stride; i < n; i += stride)
    st(f, link.dst(i), scratch[i]);
}

// The blocks of link_kernel<T, Link> the current card holds at once (every
// block of a cooperative launch must be resident).  Asked once per card (a
// sharded level's slabs may lie on several).
template <typename T, class Link>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cached[dev & 63];
  if (!c) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, link_kernel<T, Link>,
                                                  THREADS, 0);
    c = sms * per_sm;
  }
  return c;
}

// One cooperative launch over the n links on `stream`: never synchronises,
// allocates nothing; returns the launch's CUDA error (0 on success).
template <typename T, class Link>
int launch(const Link& link, void* f, void* scratch, int n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  // one link a thread where the card holds them all (3.8 us on the bench
  // box against 5.3 with four a thread, PERF.md); beyond that each thread
  // keeps up to REG values in registers and the rest in the scratch
  const int blocks = (int)std::min<long long>(resident_blocks<T, Link>(),
                                              ((long long)n + THREADS - 1) / THREADS);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  Link l = link;
  T* fp = static_cast<T*>(f);
  float* sp = static_cast<float*>(scratch);
  void* args[] = {&l, &fp, &sp, &n};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      (void*)link_kernel<T, Link>, dim3(blocks), dim3(THREADS), args, 0, stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace bzlinks
