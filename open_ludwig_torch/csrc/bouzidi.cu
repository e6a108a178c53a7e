// K2: Bouzidi interpolated bounce-back on the finest level, over the plan's
// list of linked slots, in one cooperative launch.
//
// Replaces the Pallas kernel make_bouzidi_pallas
// (open_ludwig_tpu/ops/pallas_step.py:62, pallas_call at :133).
//
// The signed single-array encoding of build_bouzidi_dense_plan, listed per
// link by dense_step.bouzidi_links: link i writes slot j at `cell`, with
// k = opp(j) = 26 - j, a = |S_k(cell)| and
//
//   other = code & SELF ? f*_j(cell) : f*_k(src)   (src = cell - c_k, wrapped
//                                                   inside the box)
//   f_j(cell) = a f*_k(cell) + (1 - a) other
//
// f* is the UNCORRECTED post-collision f: where the fluid gap is thin, or a
// cell has links in both directions, one link reads a slot another link
// writes.  So the launch runs in two phases with one barrier between them:
//   phase 1: every thread computes its links' values from f (the expression
//     of the box sweep, csrc/bouzidi_box.cuh, in the same operand order, so
//     the same contraction) and keeps them, the first REG in registers, the
//     rest in the plan's float32 scratch (one value per link);
//   the barrier: a cooperative launch (every block resident) and
//     `this_grid().sync()` order every read before any write;
//   phase 2: the same threads store their values into f, in the storage
//     type (bf16 rounded to nearest even).
// No snapshot tensor, no allocation per call (so a CUDA graph can hold
// it); any link count works, since threads stride over the links.  A
// thread-block cluster (one launch of 16 blocks of 1,024 threads, the
// barrier `cluster.sync()`) was as right and slower on the device: 8.2-8.4
// against 5.2-5.4 us per application on the bench box, replayed from a
// CUDA graph (PERF.md), so the grid barrier stays.
//
// What bounds it on an H100: the links' bytes are a few hundred kB (two
// reads and one write of f and 13 B of link data each), under a
// microsecond at the card's memory rate, so a call is its launch and the
// latency of its two dependent loads (the link, then f) and the barrier.
// The list is sorted by slot, then by cell: a warp's loads and stores of f
// run along z.  S stays float32 on both storage types; the correction is
// form-invariant under the g = f - w shift (the weights sum to 1 and
// w[opp k] = w[k]).

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int REG = 4;  // link values a thread keeps in registers
constexpr unsigned SELF = 0x80;

struct Params {
  void* f;
  const int* cell;
  const uint8_t* code;
  const int* src;
  const float* a;
  float* scratch;
  int n;
  long long N;  // cells of the level
};

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float link_value(const Params& p, const T* f, int i) {
  const long long cell = p.cell[i];
  const unsigned code = p.code[i];
  const int j = code & 31u, k = 26 - j;
  const float a = p.a[i];
  const float other = ld(f, (long long)((code & SELF) ? j : k) * p.N + p.src[i]);
  const float b = 1.0f - a;
  return a * ld(f, (long long)k * p.N + cell) + b * other;
}

template <typename T>
__device__ __forceinline__ void link_store(const Params& p, T* f, int i, float v) {
  st(f, (long long)(p.code[i] & 31u) * p.N + p.cell[i], v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) link_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  T* f = static_cast<T*>(p.f);
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  float keep[REG];
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int i = first + r * stride;
    if (i < p.n) keep[r] = link_value(p, f, i);
  }
  for (int i = first + REG * stride; i < p.n; i += stride)
    p.scratch[i] = link_value(p, f, i);
  grid.sync();  // every link read before any is written
#pragma unroll
  for (int r = 0; r < REG; ++r) {
    const int i = first + r * stride;
    if (i < p.n) link_store(p, f, i, keep[r]);
  }
  for (int i = first + REG * stride; i < p.n; i += stride)
    link_store(p, f, i, p.scratch[i]);
}

// The blocks of link_kernel<T> the card holds at once (every block of a
// cooperative launch must be resident).  Asked once.
template <typename T>
int resident_blocks() {
  static int cached = 0;
  if (!cached) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, link_kernel<T>, THREADS, 0);
    cached = sms * per_sm;
  }
  return cached;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  // one link a thread where the card holds them all (3.8 us on the bench
  // box against 5.3 with four a thread, PERF.md); beyond that each thread
  // keeps up to REG values in registers and the rest in the scratch
  const int blocks = (int)std::min<long long>(resident_blocks<T>(),
                                              ((long long)p.n + THREADS - 1) / THREADS);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  Params q = p;
  void* args[] = {&q};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      (void*)link_kernel<T>, dim3(blocks), dim3(THREADS), args, 0, stream);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns the launch's
// CUDA error (0 on success).
extern "C" int ol_bouzidi(int store_bf16, void* f, const void* cell,
                          const void* code, const void* src, const void* a,
                          void* scratch, int n, int X, int Y, int Z,
                          void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f;
  p.cell = static_cast<const int*>(cell);
  p.code = static_cast<const uint8_t*>(code);
  p.src = static_cast<const int*>(src);
  p.a = static_cast<const float*>(a);
  p.scratch = static_cast<float*>(scratch);
  p.n = n;
  p.N = (long long)X * Y * Z;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
