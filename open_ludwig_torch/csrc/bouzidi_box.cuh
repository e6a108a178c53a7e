// The Bouzidi box sweep of K6 (csrc/bouzidi_ab.cu, the retired two-array
// coefficients A and B), written for any coefficient encoding (a Link
// functor).  K2 (csrc/bouzidi.cu) runs over the plan's link list instead;
// the probe (tools/probe_bz_encoding.py) times the two designs.
//
// One thread per cell of the (bx, by, bz) box at offset (lx, ly, lz) of an
// (X, Y, Z) level.  For every slot j != 13 with link direction k = opp(j)
// (= 26 - j), the encoding's Link gives, at box index k * nb + i,
// (a, b, self) or "no link":
//
//   other    = self ? f*_j(cell) : f*_k(cell + c_opp(k))
//   f_j(cell) = a f*_k(cell) + b other                (only where linked)
//
// (reference: src/bouzidi_kernel.jl:38-88).  f* is the UNCORRECTED
// post-collision box, which the wrappers snapshot into a (27, bx, by, bz)
// scratch tensor before the launch: corrected in place without it, row k
// at cell + c_opp could be read after another thread overwrote it.  The
// shifted read wraps inside the box, as the plain version's roll does (a
// wrapped value only meets a zero weight).  f is float32 f or bf16
// g = f - w; math in float32, stores round to nearest even.
//
// What bounds it on an H100: launch latency and bytes.  The box of the
// Re~1M bench level is a few MB; each thread reads the snapshot and the
// coefficients once and writes only the linked slots, coalesced along z.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace bzbox {

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, typename Link>
__global__ void __launch_bounds__(128)
box_kernel(const T* __restrict__ snap, Link link, T* __restrict__ f, int bx,
           int by, int bz, int lx, int ly, int lz, int Y, int Z, long long N) {
  const long long nb = (long long)bx * by * bz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  const int iz = (int)(i % bz);
  const long long r = i / bz;
  const int iy = (int)(r % by);
  const int ix = (int)(r / by);
  const long long dst = ((long long)(lx + ix) * Y + (ly + iy)) * Z + (lz + iz);
#pragma unroll
  for (int j = 0; j < 27; ++j) {
    if (j == 13) continue;
    const int k = 26 - j;  // the link direction writing into slot j
    float a, b;
    bool self;
    if (!link(k * nb + i, a, b, self)) continue;
    float other;
    if (self) {
      other = ld(snap, (long long)j * nb + i);
    } else {
      // f*_k at cell + c_opp(k) = cell - c_k, wrapped inside the box
      const int cxk = k % 3 - 1, cyk = (k / 3) % 3 - 1, czk = k / 9 - 1;
      const int nx = (ix - cxk + bx) % bx;
      const int ny = (iy - cyk + by) % by;
      const int nz = (iz - czk + bz) % bz;
      other = ld(snap, (long long)k * nb + ((long long)nx * by + ny) * bz + nz);
    }
    const float val = a * ld(snap, (long long)k * nb + i) + b * other;
    st(f, (long long)j * N + dst, val);
  }
}

// Launches box_kernel on `stream`: never synchronises, allocates nothing;
// returns cudaGetLastError() of the launch.
template <typename T, typename Link>
int launch_box(const void* snap, Link link, void* f, int bx, int by, int bz,
               int lx, int ly, int lz, int X, int Y, int Z, void* stream) {
  const long long nb = (long long)bx * by * bz;
  const long long N = (long long)X * Y * Z;
  const int threads = 128;
  const long long blocks = (nb + threads - 1) / threads;
  box_kernel<T, Link><<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(snap), link, static_cast<T*>(f), bx, by, bz, lx,
      ly, lz, Y, Z, N);
  return (int)cudaGetLastError();
}

}  // namespace bzbox
