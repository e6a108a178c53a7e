// K2: Bouzidi interpolated bounce-back on the finest level's boundary box.
//
// Replaces the Pallas kernel make_bouzidi_pallas
// (open_ludwig_tpu/ops/pallas_step.py:62, pallas_call at :133).
//
// One thread per cell of the (bx, by, bz) box at offset (lx, ly, lz) of
// the level.  For every slot j != 13 with link direction k = opp(j):
//
//   S = S_k(cell);  a = |S|
//   other = S < 0 ? f*_j(cell) : f*_k(cell + c_opp(k))
//   f_j(cell) = a f*_k(cell) + (1 - a) other        (skipped where S == 0)
//
// (reference: src/bouzidi_kernel.jl:38-88; the signed single-array
// encoding of build_bouzidi_dense_plan).  f* is the UNCORRECTED
// post-collision box, which the wrapper snapshots into a (27, bx, by, bz)
// scratch tensor before the launch: corrected in place without it, row k
// at cell + c_opp could be read after another thread overwrote it.  The
// shifted read wraps inside the box exactly like the plain version's roll
// (a wrapped value only meets a = 1, weight 0).
//
// S stays float32 on both storage types; f is float32 f or bf16 g = f - w
// (the correction is form-invariant under the shift since the weights sum
// to 1 and w[opp k] = w[k]); math in float32, stores round to nearest even.
//
// What bounds it on an H100: launch latency and bytes.  The box of the
// Re~1M bench level is a few MB; the kernel reads the snapshot and S once
// and writes only the linked slots, coalesced along z.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(128)
bouzidi_kernel(const T* __restrict__ snap, const float* __restrict__ S,
               T* __restrict__ f, int bx, int by, int bz, int lx, int ly,
               int lz, int Y, int Z, long long N) {
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
    const float s = S[(long long)k * nb + i];
    if (s == 0.0f) continue;
    const float a = fabsf(s);
    float other;
    if (s < 0.0f) {
      other = ld(snap, (long long)j * nb + i);
    } else {
      // f*_k at cell + c_opp(k) = cell - c_k, wrapped inside the box
      const int cxk = k % 3 - 1, cyk = (k / 3) % 3 - 1, czk = k / 9 - 1;
      const int nx = (ix - cxk + bx) % bx;
      const int ny = (iy - cyk + by) % by;
      const int nz = (iz - czk + bz) % bz;
      other = ld(snap, (long long)k * nb + ((long long)nx * by + ny) * bz + nz);
    }
    const float val = a * ld(snap, (long long)k * nb + i) + (1.0f - a) * other;
    st(f, (long long)j * N + dst, val);
  }
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns
// cudaGetLastError() of the launch.
extern "C" int ol_bouzidi(int store_bf16, const void* snap, const void* S,
                          void* f, int bx, int by, int bz, int lx, int ly,
                          int lz, int X, int Y, int Z, void* stream) {
  const long long nb = (long long)bx * by * bz;
  const long long N = (long long)X * Y * Z;
  const int threads = 128;
  const long long blocks = (nb + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Sf = static_cast<const float*>(S);
  if (store_bf16) {
    bouzidi_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(snap), Sf,
        static_cast<__nv_bfloat16*>(f), bx, by, bz, lx, ly, lz, Y, Z, N);
  } else {
    bouzidi_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(snap), Sf, static_cast<float*>(f), bx, by,
        bz, lx, ly, lz, Y, Z, N);
  }
  return (int)cudaGetLastError();
}
