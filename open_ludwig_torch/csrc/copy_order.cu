// Measurement probe (tools/probe_copy_order.py): a copy of the 27 slots of
// an (27, X, Y, Z) array, a thread per cell, in three orders of the cells:
//   kind 0: linear, as K1 walks a level;
//   kind 1: K5's order: a block owns `ty` rows x all of z x a run of `xr`
//     planes, walks it in z-chunks of `cw` cells and marches along x
//     inside a chunk;
//   kind 2: the same region, x outermost and the z-chunks inside a plane.
// It computes nothing, so what it times is how the card's memory takes the
// order: a row piece of `cw` cells is what a block reads of one slot at a
// time.  One barrier per step, as in K5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void linear_kernel(const T* a, T* b, long long N) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  T v[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) v[k] = a[k * N + c];
#pragma unroll
  for (int k = 0; k < 27; ++k) b[k * N + c] = v[k];
}

template <typename T>
__global__ void region_kernel(const T* a, T* b, int X, int Y, int Z, int ty,
                              int cw, int xr, int x_outer) {
  const long long N = (long long)X * Y * Z;
  const int row = threadIdx.x / cw, tz = threadIdx.x % cw;
  const int y = blockIdx.x * ty + row;
  const int x0 = blockIdx.y * xr, x1 = min(x0 + xr, X);
  const int nc = (Z + cw - 1) / cw, np = x1 - x0;
  for (int it = 0; it < nc * np; ++it) {
    const int c = x_outer ? it % nc : it / np;
    const int xb = x0 + (x_outer ? it / nc : it % np);
    const int z = c * cw + tz;
    const bool in = y < Y && z < Z;
    const long long cell = ((long long)xb * Y + y) * Z + z;
    T v[27];
    if (in) {
#pragma unroll
      for (int k = 0; k < 27; ++k) v[k] = a[k * N + cell];
    }
    __syncthreads();
    if (in) {
#pragma unroll
      for (int k = 0; k < 27; ++k) b[k * N + cell] = v[k];
    }
  }
}

template <typename T>
int run(int kind, const void* a, void* b, int X, int Y, int Z, int ty, int cw,
        int xr, cudaStream_t s) {
  const long long N = (long long)X * Y * Z;
  if (kind == 0) {
    linear_kernel<T><<<(unsigned)((N + 127) / 128), 128, 0, s>>>(
        static_cast<const T*>(a), static_cast<T*>(b), N);
  } else {
    if (ty < 1 || cw < 1 || xr < 1 || ty * cw > 1024)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((Y + ty - 1) / ty, (X + xr - 1) / xr);
    region_kernel<T><<<grid, ty * cw, 0, s>>>(static_cast<const T*>(a),
                                              static_cast<T*>(b), X, Y, Z, ty,
                                              cw, xr, kind == 2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes in tools/probe_copy_order.py): one copy
// of `elem_bytes`-wide (2 or 4) elements on `stream`; returns the CUDA error
// of the launch.
extern "C" int ol_copy_order(int elem_bytes, int kind, const void* a, void* b,
                             int X, int Y, int Z, int ty, int cw, int xr,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  return elem_bytes == 2 ? run<uint16_t>(kind, a, b, X, Y, Z, ty, cw, xr, s)
                         : run<float>(kind, a, b, X, Y, Z, ty, cw, xr, s);
}
