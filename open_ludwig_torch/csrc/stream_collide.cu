// K1: one stream-collide sub-step of one dense refinement level.
//
// Replaces the Pallas kernel make_pallas_step
// (open_ludwig_tpu/ops/pallas_step.py:247, pallas_call at :883).
//
// One thread per cell of the unpadded (X, Y, Z) box, z fastest, so a warp
// reads 32 consecutive cells of each population row.  Per cell
// (lbm_cell.cuh, shared with K3):
//   1. pull streaming: population k comes from cell - c_k of the A buffer
//      (f_in), loaded from that source clamped into the box, 27 loads back
//      to back; where the source lies outside the box the face's boundary
//      condition then overwrites it;
//   2. collision: moments, sponge blend, wall model, WALE omega from the six
//      face-neighbour velocities of vel_in, regularized BGK + Guo forcing;
//   3. f, rho and vel go to the B buffer.  Concurrent CTAs run in no
//      order, so the TPU kernel's in-place f (safe there only because its
//      grid runs in order) does not carry over.
//
// What bounds it on an H100: device-memory bytes.  A bf16 step moves about
// 27*2 (read f) + 27*2 (write f) + 12 (read vel) + 16 (write rho, vel)
// + 9 (statics) ~= 145 bytes per cell against ~1-2k flops, far below the
// card's flops-per-byte balance.  This first version keeps every access
// coalesced along z and reads through the read-only cache, and does nothing
// else about it: neighbour rows are re-read from L1/L2 instead of being
// staged in shared memory, and the 27 populations live in registers.

#include "lbm_cell.cuh"

namespace {

struct Params {
  const void* f_in;
  const float* vel_in;
  void* f_out;
  float* rho_out;
  float* vel_out;
  lbm::Fields fld;
  lbm::Step s;
};

template <typename T>
__global__ void __launch_bounds__(128)
stream_collide_kernel(const Params p) {
  const int Y = p.s.Y, Z = p.s.Z;
  const long long N = (long long)p.s.X * Y * Z;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= N) return;
  int x, y, z;
  if (N <= 0xffffffffLL) {  // 32-bit divisions: a fraction of the 64-bit ones
    const unsigned c = (unsigned)cell, r = c / (unsigned)Z;
    z = (int)(c - r * (unsigned)Z);
    x = (int)(r / (unsigned)Y);
    y = (int)(r - (unsigned)x * (unsigned)Y);
  } else {
    z = (int)(cell % Z);
    const long long r = cell / Z;
    y = (int)(r % Y);
    x = (int)(r / Y);
  }

  float f[27], rho, u[3];
  lbm::update_from_global(p.s, p.fld, static_cast<const T*>(p.f_in), p.vel_in,
                          x, y, z, f, rho, u);

  lbm::store_cell(static_cast<T*>(p.f_out), p.rho_out, p.vel_out, N, cell, f,
                  rho, u);
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns
// cudaGetLastError() of the launch.
extern "C" int ol_stream_collide(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, const void* plane0, const void* plane1,
    const void* plane2, const void* plane3, const void* plane4,
    const void* plane5, int X, int Y, int Z, int lo_y, int lo_z, int bc0,
    int bc1, int bc2, int bc3, int bc4, int bc5, float u_inlet, int seed,
    double tau, double c_wale, double nu_sgs, double inlet_turb,
    int wall_model, int sponge_blend, void* stream) {
  Params p;
  p.f_in = f_in;
  p.vel_in = static_cast<const float*>(vel_in);
  p.f_out = f_out;
  p.rho_out = static_cast<float*>(rho_out);
  p.vel_out = static_cast<float*>(vel_out);
  p.fld.obstacle = static_cast<const uint8_t*>(obstacle);
  p.fld.sponge = static_cast<const float*>(sponge);
  p.fld.wall = static_cast<const float*>(wall);
  const void* planes[6] = {plane0, plane1, plane2, plane3, plane4, plane5};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  if (!lbm::make_step(p.s, planes, bcs, X, Y, Z, lo_y, lo_z, u_inlet, seed,
                      tau, c_wale, nu_sgs, inlet_turb, wall_model,
                      sponge_blend))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)X * Y * Z;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16) {
    stream_collide_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(p);
  } else {
    stream_collide_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
