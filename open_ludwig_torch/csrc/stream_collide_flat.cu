// K4: one stream-collide sub-step of an interface-free level, with the
// flat-(y, z) index algebra.
//
// Replaces the Pallas kernel make_pallas_step_flat
// (open_ludwig_tpu/ops/pallas_step.py:2100, pallas_call at :2411), which the
// JAX package runs on level 1 of every multi-level case (the wind tunnel:
// inlet, outlet and mirror faces, no interface).
//
// The port stores every level as (27, X, Y, Z) without padding, which is
// the same memory as the flat (27, X, M) view with n = y * Z + z and
// M = Y * Z.  One thread per (x, n), n fastest.  Per cell:
//   1. streaming: slot k reads one flat offset, plane x - cx (clamped into
//      the level) at n - (cy * Z + cz) (clamped into [0, M)), with no
//      branch.  Where that source is not the cell's true neighbour (a z
//      row wrapped into the next y row, a y end, an x end), the cell lies
//      on a face row of the slot's direction;
//   2. boundary masks in the TPU kernel's order z -> y -> x, later masks
//      winning (pallas_step.py:2299-2310): each such row takes its face's
//      condition, so every wrapped value is overwritten.  Interface faces
//      are refused: a ghost row would not overwrite it;
//   3. collision of lbm_cell.cuh with the velocity neighbours of K1 (flat
//      offsets +-M, +-Z, +-1, the cell itself beyond a face).
// So K4 equals K1 bit for bit on an interface-free level.  A -> B buffers
// as in K1: level 1 is a parent, and its pre-step state feeds the child's
// ghost planes after the step (solver_dense.py).
//
// What bounds it on an H100: the bench case's level 1 is 64 x 56 x 56
// (0.2M cells): at ~145 B per cell in bf16 the kernel moves ~29 MB, ~9 us
// at 3.35 TB/s, so launch latency and the host's enqueue set its pace.  It
// keeps K1's coalesced z-fastest rows; the branch-free loads do nothing
// more about it, and need none.

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
stream_collide_flat_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  const int X = p.s.X, Y = p.s.Y, Z = p.s.Z;
  const int M = Y * Z;
  const long long N = (long long)X * M;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= N) return;
  const int x = N <= 0xffffffffLL ? (int)((unsigned)cell / (unsigned)M)
                                  : (int)(cell / M);
  const int n = (int)(cell - (long long)x * M);
  const int y = n / Z, z = n - y * Z;
  const T* fin = static_cast<const T*>(p.f_in);

  float f[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
    const int xs = min(max(x - cx, 0), X - 1);
    const int ns = min(max(n - (cy * Z + cz), 0), M - 1);
    f[k] = lbm::ld(fin, (long long)k * N + (long long)xs * M + ns);
  }
  const float inlet_fac = lbm::inlet_factor<G>(p.s, x, y, z);
  auto mirror = [&](int km) { return lbm::ld(fin, (long long)km * N + cell); };
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
    int face = -1;
    if (cz > 0 && z == 0) face = 4;
    else if (cz < 0 && z == Z - 1) face = 5;
    if (cy > 0 && y == 0) face = 2;
    else if (cy < 0 && y == Y - 1) face = 3;
    if (cx < 0 && x == X - 1) face = 1;
    else if (cx > 0 && x == 0) face = 0;
    if (face >= 0)
      f[k] = lbm::face_value<G>(p.s, k, face, x, y, z, inlet_fac, mirror);
  }

  float rho, u[3];
  lbm::collide<G>(
      p.s, p.fld, cell,
      [&](float g[3][3]) {
        lbm::vel_grad_global(p.vel_in + cell, N, lbm::neighbours(p.s, x, y, z), g);
      },
      f, rho, u);

  lbm::store_cell(static_cast<T*>(p.f_out), p.rho_out, p.vel_out, N, cell, f,
                  rho, u);
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns the CUDA error of
// the launch, or cudaErrorInvalidValue for a level with an interface face.
extern "C" int ol_stream_collide_flat(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, int X, int Y, int Z, int lo_y, int lo_z, int bc0,
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
  const void* planes[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  for (int i = 0; i < 6; ++i)
    if (bcs[i] == lbm::BC_INTERFACE) return (int)cudaErrorInvalidValue;
  if (!lbm::make_step(p.s, planes, bcs, X, Y, Z, lo_y, lo_z, u_inlet, seed,
                      tau, c_wale, nu_sgs, inlet_turb, wall_model,
                      sponge_blend))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)X * Y * Z;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16) {
    stream_collide_flat_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(p);
  } else {
    stream_collide_flat_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
