// K5: one stream-collide sub-step of an interface-free level, written into
// its own f buffer (in place); rho and vel are fresh outputs.
//
// Replaces the Pallas kernel make_pallas_step_2d with alias_f=True
// (open_ludwig_tpu/ops/pallas_step.py:1575, pallas_call at :2041), which the
// JAX package runs where a whole x-plane exceeds its 1-D kernel's VMEM
// window: the single-level sweep rows from 45 cells per diameter up.  Its
// in-place update is safe there because the TPU grid runs chunks in order
// and every read leads the write it races.  CUDA blocks run in no order,
// so K5 computes what that kernel computes with its own schedule:
//
//   launch 1 (edge_copy_kernel): the level is cut into regions, a (y, z)
//     tile of TY x TZ cells times a run of XR planes along x, one block
//     each.  Every cell that a neighbouring region reads is copied, before
//     any write, into the edge buffer: on each inner region boundary, the
//     last row (plane, column) of the lower region with the 9 slots that
//     stream up across it, and the first row of the upper region with the
//     9 slots that stream down.  Ex (2 per x-run boundary, 9, Y, Z), Ey
//     (2 per y-tile boundary, 9, X, Z), Ez (2 per z-tile boundary, 9, X, Y).
//   launch 2 (inplace_kernel): each block marches its tile along its run,
//     one thread per (y, z).  At plane xb a thread pulls
//       - from another region: the edge buffer, looked up in the order
//         x-run, y-tile, z-tile (each buffer spans the other two axes
//         whole, so corners are found there too);
//       - from plane xb - 1 of its own region (cx = +1): shared memory,
//         which holds the old cx = +1 slots of the tile's previous plane;
//       - from planes xb and xb + 1 of its own region: f itself, which no
//         thread has written yet;
//     and saves its own cell's old cx = +1 slots of plane xb to shared
//     memory.  One barrier, then the collision writes plane xb in place.
// No value is read after its cell is written, and no block reads another
// block's cells from f, so the result is K1's (the per-cell code of
// lbm_cell.cuh) bit for bit.  f is written while the kernel runs, so its
// loads are ld_cg (L2, coherent), not the read-only __ldg; the edge buffer,
// vel and the statics are read-only and keep __ldg.
//
// What bounds it on an H100: device-memory bytes, like K1 (~145 B per cell
// per bf16 sub-step), plus the edge buffer, written once and read once:
// 2/3 of a slot set per tile row, ~2 (9 / 27) / TY + the same for TZ and
// XR, i.e. ~11% of f at 432 x 384 x 384 (~17 B per cell).  What it saves
// is memory: no second f copy (3.4 GB at 63.7M cells in bf16).  The march
// along x keeps one barrier per plane and 9 slots per cell in shared
// memory; it does nothing more about latency.

#include "lbm_cell.cuh"

namespace {

using lbm::st;

constexpr int TZ = 32;       // tile cells along z: one warp per row
constexpr int TY = 8;        // tile rows along y
constexpr int NT = TY * TZ;  // threads per block

struct Layout {
  int X, Y, Z;
  int XR;                // planes per x-run
  int NR, NTY, NTZ;      // x-runs, y-tiles, z-tiles
  long long nx, ny, nz;  // elements of Ex, Ey, Ez in the edge buffer
};

__host__ __device__ inline Layout make_layout(int X, int Y, int Z, int XR) {
  Layout L;
  L.X = X;
  L.Y = Y;
  L.Z = Z;
  L.XR = XR;
  L.NR = (X + XR - 1) / XR;
  L.NTY = (Y + TY - 1) / TY;
  L.NTZ = (Z + TZ - 1) / TZ;
  L.nx = 18LL * (L.NR - 1) * Y * Z;
  L.ny = 18LL * (L.NTY - 1) * X * Z;
  L.nz = 18LL * (L.NTZ - 1) * X * Y;
  return L;
}

// Slot k of edge slot index j (0..8) for a set that streams along an axis:
// the x sets are k % 3 == 2 (cx = +1, even entries) or 0 (cx = -1, odd);
// the y sets (k / 3) % 3 == 2 or 0; the z sets k / 9 == 2 or 0.
__host__ __device__ constexpr int kx(int j, bool up) { return 3 * j + (up ? 2 : 0); }
__host__ __device__ constexpr int ky(int j, bool up) {
  return j % 3 + (up ? 6 : 0) + 9 * (j / 3);
}
__host__ __device__ constexpr int kz(int j, bool up) { return j + (up ? 18 : 0); }

template <typename T>
__global__ void __launch_bounds__(256)
edge_copy_kernel(const T* __restrict__ f, T* __restrict__ edge, const Layout L) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = L.nx + L.ny + L.nz;
  if (e >= total) return;
  const long long N = (long long)L.X * L.Y * L.Z;
  long long idx;
  int x, y, z, j, e2, k;
  if (e < L.nx) {
    idx = e;
    z = (int)(idx % L.Z); idx /= L.Z;
    y = (int)(idx % L.Y); idx /= L.Y;
    j = (int)(idx % 9); e2 = (int)(idx / 9);
    const bool up = (e2 & 1) == 0;  // last plane of run b, read by run b + 1
    x = ((e2 >> 1) + 1) * L.XR - (up ? 1 : 0);
    k = kx(j, up);
  } else if (e < L.nx + L.ny) {
    idx = e - L.nx;
    z = (int)(idx % L.Z); idx /= L.Z;
    x = (int)(idx % L.X); idx /= L.X;
    j = (int)(idx % 9); e2 = (int)(idx / 9);
    const bool up = (e2 & 1) == 0;
    y = ((e2 >> 1) + 1) * TY - (up ? 1 : 0);
    k = ky(j, up);
  } else {
    idx = e - L.nx - L.ny;
    y = (int)(idx % L.Y); idx /= L.Y;
    x = (int)(idx % L.X); idx /= L.X;
    j = (int)(idx % 9); e2 = (int)(idx / 9);
    const bool up = (e2 & 1) == 0;
    z = ((e2 >> 1) + 1) * TZ - (up ? 1 : 0);
    k = kz(j, up);
  }
  edge[e] = f[(long long)k * N + ((long long)x * L.Y + y) * L.Z + z];
}

struct Params {
  void* f;  // read and written in place
  const float* vel_in;
  float* rho_out;
  float* vel_out;
  void* edge;  // written by the edge copy, read by the step
  lbm::Fields fld;
  lbm::Step s;
  Layout L;
};

template <typename T>
__device__ __forceinline__ float sm_ld(const T* p) {
  if (sizeof(T) == 2)
    return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
  return *reinterpret_cast<const float*>(p);
}

template <typename T>
__global__ void __launch_bounds__(NT) inplace_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  // old cx = +1 slots of a tile plane: [2][9][NT] of the storage type
  __shared__ __align__(16) unsigned char save_raw[2 * 9 * NT * sizeof(T)];
  T(*save)[9][NT] = reinterpret_cast<T(*)[9][NT]>(save_raw);
  const Layout& L = p.L;
  const int X = L.X, Y = L.Y, Z = L.Z;
  const long long N = (long long)X * Y * Z;
  const long long YZ = (long long)Y * Z, XZ = (long long)X * Z,
                  XY = (long long)X * Y;
  const int tid = threadIdx.x;
  const int ty = tid / TZ, tz = tid % TZ;
  const int bz_ = blockIdx.x, by_ = blockIdx.y, r = blockIdx.z;
  const int y = by_ * TY + ty, z = bz_ * TZ + tz;
  const int x0 = r * L.XR, x1 = min(x0 + L.XR, X);
  const bool in_level = y < Y && z < Z;
  T* f = static_cast<T*>(p.f);
  const T* ex = static_cast<const T*>(p.edge);
  const T* ey = ex + L.nx;
  const T* ez = ey + L.ny;

  for (int xb = x0; xb < x1; ++xb) {
    const long long cell = ((long long)xb * Y + y) * Z + z;
    float fv[27];
    if (in_level) {
      const int sp = (xb - 1) & 1;
      lbm::stream_pull<G>(
          p.s, xb, y, z,
          [&](int k, int cx, int cy, int cz) -> float {
            const int xs = xb - cx, ys = y - cy, zs = z - cz;
            if (cx == 1 && xb == x0)  // last plane of run r - 1
              return lbm::ld(ex, ((2LL * (r - 1)) * 9 + k / 3) * YZ +
                                     (long long)ys * Z + zs);
            if (cx == -1 && xb == x1 - 1)  // first plane of run r + 1
              return lbm::ld(ex, ((2LL * r + 1) * 9 + k / 3) * YZ +
                                     (long long)ys * Z + zs);
            const int jy = k % 3 + 3 * (k / 9);
            if (cy == 1 && ty == 0)  // last row of y-tile by_ - 1
              return lbm::ld(ey, ((2LL * (by_ - 1)) * 9 + jy) * XZ +
                                     (long long)xs * Z + zs);
            if (cy == -1 && ty == TY - 1)  // first row of y-tile by_ + 1
              return lbm::ld(ey, ((2LL * by_ + 1) * 9 + jy) * XZ +
                                     (long long)xs * Z + zs);
            if (cz == 1 && tz == 0)  // last column of z-tile bz_ - 1
              return lbm::ld(ez, ((2LL * (bz_ - 1)) * 9 + k % 9) * XY +
                                     (long long)xs * Y + ys);
            if (cz == -1 && tz == TZ - 1)  // first column of z-tile bz_ + 1
              return lbm::ld(ez, ((2LL * bz_ + 1) * 9 + k % 9) * XY +
                                     (long long)xs * Y + ys);
            if (cx == 1)  // plane xb - 1 of this tile, already written
              return sm_ld(&save[sp][k / 3][(ty - cy) * TZ + (tz - cz)]);
            return lbm::ld_cg(f, (long long)k * N +
                                     ((long long)xs * Y + ys) * Z + zs);
          },
          [&](int km) { return lbm::ld_cg(f, (long long)km * N + cell); }, fv);
      const int sc = xb & 1;
#pragma unroll
      for (int j = 0; j < 9; ++j)
        st(&save[sc][j][0], tid, lbm::ld_cg(f, (long long)kx(j, true) * N + cell));
    }
    // every old value of plane xb is read (and its cx = +1 slots saved)
    // before any thread of the tile writes the plane
    __syncthreads();
    if (in_level) {
      float rho, u[3];
      lbm::collide<G>(
          p.s, p.fld, cell,
          [&](float g[3][3]) {
            lbm::vel_grad_global(p.s, p.vel_in, xb, y, z, cell, g);
          },
          fv, rho, u);
#pragma unroll
      for (int k = 0; k < 27; ++k) st(f, (long long)k * N + cell, fv[k]);
      p.rho_out[cell] = rho;
      p.vel_out[cell] = u[0];
      p.vel_out[N + cell] = u[1];
      p.vel_out[2 * N + cell] = u[2];
    }
  }
}

// Planes per x-run: enough runs that ~16 blocks per SM exist, runs at
// least 8 planes long.
int planes_per_run(int X, int Y, int Z) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long tiles = (long long)((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
  long long runs = (16LL * sms + tiles - 1) / tiles;
  const long long max_runs = (X + 7) / 8;
  runs = runs < 1 ? 1 : (runs > max_runs ? max_runs : runs);
  return (int)((X + runs - 1) / runs);
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  const Layout& L = p.L;
  const long long total = L.nx + L.ny + L.nz;
  if (total > 0) {
    const long long blocks = (total + 255) / 256;
    edge_copy_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(p.f), static_cast<T*>(p.edge), L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(L.NTZ, L.NTY, L.NR);
  inplace_kernel<T><<<grid, NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, inplace_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                      inplace_kernel<T>, NT, 0);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem = (int)fa.sharedSizeBytes;
  return 0;
}

}  // namespace

// The run length K5 uses on this card for an (X, Y, Z) level, and the
// number of storage elements its edge buffer needs.
extern "C" int ol_inplace_layout(int X, int Y, int Z, int* xr,
                                 long long* edge_elems) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  *xr = planes_per_run(X, Y, Z);
  const Layout L = make_layout(X, Y, Z, *xr);
  *edge_elems = L.nx + L.ny + L.nz;
  return 0;
}

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches the edge
// copy and the in-place step on `stream`, never synchronises, allocates
// nothing: `edge` holds ol_inplace_layout's element count of the storage
// type.  Returns the CUDA error of the launches, or cudaErrorInvalidValue
// for a level with an interface face.
extern "C" int ol_stream_collide_inplace(
    int store_bf16, void* f, const void* vel_in, void* rho_out, void* vel_out,
    void* edge, const void* obstacle, const void* sponge, const void* wall,
    int X, int Y, int Z, int lo_y, int lo_z, int bc0, int bc1, int bc2,
    int bc3, int bc4, int bc5, float u_inlet, int seed, double tau,
    double c_wale, double nu_sgs, double inlet_turb, int wall_model,
    int sponge_blend, int xr, void* stream) {
  Params p;
  p.f = f;
  p.vel_in = static_cast<const float*>(vel_in);
  p.rho_out = static_cast<float*>(rho_out);
  p.vel_out = static_cast<float*>(vel_out);
  p.edge = edge;
  p.fld.obstacle = static_cast<const uint8_t*>(obstacle);
  p.fld.sponge = static_cast<const float*>(sponge);
  p.fld.wall = static_cast<const float*>(wall);
  const void* planes[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  for (int i = 0; i < 6; ++i)
    if (bcs[i] == lbm::BC_INTERFACE) return (int)cudaErrorInvalidValue;
  if (xr < 1 || !lbm::make_step(p.s, planes, bcs, X, Y, Z, lo_y, lo_z,
                                u_inlet, seed, tau, c_wale, nu_sgs,
                                inlet_turb, wall_model, sponge_blend))
    return (int)cudaErrorInvalidValue;
  p.L = make_layout(X, Y, Z, xr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

// Registers and local memory per thread, static shared memory per block and
// resident blocks per SM of K5's in-place step for one storage type.
extern "C" int ol_stream_collide_inplace_attrs(int store_bf16, int* regs,
                                               int* local_bytes, int* smem,
                                               int* blocks_per_sm) {
  return store_bf16
             ? attrs<__nv_bfloat16>(regs, local_bytes, smem, blocks_per_sm)
             : attrs<float>(regs, local_bytes, smem, blocks_per_sm);
}
