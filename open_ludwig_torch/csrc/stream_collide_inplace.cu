// K5: one stream-collide sub-step of an interface-free level, written into
// its own f buffer (in place); rho and vel are fresh outputs.
//
// Replaces the Pallas kernel make_pallas_step_2d with alias_f=True
// (open_ludwig_tpu/ops/pallas_step.py:1575, pallas_call at :2041), which the
// JAX package runs where a whole x-plane exceeds its 1-D kernel's VMEM
// window: the single-level sweep rows from 45 cells per diameter up.  Its
// in-place update is safe there because the TPU grid runs chunks in order
// and every read leads the write it races.  CUDA blocks run in no order,
// so K5 computes what that kernel computes with its own schedule
// (ops/inplace_layout.py holds the layout, which this file mirrors):
//
//   launch 1 (edge_copy_kernel): the level is cut into regions, TY rows
//     along y times all of z times a run of XR planes along x, one block
//     each.  Every cell that another region reads is copied, before any
//     write, into the edge buffer: on each inner region boundary, the last
//     plane (row) of the lower region with the 9 slots that stream up
//     across it, and the first plane (row) of the upper region with the 9
//     slots that stream down.  Ex (2 per x-run boundary, 9, Y, Z), Ey (2
//     per y-tile boundary, 9, X, Z); both copies run along z, a block a
//     line, coalesced.
//   launch 2 (inplace_kernel): a block of 512 threads walks its region in
//     z-chunks of CZ cells, TY x CZ = 512 (a thread per cell of a chunk
//     plane, a warp inside one row), and, inside a chunk, marches along x.
//     At plane xb of chunk c a thread pulls
//       - from another region: the edge buffer, x-run over y-tile (each
//         buffer spans the other axes whole, so corners are found there);
//       - from plane xb - 1 (cx = +1), already written: shared memory,
//         which holds the old cx = +1 slots of the chunk's previous plane;
//       - from chunk c - 1 (cz = +1, the chunk's first lane), already
//         written on every plane: shared memory, where the last lane of
//         chunk c - 1 left the old cz = +1 slots of its column for every
//         plane of the run;
//       - from planes xb, xb + 1 of its chunk and from chunk c + 1: f
//         itself, which no thread has written yet;
//     and saves its own cell's old cx = +1 slots (the last lane also its
//     cz = +1 slots).  Then the collision, one barrier, and the stores of
//     plane xb.
// No value is read after its cell is written, and no block reads another
// block's cells from f, so the result is K1's (the per-cell code of
// lbm_cell.cuh) bit for bit.
//
// What bounds it on an H100: like K1, instruction throughput before bytes (~145
// B per cell per bf16 sub-step against ~3,400 instructions of code, ~4,000
// here, tools/sass_counts.py), plus what the
// schedule adds: the edge buffer, written once and read once, 18 / 27 of f
// per boundary, i.e. (2 / 3) (1 / TY + 1 / XR) of f; nine loads and shared
// stores a cell for the save; a block whose warps move in step.  What it
// saves is memory: no second f copy (3.4 GB at 63.7M cells in bf16).  What
// the design does about it:
//   - rows span all of z, so no z boundary has an edge buffer, a strided
//     gather or a per-lane path through device memory; the only per-lane
//     sources are the first lane's nine slots from shared memory and the
//     last lane's three cx = +1, cz = -1 slots from f, overwritten after
//     the loads;
//   - every other source is chosen per (cx, cy) pair by a warp-uniform (y
//     edge) or block-uniform (x edge) test, its three slots then loaded
//     through one running pointer plus the clamped offsets of
//     lbm::neighbours; the level's faces are overwritten afterwards
//     (lbm::apply_faces);
//   - a chunk row is 128 bytes, one L2 line (see chunk_cells);
//   - the collision comes before the barrier, so a warp waits there for
//     the other warps' arithmetic, not for their loads;
//   - the 9 own-cell loads for the save are not re-reads: the old cx = +1
//     slots of plane xb are pulled by nobody at plane xb and are gone at
//     plane xb + 1, so each f value is still loaded once;
//   - f is written while the kernel runs, so its loads stay off the
//     read-only path (no __ldg).  They are plain loads, cached in L1, not
//     ld.cg: every read of f (and of the edge buffer) wants the value from
//     before this launch, a block reads only cells that no block has
//     written yet, and a line cached before its cell is written can only
//     hold that old value; L1 is cleared between launches.  vel and the
//     statics keep __ldg.

#include "lbm_cell.cuh"

namespace {

using lbm::st;

constexpr int NT = 512;  // threads of a block
// Cells of a z-chunk: 128 bytes of a row, so that the warps of a row read
// one whole L2 line of each slot at a time (64 cells in bf16, two warps a
// row; 32 in f32).  A copy of f in this kernel's order ran at 4.27 ms with
// 64-byte row pieces against 2.93 ms with 128-byte ones (63.7M cells, bf16,
// NVIDIA H100 80GB HBM3, 700 W; 2.55 ms in linear order;
// tools/probe_copy_order.py).
template <typename T>
__host__ __device__ constexpr int chunk_cells() {
  return 128 / (int)sizeof(T);
}
// Rows of a y-tile: a lane per cell of a chunk plane.
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return NT / chunk_cells<T>();
}

struct Layout {
  int X, Y, Z;
  int TY, XR;        // rows per y-tile, planes per x-run
  int NR, NTY;       // x-runs, y-tiles
  long long nx, ny;  // elements of Ex, Ey in the edge buffer
};

inline Layout make_layout(int X, int Y, int Z, int TY, int XR) {
  Layout L;
  L.X = X;
  L.Y = Y;
  L.Z = Z;
  L.TY = TY;
  L.XR = XR;
  L.NR = (X + XR - 1) / XR;
  L.NTY = (Y + TY - 1) / TY;
  L.nx = 18LL * (L.NR - 1) * Y * Z;
  L.ny = 18LL * (L.NTY - 1) * X * Z;
  return L;
}

// Slot k of edge slot index j (0..8) for a set that streams along an axis:
// the x sets are k % 3 == 2 (cx = +1, even entries) or 0 (cx = -1, odd);
// the y sets (k / 3) % 3 == 2 or 0.
__host__ __device__ constexpr int kx(int j, bool up) { return 3 * j + (up ? 2 : 0); }
__host__ __device__ constexpr int ky(int j, bool up) {
  return j % 3 + (up ? 6 : 0) + 9 * (j / 3);
}

// One block per line of Z cells of the edge buffer: the divisions that find
// the line's slot and source are made once per line, not per cell.
template <typename T>
__global__ void __launch_bounds__(128)
edge_copy_kernel(const T* __restrict__ f, T* __restrict__ edge, const Layout L) {
  const long long N = (long long)L.X * L.Y * L.Z;
  const int lines_x = 18 * (L.NR - 1) * L.Y;
  int line = blockIdx.x;
  int x, y, k;
  if (line < lines_x) {
    y = line % L.Y;
    const int e = line / L.Y, j = e % 9, e2 = e / 9;
    const bool up = (e2 & 1) == 0;  // last plane of run b, read by run b + 1
    x = ((e2 >> 1) + 1) * L.XR - (up ? 1 : 0);
    k = kx(j, up);
  } else {
    const int l = line - lines_x;
    x = l % L.X;
    const int e = l / L.X, j = e % 9, e2 = e / 9;
    const bool up = (e2 & 1) == 0;
    y = ((e2 >> 1) + 1) * L.TY - (up ? 1 : 0);
    k = ky(j, up);
  }
  const T* src = f + (long long)k * N + ((long long)x * L.Y + y) * L.Z;
  T* dst = edge + (long long)line * L.Z;
  for (int z = threadIdx.x; z < L.Z; z += blockDim.x) dst[z] = src[z];
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
  // SHARD: the neighbour slabs' edge planes, (27, 2, Y, Z) in the storage
  // type and (3, 2, Y, Z) float32, copied before any slab's launch
  const void* fedge;
  const float* vedge;
};

template <typename T>
__device__ __forceinline__ float sm_ld(const T* p) {
  if (sizeof(T) == 2)
    return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
  return *reinterpret_cast<const float*>(p);
}

// Shared memory of a block: the old cx = +1 slots of the chunk's last two
// planes, [2][9][NT], then the old cz = +1 slots of the last column of
// the last two chunks on every plane of the run, [2][9][XR][TY].
template <typename T>
size_t smem_bytes(int XR) {
  return (size_t)(2 * 9 * NT + 2 * 9 * XR * tile_rows<T>()) * sizeof(T);
}

// Two blocks per SM: 64 registers a thread (a few spilled), 32 warps.  One
// block of 16 warps with 100-108 registers and no spill was slower (12.1
// against 9.0 ms at 63.7M cells, bf16, with 32-cell chunks): the warps of a
// block move in step, so the second block is what fills their stalls.
// SHARD = true: the level is one x slab (Step::x_off, gX) of a sharded
// level; the slots pulled across its x ends come from p.fedge (side 0 for
// cx = +1 at x = 0, side 1 for cx = -1 at x = X - 1), chosen first, over
// the run and tile edges, and the x faces hold only at the global ends.
template <typename T, bool SHARD = false>
__global__ void __launch_bounds__(NT, 2) inplace_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  constexpr int CZ = chunk_cells<T>(), TY = tile_rows<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* save = reinterpret_cast<T*>(smem);  // [2][9][NT]
  T* col = save + 2 * 9 * NT;            // [2][9][XR][TY]
  const Layout& L = p.L;
  const int X = L.X, Y = L.Y, Z = L.Z, XR = L.XR;
  const long long N = (long long)X * Y * Z;
  const int YZ = Y * Z, XZ = X * Z;
  const int tid = threadIdx.x;
  const int ty = tid / CZ, tz = tid % CZ;
  const int t = blockIdx.x, r = blockIdx.y;
  const int y0 = t * TY, y = y0 + ty;
  const int x0 = r * XR, x1 = min(x0 + XR, X);
  T* f = static_cast<T*>(p.f);
  const T* ex = static_cast<const T*>(p.edge);
  const T* ey = ex + L.nx;
  // whose rows this warp pulls from the y edge buffer (warp-uniform): the
  // last row of tile t - 1 (cy = +1), the first row of tile t + 1 (cy = -1)
  const bool ey_lo = ty == 0 && t > 0;
  const bool ey_hi = ty == TY - 1 && y + 1 < Y;
  // rows of the tile that hold this row's y neighbours, at [cy + 1]; beyond
  // the tile or the level: any row (an edge or a face supplies the value)
  const int row[3] = {min(ty + 1, TY - 1), ty, max(ty - 1, 0)};

  for (int c = 0; c * CZ < Z; ++c) {
    const int z = c * CZ + tz;
    const bool in_level = y < Y && z < Z;
    const bool lane_lo = tz == 0 && c > 0;           // cz = +1 from chunk c - 1
    const bool lane_hi = tz == CZ - 1 && z + 1 < Z;  // cz = -1 from chunk c + 1
    // lanes of the chunk that hold this cell's z neighbours, at [cz + 1]
    const int lane[3] = {min(tz + 1, CZ - 1), tz, max(tz - 1, 0)};
    long long cell = ((long long)x0 * Y + y) * Z + z;
    for (int xb = x0; xb < x1; ++xb, cell += YZ) {
      float fv[27];
      float rho, u[3];
      if (in_level) {
        const lbm::Nbr nb = lbm::neighbours(p.s, xb, y, z);
        // planes this block pulls from the x edge buffer (block-uniform)
        const bool ex_lo = xb == x0 && x0 > 0;       // cx = +1: run r - 1
        const bool ex_hi = xb == x1 - 1 && x1 < X;   // cx = -1: run r + 1
        // SHARD: the slab's own ends, whose sources lie in the neighbour
        // slabs (block-uniform)
        const bool sx_lo = SHARD && xb == 0;
        const bool sx_hi = SHARD && xb == X - 1;
        const T* pc = f + cell;
        const int yz = y * Z + z;
        // the source plane of cx, clamped, as an x index, at [cx + 1]
        const int xs[3] = {min(xb + 1, X - 1), xb, max(xb - 1, 0)};
        // One (cx, cy) pair at a time, its three slots (cz = -1, 0, +1)
        // from one source, chosen by block- and warp-uniform tests: the x
        // edge over the y edge over (cx = +1) shared memory over f.
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int cx = a - 1, cy = b - 1;
            const int k0 = a + 3 * b;  // the pair's slots: k0, k0 + 9, k0 + 18
            if ((cx == 1 && sx_lo) || (cx == -1 && sx_hi)) {
              const int side = cx == 1 ? 0 : 1;
              const T* q = static_cast<const T*>(p.fedge) +
                           (long long)(2 * k0 + side) * YZ + (yz + nb.dy[b]);
#pragma unroll
              for (int d = 0; d < 3; ++d)
                fv[k0 + 9 * d] = lbm::ld(q + (long long)(18 * d) * YZ, nb.dz[d]);
            } else if ((cx == 1 && ex_lo) || (cx == -1 && ex_hi)) {
              const int e = cx == 1 ? 2 * (r - 1) : 2 * r + 1;
              const T* q = ex + (long long)(e * 9 + b) * YZ + (yz + nb.dy[b]);
#pragma unroll
              for (int d = 0; d < 3; ++d)
                fv[k0 + 9 * d] = lbm::ld_plain(q + (long long)(3 * d) * YZ, nb.dz[d]);
            } else if ((cy == 1 && ey_lo) || (cy == -1 && ey_hi)) {
              const int e = cy == 1 ? 2 * (t - 1) : 2 * t + 1;
              const T* q = ey + (long long)(e * 9 + a) * XZ + (xs[a] * Z + z);
#pragma unroll
              for (int d = 0; d < 3; ++d)
                fv[k0 + 9 * d] = lbm::ld_plain(q + (long long)(3 * d) * XZ, nb.dz[d]);
            } else if (cx == 1) {
              // plane xb - 1 of this chunk; lanes 0 and 31 read the
              // neighbouring lane for cz = +1 / -1: overwritten below
              const T* q = save + ((xs[a] & 1) * 9 + b) * NT + row[b] * CZ;
#pragma unroll
              for (int d = 0; d < 3; ++d)
                fv[k0 + 9 * d] = sm_ld(q + (3 * d) * NT + lane[d]);
            } else {
              const T* q = pc + k0 * N + (nb.dx[a] + nb.dy[b]);
#pragma unroll
              for (int d = 0; d < 3; ++d)
                fv[k0 + 9 * d] = lbm::ld_plain(q + 9 * d * N, nb.dz[d]);
            }
          }
        }
        if (lane_lo) {
          // cz = +1 sources in chunk c - 1, written on every plane: the
          // column that lane 31 of that chunk saved
          const T* colp = col + ((c - 1) & 1) * 9 * XR * TY;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              const int cx = a - 1, cy = b - 1;
              const bool edge = (cx == 1 && (ex_lo || sx_lo)) ||
                                (cx == -1 && (ex_hi || sx_hi)) ||
                                (cy == 1 && ey_lo) || (cy == -1 && ey_hi);
              if (!edge)
                fv[18 + a + 3 * b] =
                    sm_ld(&colp[((a + 3 * b) * XR + (xs[a] - x0)) * TY + row[b]]);
            }
          }
        }
        if (lane_hi && !ex_lo && !sx_lo) {
          // cx = +1, cz = -1 sources in chunk c + 1: not written yet
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int cy = b - 1;
            if (!((cy == 1 && ey_lo) || (cy == -1 && ey_hi)))
              fv[2 + 3 * b] =
                  lbm::ld_plain(pc + (2 + 3 * b) * N, nb.dx[2] + nb.dy[b] + 1);
          }
        }
        lbm::apply_faces<G, true, SHARD>(
            p.s, xb, y, z,
            [&](int km) { return lbm::ld_plain(pc + km * N, 0); }, fv);
        // the old values of this cell that later pulls need: its cx = +1
        // slots for plane xb + 1 (nobody pulls them at plane xb, so these
        // loads read each value once, not twice), and from lane 31 its
        // cz = +1 slots for chunk c + 1
        {
          const T* q = pc + 2 * N;
          T* sv = save + (xb & 1) * 9 * NT + tid;
#pragma unroll
          for (int j = 0; j < 9; ++j) st(sv, j * NT, lbm::ld_plain(q + 3 * j * N, 0));
        }
        if (lane_hi) {
          const T* q = pc + 18 * N;
          T* cv = col + (c & 1) * 9 * XR * TY + (xb - x0) * TY + ty;
#pragma unroll
          for (int j = 0; j < 9; ++j) st(cv, j * XR * TY, lbm::ld_plain(q + j * N, 0));
        }
        lbm::collide<G>(
            p.s, p.fld, cell,
            [&](float g[3][3]) {
              if (SHARD)
                lbm::vel_grad_slab(p.s, p.vel_in + cell, N, nb, xb, p.vedge, yz, g);
              else
                lbm::vel_grad_global(p.vel_in + cell, N, nb, g);
            },
            fv, rho, u);
      }
      // every old value of plane xb of the chunk is read or saved before
      // any thread of the block writes the plane; the collision, which
      // needs the loads, comes before the barrier, so a warp waits there
      // for the other warps' arithmetic and not for their loads
      __syncthreads();
      if (in_level)
        lbm::store_cell(f, p.rho_out, p.vel_out, N, cell, fv, rho, u);
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, which holds on the
// current card; the largest request seen is kept per instantiation and card.
template <typename T, bool SHARD = false>
cudaError_t opt_in_smem(size_t bytes) {
  static size_t granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  size_t& g = granted[dev & 63];
  if (bytes <= (g ? g : 48 * 1024)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      inplace_kernel<T, SHARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e == cudaSuccess) g = bytes;
  return e;
}

template <typename T, bool SHARD = false>
int launch(const Params& p, int parts, cudaStream_t s) {
  const long long lines = (p.L.nx + p.L.ny) / p.L.Z;
  if ((parts & 1) && lines > 0) {
    edge_copy_kernel<T><<<(unsigned)lines, 128, 0, s>>>(
        static_cast<const T*>(p.f), static_cast<T*>(p.edge), p.L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (parts & 2) {
    const size_t bytes = smem_bytes<T>(p.L.XR);
    const cudaError_t e = opt_in_smem<T, SHARD>(bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(p.L.NTY, p.L.NR);
    inplace_kernel<T, SHARD><<<grid, NT, bytes, s>>>(p);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename T>
int attrs(int xr, int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  const size_t bytes = smem_bytes<T>(xr);
  cudaFuncAttributes fa;
  cudaError_t e = opt_in_smem<T>(bytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, inplace_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, inplace_kernel<T>, NT, bytes);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem = (int)bytes;
  return 0;
}

}  // namespace

namespace {

// Host side: fills p; false for a level with an interface face or a tile
// height `ty` that is not the storage type's.
bool make_params(
    Params& p, int store_bf16, void* f, const void* vel_in, void* rho_out,
    void* vel_out, void* edge, const void* obstacle, const void* sponge,
    const void* wall, int X, int Y, int Z, int lo_y, int lo_z, int bc0,
    int bc1, int bc2, int bc3, int bc4, int bc5, float u_inlet, int seed,
    const void* rec_t, const void* rec_u, int rec_last, int rec_dt,
    int rec_shift, int rec_k, double tau, double c_wale, double nu_sgs,
    double inlet_turb, int wall_model, int sponge_blend, int ty, int xr,
    int parts) {
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
  p.fedge = nullptr;
  p.vedge = nullptr;
  for (int i = 0; i < 6; ++i)
    if (bcs[i] == lbm::BC_INTERFACE) return false;
  const int rows = store_bf16 ? tile_rows<__nv_bfloat16>() : tile_rows<float>();
  if (xr < 1 || ty != rows || parts < 1 || parts > 3 ||
      !lbm::make_step(p.s, planes, bcs, X, Y, Z, lo_y, lo_z, u_inlet, seed,
                      tau, c_wale, nu_sgs, inlet_turb, wall_model,
                      sponge_blend) ||
      !lbm::set_record(p.s, rec_t, rec_u, rec_last, rec_dt, rec_shift, rec_k))
    return false;
  p.L = make_layout(X, Y, Z, ty, xr);
  return true;
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches the edge
// copy (parts & 1) and the in-place step (parts & 2) on `stream`, never
// synchronises, allocates nothing: `edge` holds the layout's element count
// of the storage type (18 (NR - 1) Y Z + 18 (NTY - 1) X Z for runs of `xr`
// planes and the storage type's tile rows, ops/inplace_layout.py).  A
// caller passes parts = 3; the two launches are timed apart with 1 and 2.
// Returns the CUDA error of the launches, or cudaErrorInvalidValue for a
// level with an interface face or a tile height `ty` that is not the
// storage type's.
extern "C" int ol_stream_collide_inplace(
    int store_bf16, void* f, const void* vel_in, void* rho_out, void* vel_out,
    void* edge, const void* obstacle, const void* sponge, const void* wall,
    int X, int Y, int Z, int lo_y, int lo_z, int bc0, int bc1, int bc2,
    int bc3, int bc4, int bc5, float u_inlet, int seed, const void* rec_t,
    const void* rec_u, int rec_last, int rec_dt, int rec_shift, int rec_k,
    double tau, double c_wale, double nu_sgs, double inlet_turb,
    int wall_model, int sponge_blend, int ty, int xr, int parts,
    void* stream) {
  Params p;
  if (!make_params(p, store_bf16, f, vel_in, rho_out, vel_out, edge, obstacle,
                   sponge, wall, X, Y, Z, lo_y, lo_z, bc0, bc1, bc2, bc3, bc4,
                   bc5, u_inlet, seed, rec_t, rec_u, rec_last, rec_dt,
                   rec_shift, rec_k, tau, c_wale, nu_sgs, inlet_turb,
                   wall_model, sponge_blend, ty, xr, parts))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? launch<__nv_bfloat16>(p, parts, s)
                    : launch<float>(p, parts, s);
}

// The sharded form (the JAX package's make_pallas_step_2d with shard_nx,
// pallas_step.py:1647-1694): one x slab (27, X, Y, Z) of a level of gX
// planes from global plane x_off, written in place, with the neighbour
// slabs' edge planes f_edges (27, 2, Y, Z, storage type) and v_edges
// (3, 2, Y, Z, float32) beside the slab's own edge buffer.  Every slab's
// edge planes are copied before any slab's launch (a slab's launch
// overwrites the planes its neighbours read).
extern "C" int ol_stream_collide_inplace_shard(
    int store_bf16, void* f, const void* vel_in, void* rho_out, void* vel_out,
    void* edge, const void* f_edges, const void* v_edges, int x_off, int gX,
    const void* obstacle, const void* sponge, const void* wall,
    int X, int Y, int Z, int lo_y, int lo_z, int bc0, int bc1, int bc2,
    int bc3, int bc4, int bc5, float u_inlet, int seed, const void* rec_t,
    const void* rec_u, int rec_last, int rec_dt, int rec_shift, int rec_k,
    double tau, double c_wale, double nu_sgs, double inlet_turb,
    int wall_model, int sponge_blend, int ty, int xr, int parts,
    void* stream) {
  Params p;
  if (!make_params(p, store_bf16, f, vel_in, rho_out, vel_out, edge, obstacle,
                   sponge, wall, X, Y, Z, lo_y, lo_z, bc0, bc1, bc2, bc3, bc4,
                   bc5, u_inlet, seed, rec_t, rec_u, rec_last, rec_dt,
                   rec_shift, rec_k, tau, c_wale, nu_sgs, inlet_turb,
                   wall_model, sponge_blend, ty, xr, parts) ||
      !f_edges || !v_edges || x_off < 0 || x_off + X > gX)
    return (int)cudaErrorInvalidValue;
  p.fedge = f_edges;
  p.vedge = static_cast<const float*>(v_edges);
  p.s.x_off = x_off;
  p.s.gX = gX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? launch<__nv_bfloat16, true>(p, parts, s)
                    : launch<float, true>(p, parts, s);
}

// Registers and local memory per thread, dynamic shared memory per block
// and resident blocks per SM of K5's in-place step for one storage type
// and run length.
extern "C" int ol_stream_collide_inplace_attrs(int store_bf16, int xr,
                                               int* regs, int* local_bytes,
                                               int* smem, int* blocks_per_sm) {
  if (xr < 1) return (int)cudaErrorInvalidValue;
  return store_bf16
             ? attrs<__nv_bfloat16>(xr, regs, local_bytes, smem, blocks_per_sm)
             : attrs<float>(xr, regs, local_bytes, smem, blocks_per_sm);
}
