// K3: two consecutive stream-collide sub-steps of a childless level in one
// pass (temporal blocking), with the Bouzidi correction of the first one
// between them.
//
// Replaces the Pallas kernel make_pallas_step_fused2
// (open_ludwig_tpu/ops/pallas_step.py:961, pallas_call at :1476).
//
// Equal, within tolerance, to
//   step A: K1 with (u_a, seed_a, iface_a) on (f_in, vel_in);
//   -> K2: Bouzidi correction of A's f from its uncorrected values;
//   -> step B: K1 with (u_b, seed_b, iface_b) on the corrected f and A's vel.
// B's f, rho and vel go to the output buffers (A -> B, never in place).
// B's f is not corrected: the caller runs K2 after, as the TPU kernel's
// caller does (pallas_step.py:1001-1007).
//
// Device memory sees f read once and written once per pair: step A's f
// (storage type) and vel (f32) live only in shared memory.
//
// Tiling.  A block owns an output tile of TY x TZ = 14 x 30 cells in (y, z)
// and marches along x over cx_planes planes.  Its 512 threads map one to
// one onto the tile plus a one-cell halo, HY x HZ = 16 x 32 cells (z
// fastest, one warp per halo row).  Shared memory holds a ring of three
// A-planes.  For each output plane xb:
//   1. every thread runs step A on its halo cell of plane xb + 1 (the cell
//      update of K1, reading f_in and vel_in from device memory) and puts
//      f and vel into the ring;
//   2. __syncthreads;
//   3. the 420 inner threads run step B on plane xb, pulling A's f from the
//      ring planes xb - 1, xb, xb + 1 and A's vel for WALE from the same;
//   4. __syncthreads: the slot of plane xb - 1 takes plane xb + 2 next.
// A block starts with A on planes x0 - 1 and x0.  At the level's faces A
// and B take the face conditions exactly as K1 does, so nothing is read
// beyond the level; B's inlet noise and ghost planes are its own.
//
// Bouzidi where B reads A.  B at cell c pulls slot j from s = c - c_j.
// With k = opp(j), K2 makes that value
//     a A_k(s) + (1 - a) (S < 0 ? A_j(s) : A_k(s - c_k)),  S = S_k(s), a = |S|
// (skipped where S == 0), and s - c_k = s + c_j = c: the far read lies at
// B's own cell.  So every value B needs is on the tile plus its one-cell
// halo, the ring keeps A uncorrected, and neither a second halo nor a
// snapshot is needed.  At a mirror face B reads slot j of c itself; its far
// read c + c_j may leave the level, where the plan sets a = 1, and a = 1
// skips the term (it has weight 0).  The corrected value is rounded to the
// storage type, as K2's store rounds it.  S stays float32 on both storage
// types, as in K2; the TPU kernel casts it to bf16 on bf16 storage
// (pallas_step.py:1038).  K3 + K2 equals K1 -> K2 -> K1 + K2 bit for bit.
//
// What bounds it on an H100.  Per pair, device memory moves about 2 x 27
// sizeof(T) of f + 12 (vel in) + 16 (rho, vel out) + 18 (statics, read by
// both steps) bytes per cell: ~154 B in bf16 against ~290 for K1 -> K2 ->
// K1.  The arithmetic grows instead: step A runs on the halo too (512 cells
// per 420 outputs, plus two extra planes per x-run), ~2.4 cell updates per
// pair against 2, and the two sub-steps inlined into one kernel need more
// than 128 registers a thread.  So K3 is bound by latency at low occupancy,
// not by bytes: one block of 16 warps per SM in f32 (128 registers; ring
// 184,320 B of shared memory), two in bf16 (64 registers with spills; ring
// 101,376 B), with A and B separated by barriers.  This first version does
// nothing more about it: plain loads, no TMA, no overlap of A and B across
// warps.

#include "lbm_cell.cuh"

namespace {

using lbm::st;

constexpr int HZ = 32;       // halo cells along z: one warp per halo row
constexpr int TZ = HZ - 2;   // output cells along z
constexpr int HY = 16;       // halo rows along y
constexpr int TY = HY - 2;   // output rows along y
constexpr int NC = HY * HZ;  // halo cells of a plane = threads per block
constexpr int RING = 3;      // A-planes held: xb - 1, xb, xb + 1
// Resident blocks per SM asked of the compiler (launch bound): one in f32
// (128 registers a thread; the ring takes 184,320 B), two in bf16 (64
// registers, some spilled; 2 x 101,376 B).  Measured against 1-4 blocks of
// 256 and 512 threads on the 10.8M-cell level, these were the fastest.
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}

struct Params {
  const void* f_in;
  const float* vel_in;
  void* f_out;
  float* rho_out;
  float* vel_out;
  lbm::Fields fld;
  lbm::Step a, b;
  const float* S;  // Bouzidi coefficients (27, bx, by, bz), or null
  int lx, ly, lz, bx, by, bz;
  int cx_planes;   // output planes per block along x
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)RING * NC * (27 * sizeof(T) + 3 * sizeof(float));
}

__device__ __forceinline__ float sm_ld(const float* p) { return *p; }
__device__ __forceinline__ float sm_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// K2's value of slot j at level cell (sx, sy, sz), which the ring holds at
// (slot, i) with the uncorrected value v; the far read is ring (fslot, fi).
// Not inlined: only blocks whose sources meet the Bouzidi box call it, and
// inlined at each of the 27 pulls it would take registers from every block.
template <typename T>
__device__ __noinline__ float bz_corrected(const T* ringf, const float* S,
                                           int lx, int ly, int lz, int bx,
                                           int by, int bz, int j, int slot,
                                           int sx, int sy, int sz, int i,
                                           float v, int fslot, int fi) {
  const int dx = sx - lx, dy = sy - ly, dz = sz - lz;
  if ((unsigned)dx >= (unsigned)bx || (unsigned)dy >= (unsigned)by ||
      (unsigned)dz >= (unsigned)bz)
    return v;
  const int k = 26 - j;  // the link direction writing into slot j
  const float s = __ldg(S + (((long long)k * bx + dx) * by + dy) * bz + dz);
  if (s == 0.0f) return v;
  const float a = fabsf(s);
  float other = v;
  if (s > 0.0f) other = a != 1.0f ? sm_ld(ringf + (fslot * 27 + k) * NC + fi) : 0.0f;
  return lbm::to_storage<T>(a * sm_ld(ringf + (slot * 27 + k) * NC + i) +
                            (1.0f - a) * other);
}

template <typename T>
__global__ void __launch_bounds__(NC, min_blocks<T>())
fused_pair_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  extern __shared__ __align__(16) unsigned char smem[];
  T* ringf = reinterpret_cast<T*>(smem);  // [RING][27][NC]
  float* ringv = reinterpret_cast<float*>(
      smem + (size_t)RING * 27 * NC * sizeof(T));  // [RING][3][NC]

  const int X = p.a.X, Y = p.a.Y, Z = p.a.Z;
  const int tid = threadIdx.x;
  const int hy = tid / HZ, hz = tid % HZ;
  const int y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const int x0 = blockIdx.z * p.cx_planes;
  const int x1 = min(x0 + p.cx_planes, X);
  const int y = y0 - 1 + hy, z = z0 - 1 + hz;
  const bool in_level = y >= 0 && y < Y && z >= 0 && z < Z;
  const bool b_cell =
      hy >= 1 && hy <= TY && hz >= 1 && hz <= TZ && y < Y && z < Z;
  const T* fin = static_cast<const T*>(p.f_in);
  // only planes whose sources meet the Bouzidi box look S up
  auto box_near = [&](int xb) {
    return p.S != nullptr && xb + 1 >= p.lx && xb - 1 < p.lx + p.bx &&
           y0 + TY >= p.ly && y0 - 1 < p.ly + p.by && z0 + TZ >= p.lz &&
           z0 - 1 < p.lz + p.bz;
  };

  // ---- step A of halo cell (xa, y, z) -> ring ----
  auto step_a = [&](int xa) {
    float f[27], rho, u[3];
    lbm::update_from_global(p.a, p.fld, fin, p.vel_in, xa, y, z, f, rho, u);
    const int slot = xa % RING;
#pragma unroll
    for (int k = 0; k < 27; ++k) st(ringf + (slot * 27 + k) * NC, tid, f[k]);
#pragma unroll
    for (int c = 0; c < 3; ++c) ringv[(slot * 3 + c) * NC + tid] = u[c];
  };

  // ---- step B of tile cell (xb, y, z) -> device memory ----
  auto step_b = [&](int xb, bool corr) {
    const long long N = (long long)X * Y * Z;
    // ring slots of planes xb - 1, xb, xb + 1
    const int sP = (xb + 2) % RING, s0 = xb % RING, sN = (xb + 1) % RING;
    auto slot_of = [&](int dx) { return dx < 0 ? sP : (dx == 0 ? s0 : sN); };
    auto A = [&](int slot, int k, int i) {
      return sm_ld(ringf + (slot * 27 + k) * NC + i);
    };
    auto corrected = [&](int j, int slot, int sx, int sy, int sz, int i,
                         float v, int fslot, int fi) {
      return bz_corrected(ringf, p.S, p.lx, p.ly, p.lz, p.bx, p.by, p.bz, j,
                          slot, sx, sy, sz, i, v, fslot, fi);
    };

    float f[27];
    lbm::stream_pull<G>(
        p.b, xb, y, z,
        [&](int k, int cx, int cy, int cz) {
          const int slot = slot_of(-cx);
          const int i = tid - cy * HZ - cz;
          const float v = A(slot, k, i);
          return corr ? corrected(k, slot, xb - cx, y - cy, z - cz, i, v,
                                  s0, tid)
                      : v;
        },
        [&](int km) {
          const float v = A(s0, km, tid);
          const int cx = km % 3 - 1, cy = (km / 3) % 3 - 1, cz = km / 9 - 1;
          return corr ? corrected(km, s0, xb, y, z, tid, v, slot_of(cx),
                                  tid + cy * HZ + cz)
                      : v;
        },
        f);

    const long long cell = ((long long)xb * Y + y) * Z + z;
    float rho, u[3];
    lbm::collide<G>(
        p.b, p.fld, cell,
        [&](float g[3][3]) {
          const int sE = xb + 1 < X ? sN : s0, sW = xb > 0 ? sP : s0;
          const int iN = tid + (y + 1 < Y ? HZ : 0), iS = tid - (y > 0 ? HZ : 0);
          const int iT = tid + (z + 1 < Z ? 1 : 0), iB = tid - (z > 0 ? 1 : 0);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* V0 = ringv + (s0 * 3 + c) * NC;
            g[c][0] = 0.5f * (ringv[(sE * 3 + c) * NC + tid] -
                              ringv[(sW * 3 + c) * NC + tid]);
            g[c][1] = 0.5f * (V0[iN] - V0[iS]);
            g[c][2] = 0.5f * (V0[iT] - V0[iB]);
          }
        },
        f, rho, u);

    T* fout = static_cast<T*>(p.f_out);
#pragma unroll
    for (int k = 0; k < 27; ++k) st(fout, (long long)k * N + cell, f[k]);
    p.rho_out[cell] = rho;
    p.vel_out[cell] = u[0];
    p.vel_out[N + cell] = u[1];
    p.vel_out[2 * N + cell] = u[2];
  };

  for (int xa = max(x0 - 1, 0); xa <= x0; ++xa) {
    if (in_level) step_a(xa);
  }
  for (int xb = x0; xb < x1; ++xb) {
    if (in_level && xb + 1 < X) step_a(xb + 1);
    __syncthreads();  // B(xb) reads the plane just made
    if (b_cell) step_b(xb, box_near(xb));
    __syncthreads();  // the slot of plane xb - 1 takes plane xb + 2 next
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per process.
template <typename T>
cudaError_t opt_in_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      fused_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  return e;
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  const cudaError_t attr = opt_in_smem<T>();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.a.Z + TZ - 1) / TZ, (p.a.Y + TY - 1) / TY,
                  (p.a.X + p.cx_planes - 1) / p.cx_planes);
  fused_pair_kernel<T><<<grid, NC, smem_bytes<T>(), s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t e = opt_in_smem<T>();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fused_pair_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_pair_kernel<T>, NC, smem_bytes<T>());
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem = (int)smem_bytes<T>();
  return 0;
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns the CUDA error
// of the launch.  S may be null (no Bouzidi box); pa*/pb* are the ghost
// planes of steps A and B (null on faces that are not interfaces).
extern "C" int ol_fused_pair(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, const void* pa0, const void* pa1, const void* pa2,
    const void* pa3, const void* pa4, const void* pa5, const void* pb0,
    const void* pb1, const void* pb2, const void* pb3, const void* pb4,
    const void* pb5, const void* S, int X, int Y, int Z, int lo_y, int lo_z,
    int bc0, int bc1, int bc2, int bc3, int bc4, int bc5, float u_a,
    float u_b, int seed_a, int seed_b, double tau, double c_wale,
    double nu_sgs, double inlet_turb, int wall_model, int sponge_blend,
    int lx, int ly, int lz, int bx, int by, int bz, void* stream) {
  Params p;
  p.f_in = f_in;
  p.vel_in = static_cast<const float*>(vel_in);
  p.f_out = f_out;
  p.rho_out = static_cast<float*>(rho_out);
  p.vel_out = static_cast<float*>(vel_out);
  p.fld.obstacle = static_cast<const uint8_t*>(obstacle);
  p.fld.sponge = static_cast<const float*>(sponge);
  p.fld.wall = static_cast<const float*>(wall);
  const void* planes_a[6] = {pa0, pa1, pa2, pa3, pa4, pa5};
  const void* planes_b[6] = {pb0, pb1, pb2, pb3, pb4, pb5};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  if (!lbm::make_step(p.a, planes_a, bcs, X, Y, Z, lo_y, lo_z, u_a, seed_a,
                      tau, c_wale, nu_sgs, inlet_turb, wall_model,
                      sponge_blend) ||
      !lbm::make_step(p.b, planes_b, bcs, X, Y, Z, lo_y, lo_z, u_b, seed_b,
                      tau, c_wale, nu_sgs, inlet_turb, wall_model,
                      sponge_blend))
    return (int)cudaErrorInvalidValue;
  p.S = static_cast<const float*>(S);
  p.lx = lx;
  p.ly = ly;
  p.lz = lz;
  p.bx = bx;
  p.by = by;
  p.bz = bz;
  // split x into runs so that ~16 blocks per SM exist; a run re-computes
  // two A-planes at its start, so runs stay at least 4 planes long
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((Z + TZ - 1) / TZ) * ((Y + TY - 1) / TY);
  long long runs = (16LL * sms + tiles - 1) / tiles;
  runs = runs < 1 ? 1 : (runs > X ? X : runs);
  int cx = (int)((X + runs - 1) / runs);
  p.cx_planes = cx < 4 ? 4 : cx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

// Registers and local memory per thread, dynamic shared memory per block
// and resident blocks per SM of K3 for one storage type; returns the CUDA
// error of the queries.
extern "C" int ol_fused_pair_attrs(int store_bf16, int* regs, int* local_bytes,
                                   int* smem, int* blocks_per_sm) {
  return store_bf16
             ? attrs<__nv_bfloat16>(regs, local_bytes, smem, blocks_per_sm)
             : attrs<float>(regs, local_bytes, smem, blocks_per_sm);
}
