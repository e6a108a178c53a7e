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
// Tiling and schedule.  A block owns an output tile of TY x TZ cells in
// (y, z), TZ = 30 and TY = 14 (bf16) or 12 (f32), and marches along x over
// cx_planes planes.  Step A runs on the tile plus a one-cell halo, HY x HZ =
// (TY + 2) x 32 cells, z fastest.  Shared memory holds a ring of four
// A-planes.  The block is warp-specialised:
//   - producer warps, one per halo row (a lane per z), run step A of plane
//     pl, the cell update of K1 reading f_in and vel_in from device memory,
//     and put f and vel into ring slot pl % 4;
//   - consumer warps, one per output row, run step B of plane xb, pulling
//     A's f from ring planes xb - 1, xb, xb + 1 and A's vel for WALE from
//     the same, and write B's f, rho and vel to device memory.
// They meet through named barriers, one "full" and one "free" per ring
// slot (bar.arrive by the side that signals, bar.sync by the side that
// waits, both counted over the whole block): a producer waits for "free"
// of its slot from the fifth plane on and signals "full" when the plane is
// stored; a consumer waits once for "full" of each plane up to xb + 1 and
// signals "free" of plane xb - 1 when its step B of plane xb is done.  So
// the producers run up to two planes ahead, their device-memory loads in
// flight while the consumers compute from shared memory, and no barrier
// spans the block.  A block starts with A on planes x0 - 1 and x0.  At the
// level's faces A and B take the face conditions exactly as K1 does (loads
// clamped into the level or the ring, then the face slots overwritten), so
// nothing is read beyond the level; B's inlet noise and ghost planes are
// its own.
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
// K1.  But the cell update is bound by instruction throughput before bytes
// (K1's code is ~3,400 instructions a cell, ~730 of them float32 arithmetic,
// tools/sass_counts.py, and it stops at ~60% of its byte bound), and K3
// runs more of them: step A on the halo too (512 cells per 420 outputs in bf16,
// 448 per 360 in f32, plus two extra planes per x-run and the tiles' ragged
// edges), ~2.25-2.5 cell updates per pair against 2.  The ring sets the
// rest: four planes take 135,168 B (bf16) or 215,040 B (f32) of the SM's
// 232,448, so one block of 30 (26) warps with 64 (72) registers a thread is
// resident per SM.  The design answers with the two roles above (A's 27
// loads go out back to back and overlap B's arithmetic; two rows a warp at
// 128 registers was slower, 3.9 against 3.0 ms per pair at 10.8M cells in
// bf16: the kernel's pace follows its resident warps) and x-runs sized so
// that whole waves of blocks fill the SMs.  What it does not do: stage A's
// input planes through shared memory once (the ring leaves no room: the
// three pulls of a plane go through L1/L2 instead), trim the ring to the
// slots B still reads (the Bouzidi term reads the opposite slot at the
// source cell, which a trimmed ring has dropped), or widen the tile (a
// 32 x 32 halo would need 270 KB).  Fusing saves bytes, which do not bound
// the pair on this card: K1 -> K2 -> K1 stays faster (PERF.md).

#include "lbm_cell.cuh"

namespace {

using lbm::st;

constexpr int HZ = 32;      // halo cells along z: a lane each
constexpr int TZ = HZ - 2;  // output cells along z
constexpr int RING = 4;     // A-planes held: xb - 1 .. xb + 2
// named barriers of ring slot s: FULL + s, FREE + s (0 is __syncthreads')
constexpr int FULL = 1;
constexpr int FREE = 1 + RING;

// halo rows along y: what four planes of the ring leave room for
template <typename T>
__host__ __device__ constexpr int halo_rows() {
  return sizeof(T) == 2 ? 16 : 14;
}
// a producer warp per halo row, a consumer warp per output row
template <typename T>
__host__ __device__ constexpr int a_warps() {
  return halo_rows<T>();
}
template <typename T>
__host__ __device__ constexpr int b_warps() {
  return halo_rows<T>() - 2;
}
template <typename T>
__host__ __device__ constexpr int threads() {
  return 32 * (a_warps<T>() + b_warps<T>());
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
  return (size_t)RING * halo_rows<T>() * HZ * (27 * sizeof(T) + 3 * sizeof(float));
}

__device__ __forceinline__ float sm_ld(const float* p) { return *p; }
__device__ __forceinline__ float sm_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// bar.sync waits until `count` threads have arrived at barrier `id`;
// bar.arrive counts the caller in and goes on.  Both order the caller's
// earlier shared-memory accesses before the barrier completes.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// K2's value of slot j at level cell (sx, sy, sz), which the ring holds at
// (slot, i) with the uncorrected value v; the far read is ring (fslot, fi).
// Not inlined: only cells within one cell of the Bouzidi box call it, and
// inlined at each of the 27 pulls it would take registers from every thread.
template <typename T>
__device__ __noinline__ float bz_corrected(const T* ringf, const float* S,
                                           int lx, int ly, int lz, int bx,
                                           int by, int bz, int j, int slot,
                                           int sx, int sy, int sz, int i,
                                           float v, int fslot, int fi) {
  constexpr int NC = halo_rows<T>() * HZ;
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
__global__ void __launch_bounds__(threads<T>(), 1)
fused_pair_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  constexpr int HY = halo_rows<T>(), TY = HY - 2;
  constexpr int NC = HY * HZ;  // halo cells of a plane
  constexpr int NTHR = threads<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ringf = reinterpret_cast<T*>(smem);  // [RING][27][NC]
  float* ringv = reinterpret_cast<float*>(
      smem + (size_t)RING * 27 * NC * sizeof(T));  // [RING][3][NC]

  const int X = p.a.X, Y = p.a.Y, Z = p.a.Z;
  const int warp = threadIdx.x / 32, hz = threadIdx.x % 32;
  const int y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const int x0 = blockIdx.z * p.cx_planes;
  const int x1 = min(x0 + p.cx_planes, X);
  const int z = z0 - 1 + hz;
  // step A makes planes pa0 .. pa1
  const int pa0 = max(x0 - 1, 0), pa1 = min(x1, X - 1);
  const T* fin = static_cast<const T*>(p.f_in);

  if (warp < a_warps<T>()) {
    // ---- producers: step A of halo cell (pl, y, z) -> ring ----
    for (int pl = pa0; pl <= pa1; ++pl) {
      const int slot = pl % RING;
      if (pl - pa0 >= RING) bar_sync(FREE + slot, NTHR);
      const int hy = warp, y = y0 - 1 + hy;
      if (y >= 0 && y < Y && z >= 0 && z < Z) {
        const int i = hy * HZ + hz;
        float f[27], rho, u[3];
        lbm::update_from_global(p.a, p.fld, fin, p.vel_in, pl, y, z, f, rho, u);
#pragma unroll
        for (int k = 0; k < 27; ++k) st(ringf + (slot * 27 + k) * NC, i, f[k]);
#pragma unroll
        for (int c = 0; c < 3; ++c) ringv[(slot * 3 + c) * NC + i] = u[c];
      }
      __threadfence_block();
      bar_arrive(FULL + slot, NTHR);
    }
    return;
  }

  // ---- consumers: step B of tile cell (xb, y, z) -> device memory ----
  const int hy = 1 + warp - a_warps<T>(), y = y0 - 1 + hy;
  const int i = hy * HZ + hz;
  const long long N = (long long)X * Y * Z;
  T* fout = static_cast<T*>(p.f_out);
  int ready = pa0 - 1;  // the last plane known to be in the ring
  for (int xb = x0; xb < x1; ++xb) {
    const int need = min(xb + 1, X - 1);
    while (ready < need) {
      ++ready;
      bar_sync(FULL + ready % RING, NTHR);
    }
    // only cells whose sources (the cell and its neighbours) meet the
    // Bouzidi box look S up: the cells of the box grown by one
    const bool corr = p.S != nullptr &&
                      (unsigned)(xb - p.lx + 1) < (unsigned)(p.bx + 2) &&
                      (unsigned)(y - p.ly + 1) < (unsigned)(p.by + 2) &&
                      (unsigned)(z - p.lz + 1) < (unsigned)(p.bz + 2);
    // ring slots of planes xb - 1, xb, xb + 1
    const int sP = (xb + RING - 1) % RING, s0 = xb % RING, sN = (xb + 1) % RING;
    if (hz >= 1 && hz <= TZ && y < Y && z < Z) {
      auto slot_of = [&](int dx) { return dx < 0 ? sP : (dx == 0 ? s0 : sN); };
      auto A = [&](int slot, int k, int ii) {
        return sm_ld(ringf + (slot * 27 + k) * NC + ii);
      };
      auto corrected = [&](int j, int slot, int sx, int sy, int sz, int ii,
                           float v, int fslot, int fi) {
        return bz_corrected(ringf, p.S, p.lx, p.ly, p.lz, p.bx, p.by, p.bz, j,
                            slot, sx, sy, sz, ii, v, fslot, fi);
      };

      float f[27];
      // beyond a face of the level the ring holds no plane, row or column:
      // the value read there is overwritten by the face's condition
      if (!corr) {
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
          f[k] = A(slot_of(-cx), k, i - cy * HZ - cz);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
          const int slot = slot_of(-cx);
          const int ii = i - cy * HZ - cz;
          f[k] = corrected(k, slot, xb - cx, y - cy, z - cz, ii, A(slot, k, ii),
                           s0, i);
        }
      }
      lbm::apply_faces<G>(
          p.b, xb, y, z,
          [&](int km) {
            const float v = A(s0, km, i);
            const int cx = km % 3 - 1, cy = (km / 3) % 3 - 1, cz = km / 9 - 1;
            return corr ? corrected(km, s0, xb, y, z, i, v, slot_of(cx),
                                    i + cy * HZ + cz)
                        : v;
          },
          f);

      const long long cell = ((long long)xb * Y + y) * Z + z;
      float rho, u[3];
      lbm::collide<G>(
          p.b, p.fld, cell,
          [&](float g[3][3]) {
            const int sE = xb + 1 < X ? sN : s0, sW = xb > 0 ? sP : s0;
            const int iN = i + (y + 1 < Y ? HZ : 0), iS = i - (y > 0 ? HZ : 0);
            const int iT = i + (z + 1 < Z ? 1 : 0), iB = i - (z > 0 ? 1 : 0);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float* V0 = ringv + (s0 * 3 + c) * NC;
              g[c][0] = 0.5f * (ringv[(sE * 3 + c) * NC + i] -
                                ringv[(sW * 3 + c) * NC + i]);
              g[c][1] = 0.5f * (V0[iN] - V0[iS]);
              g[c][2] = 0.5f * (V0[iT] - V0[iB]);
            }
          },
          f, rho, u);

      lbm::store_cell(fout, p.rho_out, p.vel_out, N, cell, f, rho, u);
    }
    // plane xb - 1 is read for the last time: its slot takes plane
    // xb - 1 + RING, if the producers make one
    if (xb - 1 >= pa0 && xb - 1 + RING <= pa1)
      bar_arrive(FREE + (xb - 1) % RING, NTHR);
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

// Output planes per block along x: the split of X into runs that takes the
// fewest plane-times, waves of blocks x (planes of a run + the two A-planes
// a run makes first), with `slots` blocks resident on the card at once;
// runs stay at least 4 planes long.
inline int planes_per_run(int X, long long tiles, long long slots) {
  int best_cx = X;
  long long best_cost = -1;
  for (int runs = 1; runs <= X; ++runs) {
    const int cx = (X + runs - 1) / runs;
    if (cx < 4 && runs > 1) break;
    const long long blocks = tiles * ((X + cx - 1) / cx);
    const long long cost = ((blocks + slots - 1) / slots) * (cx + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_cx = cx;
    }
  }
  return best_cx;
}

template <typename T>
int launch(Params& p, cudaStream_t s) {
  cudaError_t e = opt_in_smem<T>();
  if (e != cudaSuccess) return (int)e;
  static int slots = 0;  // blocks resident on the card at once
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_pair_kernel<T>, threads<T>(), smem_bytes<T>());
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    slots = sms * per_sm;
  }
  constexpr int TY = halo_rows<T>() - 2;
  const dim3 tiles((p.a.Z + TZ - 1) / TZ, (p.a.Y + TY - 1) / TY);
  p.cx_planes = planes_per_run(p.a.X, (long long)tiles.x * tiles.y, slots);
  const dim3 grid(tiles.x, tiles.y, (p.a.X + p.cx_planes - 1) / p.cx_planes);
  fused_pair_kernel<T><<<grid, threads<T>(), smem_bytes<T>(), s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t e = opt_in_smem<T>();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fused_pair_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_pair_kernel<T>, threads<T>(), smem_bytes<T>());
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
    float u_b, int seed_a, int seed_b, const void* rec_t, const void* rec_u,
    int rec_last, int dt_a, int shift_a, int k_a, int dt_b, int shift_b,
    int k_b, double tau, double c_wale,
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
                      sponge_blend) ||
      !lbm::set_record(p.a, rec_t, rec_u, rec_last, dt_a, shift_a, k_a) ||
      !lbm::set_record(p.b, rec_t, rec_u, rec_last, dt_b, shift_b, k_b))
    return (int)cudaErrorInvalidValue;
  p.S = static_cast<const float*>(S);
  p.lx = lx;
  p.ly = ly;
  p.lz = lz;
  p.bx = bx;
  p.by = by;
  p.bz = bz;
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
