// The cell body of one stream-collide sub-step on a flat grid, shared by K1
// (stream_collide.cu, every level) and K4 (stream_collide_flat.cu, levels
// without interface faces): one thread per cell of the unpadded (X, Y, Z)
// box, z fastest, so a warp reads 32 consecutive cells of each population
// row.  Per cell (the physics is lbm_cell.cuh's):
//   1. pull streaming: population k comes from cell - c_k of the A buffer
//      (f_in), 27 loads back to back, x and y clamped into the level, z
//      not: a z source beyond the level lies beyond a z face, whose
//      condition then overwrites the slot (apply_faces), and its address
//      stays inside f (one element past a plane's end or before its start,
//      in a neighbouring plane);
//   2. collision (collide_values): moments, sponge blend, wall model, WALE
//      omega from the six face-neighbour velocities of vel_in, regularized
//      BGK + Guo forcing;
//   3. f, rho and vel go to the B buffer.  Concurrent CTAs run in no
//      order, so the TPU kernels' in-place f (safe there only because their
//      grid runs in order) does not carry over.
// What the addressing does about the instructions a cell costs:
//   - the 27 slot addresses are one wide add each: the plane base pointers
//     are kernel parameters and the offsets 32-bit (make_params checks
//     N + 2 YZ < 2^31), with the z offsets +-1 immediate;
//   - the flat cell index is decoded without a division: a multiply-high
//     and a shift by Z's and Y's round-up reciprocals (exact below 2^31).
// IFACE = false (K4) compiles the interface faces' ghost-plane reads out of
// the face conditions; the Step's six plane pointers are then never read.
// SHARD = true is the form for one x slab of a sharded level (the JAX
// package's shard_nx > 1, ops/pallas_step.py:562-611): the array is the
// slab's (27, XL, Y, Z), and the slots pulled across its x ends come from
// the neighbour slabs' edge planes `fedge` (27, 2, Y, Z), storage type,
// [:, 0] the previous slab's last plane and [:, 1] the next one's first,
// shifted in y and z like any source (the clamped rows lie on y or z faces,
// which overwrite them); then the faces, x faces only at the level's global
// ends (lbm::apply_faces<..., SHARD>); velocity neighbours across the ends
// from `vedge` (3, 2, Y, Z) float32.  SHARD = false compiles all of this out.

#pragma once

#include "lbm_cell.cuh"

namespace sc {

// n / d for n < 2^31 without a division: q = umulhi(n, m) >> s with
// m = ceil(2^(31 + L) / d), L = ceil(log2 d), s = L - 1 (Granlund and
// Montgomery's round-up reciprocal; exact for 31-bit n); d = 1 has m = 0.
struct Divisor {
  unsigned m, s;
};
static inline Divisor make_divisor(unsigned d) {
  if (d <= 1) return {0u, 0u};
  unsigned L = 0;
  while ((1ull << L) < d) ++L;
  const unsigned long long m = ((1ull << (31 + L)) + d - 1) / d;
  return {(unsigned)m, L - 1};
}
__device__ __forceinline__ unsigned divide(unsigned n, Divisor d) {
  return d.m ? __umulhi(n, d.m) >> d.s : n;
}

struct Params {
  const void* fin[27];  // plane k of the A buffer (storage type)
  void* fout[27];       // plane k of the B buffer
  const float* vel_in;
  float* rho_out;
  float* vel_out;
  lbm::Fields fld;
  lbm::Step s;
  int N;  // cells of the level (N + 2 Y Z < 2^31)
  Divisor byZ, byY;
  const void* fedge;   // SHARD: (27, 2, Y, Z) edge planes, storage type
  const float* vedge;  // SHARD: (3, 2, Y, Z) velocity edge planes
};

// Host side: fills p for an (X, Y, Z) level; returns false where the level
// is empty, its offsets exceed 32 bits, or an interface face has no plane.
static inline bool make_params(
    Params& p, int store_bf16, const void* f_in, const void* vel_in,
    void* f_out, void* rho_out, void* vel_out, const void* obstacle,
    const void* sponge, const void* wall, const void* const planes[6],
    int X, int Y, int Z, int lo_y, int lo_z, const int bcs[6], float u_inlet,
    int seed, double tau, double c_wale, double nu_sgs, double inlet_turb,
    int wall_model, int sponge_blend) {
  const long long n = (long long)X * Y * Z;
  // 32-bit offsets, the clamped neighbours' included
  if (n <= 0 || n + 2LL * Y * Z >= (1LL << 31)) return false;
  const size_t elem = store_bf16 ? 2 : 4;
  for (int k = 0; k < 27; ++k) {
    p.fin[k] = static_cast<const char*>(f_in) + (size_t)k * n * elem;
    p.fout[k] = static_cast<char*>(f_out) + (size_t)k * n * elem;
  }
  p.vel_in = static_cast<const float*>(vel_in);
  p.rho_out = static_cast<float*>(rho_out);
  p.vel_out = static_cast<float*>(vel_out);
  p.fld.obstacle = static_cast<const uint8_t*>(obstacle);
  p.fld.sponge = static_cast<const float*>(sponge);
  p.fld.wall = static_cast<const float*>(wall);
  p.N = (int)n;
  p.byZ = make_divisor((unsigned)Z);
  p.byY = make_divisor((unsigned)Y);
  p.fedge = nullptr;
  p.vedge = nullptr;
  return lbm::make_step(p.s, planes, bcs, X, Y, Z, lo_y, lo_z, u_inlet, seed,
                        tau, c_wale, nu_sgs, inlet_turb, wall_model,
                        sponge_blend);
}

// Host side: makes p the form for the x slab [x_off, x_off + X) of a level
// of gX planes with the given edge planes; false where they are missing or
// the slab does not lie inside the level.
static inline bool make_slab(Params& p, const void* fedge, const void* vedge,
                             int x_off, int gX) {
  if (!fedge || !vedge || x_off < 0 || x_off + p.s.X > gX) return false;
  p.fedge = fedge;
  p.vedge = static_cast<const float*>(vedge);
  p.s.x_off = x_off;
  p.s.gX = gX;
  return true;
}

__device__ __forceinline__ float ld1(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, int i) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << 16);
}

// The sub-step of cell `cell` (< p.N).  `mark(s)` ends section s of the
// update (lbm::NoMark in every normal build; K1's section probe times them).
template <typename T, bool IFACE, bool SHARD, class Mark>
__device__ __forceinline__ void update_cell(const Params& p, unsigned cell,
                                            Mark mark) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  const int Y = p.s.Y, Z = p.s.Z;
  const unsigned r = divide(cell, p.byZ);
  const int z = (int)(cell - r * (unsigned)Z);
  const int x = (int)divide(r, p.byY);
  const int y = (int)(r - (unsigned)x * (unsigned)Y);
  const int c = (int)cell;
  const int YZ = Y * Z;
  // x and y neighbour offsets clamped into the level, at [c + 1] for the
  // source x - c (lbm::neighbours)
  const int dx[3] = {x + 1 < p.s.X ? YZ : 0, 0, x > 0 ? -YZ : 0};
  const int dy[3] = {y + 1 < Y ? Z : 0, 0, y > 0 ? -Z : 0};

  // ---- 1. pull: slots g, g + 9, g + 18 of (cx, cy) = (g % 3 - 1, g / 3 - 1) ----
  float f[27];
#pragma unroll
  for (int g = 0; g < 9; ++g) {
    const int o = c + dx[g % 3] + dy[g / 3];  // the source row at z
    f[g] = ld1(static_cast<const T*>(p.fin[g]), o + 1);        // cz = -1
    f[g + 9] = ld1(static_cast<const T*>(p.fin[g + 9]), o);    // cz = 0
    f[g + 18] = ld1(static_cast<const T*>(p.fin[g + 18]), o - 1);  // cz = +1
  }
  const int yz = y * Z + z;
  if (SHARD && (x == 0 || x == p.s.X - 1)) {
    // slots pulled across the slab's ends: the neighbour slabs' edge
    // planes, side 0 (cx = +1) at x = 0, side 1 (cx = -1) at x = XL - 1
    const int zp = z + 1 < Z ? 1 : 0, zm = z > 0 ? -1 : 0;
    const T* fe = static_cast<const T*>(p.fedge);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (side == 0 ? x != 0 : x != p.s.X - 1) continue;
        const int g = 3 * b + (side == 0 ? 2 : 0);
        const T* e = fe + (2 * g + side) * YZ + yz + dy[b];
        f[g] = ld1(e, zp);
        f[g + 9] = ld1(e + 18 * YZ, 0);
        f[g + 18] = ld1(e + 36 * YZ, zm);
      }
    }
  }
  mark(0);
  lbm::apply_faces<G, IFACE, SHARD>(
      p.s, x, y, z,
      [&](int km) { return ld1(static_cast<const T*>(p.fin[km]), c); }, f);
  mark(1);

  // ---- 2. collision ----
  const bool solid = __ldg(p.fld.obstacle + c) != 0;
  const float sp = __ldg(p.fld.sponge + c);
  const float wd = p.s.wall_model ? __ldg(p.fld.wall + c) : 0.0f;
  float rho, u[3];
  lbm::collide_values<G>(
      p.s, solid, sp, wd,
      [&](float g[3][3]) {
        const int zp = z + 1 < Z ? 1 : 0, zm = z > 0 ? -1 : 0;
        // SHARD: the +-x neighbours across the slab's ends (not the
        // level's) from the velocity edge planes
        const int gx = x + p.s.x_off;
        const bool from_next = SHARD && x == p.s.X - 1 && gx != p.s.gX - 1;
        const bool from_prev = SHARD && x == 0 && gx != 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float* V = p.vel_in + (long long)d * p.N + c;
          const float vp = from_next ? __ldg(p.vedge + (2 * d + 1) * YZ + yz)
                                     : __ldg(V + dx[0]);
          const float vm = from_prev ? __ldg(p.vedge + 2 * d * YZ + yz)
                                     : __ldg(V + dx[2]);
          g[d][0] = 0.5f * (vp - vm);
          g[d][1] = 0.5f * (__ldg(V + dy[0]) - __ldg(V + dy[2]));
          g[d][2] = 0.5f * (__ldg(V + zp) - __ldg(V + zm));
        }
      },
      f, rho, u, mark);

  // ---- 3. stores ----
#pragma unroll
  for (int k = 0; k < 27; ++k) lbm::st(static_cast<T*>(p.fout[k]), c, f[k]);
  p.rho_out[c] = rho;
#pragma unroll
  for (int d = 0; d < 3; ++d) p.vel_out[(long long)d * p.N + c] = u[d];
  mark(6);
}

}  // namespace sc
