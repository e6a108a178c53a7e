// Per-cell physics of one stream-collide sub-step, shared by K1 and K4
// (stream_collide.cu, stream_collide_flat.cu, through the cell body of
// stream_collide_body.cuh), K3 (fused_pair.cu) and K5
// (stream_collide_inplace.cu) so that all compile the same device code:
//   neighbours + apply_faces: pull streaming of the 27 populations with
//     the boundary conditions of the level's six faces (face_slots): every
//     slot is loaded from its source clamped into the level (K1 leaves z
//     unclamped: its addresses stay inside f), with no branch between the
//     loads, then the face slots are overwritten, in the precedence
//     of the plain version (ops/dense_step.py): x faces over y faces over z
//     faces, i.e. inlet > outlet > y-mirror > z-mirror.  Mirror faces read
//     the destination cell's own mirrored row (unshifted); interface faces
//     read the per-face ghost plane (27, A, B) at the destination cell's
//     own transverse position: the planes arrive pre-shifted, in the
//     storage type (ops/dense_step.py: interface_planes_pair_mm).  Where
//     the source is a cell of the level the caller's accessor supplies
//     it, so K1 reads device memory, K3's second sub-step shared memory
//     and K5 whichever holds the old value;
//   collide: the per-cell factorized form of the JAX package's
//     collide_unrolled_v2 (ops/collide_math.py:404): column partial sums
//     give all ten moments, sponge blend, log-law wall-model force, WALE
//     omega from the six face-neighbour velocities (the caller's gradient
//     accessor, self at every patch face), regularized BGK + Guo forcing as
//     a quadratic form in c, the wall model only where the wall distance
//     is in (0, 10).  Obstacle cells bounce back.
//
// Storage: T = float (f-space) or __nv_bfloat16 (g = f - w).  In g-space
// the weight shift folds into constants: rho_raw += 1, diagonal raw second
// moments += 1/3, t0 -= 1; the inlet/outlet equilibria drop their 1;
// ghost planes arrive in g already (bf16); outputs round to nearest even.
//
// No fast math: powf/logf of the wall model and the WALE square roots
// match the plain PyTorch version to 1e-5.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace lbm {

constexpr int BC_INLET = 0;
constexpr int BC_OUTLET = 1;
constexpr int BC_MIRROR_Y = 2;
constexpr int BC_MIRROR_Z = 3;
constexpr int BC_INTERFACE = 4;

// The constants of one sub-step of one level.
struct Step {
  // interface ghost planes (27, A, B), pre-shifted, in the storage type T:
  // float f-space, or __nv_bfloat16 g = f - w (read as T by face_slots<..., G, ...>)
  const void* plane[6];
  int bc[6];
  int X, Y, Z;
  // the level's global x extent and this array's first global plane: an
  // x slab of a sharded level (x_off > 0 or X < gX) takes its x faces at
  // global x = 0 and gX - 1 only; one device has x_off = 0, gX = X
  int x_off, gX;
  int lo_y, lo_z;
  float u_inlet;
  int seed;
  // The step record (solver.StepRecord): where rec_t is set, the inlet
  // speed and the noise seed are read on the device in place of u_inlet
  // and seed, from the coarse-step counter *rec_t and the speed table
  // rec_u: with tc = *rec_t + rec_dt, u = rec_u[min(tc, rec_last)] and
  // seed = ((tc << rec_shift) + rec_k) % 1000000, rec_shift the level's
  // depth and rec_k the sub-step within the coarse step.  A CUDA graph
  // then replays one captured launch at every step.
  const int* rec_t;
  const float* rec_u;
  int rec_last, rec_dt, rec_shift, rec_k;
  float tau, c_wale2, nu_sgs, inlet_turb, nu_visc, c17;
  int wall_model, sponge_blend;
};

// The level's static fields, (X, Y, Z) each.
struct Fields {
  const uint8_t* obstacle;
  const float* sponge;
  const float* wall;
};

// Host side: fills a Step; returns false if an interface face has no plane.
// Constants are taken in double and rounded once, as the plain version's
// Python-float constants are.
static inline bool make_step(Step& s, const void* const planes[6],
                             const int bcs[6], int X, int Y, int Z, int lo_y,
                             int lo_z, float u_inlet, int seed, double tau,
                             double c_wale, double nu_sgs, double inlet_turb,
                             int wall_model, int sponge_blend) {
  for (int i = 0; i < 6; ++i) {
    s.plane[i] = planes[i];
    s.bc[i] = bcs[i];
    if (bcs[i] == BC_INTERFACE && planes[i] == nullptr) return false;
  }
  s.X = X;
  s.Y = Y;
  s.Z = Z;
  s.x_off = 0;
  s.gX = X;
  s.lo_y = lo_y;
  s.lo_z = lo_z;
  s.u_inlet = u_inlet;
  s.seed = seed;
  s.rec_t = nullptr;
  s.rec_u = nullptr;
  s.rec_last = s.rec_dt = s.rec_shift = s.rec_k = 0;
  s.tau = (float)tau;
  s.c_wale2 = (float)(c_wale * c_wale);
  s.nu_sgs = (float)nu_sgs;
  s.inlet_turb = (float)inlet_turb;
  s.nu_visc = (float)((tau - 0.5) / 3.0);
  s.c17 = (float)pow(2.0 * 8.3, -1.0 / 7.0);
  s.wall_model = wall_model;
  s.sponge_blend = sponge_blend;
  return true;
}

// Host side: the Step reads its inlet speed and seed from the step record
// (rec_t null: the by-value u_inlet and seed stay); false for a table
// without entries.
static inline bool set_record(Step& s, const void* rec_t, const void* rec_u,
                              int last, int dt, int shift, int k) {
  if (!rec_t) return true;
  if (!rec_u || last < 0 || dt < 0 || shift < 0 || shift > 16 || k < 0)
    return false;
  s.rec_t = static_cast<const int*>(rec_t);
  s.rec_u = static_cast<const float*>(rec_u);
  s.rec_last = last;
  s.rec_dt = dt;
  s.rec_shift = shift;
  s.rec_k = k;
  return true;
}

// The sub-step's inlet speed and noise seed: the Step's own, or read from
// the step record (uniform branch; two cached loads).
__device__ __forceinline__ float inlet_u(const Step& p) {
  if (!p.rec_t) return p.u_inlet;
  return __ldg(p.rec_u + min(__ldg(p.rec_t) + p.rec_dt, p.rec_last));
}
__device__ __forceinline__ int noise_seed(const Step& p) {
  if (!p.rec_t) return p.seed;
  return (((__ldg(p.rec_t) + p.rec_dt) << p.rec_shift) + p.rec_k) % 1000000;
}

// Every input of K1-K4 is read-only while it runs (A -> B buffers), so
// device-memory loads go through the read-only data cache (__ldg); K5
// reads its f, which it writes in place, with plain loads instead
// (ld_plain).  Measured on the 10.8M-cell level, __ldg took K1 f32 from 1.30
// to 1.08 ms and bf16 from 2.24 to 1.55 ms per call.  bf16 -> f32 is exact
// as a 16-bit shift.
__device__ __forceinline__ float ld(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << 16);
}
// Loads of an array that the running kernel also writes (K5's f): plain
// loads, cached in L1 and L2, never the read-only path (see K5's note).
__device__ __forceinline__ float ld_plain(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld_plain(const __nv_bfloat16* p, long long i) {
  return __uint_as_float(
      (unsigned)reinterpret_cast<const unsigned short*>(p)[i] << 16);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// v as the storage type T holds it (bf16: rounded to nearest even)
template <typename T>
__device__ __forceinline__ float to_storage(float v) {
  if (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// lattice weight by |c|^2 (float32-rounded double constants, as numpy's W)
__host__ __device__ constexpr int csq(int k) {
  return (k % 3 - 1) * (k % 3 - 1) + ((k / 3) % 3 - 1) * ((k / 3) % 3 - 1) +
         (k / 9 - 1) * (k / 9 - 1);
}
__host__ __device__ constexpr float weight(int k) {
  return csq(k) == 0   ? (float)(8.0 / 27.0)
         : csq(k) == 1 ? (float)(2.0 / 27.0)
         : csq(k) == 2 ? (float)(1.0 / 54.0)
                       : (float)(1.0 / 216.0);
}

// integer-hash inlet noise in [-1, 1), bit-exact with hash_noise
// (reference: src/physics_utils.jl:17-28)
__device__ __forceinline__ float hash_noise(int gy, int gz, int seed) {
  uint32_t h = (uint32_t)gy * 374761393u + (uint32_t)gz * 668265263u +
               (uint32_t)seed * 1274126177u + 1234u;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  h = h ^ (h >> 16);
  return (float)(int)(h & 0xFFFFu) / 32768.0f - 1.0f;
}

// The inlet factor of cell (gx, y, z), gx its global x: 1 (f) or 0 (g) + the inlet
// equilibrium's velocity terms on the cells of an inlet x-min face, with
// the hash noise of the cell's global (y, z); 0 elsewhere.
template <bool G>
__device__ __forceinline__ float inlet_factor(const Step& p, int gx, int y,
                                              int z) {
  if (p.bc[0] != BC_INLET || gx != 0) return 0.0f;
  const float u_in = inlet_u(p);
  float u_inst = u_in;
  if (p.inlet_turb > 0.0f) {
    const float noise = hash_noise(y + p.lo_y + 1, z + p.lo_z + 1, noise_seed(p));
    u_inst = u_in + noise * p.inlet_turb * u_in;
  }
  return (G ? 0.0f : 1.0f) + 3.0f * u_inst + 4.5f * u_inst * u_inst -
         1.5f * u_inst * u_inst;
}


// Pull streaming into f[27] for cell (x, y, z), in two phases, so that the
// 27 loads go out back to back with no branch between them:
//   phase 1: slot k is loaded from its source (x - cx, y - cy, z - cz)
//     clamped into the level: always a cell of the level, the true source
//     wherever that lies inside.  `neighbours` gives the clamped sources
//     as element offsets from the cell itself, three ints per axis, so a
//     slot's address is one running pointer plus a sum of three ints: the
//     kernels are bound by instruction throughput before they are bound by
//     bytes, and 64-bit index arithmetic per slot was most of it;
//   phase 2 (apply_faces): the slots whose source lay beyond a face are
//     overwritten with the face's condition, x faces over y faces over z
//     faces: like the plain version, which applies its masks z -> y -> x,
//     later ones winning, the faces the cell lies on are applied in that
//     order, each a constant (`face_slots`: the 9 slots that cross it,
//     one branch on the face's condition), so a face lane's path, which
//     its whole warp waits for, holds no per-slot face test or switch.  `mirror(km)` returns
//     population km of the cell itself (a read without side effects: an
//     edge cell may read a slot that a higher face then overwrites).
//     Cells off every face, nearly all, skip the phase.
//     With SHARD (an x slab of a sharded level, Step::x_off and gX) the x
//     faces are tested at the cell's global x: a slab's inner x ends are
//     no face, their slots come from the neighbour slabs' edge planes,
//     which the caller puts in before this phase (the y and z faces then
//     win over them, as over any pulled value).
struct Nbr {
  int dx[3], dy[3], dz[3];  // offset of the cell - c, clamped, at [c + 1]
};
__device__ __forceinline__ Nbr neighbours(const Step& p, int x, int y, int z) {
  const int YZ = p.Y * p.Z;
  Nbr n;
  n.dx[0] = x + 1 < p.X ? YZ : 0;
  n.dx[1] = 0;
  n.dx[2] = x > 0 ? -YZ : 0;
  n.dy[0] = y + 1 < p.Y ? p.Z : 0;
  n.dy[1] = 0;
  n.dy[2] = y > 0 ? -p.Z : 0;
  n.dz[0] = z + 1 < p.Z ? 1 : 0;
  n.dz[1] = 0;
  n.dz[2] = z > 0 ? -1 : 0;
  return n;
}

// The slots of cell (x, y, z) whose source lies beyond face FACE (a
// constant), each set to the face's boundary condition, in the storage
// type's space: the inlet's or the outlet's equilibrium, the cell's own
// mirrored slot (`mirror(km)`, population km of the cell itself) or the
// interface face's ghost plane (27, A, B) at the cell's transverse
// position (pre-shifted).  The condition is branched on once for the
// face's nine slots, whose loop holds no test; with IFACE false (K4: a
// level without interface faces) the plane's case is compiled out and a
// z mirror is the last one.
template <int FACE, bool G, bool IFACE, class Mirror>
__device__ __forceinline__ void face_slots(const Step& p, int x, int y, int z,
                                           float inlet_fac, Mirror mirror,
                                           float f[27]) {
  constexpr int ax = FACE >> 1;
  auto each = [&](auto value) {
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      const int c = ax == 0 ? k % 3 - 1 : ax == 1 ? (k / 3) % 3 - 1 : k / 9 - 1;
      if (FACE & 1 ? c < 0 : c > 0) f[k] = value(k);
    }
  };
  const int bc = p.bc[FACE];
  if (bc == BC_INLET) {
    each([&](int k) { return weight(k) * inlet_fac; });
  } else if (bc == BC_OUTLET) {
    const float u_in = inlet_u(p);
    each([&](int k) {
      const float cu = (float)(k % 3 - 1) * u_in;
      return weight(k) *
             ((G ? 0.0f : 1.0f) + 3.0f * cu + 4.5f * cu * cu - 1.5f * u_in * u_in);
    });
  } else if (bc == BC_MIRROR_Y) {
    each([&](int k) {
      return mirror((k % 3) + 3 * (2 - (k / 3) % 3) + 9 * (k / 9));
    });
  } else if (!IFACE || bc == BC_MIRROR_Z) {
    each([&](int k) {
      return mirror((k % 3) + 3 * ((k / 3) % 3) + 9 * (2 - k / 9));
    });
  } else {
    // BC_INTERFACE: plane index (k A + a) B + b, below 2^31 (27 A B)
    const int a = ax == 0 ? y : x;
    const int b = ax == 2 ? y : z;
    const int A = ax == 0 ? p.Y : p.X;
    const int B = ax == 2 ? p.Y : p.Z;
    const int AB = A * B;
    if (G) {
      const __nv_bfloat16* at = static_cast<const __nv_bfloat16*>(p.plane[FACE]) + a * B + b;
      each([&](int k) { return ld(at, k * AB); });
    } else {
      const float* at = static_cast<const float*>(p.plane[FACE]) + a * B + b;
      each([&](int k) { return ld(at, k * AB); });
    }
  }
}

template <bool G, bool IFACE = true, bool SHARD = false, class Mirror>
__device__ __forceinline__ void apply_faces(const Step& p, int x, int y, int z,
                                            Mirror mirror, float f[27]) {
  const int Y = p.Y, Z = p.Z;
  const int gx = SHARD ? x + p.x_off : x;
  const int last = SHARD ? p.gX - 1 : p.X - 1;
  if (gx != 0 && gx != last && y != 0 && y != Y - 1 && z != 0 && z != Z - 1)
    return;
  const float inlet_fac = inlet_factor<G>(p, gx, y, z);
  // face by face from the lowest precedence up, each overwriting the slots
  // that cross it, so a slot ends with its highest face's value
  if (z == Z - 1) face_slots<5, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
  if (z == 0) face_slots<4, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
  if (y == Y - 1) face_slots<3, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
  if (y == 0) face_slots<2, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
  if (gx == last) face_slots<1, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
  if (gx == 0) face_slots<0, G, IFACE>(p, x, y, z, inlet_fac, mirror, f);
}

// Section marks of the cell update, for tools/probe_k1_sections.py: `mark(s)`
// is called where section s of the update ends (2 moments and sponge, 3 wall
// model, 4 velocity gradient and WALE, 5 BGK and reconstruction; the kernel
// marks 0 index and pull, 1 faces, 6 store).  NoMark, which every normal
// build passes, does nothing and compiles to nothing.
struct NoMark {
  __device__ __forceinline__ void operator()(int) const {}
};

// WALE omega from the velocity gradient g[c][d] = d u_c / d x_d
// (reference: src/physics_kernels.jl:251-301, physics_utils.jl:45-70)
__device__ __forceinline__ float wale_omega(const Step& p, const float g[3][3]) {
  const float g11 = g[0][0], g12 = g[0][1], g13 = g[0][2];
  const float g21 = g[1][0], g22 = g[1][1], g23 = g[1][2];
  const float g31 = g[2][0], g32 = g[2][1], g33 = g[2][2];
  const float gsq11 = g11 * g11 + g12 * g21 + g13 * g31;
  const float gsq12 = g11 * g12 + g12 * g22 + g13 * g32;
  const float gsq13 = g11 * g13 + g12 * g23 + g13 * g33;
  const float gsq21 = g21 * g11 + g22 * g21 + g23 * g31;
  const float gsq22 = g21 * g12 + g22 * g22 + g23 * g32;
  const float gsq23 = g21 * g13 + g22 * g23 + g23 * g33;
  const float gsq31 = g31 * g11 + g32 * g21 + g33 * g31;
  const float gsq32 = g31 * g12 + g32 * g22 + g33 * g32;
  const float gsq33 = g31 * g13 + g32 * g23 + g33 * g33;
  const float tr = (gsq11 + gsq22 + gsq33) / 3.0f;
  const float Sd11 = gsq11 - tr, Sd22 = gsq22 - tr, Sd33 = gsq33 - tr;
  const float Sd12 = 0.5f * (gsq12 + gsq21);
  const float Sd13 = 0.5f * (gsq13 + gsq31);
  const float Sd23 = 0.5f * (gsq23 + gsq32);
  const float S12 = 0.5f * (g12 + g21);
  const float S13 = 0.5f * (g13 + g31);
  const float S23 = 0.5f * (g23 + g32);
  const float OP1 = Sd11 * Sd11 + Sd22 * Sd22 + Sd33 * Sd33 +
                    2.0f * (Sd12 * Sd12 + Sd13 * Sd13 + Sd23 * Sd23);
  const float OP2 = g11 * g11 + g22 * g22 + g33 * g33 +
                    2.0f * (S12 * S12 + S13 * S13 + S23 * S23);
  const float OP1_32 = OP1 * sqrtf(OP1);
  const float OP2_52 = OP2 * OP2 * sqrtf(fmaxf(OP2, 1e-12f));
  const float denom = OP2_52 + OP1 * sqrtf(sqrtf(fmaxf(OP1, 1e-12f)));
  float nu_eddy = (OP1 > 1e-12f && denom > 1e-12f)
                      ? p.c_wale2 * OP1_32 / fmaxf(denom, 1e-12f)
                      : 0.0f;
  nu_eddy = fmaxf(nu_eddy, p.nu_sgs);
  return 1.0f / fmaxf(p.tau + nu_eddy * 3.0f, 0.500001f);
}

// Collision of the streamed f[27] of one cell, in place: f becomes the
// post-collision populations; rho and u[3] the cell's moments.  The cell's
// static fields come as values: `solid` (obstacle), its sponge weight `sp`
// and its wall distance `wd` (read only with the wall model).
// `vel_grad(g)` fills g[c][d] with the central differences of the previous
// sub-step's velocity (self-fallback at every patch face).
//
// The wall model acts only where 0 < wd < 10 (its `active` test): the wall
// distance field holds the 100.0 sentinel everywhere but the fluid shell
// next to the body (domain/fields.py), and elsewhere its force is exactly
// +-0, which leaves u_eq = u and every Guo term as it was (x + (+-0) = x).
// So the sqrt / pow / log / division chain and the Guo terms run only on
// the cells inside that range (`near_wall`): the stored f is unchanged,
// the sign of a zero aside.
template <bool G, class VelGrad, class Mark = NoMark>
__device__ __forceinline__ void collide_values(const Step& p, bool solid, float sp,
                                               float wd, VelGrad vel_grad,
                                               float f[27], float& rho_out,
                                               float u_out[3], Mark mark = Mark()) {
  const float u_in = inlet_u(p);
  if (solid) {
    // full bounce-back of the raw streamed values
    // (reference: src/physics_kernels.jl:154-166)
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      const float t = f[k];
      f[k] = f[26 - k];
      f[26 - k] = t;
    }
    rho_out = 1.0f;
    u_out[0] = u_out[1] = u_out[2] = 0.0f;
    return;
  }

  // ---- moments from column partial sums (x first) ----
  float rho_raw = 0.f, jx = 0.f, jy = 0.f, jz = 0.f;
  float Sxx = 0.f, Syy = 0.f, Szz = 0.f, Sxy = 0.f, Szx = 0.f, Syz = 0.f;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int cy = c % 3 - 1, cz = c / 3 - 1;
    const int km = 1 + 3 * c;
    const float fm = f[km - 1], f0 = f[km], fp = f[km + 1];
    const float s0 = fm + f0 + fp;
    const float s1 = fp - fm;
    const float s2 = fp + fm;
    rho_raw += s0;
    jx += s1;
    Sxx += s2;
    if (cy) { jy += cy * s0; Syy += s0; Sxy += cy * s1; }
    if (cz) { jz += cz * s0; Szz += s0; Szx += cz * s1; }
    if (cy && cz) Syz += (cy * cz) * s0;
  }
  if (G) {
    // moments of the weight shift: sum w = 1, sum c c^T w = cs^2 I
    rho_raw += 1.0f;
    Sxx += 1.0f / 3.0f;
    Syy += 1.0f / 3.0f;
    Szz += 1.0f / 3.0f;
  }
  rho_raw = fmaxf(rho_raw, 0.01f);
  const float inv_rho_raw = 1.0f / rho_raw;
  float ux = jx * inv_rho_raw, uy = jy * inv_rho_raw, uz = jz * inv_rho_raw;

  const float one_m = 1.0f - sp;
  const float rho = rho_raw * one_m + sp;
  ux = ux * one_m + u_in * sp;
  uy = uy * one_m;
  uz = uz * one_m;
  if (p.sponge_blend) {
    // Pi(feq at rho=1, u=(u_in,0,0)) = u u^T + cs^2 I (exact identity)
    Sxx = Sxx * one_m + (u_in * u_in + 1.0f / 3.0f) * sp;
    Syy = Syy * one_m + (1.0f / 3.0f) * sp;
    Szz = Szz * one_m + (1.0f / 3.0f) * sp;
    Sxy = Sxy * one_m;
    Syz = Syz * one_m;
    Szx = Szx * one_m;
  }
  mark(2);

  // equilibrium log-law wall-stress body force
  // (reference: src/physics_kernels.jl:206-241)
  float Fx = 0.f, Fy = 0.f, Fz = 0.f;
  float ux_eq = ux, uy_eq = uy, uz_eq = uz;
  const bool near_wall = p.wall_model && wd > 0.0f && wd < 10.0f;
  if (near_wall) {
    const float nu_visc = p.nu_visc;
    const float u_mag = sqrtf(ux * ux + uy * uy + uz * uz);
    float u_tau = u_mag * powf(nu_visc / (wd * u_mag + 1e-10f), (float)(1.0 / 7.0)) *
                  p.c17;
    u_tau = fmaxf(u_tau, 1e-6f);
    const float y_p = u_tau * wd / nu_visc;
    const float u_plus = (float)(1.0 / 0.41) * logf(fmaxf(y_p, 1e-10f)) + 5.2f;
    const float corr = (y_p > 11.81f && u_plus > 0.1f)
                           ? (u_mag / u_tau) / fmaxf(u_plus, 0.1f)
                           : 1.0f;
    u_tau = fmaxf(u_tau * corr, 1e-6f);
    const float tau_wall = rho * u_tau * u_tau;
    const float tau_res = rho * nu_visc * u_mag / fmaxf(wd, 1e-10f);
    const bool active = wd > 0.0f && wd < 10.0f && u_mag > 1e-6f &&
                        tau_wall > tau_res && nu_visc > 1e-10f;
    const float fm = active ? (tau_wall - tau_res) / fmaxf(wd, 1e-10f) : 0.0f;
    const float inv_umag = 1.0f / fmaxf(u_mag, 1e-20f);
    Fx = -fm * ux * inv_umag;
    Fy = -fm * uy * inv_umag;
    Fz = -fm * uz * inv_umag;
    ux_eq = ux + 0.5f * Fx * inv_rho_raw;
    uy_eq = uy + 0.5f * Fy * inv_rho_raw;
    uz_eq = uz + 0.5f * Fz * inv_rho_raw;
  }
  const float usq_eq = ux_eq * ux_eq + uy_eq * uy_eq + uz_eq * uz_eq;
  mark(3);

  float g[3][3];
  vel_grad(g);
  const float omega = wale_omega(p, g);
  const float one_m_om = 1.0f - omega;
  mark(4);

  // ---- regularized BGK + Guo forcing as f_k / w_k = t0 + c.t + c^T T2 c ----
  const float rux = rho * ux_eq, ruy = rho * uy_eq, ruz = rho * uz_eq;
  const float ruxx = rux * ux_eq, ruyy = ruy * uy_eq, ruzz = ruz * uz_eq;
  const float ruxy = rux * uy_eq, ruyz = ruy * uz_eq, ruzx = ruz * ux_eq;
  const float rho_cs2 = rho * (1.0f / 3.0f);
  const float P1 = one_m_om * (Sxx - ruxx - rho_cs2);
  const float P2 = one_m_om * (Syy - ruyy - rho_cs2);
  const float P3 = one_m_om * (Szz - ruzz - rho_cs2);
  const float P4 = one_m_om * (Sxy - ruxy);
  const float P5 = one_m_om * (Syz - ruyz);
  const float P6 = one_m_om * (Szx - ruzx);

  float t0 = rho - 1.5f * rho * usq_eq - 1.5f * (P1 + P2 + P3);
  if (G) t0 -= 1.0f;
  float tx = 3.0f * rux, ty = 3.0f * ruy, tz = 3.0f * ruz;
  float txx = 4.5f * (ruxx + P1), tyy = 4.5f * (ruyy + P2), tzz = 4.5f * (ruzz + P3);
  float txy = 9.0f * (ruxy + P4), tyz = 9.0f * (ruyz + P5), tzx = 9.0f * (ruzx + P6);
  if (near_wall) {
    const float guo = 1.0f - 0.5f * omega;
    const float Gx = guo * Fx, Gy = guo * Fy, Gz = guo * Fz;
    // uF uses the post-sponge u, like the reference (physics_kernels.jl:348)
    t0 = t0 - 3.0f * guo * (ux * Fx + uy * Fy + uz * Fz);
    tx = tx + 3.0f * Gx;
    ty = ty + 3.0f * Gy;
    tz = tz + 3.0f * Gz;
    txx = txx + 9.0f * Gx * ux_eq;
    tyy = tyy + 9.0f * Gy * uy_eq;
    tzz = tzz + 9.0f * Gz * uz_eq;
    txy = txy + 9.0f * (Gx * uy_eq + Gy * ux_eq);
    tyz = tyz + 9.0f * (Gy * uz_eq + Gz * uy_eq);
    tzx = tzx + 9.0f * (Gz * ux_eq + Gx * uz_eq);
  }

#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const int cy = c % 3 - 1, cz = c / 3 - 1;
    const int km = 1 + 3 * c;
    float base = t0;
    if (cy) base = base + (cy == 1 ? ty : -ty) + tyy;
    if (cz) base = base + (cz == 1 ? tz : -tz) + tzz;
    if (cy && cz) base = base + (cy * cz == 1 ? tyz : -tyz);
    float xlin = tx;
    if (cy) xlin = xlin + (cy == 1 ? txy : -txy);
    if (cz) xlin = xlin + (cz == 1 ? tzx : -tzx);
    const float bx = base + txx;
    f[km] = weight(km) * base;
    f[km + 1] = weight(km + 1) * (bx + xlin);
    f[km - 1] = weight(km - 1) * (bx - xlin);
  }
  mark(5);
  rho_out = rho;
  u_out[0] = ux;
  u_out[1] = uy;
  u_out[2] = uz;
}

// collide_values with the cell's static fields read from device memory.
template <bool G, class VelGrad>
__device__ __forceinline__ void collide(const Step& p, const Fields& fld,
                                        long long cell, VelGrad vel_grad,
                                        float f[27], float& rho_out,
                                        float u_out[3]) {
  const bool solid = __ldg(fld.obstacle + cell) != 0;
  const float sp = __ldg(fld.sponge + cell);
  const float wd = p.wall_model ? __ldg(fld.wall + cell) : 0.0f;
  collide_values<G>(p, solid, sp, wd, vel_grad, f, rho_out, u_out);
}

// Central differences of the previous sub-step's velocity at a cell of a
// (3, X, Y, Z) device array, `V` pointing at the cell's first component;
// the cell itself stands in for a neighbour beyond any face of the level
// (the clamped offsets of `neighbours`).
__device__ __forceinline__ void vel_grad_global(const float* V, long long N,
                                                const Nbr& nb, float g[3][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g[c][0] = 0.5f * (__ldg(V + nb.dx[0]) - __ldg(V + nb.dx[2]));
    g[c][1] = 0.5f * (__ldg(V + nb.dy[0]) - __ldg(V + nb.dy[2]));
    g[c][2] = 0.5f * (__ldg(V + nb.dz[0]) - __ldg(V + nb.dz[2]));
    V += N;
  }
}

// vel_grad_global for a cell of an x slab (SHARD): where the +x or -x
// neighbour lies in the next or previous slab it comes from the slab's
// velocity edge planes `VE` (3, 2, Y, Z) at the cell's (y, z) offset `yz`
// ([:, 0] the previous slab's last plane, [:, 1] the next one's first); at
// the level's global x ends the cell itself stands in, as on one device.
__device__ __forceinline__ void vel_grad_slab(const Step& p, const float* V,
                                              long long N, const Nbr& nb,
                                              int x, const float* VE, int yz,
                                              float g[3][3]) {
  const int YZ = p.Y * p.Z;
  const int gx = x + p.x_off;
  const bool from_next = x == p.X - 1 && gx != p.gX - 1;
  const bool from_prev = x == 0 && gx != 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float vp = from_next ? __ldg(VE + (2 * c + 1) * YZ + yz) : __ldg(V + nb.dx[0]);
    const float vm = from_prev ? __ldg(VE + (2 * c) * YZ + yz) : __ldg(V + nb.dx[2]);
    g[c][0] = 0.5f * (vp - vm);
    g[c][1] = 0.5f * (__ldg(V + nb.dy[0]) - __ldg(V + nb.dy[2]));
    g[c][2] = 0.5f * (__ldg(V + nb.dz[0]) - __ldg(V + nb.dz[2]));
    V += N;
  }
}

// One whole sub-step of cell (x, y, z) whose inputs, f (storage type T) and
// vel (f32), are (27|3, X, Y, Z) arrays in device memory: K1's cell, and
// K3's first sub-step.
template <typename T>
__device__ __forceinline__ void update_from_global(
    const Step& p, const Fields& fld, const T* fin, const float* vel_in, int x,
    int y, int z, float f[27], float& rho, float u[3]) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  const long long N = (long long)p.X * p.Y * p.Z;
  const long long cell = ((long long)x * p.Y + y) * p.Z + z;
  const Nbr nb = neighbours(p, x, y, z);
  const T* pk = fin + cell;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
    f[k] = ld(pk, nb.dx[cx + 1] + nb.dy[cy + 1] + nb.dz[cz + 1]);
    pk += N;
  }
  apply_faces<G>(
      p, x, y, z, [&](int km) { return ld(fin, (long long)km * N + cell); }, f);
  collide<G>(
      p, fld, cell,
      [&](float g[3][3]) { vel_grad_global(vel_in + cell, N, nb, g); }, f, rho,
      u);
}

// f[27], rho and u of a cell to (27|1|3, X, Y, Z) device arrays.
template <typename T>
__device__ __forceinline__ void store_cell(T* fout, float* rho_out,
                                           float* vel_out, long long N,
                                           long long cell, const float f[27],
                                           float rho, const float u[3]) {
  T* qk = fout + cell;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    st(qk, 0, f[k]);
    qk += N;
  }
  rho_out[cell] = rho;
  float* v = vel_out + cell;
  v[0] = u[0];
  v[N] = u[1];
  v[2 * N] = u[2];
}

}  // namespace lbm
