// K1: one stream-collide sub-step of one dense refinement level.
//
// Replaces the Pallas kernel make_pallas_step
// (open_ludwig_tpu/ops/pallas_step.py:247, pallas_call at :883).
//
// One thread per cell of the unpadded (X, Y, Z) box, z fastest, so a warp
// reads 32 consecutive cells of each population row.  Per cell:
//   1. pull streaming: population k comes from cell - c_k of the A buffer
//      (f_in); where that source lies outside the box the face's boundary
//      condition supplies it, in the precedence of the plain version
//      (ops/dense_step.py): x faces over y faces over z faces, i.e.
//      inlet > outlet > y-mirror > z-mirror.  Mirror faces read the
//      destination cell's own mirrored row (unshifted); interface faces
//      read the raw per-face ghost plane (27, A+2, B+2) at transverse
//      offset 1 - c_t, float32 in f-space;
//   2. collision in the per-cell factorized form of the JAX package's
//      collide_unrolled_v2 (ops/collide_math.py:404): column partial sums
//      give all ten moments, sponge blend, log-law wall-model force, WALE
//      omega from the six face-neighbour velocities (self at every patch
//      face), regularized BGK + Guo forcing as a quadratic form in c;
//   3. f, rho and vel go to the B buffer.  Concurrent CTAs run in no
//      order, so the TPU kernel's in-place f (safe there only because its
//      grid runs in order) does not carry over.
//
// Storage: T = float (f-space) or __nv_bfloat16 (g = f - w).  In g-space
// the weight shift folds into constants: rho_raw += 1, diagonal raw second
// moments += 1/3, t0 -= 1; the inlet/outlet equilibria drop their 1;
// ghost planes (f-space) subtract w; outputs round to nearest even.
//
// What bounds it on an H100: device-memory bytes.  A bf16 step moves about
// 27*2 (read f) + 27*2 (write f) + 12 (read vel) + 16 (write rho, vel)
// + 9 (statics) ~= 145 bytes per cell against ~1-2k flops, far below the
// card's flops-per-byte balance.  This first version keeps every access
// coalesced along z and reads through the read-only cache, and does nothing
// else about it: neighbour rows are re-read from L1/L2 instead of being
// staged in shared memory, and the 27 populations live in registers.
//
// No fast math: powf/logf of the wall model and the WALE square roots
// match the plain PyTorch version to 1e-5.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BC_INLET = 0;
constexpr int BC_OUTLET = 1;
constexpr int BC_MIRROR_Y = 2;
constexpr int BC_MIRROR_Z = 3;
constexpr int BC_INTERFACE = 4;

struct Params {
  const void* f_in;
  const float* vel_in;
  void* f_out;
  float* rho_out;
  float* vel_out;
  const uint8_t* obstacle;
  const float* sponge;
  const float* wall;
  const float* plane[6];
  int X, Y, Z;
  int lo_y, lo_z;
  int bc[6];
  float u_inlet;
  int seed;
  float tau, c_wale2, nu_sgs, inlet_turb, nu_visc, c17;
  int wall_model, sponge_blend;
};

// Every input of the kernel is read-only while it runs (A -> B buffers), so
// all loads go through the read-only data cache (__ldg); measured on the
// 10.8M-cell level, this took f32 from 1.30 to 1.08 ms and bf16 from 2.24 to
// 1.55 ms per call.  bf16 -> f32 is exact as a 16-bit shift.
__device__ __forceinline__ float ld(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << 16);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
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

template <typename T>
__global__ void __launch_bounds__(128)
stream_collide_kernel(const Params p) {
  constexpr bool G = sizeof(T) == 2;  // bf16 g-space storage
  const long long N = (long long)p.X * p.Y * p.Z;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= N) return;
  const int z = (int)(cell % p.Z);
  const long long r = cell / p.Z;
  const int y = (int)(r % p.Y);
  const int x = (int)(r / p.Y);
  const int X = p.X, Y = p.Y, Z = p.Z;
  const T* fin = static_cast<const T*>(p.f_in);
  const float u_in = p.u_inlet;
  const float base1 = G ? 0.0f : 1.0f;

  float inlet_fac = 0.0f;
  if (p.bc[0] == BC_INLET && x == 0) {
    float u_inst = u_in;
    if (p.inlet_turb > 0.0f) {
      const float noise = hash_noise(y + p.lo_y + 1, z + p.lo_z + 1, p.seed);
      u_inst = u_in + noise * p.inlet_turb * u_in;
    }
    inlet_fac = base1 + 3.0f * u_inst + 4.5f * u_inst * u_inst -
                1.5f * u_inst * u_inst;
  }

  // ---- 1. pull streaming with boundary conditions ----
  float f[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
    int face = -1;
    if (cx > 0 && x == 0) face = 0;
    else if (cx < 0 && x == X - 1) face = 1;
    else if (cy > 0 && y == 0) face = 2;
    else if (cy < 0 && y == Y - 1) face = 3;
    else if (cz > 0 && z == 0) face = 4;
    else if (cz < 0 && z == Z - 1) face = 5;
    float v;
    if (face < 0) {
      v = ld(fin, (long long)k * N +
                      ((long long)(x - cx) * Y + (y - cy)) * Z + (z - cz));
    } else {
      const int bc = p.bc[face];
      if (bc == BC_INLET) {
        v = weight(k) * inlet_fac;
      } else if (bc == BC_OUTLET) {
        const float cu = (float)cx * u_in;
        v = weight(k) * (base1 + 3.0f * cu + 4.5f * cu * cu - 1.5f * u_in * u_in);
      } else if (bc == BC_MIRROR_Y) {
        const int km = (cx + 1) + 3 * (1 - cy) + 9 * (cz + 1);
        v = ld(fin, (long long)km * N + cell);
      } else if (bc == BC_MIRROR_Z) {
        const int km = (cx + 1) + 3 * (cy + 1) + 9 * (1 - cz);
        v = ld(fin, (long long)km * N + cell);
      } else {  // BC_INTERFACE
        const int ax = face >> 1;
        const int a = ax == 0 ? y : x;
        const int b = ax == 2 ? y : z;
        const int ca = ax == 0 ? cy : cx;
        const int cb = ax == 2 ? cy : cz;
        const int A = ax == 0 ? Y : X;
        const int B = ax == 2 ? Y : Z;
        const long long i =
            ((long long)k * (A + 2) + (a + 1 - ca)) * (B + 2) + (b + 1 - cb);
        v = __ldg(p.plane[face] + i);
        if (G) v -= weight(k);
      }
    }
    f[k] = v;
  }

  const bool obstacle = __ldg(p.obstacle + cell) != 0;
  T* fout = static_cast<T*>(p.f_out);
  if (obstacle) {
    // full bounce-back of the raw streamed values
    // (reference: src/physics_kernels.jl:154-166)
#pragma unroll
    for (int k = 0; k < 27; ++k) st(fout, (long long)k * N + cell, f[26 - k]);
    p.rho_out[cell] = 1.0f;
    p.vel_out[cell] = 0.0f;
    p.vel_out[N + cell] = 0.0f;
    p.vel_out[2 * N + cell] = 0.0f;
    return;
  }

  // ---- 2. moments from column partial sums (x first) ----
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

  const float sp = __ldg(p.sponge + cell);
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

  // equilibrium log-law wall-stress body force
  // (reference: src/physics_kernels.jl:206-241)
  float Fx = 0.f, Fy = 0.f, Fz = 0.f;
  float ux_eq = ux, uy_eq = uy, uz_eq = uz;
  if (p.wall_model) {
    const float wd = __ldg(p.wall + cell);
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

  // WALE eddy viscosity from central differences of the previous step's
  // velocity, self-fallback at every patch face
  // (reference: src/physics_kernels.jl:251-301, physics_utils.jl:45-70)
  float omega;
  {
    const float* V = p.vel_in;
    const long long sx = (long long)Y * Z, sy = Z;
    const long long oE = x + 1 < X ? sx : 0, oW = x > 0 ? -sx : 0;
    const long long oN = y + 1 < Y ? sy : 0, oS = y > 0 ? -sy : 0;
    const long long oT = z + 1 < Z ? 1 : 0, oB = z > 0 ? -1 : 0;
    float g[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* Vc = V + c * N + cell;
      g[c][0] = 0.5f * (__ldg(Vc + oE) - __ldg(Vc + oW));
      g[c][1] = 0.5f * (__ldg(Vc + oN) - __ldg(Vc + oS));
      g[c][2] = 0.5f * (__ldg(Vc + oT) - __ldg(Vc + oB));
    }
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
    omega = 1.0f / fmaxf(p.tau + nu_eddy * 3.0f, 0.500001f);
  }
  const float one_m_om = 1.0f - omega;

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
  if (p.wall_model) {
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
    st(fout, (long long)km * N + cell, weight(km) * base);
    st(fout, (long long)(km + 1) * N + cell, weight(km + 1) * (bx + xlin));
    st(fout, (long long)(km - 1) * N + cell, weight(km - 1) * (bx - xlin));
  }
  p.rho_out[cell] = rho;
  p.vel_out[cell] = ux;
  p.vel_out[N + cell] = uy;
  p.vel_out[2 * N + cell] = uz;
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
  p.obstacle = static_cast<const uint8_t*>(obstacle);
  p.sponge = static_cast<const float*>(sponge);
  p.wall = static_cast<const float*>(wall);
  const void* planes[6] = {plane0, plane1, plane2, plane3, plane4, plane5};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  for (int i = 0; i < 6; ++i) {
    p.plane[i] = static_cast<const float*>(planes[i]);
    p.bc[i] = bcs[i];
    if (bcs[i] == BC_INTERFACE && planes[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  p.X = X;
  p.Y = Y;
  p.Z = Z;
  p.lo_y = lo_y;
  p.lo_z = lo_z;
  p.u_inlet = u_inlet;
  p.seed = seed;
  // host-side constants in double, rounded once, as the plain version's
  // Python-float constants are
  p.tau = (float)tau;
  p.c_wale2 = (float)(c_wale * c_wale);
  p.nu_sgs = (float)nu_sgs;
  p.inlet_turb = (float)inlet_turb;
  p.nu_visc = (float)((tau - 0.5) / 3.0);
  p.c17 = (float)pow(2.0 * 8.3, -1.0 / 7.0);
  p.wall_model = wall_model;
  p.sponge_blend = sponge_blend;
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
