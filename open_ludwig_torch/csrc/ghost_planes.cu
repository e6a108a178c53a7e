// The ghost planes of a child level: the parent's endpoint slabs and the
// child's pre-shifted interface planes, one launch each.
//
// Replaces no Pallas kernel.  The reference builds these planes as XLA
// glue (open_ludwig_tpu/ops/dense_step.py:577-858: extract_endpoint_slabs
// and the einsum chain of interface_planes_pair_mm), which the port ran as
// ~170 small PyTorch launches a child build (dense_step.py's plain
// versions, which the tests hold these kernels to).
//
// ghost_extract_kernel: one thread per value of the endpoint slabs of every
// interface-face group of the child, (nf, 31, wa, wb) per group (27 f, rho,
// 3 vel): the two parent planes along the face's normal at the window's
// (a, b), lerped with the face's weights, written float32 into one buffer
// in the layout extract_endpoint_slabs returns (f (nf, 27, wa, wb), then
// rho (nf, wa, wb), then vel (nf, 3, wa, wb) per group).  A bf16 parent's
// slabs hold g = f - w, as the plain version's do.
//
// ghost_planes_kernel: one thread per plane cell (a, b) of a face and class
// pair (c_a, c_b) of the directions' transverse components, over every
// group: rho and u interpolated from the slabs at the 2 x 2 stencil of its
// tap tables (the 2x upsample, the edge clamp and the (1 - c) window shift
// of build_iface_mm_plan's UA3 / UB3 rows), then for the three directions
// of the pair the f slot at the same stencil, the equilibrium split and the
// f_neq rescale, stored in the child's storage type at both temporal
// weights.  The order of the arithmetic is the plain version's: the
// temporal blend (o + n) * 0.5 first, then the contraction along B, then
// along A (each a product and a fused add in ascending slab column, as a
// float32 GEMM over a row of two nonzero weights accumulates it), then the
// elementwise tail op by op, each rounded (no contraction into fused
// multiply-adds).  On the H100 the planes equal interface_planes_pair_mm's
// bit for bit (chip_smoke.py phase 15).
//
// What bounds them on an H100: bytes.  A child build of the Re10M sphere's
// finest level writes 13.6 MB of planes and 4.4 MB of slabs and reads the
// slabs twice, ~9 us at 3.35 TB/s with the parent's window and the carry.
// Measured (PERF.md): the planes kernel at ~3x its bytes, 56 loads of
// slab values (L1 / L2 hits) against 6 stores a thread, and the
// extraction's z-face group reading one 32-byte sector per two values
// (the window's columns lie a row of z apart).  Tried and dropped: a
// block per 8 x 32 tile with rho and u staged in shared memory for all
// nine class pairs (fewer threads; slower on the smaller children), the
// nine class pairs of a row in one block, and other block sizes and
// launch bounds (no gain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_GROUPS = 3;  // one per axis that has an interface face
constexpr int THREADS = 256;

template <typename I>
__device__ __forceinline__ float ld(const float* p, I i) { return __ldg(p + i); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// ---- extraction ----

struct ExtractGroup {
  long long begin;  // the group's first value in the launch's index space
  float* out;       // the group's slabs: f, rho, vel (file comment)
  int axis, nf, wa, wb, sa, sb;
  int idx[4];       // per face, the two parent planes along the normal
  float w_lo[2], w_hi[2];
};

struct ExtractArgs {
  ExtractGroup g[MAX_GROUPS];
  int ng;
  long long n;  // values of every group
  int X, Y, Z;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ghost_extract_kernel(const T* __restrict__ f, const float* __restrict__ rho,
                     const float* __restrict__ vel, const ExtractArgs a) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= a.n) return;
  int gi = 0;
  while (gi + 1 < a.ng && i >= a.g[gi + 1].begin) ++gi;
  const ExtractGroup& g = a.g[gi];
  const int r = (int)(i - g.begin);  // a group's values fit 32 bits
  const int plane = g.wa * g.wb;
  const int ch = r / plane;
  const int ab = r - ch * plane;
  const int ia = ab / g.wb, jb = ab - ia * g.wb;
  const long long N = (long long)a.X * a.Y * a.Z;
  // channel ch: f slot k of face fi, then rho of face fi, then vel c of fi
  int fi;
  long long base;
  float v0, v1;
  const int nf27 = 27 * g.nf;
  if (ch < nf27) {
    fi = ch / 27;
    base = (long long)(ch - 27 * fi) * N;
  } else if (ch < nf27 + g.nf) {
    fi = ch - nf27;
    base = 0;
  } else {
    const int c = ch - nf27 - g.nf;
    fi = c / 3;
    base = (long long)(c - 3 * fi) * N;
  }
  int pos[3];
  const int t0 = g.axis == 0 ? 1 : 0, t1 = g.axis == 2 ? 1 : 2;
  pos[t0] = g.sa + ia;
  pos[t1] = g.sb + jb;
  pos[g.axis] = g.idx[2 * fi];
  const long long c0 = ((long long)pos[0] * a.Y + pos[1]) * a.Z + pos[2];
  pos[g.axis] = g.idx[2 * fi + 1];
  const long long c1 = ((long long)pos[0] * a.Y + pos[1]) * a.Z + pos[2];
  if (ch < nf27) {
    v0 = ld(f, base + c0);
    v1 = ld(f, base + c1);
  } else if (ch < nf27 + g.nf) {
    v0 = ld(rho, c0);
    v1 = ld(rho, c1);
  } else {
    v0 = ld(vel, base + c0);
    v1 = ld(vel, base + c1);
  }
  g.out[r] = __fadd_rn(__fmul_rn(v0, g.w_lo[fi]), __fmul_rn(v1, g.w_hi[fi]));
}

// ---- planes ----

struct PlaneGroup {
  long long begin;       // the group's first thread in the launch's index space
  const float* f[2];     // [0] the old slabs (unread without the blend), [1] the new
  const float* rho[2];
  const float* vel[2];
  void* out;             // (nf, nw, 27, A, B) in the output type
  const int* col_a;      // (3, A, 2): per class c + 1 and fine row, two slab columns
  const float* w_a;      // and their weights
  const int* col_b;      // (3, B, 2)
  const float* w_b;
  int axis, nf, A, B, wa, wb;
};

struct PlaneArgs {
  PlaneGroup g[MAX_GROUPS];
  int ng, g_store, g_shifted;
  float scale;
  long long n;  // threads: plane cells of every group and face, times 9 class pairs
};

struct Stencil {
  int a0, a1, b0, b1;
  float wa0, wa1, wb0, wb1;
};

// The stencil's four slab values (rows a0, a1 by columns b0, b1) along B,
// then along A.
__device__ __forceinline__ float contract(const float v[4], const Stencil& s) {
  const float t0 = __fmaf_rn(v[1], s.wb1, __fmul_rn(v[0], s.wb0));
  const float t1 = __fmaf_rn(v[3], s.wb1, __fmul_rn(v[2], s.wb0));
  return __fmaf_rn(t1, s.wa1, __fmul_rn(t0, s.wa0));
}

// One field of the slabs at the stencil, at each temporal weight: out[0]
// the old slab's value, out[1] the blend (o + n) * 0.5's; without the
// blend, out[0] the new slab's.
template <bool BLEND>
__device__ __forceinline__ void interp(const float* const* p, int base, int wb,
                                       const Stencil& s, float out[2]) {
  const int r0 = base + s.a0 * wb, r1 = base + s.a1 * wb;
  const int off[4] = {r0 + s.b0, r0 + s.b1, r1 + s.b0, r1 + s.b1};
  float v0[4], v1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float nv = ld(p[1], off[q]);
    if (BLEND) {
      const float o = ld(p[0], off[q]);
      v0[q] = o;
      v1[q] = __fmul_rn(__fadd_rn(o, nv), 0.5f);
    } else {
      v0[q] = nv;
    }
  }
  out[0] = contract(v0, s);
  if (BLEND) out[1] = contract(v1, s);
}

// The lattice weight of a direction of |c|^2 = d2, as float32 rounds the
// float64 value (lattice.W).
__device__ __forceinline__ float weight(int d2) {
  return d2 == 0 ? (float)(8.0 / 27.0)
                 : d2 == 1 ? (float)(2.0 / 27.0)
                           : d2 == 2 ? (float)(1.0 / 54.0) : (float)(1.0 / 216.0);
}

__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// One thread per plane cell (a, b) of a face and class pair (c_a, c_b):
// rho and u there, then the three directions of the pair at every weight.
template <typename OutT, bool BLEND>
__global__ void __launch_bounds__(THREADS) ghost_planes_kernel(const PlaneArgs a) {
  constexpr int NW = BLEND ? 2 : 1;
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= a.n) return;
  int gi = 0;
  while (gi + 1 < a.ng && i >= a.g[gi + 1].begin) ++gi;
  const PlaneGroup& g = a.g[gi];
  const int r = (int)(i - g.begin);  // a group's threads fit 32 bits
  const int AB = g.A * g.B;
  const int q = r / AB;  // face * 9 + class pair
  const int ab = r - q * AB;
  const int ia = ab / g.B, jb = ab - ia * g.B;
  const int fi = q / 9, ca = (q - 9 * fi) / 3, cb = q - 9 * fi - 3 * ca;
  const int slab = g.wa * g.wb;
  Stencil s;
  const int ta = (ca * g.A + ia) * 2, tb = (cb * g.B + jb) * 2;
  s.a0 = __ldg(g.col_a + ta);
  s.a1 = __ldg(g.col_a + ta + 1);
  s.wa0 = __ldg(g.w_a + ta);
  s.wa1 = __ldg(g.w_a + ta + 1);
  s.b0 = __ldg(g.col_b + tb);
  s.b1 = __ldg(g.col_b + tb + 1);
  s.wb0 = __ldg(g.w_b + tb);
  s.wb1 = __ldg(g.w_b + tb + 1);
  float u[3][2], rho[2], usq[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    interp<BLEND>(g.vel, (3 * fi + c) * slab, g.wb, s, u[c]);
  interp<BLEND>(g.rho, fi * slab, g.wb, s, rho);
#pragma unroll
  for (int n = 0; n < NW; ++n)
    usq[n] = __fadd_rn(__fadd_rn(__fmul_rn(u[0][n], u[0][n]), __fmul_rn(u[1][n], u[1][n])),
                       __fmul_rn(u[2][n], u[2][n]));
  const int t0 = g.axis == 0 ? 1 : 0;
  OutT* out = static_cast<OutT*>(g.out) + (long long)fi * NW * 27 * AB + ab;
#pragma unroll
  for (int cn = 0; cn < 3; ++cn) {
    // the direction's components along x, y, z
    const int cx = g.axis == 0 ? cn - 1 : ca - 1;
    const int cy = g.axis == 1 ? cn - 1 : (t0 == 1 ? ca - 1 : cb - 1);
    const int cz = g.axis == 2 ? cn - 1 : cb - 1;
    const int k = (cx + 1) + 3 * (cy + 1) + 9 * (cz + 1);
    const float w = weight(cx * cx + cy * cy + cz * cz);
    float fu[2];
    interp<BLEND>(g.f, (27 * fi + k) * slab, g.wb, s, fu);
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const float cu = __fadd_rn(__fadd_rn(__fmul_rn((float)cx, u[0][n]),
                                           __fmul_rn((float)cy, u[1][n])),
                                 __fmul_rn((float)cz, u[2][n]));
      float e = __fadd_rn(__fmul_rn(3.0f, cu), 1.0f);
      e = __fadd_rn(e, __fmul_rn(__fmul_rn(4.5f, cu), cu));
      e = __fsub_rn(e, __fmul_rn(1.5f, usq[n]));
      const float expr = __fmul_rn(rho[n], e);
      float up = fu[n], feq;
      if (a.g_shifted) {  // plane_g = feq_g + (g_up - feq_g) scale, feq_g = w (expr - 1)
        feq = __fmul_rn(w, __fsub_rn(expr, 1.0f));
        if (!a.g_store) up = __fsub_rn(up, w);
      } else {
        feq = __fmul_rn(w, expr);
        if (a.g_store) up = __fadd_rn(up, w);
      }
      store(out, (long long)(n * 27 + k) * AB,
            __fadd_rn(feq, __fmul_rn(__fsub_rn(up, feq), a.scale)));
    }
  }
}

int grid_of(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// C entry points (bound with ctypes in ops/ghost_planes.py).  Each launches
// on `stream`, never synchronises, allocates nothing, and returns the
// launch's CUDA error (0 on success).
//
// Extraction of the endpoint slabs of `ng` groups from a parent state
// (27, X, Y, Z) f (float32 or bf16), (X, Y, Z) rho, (3, X, Y, Z) vel into
// `out` (float32).  Per group, gi holds axis, nf, wa, wb, sa, sb, the four
// normal planes and the offset of its slabs in `out` (11 ints); gw the
// lerp weights w_lo, w_hi of each face (4 floats).
extern "C" int ol_ghost_extract(int store_bf16, const void* f, const void* rho,
                                const void* vel, void* out, int X, int Y, int Z,
                                int ng, const int* gi, const float* gw, void* stream) {
  if (ng < 1 || ng > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  ExtractArgs a{};
  a.ng = ng;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  long long n = 0;
  for (int q = 0; q < ng; ++q) {
    const int* p = gi + 11 * q;
    ExtractGroup& g = a.g[q];
    g.begin = n;
    g.axis = p[0];
    g.nf = p[1];
    g.wa = p[2];
    g.wb = p[3];
    g.sa = p[4];
    g.sb = p[5];
    for (int j = 0; j < 4; ++j) g.idx[j] = p[6 + j];
    g.out = static_cast<float*>(out) + p[10];
    for (int j = 0; j < 2; ++j) {
      g.w_lo[j] = gw[4 * q + 2 * j];
      g.w_hi[j] = gw[4 * q + 2 * j + 1];
    }
    if (g.axis < 0 || g.axis > 2 || g.nf < 1 || g.nf > 2 ||
        (long long)g.nf * 31 * g.wa * g.wb >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    n += (long long)g.nf * 31 * g.wa * g.wb;
  }
  a.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16)
    ghost_extract_kernel<__nv_bfloat16><<<grid_of(n), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f), static_cast<const float*>(rho),
        static_cast<const float*>(vel), a);
  else
    ghost_extract_kernel<float><<<grid_of(n), THREADS, 0, s>>>(
        static_cast<const float*>(f), static_cast<const float*>(rho),
        static_cast<const float*>(vel), a);
  return (int)cudaGetLastError();
}

// The planes of `ng` groups at `nw` temporal weights (2 with the blend, 1
// without).  Per group, ptrs holds f, rho, vel of the old slabs (null
// without the blend), f, rho, vel of the new, the output planes and the
// tap tables col_a, w_a, col_b, w_b (11 pointers); gi holds axis, nf, A,
// B, wa, wb (6 ints).  g_store: the slabs hold bf16 storage's g; g_shifted:
// the planes are g = f - w; out_bf16: they are stored bf16, else float32.
extern "C" int ol_ghost_planes(int out_bf16, int ng, void* const* ptrs, const int* gi,
                               int nw, int blend, int g_store, int g_shifted,
                               float scale, void* stream) {
  if (ng < 1 || ng > MAX_GROUPS || nw != (blend ? 2 : 1)) return (int)cudaErrorInvalidValue;
  PlaneArgs a{};
  a.ng = ng;
  a.g_store = g_store;
  a.g_shifted = g_shifted;
  a.scale = scale;
  long long n = 0;
  for (int q = 0; q < ng; ++q) {
    void* const* p = ptrs + 11 * q;
    const int* v = gi + 6 * q;
    PlaneGroup& g = a.g[q];
    g.begin = n;
    g.f[0] = static_cast<const float*>(p[0]);
    g.rho[0] = static_cast<const float*>(p[1]);
    g.vel[0] = static_cast<const float*>(p[2]);
    g.f[1] = static_cast<const float*>(p[3]);
    g.rho[1] = static_cast<const float*>(p[4]);
    g.vel[1] = static_cast<const float*>(p[5]);
    g.out = p[6];
    g.col_a = static_cast<const int*>(p[7]);
    g.w_a = static_cast<const float*>(p[8]);
    g.col_b = static_cast<const int*>(p[9]);
    g.w_b = static_cast<const float*>(p[10]);
    g.axis = v[0];
    g.nf = v[1];
    g.A = v[2];
    g.B = v[3];
    g.wa = v[4];
    g.wb = v[5];
    // the slabs' offsets and the group's threads are 32-bit
    if (g.axis < 0 || g.axis > 2 || g.nf < 1 || g.nf > 2 ||
        (long long)g.nf * 31 * g.wa * g.wb >= (1LL << 31) ||
        (long long)g.nf * 9 * g.A * g.B >= (1LL << 31) ||
        (blend && (!g.f[0] || !g.rho[0] || !g.vel[0])))
      return (int)cudaErrorInvalidValue;
    n += (long long)g.nf * 9 * g.A * g.B;
  }
  a.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(n);
  if (out_bf16 && blend)
    ghost_planes_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(a);
  else if (out_bf16)
    ghost_planes_kernel<__nv_bfloat16, false><<<grid, THREADS, 0, s>>>(a);
  else if (blend)
    ghost_planes_kernel<float, true><<<grid, THREADS, 0, s>>>(a);
  else
    ghost_planes_kernel<float, false><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
