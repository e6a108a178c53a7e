// The ghost planes of a child level: the parent's endpoint slabs and the
// child's pre-shifted interface planes, one launch each, or both in one
// launch from the parent's two states.
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
// ghost_build_kernel: a child build in one launch where its parent steps
// A -> B (K1 or K4 on one card): the pre-step state (old) still lies in
// its own buffers while the child builds, so the kernel reads the parent's
// two states directly and no endpoint slab is written, read back or
// carried.  One block per tile of a face's extended cells and normal class
// of the directions (three blocks a tile): it stages its window of the 13
// channels its directions read, lerped along the normal as the extraction
// does and blended as the planes kernel does, in shared memory, then
// makes the nine class pairs of its class from it in the planes kernel's
// order of operations, so its planes equal the two kernels' bit for bit.
// The tile (`dense_step.build_tiles`) is 8 x 16 extended cells, 16 x 16 on
// the z faces of a build whose 8 x 16 z tiles alone number one a SM, so
// the smallest child of the benchmark's cells still launches over two
// blocks a SM.  The two kernels still run under a K5 parent (its in-place
// step overwrites the old state, so its old slabs are extracted before the
// launch and carried), under the x mesh (slabs assembled from the x slabs)
// and wherever a caller passes slabs.
//
// What bounds them on an H100: bytes, and for the fused build the parent's
// sectors.  A child build of the Re10M sphere's finest level writes 13.6
// MB of planes and 4.4 MB of slabs and reads the slabs twice, ~9 us at
// 3.35 TB/s with the parent's window and the carry.  Measured (PERF.md):
// the planes kernel at ~3x its bytes, 56 loads of slab values (L1 / L2
// hits) against 6 stores a thread, and the extraction's z-face group
// reading one 32-byte sector per two values (the window's columns lie a
// row of z apart).  The fused build reads both states' planes, so a z face
// costs a sector per value and state, once for each tile whose window
// holds it and, for rho and vel, once for each class: its staging (one
// round of two channels' loads after another) takes most of a block's
// time, ~5 us on the headline's children and ~20 us on the z faces of
// Re10M's finest.  From a graph (PERF.md section 6): 0.0118 ms on the
// headline's level 2 (bound 0.0014; the two kernels and the carry
// 0.0138), 0.0325 ms on Re10M's level 4 (bound 0.0067; 0.0360).  Tried
// and dropped for the fused build: every staged load of a thread in
// flight at once (96 registers, five
// blocks a SM, slower), one 16-byte load for a z face's two planes
// (slower), the nine (axis, class) bodies as template instances (twice
// as slow), launch bounds for 9 or 10 blocks a SM and rounds of three
// channels (no gain), 8 x 8 and 16 x 16 tiles on every face (slower on
// the small children).  Tried and dropped for the planes kernel: a
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

// rho and u at a stencil, at each temporal weight, and |u|^2.  at(ch, v)
// gives slab channel ch (f slot k, then 27 rho, 28 + c vel c) at the
// stencil: v[0] the old slab's value (the new one's without the blend),
// v[1] the blend's.
struct Moments {
  float u[3][2], rho[2], usq[2];
};

template <bool BLEND, typename At>
__device__ __forceinline__ void moments(const At& at, Moments& m) {
#pragma unroll
  for (int c = 0; c < 3; ++c) at(28 + c, m.u[c]);
  at(27, m.rho);
#pragma unroll
  for (int n = 0; n < (BLEND ? 2 : 1); ++n)
    m.usq[n] = __fadd_rn(__fadd_rn(__fmul_rn(m.u[0][n], m.u[0][n]),
                                   __fmul_rn(m.u[1][n], m.u[1][n])),
                         __fmul_rn(m.u[2][n], m.u[2][n]));
}

// The planes of direction (cx, cy, cz) at one plane cell from its f slot
// `fu` and the moments at the same stencil, at every weight: the
// equilibrium split and the f_neq rescale, op by op.  `out` points at the
// cell's slot 0 at weight 0 of the face's (nw, 27, A, B) planes.
template <typename OutT, bool BLEND>
__device__ __forceinline__ void direction(const Moments& m, const float fu[2], int cx,
                                          int cy, int cz, OutT* out, int AB, int g_store,
                                          int g_shifted, float scale) {
  const int k = (cx + 1) + 3 * (cy + 1) + 9 * (cz + 1);
  const float w = weight(cx * cx + cy * cy + cz * cz);
#pragma unroll
  for (int n = 0; n < (BLEND ? 2 : 1); ++n) {
    const float cu = __fadd_rn(__fadd_rn(__fmul_rn((float)cx, m.u[0][n]),
                                         __fmul_rn((float)cy, m.u[1][n])),
                               __fmul_rn((float)cz, m.u[2][n]));
    float e = __fadd_rn(__fmul_rn(3.0f, cu), 1.0f);
    e = __fadd_rn(e, __fmul_rn(__fmul_rn(4.5f, cu), cu));
    e = __fsub_rn(e, __fmul_rn(1.5f, m.usq[n]));
    const float expr = __fmul_rn(m.rho[n], e);
    float up = fu[n], feq;
    if (g_shifted) {  // plane_g = feq_g + (g_up - feq_g) scale, feq_g = w (expr - 1)
      feq = __fmul_rn(w, __fsub_rn(expr, 1.0f));
      if (!g_store) up = __fsub_rn(up, w);
    } else {
      feq = __fmul_rn(w, expr);
      if (g_store) up = __fadd_rn(up, w);
    }
    store(out, (long long)(n * 27 + k) * AB,
          __fadd_rn(feq, __fmul_rn(__fsub_rn(up, feq), scale)));
  }
}

// The direction's components along x, y, z from its classes c + 1 along
// the face's transverse axes (ca along A, cb along B) and its normal (cn).
__device__ __forceinline__ void components(int axis, int ca, int cb, int cn, int& cx,
                                           int& cy, int& cz) {
  const int t0 = axis == 0 ? 1 : 0;
  cx = axis == 0 ? cn - 1 : ca - 1;
  cy = axis == 1 ? cn - 1 : (t0 == 1 ? ca - 1 : cb - 1);
  cz = axis == 2 ? cn - 1 : cb - 1;
}

// One thread per plane cell (a, b) of a face and class pair (c_a, c_b),
// reading the endpoint slabs: rho and u there, then the pair's three
// directions.
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
  auto at = [&](int ch, float v[2]) {
    if (ch < 27)
      interp<BLEND>(g.f, (27 * fi + ch) * slab, g.wb, s, v);
    else if (ch == 27)
      interp<BLEND>(g.rho, fi * slab, g.wb, s, v);
    else
      interp<BLEND>(g.vel, (3 * fi + ch - 28) * slab, g.wb, s, v);
  };
  Moments m;
  moments<BLEND>(at, m);
  OutT* out = static_cast<OutT*>(g.out) + (long long)fi * NW * 27 * AB + ab;
#pragma unroll
  for (int cn = 0; cn < 3; ++cn) {
    int cx, cy, cz;
    components(g.axis, ca, cb, cn, cx, cy, cz);
    float fu[2];
    at((cx + 1) + 3 * (cy + 1) + 9 * (cz + 1), fu);
    direction<OutT, BLEND>(m, fu, cx, cy, cz, out, AB, a.g_store, a.g_shifted, a.scale);
  }
}

// ---- the fused build ----

constexpr int BUILD_THREADS = 128;  // a tile's cells, or half of them
constexpr int BUILD_SMEM = 48 * 1024;   // static limit of a launch's shared memory

struct BuildGroup {
  int begin;             // the group's first block
  void* out;             // (nf, nw, 27, A, B) in the output type
  const int* row_a;      // (A + 2, 2): per extended row, its two slab columns
  const float* w_a;      // and their weights
  const int* row_b;      // (B + 2, 2)
  const float* w_b;
  const int* win_a;      // (tiles along A, 2): a tile's first staged slab column, count
  const int* win_b;      // (tiles along B, 2)
  int axis, nf, A, B, sa, sb;
  int ta, tb, tiles_a, tiles_b;  // the group's tiles: extended rows x columns, counts
  int idx[4];            // per face, the two parent planes along the normal
  float w_lo[2], w_hi[2];
};

struct BuildArgs {
  BuildGroup g[MAX_GROUPS];
  int ng, g_store, g_shifted;
  float scale;
  int X, Y, Z;
};

__device__ __forceinline__ float lerp(float v0, float v1, float w_lo, float w_hi) {
  return __fadd_rn(__fmul_rn(v0, w_lo), __fmul_rn(v1, w_hi));
}

// The f slot of the direction of classes (ca, cb) along a face's
// transverse axes and cn along its normal `axis`.
__device__ __forceinline__ int slot_of(int axis, int ca, int cb, int cn) {
  int cx, cy, cz;
  components(axis, ca, cb, cn, cx, cy, cz);
  return (cx + 1) + 3 * (cy + 1) + 9 * (cz + 1);
}

// One block per tile (ta x tb extended cells) of a face and normal class
// cn of the directions, a thread a cell (two rounds on a tile of twice the
// block's threads).  An extended cell (r, s), r < A + 2, s < B + 2, is a
// row of the 2x upsample along each transverse axis before the window
// shift: plane cell (a, b) of class pair (c_a, c_b) reads the stencil of
// (a + 1 - c_a, b + 1 - c_b) (`dense_step.build_iface_mm_plan`'s UA3 /
// UB3 rows), so every plane value of a face comes from exactly one
// extended cell, and rho and u there serve all nine class pairs.  First
// the block stages its window of the 13 channels its directions read (the
// nine f slots of class cn, rho and vel) of the face's endpoint slab (the
// parent's two planes along the normal lerped as ghost_extract_kernel
// does) in shared memory: per channel the old value and the blend (o + n)
// * 0.5, or the new value without the blend.  Then the thread of cell (r,
// s) makes rho and u there and the nine directions of class cn whose
// plane cell lies on the face, each as ghost_planes_kernel does.  The
// three blocks of a tile, one a class, are neighbours in the grid, so the
// window's rho and vel that all three stage come mostly from L2.
template <typename InT, typename OutT, bool BLEND>
__global__ void __launch_bounds__(BUILD_THREADS)
ghost_build_kernel(const InT* __restrict__ f_old, const float* __restrict__ rho_old,
                   const float* __restrict__ vel_old, const InT* __restrict__ f_new,
                   const float* __restrict__ rho_new, const float* __restrict__ vel_new,
                   const BuildArgs a) {
  constexpr int NW = BLEND ? 2 : 1;
  extern __shared__ float sm[];  // (NW, 13, wh, ww): f slots by class pair, rho, vel
  const int cn = blockIdx.x % 3, blk = blockIdx.x / 3;
  int gi = 0;
  while (gi + 1 < a.ng && blk >= a.g[gi + 1].begin) ++gi;
  const BuildGroup& g = a.g[gi];
  const int per_face = g.tiles_a * g.tiles_b;
  const int r = blk - g.begin;
  const int fi = r / per_face;
  const int ti = (r - fi * per_face) / g.tiles_b, tj = r - fi * per_face - ti * g.tiles_b;
  // this thread's first extended cell (and in a tile of two rounds the
  // per-th after it); its taps are loaded before the staging, whose loads
  // hide their latency
  const int cells = g.ta * g.tb, per = blockDim.x;
  int c = threadIdx.x;
  int er = ti * g.ta + c / g.tb, es = tj * g.tb + c % g.tb;
  const bool live = er < g.A + 2 && es < g.B + 2;
  Stencil s{};
  if (live) {
    s.a0 = __ldg(g.row_a + 2 * er);
    s.a1 = __ldg(g.row_a + 2 * er + 1);
    s.wa0 = __ldg(g.w_a + 2 * er);
    s.wa1 = __ldg(g.w_a + 2 * er + 1);
    s.b0 = __ldg(g.row_b + 2 * es);
    s.b1 = __ldg(g.row_b + 2 * es + 1);
    s.wb0 = __ldg(g.w_b + 2 * es);
    s.wb1 = __ldg(g.w_b + 2 * es + 1);
  }
  const int a_lo = __ldg(g.win_a + 2 * ti), wh = __ldg(g.win_a + 2 * ti + 1);
  const int b_lo = __ldg(g.win_b + 2 * tj), ww = __ldg(g.win_b + 2 * tj + 1);
  const int wsz = wh * ww;
  const long long N = (long long)a.X * a.Y * a.Z;
  const int t0 = g.axis == 0 ? 1 : 0, t1 = g.axis == 2 ? 1 : 2;
  const float w_lo = g.w_lo[fi], w_hi = g.w_hi[fi];
  // Each thread stages one cell of the window for every lanes-th channel:
  // its two parent positions are found once, and each round of two
  // channels issues all of its loads before it uses one.
  const int lanes = blockDim.x / wsz;  // >= 1 (ol_ghost_build)
  const int lane = threadIdx.x / wsz, cell = threadIdx.x - lane * wsz;
  if (lane < lanes) {
    const int i = cell / ww;
    int pos[3];
    pos[t0] = g.sa + a_lo + i;
    pos[t1] = g.sb + b_lo + cell - i * ww;
    pos[g.axis] = g.idx[2 * fi];
    const long long c0 = ((long long)pos[0] * a.Y + pos[1]) * a.Z + pos[2];
    pos[g.axis] = g.idx[2 * fi + 1];
    const long long c1 = ((long long)pos[0] * a.Y + pos[1]) * a.Z + pos[2];
    // staged channel j of a state at both planes: f slot of classes
    // (j / 3, j % 3, cn), then 9 rho and 10 + c vel c
    auto fetch = [&](const InT* f, const float* rho, const float* vel, int j,
                     float& v0, float& v1) {
      if (j < 9) {
        const long long base = (long long)slot_of(g.axis, j / 3, j % 3, cn) * N;
        v0 = ld(f, base + c0);
        v1 = ld(f, base + c1);
      } else if (j == 9) {
        v0 = ld(rho, c0);
        v1 = ld(rho, c1);
      } else {
        const long long base = (long long)(j - 10) * N;
        v0 = ld(vel, base + c0);
        v1 = ld(vel, base + c1);
      }
    };
    for (int j0 = lane; j0 < 13; j0 += 2 * lanes) {
      float v[2][4];  // per channel: the new state's two planes, the old's
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = j0 + m * lanes;
        if (j < 13) {
          fetch(f_new, rho_new, vel_new, j, v[m][0], v[m][1]);
          if (BLEND) fetch(f_old, rho_old, vel_old, j, v[m][2], v[m][3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = j0 + m * lanes;
        if (j < 13) {
          const float nv = lerp(v[m][0], v[m][1], w_lo, w_hi);
          if (BLEND) {
            const float o = lerp(v[m][2], v[m][3], w_lo, w_hi);
            sm[j * wsz + cell] = o;
            sm[(13 + j) * wsz + cell] = __fmul_rn(__fadd_rn(o, nv), 0.5f);
          } else {
            sm[j * wsz + cell] = nv;
          }
        }
      }
    }
  }
  __syncthreads();
  const int AB = g.A * g.B;
  OutT* face = static_cast<OutT*>(g.out) + (long long)fi * NW * 27 * AB;
  // the planes of extended cell (er, es) from its stencil `t` (slab columns)
  auto planes_at = [&](int er, int es, Stencil t) {
    t.a0 -= a_lo;
    t.a1 -= a_lo;
    t.b0 -= b_lo;
    t.b1 -= b_lo;
    // staged channel j at the stencil, at each temporal weight
    auto at = [&](int j, float v[2]) {
      const int r0 = j * wsz + t.a0 * ww, r1 = j * wsz + t.a1 * ww;
      const int off[4] = {r0 + t.b0, r0 + t.b1, r1 + t.b0, r1 + t.b1};
      float v0[4], v1[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        v0[p] = sm[off[p]];
        if (BLEND) v1[p] = sm[13 * wsz + off[p]];
      }
      v[0] = contract(v0, t);
      if (BLEND) v[1] = contract(v1, t);
    };
    Moments m;  // slab channel 27 + q is staged channel 9 + q
    moments<BLEND>([&](int ch, float v[2]) { at(ch - 18, v); }, m);
#pragma unroll
    for (int ca = 0; ca < 3; ++ca) {
      const int ia = er - 2 + ca;  // the plane cell this cell serves for class ca
      if (ia < 0 || ia >= g.A) continue;
#pragma unroll
      for (int cb = 0; cb < 3; ++cb) {
        const int jb = es - 2 + cb;
        if (jb < 0 || jb >= g.B) continue;
        int cx, cy, cz;
        components(g.axis, ca, cb, cn, cx, cy, cz);
        float fu[2];
        at(3 * ca + cb, fu);
        direction<OutT, BLEND>(m, fu, cx, cy, cz, face + ia * g.B + jb, AB, a.g_store,
                               a.g_shifted, a.scale);
      }
    }
  };
  if (live) planes_at(er, es, s);
  if (cells > per) {  // a tile of two rounds: the thread's second cell
    c += per;
    er = ti * g.ta + c / g.tb;
    es = tj * g.tb + c % g.tb;
    if (er < g.A + 2 && es < g.B + 2) {
      Stencil t;
      t.a0 = __ldg(g.row_a + 2 * er);
      t.a1 = __ldg(g.row_a + 2 * er + 1);
      t.wa0 = __ldg(g.w_a + 2 * er);
      t.wa1 = __ldg(g.w_a + 2 * er + 1);
      t.b0 = __ldg(g.row_b + 2 * es);
      t.b1 = __ldg(g.row_b + 2 * es + 1);
      t.wb0 = __ldg(g.w_b + 2 * es);
      t.wb1 = __ldg(g.w_b + 2 * es + 1);
      planes_at(er, es, t);
    }
  }
}

template <typename InT, typename OutT, bool BLEND>
void launch_build(const void* const* st, const BuildArgs& a, int blocks, int threads,
                  int smem, cudaStream_t s) {
  ghost_build_kernel<InT, OutT, BLEND><<<blocks, threads, smem, s>>>(
      static_cast<const InT*>(st[0]), static_cast<const float*>(st[1]),
      static_cast<const float*>(st[2]), static_cast<const InT*>(st[3]),
      static_cast<const float*>(st[4]), static_cast<const float*>(st[5]), a);
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

// A child build in one launch, from the parent's states before (old) and
// after (new) its step: f (27, X, Y, Z) float32 or bf16, rho (X, Y, Z) and
// vel (3, X, Y, Z) float32; `st` holds f, rho, vel of the old state (null
// without the blend), then of the new.  Per group, ptrs holds the output
// planes, the extended tap tables row_a, w_a, row_b, w_b and the tile
// windows win_a, win_b (7 pointers); gi holds axis, nf, A, B, the window's
// starts sa, sb, the four normal planes and the group's tile ta x tb (12
// ints); gw the lerp weights w_lo, w_hi of each face (4 floats).  Three
// blocks a tile, one a normal class, of `threads` threads, a thread a cell
// of a tile of one or two such rounds; `cells` the largest tile window's
// cells (its shared memory).
// The last group's blocks come first.  in_bf16: f is bf16 storage's g;
// g_shifted: the planes are g = f - w; out_bf16: they are stored bf16, else
// float32.
extern "C" int ol_ghost_build(int in_bf16, int out_bf16, const void* const* st, int X,
                              int Y, int Z, int ng, void* const* ptrs, const int* gi,
                              const float* gw, int threads, int cells, int blend,
                              int g_shifted, float scale, void* stream) {
  const int nw = blend ? 2 : 1;
  const long long smem = (long long)nw * 13 * cells * (long long)sizeof(float);
  if (ng < 1 || ng > MAX_GROUPS || threads < 32 || threads > BUILD_THREADS ||
      cells < 1 || cells > threads || smem > BUILD_SMEM || !st[3] || !st[4] || !st[5] ||
      (blend && (!st[0] || !st[1] || !st[2])))
    return (int)cudaErrorInvalidValue;
  BuildArgs a{};
  a.ng = ng;
  a.g_store = in_bf16;
  a.g_shifted = g_shifted;
  a.scale = scale;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  long long blocks = 0;
  for (int k = 0; k < ng; ++k) {
    const int q = ng - 1 - k;  // the z faces' blocks, the heaviest, first
    void* const* p = ptrs + 7 * q;
    const int* v = gi + 12 * q;
    BuildGroup& g = a.g[k];
    g.begin = (int)blocks;
    g.out = p[0];
    g.row_a = static_cast<const int*>(p[1]);
    g.w_a = static_cast<const float*>(p[2]);
    g.row_b = static_cast<const int*>(p[3]);
    g.w_b = static_cast<const float*>(p[4]);
    g.win_a = static_cast<const int*>(p[5]);
    g.win_b = static_cast<const int*>(p[6]);
    g.axis = v[0];
    g.nf = v[1];
    g.A = v[2];
    g.B = v[3];
    g.sa = v[4];
    g.sb = v[5];
    for (int j = 0; j < 4; ++j) g.idx[j] = v[6 + j];
    g.ta = v[10];
    g.tb = v[11];
    for (int j = 0; j < 2; ++j) {
      g.w_lo[j] = gw[4 * q + 2 * j];
      g.w_hi[j] = gw[4 * q + 2 * j + 1];
    }
    // the planes' offsets are 32-bit within a face's (nw, 27, A, B), and a
    // tile is whole rounds of threads / 3 cells
    if (g.axis < 0 || g.axis > 2 || g.nf < 1 || g.nf > 2 || g.A < 1 || g.B < 1 ||
        g.ta < 1 || g.tb < 1 || (g.ta * g.tb != threads && g.ta * g.tb != 2 * threads) ||
        (long long)g.nf * nw * 27 * g.A * g.B >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    g.tiles_a = (g.A + 2 + g.ta - 1) / g.ta;
    g.tiles_b = (g.B + 2 + g.tb - 1) / g.tb;
    blocks += (long long)g.nf * g.tiles_a * g.tiles_b;
  }
  if (3 * blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = (int)(3 * blocks), sh = (int)smem;  // three blocks a tile, one a class
  if (in_bf16) {
    if (out_bf16 && blend)
      launch_build<__nv_bfloat16, __nv_bfloat16, true>(st, a, n, threads, sh, s);
    else if (out_bf16)
      launch_build<__nv_bfloat16, __nv_bfloat16, false>(st, a, n, threads, sh, s);
    else if (blend)
      launch_build<__nv_bfloat16, float, true>(st, a, n, threads, sh, s);
    else
      launch_build<__nv_bfloat16, float, false>(st, a, n, threads, sh, s);
  } else {
    if (out_bf16 && blend)
      launch_build<float, __nv_bfloat16, true>(st, a, n, threads, sh, s);
    else if (out_bf16)
      launch_build<float, __nv_bfloat16, false>(st, a, n, threads, sh, s);
    else if (blend)
      launch_build<float, float, true>(st, a, n, threads, sh, s);
    else
      launch_build<float, float, false>(st, a, n, threads, sh, s);
  }
  return (int)cudaGetLastError();
}
