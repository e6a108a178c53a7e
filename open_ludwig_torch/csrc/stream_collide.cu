// K1: one stream-collide sub-step of one dense refinement level.
//
// Replaces the Pallas kernel make_pallas_step
// (open_ludwig_tpu/ops/pallas_step.py:247, pallas_call at :883).
//
// The cell body (pull, face conditions, collision, stores, on one flat
// grid with z fastest) is stream_collide_body.cuh's, which K4 shares; K1
// instantiates it with the interface faces' ghost planes.
//
// What bounds it on an H100.  A bf16 step moves ~145 bytes a cell (27*2
// read f, 27*2 write f, 12 read vel, 16 write rho and vel, 9 statics); f32
// ~253.  On the levels of 0.2-1.1M cells that multi-level cases run, K1 is
// bound by the instructions and latencies of its cells, not by bytes: the
// bulk copies of a tile's f alone run at ~2.7 TB/s (10.5 us of the 48 us
// that K1 took on a 60x64x128 bf16 level), and the face phase was the
// longest section of a cell (tools/probe_k1_sections.py: 427 of 1,145
// warp-cycles a cell on the bench's L2 in bf16).  Its warps diverge there:
// a z face falls on every row, so half the warps of a 128-cell row carry a
// face lane, and the whole warp waited for that lane's 27 per-slot face
// tests and branches (csrc/lbm_cell.cuh, apply_faces).  What the design
// does: the addressing of the body (plane base pointers, 32-bit offsets, z
// unclamped, the index decoded by reciprocals); the face phase face by face
// with the face a constant and one branch on its condition for its nine
// slots (`face_slots`); 128 threads capped at 64 registers (8 blocks a SM,
// none spilled); the wall model's transcendental chain only where the wall
// distance is in (0, 10) (collide_values).  All bit-equal.
// Measured at the benchmark cells' levels from a CUDA graph, in turns with
// the per-slot face phase at 56 registers (PERF.md; before -> after, % of
// the byte bound after): bf16 46x48x104 0.0206 -> 0.0132 ms (80%),
// 60x64x128 0.0483 -> 0.0341 (64%); float32 48x48x120 0.0377 -> 0.0298
// (74%), 62x64x128 0.0600 -> 0.0504 (79%), 94x88x128 0.1123 -> 0.1002
// (82%), 400^3 6.153 -> 6.101 ms (79%).  Uncapped, this face phase takes
// 110-118 registers and runs 13-29% slower than at 64; at 56 (9 a SM)
// bf16 spills and loses 1-11%.
// Measured and taken out (PERF.md): a grid over (z-tiles, y-tiles, x)
// (idle lanes and row segments off the 128-byte lines on the 10.8M-cell
// level: 0.80 against 0.70 ms); two z-adjacent cells a thread with paired
// accesses (96-128 registers, half the resident warps: 1.08 ms at 10.8M
// cells, 4.59 at 63.7M against 4.05); a persistent kernel whose warps pull
// from a ring of 128-cell tiles in shared memory, fed by bulk copies
// (cp.async.bulk on mbarriers) one to three tiles ahead, tiles taken from
// a counter: bit-equal, at parity to 2% slower in float32 and 15-50%
// slower in bf16 (60x64x128 0.055-0.061 ms against 0.048; 64 registers, 8
// CTAs a SM; the loads it overlaps were not what bound the cells); cell
// maps that put a row's two z-face lanes into one warp (one cell of shift:
// 30-70% slower, every access off its 128-byte line).

#include "stream_collide_body.cuh"

#ifdef OL_K1_SECTIONS
// tools/probe_k1_sections.py builds K1 with -DOL_K1_SECTIONS: lane 0 of each
// warp adds the clock64() cycles between two marks to the section's counter,
// [7] counts the cells of the warps that timed.
__device__ unsigned long long ol_k1_cycles[8];
struct SectionMark {
  long long& t;
  __device__ __forceinline__ void operator()(int s) const {
    const long long now = clock64();
    if ((threadIdx.x & 31) == 0)
      atomicAdd(&ol_k1_cycles[s], (unsigned long long)(now - t));
    t = now;
  }
};
#endif

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // 64 registers a thread, none spilled

template <typename T, bool SHARD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) stream_collide_kernel(const sc::Params p) {
#ifdef OL_K1_SECTIONS
  long long t_mark = clock64();
  const SectionMark mark{t_mark};
#else
  const lbm::NoMark mark;
#endif
  const unsigned cell = blockIdx.x * THREADS + threadIdx.x;
  if (cell >= (unsigned)p.N) return;
#ifdef OL_K1_SECTIONS
  const unsigned active = __activemask();
  if ((threadIdx.x & 31) == 0) atomicAdd(&ol_k1_cycles[7], (unsigned long long)__popc(active));
#endif
  sc::update_cell<T, true, SHARD>(p, cell, mark);
}

template <bool SHARD>
int launch(int store_bf16, const sc::Params& p, void* stream) {
  const unsigned blocks = (unsigned)(((long long)p.N + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16)
    stream_collide_kernel<__nv_bfloat16, SHARD><<<blocks, THREADS, 0, s>>>(p);
  else
    stream_collide_kernel<float, SHARD><<<blocks, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
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
    const void* rec_t, const void* rec_u, int rec_last, int rec_dt,
    int rec_shift, int rec_k, double tau, double c_wale, double nu_sgs,
    double inlet_turb, int wall_model, int sponge_blend, void* stream) {
  sc::Params p;
  const void* planes[6] = {plane0, plane1, plane2, plane3, plane4, plane5};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  if (!sc::make_params(p, store_bf16, f_in, vel_in, f_out, rho_out, vel_out,
                       obstacle, sponge, wall, planes, X, Y, Z, lo_y, lo_z, bcs,
                       u_inlet, seed, tau, c_wale, nu_sgs, inlet_turb,
                       wall_model, sponge_blend) ||
      !lbm::set_record(p.s, rec_t, rec_u, rec_last, rec_dt, rec_shift, rec_k))
    return (int)cudaErrorInvalidValue;
  return launch<false>(store_bf16, p, stream);
}

// The sharded form: one x slab (27, X, Y, Z) of a level of gX planes whose
// first plane is global x_off, with the neighbour slabs' edge planes f_edges
// (27, 2, Y, Z, storage type) and v_edges (3, 2, Y, Z, float32); y and z
// faces' ghost planes are the slab's own x range (27, X, B), x faces' whole
// planes (read only by the slabs holding x = 0 or gX - 1).  The JAX
// package's shard_nx form of make_pallas_step (pallas_step.py:769-781).
extern "C" int ol_stream_collide_shard(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, const void* plane0, const void* plane1,
    const void* plane2, const void* plane3, const void* plane4,
    const void* plane5, const void* f_edges, const void* v_edges, int x_off,
    int gX, int X, int Y, int Z, int lo_y, int lo_z, int bc0, int bc1,
    int bc2, int bc3, int bc4, int bc5, float u_inlet, int seed,
    const void* rec_t, const void* rec_u, int rec_last, int rec_dt,
    int rec_shift, int rec_k, double tau, double c_wale, double nu_sgs,
    double inlet_turb, int wall_model, int sponge_blend, void* stream) {
  sc::Params p;
  const void* planes[6] = {plane0, plane1, plane2, plane3, plane4, plane5};
  int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  // an x face this slab does not hold needs no plane here
  if (x_off != 0) bcs[0] = bc0 == lbm::BC_INTERFACE ? lbm::BC_OUTLET : bc0;
  if (x_off + X != gX) bcs[1] = bc1 == lbm::BC_INTERFACE ? lbm::BC_OUTLET : bc1;
  if (!sc::make_params(p, store_bf16, f_in, vel_in, f_out, rho_out, vel_out,
                       obstacle, sponge, wall, planes, X, Y, Z, lo_y, lo_z, bcs,
                       u_inlet, seed, tau, c_wale, nu_sgs, inlet_turb,
                       wall_model, sponge_blend) ||
      !lbm::set_record(p.s, rec_t, rec_u, rec_last, rec_dt, rec_shift, rec_k) ||
      !sc::make_slab(p, f_edges, v_edges, x_off, gX))
    return (int)cudaErrorInvalidValue;
  return launch<true>(store_bf16, p, stream);
}

#ifdef OL_K1_SECTIONS
// The section counters: copied to out[8] (reset = 0) or zeroed (reset = 1).
extern "C" int ol_k1_sections(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return (int)cudaMemcpyToSymbol(ol_k1_cycles, zero, sizeof zero);
  }
  return (int)cudaMemcpyFromSymbol(out, ol_k1_cycles, 8 * sizeof(unsigned long long));
}
#endif
