// K4: one stream-collide sub-step of a level without interface faces.
//
// Replaces the Pallas kernel make_pallas_step_flat
// (open_ludwig_tpu/ops/pallas_step.py:2100, pallas_call at :2411), which the
// JAX package runs on level 1 of every multi-level case (the wind tunnel:
// inlet, outlet and mirror faces, no interface).
//
// The TPU kernel keeps the level as a flat (27, X, M) array with
// n = y * Z + z and M = Y * Z, so that its lane axis is full, and streams
// with one lane roll by cy * Z + cz; a source that wraps into the next y
// row lies on a face row, whose condition overwrites it.  The port stores
// every level as (27, X, Y, Z) without padding, which is the same memory:
// K1's flat cell index x * YZ + n with z offsets of +-1 is already that
// view, and a z source that wraps into the next row lands on a face row
// too (apply_faces overwrites it).  So K4 is the cell body of K1
// (stream_collide_body.cuh) with IFACE = false: the ghost-plane reads are
// compiled out, and a level with an interface face is refused.  K4 equals
// K1 bit for bit on an interface-free level.  A -> B buffers as in K1:
// level 1 is a parent, and its pre-step state feeds the child's ghost
// planes after the step (solver_dense.py).
//
// What bounds it on an H100: bytes, ~145 B a cell in bf16 (as K1), and at
// the bench case's level 1, 64 x 56 x 56 = 200,704 cells (~29 MB, 8.7 us
// at 3.35 TB/s), the waves.  So the instantiation depends on the storage
// type and the level (`choose`), each measured against the others at
// 64x56x56 and 232x216x216 with the face phase of csrc/lbm_cell.cuh as it
// stands (tools/probe_k4_shapes.py, PERF.md; device times from a CUDA
// graph): 128 threads capped at 64 registers (8 a SM, none spilled)
// everywhere but bf16 levels of more than two waves of that shape, which
// take 128 threads at 48 registers (10 a SM, 4 B spilled).  bf16 at L1
// 0.0107-0.0111 ms against 0.0113-0.0117 at 10 a SM and 0.0123 for the
// one-wave <256, 6> (40 registers, 60 B spilled) that was the choice
// before; at 10.8M cells 0.6326 against 0.6176.  float32 at L1 0.0230 ms
// against 0.0248 uncapped (118 registers), at 10.8M cells 0.997 against
// 1.131.

#include "stream_collide_body.cuh"

namespace {

template <typename T, int THREADS, int MIN_BLOCKS, bool SHARD = false>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stream_collide_flat_kernel(const sc::Params p) {
  const unsigned cell = blockIdx.x * THREADS + threadIdx.x;
  if (cell >= (unsigned)p.N) return;
  sc::update_cell<T, false, SHARD>(p, cell, lbm::NoMark());
}

// The blocks of the 64-register bf16 instantiation the current card holds
// at once.  Asked once per card (a sharded level's slabs may lie on
// several).
int resident_8() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cached[dev & 63];
  if (!c) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_collide_flat_kernel<__nv_bfloat16, 128, 8>, 128, 0);
    c = sms * per_sm;
  }
  return c;
}

// The instantiation a level of n cells takes: (threads, min blocks per SM).
// ops/cuda_step.flat_instantiation states the same rule.
void choose(int store_bf16, long long n, int& threads, int& min_blocks) {
  threads = 128;
  min_blocks = store_bf16 && (n + 127) / 128 > 2LL * resident_8() ? 10 : 8;
}

template <bool SHARD, typename T, int THREADS, int MIN_BLOCKS>
void launch(const sc::Params& p, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((long long)p.N + THREADS - 1) / THREADS);
  stream_collide_flat_kernel<T, THREADS, MIN_BLOCKS, SHARD><<<blocks, THREADS, 0, s>>>(p);
}

// The launch of `choose`'s instantiation for p's N cells.
template <bool SHARD>
int launch_chosen(int store_bf16, const sc::Params& p, cudaStream_t s) {
  int threads, min_blocks;
  choose(store_bf16, p.N, threads, min_blocks);
  if (!store_bf16)
    launch<SHARD, float, 128, 8>(p, s);
  else if (min_blocks == 8)
    launch<SHARD, __nv_bfloat16, 128, 8>(p, s);
  else
    launch<SHARD, __nv_bfloat16, 128, 10>(p, s);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns the CUDA error of
// the launch, or cudaErrorInvalidValue for a level with an interface face or
// offsets beyond 32 bits (N + 2 Y Z >= 2^31).
extern "C" int ol_stream_collide_flat(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, int X, int Y, int Z, int lo_y, int lo_z, int bc0,
    int bc1, int bc2, int bc3, int bc4, int bc5, float u_inlet, int seed,
    const void* rec_t, const void* rec_u, int rec_last, int rec_dt,
    int rec_shift, int rec_k, double tau, double c_wale, double nu_sgs,
    double inlet_turb, int wall_model, int sponge_blend, void* stream) {
  const void* planes[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  for (int i = 0; i < 6; ++i)
    if (bcs[i] == lbm::BC_INTERFACE) return (int)cudaErrorInvalidValue;
  sc::Params p;
  if (!sc::make_params(p, store_bf16, f_in, vel_in, f_out, rho_out, vel_out,
                       obstacle, sponge, wall, planes, X, Y, Z, lo_y, lo_z, bcs,
                       u_inlet, seed, tau, c_wale, nu_sgs, inlet_turb,
                       wall_model, sponge_blend) ||
      !lbm::set_record(p.s, rec_t, rec_u, rec_last, rec_dt, rec_shift, rec_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef OL_K4_THREADS
  // a measurement build (tools/probe_k4_shapes.py): every level at one shape
  if (store_bf16)
    launch<false, __nv_bfloat16, OL_K4_THREADS, OL_K4_MIN_BLOCKS>(p, s);
  else
    launch<false, float, OL_K4_THREADS, OL_K4_MIN_BLOCKS>(p, s);
  return (int)cudaGetLastError();
#endif
  return launch_chosen<false>(store_bf16, p, s);
}

// The sharded form (the JAX package's make_pallas_step_flat with shard_nx,
// pallas_step.py:2134-2181): one x slab (27, X, Y, Z) of a level of gX
// planes from global plane x_off, the neighbour slabs' edge planes f_edges
// (27, 2, Y, Z, storage type) and v_edges (3, 2, Y, Z, float32).  The
// instantiation is `choose`'s for the slab's own cell count.
extern "C" int ol_stream_collide_flat_shard(
    int store_bf16, const void* f_in, const void* vel_in, void* f_out,
    void* rho_out, void* vel_out, const void* obstacle, const void* sponge,
    const void* wall, const void* f_edges, const void* v_edges, int x_off,
    int gX, int X, int Y, int Z, int lo_y, int lo_z, int bc0, int bc1,
    int bc2, int bc3, int bc4, int bc5, float u_inlet, int seed,
    const void* rec_t, const void* rec_u, int rec_last, int rec_dt,
    int rec_shift, int rec_k, double tau, double c_wale, double nu_sgs,
    double inlet_turb, int wall_model, int sponge_blend, void* stream) {
  const void* planes[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  const int bcs[6] = {bc0, bc1, bc2, bc3, bc4, bc5};
  for (int i = 0; i < 6; ++i)
    if (bcs[i] == lbm::BC_INTERFACE) return (int)cudaErrorInvalidValue;
  sc::Params p;
  if (!sc::make_params(p, store_bf16, f_in, vel_in, f_out, rho_out, vel_out,
                       obstacle, sponge, wall, planes, X, Y, Z, lo_y, lo_z, bcs,
                       u_inlet, seed, tau, c_wale, nu_sgs, inlet_turb,
                       wall_model, sponge_blend) ||
      !lbm::set_record(p.s, rec_t, rec_u, rec_last, rec_dt, rec_shift, rec_k) ||
      !sc::make_slab(p, f_edges, v_edges, x_off, gX))
    return (int)cudaErrorInvalidValue;
  return launch_chosen<true>(store_bf16, p, static_cast<cudaStream_t>(stream));
}

// The instantiation ol_stream_collide_flat launches on an (X, Y, Z) level,
// and the blocks of the 64-register bf16 instantiation the card holds at
// once.
extern "C" int ol_stream_collide_flat_choice(int store_bf16, int X, int Y, int Z,
                                             int* threads, int* min_blocks,
                                             int* resident) {
  choose(store_bf16, (long long)X * Y * Z, *threads, *min_blocks);
  *resident = resident_8();
  return (int)cudaGetLastError();
}
