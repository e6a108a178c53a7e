// K2: Bouzidi interpolated bounce-back on the finest level, over the plan's
// list of linked slots, in one cooperative launch.
//
// Replaces the Pallas kernel make_bouzidi_pallas
// (open_ludwig_tpu/ops/pallas_step.py:62, pallas_call at :133).
//
// The signed single-array encoding of build_bouzidi_dense_plan, listed per
// link by dense_step.bouzidi_links: link i writes slot j at `cell`, with
// k = opp(j) = 26 - j, a = |S_k(cell)| and
//
//   other = code & SELF ? f*_j(cell) : f*_k(src)   (src = cell - c_k, wrapped
//                                                   inside the box)
//   f_j(cell) = a f*_k(cell) + (1 - a) other
//
// in the operand order of the box sweep the plain version performs
// (dense_step.apply_bouzidi_dense), so the same contraction.  The launch,
// its two phases, its grid barrier and what bounds it: bouzidi_links.cuh.
// S stays float32 on both storage types; the correction is form-invariant
// under the g = f - w shift (the weights sum to 1 and w[opp k] = w[k]).

#include "bouzidi_links.cuh"

namespace {

constexpr unsigned SELF = 0x80;

// HALO = true is the form for one x slab of a sharded level: a link whose
// `other` lies in another slab has src = -1 - h and reads entry h of
// `halo`, that value gathered from its slab before any slab's launch
// (parallel/patch_shard.py); every other read is of the slab's own f.
template <bool HALO = false>
struct SignedLink {
  const int* cell;
  const uint8_t* code;
  const int* src;
  const float* a;
  long long N;  // cells of the level
  const void* halo;

  template <typename T>
  __device__ __forceinline__ float value(const T* f, int i) const {
    const long long c = cell[i];
    const unsigned cd = code[i];
    const int j = cd & 31u, k = 26 - j;
    const float av = a[i];
    const int s = src[i];
    const float other =
        HALO && s < 0
            ? bzlinks::ld(static_cast<const T*>(halo), (long long)(-1 - s))
            : bzlinks::ld(f, (long long)((cd & SELF) ? j : k) * N + s);
    const float b = 1.0f - av;
    return av * bzlinks::ld(f, (long long)k * N + c) + b * other;
  }
  __device__ __forceinline__ long long dst(int i) const {
    return (long long)(code[i] & 31u) * N + cell[i];
  }
};

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  Launches on
// `stream`, never synchronises, allocates nothing; returns the launch's
// CUDA error (0 on success).
extern "C" int ol_bouzidi(int store_bf16, void* f, const void* cell,
                          const void* code, const void* src, const void* a,
                          void* scratch, int n, int X, int Y, int Z,
                          void* stream) {
  const SignedLink<> link{static_cast<const int*>(cell),
                          static_cast<const uint8_t*>(code),
                          static_cast<const int*>(src), static_cast<const float*>(a),
                          (long long)X * Y * Z, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? bzlinks::launch<__nv_bfloat16>(link, f, scratch, n, s)
                    : bzlinks::launch<float>(link, f, scratch, n, s);
}

// The sharded form: the links of one x slab (X, Y, Z) of a level, cells and
// sources slab-local, sources in another slab read from `halo` (storage
// type, one value per such link, gathered before any slab's launch).  Every
// link of every slab is read before any is written only if no slab's launch
// starts before all halos are gathered: the caller's order.
extern "C" int ol_bouzidi_shard(int store_bf16, void* f, const void* cell,
                                const void* code, const void* src, const void* a,
                                void* scratch, const void* halo, int n, int X,
                                int Y, int Z, void* stream) {
  const SignedLink<true> link{static_cast<const int*>(cell),
                              static_cast<const uint8_t*>(code),
                              static_cast<const int*>(src),
                              static_cast<const float*>(a), (long long)X * Y * Z,
                              halo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return store_bf16 ? bzlinks::launch<__nv_bfloat16>(link, f, scratch, n, s)
                    : bzlinks::launch<float>(link, f, scratch, n, s);
}
