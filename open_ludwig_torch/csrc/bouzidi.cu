// K2: Bouzidi interpolated bounce-back on the finest level's boundary box.
//
// Replaces the Pallas kernel make_bouzidi_pallas
// (open_ludwig_tpu/ops/pallas_step.py:62, pallas_call at :133).
//
// The signed single-array encoding of build_bouzidi_dense_plan: for the
// link k writing slot j, S = S_k(cell), a = |S|,
//
//   other = S < 0 ? f*_j(cell) : f*_k(cell + c_opp(k))
//   f_j(cell) = a f*_k(cell) + (1 - a) other        (skipped where S == 0)
//
// S stays float32 on both storage types; the correction is form-invariant
// under the g = f - w shift since the weights sum to 1 and w[opp k] = w[k].
// The sweep, its snapshot and what bounds it: csrc/bouzidi_box.cuh.

#include "bouzidi_box.cuh"

namespace {

struct SignedLink {
  const float* S;
  __device__ __forceinline__ bool operator()(long long idx, float& a, float& b,
                                             bool& self) const {
    const float s = S[idx];
    if (s == 0.0f) return false;
    a = fabsf(s);
    b = 1.0f - a;
    self = s < 0.0f;
    return true;
  }
};

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).
extern "C" int ol_bouzidi(int store_bf16, const void* snap, const void* S,
                          void* f, int bx, int by, int bz, int lx, int ly,
                          int lz, int X, int Y, int Z, void* stream) {
  const SignedLink link{static_cast<const float*>(S)};
  if (store_bf16)
    return bzbox::launch_box<__nv_bfloat16>(snap, link, f, bx, by, bz, lx, ly,
                                            lz, X, Y, Z, stream);
  return bzbox::launch_box<float>(snap, link, f, bx, by, bz, lx, ly, lz, X, Y,
                                  Z, stream);
}
