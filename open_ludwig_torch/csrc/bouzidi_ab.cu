// K6: the Bouzidi correction with the retired two-array (A, B) encoding.
//
// Replaces the Pallas kernel built in tools/probe_bz_encoding.py:main
// (:76-136, pallas_call at :117), which the probe times against the
// production signed single-array kernel (K2 here).  For the link k writing
// slot j, with a = A_k(cell) and b = B_k(cell):
//
//   other = b < 0 ? f*_j(cell) : f*_k(cell + c_opp(k))
//   f_j(cell) = a f*_k(cell) + |b| other             (only where a > 0)
//
// A = |S| and B = sign(S)(1 - |S|) (B = 0 where S = 1) come in the storage
// dtype, as the probe passes them: float32 with float32 f, bf16 with bf16
// g = f - w.  In bf16, a + |b| is no longer exactly 1, so the g-shift
// invariance of K2 holds only to the coefficients' rounding.  Math in
// float32, stores round to nearest even.  Against K2 it reads one more
// coefficient array per slot; the sweep, its snapshot and what bounds it:
// csrc/bouzidi_box.cuh.

#include "bouzidi_box.cuh"

namespace {

template <typename T>
struct TwoArrayLink {
  const T* A;
  const T* B;
  __device__ __forceinline__ bool operator()(long long idx, float& a, float& b,
                                             bool& self) const {
    a = bzbox::ld(A, idx);
    if (!(a > 0.0f)) return false;
    const float bv = bzbox::ld(B, idx);
    b = fabsf(bv);
    self = bv < 0.0f;
    return true;
  }
};

template <typename T>
int launch(const void* snap, const void* A, const void* B, void* f, int bx,
           int by, int bz, int lx, int ly, int lz, int X, int Y, int Z,
           void* stream) {
  const TwoArrayLink<T> link{static_cast<const T*>(A), static_cast<const T*>(B)};
  return bzbox::launch_box<T>(snap, link, f, bx, by, bz, lx, ly, lz, X, Y, Z,
                              stream);
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  snap, A, B and f
// share the storage dtype: bf16 when store_bf16, else float32.
extern "C" int ol_bouzidi_ab(int store_bf16, const void* snap, const void* A,
                             const void* B, void* f, int bx, int by, int bz,
                             int lx, int ly, int lz, int X, int Y, int Z,
                             void* stream) {
  if (store_bf16)
    return launch<__nv_bfloat16>(snap, A, B, f, bx, by, bz, lx, ly, lz, X, Y,
                                 Z, stream);
  return launch<float>(snap, A, B, f, bx, by, bz, lx, ly, lz, X, Y, Z, stream);
}
