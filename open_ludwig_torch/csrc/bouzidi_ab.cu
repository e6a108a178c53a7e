// K6: the Bouzidi correction with the retired two-array (A, B) encoding,
// over the plan's list of linked slots, in one cooperative launch.
//
// Replaces the Pallas kernel built in tools/probe_bz_encoding.py:main
// (:76-136, pallas_call at :117), which the probe times against the
// production signed single-array kernel (K2 here).  A = |S| and
// B = sign(S)(1 - |S|) (B = 0 where S = 1) come in the storage dtype, as the
// probe passes them: float32 with float32 f, bf16 with bf16 g = f - w.  The
// list (dense_step.bouzidi_ab_links) has one entry per linked slot
// (A_k(cell) > 0), sorted by slot, then by cell: link i writes slot j at
// `cell`, with k = opp(j) = 26 - j, a = A_k(cell), b = B_k(cell) and
//
//   other = b < 0 ? f*_j(cell) : f*_k(far)    (far = cell - c_k, wrapped
//                                              inside the box)
//   f_j(cell) = a f*_k(cell) + |b| other
//
// in the operand order of the box sweep the plain version performs
// (dense_step.apply_bouzidi_ab_plain), so the same contraction.  The sign
// of B chooses `other`, as the encoding says, so each link carries both
// coefficients and the far cell.  In bf16, a + |b| is no longer exactly 1,
// so the g-shift invariance of K2 holds only to the coefficients' rounding.
// Against K2 a link carries one more coefficient in the storage type in
// place of K2's float32 one and its slot code: 13 B in bf16 as K2's, 17 B
// in float32.  The launch, its two phases, its grid barrier and what
// bounds it: bouzidi_links.cuh, which K2 shares, so that the probe's ratio
// measures the encodings alone.

#include "bouzidi_links.cuh"

namespace {

template <typename T>
struct TwoArrayLink {
  const int* cell;
  const uint8_t* j;
  const int* far;
  const T* A;
  const T* B;
  long long N;  // cells of the level

  __device__ __forceinline__ float value(const T* f, int i) const {
    const long long c = cell[i];
    const int jj = j[i], k = 26 - jj;
    const float a = bzlinks::ld(A, i);
    const float bv = bzlinks::ld(B, i);
    const float other = bv < 0.0f ? bzlinks::ld(f, (long long)jj * N + c)
                                  : bzlinks::ld(f, (long long)k * N + far[i]);
    const float b = fabsf(bv);
    return a * bzlinks::ld(f, (long long)k * N + c) + b * other;
  }
  __device__ __forceinline__ long long dst(int i) const {
    return (long long)j[i] * N + cell[i];
  }
};

template <typename T>
int launch(void* f, const void* cell, const void* j, const void* far,
           const void* A, const void* B, void* scratch, int n, long long N,
           cudaStream_t stream) {
  const TwoArrayLink<T> link{static_cast<const int*>(cell),
                             static_cast<const uint8_t*>(j),
                             static_cast<const int*>(far),
                             static_cast<const T*>(A), static_cast<const T*>(B), N};
  return bzlinks::launch<T>(link, f, scratch, n, stream);
}

}  // namespace

// C entry point (bound with ctypes in ops/cuda_step.py).  f, A and B share
// the storage dtype: bf16 when store_bf16, else float32.  Launches on
// `stream`, never synchronises, allocates nothing; returns the launch's
// CUDA error (0 on success).
extern "C" int ol_bouzidi_ab_links(int store_bf16, void* f, const void* cell,
                                   const void* j, const void* far, const void* A,
                                   const void* B, void* scratch, int n, int X,
                                   int Y, int Z, void* stream) {
  const long long N = (long long)X * Y * Z;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_bf16)
    return launch<__nv_bfloat16>(f, cell, j, far, A, B, scratch, n, N, s);
  return launch<float>(f, cell, j, far, A, B, scratch, n, N, s);
}
