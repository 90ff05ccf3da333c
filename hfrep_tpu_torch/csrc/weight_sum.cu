// The weight sums (weight_sum.cuh) as a C entry of their own: the card
// tests, chip_smoke.py and tools/torch_weight_sum.py call it to hold the
// sums against their plain version and time them.  The backward and
// adjoint kernels launch the same code from their own sources; nothing on
// the main path calls this entry.

#include "weight_sum.cuh"

extern "C" {

// nsum sums (1 .. 3) of npair pairs (1 or 2) over R rows, each C (M, N):
// a, b and head hold nsum * npair pointers, sum by sum (a null a is a
// column of ones, a null head zeros), out and shift nsum.  `splits` 0 is
// the rule's cluster size, else 1, 2, 4, 8 or 16.  Returns the CUDA error
// of the launch (0 = ok).
int hfrep_weight_sum(const void* const* a, const void* const* b, const void* const* head,
                     void* const* out, const int* shift, int nsum, int npair, int R, int M,
                     int N, int splits, int device, void* stream) {
  if (nsum < 1 || nsum > hfrep::ws::MAX_SUMS || npair < 1 || npair > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  hfrep::ws::Batch batch{};
  batch.n = nsum;
  for (int i = 0; i < nsum; ++i) {
    hfrep::ws::Sum& s = batch.s[i];
    for (int p = 0; p < npair; ++p) {
      s.a[p] = static_cast<const float*>(a[i * npair + p]);
      s.b[p] = static_cast<const float*>(b[i * npair + p]);
      s.head[p] = static_cast<const float*>(head[i * npair + p]);
    }
    s.out = static_cast<float*>(out[i]);
    s.shift = shift[i];
  }
  return static_cast<int>(hfrep::ws::weight_sums(batch, npair, R, M, N,
                                                 static_cast<cudaStream_t>(stream), splits));
}

// The cluster size the rule picks for such a launch on a card of `sms`
// SMs, operands aligned: the C++ twin of cuda_lstm.sum_splits.
int hfrep_weight_sum_splits(int nsum, int npair, int R, int M, int N, int sms) {
  int pieces = 0;
  const dim3 g = hfrep::ws::grid_for(nsum, npair, R, M, N,
                                     N % 4 == 0 && (M == 1 || M % 4 == 0), &pieces);
  return hfrep::ws::splits_for(static_cast<int>(g.x * g.y), pieces, sms);
}

}  // extern "C"
