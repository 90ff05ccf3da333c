// Fused two-layer LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm_stack.py::_stack_fwd_kernel,
// launched through _stack_fwd_impl in its primal mode (stack_seq: layer
// 2's hidden states only) and in its with_res mode (stack_fwd_res: both
// layers' hidden and cell states, the residuals of the backward).  The
// MTSS critics' plain stack LSTM(H) -> LSTM(H), one activation for both
// layers; for t = 0 .. W-1 with every state starting at zero:
//
//     z1_t = xz1_t + h1_{t-1} . rec1
//     c1_t = f1 * c1_{t-1} + i1 * act(g1);   h1_t = o1 * act(c1_t)
//     z2_t = b2 + h1_t . k2 + h2_{t-1} . rec2
//     c2_t = f2 * c2_{t-1} + i2 * act(g2);   h2_t = o2 * act(c2_t)
//
// -> hs2[t] [and hs1, cs1, cs2 with WITH_RES, a template flag].  xz1,
// rec1, k2, b2 and rec2 are float32 or bf16; h1 and h2 are rounded to the
// operand dtype before their dots, b2 is added in float32, and state and
// gate math are float32, as in the TPU kernel.
//
// What bounds it.  At the critic's shape in the epoch (W=48, B=64, H=100,
// float32, with_res) it must move 9.8 MB (xz1 4.92 MB, hs1, cs1, hs2 and
// cs2 1.23 MB each, three matrices 0.48 MB) — >= 2.9 us at 3.35 TB/s —
// and do 737 MFLOP (three products of 2*W*B*H*4H) — >= 11 us at 67
// TFLOP/s float32.  Neither sets the pace: each step needs the one
// before, twice (layer 1's h feeds layer 2 in the same step), so the time
// is W times the latency of one step's two dot chains.
//
// What the design does about it.  One block owns a tile of batch rows and
// walks all W steps, as the TPU's sequential grid did.  rec1, the matrix
// on layer 1's serial chain, sits once in dynamic shared memory (160,000
// B float32 at H=100); k2 and rec2 would not fit beside it (3 x 160,000
// B against 232,448 B) and are read from global memory, where they stay
// in the 50 MB L2, by columns: thread (b, j) reads column j of each gate
// block, so neighbouring threads read neighbouring words.  That walk is
// bound by L2 latency, not bandwidth (a block has four warps), so each
// thread loads KC rows of both matrices at once through ldg_f before
// their FMAs (lstm_common.cuh): 64 loads in flight, 4.7x faster than
// plain loads at W=48, B=32 (PERF.md).  h1 and h2 are double-buffered in
// shared memory, so one barrier a step suffices (the one between the
// layers: layer 2 needs all of h1_t); c1 and c2 live in registers.

#include "lstm_common.cuh"

namespace {

using namespace hfrep;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows of k2 and rec2 loaded together before their FMAs (ldg_f): each
// thread keeps 8 * KC loads in flight
constexpr int KC = 8;

template <typename T, int ACT, bool WITH_RES>
__global__ void stack_fwd_kernel(const T* __restrict__ xz1,
                                 const T* __restrict__ rec1,
                                 const T* __restrict__ k2,
                                 const T* __restrict__ b2,
                                 const T* __restrict__ rec2,
                                 float* __restrict__ hs1,     // WITH_RES only
                                 float* __restrict__ cs1,     // WITH_RES only
                                 float* __restrict__ hs2,
                                 float* __restrict__ cs2,     // WITH_RES only
                                 int W, int B, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  T* rec_s = reinterpret_cast<T*>(smem_raw);          // (H, 4H)
  T* h1_s = rec_s + static_cast<size_t>(H) * G;       // 2 x (rows, H)
  T* h2_s = h1_s + 2 * rows * H;                      // 2 x (rows, H)

  const int tid = threadIdx.x;
  for (int i = tid; i < H * G; i += blockDim.x) rec_s[i] = rec1[i];
  for (int i = tid; i < 4 * rows * H; i += blockDim.x) h1_s[i] = from_f<T>(0.0f);

  const int bl = tid / H;                 // row inside the tile
  const int j = tid - bl * H;             // hidden unit
  const int b = blockIdx.x * rows + bl;   // batch row
  const bool live = bl < rows && b < B;

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = to_f(b2[g * H + j]);
  const size_t xstep = static_cast<size_t>(B) * G;
  const T* xrow = xz1 + static_cast<size_t>(live ? b : 0) * G + j;
  float c1 = 0.f, c2 = 0.f;
  __syncthreads();

  for (int t = 0; t < W; ++t) {
    const int cur = (t & 1) * rows * H + bl * H;          // h_{t-1}
    const int nxt = ((t + 1) & 1) * rows * H + bl * H;    // h_t
    const size_t out = (static_cast<size_t>(t) * B + b) * H + j;
    if (live) {                            // layer 1
      const T* xr = xrow + t * xstep;
      float z[4] = {to_f(xr[0]), to_f(xr[H]), to_f(xr[2 * H]), to_f(xr[3 * H])};
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const T* col = rec_s + j;
      const T* hp = h1_s + cur;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = to_f(hp[k]);
        const T* r = col + static_cast<size_t>(k) * G;
#pragma unroll
        for (int g = 0; g < 4; ++g) d[g] = fmaf(hk, to_f(r[g * H]), d[g]);
      }
      const float ig = sigmoid_f(z[0] + d[0]);
      const float fg = sigmoid_f(z[1] + d[1]);
      const float gc = act_f<ACT>(z[2] + d[2]);
      const float og = sigmoid_f(z[3] + d[3]);
      c1 = fg * c1 + ig * gc;
      const float h = og * act_f<ACT>(c1);
      h1_s[nxt + j] = from_f<T>(h);
      if (WITH_RES) {
        hs1[out] = h;
        cs1[out] = c1;
      }
    }
    __syncthreads();
    if (live) {                            // layer 2, k2 and rec2 from L2
      float d[4] = {0.f, 0.f, 0.f, 0.f};   // h1_t . k2
      float e[4] = {0.f, 0.f, 0.f, 0.f};   // h2_{t-1} . rec2
      const T* h1 = h1_s + nxt;
      const T* h2p = h2_s + cur;
      const T* kcol = k2 + j;
      const T* rcol = rec2 + j;
      for (int k0 = 0; k0 < H; k0 += KC) {   // KC rows of k2 and rec2 in flight
        float kv[KC][4], rv[KC][4];
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          const size_t off = static_cast<size_t>(min(k0 + u, H - 1)) * G;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            kv[u][g] = ldg_f(kcol + off + g * H);
            rv[u][g] = ldg_f(rcol + off + g * H);
          }
        }
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          if (k0 + u < H) {
            const float a = to_f(h1[k0 + u]);
            const float p = to_f(h2p[k0 + u]);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              d[g] = fmaf(a, kv[u][g], d[g]);
              e[g] = fmaf(p, rv[u][g], e[g]);
            }
          }
        }
      }
      const float ig = sigmoid_f(bias[0] + d[0] + e[0]);
      const float fg = sigmoid_f(bias[1] + d[1] + e[1]);
      const float gc = act_f<ACT>(bias[2] + d[2] + e[2]);
      const float og = sigmoid_f(bias[3] + d[3] + e[3]);
      c2 = fg * c2 + ig * gc;
      const float h = og * act_f<ACT>(c2);
      h2_s[nxt + j] = from_f<T>(h);
      hs2[out] = h;
      if (WITH_RES) cs2[out] = c2;
    }
    // no second barrier: the next step's layer 1 writes the other h1
    // buffer, and its layer 2 reads h2_t only after the next barrier
  }
}

template <typename T, int ACT, bool WITH_RES>
cudaError_t launch(const void* xz1, const void* rec1, const void* k2, const void* b2,
                   const void* rec2, float* hs1, float* cs1, float* hs2, float* cs2,
                   int W, int B, int H, int rows, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(H) * 4 * H + 4 * static_cast<size_t>(rows) * H)
                      * sizeof(T);
  const int threads = ((rows * H + 31) / 32) * 32;
  const int blocks = (B + rows - 1) / rows;
  cudaError_t e = cudaFuncSetAttribute(stack_fwd_kernel<T, ACT, WITH_RES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  stack_fwd_kernel<T, ACT, WITH_RES><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(xz1), static_cast<const T*>(rec1), static_cast<const T*>(k2),
      static_cast<const T*>(b2), static_cast<const T*>(rec2), hs1, cs1, hs2, cs2, W, B, H,
      rows);
  return cudaGetLastError();
}

template <typename T, bool WITH_RES>
cudaError_t launch_act(int act, const void* xz1, const void* rec1, const void* k2,
                       const void* b2, const void* rec2, float* hs1, float* cs1,
                       float* hs2, float* cs2, int W, int B, int H, int rows,
                       cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR:
      return launch<T, ACT_LINEAR, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                                             W, B, H, rows, s);
    case ACT_SIGMOID:
      return launch<T, ACT_SIGMOID, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                                              W, B, H, rows, s);
    case ACT_TANH:
      return launch<T, ACT_TANH, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                                           W, B, H, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mode(int act, const void* xz1, const void* rec1, const void* k2,
                        const void* b2, const void* rec2, float* hs1, float* cs1,
                        float* hs2, float* cs2, int W, int B, int H, int rows,
                        cudaStream_t s) {
  if (hs1 != nullptr)
    return launch_act<T, true>(act, xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, W, B, H,
                               rows, s);
  return launch_act<T, false>(act, xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, W, B, H,
                              rows, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the first CUDA error of the launch (0 = ok).
// hs1 null is the primal mode (cs1 and cs2 are then ignored); otherwise
// the with_res mode writes hs1, cs1 and cs2 too.
int hfrep_stack_fwd(const void* xz1, const void* rec1, const void* k2, const void* b2,
                    const void* rec2, void* hs1, void* cs1, void* hs2, void* cs2, int W,
                    int B, int H, int act, int bf16, int rows, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h1 = static_cast<float*>(hs1);
  float* c1 = static_cast<float*>(cs1);
  float* h2 = static_cast<float*>(hs2);
  float* c2 = static_cast<float*>(cs2);
  e = bf16 ? launch_mode<__nv_bfloat16>(act, xz1, rec1, k2, b2, rec2, h1, c1, h2, c2, W, B,
                                       H, rows, s)
           : launch_mode<float>(act, xz1, rec1, k2, b2, rec2, h1, c1, h2, c2, W, B, H,
                                rows, s);
  return static_cast<int>(e);
}

}  // extern "C"
