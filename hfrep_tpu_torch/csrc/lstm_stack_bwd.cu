// Fused two-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm_stack.py::_stack_bwd_kernel,
// launched through _stack_bwd_call: the backward of stack_fwd_res (with
// direct cotangents dhs1, dcs1, dcs2 on its residual streams at second
// order) and the primal of stack_bwd_seq (with the per-step carries the
// adjoint needs).  Walks t = W-1 .. 0, carries starting at zero, step 0's
// previous states zero.  Per step, recomputing both layers' gates from
// the saved states (z1 from h1_{t-1}; z2 = b2 + h1_t . k2 + h2_{t-1} .
// rec2), layer 2 first:
//
//     dhT2 = dhs2_t + dh2;  dcT2 = dc2 [+ dcs2_t] + dhT2 o2 act'(act(c2_t))
//     dz2  = [dcT2 g2 i2', dcT2 c2_{t-1} f2', dcT2 i2 act'(g2), dhT2 act(c2_t) o2']
//     dh1_in = dz2 . k2^T [+ dhs1_t]
//     dhT1 = dh1_in + dh1;  dcT1 = dc1 [+ dcs1_t] + dhT1 o1 act'(act(c1_t))
//     dz1  = (the same for layer 1)                     -> dxz1_t
//     dh1 = dz1 . rec1^T;  dc1 = dcT1 f1;  dh2 = dz2 . rec2^T;  dc2 = dcT2 f2
//
// [dhT1, dcT1, dhT2, dcT2 per step with the carries], then drec1 =
// sum h1_{t-1}^T dz1, dk2 = sum h1_t^T dz2, db2 = sum dz2, drec2 = sum
// h2_{t-1}^T dz2 over the W*B rows.  Operands are float32 or bf16; every
// vector dotted with one of them is rounded to its dtype first (h1_{t-1},
// h1_t, h2_{t-1}, dz1, dz2), and the sums use the float32 values, as in
// the TPU kernel.
//
// What bounds it.  At the critic's shape in the epoch (W=48, B=64, H=100,
// float32) it must move 21.5 MB (xz1, dxz1 and the dz2 workspace 4.92 MB
// each; hs1, cs1, hs2, cs2 and dhs2 1.23 MB each; three matrices and four
// gradients 1.12 MB) — >= 6.4 us at 3.35 TB/s — and do 2.2 GFLOP (nine
// products of 2*W*B*H*4H: three recomputes, three dots with a transposed
// matrix, three sums) — >= 33 us at 67 TFLOP/s float32.  Neither sets the
// pace: dh1 and dh2 of step t feed step t-1, so the sweep is W dependent
// steps, each four dot chains and three block barriers.
//
// What the design does about it.  One block owns a tile of batch rows and
// walks all W steps.  rec1 sits once in dynamic shared memory with the
// one-entry row pad of lstm_common.cuh, read by columns (the recompute)
// and by rows (dz1 . rec1^T) without bank conflicts.  k2 and rec2 are read
// from global memory (L2) by columns for the recompute, and through
// transposed copies the wrapper passes (k2^T, rec2^T, (4H, H)) for the
// dz2 dots, so those walks are by columns too and coalesced.  The walks
// are bound by L2 latency, so each thread issues a chunk of rows' loads at
// once through ldg_f before their FMAs (64 in flight; 3.1x faster than
// plain loads at W=48, B=32, PERF.md).  The step's
// staged states and both dz are in shared memory; the carries live in
// registers (thread j produces and consumes unit j).  The sums are formed
// after the sweep by lstm_common.cuh's outer_sum over the W*B rows (dz2
// goes to a workspace), deterministically and without atomics.

#include "lstm_common.cuh"

namespace {

using namespace hfrep;

struct StackBwdArgs {
  const float* hs1;
  const float* cs1;
  const float* hs2;
  const float* cs2;
  const float* dhs2;
  const float* dhs1;   // the three directs: all null or all set
  const float* dcs1;
  const float* dcs2;
  float* dxz1;
  float* dz2w;
  float* dhT1;         // the four carries: all null or all set
  float* dcT1;
  float* dhT2;
  float* dcT2;
};

template <int ACT>
__device__ __forceinline__ void bwd_step(float ig, float fg, float gc, float og,
                                         float c, float cp, float dh_in, float dh,
                                         float dc, float* dz, float* dcT, float* dhT) {
  const float a_c = act_f<ACT>(c);
  const float dht = dh_in + dh;
  const float d_out = dht * a_c;
  const float dct = dc + dht * og * act_prime<ACT>(a_c);
  dz[0] = dct * gc * ig * (1.0f - ig);
  dz[1] = dct * cp * fg * (1.0f - fg);
  dz[2] = dct * ig * act_prime<ACT>(gc);
  dz[3] = d_out * og * (1.0f - og);
  *dcT = dct;
  *dhT = dht;
}

// rows of the L2-resident matrices loaded together before their FMAs
// (ldg_f): KC rows of k2 and rec2 for the recompute, MC rows of k2^T and
// rec2^T for the dz2 dots, 64 loads in flight a thread
constexpr int KC = 8;
constexpr int MC = 32;

template <typename T, int ACT>
__global__ void stack_bwd_kernel(const T* __restrict__ xz1, const T* __restrict__ rec1,
                                 const T* __restrict__ k2, const T* __restrict__ k2t,
                                 const T* __restrict__ b2, const T* __restrict__ rec2,
                                 const T* __restrict__ rec2t, StackBwdArgs a, int W,
                                 int B, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  const int ld = G + 1;
  T* rec_s = reinterpret_cast<T*>(smem_raw);                          // H x ld
  float* h1p_s = reinterpret_cast<float*>(smem_raw + rec_smem_bytes(H, sizeof(T)));
  float* h1_s = h1p_s + static_cast<size_t>(rows) * H;                // rows x H
  float* h2p_s = h1_s + static_cast<size_t>(rows) * H;                // rows x H
  float* dz2_s = h2p_s + static_cast<size_t>(rows) * H;               // rows x G
  float* dz1_s = dz2_s + static_cast<size_t>(rows) * G;               // rows x G

  const int tid = threadIdx.x;
  for (int i = tid; i < H * G; i += blockDim.x) {
    const int k = i / G;
    rec_s[static_cast<size_t>(k) * ld + (i - k * G)] = rec1[i];
  }

  const int bl = tid / H;
  const int j = tid - bl * H;
  const int b = blockIdx.x * rows + bl;
  const bool live = bl < rows && b < B;
  const size_t hstep = static_cast<size_t>(B) * H;
  float* h1p_row = h1p_s + bl * H;
  float* h1_row = h1_s + bl * H;
  float* h2p_row = h2p_s + bl * H;
  float* dz2_row = dz2_s + static_cast<size_t>(bl) * G;
  float* dz1_row = dz1_s + static_cast<size_t>(bl) * G;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = to_f(b2[g * H + j]);
  const bool direct = a.dhs1 != nullptr;
  float dh1 = 0.f, dc1 = 0.f, dh2 = 0.f, dc2 = 0.f;

  for (int t = W - 1; t >= 0; --t) {
    const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
    const size_t og4 = (static_cast<size_t>(t) * B + b) * G + j;
    if (live) {
      h1p_row[j] = t > 0 ? round_to<T>(a.hs1[o - hstep]) : 0.f;
      h1_row[j] = round_to<T>(a.hs1[o]);
      h2p_row[j] = t > 0 ? round_to<T>(a.hs2[o - hstep]) : 0.f;
    }
    __syncthreads();
    float i1 = 0.f, f1 = 0.f, g1 = 0.f, o1 = 0.f;
    if (live) {
      float z1[4] = {0.f, 0.f, 0.f, 0.f};   // h1_{t-1} . rec1
      float d[4] = {0.f, 0.f, 0.f, 0.f};    // h1_t . k2
      float e[4] = {0.f, 0.f, 0.f, 0.f};    // h2_{t-1} . rec2
      const T* col = rec_s + j;
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
          const int k = k0 + u;
          if (k < H) {
            const float hp = h1p_row[k], h1 = h1_row[k], h2 = h2p_row[k];
            const T* r = col + static_cast<size_t>(k) * ld;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              z1[g] = fmaf(hp, to_f(r[g * H]), z1[g]);
              d[g] = fmaf(h1, kv[u][g], d[g]);
              e[g] = fmaf(h2, rv[u][g], e[g]);
            }
          }
        }
      }
      const T* xr = xz1 + og4;
      i1 = sigmoid_f(to_f(xr[0]) + z1[0]);
      f1 = sigmoid_f(to_f(xr[H]) + z1[1]);
      g1 = act_f<ACT>(to_f(xr[2 * H]) + z1[2]);
      o1 = sigmoid_f(to_f(xr[3 * H]) + z1[3]);
      const float i2 = sigmoid_f(bias[0] + d[0] + e[0]);
      const float f2 = sigmoid_f(bias[1] + d[1] + e[1]);
      const float g2 = act_f<ACT>(bias[2] + d[2] + e[2]);
      const float o2 = sigmoid_f(bias[3] + d[3] + e[3]);

      float dz[4], dcT, dhT;
      const float dc_in = direct ? dc2 + a.dcs2[o] : dc2;
      bwd_step<ACT>(i2, f2, g2, o2, a.cs2[o], t > 0 ? a.cs2[o - hstep] : 0.f, a.dhs2[o],
                    dh2, dc_in, dz, &dcT, &dhT);
      float* dw = a.dz2w + og4;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dw[g * H] = dz[g];
        dz2_row[g * H + j] = round_to<T>(dz[g]);
      }
      if (a.dhT2 != nullptr) {
        a.dhT2[o] = dhT;
        a.dcT2[o] = dcT;
      }
      dc2 = dcT * f2;
    }
    __syncthreads();
    if (live) {          // dh1_in = dz2 . k2^T and the dh2 carry dz2 . rec2^T, unit j
      float dh1_in = 0.f, acc2 = 0.f;
      const T* kt = k2t + j;
      const T* rt = rec2t + j;
      for (int m0 = 0; m0 < G; m0 += MC) {   // MC rows of k2^T and rec2^T in flight
        float kv[MC], rv[MC];
#pragma unroll
        for (int u = 0; u < MC; ++u) {
          const size_t off = static_cast<size_t>(min(m0 + u, G - 1)) * H;
          kv[u] = ldg_f(kt + off);
          rv[u] = ldg_f(rt + off);
        }
#pragma unroll
        for (int u = 0; u < MC; ++u) {
          if (m0 + u < G) {
            const float v = dz2_row[m0 + u];
            dh1_in = fmaf(v, kv[u], dh1_in);
            acc2 = fmaf(v, rv[u], acc2);
          }
        }
      }
      dh2 = acc2;
      if (direct) dh1_in += a.dhs1[o];
      float dz[4], dcT, dhT;
      const float dc_in = direct ? dc1 + a.dcs1[o] : dc1;
      bwd_step<ACT>(i1, f1, g1, o1, a.cs1[o], t > 0 ? a.cs1[o - hstep] : 0.f, dh1_in, dh1,
                    dc_in, dz, &dcT, &dhT);
      float* dr = a.dxz1 + og4;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dr[g * H] = dz[g];
        dz1_row[g * H + j] = round_to<T>(dz[g]);
      }
      if (a.dhT1 != nullptr) {
        a.dhT1[o] = dhT;
        a.dcT1[o] = dcT;
      }
      dc1 = dcT * f1;
    }
    __syncthreads();
    if (live) {          // the dh1 carry: dz1 . rec1^T, row j of rec1
      const T* rr = rec_s + static_cast<size_t>(j) * ld;
      float acc = 0.f;
#pragma unroll 4
      for (int m = 0; m < G; ++m) acc = fmaf(dz1_row[m], to_f(rr[m]), acc);
      dh1 = acc;
    }
  }
}

template <typename T, int ACT>
cudaError_t launch_sweep(const void* xz1, const void* rec1, const void* k2,
                         const void* k2t, const void* b2, const void* rec2,
                         const void* rec2t, const StackBwdArgs& a, int W, int B, int H,
                         int rows, cudaStream_t stream) {
  const size_t smem = rec_smem_bytes(H, sizeof(T))
                      + static_cast<size_t>(rows) * 11 * H * sizeof(float);
  const int threads = ((rows * H + 31) / 32) * 32;
  const int blocks = (B + rows - 1) / rows;
  cudaError_t e = cudaFuncSetAttribute(stack_bwd_kernel<T, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  stack_bwd_kernel<T, ACT><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(xz1), static_cast<const T*>(rec1), static_cast<const T*>(k2),
      static_cast<const T*>(k2t), static_cast<const T*>(b2), static_cast<const T*>(rec2),
      static_cast<const T*>(rec2t), a, W, B, H, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(int act, const void* xz1, const void* rec1, const void* k2,
                       const void* k2t, const void* b2, const void* rec2,
                       const void* rec2t, const StackBwdArgs& a, int W, int B, int H,
                       int rows, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR:
      return launch_sweep<T, ACT_LINEAR>(xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H,
                                         rows, s);
    case ACT_SIGMOID:
      return launch_sweep<T, ACT_SIGMOID>(xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H,
                                          rows, s);
    case ACT_TANH:
      return launch_sweep<T, ACT_TANH>(xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H,
                                       rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The sweep, then drec1, dk2, db2 and drec2 over the W*B rows, all on
// `stream`.  dhs1/dcs1/dcs2 null: no direct cotangents; dhT1..dcT2 null:
// no carries.  `dz2w` is a (W, B, 4H) float32 workspace; `part` holds
// splits x H x 4H floats when splits > 1.  Returns the first CUDA error
// of a launch (0 = ok).
int hfrep_stack_bwd(const void* xz1, const void* rec1, const void* k2, const void* k2t,
                    const void* b2, const void* rec2, const void* rec2t, const void* hs1,
                    const void* cs1, const void* hs2, const void* cs2, const void* dhs2,
                    const void* dhs1, const void* dcs1, const void* dcs2, void* dxz1,
                    void* dz2w, void* dhT1, void* dcT1, void* dhT2, void* dcT2,
                    void* drec1, void* dk2, void* db2, void* drec2, void* part, int W,
                    int B, int H, int act, int bf16, int rows, int splits,
                    int rows_per_split, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StackBwdArgs a{
      static_cast<const float*>(hs1),  static_cast<const float*>(cs1),
      static_cast<const float*>(hs2),  static_cast<const float*>(cs2),
      static_cast<const float*>(dhs2), static_cast<const float*>(dhs1),
      static_cast<const float*>(dcs1), static_cast<const float*>(dcs2),
      static_cast<float*>(dxz1),       static_cast<float*>(dz2w),
      static_cast<float*>(dhT1),       static_cast<float*>(dcT1),
      static_cast<float*>(dhT2),       static_cast<float*>(dcT2)};
  e = bf16 ? launch_act<__nv_bfloat16>(act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B,
                                      H, rows, s)
           : launch_act<float>(act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H, rows,
                               s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = W * B, G = 4 * H;
  float* pt = static_cast<float*>(part);
  e = outer_sum<1>(a.hs1, a.dxz1, nullptr, nullptr, static_cast<float*>(drec1), pt, R, B,
                   H, G, splits, rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<1>(a.hs1, a.dz2w, nullptr, nullptr, static_cast<float*>(dk2), pt, R, 0,
                     H, G, splits, rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<1>(nullptr, a.dz2w, nullptr, nullptr, static_cast<float*>(db2), pt, R,
                     0, 1, G, splits, rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<1>(a.hs2, a.dz2w, nullptr, nullptr, static_cast<float*>(drec2), pt, R,
                     B, H, G, splits, rows_per_split, s);
  return static_cast<int>(e);
}

}  // extern "C"
