// Fused two-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm_stack.py::_stack_bwd_kernel,
// launched through _stack_bwd_call: the backward of stack_fwd_res (with
// direct cotangents dhs1, dcs1, dcs2 on its residual streams at second
// order) and the primal of stack_bwd_seq (with the per-step carries the
// adjoint needs).  Walks t = W-1 .. 0, carries starting at zero, step 0's
// previous states zero.  Per step, from both layers' gates recomputed from
// the saved states (z1 = xz1 + h1_{t-1} . rec1; z2 = b2 + h1_t . k2 +
// h2_{t-1} . rec2), layer 2 first:
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
// h1_t, h2_{t-1}, dz1, dz2), b2 is added in float32, and the sums use the
// float32 values, as in the TPU kernel.
//
// What bounds it.  At the critic's shape in the epoch (W=48, B=64, H=100,
// float32) it must move 21.5 MB (xz1, dxz1 and the dz2 workspace 4.92 MB
// each; hs1, cs1, hs2, cs2 and dhs2 1.23 MB each; three matrices and four
// gradients 1.12 MB) — >= 6.4 us at 3.35 TB/s — and do 2.2 GFLOP (nine
// products of 2*W*B*H*4H: three recomputes, three dots with a transposed
// matrix, three sums) — >= 33 us at 67 TFLOP/s float32.  Neither sets the
// pace: dh1 and dh2 of step t feed step t-1, so the sweep is W dependent
// steps.  Only two of the nine products sit on that chain (dz1 . rec1^T
// and dz2 . rec2^T); the recompute reads saved states alone, and dz2 .
// k2^T feeds layer 1 but not layer 2's own chain.
//
// The cluster layout, for H <= 4*KS = 100, which every preset width takes:
// - The recompute leaves the chain: stack_gates_kernel forms both
//   layers' gates for all W*B rows at once, a tiled float32 product
//   (lstm_stack.cuh, shared with the adjoint's pre-pass; no tensor cores:
//   TF32 or bf16 products of float32 operands would break the float32
//   bars), and writes them in place of what the sweep writes later at the
//   same positions: layer 1's gates into dxz1, layer 2's into the dz2
//   workspace.
// - The sweep (stack_bwd_cluster_kernel) runs a cluster of two blocks a
//   batch row, one layer a block, each block 416 threads, a quad a hidden
//   unit k: thread (k, q) holds chunks c < KS of row k's gate-q columns of
//   its layer's recurrent matrix (entries q*H + 4c .. 4c + 3), KR1 (block
//   0) or KR2 (block 1) chunks in registers and the rest in shared memory
//   as a float4 each, so dh[k] = sum_m dz[m] rec[k, m] is 100 FMAs a
//   thread against dz broadcast from shared memory as float4s, and a quad
//   sum of two shuffles that leaves dh[k] in all four lanes.  Each lane then
//   runs unit k's gate math itself (lane q keeps dz[q]), so the carry never
//   leaves the quad and a step has one block barrier.
// - k2^T's product is split by chunks: c < KH = 13 in block 1, the rest in
//   block 0, each block's chunks dealt out in its shared memory as the rows
//   of the recurrent matrix are.  Held whole by one block, k2 made that
//   block the slow one in the stack forward (PERF.md).
// - Block 1 (layer 2) walks ahead: per step it forms dz2_t from the gates,
//   writes dz2 (float32, for the sums) [and dhT2, dcT2], and puts round(dz2)
//   into its own dz buffer and into slot t mod D of a ring in block 0's
//   shared memory; after the barrier, its chain dh2 = round(dz2) . rec2^T
//   and its part of round(dz2) . k2^T, which goes into the same slot.  The
//   stores are st.async, counting their bytes off the slot's mbarrier in
//   block 0 (lstm_common.cuh).
// - Block 0 (layer 1) waits on the slot, finishes dh1_in = round(dz2) .
//   k2^T over its chunks plus block 1's part [+ dhs1], forms dz1 and dxz1
//   [dhT1, dcT1], then its chain dh1 = round(dz1) . rec1^T.  After its
//   barrier one thread re-arms the slot's mbarrier and stores the count of
//   slots read into block 1, which polls it before refilling a slot.  So
//   block 1 runs up to D = 4 steps ahead, the two reverse chains overlap,
//   and no release or acquire at cluster scope runs in the time loop.
// - Each lane stages its gate's value and one of the step's state values a
//   step ahead (c_t, c_{t-1}, the direct dc, the dh input) with cp.async,
//   which holds no registers, and the quad trades them by shuffles.  Loop
//   offsets are 32-bit.  The direct cotangents and the carries are
//   template flags.
// - Registers: ptxas grants the 13 warps 128 registers a thread and fills
//   them with the dz loads it issues early; 15 chunks in registers in
//   float32 (15 and 16 in bf16) spill in no instantiation
//   (tools/torch_stack_fwd_sweep.py --kernel bwd --rows), which leaves
//   shared memory for only a third of a matrix's rows to be staged at a
//   time in the prologue: 225,840 B a block in float32, 155,376 in bf16.
// - Clusters loop over ceil(B / (SMs/2)) batch rows each, carries reset
//   a row; the ring's phase runs on across rows.
// A width whose recurrent matrices the register file cannot hold (100 < H,
// within stack_fits) runs the wide layout (stack_bwd_kernel), the port's
// first stack backward, unchanged: one block owns a tile of batch rows and
// walks all W steps with the recompute on the chain; rec1 sits once in
// dynamic shared memory with the one-entry row pad of lstm_common.cuh,
// read by columns (the recompute) and by rows (dz1 . rec1^T); k2 and rec2
// are read from L2 by columns for the recompute, and through transposed
// copies the wrapper passes (k2^T, rec2^T, (4H, H)) for the dz2 dots, each
// thread issuing a chunk of rows' loads at once through ldg_f.  The
// wrapper chooses the layout by a rule on (H, dtype, B, SMs)
// (cuda_lstm_stack.stack_bwd_layout) and passes it here; it never tries
// one and falls back.  In both layouts the sums are formed after the
// sweep by weight_sum.cuh over the W*B rows (dz2 goes to a workspace):
// drec1, dk2 and drec2 in one launch, db2 in another, deterministically
// and without atomics.

#include <cooperative_groups.h>

#include "lstm_stack.cuh"
#include "weight_sum.cuh"

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

// ------------------------------------------------------------ wide layout
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


// ----------------------------------------------------- cluster layout
// The gate recompute, off the chain, is lstm_stack.cuh's
// stack_gates_kernel: both layers' gates (W, B, 4H) float32 from the
// saved states, a tiled product over all W*B rows.

namespace cb {

using namespace bq;
// Of a thread's KS chunks of its layer's recurrent matrix, the first KR1
// (layer 1) or KR2 (layer 2) are held in registers, the rest in shared
// memory: ptxas grants 13 warps 128 registers a thread, and the counts that
// leave no instantiation spilling differ by operand type
// (tools/torch_stack_fwd_sweep.py --kernel bwd --rows).
constexpr int KR1_F32 = 15, KR2_F32 = 15, KR1_BF16 = 15, KR2_BF16 = 16;
template <typename T>
struct Keep {
  static constexpr int r1 = KR1_F32, r2 = KR2_F32;
};
template <>
struct Keep<__nv_bfloat16> {
  static constexpr int r1 = KR1_BF16, r2 = KR2_BF16;
};
__host__ __device__ constexpr int kr_min(size_t item) {
  return item == 4 ? (KR1_F32 < KR2_F32 ? KR1_F32 : KR2_F32)
                   : (KR1_BF16 < KR2_BF16 ? KR1_BF16 : KR2_BF16);
}
// k2^T's product is split between the blocks: chunks c < KH of each gate's
// columns in block 1, the rest in block 0
constexpr int KH = 13;
constexpr int D = 4;                // ring slots: how far layer 2 may run ahead
// a slot: round(dz2_t) laid out as a dz buffer, then block 1's part of
// dh1_in_t by unit
constexpr int SLOT = 5 * ZP;
// bytes of st.async stores a slot awaits: lane q of unit k's quad stores
// dz2[q] and lane 0 the part, for H units
__host__ __device__ constexpr unsigned slot_bytes(int H) { return 20u * H; }

// The fixed part of a block's shared memory, in floats: two dz buffers,
// each thread's two staged step inputs for two steps, the chunks of the
// recurrent matrix past the fewer of KR1, KR2 (a float4 a thread each),
// the ring and its D mbarriers (block 0), then the count of slots block 0
// has read (block 1), padded to 16 bytes.
__host__ __device__ constexpr int fixed_floats(size_t item) {
  return 8 * ZP + 4 * THREADS + 4 * (KS - kr_min(item)) * THREADS + D * SLOT + 2 * D + 4;
}

// bytes of a block's chunks of k2, dealt out: chunks x THREADS x 4 entries of T
__host__ __device__ constexpr size_t k2_bytes(size_t item) {
  return static_cast<size_t>(KS - KH > KH ? KS - KH : KH) * THREADS * 4 * item;
}

// Dynamic shared memory of either block: the fixed part, the block's
// chunks of k2, then a staging area for a PARTS-th of the rows of a
// matrix (a third: room for fewer chunks in registers in float32).
constexpr int PARTS = 3;
__host__ __device__ inline size_t stage_bytes(int H, size_t item) {
  return static_cast<size_t>((H + PARTS - 1) / PARTS) * 4 * H * item;
}
__host__ __device__ inline size_t smem_bytes(int H, size_t item) {
  return fixed_floats(item) * sizeof(float) + k2_bytes(item) + stage_bytes(H, item);
}

// The same rows of k2: thread (k, q) takes chunks c0 <= c < c1 of row k's
// gate-q columns into k2_s at entries ((c - c0) * THREADS + tid) * 4 + e.
template <typename T>
__device__ __forceinline__ void deal_k2(const T* stage, int lo, int n, int H, int q, int k,
                                        bool unit, int c0, int c1, T* k2_s) {
  const int r = k - lo, tid = threadIdx.x;
  if (!unit || r < 0 || r >= n) return;
  const T* src = stage + r * 4 * H + q * H;
  for (int c = c0; c < c1; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      k2_s[((c - c0) * THREADS + tid) * 4 + e] = 4 * c + e < H ? src[4 * c + e] : from_f<T>(0.0f);
}

// this thread's parts of dz . rec^T and of dz . k2^T over chunks c < C1,
// in one walk over the dz buffer: each float4 is read once, and no value
// of it is held for a second walk
template <int KR, int C1, int KW, typename T>
__device__ __forceinline__ float2 dot_rec_k2(const float4* dz4, const float (&w)[4][KW],
                                             const float4* rec_s, const T* k2_s, int tid) {
  float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    const float4 v = dz4[c];
    const float d[4] = {v.x, v.y, v.z, v.w};
    float wk[4];
    weights<KR>(w, rec_s, c, tid, wk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c & 1) a1[e] = fmaf(d[e], wk[e], a1[e]);
      else a0[e] = fmaf(d[e], wk[e], a0[e]);
    }
    if (c < C1) {
      float kv[4];
      load4(k2_s + (c * THREADS + tid) * 4, kv);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = fmaf(d[e], kv[e], p[e]);
    }
  }
  return make_float2(chains(a0, a1), (p[0] + p[1]) + (p[2] + p[3]));
}

// this thread's part of dz2 . k2^T over chunks C0 <= c < C1
template <int C0, int C1, typename T>
__device__ __forceinline__ float dot_k2(const float4* dz4, const T* k2_s, int tid) {
  float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    const float4 v = dz4[c];
    const float d[4] = {v.x, v.y, v.z, v.w};
    float kv[4];
    load4(k2_s + ((c - C0) * THREADS + tid) * 4, kv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c & 1) a1[e] = fmaf(d[e], kv[e], a1[e]);
      else a0[e] = fmaf(d[e], kv[e], a0[e]);
    }
  }
  return chains(a0, a1);
}

}  // namespace cb

// Launched as clusters of two blocks of cb::THREADS threads, after
// stack_gates_kernel has written the gates into dxz1 and dz2w;
// grid = 2 x the clusters, cluster c walks batch rows c*rows .. c*rows +
// rows - 1.
template <typename T, int ACT, bool DIRECT, bool CARRIES>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(cb::THREADS, 1)
stack_bwd_cluster_kernel(const T* __restrict__ rec1, const T* __restrict__ k2,
                         const T* __restrict__ rec2, StackBwdArgs a, int W, int B, int H,
                         int rows) {
  using namespace cb;
  namespace cg = cooperative_groups;
  constexpr int KR1 = Keep<T>::r1, KR2 = Keep<T>::r2;
  constexpr int KRMIN = KR1 < KR2 ? KR1 : KR2, KRMAX = KR1 < KR2 ? KR2 : KR1;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  float* dz_s = fsm;                         // round(dz_t): 2 buffers (step parity) x 4 x ZP
  float* step_s = dz_s + 8 * ZP;             // step inputs: 2 (step parity) x THREADS x 2
  float4* rec_s = reinterpret_cast<float4*>(step_s + 4 * THREADS);   // chunks c >= KR1 or KR2
  float* ring = reinterpret_cast<float*>(rec_s + (KS - KRMIN) * THREADS);   // D slots
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + D * SLOT);  // D
  unsigned* done = reinterpret_cast<unsigned*>(full + D);   // block 1: slots block 0 has read
  T* k2_s = reinterpret_cast<T*>(fsm + fixed_floats(sizeof(T)));    // this block's chunks of k2
  T* stage = k2_s + k2_bytes(sizeof(T)) / sizeof(T);        // staging area
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int q = tid & 3;                     // gate q's columns of row k; state stream q
  const int k = (tid >> 5) * 8 + ((tid & 31) >> 2);   // hidden unit: row k of the matrices
  const int base = tid & 28;                 // the quad's first lane
  const bool unit = k < H;
  const unsigned rank = cluster.block_rank();          // 0: layer 1, 1: layer 2
  const int cid = static_cast<int>(blockIdx.x / 2);

  // dz buffers and the ring start at zero; entries past H stay zero,
  // multiplied by zero weights
  for (int i = tid; i < 8 * ZP; i += THREADS) dz_s[i] = 0.0f;
  for (int i = tid; i < D * SLOT; i += THREADS) ring[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < D; ++s) mbar_init(smem_u32(full + s), 1);
    if (rank == 0)
      for (int s = 0; s < D; ++s) mbar_expect(smem_u32(full + s), slot_bytes(H));   // uses 0 .. D-1
    *reinterpret_cast<volatile unsigned*>(done) = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block's chunks of k2, then its layer's recurrent matrix, a
  // PARTS-th of the rows at a time: chunks c < KR1 (KR2) into registers,
  // the rest into shared memory
  float w[4][KRMAX];
#pragma unroll
  for (int c = 0; c < KRMAX; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e][c] = 0.0f;
  for (int c = 0; c < KS - KRMIN; ++c) rec_s[c * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid * 4; i < static_cast<int>(k2_bytes(sizeof(T)) / sizeof(T)); i += THREADS * 4)
#pragma unroll
    for (int e = 0; e < 4; ++e) k2_s[i + e] = from_f<T>(0.0f);
  const int part = (H + PARTS - 1) / PARTS;
  for (int lo = 0; lo < H; lo += part) {
    const int n = min(part, H - lo);
    copy_issue<THREADS>(k2 + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    if (rank == 0) deal_k2(stage, lo, n, H, q, k, unit, KH, KS, k2_s);
    else deal_k2(stage, lo, n, H, q, k, unit, 0, KH, k2_s);
    __syncthreads();                         // the staged rows are read
  }
  const T* rec = rank == 0 ? rec1 : rec2;
  for (int lo = 0; lo < H; lo += part) {
    const int n = min(part, H - lo);
    copy_issue<THREADS>(rec + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    if (rank == 0) deal_rec<T, KR1>(stage, lo, n, H, q, k, unit, w, rec_s);
    else deal_rec<T, KR2>(stage, lo, n, H, q, k, unit, w, rec_s);
    __syncthreads();
  }
  cluster.sync();                            // both blocks set up before any remote access

  // 32-bit element offsets (the launch checks that W*B*4H fits)
  const int xstep = B * G;
  const int ostep = B * H;
  const int back = q == 1 ? ostep : 0;       // lane 1 reads c_{t-1}
  unsigned n = 0;                            // steps so far: slot n % D, its use n / D
  // each block runs its own loop, so that neither holds the other's values
  if (rank == 1) {
    // Layer 2, ahead: dz2_t into slot n of layer 1's ring, then the chain
    // dh2 = round(dz2) . rec2^T and this block's part of round(dz2) . k2^T.
    const unsigned ring_peer = peer_u32(smem_u32(ring), 0);
    const float* sp = q < 2 ? a.cs2 : q == 2 ? (DIRECT ? a.dcs2 : nullptr) : a.dhs2;
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;                     // the same for the whole cluster
      __syncthreads();
      float dh = 0.0f, dc = 0.0f;
      int o = ((W - 1) * B + b) * H + (unit ? k : 0);        // (W, B, H) offset, step t
      int og = ((W - 1) * B + b) * G + (unit ? q * H + k : 0);   // gate q's, (W, B, 4H)
      stage_step(step_s + ((n & 1u) * THREADS + tid) * 2, a.dz2w, og, sp, o, back, W - 1, unit);
      for (int t = W - 1; t >= 0; --t, ++n) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        const float* st = step_s + ((n & 1u) * THREADS + tid) * 2;
        const float gq = st[0], sq = st[1];
        if (t > 0)
          stage_step(step_s + (((n + 1) & 1u) * THREADS + tid) * 2, a.dz2w, og - xstep, sp,
                     o - ostep, back, t - 1, unit);
        const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
        const float gc = from_lane(gq, base, 2), og2 = from_lane(gq, base, 3);
        const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
        const float dcs = from_lane(sq, base, 2), dhs = from_lane(sq, base, 3);
        float dz[4], dcT, dhT;
        bwd_step<ACT>(ig, fg, gc, og2, c, cp, dhs, dh, DIRECT ? dc + dcs : dc, dz, &dcT, &dhT);
        dc = dcT * fg;
        const float dzq = q == 0 ? dz[0] : q == 1 ? dz[1] : q == 2 ? dz[2] : dz[3];
        const unsigned slot = n % D;
        const int buf = static_cast<int>(n & 1u) * 4 * ZP;
        if (unit) {
          a.dz2w[og] = dzq;
          if (CARRIES) {
            if (q == 0) a.dhT2[o] = dhT;
            if (q == 1) a.dcT2[o] = dcT;
          }
          const float rd = round_to<T>(dzq);
          dz_s[buf + q * ZP + k] = rd;
          if (n >= D)                        // slot n is free once layer 1 has read use n - D
            while (ld_flag(smem_u32(done)) < n - D + 1) {
            }
          st_async_peer(ring_peer + 4 * (slot * SLOT + q * ZP + k), rd,
                        peer_u32(smem_u32(full + slot), 0));
        }
        __syncthreads();
        const float2 d2 = dot_rec_k2<KR2, KH>(reinterpret_cast<const float4*>(dz_s + buf + q * ZP),
                                              w, rec_s, k2_s, tid);
        dh = quad_sum(d2.x);
        const float part = quad_sum(d2.y);
        if (unit && q == 0)
          st_async_peer(ring_peer + 4 * (slot * SLOT + 4 * ZP + k), part,
                        peer_u32(smem_u32(full + slot), 0));
        o -= ostep;
        og -= xstep;
      }
    }
  } else {
    // Layer 1: dh1_in_t from slot n (this block's chunks of k2 and layer
    // 2's part), dz1_t, then the chain dh1 = round(dz1) . rec1^T.
    const float* sp = q < 2 ? a.cs1 : !DIRECT ? nullptr : q == 2 ? a.dcs1 : a.dhs1;
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;
      __syncthreads();
      float dh = 0.0f, dc = 0.0f;
      int o = ((W - 1) * B + b) * H + (unit ? k : 0);
      int og = ((W - 1) * B + b) * G + (unit ? q * H + k : 0);
      stage_step(step_s + ((n & 1u) * THREADS + tid) * 2, a.dxz1, og, sp, o, back, W - 1, unit);
      for (int t = W - 1; t >= 0; --t, ++n) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        const float* st = step_s + ((n & 1u) * THREADS + tid) * 2;
        const float gq = st[0], sq = st[1];
        if (t > 0)
          stage_step(step_s + (((n + 1) & 1u) * THREADS + tid) * 2, a.dxz1, og - xstep, sp,
                     o - ostep, back, t - 1, unit);
        const unsigned slot = n % D;
        mbar_wait(smem_u32(full + slot), (n / D) & 1u);
        const float* sl = ring + slot * SLOT;
        const float part = quad_sum(dot_k2<KH, KS>(reinterpret_cast<const float4*>(sl + q * ZP),
                                                   k2_s, tid))
                           + (unit ? sl[4 * ZP + k] : 0.0f);
        const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
        const float gc = from_lane(gq, base, 2), og1 = from_lane(gq, base, 3);
        const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
        const float dcs = from_lane(sq, base, 2), dhs = from_lane(sq, base, 3);
        float dz[4], dcT, dhT;
        bwd_step<ACT>(ig, fg, gc, og1, c, cp, DIRECT ? part + dhs : part, dh,
                      DIRECT ? dc + dcs : dc, dz, &dcT, &dhT);
        dc = dcT * fg;
        const float dzq = q == 0 ? dz[0] : q == 1 ? dz[1] : q == 2 ? dz[2] : dz[3];
        const int buf = static_cast<int>(n & 1u) * 4 * ZP;
        if (unit) {
          a.dxz1[og] = dzq;
          if (CARRIES) {
            if (q == 0) a.dhT1[o] = dhT;
            if (q == 1) a.dcT1[o] = dcT;
          }
          dz_s[buf + q * ZP + k] = round_to<T>(dzq);
        }
        __syncthreads();
        // every thread has read slot n: layer 2 may refill it
        if (tid == THREADS - 1) {            // a thread with no unit
          mbar_expect(smem_u32(full + slot), slot_bytes(H));   // slot n's next use, n + D
          st_flag_peer(peer_u32(smem_u32(done), 1), n + 1);
        }
        dh = quad_sum(dot_rec<KR1>(reinterpret_cast<const float4*>(dz_s + buf + q * ZP), w,
                                   rec_s, tid));
        o -= ostep;
        og -= xstep;
      }
    }
  }
  cluster.sync();                            // no block leaves while the other may reach it
}

template <typename T, int ACT, bool DIRECT, bool CARRIES>
cudaError_t launch_sweep_cluster(const void* rec1, const void* k2, const void* rec2,
                                 const StackBwdArgs& a, int W, int B, int H, int rows,
                                 cudaStream_t stream) {
  const size_t smem = cb::smem_bytes(H, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(stack_bwd_cluster_kernel<T, ACT, DIRECT, CARRIES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int clusters = (B + rows - 1) / rows;
  stack_bwd_cluster_kernel<T, ACT, DIRECT, CARRIES><<<2 * clusters, cb::THREADS, smem, stream>>>(
      static_cast<const T*>(rec1), static_cast<const T*>(k2), static_cast<const T*>(rec2), a,
      W, B, H, rows);
  return cudaGetLastError();
}

// the recompute, then the sweep
template <typename T, int ACT>
cudaError_t launch_cluster(const void* xz1, const void* rec1, const void* k2, const void* b2,
                           const void* rec2, const StackBwdArgs& a, int W, int B, int H,
                           int rows, cudaStream_t stream) {
  if (H > 4 * cb::KS || static_cast<long long>(W) * B * 4 * H >= (1LL << 31))
    return cudaErrorInvalidValue;                // the kernels' 32-bit offsets
  GatesArgs g{};
  g.hs1 = a.hs1, g.hs2 = a.hs2, g.g1 = a.dxz1, g.g2 = a.dz2w;
  cudaError_t e = launch_gates<T, ACT, false>(xz1, rec1, k2, b2, rec2, g, W * B, B, H, stream);
  if (e != cudaSuccess) return e;
  if (a.dhs1 != nullptr)
    return a.dhT1 != nullptr
               ? launch_sweep_cluster<T, ACT, true, true>(rec1, k2, rec2, a, W, B, H, rows, stream)
               : launch_sweep_cluster<T, ACT, true, false>(rec1, k2, rec2, a, W, B, H, rows, stream);
  return a.dhT1 != nullptr
             ? launch_sweep_cluster<T, ACT, false, true>(rec1, k2, rec2, a, W, B, H, rows, stream)
             : launch_sweep_cluster<T, ACT, false, false>(rec1, k2, rec2, a, W, B, H, rows, stream);
}

enum { LAYOUT_CLUSTER = 0, LAYOUT_WIDE = 1 };

template <typename T>
cudaError_t launch_mode(int layout, int act, const void* xz1, const void* rec1,
                        const void* k2, const void* k2t, const void* b2, const void* rec2,
                        const void* rec2t, const StackBwdArgs& a, int W, int B, int H,
                        int rows, cudaStream_t s) {
  if (layout == LAYOUT_WIDE) return launch_act<T>(act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a,
                                                  W, B, H, rows, s);
  if (layout != LAYOUT_CLUSTER) return cudaErrorInvalidValue;
  switch (act) {
    case ACT_LINEAR:
      return launch_cluster<T, ACT_LINEAR>(xz1, rec1, k2, b2, rec2, a, W, B, H, rows, s);
    case ACT_SIGMOID:
      return launch_cluster<T, ACT_SIGMOID>(xz1, rec1, k2, b2, rec2, a, W, B, H, rows, s);
    case ACT_TANH:
      return launch_cluster<T, ACT_TANH>(xz1, rec1, k2, b2, rec2, a, W, B, H, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The sweep, then drec1, dk2, db2 and drec2 over the W*B rows, all on
// `stream`.  dhs1/dcs1/dcs2 null: no direct cotangents; dhT1..dcT2 null:
// no carries.  `dz2w` is a (W, B, 4H) float32 workspace.  `layout` (0
// cluster, 1 wide), `threads` and `rows` (batch rows a cluster, or a
// block) are the wrapper's launch rule (cuda_lstm_stack.stack_bwd_layout);
// k2t and rec2t (k2^T, rec2^T) are read by the wide layout only and may
// be null in the cluster one.  Returns the first CUDA error of a launch (0 = ok).
int hfrep_stack_bwd(const void* xz1, const void* rec1, const void* k2, const void* k2t,
                    const void* b2, const void* rec2, const void* rec2t, const void* hs1,
                    const void* cs1, const void* hs2, const void* cs2, const void* dhs2,
                    const void* dhs1, const void* dcs1, const void* dcs2, void* dxz1,
                    void* dz2w, void* dhT1, void* dcT1, void* dhT2, void* dcT2,
                    void* drec1, void* dk2, void* db2, void* drec2, int W, int B, int H,
                    int act, int bf16, int rows, int device, void* stream, int layout,
                    int threads) {
  const int want = layout == LAYOUT_CLUSTER ? cb::THREADS : ((rows * H + 31) / 32) * 32;
  if (threads != want || (layout == LAYOUT_WIDE && (k2t == nullptr || rec2t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  e = bf16 ? launch_mode<__nv_bfloat16>(layout, act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a,
                                       W, B, H, rows, s)
           : launch_mode<float>(layout, act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H,
                                rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // drec1 = sum h1_{t-1}^T dz1, dk2 = sum h1_t^T dz2 and drec2 = sum
  // h2_{t-1}^T dz2 in one launch, then db2 = sum dz2
  ws::Batch sums{};
  sums.n = 3;
  sums.s[0] = ws::sum_of(static_cast<float*>(drec1), B, a.hs1, a.dxz1);
  sums.s[1] = ws::sum_of(static_cast<float*>(dk2), 0, a.hs1, a.dz2w);
  sums.s[2] = ws::sum_of(static_cast<float*>(drec2), B, a.hs2, a.dz2w);
  e = ws::weight_sums(sums, 1, W * B, H, 4 * H, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ws::Batch bias{};
  bias.n = 1;
  bias.s[0] = ws::sum_of(static_cast<float*>(db2), 0, nullptr, a.dz2w);
  e = ws::weight_sums(bias, 1, W * B, 1, 4 * H, s);
  return static_cast<int>(e);
}

// Clusters of the cluster layout (with the carries, tanh) that can be
// resident on `device` at once at width H, by
// cudaOccupancyMaxActiveClusters; a negative value is a CUDA error code.
int hfrep_stack_bwd_clusters(int H, int bf16, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const void* kern =
      bf16 ? reinterpret_cast<const void*>(
                 stack_bwd_cluster_kernel<__nv_bfloat16, ACT_TANH, false, true>)
           : reinterpret_cast<const void*>(stack_bwd_cluster_kernel<float, ACT_TANH, false, true>);
  const size_t smem = cb::smem_bytes(H, bf16 ? 2 : 4);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * 66, 1, 1);
  cfg.blockDim = dim3(cb::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // extern "C"
