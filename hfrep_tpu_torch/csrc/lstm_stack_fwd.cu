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
// before, so the time is W times the latency of one step.  Layer 1 never
// reads layer 2, so layer 1's chain (h1_{t-1} . rec1 -> gates -> h1_t) and
// layer 2's (h2_{t-1} . rec2 -> gates -> h2_t) can run side by side, one
// step apart, if h1_t reaches layer 2 in time.
//
// The cluster layout (stack_fwd_cluster_kernel), for H <= 4*KS = 100,
// which every preset width takes: a cluster of two blocks a batch row, one
// layer a block, each block lstm_fwd.cu's register layout over its layer's
// recurrent matrix: 416 threads, a quad a hidden unit, thread (j, q)
// owning k-quarter q of unit j's four gate columns, KR1 (block 0) or KR2
// (block 1) of its 25 rows in registers and the rest in shared memory as
// one float4 a row.
// - k2's product h1_t . k2 is split by rows: rows kk < KH = 13 of each
//   quarter in block 0, the other 12 in block 1, each block's part of k2
//   dealt out in its shared memory so that thread (j, q) reads its row kk
//   of the four gate columns as one float4 (f32) or 8-byte word (bf16).
//   Held whole by block 1, k2 made that block the slow one (PERF.md).
// - Block 0 (layer 1), pass s: one walk over h1_{s-1} for z1_s = xz1_s +
//   h1_{s-1} . rec1 (xz1 loaded a step ahead) and, in a second loop over
//   the same h, its part of h1_{s-1} . k2; then the gate math makes h1_s.
//   h1_s (rounded to the operand dtype) and the k2 part go into slot s mod
//   D of a ring in block 1's shared memory through distributed shared
//   memory, by st.async stores that count their bytes off the slot's
//   mbarrier there (lstm_common.cuh).  A last pass s = W forms the k2 part
//   of h1_{W-1}.
// - Block 1 (layer 2), step t: waits for slot t's mbarrier, then one walk
//   over h2_{t-1} . rec2 and one over h1_t (from the ring) . its rows of
//   k2, into the same eight chains (two a gate); lane q starts gate q's at
//   b2 (float32, never rounded) plus block 0's k2 part.  Once every thread
//   has read the slot, one thread re-arms its mbarrier and stores the count
//   of slots read into block 0, which polls it before refilling a slot.
// - So block 0 runs up to D = 4 steps ahead and never waits for block 1
//   unless the ring is full: the two layers' chains overlap, and no
//   cluster barrier, release or acquire runs inside the time loop: a
//   release at cluster scope on each hand-off (a remote mbarrier arrive)
//   waits for the block's device-memory stores of hs and cs.
// - Registers: ptxas grants the 13 warps 128 registers a thread, and a
//   spill-free build keeps KR1 = 18, KR2 = 19 rows in registers in float32
//   and 19, 20 in bf16 (tools/torch_stack_fwd_sweep.py --rows compiles
//   every pair; the loops' offsets are 32-bit for the same reason).
// - Shared memory, each block (f32 / bf16 at H=100): 57,200 / 50,544 B
//   fixed (h 448, z 1,664, the 7 / 6 shared rows 46,592 / 39,936, the ring
//   8,448, its 4 mbarriers and the read counter 48), k2's 13 rows dealt out
//   (86,528 / 43,264 B) and a staging area for half of the recurrent
//   matrix (80,000 / 40,000 B): 223,728 / 133,808 B of the 232,448 a block
//   may have.  The prologue stages k2's runs of rows (three quarters' runs
//   at a time) and then the recurrent matrix in two halves with 16-byte
//   cp.async, and each thread takes its values from there: no registers
//   held for the copies, so the prologue does not spill.
// - Clusters loop over ceil(B / (SMs/2)) batch rows each, as lstm_fwd's
//   blocks do: at B=64, 64 clusters (128 blocks) in one wave.
// A width whose recurrent matrices the register file cannot hold (100 < H,
// within stack_fits) runs the wide layout (stack_fwd_kernel), the port's
// first stack forward, unchanged: one block a tile of batch rows, rec1 in
// dynamic shared memory (160,000 B at H=100), k2 and rec2 read by columns
// from L2 through ldg_f, 64 loads in flight a thread, h1 and h2
// double-buffered in shared memory with one barrier a step between the
// layers.  The wrapper chooses the layout by a rule on (H, dtype, B, SMs)
// (cuda_lstm_stack.stack_fwd_layout) and passes it here; it never tries
// one and falls back.

#include <cooperative_groups.h>

#include <cstdint>

#include "lstm_stack.cuh"

namespace {

using namespace hfrep;

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

// ------------------------------------------------------------ cluster layout
// The layout itself (hfrep::cl) is lstm_stack.cuh's, shared with the
// adjoint; here are the forward's own register rows and shared memory.
namespace cf {

using namespace cl;

// Of a thread's KS rows of its layer's recurrent matrix, the first KR1
// (layer 1) or KR2 (layer 2) are held in registers, the rest in shared
// memory: ptxas grants 13 warps 128 registers a thread (lstm_fwd.cu), and
// the counts that leave no instantiation spilling differ by operand type.
constexpr int KR1_F32 = 18, KR2_F32 = 19, KR1_BF16 = 19, KR2_BF16 = 20;
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

// The fixed part of a block's shared memory, in floats: h, z, the rows of
// the recurrent matrix past the fewer of KR1, KR2 (a float4 a thread each), the ring and its
// D mbarriers (block 1), then the count of uses block 1 has read (block 0),
// padded to 16 bytes.
__host__ __device__ constexpr int fixed_floats(size_t item) {
  return 4 * KSP + 4 * ZP + 4 * (KS - kr_min(item)) * THREADS + D * SLOT + 2 * D + 4;
}

// Dynamic shared memory of either block: the fixed part, the block's part
// of k2, then a staging area for half the rows of the recurrent matrix, and
// at least one quarter's run of k2's rows.
__host__ __device__ inline size_t stage_bytes(int H, size_t item) {
  const size_t half = static_cast<size_t>((H + 1) / 2) * 4 * H * item;
  const size_t run = static_cast<size_t>(KS - KH > KH ? KS - KH : KH) * 4 * H * item;
  return half > run ? half : run;
}
__host__ __device__ inline size_t smem_bytes(int H, size_t item) {
  return fixed_floats(item) * sizeof(float) + k2_bytes(item) + stage_bytes(H, item);
}

// unit u's gate math from the z buffer: c updated, h returned
template <int ACT>
__device__ __forceinline__ float gate_step(const float* z_s, int u, float& c) {
  const float ig = sigmoid_rcp(z_s[u]);
  const float fg = sigmoid_rcp(z_s[ZP + u]);
  const float og = sigmoid_rcp(z_s[3 * ZP + u]);
  c = fg * c + ig * act_rcp<ACT>(z_s[2 * ZP + u]);
  return og * act_rcp<ACT>(c);
}

}  // namespace cf

// Launched as clusters of two blocks of cl::THREADS threads; grid = 2 x the
// clusters, cluster c walks batch rows c*rows .. c*rows + rows - 1.
template <typename T, int ACT, bool WITH_RES>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(cl::THREADS, 1)
stack_fwd_cluster_kernel(const T* __restrict__ xz1, const T* __restrict__ rec1,
                         const T* __restrict__ k2, const T* __restrict__ b2,
                         const T* __restrict__ rec2,
                         float* __restrict__ hs1,     // WITH_RES only
                         float* __restrict__ cs1,     // WITH_RES only
                         float* __restrict__ hs2,
                         float* __restrict__ cs2,     // WITH_RES only
                         int W, int B, int H, int rows) {
  using namespace cf;
  namespace cg = cooperative_groups;
  constexpr int KR1 = Keep<T>::r1, KR2 = Keep<T>::r2;
  constexpr int KRMIN = KR1 < KR2 ? KR1 : KR2, KRMAX = KR1 < KR2 ? KR2 : KR1;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  float* h_s = fsm;                          // this layer's h_{t-1}: 4 quarters x KSP
  float* z_s = h_s + 4 * KSP;                // z_t: 4 gates x ZP
  float4* rec_s = reinterpret_cast<float4*>(z_s + 4 * ZP);   // rows kk >= KR1 or KR2
  float* ring = reinterpret_cast<float*>(rec_s + (KS - KRMIN) * THREADS);   // D slots
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + D * SLOT);  // D
  unsigned* done = reinterpret_cast<unsigned*>(full + D);   // block 0: uses block 1 has read
  T* k2_s = reinterpret_cast<T*>(fsm + fixed_floats(sizeof(T)));    // this block's rows of k2
  T* stage = k2_s + k2_bytes(sizeof(T)) / sizeof(T);        // staging area
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int q = tid & 3;                     // k-quarter, and the gate it sums
  const int j = (tid >> 5) * 8 + ((tid & 31) >> 2);   // hidden unit of the dot
  const bool unit = j < H;
  const bool gate = tid < H;                 // thread tid does unit tid's gate math
  const int hpos = (tid / KS) * KSP + tid % KS;       // unit tid's h in an h buffer
  const unsigned rank = cluster.block_rank();          // 0: layer 1, 1: layer 2
  const int cid = static_cast<int>(blockIdx.x / 2);

  // h buffers and the ring start at zero; positions past H and the pads
  // stay zero, multiplied by zero weights
  for (int i = tid; i < 4 * KSP; i += THREADS) h_s[i] = 0.0f;
  for (int i = tid; i < D * SLOT; i += THREADS) ring[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < D; ++s) mbar_init(smem_u32(full + s), 1);
    if (rank == 1)
      for (int s = 0; s < D; ++s) mbar_expect(smem_u32(full + s), 20 * H);   // uses 0 .. D-1
    *reinterpret_cast<volatile unsigned*>(done) = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block's rows of k2, then this layer's recurrent matrix, half its
  // rows at a time: rows kk < KR1 (KR2) into registers, the rest into
  // shared memory
  deal_k2(k2, k2_s, stage, static_cast<int>(stage_bytes(H, sizeof(T)) / sizeof(T)),
          rank == 0 ? 0 : KH, rank == 0 ? KH : KS, H, q, j, unit);
  float w[4][KRMAX];
#pragma unroll
  for (int kk = 0; kk < KRMAX; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g][kk] = 0.0f;
  for (int kk = 0; kk < KS - KRMIN; ++kk) rec_s[kk * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const T* rec = rank == 0 ? rec1 : rec2;
  for (int lo = 0; lo < H; lo += (H + 1) / 2) {
    const int n = min((H + 1) / 2, H - lo);
    copy_issue<THREADS>(rec + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    if (rank == 0) deal_rec<T, KR1>(stage, lo, n, H, q, j, unit, w, rec_s);
    else deal_rec<T, KR2>(stage, lo, n, H, q, j, unit, w, rec_s);
    __syncthreads();                         // the staged rows are read
  }
  cluster.sync();                            // both blocks set up before any remote access

  // 32-bit element offsets into xz1 and the outputs (the launch checks that
  // W*B*4H fits), so a step's walk holds no 64-bit pointers beside the
  // kernel parameters
  const int xstep = B * G;
  const int ostep = B * H;
  unsigned n = 0;                            // steps so far: slot n % D, its use n / D
  // each block runs its own loop, so that neither holds the other's values
  if (rank == 0) {
    // Layer 1.  Pass s reads h1_{s-1} once for z1_s = xz1_s + h1_{s-1} . rec1
    // (s < W) and for this block's part of h1_{s-1} . k2 (s > 0), which goes
    // to slot s-1 of layer 2's ring beside h1_{s-1}.
    const unsigned ring_peer = peer_u32(smem_u32(ring), 1);   // layer 2's ring
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;                     // the same for the whole cluster
      __syncthreads();                       // the last row's reads are done
      int o = b * H + (gate ? tid : 0);     // (W, B, H) offset of this step's output
      float c = 0.0f;
      if (gate) h_s[hpos] = 0.0f;
      // this lane's gate column of xz1, a step ahead
      int xo = b * G + q * H + (unit ? j : 0);
      float xn = unit ? ldg_f(xz1 + xo) : 0.0f;
      __syncthreads();
      for (int s = 0; s <= W; ++s) {
        const float x = xn;
        xo += xstep;
        if (unit && s + 1 < W) xn = ldg_f(xz1 + xo);
        // z1's dot, then this block's rows of k2: two loops, so that the
        // second holds none of the first's values
        float acc[4], acc2[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = g == q ? x : 0.0f, acc2[g] = 0.0f;
        const float4* hp = reinterpret_cast<const float4*>(h_s + q * KSP);
#pragma unroll
        for (int i = 0; i < KSP / 4; ++i) {
          const float4 v = hp[i];
          const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * i + e;
            if (kk >= KS) break;
            float wk[4];
            weights<KR1>(w, rec_s, kk, tid, wk);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (e & 1) acc2[g] = fmaf(hk[e], wk[g], acc2[g]);
              else acc[g] = fmaf(hk[e], wk[g], acc[g]);
            }
          }
        }
        const float zq = quad_z(acc, acc2, q);
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < (KH + 3) / 4; ++i) {
          const float4 v = hp[i];
          const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * i + e;
            if (kk >= KH) break;
            float kv[4];
            load4(k2_s + (kk * THREADS + tid) * 4, kv);
#pragma unroll
            for (int g = 0; g < 4; ++g) p[g] = fmaf(hk[e], kv[g], p[g]);
          }
        }
        const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float pq = quad_z(p, zero, q);
        const unsigned prev = (n - 1) % D;   // slot of step s-1
        if (unit) {
          if (s < W) z_s[q * ZP + j] = zq;
          if (s > 0) st_async_peer(ring_peer + 4 * (prev * SLOT + 4 * KSP + q * ZP + j), pq,
                                   peer_u32(smem_u32(full + prev), 1));
        }
        __syncthreads();
        if (s == W) break;
        const unsigned slot = n % D;
        if (gate) {
          const float h = gate_step<ACT>(z_s, tid, c);
          if (WITH_RES) hs1[o] = h, cs1[o] = c;
          const float hr = round_to<T>(h);
          h_s[hpos] = hr;
          // h1_s into slot n of layer 2's ring, once layer 2 has read it
          if (n >= D)
            while (ld_flag(smem_u32(done)) < n - D + 1) {
            }
          st_async_peer(ring_peer + 4 * (slot * SLOT + hpos), hr, peer_u32(smem_u32(full + slot), 1));
        }
        o += ostep;
        ++n;
        __syncthreads();
      }
    }
  } else {
    // Layer 2: z2_t = b2 + h1_t . k2 + h2_{t-1} . rec2, block 0's part of
    // h1_t . k2 taken from the ring as lane q's start for gate q.
    const float bias = unit ? to_f(b2[q * H + j]) : 0.0f;   // gate q's b2
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;
      __syncthreads();
      int o = b * H + (gate ? tid : 0);
      float c = 0.0f;
      if (gate) h_s[hpos] = 0.0f;
      __syncthreads();
      for (int t = 0; t < W; ++t, ++n) {
        const unsigned slot = n % D;
        mbar_wait(smem_u32(full + slot), (n / D) & 1);
        const float* sl = ring + slot * SLOT;
        const float part = unit ? sl[4 * KSP + q * ZP + j] : 0.0f;
        float acc[4], acc2[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = g == q ? bias + part : 0.0f, acc2[g] = 0.0f;
        const float4* hp = reinterpret_cast<const float4*>(h_s + q * KSP);
        const float4* h1p = reinterpret_cast<const float4*>(sl + q * KSP);
        // h2_{t-1} . rec2, then h1_t . k2 over this block's rows, into the
        // same chains
#pragma unroll
        for (int i = 0; i < KSP / 4; ++i) {
          const float4 v = hp[i];
          const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * i + e;
            if (kk >= KS) break;
            float wk[4];
            weights<KR2>(w, rec_s, kk, tid, wk);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (e & 1) acc2[g] = fmaf(hk[e], wk[g], acc2[g]);
              else acc[g] = fmaf(hk[e], wk[g], acc[g]);
            }
          }
        }
#pragma unroll
        for (int i = KH / 4; i < KSP / 4; ++i) {
          const float4 u = h1p[i];
          const float h1k[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * i + e;
            if (kk < KH || kk >= KS) continue;
            float kv[4];
            load4(k2_s + ((kk - KH) * THREADS + tid) * 4, kv);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              if (e & 1) acc2[g] = fmaf(h1k[e], kv[g], acc2[g]);
              else acc[g] = fmaf(h1k[e], kv[g], acc[g]);
            }
          }
        }
        const float zq = quad_z(acc, acc2, q);
        if (unit) z_s[q * ZP + j] = zq;
        __syncthreads();
        // every thread has read slot n: layer 1 may refill it
        if (tid == THREADS - 1) {                // a thread with no gate math
          mbar_expect(smem_u32(full + slot), 20 * H);   // slot n's next use, n + D
          st_flag_peer(peer_u32(smem_u32(done), 0), n + 1);
        }
        if (gate) {
          const float h = gate_step<ACT>(z_s, tid, c);
          hs2[o] = h;
          if (WITH_RES) cs2[o] = c;
          h_s[hpos] = round_to<T>(h);
        }
        o += ostep;
        __syncthreads();
      }
    }
  }
  cluster.sync();                            // no block leaves while the other may reach it
}

template <typename T, int ACT, bool WITH_RES>
cudaError_t launch_cluster(const void* xz1, const void* rec1, const void* k2, const void* b2,
                           const void* rec2, float* hs1, float* cs1, float* hs2, float* cs2,
                           int W, int B, int H, int rows, cudaStream_t stream) {
  if (H > 4 * cl::KS || static_cast<long long>(W) * B * 4 * H >= (1LL << 31))
    return cudaErrorInvalidValue;                // the kernel's 32-bit offsets
  const size_t smem = cf::smem_bytes(H, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(stack_fwd_cluster_kernel<T, ACT, WITH_RES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int clusters = (B + rows - 1) / rows;
  stack_fwd_cluster_kernel<T, ACT, WITH_RES><<<2 * clusters, cl::THREADS, smem, stream>>>(
      static_cast<const T*>(xz1), static_cast<const T*>(rec1), static_cast<const T*>(k2),
      static_cast<const T*>(b2), static_cast<const T*>(rec2), hs1, cs1, hs2, cs2, W, B, H,
      rows);
  return cudaGetLastError();
}

template <typename T, bool WITH_RES>
cudaError_t launch_cluster_act(int act, const void* xz1, const void* rec1, const void* k2,
                               const void* b2, const void* rec2, float* hs1, float* cs1,
                               float* hs2, float* cs2, int W, int B, int H, int rows,
                               cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR:
      return launch_cluster<T, ACT_LINEAR, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2,
                                                     cs2, W, B, H, rows, s);
    case ACT_SIGMOID:
      return launch_cluster<T, ACT_SIGMOID, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2,
                                                      cs2, W, B, H, rows, s);
    case ACT_TANH:
      return launch_cluster<T, ACT_TANH, WITH_RES>(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2,
                                                   cs2, W, B, H, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

enum { LAYOUT_CLUSTER = 0, LAYOUT_WIDE = 1 };

template <typename T>
cudaError_t launch_mode(int layout, int act, const void* xz1, const void* rec1, const void* k2,
                        const void* b2, const void* rec2, float* hs1, float* cs1,
                        float* hs2, float* cs2, int W, int B, int H, int rows,
                        cudaStream_t s) {
  if (layout == LAYOUT_CLUSTER) {
    if (hs1 != nullptr)
      return launch_cluster_act<T, true>(act, xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, W,
                                         B, H, rows, s);
    return launch_cluster_act<T, false>(act, xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, W,
                                        B, H, rows, s);
  }
  if (layout != LAYOUT_WIDE) return cudaErrorInvalidValue;
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
// the with_res mode writes hs1, cs1 and cs2 too.  `layout` (0 cluster,
// 1 wide), `threads` and `rows` (batch rows a block, or a cluster) are the
// wrapper's launch rule (cuda_lstm_stack.stack_fwd_layout).
int hfrep_stack_fwd(const void* xz1, const void* rec1, const void* k2, const void* b2,
                    const void* rec2, void* hs1, void* cs1, void* hs2, void* cs2, int W,
                    int B, int H, int act, int bf16, int rows, int device, void* stream,
                    int layout, int threads) {
  const int want = layout == LAYOUT_CLUSTER ? cl::THREADS : ((rows * H + 31) / 32) * 32;
  if (threads != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h1 = static_cast<float*>(hs1);
  float* c1 = static_cast<float*>(cs1);
  float* h2 = static_cast<float*>(hs2);
  float* c2 = static_cast<float*>(cs2);
  e = bf16 ? launch_mode<__nv_bfloat16>(layout, act, xz1, rec1, k2, b2, rec2, h1, c1, h2, c2,
                                       W, B, H, rows, s)
           : launch_mode<float>(layout, act, xz1, rec1, k2, b2, rec2, h1, c1, h2, c2, W, B,
                                H, rows, s);
  return static_cast<int>(e);
}

// Clusters of the cluster layout (with_res, tanh) that can be resident on
// `device` at once at width H, by cudaOccupancyMaxActiveClusters; a
// negative value is a CUDA error code.
int hfrep_stack_fwd_clusters(int H, int bf16, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const void* kern = bf16 ? reinterpret_cast<const void*>(
                                stack_fwd_cluster_kernel<__nv_bfloat16, ACT_TANH, true>)
                          : reinterpret_cast<const void*>(
                                stack_fwd_cluster_kernel<float, ACT_TANH, true>);
  const size_t smem = cf::smem_bytes(H, bf16 ? 2 : 4);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * 66, 1, 1);
  cfg.blockDim = dim3(cl::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // extern "C"
