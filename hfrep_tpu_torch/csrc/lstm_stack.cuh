// Pieces shared by the fused two-layer stack's kernels
// (lstm_stack_{fwd,bwd,adj}.cu) and the single-layer backward and adjoint
// (lstm_bwd.cu, lstm_adj.cu):
//
// - the cluster layout of the products that run a row vector into an
//   (H, 4H) matrix (hfrep::cl): a block of 416 threads, a quad a hidden
//   unit j, thread (j, q) holding k-quarter q of unit j's four gate columns
//   (rows k = q*KS + kk), some rows in registers and the rest in shared
//   memory, and a block's part of k2's rows dealt out beside them.  The
//   stack forward (h . rec) and the adjoints (mu_h . rec; the stack's
//   cluster and the single-layer register layout) run it, the adjoints
//   with their lane math (hfrep::adj);
// - the backward sweeps' quad layout (hfrep::bq): a quad a hidden unit
//   holding its row of the recurrent matrix for dz . rec^T, in the stack
//   backward's cluster and the single-layer backward's register layout;
// - the tiled float32 products over all W*B rows (hfrep::tile) and the
//   kernel that forms both layers' gates from the saved states with them,
//   the pre-pass of the stack backward and of the adjoint (which also forms
//   its chain-free v-stream products there) and, its first layer alone,
//   of the single-layer backward (the gates) and adjoint (the gates and
//   the v-stream product).  No tensor cores: TF32 or bf16 products of
//   float32 operands would break the float32 bars.

#pragma once

#include "lstm_common.cuh"

namespace hfrep {

namespace cl {

constexpr int KS = 25;              // k rows a thread owns: H <= 4*KS
constexpr int KSP = 28;             // a quarter's stride in an h buffer (floats)
constexpr int ZP = 104;             // a gate's stride in a z buffer
constexpr int THREADS = 32 * ((4 * KS + 7) / 8);   // 416: a quad per unit
// k2's product is split between the blocks: rows kk < KH of each quarter in
// the block that sends its vector, the rest in the block that receives it
constexpr int KH = 13;
constexpr int D = 4;                // ring slots: how far the sender may run ahead
// a slot: the sent vector laid out as an h buffer, then the sender's part
// of its product with k2 laid out as a z buffer
constexpr int SLOT = 4 * KSP + 4 * ZP;

// bytes of a block's part of k2, dealt out: rows x THREADS x 4 entries of T
__host__ __device__ constexpr size_t k2_bytes(size_t item) {
  return static_cast<size_t>(KS - KH > KH ? KS - KH : KH) * THREADS * 4 * item;
}

// Rows [lo, lo + n) of an (H, 4H) matrix lie staged at `stage`: thread
// (j, q) takes its rows k = q*KS + kk among them, the four gate columns of
// its unit, into w (kk < KR) and rec_s.
template <typename T, int KR, int KW>
__device__ __forceinline__ void deal_rec(const T* stage, int lo, int n, int H, int q, int j,
                                         bool unit, float (&w)[4][KW], float4* rec_s) {
  const int G = 4 * H, tid = threadIdx.x;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k = q * KS + kk - lo;
    if (unit && k >= 0 && k < n) {
      float v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = to_f(stage[k * G + g * H + j]);
      if (kk < KR) {
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g][kk < KR ? kk : 0] = v[g];
      } else {
        rec_s[(kk - KR) * THREADS + tid] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// This block's rows kk0 <= kk < kk1 of each quarter of k2 into k2_s:
// thread (j, q) row k = q*KS + kk of its unit's four gate columns at
// entries ((kk - kk0) * THREADS + tid) * 4 + g; rows past H and units past
// H zero.  Each quarter's rows are one contiguous run of k2; as many runs
// as the staging area holds are copied at once, then dealt out.
template <typename T>
__device__ void deal_k2(const T* k2, T* k2_s, T* stage, int stage_elems, int kk0, int kk1,
                        int H, int q, int j, bool unit) {
  const int G = 4 * H, tid = threadIdx.x, run = kk1 - kk0;
  for (int kk = kk0; kk < kk1; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) k2_s[((kk - kk0) * THREADS + tid) * 4 + g] = from_f<T>(0.0f);
  const int per = max(1, stage_elems / (run * G));     // runs staged at once
  for (int q0 = 0; q0 < 4; q0 += per) {
    for (int r = 0; r < per && q0 + r < 4; ++r) {
      const int lo = (q0 + r) * KS + kk0;
      const int n = min(run, H - lo);
      if (n > 0) copy_issue<THREADS>(k2 + static_cast<size_t>(lo) * G, stage + r * run * G, n * G);
    }
    copy_wait();
    if (unit && q >= q0 && q < q0 + per)
      for (int kk = kk0; kk < kk1; ++kk) {
        if (q * KS + kk >= H) break;
        const T* src = stage + ((q - q0) * run + kk - kk0) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) k2_s[((kk - kk0) * THREADS + tid) * 4 + g] = src[g * H];
      }
    __syncthreads();                         // the staged runs are read
  }
}

// row kk of this thread's four gate columns: from registers (kk < KR) or
// from shared memory
template <int KR, int KW>
__device__ __forceinline__ void weights(const float (&w)[4][KW], const float4* rec_s, int kk,
                                        int tid, float (&wk)[4]) {
  if (kk < KR) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wk[g] = w[g][kk < KR ? kk : 0];
  } else {
    const float4 v = rec_s[(kk - KR) * THREADS + tid];
    wk[0] = v.x, wk[1] = v.y, wk[2] = v.z, wk[3] = v.w;
  }
}

// The quad's sums, scattered: lane q ends with gate q's sum of acc + acc2
// over the quad, each gate summed once, in the same order in every run
// (lstm_fwd.cu).
__device__ __forceinline__ float quad_z(float (&acc)[4], const float (&acc2)[4], int q) {
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] += acc2[g];
  const bool odd = q & 1, hi = q & 2;
  float k0 = odd ? acc[1] : acc[0], k1 = odd ? acc[3] : acc[2];
  k0 += __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[1], 1);
  k1 += __shfl_xor_sync(0xffffffffu, odd ? acc[2] : acc[3], 1);
  return (hi ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hi ? k0 : k1, 2);
}

}  // namespace cl

// ------------------------------------------- the backward sweeps' quad layout
// A block of THREADS threads, a quad a hidden unit k: thread (k, q) holds
// chunks c < KS of row k's gate-q columns of an (H, 4H) matrix (entries
// q*H + 4c .. 4c + 3), the first KR in registers and the rest in shared
// memory as a float4 each, so dh[k] = sum_m dz[m] rec[k, m] is KS float4
// FMAs a thread against dz broadcast from shared memory, and a quad sum of
// two shuffles.  The stack backward's cluster (lstm_stack_bwd.cu) and the
// single-layer backward's register layout (lstm_bwd.cu) run it.
namespace bq {

constexpr int KS = 25;              // chunks of four columns a thread owns: H <= 4*KS
constexpr int ZP = 104;             // a gate's stride in a dz buffer (floats)
constexpr int THREADS = 32 * ((4 * KS + 7) / 8);   // 416: a quad per unit

// Rows [lo, lo + n) of an (H, 4H) matrix lie staged at `stage`: thread
// (k, q), k among them, takes its chunks c < KS of row k's gate-q columns
// into w (c < KR) and rec_s, entries past H zero.
template <typename T, int KR, int KW>
__device__ __forceinline__ void deal_rec(const T* stage, int lo, int n, int H, int q, int k,
                                         bool unit, float (&w)[4][KW], float4* rec_s) {
  const int r = k - lo, tid = threadIdx.x;
  if (!unit || r < 0 || r >= n) return;
  const T* src = stage + r * 4 * H + q * H;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = 4 * c + e < H ? to_f(src[4 * c + e]) : 0.0f;
    if (c < KR) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e][c < KR ? c : 0] = v[e];
    } else {
      rec_s[(c - KR) * THREADS + tid] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// chunk c of this thread's row: from registers (c < KR) or shared memory
template <int KR, int KW>
__device__ __forceinline__ void weights(const float (&w)[4][KW], const float4* rec_s, int c,
                                        int tid, float (&wk)[4]) {
  if (c < KR) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wk[e] = w[e][c < KR ? c : 0];
  } else {
    const float4 v = rec_s[(c - KR) * THREADS + tid];
    wk[0] = v.x, wk[1] = v.y, wk[2] = v.z, wk[3] = v.w;
  }
}

// the eight chains of a dot, summed in a fixed order
__device__ __forceinline__ float chains(const float (&a0)[4], const float (&a1)[4]) {
  return ((a0[0] + a1[0]) + (a0[1] + a1[1])) + ((a0[2] + a1[2]) + (a0[3] + a1[3]));
}

// this thread's part of dz . rec^T for its row: its KS chunks against the
// dz buffer's gate-q run (float4s, broadcast within each quarter-warp)
template <int KR, int KW>
__device__ __forceinline__ float dot_rec(const float4* dz4, const float (&w)[4][KW],
                                         const float4* rec_s, int tid) {
  float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
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
  }
  return chains(a0, a1);
}

// the quad's sum in all four lanes, the same bits in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// lane `src` of this quad's value
__device__ __forceinline__ float from_lane(float v, int base, int src) {
  return __shfl_sync(0xffffffffu, v, base + src);
}

// Stage this lane's inputs of step t into st[0..1] with cp.async, which
// holds no registers while the loads are in flight: its gate's value (at
// (W, B, 4H) offset og of `gates`) and its value of the step's state
// stream (lane 0 c_t, lane 1 c_{t-1}, lane 2 the direct dc, lane 3 the dh
// input, at (W, B, H) offset o - back of `sp`; null is zeros).  Lane 1's
// c_{-1} is zero, or *first (the carry mode's c0) where given.
__device__ __forceinline__ void stage_step(float* st, const float* gates, int og,
                                           const float* sp, int o, int back, int t, bool on,
                                           const float* first = nullptr) {
  if (on) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st)),
                 "l"(gates + og) : "memory");
  } else {
    st[0] = 0.0f;
  }
  if (on && sp != nullptr && (back == 0 || t > 0)) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st + 1)),
                 "l"(sp + o - back) : "memory");
  } else if (on && first != nullptr && back != 0) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st + 1)),
                 "l"(first) : "memory");
  } else {
    st[1] = 0.0f;
  }
}

}  // namespace bq

// ------------------------------------------------ the adjoints' lane math
// The adjoint sweeps on the cluster layout: the stack adjoint's cluster
// (lstm_stack_adj.cu) and the single-layer adjoint's register layout
// (lstm_adj.cu).  A lane stages its step inputs a step ahead, starts gate
// q's sum at its base, adds its k-quarter of round(mu_h) . rec, and after
// the quad's butterfly runs its unit's adj_step itself.
namespace adj {

// The single-layer adjoint step of unit j from its gate values: given
// the backward's carries dh, dc and the cotangent dzb[4] of dz, fills
// dz[4] (the backward's dz, recomputed) and zb[4] (the cotangent of z)
// and returns dhTbar, dcTbar, cpbar (cot of c_{t-1}) and cbar (of c_t).
template <int ACT>
__device__ __forceinline__ void adj_step(float ig, float fg, float gc, float og,
                                         float c, float cp, float dh, float dc,
                                         float muc, const float* dzb, float* dz,
                                         float* zb, float* dhTbar_out,
                                         float* dcTbar_out, float* cpbar_out,
                                         float* cbar_out) {
  const float a_c = act_f<ACT>(c);
  const float qi = ig * (1.0f - ig), qf = fg * (1.0f - fg), qo = og * (1.0f - og);
  const float pg = act_prime<ACT>(gc), pa = act_prime<ACT>(a_c);
  const float ppg = act_prime2<ACT>(gc), ppa = act_prime2<ACT>(a_c);
  const float d_out = dh * a_c;
  dz[0] = dc * gc * qi;
  dz[1] = dc * cp * qf;
  dz[2] = dc * ig * pg;
  dz[3] = d_out * qo;
  float dcTbar = muc * fg;
  float fbar = muc * dc;
  dcTbar += dzb[0] * gc * qi;
  float gbar = dzb[0] * dc * qi;
  float ibar = dzb[0] * dc * gc * (1.0f - 2.0f * ig);
  dcTbar += dzb[1] * cp * qf;
  *cpbar_out = dzb[1] * dc * qf;
  fbar += dzb[1] * dc * cp * (1.0f - 2.0f * fg);
  dcTbar += dzb[2] * ig * pg;
  ibar += dzb[2] * dc * pg;
  gbar += dzb[2] * dc * ig * ppg;
  const float dobar = dzb[3] * qo;
  float obar = dzb[3] * d_out * (1.0f - 2.0f * og);
  float dhTbar = dcTbar * og * pa;
  obar += dcTbar * dh * pa;
  float aCbar = dcTbar * dh * og * ppa;
  dhTbar += dobar * a_c;
  aCbar += dobar * dh;
  zb[0] = ibar * qi;
  zb[1] = fbar * qf;
  zb[2] = gbar * pg;
  zb[3] = obar * qo;
  *dhTbar_out = dhTbar;
  *dcTbar_out = dcTbar;
  *cbar_out = aCbar * pa;
}

// The quad's sums of acc + acc2 gate by gate, in every lane: a butterfly,
// whose two additions are each commutative, so all four lanes hold the
// same bits, in the same order in every run.
__device__ __forceinline__ void quad_sums(const float (&acc)[4], const float (&acc2)[4],
                                          float (&out)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float v = acc[g] + acc2[g];
    const float s = v + __shfl_xor_sync(0xffffffffu, v, 1);
    out[g] = s + __shfl_xor_sync(0xffffffffu, s, 2);
  }
}

using bq::from_lane;   // lane `src` of this quad's value

// v[q], without indexing a register array by a runtime value
__device__ __forceinline__ float pick(const float (&v)[4], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

constexpr int NST = 3;              // a lane's staged step inputs: gate, base, a state value

// Stage this lane's inputs of step t into st[0..2] with cp.async, which
// holds no registers while the loads are in flight: its gate's value and
// its base (at (W, B, 4H) offset og of `gates` and `base`) and its value of
// the step's state stream (lane 0 c_t, lane 1 c_{t-1}, lane 2 dhT, lane 3
// dcT, at (W, B, H) offset o - back of `sp`).  Lane 1's c_{-1} is zero, or
// *first (the carry mode's c0) where given.
__device__ __forceinline__ void stage_step(float* st, const float* gates, const float* base,
                                           int og, const float* sp, int o, int back, int t,
                                           bool on, const float* first = nullptr) {
  if (on) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st)),
                 "l"(gates + og) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st + 1)),
                 "l"(base + og) : "memory");
  } else {
    st[0] = 0.0f;
    st[1] = 0.0f;
  }
  if (on && (back == 0 || t > 0)) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st + 2)),
                 "l"(sp + o - back) : "memory");
  } else if (on && first != nullptr) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(st + 2)),
                 "l"(first) : "memory");
  } else {
    st[2] = 0.0f;
  }
}

// this thread's part of v . rec for its unit's four gate columns, into the
// two chains of each gate: its KS rows against the h buffer's quarter
template <int KR, int KW>
__device__ __forceinline__ void dot_rec(const float4* hp, const float (&w)[4][KW],
                                        const float4* rec_s, int tid, float (&acc)[4],
                                        float (&acc2)[4]) {
#pragma unroll
  for (int i = 0; i < cl::KSP / 4; ++i) {
    const float4 v = hp[i];
    const float hk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 4 * i + e;
      if (kk >= cl::KS) break;
      float wk[4];
      cl::weights<KR>(w, rec_s, kk, tid, wk);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (e & 1) acc2[g] = fmaf(hk[e], wk[g], acc2[g]);
        else acc[g] = fmaf(hk[e], wk[g], acc[g]);
      }
    }
  }
}

}  // namespace adj

// ------------------------------------------------ products over the W*B rows
namespace tile {

// One output tile of M rows x N columns a block of THREADS threads, each
// keeping a 4 x 4 tile of sums; the k range goes K at a time through
// shared memory, the next piece loaded into registers while the current
// one is multiplied, so a block waits for global memory once.
constexpr int M = 64, N = 64, K = 16, THREADS = (M / 4) * (N / 4);
constexpr int LA = M * K / THREADS, LB = N * K / THREADS;

struct Smem {
  float as[K][M + 4];    // the row vectors' piece, k-major
  float bs[K][N + 4];    // the matrix's piece
};

// acc = A B over k_begin <= k < k_end (whole pieces).  piece(k0, va, vb)
// loads this thread's entries of the piece at k0: va[u] is A's entry
// (m0 + i / K, k0 + i % K) and vb[u] B's entry (k0 + i / N, n0 + i % N),
// or with BT (B read from its transpose, so that neighbouring threads read
// neighbouring words) (k0 + i % K, n0 + i / K), for i = threadIdx.x + u *
// THREADS; zero outside the ranges.
template <bool BT, class Piece>
__device__ __forceinline__ void product(Piece piece, int k_begin, int k_end, Smem& s,
                                        float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % (N / 4), ty = tid / (N / 4);   // columns 4tx.., rows 4ty..
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  float va[LA], vb[LB];
  if (k_begin < k_end) piece(k_begin, va, vb);
  for (int k0 = k_begin; k0 < k_end; k0 += K) {
#pragma unroll
    for (int u = 0; u < LA; ++u) {
      const int i = tid + u * THREADS;
      s.as[i % K][i / K] = va[u];
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = tid + u * THREADS;
      if (BT) s.bs[i % K][i / K] = vb[u];
      else s.bs[i / N][i % N] = vb[u];
    }
    __syncthreads();
    if (k0 + K < k_end) piece(k0 + K, va, vb);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s.as[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&s.bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
}

}  // namespace tile

// The gates of both layers for all W*B rows, from the saved states, one
// output tile a block, blockIdx.z the product:
//   0: act(xz1 + round(shift(hs1)) . rec1)                         -> g1
//   1: act(b2 + [round(hs1), round(shift(hs2))] . [k2; rec2])      -> g2
// (sigmoid for i, f, o; the activation for the candidate; shift(s) is the
// previous step's s, zero at t = 0, or the head h0 where given: the
// single-layer backward's carry mode runs product 0 alone).  With V (the
// adjoint's pre-pass) also
// the chain-free part of each layer's dzbar, from unrounded states and the
// float32 v-streams:
//   2: u1 + shift(hs1) . vr1                                        -> v1
//   3: vb2 + [hs1, shift(hs2)] . [vk2; vr2]                         -> v2
struct GatesArgs {
  const float* hs1;    // (W, B, H)
  const float* hs2;
  float* g1;           // (W, B, 4H) outputs
  float* g2;
  const float* u1;     // V only: (W, B, 4H)
  const float* vr1;    // (H, 4H)
  const float* vk2;
  const float* vb2;    // (4H,)
  const float* vr2;
  float* v1;           // (W, B, 4H) outputs
  float* v2;
  const float* h0;     // (B, H) layer 1's state before step 0; null: zeros
};

template <typename T, int ACT, bool V>
__global__ void __launch_bounds__(tile::THREADS)
stack_gates_kernel(const T* __restrict__ xz1, const T* __restrict__ rec1,
                   const T* __restrict__ k2, const T* __restrict__ b2,
                   const T* __restrict__ rec2, GatesArgs a, int R, int B, int H) {
  using namespace tile;
  __shared__ __align__(16) Smem s;
  // with V, a grid of two products is layer 1's pair, products 0 and 2
  // (the single-layer adjoint's pre-pass)
  const int z = V && gridDim.z == 2 ? 2 * static_cast<int>(blockIdx.z)
                                    : static_cast<int>(blockIdx.z);
  const int layer = z & 1;
  const bool vp = V && z >= 2;              // a v-stream product
  const int G = 4 * H, depth = layer ? 2 * H : H;
  const int m0 = blockIdx.x * M, n0 = blockIdx.y * N;
  const int tid = threadIdx.x;
  // each load loop reads one type, and the rounding follows the loads, so
  // that a piece's loads are all in flight at once
  auto piece = [&](int k0, float (&va)[LA], float (&vb)[LB]) {
#pragma unroll
    for (int u = 0; u < LA; ++u) {
      const int i = tid + u * THREADS;
      const int r = m0 + i / K, k = k0 + i % K;
      float v = 0.0f;
      if (r < R && k < depth) {
        if (layer == 0 || k >= H) {                      // a previous state
          const float* hp = layer == 0 ? a.hs1 : a.hs2;
          if (r >= B) v = hp[(r - B) * H + (layer == 0 ? k : k - H)];
          else if (layer == 0 && a.h0 != nullptr) v = a.h0[r * H + k];
        } else {
          v = a.hs1[r * H + k];
        }
      }
      va[u] = v;
    }
    if (!vp)
#pragma unroll
      for (int u = 0; u < LA; ++u) va[u] = round_to<T>(va[u]);
    if (vp) {
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int k = k0 + i / N, n = n0 + i % N;
        const float* m = layer == 0 ? a.vr1 + k * G : k < H ? a.vk2 + k * G : a.vr2 + (k - H) * G;
        vb[u] = k < depth && n < G ? m[n] : 0.0f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int k = k0 + i / N, n = n0 + i % N;
        float v = 0.0f;
        if (k < depth && n < G) {
          if (layer == 0) v = to_f(rec1[k * G + n]);
          else v = to_f(k < H ? k2[k * G + n] : rec2[(k - H) * G + n]);
        }
        vb[u] = v;
      }
    }
  };
  float acc[4][4];
  product<false>(piece, 0, depth, s, acc);
  const int tx = tid % (N / 4), ty = tid / (N / 4);
  float* out = vp ? (layer ? a.v2 : a.v1) : (layer ? a.g2 : a.g1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    if (r >= R) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 4 * tx + jj;
      if (n >= G) continue;
      if (vp) {
        out[r * G + n] = (layer ? a.vb2[n] : a.u1[r * G + n]) + acc[i][jj];
      } else {
        const float z = (layer ? to_f(b2[n]) : to_f(xz1[r * G + n])) + acc[i][jj];
        out[r * G + n] = n / H == 2 ? act_f<ACT>(z) : sigmoid_f(z);
      }
    }
  }
}

// Launch stack_gates_kernel over the W*B rows on `stream`: the two gate
// products, and with V the two v-stream products; with `one_layer` the
// first layer's alone, its gate product (and with V its v-stream product:
// products 0 and 2), k2, b2 and rec2 unread.
template <typename T, int ACT, bool V>
cudaError_t launch_gates(const void* xz1, const void* rec1, const void* k2, const void* b2,
                         const void* rec2, const GatesArgs& a, int R, int B, int H,
                         cudaStream_t stream, bool one_layer = false) {
  const dim3 grid((R + tile::M - 1) / tile::M, (4 * H + tile::N - 1) / tile::N,
                  (one_layer ? 1 : 2) * (V ? 2 : 1));
  stack_gates_kernel<T, ACT, V><<<grid, tile::THREADS, 0, stream>>>(
      static_cast<const T*>(xz1), static_cast<const T*>(rec1), static_cast<const T*>(k2),
      static_cast<const T*>(b2), static_cast<const T*>(rec2), a, R, B, H);
  return cudaGetLastError();
}

// Blocks a post-pass output tile (the adjoints' transposed products,
// lstm_stack_adj.cu and lstm_adj.cu) is split over: the most of 4, 2, 1
// that keeps the launch within POST_BLOCKS_PER_SM blocks an SM.  A split
// pays while the tiles alone would leave SMs idle, and costs its reduction
// once they fill the card (PERF.md).
constexpr int POST_BLOCKS_PER_SM = 12;
inline int post_splits(int tiles, int sms) {
  for (int s = 4; s > 1; s /= 2)
    if (s * tiles <= POST_BLOCKS_PER_SM * sms) return s;
  return 1;
}

}  // namespace hfrep
