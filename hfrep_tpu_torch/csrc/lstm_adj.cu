// Adjoint of the single-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm.py::_adj_kernel, launched through
// _adj_call without a carry (the VJP of lstm_bwd_seq, which is the
// WGAN-GP penalty's d/dtheta grad_x c term for each critic LSTM layer)
// and in its carry mode (the VJP of lstm_bwd_seq_carry).
// Given u = cot(dxz) and v = cot(drec) it returns the cotangents of the
// backward's inputs xz, rec, hs, cs and dhs.  It runs forward in time,
// t = 0 .. W-1 (the reverse of the backward's order), with the adjoint
// carries mu_h and mu_c (the cotangents of the backward's dh and dc
// carries) starting at zero.  Per step it recomputes the gates from
// h_{t-1} and the backward's dz from the saved carries dhT_t and dcT_t,
// then (the formulas of _adj_kernel, one for one):
//
//     dzbar  = u_t + mu_h . rec + h_{t-1} . v
//     zbar   = the cotangent of z through the gate math    -> uxz_t
//     dhTbar, dcTbar                                       -> udhs_t, next mu_h, mu_c
//     uhp    = dz . v^T + zbar . rec^T     (cot of h_{t-1}) -> uhs_{t-1}
//     ucp, uc (cots of c_{t-1}, c_t)                       -> ucs_{t-1}, ucs_t
//
// with _adj_call's output shift (uhs_t = uhp_{t+1}, ucs_t = uc_t +
// ucp_{t+1}, zero past the end), and then urec = sum_t mu_h^T dz +
// h_{t-1}^T zbar.
//
// Carry mode (template flag CARRY, and the post-pass's extra rows): the
// backward's final carries were (dh0, dc0), so their cotangents (mu_h0,
// mu_c0) seed mu_h and mu_c (null: zero); step 0's h_{t-1} and c_{t-1} are
// the injected h0 and c0; step 0's uhp and ucp, dropped without a carry,
// are cot(h0) and cot(c0); the last step's dcTbar is cot(dc_fin), the
// cotangent of the dc carry the backward started from; and urec's t = 0
// terms mu_h0^T dz_0 + h0^T zbar_0 come in through the reduction's head
// operands.  All (B, H), float32.  xz and rec are float32 or bf16; v, u
// and everything else float32.  As in the TPU kernel, the vectors dotted
// with rec or rec^T (h_{t-1}, mu_h, zbar) are rounded to the operand
// dtype first; the products with v and urec use float32.
//
// What bounds it.  At the penalty's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 12.15 MB (xz, u and uxz 2.46 MB each;
// hs, cs, dhT, dcT, uhs, ucs and udhs 0.61 MB each; rec, v and urec
// 0.16 MB each) — >= 3.6 us at 3.35 TB/s — and do 860 MFLOP (seven
// products of 2*W*B*H*4H) — >= 12.8 us at 67 TFLOP/s float32 (the carry
// mode adds seven (B, H) arrays, 90 KB).  Neither sets the pace: mu_h of
// step t feeds step t+1 through mu_h . rec, so the sweep is W dependent
// steps.  Only round(mu_h) . rec is on that chain: the gates, h_{t-1} . v
// and dz read saved states alone, and the transposed products and urec
// are outputs that no later step reads.
//
// The register layout, for H <= 4*KS = 100, which every preset width takes
// (lstm_stack_adj.cu's cluster on one layer: its block 0 without the ring
// and without k2, as lstm_bwd.cu's sweep is lstm_stack_bwd.cu's):
// - The pre-pass (lstm_stack.cuh's stack_gates_kernel, its first layer's
//   gate and v-stream products) forms, for all W*B rows at once in tiled
//   float32 products, every step's gates and the chain-free part of dzbar,
//   base = u + h_{t-1} . v (unrounded states: v is float32), h0 the head
//   of h_{t-1} in the carry mode (no tensor cores: TF32 or bf16 products
//   of float32 operands would break the float32 bars).  The gates go into
//   uxz, where the sweep writes zbar later, the base into the dz
//   workspace, where it writes dz.
// - The sweep (lstm_adj_kernel): one block of 416 threads a batch row (or
//   a few, walked one after another), a quad a hidden unit j, thread (j,
//   q) holding k-quarter q of unit j's four gate columns of rec (the
//   cluster layout, hfrep::cl), KR of its 25 rows in registers and the
//   rest in shared memory.  Lane q starts gate q's sum at its base and adds
//   its k-quarter of round(mu_h) . rec; after the quad's butterfly every
//   lane holds the same bits of unit j's four dzbar and runs the unit's
//   adj_step itself (hfrep::adj), so mu_c and dhTbar stay in the quad and
//   a step has one block barrier (round(mu_h) double-buffered by step
//   parity).  Each lane stages its gate, its base and one of (c_t,
//   c_{t-1} — c0 at t = 0 in the carry mode — dhT, dcT) a step ahead with
//   cp.async, which holds no registers.  It writes zbar (into uxz), dz
//   (float32, into the workspace), udhs and ucs, the c-shift in
//   registers.  Loop offsets are 32-bit.
// - Registers: ptxas grants the 13 warps 128 registers a thread; KR is the
//   most rows that spill in no instantiation (tools/
//   torch_stack_fwd_sweep.py --kernel lstm_adj --rows), and the build
//   phase of chip_smoke.py fails on a spill.
// - The post-pass (lstm_adj_post_kernel) forms the transposed products
//   over all rows, the h-shift in its row reads: uhs_t = dz_{t+1} . v^T +
//   round(zbar_{t+1}) . rec^T, reading rec and v by rows (no transposed
//   copies), and in the carry mode first the row t = -1, uh0.  Where the
//   output has few tiles (48 at W=48, B=32), a tile's depth is split over
//   a cluster of two or four blocks that add their partial tiles through
//   distributed shared memory in split order.
// A width rec's rows cannot be dealt out to (100 < H) runs the wide layout
// (lstm_adj_wide_kernel), the port's first adjoint, unchanged: one block
// owns a tile of batch rows and walks all W steps, as the TPU's sequential
// grid did, everything above on the chain.  rec and v cannot both sit in
// one block's shared memory (2 x 160,000 B in float32 at H=100 against
// 232,448 B, and v is always float32), so rec sits in dynamic shared memory
// with a one-entry row pad, read by columns (the recompute and mu_h . rec)
// and by rows (zbar . rec^T) without bank conflicts, and v (160 KB) is read
// from global memory, where it stays resident in the 50 MB L2: by columns
// for h_{t-1} . v, coalesced, and by rows for dz . v^T.  h_{t-1}, mu_h, dz
// and zbar of the tile's rows are staged in shared memory, two block
// barriers a step.  The wrapper chooses the layout by a rule on (H, dtype,
// B, SMs) (cuda_lstm.adj_layout) and passes it here; it never tries one and
// falls back.  In both layouts urec is reduced after the sweep by
// weight_sum.cuh over the W*B rows the sweep wrote (udhs is mu_h moved one
// step; dz goes to a workspace), deterministically and without atomics.

#include <cooperative_groups.h>

#include "lstm_stack.cuh"
#include "weight_sum.cuh"

namespace {

using namespace hfrep;

template <typename T, int ACT, bool CARRY>
__global__ void lstm_adj_wide_kernel(const T* __restrict__ xz,
                                const T* __restrict__ rec,
                                const float* __restrict__ v,
                                const float* __restrict__ hs,
                                const float* __restrict__ cs,
                                const float* __restrict__ dhT,
                                const float* __restrict__ dcT,
                                const float* __restrict__ u,
                                const float* __restrict__ h0,     // CARRY
                                const float* __restrict__ c0,     // CARRY
                                const float* __restrict__ muh0,   // CARRY, nullable
                                const float* __restrict__ muc0,   // CARRY, nullable
                                float* __restrict__ uxz,
                                float* __restrict__ uhs,
                                float* __restrict__ ucs,
                                float* __restrict__ udhs,
                                float* __restrict__ dzw,
                                float* __restrict__ udcfin,       // CARRY
                                float* __restrict__ uh0,          // CARRY
                                float* __restrict__ uc0,          // CARRY
                                int W, int B, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  const int ld = G + 1;
  T* rec_s = reinterpret_cast<T*>(smem_raw);                          // H x ld
  float* hp_s = reinterpret_cast<float*>(smem_raw + rec_smem_bytes(H, sizeof(T)));
  float* mu_s = hp_s + static_cast<size_t>(rows) * H;                 // rows x H
  float* dz_s = mu_s + static_cast<size_t>(rows) * H;                 // rows x G
  float* zb_s = dz_s + static_cast<size_t>(rows) * G;                 // rows x G

  const int tid = threadIdx.x;
  for (int i = tid; i < H * G; i += blockDim.x) {
    const int k = i / G;
    rec_s[static_cast<size_t>(k) * ld + (i - k * G)] = rec[i];
  }

  const int bl = tid / H;
  const int j = tid - bl * H;
  const int b = blockIdx.x * rows + bl;
  const bool live = bl < rows && b < B;
  const size_t hstep = static_cast<size_t>(B) * H;
  float* hp_row = hp_s + bl * H;
  float* mu_row = mu_s + bl * H;
  float* dz_row = dz_s + static_cast<size_t>(bl) * G;
  float* zb_row = zb_s + static_cast<size_t>(bl) * G;
  const size_t st = static_cast<size_t>(live ? b : 0) * H + j;   // (B, H) carry
  float muh = CARRY && live && muh0 != nullptr ? muh0[st] : 0.f;
  float muc = CARRY && live && muc0 != nullptr ? muc0[st] : 0.f;
  float uc_prev = 0.f;

  for (int t = 0; t < W; ++t) {
    const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
    const size_t og4 = (static_cast<size_t>(t) * B + b) * G + j;
    if (live) {
      hp_row[j] = t > 0 ? hs[o - hstep] : (CARRY ? h0[st] : 0.f);
      mu_row[j] = round_to<T>(muh);
    }
    __syncthreads();
    if (live) {
      float zd[4] = {0.f, 0.f, 0.f, 0.f};   // h_{t-1} . rec
      float md[4] = {0.f, 0.f, 0.f, 0.f};   // mu_h . rec
      float vd[4] = {0.f, 0.f, 0.f, 0.f};   // h_{t-1} . v
      const T* col = rec_s + j;
      const float* vcol = v + j;
      for (int k = 0; k < H; ++k) {
        const float hk = hp_row[k];
        const float hkt = round_to<T>(hk);
        const float mk = mu_row[k];
        const T* r = col + static_cast<size_t>(k) * ld;
        const float* vr = vcol + static_cast<size_t>(k) * G;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float rv = to_f(r[g * H]);
          zd[g] = fmaf(hkt, rv, zd[g]);
          md[g] = fmaf(mk, rv, md[g]);
          vd[g] = fmaf(hk, vr[g * H], vd[g]);
        }
      }
      const T* xr = xz + og4;
      const float ig = sigmoid_f(to_f(xr[0]) + zd[0]);
      const float fg = sigmoid_f(to_f(xr[H]) + zd[1]);
      const float gc = act_f<ACT>(to_f(xr[2 * H]) + zd[2]);
      const float og = sigmoid_f(to_f(xr[3 * H]) + zd[3]);
      const float c_s = cs[o];
      const float cp = t > 0 ? cs[o - hstep] : (CARRY ? c0[st] : 0.f);
      const float a_c = act_f<ACT>(c_s);
      const float qi = ig * (1.0f - ig), qf = fg * (1.0f - fg), qo = og * (1.0f - og);
      const float pg = act_prime<ACT>(gc), pa = act_prime<ACT>(a_c);
      const float ppg = act_prime2<ACT>(gc), ppa = act_prime2<ACT>(a_c);
      const float dh = dhT[o];
      const float dc = dcT[o];

      // the backward's step (recomputed)
      const float d_out = dh * a_c;
      const float dz0 = dc * gc * qi;
      const float dz1 = dc * cp * qf;
      const float dz2 = dc * ig * pg;
      const float dz3 = d_out * qo;

      // its adjoint
      const float* ur = u + og4;
      const float dzbi = ur[0] + md[0] + vd[0];
      const float dzbf = ur[H] + md[1] + vd[1];
      const float dzbc = ur[2 * H] + md[2] + vd[2];
      const float dzbo = ur[3 * H] + md[3] + vd[3];
      float dcTbar = muc * fg;
      float fbar = muc * dc;
      dcTbar += dzbi * gc * qi;
      float gbar = dzbi * dc * qi;
      float ibar = dzbi * dc * gc * (1.0f - 2.0f * ig);
      dcTbar += dzbf * cp * qf;
      const float cpbar = dzbf * dc * qf;
      fbar += dzbf * dc * cp * (1.0f - 2.0f * fg);
      dcTbar += dzbc * ig * pg;
      ibar += dzbc * dc * pg;
      gbar += dzbc * dc * ig * ppg;
      const float dobar = dzbo * qo;
      float obar = dzbo * d_out * (1.0f - 2.0f * og);
      float dhTbar = dcTbar * og * pa;
      obar += dcTbar * dh * pa;
      float aCbar = dcTbar * dh * og * ppa;
      dhTbar += dobar * a_c;
      aCbar += dobar * dh;
      const float zb0 = ibar * qi, zb1 = fbar * qf, zb2 = gbar * pg, zb3 = obar * qo;

      float* uo = uxz + og4;
      uo[0] = zb0;
      uo[H] = zb1;
      uo[2 * H] = zb2;
      uo[3 * H] = zb3;
      float* dw = dzw + og4;
      dw[0] = dz0;
      dw[H] = dz1;
      dw[2 * H] = dz2;
      dw[3 * H] = dz3;
      udhs[o] = dhTbar;
      const float uc = aCbar * pa;
      if (t > 0) ucs[o - hstep] = uc_prev + cpbar;
      else if (CARRY) uc0[st] = cpbar;
      uc_prev = uc;
      dz_row[j] = dz0;
      dz_row[H + j] = dz1;
      dz_row[2 * H + j] = dz2;
      dz_row[3 * H + j] = dz3;
      zb_row[j] = round_to<T>(zb0);
      zb_row[H + j] = round_to<T>(zb1);
      zb_row[2 * H + j] = round_to<T>(zb2);
      zb_row[3 * H + j] = round_to<T>(zb3);
      muh = dhTbar;
      muc = dcTbar;
    }
    __syncthreads();
    if (live) {          // cot of h_{t-1}: dz . v^T + zbar . rec^T, row j
      const float* vr = v + static_cast<size_t>(j) * G;
      const T* rr = rec_s + static_cast<size_t>(j) * ld;
      float hpbar = 0.f, rb = 0.f;
      for (int m = 0; m < G; ++m) {
        hpbar = fmaf(dz_row[m], vr[m], hpbar);
        rb = fmaf(zb_row[m], to_f(rr[m]), rb);
      }
      if (t > 0) uhs[o - hstep] = hpbar + rb;
      else if (CARRY) uh0[st] = hpbar + rb;
    }
  }
  if (live) {
    const size_t last = (static_cast<size_t>(W - 1) * B + b) * H + j;
    uhs[last] = 0.f;
    ucs[last] = uc_prev;
    if (CARRY) udcfin[st] = muc;
  }
}

struct AdjArgs {
  const void* xz;
  const void* rec;
  const float* v;
  const float* hs;
  const float* cs;
  const float* dhT;
  const float* dcT;
  const float* u;
  const float* h0;     // null: no carry
  const float* c0;
  const float* muh0;   // null: zero
  const float* muc0;   // null: zero
  float* uxz;
  float* uhs;
  float* ucs;
  float* udhs;
  float* dzw;
  float* udcfin;
  float* uh0;
  float* uc0;
  int W, B, H, rows;
};

template <typename T, int ACT, bool CARRY>
cudaError_t launch_sweep(const AdjArgs& a, cudaStream_t stream) {
  const size_t smem = rec_smem_bytes(a.H, sizeof(T))
                      + static_cast<size_t>(a.rows) * 10 * a.H * sizeof(float);
  const int threads = ((a.rows * a.H + 31) / 32) * 32;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  cudaError_t e = cudaFuncSetAttribute(lstm_adj_wide_kernel<T, ACT, CARRY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_adj_wide_kernel<T, ACT, CARRY><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.xz), static_cast<const T*>(a.rec), a.v, a.hs, a.cs, a.dhT,
      a.dcT, a.u, a.h0, a.c0, a.muh0, a.muc0, a.uxz, a.uhs, a.ucs, a.udhs, a.dzw,
      a.udcfin, a.uh0, a.uc0, a.W, a.B, a.H, a.rows);
  return cudaGetLastError();
}

// ----------------------------------------------------- register layout
namespace ra {

using namespace cl;
using namespace adj;

// Of a thread's KS rows of rec, the first KR_F32 (float32) or KR_BF16
// (bf16) are held in registers, the rest in shared memory: ptxas grants 13
// warps 128 registers a thread, and the counts that spill in no
// instantiation are found by compiling them
// (tools/torch_stack_fwd_sweep.py --kernel lstm_adj --rows).
constexpr int KR_F32 = 21, KR_BF16 = 21;
template <typename T>
struct Keep {
  static constexpr int r = KR_F32;
};
template <>
struct Keep<__nv_bfloat16> {
  static constexpr int r = KR_BF16;
};

// The fixed part of the block's shared memory, in floats: two h buffers
// (step parity), each thread's NST step inputs for two steps, the rows of
// rec past KR (a float4 a thread each).
__host__ __device__ constexpr int fixed_floats(size_t item) {
  return 8 * KSP + 2 * NST * THREADS + 4 * (KS - (item == 4 ? KR_F32 : KR_BF16)) * THREADS;
}

// then a staging area for a PARTS-th of rec's rows, for the prologue
constexpr int PARTS = 2;
__host__ __device__ inline size_t smem_bytes(int H, size_t item) {
  return fixed_floats(item) * sizeof(float)
         + static_cast<size_t>((H + PARTS - 1) / PARTS) * 4 * H * item;
}

}  // namespace ra

// Launched after the pre-pass has written the gates into uxz and the bases
// into dzw, one block of cl::THREADS threads walking batch rows
// blockIdx.x * rows .. + rows - 1 one after another, all W steps each.
template <typename T, int ACT, bool CARRY>
__global__ void __launch_bounds__(cl::THREADS, 1)
lstm_adj_kernel(const T* __restrict__ rec, AdjArgs a) {
  using namespace ra;
  constexpr int KR = Keep<T>::r;
  extern __shared__ __align__(16) float fsm[];
  float* h_s = fsm;                          // round(mu_h): 2 buffers (step parity) x 4 x KSP
  float* step_s = h_s + 8 * KSP;             // step inputs: 2 (step parity) x THREADS x NST
  float4* rec_s = reinterpret_cast<float4*>(step_s + 2 * NST * THREADS);   // rows kk >= KR
  T* stage = reinterpret_cast<T*>(fsm + fixed_floats(sizeof(T)));
  const int W = a.W, B = a.B, H = a.H, G = 4 * H;
  const int tid = threadIdx.x;
  const int q = tid & 3;                     // k-quarter; gate q's sum; state stream q
  const int j = (tid >> 5) * 8 + ((tid & 31) >> 2);   // hidden unit
  const int base = tid & 28;                 // the quad's first lane
  const bool unit = j < H;
  const int hpos = (j / KS) * KSP + j % KS;  // unit j's entry in an h buffer

  // h buffers start at zero; positions past H and the pads stay zero,
  // multiplied by zero weights.  rec, a PARTS-th of its rows at a time:
  // rows kk < KR into registers, the rest into shared memory.
  for (int i = tid; i < 8 * KSP; i += THREADS) h_s[i] = 0.0f;
  float w[4][KR];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g][kk] = 0.0f;
  for (int kk = 0; kk < KS - KR; ++kk) rec_s[kk * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int part = (H + PARTS - 1) / PARTS;
  for (int lo = 0; lo < H; lo += part) {
    const int n = min(part, H - lo);
    copy_issue<THREADS>(rec + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    deal_rec<T, KR>(stage, lo, n, H, q, j, unit, w, rec_s);
    __syncthreads();                         // the staged rows are read
  }

  // 32-bit element offsets (the launch checks that W*B*4H fits)
  const int xstep = B * G;
  const int ostep = B * H;
  const int back = q == 1 ? ostep : 0;       // lane 1 reads c_{t-1}
  const float* sp = q < 2 ? a.cs : q == 2 ? a.dhT : a.dcT;
  for (int r = 0; r < a.rows; ++r) {
    const int b = blockIdx.x * a.rows + r;
    if (b >= B) break;                       // the same for the whole block
    __syncthreads();                         // the last row's reads are done
    const int sb = b * H + (unit ? j : 0);   // (B, H) offset of the carry-mode arrays
    const float* first = CARRY ? a.c0 + sb : nullptr;
    if (unit && q == 0)                      // round(mu_h) of step 0
      h_s[hpos] = CARRY && a.muh0 != nullptr ? round_to<T>(a.muh0[sb]) : 0.0f;
    float muc = CARRY && a.muc0 != nullptr ? a.muc0[sb] : 0.0f;
    float uc_prev = 0.0f;
    int o = b * H + (unit ? j : 0);          // (W, B, H) offset of step t
    int og = b * G + (unit ? q * H + j : 0);   // gate q's, (W, B, 4H)
    stage_step(step_s + tid * NST, a.uxz, a.dzw, og, sp, o, back, 0, unit, first);
    __syncthreads();
    for (int t = 0; t < W; ++t) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      const float* st = step_s + ((t & 1) * THREADS + tid) * NST;
      const float gq = st[0], bq = st[1], sq = st[2];
      if (t + 1 < W)
        stage_step(step_s + (((t + 1) & 1) * THREADS + tid) * NST, a.uxz, a.dzw, og + xstep,
                   sp, o + ostep, back, t + 1, unit, first);
      // dzbar = base + round(mu_h) . rec: lane q's k-quarter, gate q's base
      float acc[4], acc2[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = g == q ? bq : 0.0f, acc2[g] = 0.0f;
      dot_rec<KR>(reinterpret_cast<const float4*>(h_s + (t & 1) * 4 * KSP + q * KSP), w, rec_s,
                  tid, acc, acc2);
      float dzb[4];
      quad_sums(acc, acc2, dzb);
      const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
      const float gc = from_lane(gq, base, 2), ogt = from_lane(gq, base, 3);
      const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
      const float dh = from_lane(sq, base, 2), dc = from_lane(sq, base, 3);
      float dz[4], zb[4], dhTbar, dcTbar, cpbar, cbar;
      adj_step<ACT>(ig, fg, gc, ogt, c, cp, dh, dc, muc, dzb, dz, zb, &dhTbar, &dcTbar, &cpbar,
                    &cbar);
      muc = dcTbar;
      if (unit) {
        a.uxz[og] = pick(zb, q);
        a.dzw[og] = pick(dz, q);
        if (q == 0) {
          a.udhs[o] = dhTbar;
          h_s[((t + 1) & 1) * 4 * KSP + hpos] = round_to<T>(dhTbar);
        }
        if (q == 1) {                        // ucs_{t-1} = uc_{t-1} + ucp_t; cot(c0) at t = 0
          if (t > 0) a.ucs[o - ostep] = uc_prev + cpbar;
          else if (CARRY) a.uc0[sb] = cpbar;
        }
      }
      uc_prev = cbar;
      o += ostep;
      og += xstep;
      __syncthreads();
    }
    if (unit && q == 1) a.ucs[o - ostep] = uc_prev;   // step W-1: nothing after it
    if (CARRY && unit && q == 0) a.udcfin[sb] = muc;   // the last dcTbar: cot(dc_fin)
  }
}

// The transposed products, off the chain, over the rows of the output,
// with _adj_call's h-shift in the row reads (terms of step W are zero):
//   uhs_t = dz_{t+1} . v^T + round(zbar_{t+1}) . rec^T
// and in the carry mode (uh0 not null) first the row t = -1, uh0 = dz_0 .
// v^T + round(zbar_0) . rec^T: output row i reads the W*B input rows'
// row i + lo, lo = B (0 in the carry mode), and writes uh0 below B, uhs
// from there.  A row's vector is dz's row, then zbar's, each padded to a
// whole number of k pieces; v and rec are read by rows (tile::product's
// transposed B).  One output tile a cluster of `splits` (1, 2 or 4) blocks
// along blockIdx.z: block `split` sums a splits-th of the pieces, then adds
// rows split, split + splits, ... of every thread's 4 x 4 tile over the
// cluster's blocks, in split order, through distributed shared memory: no
// atomics.  A row's sum is the same in both modes.
template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
lstm_adj_post_kernel(const T* __restrict__ rec, const float* __restrict__ v,
                     const float* __restrict__ dz, const float* __restrict__ zb,
                     float* __restrict__ uhs, float* __restrict__ uh0, int R, int B, int H) {
  using namespace tile;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(16) Smem s;
  __shared__ float4 sums[4][THREADS];       // row i of each thread's 4 x 4 tile
  const int G = 4 * H, seg = (G + K - 1) / K * K;
  const int lo = uh0 != nullptr ? 0 : B;
  const int m0 = blockIdx.x * M + lo, n0 = blockIdx.y * N;
  const int tid = threadIdx.x;
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  auto piece = [&](int k0, float (&va)[LA], float (&vb)[LB]) {
    const int c0 = k0 % seg;
    const bool zterm = k0 >= seg;            // round(zbar) . rec^T, else dz . v^T
    const float* av = zterm ? zb : dz;
    // each load loop reads one type, and the rounding follows the loads, so
    // that a piece's loads are all in flight at once
#pragma unroll
    for (int u = 0; u < LA; ++u) {
      const int i = tid + u * THREADS;
      const int c = c0 + i % K, row = m0 + i / K;
      va[u] = row < R && c < G ? av[row * G + c] : 0.0f;
    }
    if (zterm) {
#pragma unroll
      for (int u = 0; u < LA; ++u) va[u] = round_to<T>(va[u]);
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int c = c0 + i % K, n = n0 + i / K;
        vb[u] = c < G && n < H ? to_f(rec[n * G + c]) : 0.0f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int c = c0 + i % K, n = n0 + i / K;
        vb[u] = c < G && n < H ? v[n * G + c] : 0.0f;
      }
    }
  };
  const int pieces = 2 * seg / K, per = (pieces + splits - 1) / splits;
  float acc[4][4];
  product<true>(piece, min(split * per, pieces) * K, min((split + 1) * per, pieces) * K, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) sums[i][tid] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  const int tx = tid % (N / 4), ty = tid / (N / 4);
  for (int i = split; i < 4; i += splits) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < splits; ++b) {
      const float4 p = cluster.map_shared_rank(&sums[i][0], b)[tid];
      t = b == 0 ? p : make_float4(t.x + p.x, t.y + p.y, t.z + p.z, t.w + p.w);
    }
    const int r = m0 + 4 * ty + i;           // input row; output row r - B
    const float tv[4] = {t.x, t.y, t.z, t.w};
    if (r < R + B)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + 4 * tx + jj;
        if (n < H) (r < B ? uh0 + r * H : uhs + (r - B) * H)[n] = tv[jj];
      }
  }
  cluster.sync();                            // no block leaves while another reads its sums
}

// the post-pass over the output's rows: W*B, and B more (uh0) in the carry
// mode; the split is the carry-free launch's, so both modes give a row the
// same bits
template <typename T>
cudaError_t launch_post(const AdjArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int R = a.W * a.B, rows = R + (a.uh0 != nullptr ? a.B : 0);
  const int ty = (a.H + tile::N - 1) / tile::N;
  const int splits = post_splits(((R + tile::M - 1) / tile::M) * ty, sms);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + tile::M - 1) / tile::M, ty, splits);
  cfg.blockDim = dim3(tile::THREADS, 1, 1);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lstm_adj_post_kernel<T>, static_cast<const T*>(a.rec), a.v,
                            static_cast<const float*>(a.dzw), static_cast<const float*>(a.uxz),
                            a.uhs, a.uh0, R, a.B, a.H);
}

// the pre-pass, the sweep, then the post-pass
template <typename T, int ACT, bool CARRY>
cudaError_t launch_registers(const AdjArgs& a, cudaStream_t stream) {
  if (a.H > 4 * cl::KS || static_cast<long long>(a.W) * a.B * 4 * a.H >= (1LL << 31))
    return cudaErrorInvalidValue;                // the layout's width, its 32-bit offsets
  GatesArgs g{};
  g.hs1 = a.hs, g.g1 = a.uxz, g.u1 = a.u, g.vr1 = a.v, g.v1 = a.dzw, g.h0 = a.h0;
  cudaError_t e = launch_gates<T, ACT, true>(a.xz, a.rec, nullptr, nullptr, nullptr, g,
                                             a.W * a.B, a.B, a.H, stream, true);
  if (e != cudaSuccess) return e;
  const size_t smem = ra::smem_bytes(a.H, sizeof(T));
  e = cudaFuncSetAttribute(lstm_adj_kernel<T, ACT, CARRY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_adj_kernel<T, ACT, CARRY><<<(a.B + a.rows - 1) / a.rows, cl::THREADS, smem, stream>>>(
      static_cast<const T*>(a.rec), a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_post<T>(a, stream);
}

enum { LAYOUT_REGISTERS = 0, LAYOUT_WIDE = 1 };

template <typename T, int ACT, bool CARRY>
cudaError_t launch_layout(const AdjArgs& a, int layout, cudaStream_t s) {
  if (layout == LAYOUT_WIDE) return launch_sweep<T, ACT, CARRY>(a, s);
  if (layout == LAYOUT_REGISTERS) return launch_registers<T, ACT, CARRY>(a, s);
  return cudaErrorInvalidValue;
}

template <typename T, bool CARRY>
cudaError_t launch_act(const AdjArgs& a, int act, int layout, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR: return launch_layout<T, ACT_LINEAR, CARRY>(a, layout, s);
    case ACT_SIGMOID: return launch_layout<T, ACT_SIGMOID, CARRY>(a, layout, s);
    case ACT_TANH: return launch_layout<T, ACT_TANH, CARRY>(a, layout, s);
    default: return cudaErrorInvalidValue;
  }
}

// The sweep in `layout` (0 registers, 1 wide; `threads` the block's
// threads), then urec = sum mu_h^T dz + h_{t-1}^T zbar over the W*B rows
// (in carry mode mu_h0 and h0 are the heads of mu_h and h_{t-1}), all on
// `stream`.
int run(const AdjArgs& a, void* urec, int act, int bf16, int device, void* stream, int layout,
        int threads) {
  const int want = layout == LAYOUT_REGISTERS ? cl::THREADS : ((a.rows * a.H + 31) / 32) * 32;
  if (threads != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool carry = a.h0 != nullptr;
  if (bf16)
    e = carry ? launch_act<__nv_bfloat16, true>(a, act, layout, s)
              : launch_act<__nv_bfloat16, false>(a, act, layout, s);
  else
    e = carry ? launch_act<float, true>(a, act, layout, s)
              : launch_act<float, false>(a, act, layout, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ws::Batch sum{};
  sum.n = 1;
  sum.s[0] = ws::sum_of(static_cast<float*>(urec), a.B, a.udhs, a.dzw, a.muh0, a.hs, a.uxz,
                        a.h0);
  e = ws::weight_sums(sum, 2, a.W * a.B, a.H, 4 * a.H, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// The sweep and urec on `stream`.  `dzw` is a (W, B, 4H) float32
// workspace for dz.  `layout` (0 registers, 1 wide), `threads` and `rows`
// (batch rows a block) are the wrapper's launch rule (cuda_lstm.adj_layout).
// Returns the first CUDA error of a launch (0 = ok).
int hfrep_lstm_adj(const void* xz, const void* rec, const void* v, const void* hs,
                   const void* cs, const void* dhT, const void* dcT, const void* u,
                   void* uxz, void* uhs, void* ucs, void* udhs, void* urec,
                   void* dzw, int W, int B, int H, int act, int bf16, int rows,
                   int device, void* stream, int layout, int threads) {
  const AdjArgs a{xz, rec, static_cast<const float*>(v), static_cast<const float*>(hs),
                  static_cast<const float*>(cs), static_cast<const float*>(dhT),
                  static_cast<const float*>(dcT), static_cast<const float*>(u),
                  nullptr, nullptr, nullptr, nullptr, static_cast<float*>(uxz),
                  static_cast<float*>(uhs), static_cast<float*>(ucs),
                  static_cast<float*>(udhs), static_cast<float*>(dzw), nullptr, nullptr,
                  nullptr, W, B, H, rows};
  return run(a, urec, act, bf16, device, stream, layout, threads);
}

// The carry mode: h0, c0 (B, H) the injected state, muh0 and muc0 (B, H;
// null: zero) the cotangents of the backward's dh0 and dc0; cot(dc_fin),
// cot(h0) and cot(c0) go to udcfin, uh0 and uc0 (B, H).
int hfrep_lstm_adj_carry(const void* xz, const void* rec, const void* v,
                         const void* hs, const void* cs, const void* dhT,
                         const void* dcT, const void* u, const void* h0,
                         const void* c0, const void* muh0, const void* muc0,
                         void* uxz, void* uhs, void* ucs, void* udhs, void* urec,
                         void* dzw, void* udcfin, void* uh0, void* uc0, int W, int B,
                         int H, int act, int bf16, int rows, int device, void* stream,
                         int layout, int threads) {
  if (h0 == nullptr || c0 == nullptr || udcfin == nullptr || uh0 == nullptr ||
      uc0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdjArgs a{xz, rec, static_cast<const float*>(v), static_cast<const float*>(hs),
                  static_cast<const float*>(cs), static_cast<const float*>(dhT),
                  static_cast<const float*>(dcT), static_cast<const float*>(u),
                  static_cast<const float*>(h0), static_cast<const float*>(c0),
                  static_cast<const float*>(muh0), static_cast<const float*>(muc0),
                  static_cast<float*>(uxz), static_cast<float*>(uhs),
                  static_cast<float*>(ucs), static_cast<float*>(udhs),
                  static_cast<float*>(dzw), static_cast<float*>(udcfin),
                  static_cast<float*>(uh0), static_cast<float*>(uc0), W, B, H, rows};
  return run(a, urec, act, bf16, device, stream, layout, threads);
}

}  // extern "C"
