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
// with _adj_call's output shift done in place (uhs_t = uhp_{t+1},
// ucs_t = uc_t + ucp_{t+1}, zero past the end), and then
// urec = sum_t mu_h^T dz + h_{t-1}^T zbar.
//
// Carry mode (template flag CARRY; the carry-free instantiation is the
// code it was before the mode existed): the backward's final carries were
// (dh0, dc0), so their cotangents (mu_h0, mu_c0) seed mu_h and mu_c
// (null: zero); step 0's h_{t-1} and c_{t-1} are the injected h0 and c0;
// step 0's uhp and ucp, dropped without a carry, are cot(h0) and cot(c0);
// the last step's dcTbar is cot(dc_fin), the cotangent of the dc carry the
// backward started from; and urec's t = 0 terms mu_h0^T dz_0 + h0^T zbar_0
// come in through the reduction's head operands.  All (B, H), float32.  xz and rec are float32 or
// bf16; v, u and everything else float32.  As in the TPU kernel, the
// vectors dotted with rec or rec^T (h_{t-1}, mu_h, zbar) are rounded to
// the operand dtype first; the products with v and urec use float32.
//
// What bounds it.  At the penalty's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 12.15 MB (xz, u and uxz 2.46 MB each;
// hs, cs, dhT, dcT, uhs, ucs and udhs 0.61 MB each; rec, v and urec
// 0.16 MB each) — >= 3.6 us at 3.35 TB/s — and do 860 MFLOP (seven
// products of 2*W*B*H*4H) — >= 12.8 us at 67 TFLOP/s float32 (the carry
// mode adds seven (B, H) arrays, 90 KB).  Neither sets the pace: mu_h of
// step t feeds step t+1 through mu_h . rec, so the sweep is W dependent
// steps.
//
// What the design does about it.  One block owns a tile of batch rows and
// walks all W steps, as the TPU's sequential grid did.  rec and v cannot
// both sit in one block's shared memory (2 x 160,000 B in float32 at
// H=100 against 232,448 B, and v is always float32), so rec sits in
// dynamic shared memory with a one-entry row pad, read by columns (the
// recompute and mu_h . rec) and by rows (zbar . rec^T) without bank
// conflicts, and v (160 KB) is read from global memory, where it stays
// resident in the 50 MB L2: by columns for h_{t-1} . v, coalesced, and
// by rows for dz . v^T.  Only mu_h . rec is on the serial chain; the
// other products are independent of the carries and share its loop.
// h_{t-1}, mu_h, dz and zbar of the tile's rows are staged in shared
// memory, two block barriers a step.  urec is reduced afterwards by a
// second kernel over the W*B rows the sweep wrote (udhs is mu_h moved
// one step; dz goes to a workspace), deterministically and without
// atomics (weight_sum.cuh).

#include "weight_sum.cuh"

namespace {

using namespace hfrep;

template <typename T, int ACT, bool CARRY>
__global__ void lstm_adj_kernel(const T* __restrict__ xz,
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
  cudaError_t e = cudaFuncSetAttribute(lstm_adj_kernel<T, ACT, CARRY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_adj_kernel<T, ACT, CARRY><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.xz), static_cast<const T*>(a.rec), a.v, a.hs, a.cs, a.dhT,
      a.dcT, a.u, a.h0, a.c0, a.muh0, a.muc0, a.uxz, a.uhs, a.ucs, a.udhs, a.dzw,
      a.udcfin, a.uh0, a.uc0, a.W, a.B, a.H, a.rows);
  return cudaGetLastError();
}

template <typename T, bool CARRY>
cudaError_t launch_act(const AdjArgs& a, int act, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR: return launch_sweep<T, ACT_LINEAR, CARRY>(a, s);
    case ACT_SIGMOID: return launch_sweep<T, ACT_SIGMOID, CARRY>(a, s);
    case ACT_TANH: return launch_sweep<T, ACT_TANH, CARRY>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The sweep, then urec = sum mu_h^T dz + h_{t-1}^T zbar over the W*B rows
// (in carry mode mu_h0 and h0 are the heads of mu_h and h_{t-1}), both on
// `stream`.
int run(const AdjArgs& a, void* urec, int act, int bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool carry = a.h0 != nullptr;
  if (bf16)
    e = carry ? launch_act<__nv_bfloat16, true>(a, act, s)
              : launch_act<__nv_bfloat16, false>(a, act, s);
  else
    e = carry ? launch_act<float, true>(a, act, s) : launch_act<float, false>(a, act, s);
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
// workspace for dz.  Returns the first CUDA error of a launch (0 = ok).
int hfrep_lstm_adj(const void* xz, const void* rec, const void* v, const void* hs,
                   const void* cs, const void* dhT, const void* dcT, const void* u,
                   void* uxz, void* uhs, void* ucs, void* udhs, void* urec,
                   void* dzw, int W, int B, int H, int act, int bf16, int rows,
                   int device, void* stream) {
  const AdjArgs a{xz, rec, static_cast<const float*>(v), static_cast<const float*>(hs),
                  static_cast<const float*>(cs), static_cast<const float*>(dhT),
                  static_cast<const float*>(dcT), static_cast<const float*>(u),
                  nullptr, nullptr, nullptr, nullptr, static_cast<float*>(uxz),
                  static_cast<float*>(uhs), static_cast<float*>(ucs),
                  static_cast<float*>(udhs), static_cast<float*>(dzw), nullptr, nullptr,
                  nullptr, W, B, H, rows};
  return run(a, urec, act, bf16, device, stream);
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
                         int H, int act, int bf16, int rows, int device, void* stream) {
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
  return run(a, urec, act, bf16, device, stream);
}

}  // extern "C"
