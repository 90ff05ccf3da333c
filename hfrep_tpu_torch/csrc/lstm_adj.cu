// Adjoint of the single-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm.py::_adj_kernel, launched through
// _adj_call without a carry: the VJP of lstm_bwd_seq, which is the
// WGAN-GP penalty's d/dtheta grad_x c term for each critic LSTM layer.
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
// urec = sum_t mu_h^T dz + h_{t-1}^T zbar.  xz and rec are float32 or
// bf16; v, u and everything else float32.  As in the TPU kernel, the
// vectors dotted with rec or rec^T (h_{t-1}, mu_h, zbar) are rounded to
// the operand dtype first; the products with v and urec use float32.
//
// What bounds it.  At the penalty's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 12.15 MB (xz, u and uxz 2.46 MB each;
// hs, cs, dhT, dcT, uhs, ucs and udhs 0.61 MB each; rec, v and urec
// 0.16 MB each) — >= 3.6 us at 3.35 TB/s — and do 860 MFLOP (seven
// products of 2*W*B*H*4H) — >= 12.8 us at 67 TFLOP/s float32.  Neither
// sets the pace: mu_h of step t feeds step t+1 through mu_h . rec, so the
// sweep is W dependent steps.
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
// atomics (lstm_common.cuh: outer_sum).

#include "lstm_common.cuh"

namespace {

using namespace hfrep;

template <typename T, int ACT>
__global__ void lstm_adj_kernel(const T* __restrict__ xz,
                                const T* __restrict__ rec,
                                const float* __restrict__ v,
                                const float* __restrict__ hs,
                                const float* __restrict__ cs,
                                const float* __restrict__ dhT,
                                const float* __restrict__ dcT,
                                const float* __restrict__ u,
                                float* __restrict__ uxz,
                                float* __restrict__ uhs,
                                float* __restrict__ ucs,
                                float* __restrict__ udhs,
                                float* __restrict__ dzw,
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
  float muh = 0.f, muc = 0.f, uc_prev = 0.f;

  for (int t = 0; t < W; ++t) {
    const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
    const size_t og4 = (static_cast<size_t>(t) * B + b) * G + j;
    if (live) {
      hp_row[j] = t > 0 ? hs[o - hstep] : 0.f;
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
      const float cp = t > 0 ? cs[o - hstep] : 0.f;
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
    }
  }
  if (live) {
    const size_t last = (static_cast<size_t>(W - 1) * B + b) * H + j;
    uhs[last] = 0.f;
    ucs[last] = uc_prev;
  }
}

template <typename T, int ACT>
cudaError_t launch_sweep(const void* xz, const void* rec, const float* v,
                         const float* hs, const float* cs, const float* dhT,
                         const float* dcT, const float* u, float* uxz, float* uhs,
                         float* ucs, float* udhs, float* dzw, int W, int B, int H,
                         int rows, cudaStream_t stream) {
  const size_t smem = rec_smem_bytes(H, sizeof(T))
                      + static_cast<size_t>(rows) * 10 * H * sizeof(float);
  const int threads = ((rows * H + 31) / 32) * 32;
  const int blocks = (B + rows - 1) / rows;
  cudaError_t e = cudaFuncSetAttribute(lstm_adj_kernel<T, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_adj_kernel<T, ACT><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(xz), static_cast<const T*>(rec), v, hs, cs, dhT, dcT,
      u, uxz, uhs, ucs, udhs, dzw, W, B, H, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(int act, const void* xz, const void* rec, const float* v,
                       const float* hs, const float* cs, const float* dhT,
                       const float* dcT, const float* u, float* uxz, float* uhs,
                       float* ucs, float* udhs, float* dzw, int W, int B, int H,
                       int rows, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR:
      return launch_sweep<T, ACT_LINEAR>(xz, rec, v, hs, cs, dhT, dcT, u, uxz, uhs,
                                         ucs, udhs, dzw, W, B, H, rows, s);
    case ACT_SIGMOID:
      return launch_sweep<T, ACT_SIGMOID>(xz, rec, v, hs, cs, dhT, dcT, u, uxz, uhs,
                                          ucs, udhs, dzw, W, B, H, rows, s);
    case ACT_TANH:
      return launch_sweep<T, ACT_TANH>(xz, rec, v, hs, cs, dhT, dcT, u, uxz, uhs,
                                       ucs, udhs, dzw, W, B, H, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The sweep, then urec = sum mu_h^T dz + h_{t-1}^T zbar over the W*B
// rows, both on `stream`.  `dzw` is a (W, B, 4H) float32 workspace for
// dz; `part` holds splits x H x 4H floats when splits > 1.  Returns the
// first CUDA error of a launch (0 = ok).
int hfrep_lstm_adj(const void* xz, const void* rec, const void* v, const void* hs,
                   const void* cs, const void* dhT, const void* dcT, const void* u,
                   void* uxz, void* uhs, void* ucs, void* udhs, void* urec,
                   void* dzw, void* part, int W, int B, int H, int act, int bf16,
                   int rows, int splits, int rows_per_split, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v_f = static_cast<const float*>(v);
  const float* hs_f = static_cast<const float*>(hs);
  const float* cs_f = static_cast<const float*>(cs);
  const float* dhT_f = static_cast<const float*>(dhT);
  const float* dcT_f = static_cast<const float*>(dcT);
  const float* u_f = static_cast<const float*>(u);
  float* uxz_f = static_cast<float*>(uxz);
  float* udhs_f = static_cast<float*>(udhs);
  float* dzw_f = static_cast<float*>(dzw);
  e = bf16 ? launch_act<__nv_bfloat16>(act, xz, rec, v_f, hs_f, cs_f, dhT_f, dcT_f,
                                      u_f, uxz_f, static_cast<float*>(uhs),
                                      static_cast<float*>(ucs), udhs_f, dzw_f, W, B,
                                      H, rows, s)
           : launch_act<float>(act, xz, rec, v_f, hs_f, cs_f, dhT_f, dcT_f, u_f,
                               uxz_f, static_cast<float*>(uhs),
                               static_cast<float*>(ucs), udhs_f, dzw_f, W, B, H,
                               rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = outer_sum<2>(udhs_f, dzw_f, hs_f, uxz_f, static_cast<float*>(urec),
                   static_cast<float*>(part), W * B, B, H, 4 * H, splits,
                   rows_per_split, s);
  return static_cast<int>(e);
}

}  // extern "C"
