// Adjoint of the fused two-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm_stack.py::_stack_adj_kernel,
// launched through _stack_adj_call: the VJP of stack_bwd_seq, which is the
// WGAN-GP penalty's d/dtheta grad_x c term for the MTSS critics' stack.
// Given u1 = cot(dxz1) and v = (vr1, vk2, vb2, vr2) = cot(drec1, dk2,
// db2, drec2), it returns the cotangents of the backward's inputs xz1,
// rec1, k2, b2, rec2, hs1, cs1, hs2, cs2 and dhs2.  It runs forward in
// time (the backward's reverse) with the adjoint carries mu_h1, mu_c1,
// mu_h2, mu_c2 starting at zero, recomputing both layers' gates and the
// backward's dz from the saved carries dhT1, dcT1, dhT2, dcT2.  Per step,
// layer 1 first (it ran last in the backward's step), each layer the
// single-layer adjoint of lstm_adj.cu (the formulas of adj_layer):
//
//     dzbar1 = u1_t + mu_h1 . rec1 + h1_{t-1} . vr1   -> zbar1 = uxz1_t, dhTbar1, ...
//     uh1p   = dz1 . vr1^T + zbar1 . rec1^T           (cot of h1_{t-1})
//     u2     = dhTbar1 . k2 + h1_t . vk2 + vb2        (cot of dz2)
//     dzbar2 = u2 + mu_h2 . rec2 + h2_{t-1} . vr2     -> zbar2, dhTbar2 = udhs2_t, ...
//     uh2p   = dz2 . vr2^T + zbar2 . rec2^T           (cot of h2_{t-1})
//     uh1    = zbar2 . k2^T + dz2 . vk2^T             (cot of h1_t)
//
// with _stack_adj_call's output shift done in place (uhs1_t = uh1_t +
// uh1p_{t+1}, ucs1_t = uc1_t + uc1p_{t+1}, uhs2_t = uh2p_{t+1} alone,
// ucs2_t = uc2_t + uc2p_{t+1}; zero past the end), and then over the W*B
// rows ur1 = sum mu_h1^T dz1 + h1_{t-1}^T zbar1, uk2 = sum h1_t^T zbar2 +
// dhTbar1^T dz2, ub2 = sum zbar2, ur2 = sum mu_h2^T dz2 + h2_{t-1}^T zbar2.
// xz1 and the weights are float32 or bf16, everything else float32.  As
// in the TPU kernel, the vectors dotted with an operand-dtype matrix
// (h1_{t-1}, mu_h1, zbar1, h1_t, dhTbar1, h2_{t-1}, mu_h2, zbar2) are
// rounded to its dtype first; the products with the v-streams and the
// sums use float32.
//
// What bounds it.  At the penalty's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 24.3 MB (xz1, u1, uxz1 and the three
// (W, B, 4H) workspaces 2.46 MB each; hs1, cs1, hs2, cs2, the four
// carries, the five cotangent streams and one workspace 0.61 MB each;
// seven matrices and four sums 1.76 MB) — >= 7.3 us at 3.35 TB/s — and
// do 2.6 GFLOP (21 products of 2*W*B*H*4H) — >= 38.5 us at 67 TFLOP/s
// float32.  Neither sets the pace: mu_h1 and mu_h2 of step t feed step
// t+1, so the sweep is W dependent steps of six dot chains.
//
// What the design does about it.  The skeleton of lstm_adj.cu, two layers
// deep.  One block owns a tile of batch rows and walks all W steps.  rec1
// sits in dynamic shared memory with the one-entry row pad, read by
// columns and by rows without bank conflicts.  k2, rec2 and the float32
// v-streams stay in global memory (L2): the step walks each by columns,
// and through the transposed copies the wrapper passes (k2^T, rec2^T,
// vr1^T, vk2^T, vr2^T) the dots with a transpose are by columns too, so
// every global walk is coalesced.  The walks are bound by L2 latency, so
// each thread issues a chunk of rows' loads at once through ldg_f before
// their FMAs (64 in flight; 2.3x faster than plain loads at W=48, B=32,
// PERF.md).  Three block barriers a step: after
// staging the step's states, after layer 1 (u2 needs all of dhTbar1, and
// uh1p all of dz1 and zbar1), after layer 2 (uh1 and uh2p need all of
// dz2 and zbar2).  The carries and the output shift's previous terms
// live in registers.  The sums are formed after the sweep by
// lstm_common.cuh's outer_sum (dz1, dz2, zbar2 and dhTbar1 go to
// workspaces; mu_h2 is udhs2 one step back), deterministically and
// without atomics.

#include "lstm_common.cuh"

namespace {

using namespace hfrep;

struct StackAdjArgs {
  const float* vr1;    // (H, 4H) and its transpose (4H, H)
  const float* vr1t;
  const float* vk2;
  const float* vk2t;
  const float* vb2;    // (4H,)
  const float* vr2;
  const float* vr2t;
  const float* hs1;    // (W, B, H)
  const float* cs1;
  const float* hs2;
  const float* cs2;
  const float* dhT1;
  const float* dcT1;
  const float* dhT2;
  const float* dcT2;
  const float* u1;     // (W, B, 4H)
  float* uxz1;         // (W, B, 4H)
  float* uhs1;         // (W, B, H)
  float* ucs1;
  float* uhs2;
  float* ucs2;
  float* udhs2;
  float* dz1w;         // workspaces: (W, B, 4H) x 3, (W, B, H)
  float* dz2w;
  float* zb2w;
  float* dhtb1w;
};

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

// rows of the L2-resident matrices loaded together before their FMAs
// (ldg_f), 64 loads in flight a thread: 2 KC rows of vr1, KC/2 rows of
// k2, rec2, vk2 and vr2; 2 MC rows of vr1^T, MC/2 rows of k2^T, rec2^T,
// vk2^T and vr2^T
constexpr int KC = 8;
constexpr int MC = 32;

template <typename T, int ACT>
__global__ void stack_adj_kernel(const T* __restrict__ xz1, const T* __restrict__ rec1,
                                 const T* __restrict__ k2, const T* __restrict__ k2t,
                                 const T* __restrict__ b2, const T* __restrict__ rec2,
                                 const T* __restrict__ rec2t, StackAdjArgs a, int W,
                                 int B, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  const int ld = G + 1;
  T* rec_s = reinterpret_cast<T*>(smem_raw);                          // H x ld
  float* base = reinterpret_cast<float*>(smem_raw + rec_smem_bytes(H, sizeof(T)));
  const size_t rh = static_cast<size_t>(rows) * H, rg = static_cast<size_t>(rows) * G;
  float* h1p_s = base;              // h1_{t-1}, float32       rows x H
  float* mu1_s = h1p_s + rh;        // mu_h1, rounded          rows x H
  float* h1_s = mu1_s + rh;         // h1_t, float32           rows x H
  float* h2p_s = h1_s + rh;         // h2_{t-1}, float32       rows x H
  float* mu2_s = h2p_s + rh;        // mu_h2, rounded          rows x H
  float* tb1_s = mu2_s + rh;        // dhTbar1, rounded        rows x H
  float* dz1_s = tb1_s + rh;        // dz1, float32            rows x G
  float* zb1_s = dz1_s + rg;        // zbar1, rounded          rows x G
  float* dz2_s = zb1_s + rg;        // dz2, float32            rows x G
  float* zb2_s = dz2_s + rg;        // zbar2, rounded          rows x G

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
  const size_t rowh = static_cast<size_t>(bl) * H, rowg = static_cast<size_t>(bl) * G;
  float bias[4], vbias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias[g] = to_f(b2[g * H + j]);
    vbias[g] = a.vb2[g * H + j];
  }
  float muh1 = 0.f, muc1 = 0.f, muh2 = 0.f, muc2 = 0.f;
  float uh1_prev = 0.f, uc1_prev = 0.f, uc2_prev = 0.f;

  for (int t = 0; t < W; ++t) {
    const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
    const size_t og4 = (static_cast<size_t>(t) * B + b) * G + j;
    if (live) {
      h1p_s[rowh + j] = t > 0 ? a.hs1[o - hstep] : 0.f;
      mu1_s[rowh + j] = round_to<T>(muh1);
      h1_s[rowh + j] = a.hs1[o];
      h2p_s[rowh + j] = t > 0 ? a.hs2[o - hstep] : 0.f;
      mu2_s[rowh + j] = round_to<T>(muh2);
    }
    __syncthreads();
    if (live) {          // layer 1
      float zd[4] = {0.f, 0.f, 0.f, 0.f};   // h1_{t-1} . rec1
      float md[4] = {0.f, 0.f, 0.f, 0.f};   // mu_h1 . rec1
      float vd[4] = {0.f, 0.f, 0.f, 0.f};   // h1_{t-1} . vr1
      const T* col = rec_s + j;
      const float* vcol = a.vr1 + j;
      for (int k0 = 0; k0 < H; k0 += 2 * KC) {   // 2 KC rows of vr1 in flight
        float vv[2 * KC][4];
#pragma unroll
        for (int u = 0; u < 2 * KC; ++u) {
          const size_t off = static_cast<size_t>(min(k0 + u, H - 1)) * G;
#pragma unroll
          for (int g = 0; g < 4; ++g) vv[u][g] = ldg_f(vcol + off + g * H);
        }
#pragma unroll
        for (int u = 0; u < 2 * KC; ++u) {
          const int k = k0 + u;
          if (k < H) {
            const float hk = h1p_s[rowh + k];
            const float hkt = round_to<T>(hk);
            const float mk = mu1_s[rowh + k];
            const T* r = col + static_cast<size_t>(k) * ld;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float rv = to_f(r[g * H]);
              zd[g] = fmaf(hkt, rv, zd[g]);
              md[g] = fmaf(mk, rv, md[g]);
              vd[g] = fmaf(hk, vv[u][g], vd[g]);
            }
          }
        }
      }
      const T* xr = xz1 + og4;
      const float* ur = a.u1 + og4;
      float dzb[4], dz[4], zb[4], dhTbar, dcTbar, cpbar, cbar;
#pragma unroll
      for (int g = 0; g < 4; ++g) dzb[g] = ur[g * H] + md[g] + vd[g];
      adj_step<ACT>(sigmoid_f(to_f(xr[0]) + zd[0]), sigmoid_f(to_f(xr[H]) + zd[1]),
                    act_f<ACT>(to_f(xr[2 * H]) + zd[2]), sigmoid_f(to_f(xr[3 * H]) + zd[3]),
                    a.cs1[o], t > 0 ? a.cs1[o - hstep] : 0.f, a.dhT1[o], a.dcT1[o], muc1,
                    dzb, dz, zb, &dhTbar, &dcTbar, &cpbar, &cbar);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a.uxz1[og4 + g * H] = zb[g];
        a.dz1w[og4 + g * H] = dz[g];
        dz1_s[rowg + g * H + j] = dz[g];
        zb1_s[rowg + g * H + j] = round_to<T>(zb[g]);
      }
      a.dhtb1w[o] = dhTbar;
      tb1_s[rowh + j] = round_to<T>(dhTbar);
      if (t > 0) a.ucs1[o - hstep] = uc1_prev + cpbar;
      uc1_prev = cbar;
      muh1 = dhTbar;
      muc1 = dcTbar;
    }
    __syncthreads();
    if (live) {          // uh1p of layer 1, then layer 2
      const float* vt = a.vr1t + j;
      const T* rr = rec_s + static_cast<size_t>(j) * ld;
      float dzv = 0.f, zr = 0.f;
      for (int m0 = 0; m0 < G; m0 += 2 * MC) {   // 2 MC rows of vr1^T in flight
        float vv[2 * MC];
#pragma unroll
        for (int u = 0; u < 2 * MC; ++u)
          vv[u] = ldg_f(vt + static_cast<size_t>(min(m0 + u, G - 1)) * H);
#pragma unroll
        for (int u = 0; u < 2 * MC; ++u) {
          const int m = m0 + u;
          if (m < G) {
            dzv = fmaf(dz1_s[rowg + m], vv[u], dzv);
            zr = fmaf(zb1_s[rowg + m], to_f(rr[m]), zr);
          }
        }
      }
      if (t > 0) a.uhs1[o - hstep] = uh1_prev + (dzv + zr);

      float d[4] = {0.f, 0.f, 0.f, 0.f};    // h1_t . k2
      float ud[4] = {0.f, 0.f, 0.f, 0.f};   // dhTbar1 . k2
      float uv[4] = {0.f, 0.f, 0.f, 0.f};   // h1_t . vk2
      float e[4] = {0.f, 0.f, 0.f, 0.f};    // h2_{t-1} . rec2
      float md[4] = {0.f, 0.f, 0.f, 0.f};   // mu_h2 . rec2
      float vd[4] = {0.f, 0.f, 0.f, 0.f};   // h2_{t-1} . vr2
      const T* kcol = k2 + j;
      const T* rcol = rec2 + j;
      const float* vkcol = a.vk2 + j;
      const float* vrcol = a.vr2 + j;
      for (int k0 = 0; k0 < H; k0 += KC / 2) {   // KC/2 rows of four matrices in flight
        float kv[KC / 2][4], rv[KC / 2][4], vkv[KC / 2][4], vrv[KC / 2][4];
#pragma unroll
        for (int u = 0; u < KC / 2; ++u) {
          const size_t off = static_cast<size_t>(min(k0 + u, H - 1)) * G;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            kv[u][g] = ldg_f(kcol + off + g * H);
            rv[u][g] = ldg_f(rcol + off + g * H);
            vkv[u][g] = ldg_f(vkcol + off + g * H);
            vrv[u][g] = ldg_f(vrcol + off + g * H);
          }
        }
#pragma unroll
        for (int u = 0; u < KC / 2; ++u) {
          const int k = k0 + u;
          if (k < H) {
            const float h1 = h1_s[rowh + k];
            const float h1t = round_to<T>(h1);
            const float tb = tb1_s[rowh + k];
            const float h2 = h2p_s[rowh + k];
            const float h2t = round_to<T>(h2);
            const float mk = mu2_s[rowh + k];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              d[g] = fmaf(h1t, kv[u][g], d[g]);
              ud[g] = fmaf(tb, kv[u][g], ud[g]);
              uv[g] = fmaf(h1, vkv[u][g], uv[g]);
              e[g] = fmaf(h2t, rv[u][g], e[g]);
              md[g] = fmaf(mk, rv[u][g], md[g]);
              vd[g] = fmaf(h2, vrv[u][g], vd[g]);
            }
          }
        }
      }
      float dzb[4], dz[4], zb[4], dhTbar, dcTbar, cpbar, cbar;
#pragma unroll
      for (int g = 0; g < 4; ++g) dzb[g] = ud[g] + uv[g] + vbias[g] + md[g] + vd[g];
      adj_step<ACT>(sigmoid_f(bias[0] + d[0] + e[0]), sigmoid_f(bias[1] + d[1] + e[1]),
                    act_f<ACT>(bias[2] + d[2] + e[2]), sigmoid_f(bias[3] + d[3] + e[3]),
                    a.cs2[o], t > 0 ? a.cs2[o - hstep] : 0.f, a.dhT2[o], a.dcT2[o], muc2,
                    dzb, dz, zb, &dhTbar, &dcTbar, &cpbar, &cbar);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a.dz2w[og4 + g * H] = dz[g];
        a.zb2w[og4 + g * H] = zb[g];
        dz2_s[rowg + g * H + j] = dz[g];
        zb2_s[rowg + g * H + j] = round_to<T>(zb[g]);
      }
      a.udhs2[o] = dhTbar;
      if (t > 0) a.ucs2[o - hstep] = uc2_prev + cpbar;
      uc2_prev = cbar;
      muh2 = dhTbar;
      muc2 = dcTbar;
    }
    __syncthreads();
    if (live) {          // uh1 (cot of h1_t) and uh2p (cot of h2_{t-1}), unit j
      const T* kt = k2t + j;
      const T* rt = rec2t + j;
      const float* vkt = a.vk2t + j;
      const float* vrt = a.vr2t + j;
      float zk = 0.f, dv = 0.f, dzv = 0.f, zr = 0.f;
      for (int m0 = 0; m0 < G; m0 += MC / 2) {   // MC/2 rows of four matrices in flight
        float kv[MC / 2], rv[MC / 2], vkv[MC / 2], vrv[MC / 2];
#pragma unroll
        for (int u = 0; u < MC / 2; ++u) {
          const size_t off = static_cast<size_t>(min(m0 + u, G - 1)) * H;
          kv[u] = ldg_f(kt + off);
          rv[u] = ldg_f(rt + off);
          vkv[u] = ldg_f(vkt + off);
          vrv[u] = ldg_f(vrt + off);
        }
#pragma unroll
        for (int u = 0; u < MC / 2; ++u) {
          const int m = m0 + u;
          if (m < G) {
            const float z = zb2_s[rowg + m];
            const float dzm = dz2_s[rowg + m];
            zk = fmaf(z, kv[u], zk);
            dv = fmaf(dzm, vkv[u], dv);
            dzv = fmaf(dzm, vrv[u], dzv);
            zr = fmaf(z, rv[u], zr);
          }
        }
      }
      uh1_prev = zk + dv;
      if (t > 0) a.uhs2[o - hstep] = dzv + zr;
    }
  }
  if (live) {
    const size_t last = (static_cast<size_t>(W - 1) * B + b) * H + j;
    a.uhs1[last] = uh1_prev;
    a.ucs1[last] = uc1_prev;
    a.uhs2[last] = 0.f;
    a.ucs2[last] = uc2_prev;
  }
}

template <typename T, int ACT>
cudaError_t launch_sweep(const void* xz1, const void* rec1, const void* k2,
                         const void* k2t, const void* b2, const void* rec2,
                         const void* rec2t, const StackAdjArgs& a, int W, int B, int H,
                         int rows, cudaStream_t stream) {
  const size_t smem = rec_smem_bytes(H, sizeof(T))
                      + static_cast<size_t>(rows) * 22 * H * sizeof(float);
  const int threads = ((rows * H + 31) / 32) * 32;
  const int blocks = (B + rows - 1) / rows;
  cudaError_t e = cudaFuncSetAttribute(stack_adj_kernel<T, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  stack_adj_kernel<T, ACT><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(xz1), static_cast<const T*>(rec1), static_cast<const T*>(k2),
      static_cast<const T*>(k2t), static_cast<const T*>(b2), static_cast<const T*>(rec2),
      static_cast<const T*>(rec2t), a, W, B, H, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(int act, const void* xz1, const void* rec1, const void* k2,
                       const void* k2t, const void* b2, const void* rec2,
                       const void* rec2t, const StackAdjArgs& a, int W, int B, int H,
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

// The sweep, then ur1, uk2, ub2 and ur2 over the W*B rows, all on
// `stream`.  dz1w, dz2w, zb2w ((W, B, 4H)) and dhtb1w ((W, B, H)) are
// float32 workspaces; `part` holds splits x H x 4H floats when
// splits > 1.  Returns the first CUDA error of a launch (0 = ok).
int hfrep_stack_adj(const void* xz1, const void* rec1, const void* k2, const void* k2t,
                    const void* b2, const void* rec2, const void* rec2t, const void* vr1,
                    const void* vr1t, const void* vk2, const void* vk2t, const void* vb2,
                    const void* vr2, const void* vr2t, const void* hs1, const void* cs1,
                    const void* hs2, const void* cs2, const void* dhT1, const void* dcT1,
                    const void* dhT2, const void* dcT2, const void* u1, void* uxz1,
                    void* uhs1, void* ucs1, void* uhs2, void* ucs2, void* udhs2,
                    void* dz1w, void* dz2w, void* zb2w, void* dhtb1w, void* ur1,
                    void* uk2, void* ub2, void* ur2, void* part, int W, int B, int H,
                    int act, int bf16, int rows, int splits, int rows_per_split,
                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto mf = [](void* p) { return static_cast<float*>(p); };
  const StackAdjArgs a{cf(vr1),  cf(vr1t),  cf(vk2),  cf(vk2t), cf(vb2),   cf(vr2),
                       cf(vr2t), cf(hs1),   cf(cs1),  cf(hs2),  cf(cs2),   cf(dhT1),
                       cf(dcT1), cf(dhT2),  cf(dcT2), cf(u1),   mf(uxz1),  mf(uhs1),
                       mf(ucs1), mf(uhs2),  mf(ucs2), mf(udhs2), mf(dz1w), mf(dz2w),
                       mf(zb2w), mf(dhtb1w)};
  e = bf16 ? launch_act<__nv_bfloat16>(act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B,
                                      H, rows, s)
           : launch_act<float>(act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H, rows,
                               s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = W * B, G = 4 * H;
  float* pt = mf(part);
  // mu_h1 of step t is dhTbar1 of step t-1, mu_h2 is udhs2 of step t-1
  e = outer_sum<2>(a.dhtb1w, a.dz1w, a.hs1, a.uxz1, mf(ur1), pt, R, B, H, G, splits,
                   rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<2>(a.hs1, a.zb2w, a.dhtb1w, a.dz2w, mf(uk2), pt, R, 0, H, G, splits,
                     rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<1>(nullptr, a.zb2w, nullptr, nullptr, mf(ub2), pt, R, 0, 1, G, splits,
                     rows_per_split, s);
  if (e == cudaSuccess)
    e = outer_sum<2>(a.udhs2, a.dz2w, a.hs2, a.zb2w, mf(ur2), pt, R, B, H, G, splits,
                     rows_per_split, s);
  return static_cast<int>(e);
}

}  // extern "C"
