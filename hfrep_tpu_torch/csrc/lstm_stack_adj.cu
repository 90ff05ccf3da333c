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
// with _stack_adj_call's output shift (uhs1_t = uh1_t + uh1p_{t+1}, ucs1_t
// = uc1_t + uc1p_{t+1}, uhs2_t = uh2p_{t+1} alone, ucs2_t = uc2_t +
// uc2p_{t+1}; zero past the end), and then over the W*B rows ur1 = sum
// mu_h1^T dz1 + h1_{t-1}^T zbar1, uk2 = sum h1_t^T zbar2 + dhTbar1^T dz2,
// ub2 = sum zbar2, ur2 = sum mu_h2^T dz2 + h2_{t-1}^T zbar2.  xz1 and the
// weights are float32 or bf16, everything else float32.  As in the TPU
// kernel, the vectors dotted with an operand-dtype matrix (h1_{t-1},
// mu_h1, zbar1, h1_t, dhTbar1, h2_{t-1}, mu_h2, zbar2) are rounded to its
// dtype first; the products with the v-streams and the sums use float32.
//
// What bounds it.  At the penalty's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 24.3 MB (xz1, u1, uxz1 and the three
// (W, B, 4H) workspaces 2.46 MB each; hs1, cs1, hs2, cs2, the four
// carries, the five cotangent streams and one workspace 0.61 MB each;
// seven matrices and four sums 1.76 MB) — >= 7.3 us at 3.35 TB/s — and
// do 2.6 GFLOP (21 products of 2*W*B*H*4H) — >= 38.5 us at 67 TFLOP/s
// float32.  Neither sets the pace: mu_h1 and mu_h2 of step t feed step
// t+1, so the sweep is W dependent steps.  Only two products a step sit
// on that chain: mu_h1 . rec1 and, for layer 2, mu_h2 . rec2 plus dhTbar1
// . k2 (layer 1 never reads layer 2).  Both layers' gates and the
// v-stream terms read only saved states, the transposed products are
// outputs that no step reads again, and the backward's dz reads only the
// saved carries.
//
// The cluster layout, for H <= 4*KS = 100, which every preset width takes:
// - The pre-pass (lstm_stack.cuh's stack_gates_kernel, shared with the
//   stack backward) forms, for all W*B rows at once in tiled float32
//   products, both layers' gates and the chain-free part of each layer's
//   dzbar: base1 = u1 + h1_{t-1} . vr1, base2 = vb2 + h1_t . vk2 + h2_{t-1}
//   . vr2 (unrounded states: v is float32).  It writes them where the
//   sweep writes later: layer 1's gates into uxz1 (then zbar1), layer 2's
//   into the zbar2 workspace, base1 and base2 into the dz workspaces.
// - The sweep (stack_adj_cluster_kernel) is the stack forward's cluster
//   (lstm_stack.cuh, hfrep::cl) with the adjoint's lane math: two blocks a
//   batch row, one layer a block, 416 threads, a quad a hidden unit j,
//   thread (j, q) holding k-quarter q of unit j's four gate columns of its
//   layer's recurrent matrix, KR1 (block 0) or KR2 (block 1) of its 25
//   rows in registers and the rest in shared memory.  Lane q starts gate
//   q's sum at its base, and after the quad's sums (a butterfly: every
//   lane ends with the same bits of unit j's four dzbar) each lane runs
//   the unit's adj_step itself, so the carries mu_c and dhTbar stay in
//   the quad and a step has one block barrier.
// - Block 0 (layer 1) forms round(mu_h1) . rec1, and in a second loop over
//   the same vector its rows kk < KH = 13 of round(dhTbar1_{t-1}) . k2;
//   round(dhTbar1_t) and that k2 part go into slot t mod D of a ring in
//   block 1's shared memory by st.async (lstm_common.cuh), as the forward
//   hands over h1.  Block 1 (layer 2) waits on the slot, starts lane q's
//   gate q at base2 plus block 0's part, and adds round(mu_h2) . rec2 and
//   its rows of k2.  Block 0 runs up to D = 4 steps ahead; no release or
//   acquire at cluster scope runs in the time loop.
// - Each step writes zbar, dz (both float32, for the post-pass and the
//   sums), dhTbar1 (a workspace) or udhs2, and the c-shift in registers.
//   Each lane stages its gate, its base and one of (c_t, c_{t-1}, dhT, dcT)
//   a step ahead with cp.async, which holds no registers.
// - Registers: 13 warps get 128 registers a thread; 17 (block 0) and 18
//   (block 1) rows in registers in float32, 17 and 17 in bf16, spill in
//   no instantiation (tools/torch_stack_fwd_sweep.py --kernel adj --rows),
//   which leaves room to stage a third of a matrix's rows in the prologue:
//   213,552 B of shared memory a block in float32, 143,088 in bf16.
// - The post-pass (stack_adj_post_kernel) forms the transposed products
//   over all W*B rows with the h-shift in its row reads: uhs1_t =
//   round(zbar2_t) . k2^T + dz2_t . vk2^T + dz1_{t+1} . vr1^T +
//   round(zbar1_{t+1}) . rec1^T and uhs2_t = dz2_{t+1} . vr2^T +
//   round(zbar2_{t+1}) . rec2^T, reading the matrices themselves by rows
//   (no transposed copies); where the output has few tiles, each tile's
//   depth is split over a cluster of two or four blocks that add their
//   sums through distributed shared memory.
// - Clusters loop over ceil(B / (SMs/2)) batch rows each, carries reset a
//   row; the ring's phase runs on across rows.
// A width whose recurrent matrices the register file cannot hold (100 < H,
// within stack_fits) runs the wide layout (stack_adj_kernel), the port's
// first stack adjoint, unchanged: the skeleton of lstm_adj.cu, two layers
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
// live in registers.  The wrapper chooses the layout by a rule on (H,
// dtype, B, SMs) (cuda_lstm_stack.stack_adj_layout) and passes it here; it
// never tries one and falls back.  In both layouts the sums are formed
// after the sweep by weight_sum.cuh (dz1, dz2, zbar2 and dhTbar1 go to
// workspaces; mu_h2 is udhs2 one step back): ur1, uk2 and ur2, two pairs
// each, in one launch, ub2 in another, deterministically and without
// atomics.

#include <cooperative_groups.h>

#include "lstm_stack.cuh"
#include "weight_sum.cuh"

namespace {

using namespace hfrep;
using namespace hfrep::adj;   // adj_step and the cluster sweep's lane pieces

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

// ----------------------------------------------------- cluster layout
namespace ca {

using namespace cl;

// Of a thread's KS rows of its layer's recurrent matrix, the first KR1
// (layer 1) or KR2 (layer 2) are held in registers, the rest in shared
// memory: ptxas grants 13 warps 128 registers a thread, and the counts that
// leave no instantiation spilling differ by operand type
// (tools/torch_stack_fwd_sweep.py --kernel adj --rows).
constexpr int KR1_F32 = 17, KR2_F32 = 18, KR1_BF16 = 17, KR2_BF16 = 17;
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

// The fixed part of a block's shared memory, in floats: two h buffers
// (step parity), each thread's staged step inputs for two steps, the rows
// of the recurrent matrix past the fewer of KR1, KR2 (a float4 a thread
// each), the ring and its D mbarriers (block 1), then the count of slots
// block 1 has read (block 0), padded to 16 bytes.
__host__ __device__ constexpr int fixed_floats(size_t item) {
  return 8 * KSP + 2 * NST * THREADS + 4 * (KS - kr_min(item)) * THREADS + D * SLOT + 2 * D + 4;
}

// Dynamic shared memory of either block: the fixed part, the block's part
// of k2, then a staging area for a PARTS-th of the rows of the recurrent
// matrix, and at least one quarter's run of k2's rows (two runs at a time
// in float32 at H=100).
constexpr int PARTS = 3;
__host__ __device__ inline size_t stage_bytes(int H, size_t item) {
  const size_t part = static_cast<size_t>((H + PARTS - 1) / PARTS) * 4 * H * item;
  const size_t run = static_cast<size_t>(KS - KH > KH ? KS - KH : KH) * 4 * H * item;
  return part > run ? part : run;
}
__host__ __device__ inline size_t smem_bytes(int H, size_t item) {
  return fixed_floats(item) * sizeof(float) + k2_bytes(item) + stage_bytes(H, item);
}

}  // namespace ca

// Launched as clusters of two blocks of cl::THREADS threads, after
// stack_gates_kernel has written the gates into uxz1 and zb2w and the
// bases into dz1w and dz2w; grid = 2 x the clusters, cluster c walks batch
// rows c*rows .. c*rows + rows - 1.
template <typename T, int ACT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(cl::THREADS, 1)
stack_adj_cluster_kernel(const T* __restrict__ rec1, const T* __restrict__ k2,
                         const T* __restrict__ rec2, StackAdjArgs a, int W, int B, int H,
                         int rows) {
  using namespace ca;
  namespace cg = cooperative_groups;
  constexpr int KR1 = Keep<T>::r1, KR2 = Keep<T>::r2;
  constexpr int KRMIN = KR1 < KR2 ? KR1 : KR2, KRMAX = KR1 < KR2 ? KR2 : KR1;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  float* h_s = fsm;                          // round(mu_h): 2 buffers (step parity) x 4 x KSP
  float* step_s = h_s + 8 * KSP;             // step inputs: 2 (step parity) x THREADS x NST
  float4* rec_s = reinterpret_cast<float4*>(step_s + 2 * NST * THREADS);   // rows kk >= KR1, KR2
  float* ring = reinterpret_cast<float*>(rec_s + (KS - KRMIN) * THREADS);   // D slots
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + D * SLOT);  // D
  unsigned* done = reinterpret_cast<unsigned*>(full + D);   // block 0: slots block 1 has read
  T* k2_s = reinterpret_cast<T*>(fsm + fixed_floats(sizeof(T)));    // this block's rows of k2
  T* stage = k2_s + k2_bytes(sizeof(T)) / sizeof(T);        // staging area
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int q = tid & 3;                     // k-quarter; gate q's sum; state stream q
  const int j = (tid >> 5) * 8 + ((tid & 31) >> 2);   // hidden unit
  const int base = tid & 28;                 // the quad's first lane
  const bool unit = j < H;
  const int hpos = (j / KS) * KSP + j % KS;  // unit j's entry in an h buffer
  const unsigned rank = cluster.block_rank();          // 0: layer 1, 1: layer 2
  const int cid = static_cast<int>(blockIdx.x / 2);

  // h buffers and the ring start at zero; positions past H and the pads
  // stay zero, multiplied by zero weights
  for (int i = tid; i < 8 * KSP; i += THREADS) h_s[i] = 0.0f;
  for (int i = tid; i < D * SLOT; i += THREADS) ring[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < D; ++s) mbar_init(smem_u32(full + s), 1);
    if (rank == 1)
      for (int s = 0; s < D; ++s) mbar_expect(smem_u32(full + s), 20 * H);   // uses 0 .. D-1
    *reinterpret_cast<volatile unsigned*>(done) = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this block's rows of k2, then this layer's recurrent matrix, a
  // PARTS-th of its rows at a time: rows kk < KR1 (KR2) into registers, the
  // rest into shared memory
  deal_k2(k2, k2_s, stage, static_cast<int>(stage_bytes(H, sizeof(T)) / sizeof(T)),
          rank == 0 ? 0 : KH, rank == 0 ? KH : KS, H, q, j, unit);
  float w[4][KRMAX];
#pragma unroll
  for (int kk = 0; kk < KRMAX; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) w[g][kk] = 0.0f;
  for (int kk = 0; kk < KS - KRMIN; ++kk) rec_s[kk * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const T* rec = rank == 0 ? rec1 : rec2;
  const int part = (H + PARTS - 1) / PARTS;
  for (int lo = 0; lo < H; lo += part) {
    const int n = min(part, H - lo);
    copy_issue<THREADS>(rec + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    if (rank == 0) deal_rec<T, KR1>(stage, lo, n, H, q, j, unit, w, rec_s);
    else deal_rec<T, KR2>(stage, lo, n, H, q, j, unit, w, rec_s);
    __syncthreads();                         // the staged rows are read
  }
  cluster.sync();                            // both blocks set up before any remote access

  // 32-bit element offsets (the launch checks that W*B*4H fits)
  const int xstep = B * G;
  const int ostep = B * H;
  const int back = q == 1 ? ostep : 0;       // lane 1 reads c_{t-1}
  unsigned n = 0;                            // steps so far: slot n % D, its use n / D
  // each block runs its own loop, so that neither holds the other's values
  if (rank == 0) {
    // Layer 1.  Pass s reads round(mu_h1) = round(dhTbar1_{s-1}) once for
    // dzbar1_s = base1_s + round(mu_h1) . rec1 (s < W) and for this block's
    // part of round(dhTbar1_{s-1}) . k2 (s > 0), which goes to slot s-1 of
    // layer 2's ring beside round(dhTbar1_{s-1}).
    const unsigned ring_peer = peer_u32(smem_u32(ring), 1);   // layer 2's ring
    const float* sp = q < 2 ? a.cs1 : q == 2 ? a.dhT1 : a.dcT1;
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;                     // the same for the whole cluster
      __syncthreads();                       // the last row's reads are done
      if (unit && q == 0) h_s[hpos] = 0.0f;  // mu_h1 of step 0
      float muc = 0.0f, uc_prev = 0.0f;
      int o = b * H + (unit ? j : 0);        // (W, B, H) offset of step s
      int og = b * G + (unit ? q * H + j : 0);   // gate q's, (W, B, 4H)
      stage_step(step_s + tid * NST, a.uxz1, a.dz1w, og, sp, o, back, 0, unit);
      __syncthreads();
      for (int s = 0; s <= W; ++s) {
        float gq = 0.0f, bq = 0.0f, sq = 0.0f;
        if (s < W) {
          asm volatile("cp.async.wait_all;" ::: "memory");
          const float* st = step_s + ((s & 1) * THREADS + tid) * NST;
          gq = st[0], bq = st[1], sq = st[2];
          if (s + 1 < W)
            stage_step(step_s + (((s + 1) & 1) * THREADS + tid) * NST, a.uxz1, a.dz1w,
                       og + xstep, sp, o + ostep, back, s + 1, unit);
        }
        // dzbar1's dot, then this block's rows of k2: two loops, so that
        // the second holds none of the first's values
        float acc[4], acc2[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = g == q ? bq : 0.0f, acc2[g] = 0.0f;
        const float4* hp = reinterpret_cast<const float4*>(h_s + (s & 1) * 4 * KSP + q * KSP);
        dot_rec<KR1>(hp, w, rec_s, tid, acc, acc2);
        float dzb[4];
        quad_sums(acc, acc2, dzb);
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
        if (unit && s > 0) {
          const unsigned prev = (n - 1) % D;   // slot of step s-1
          st_async_peer(ring_peer + 4 * (prev * SLOT + 4 * KSP + q * ZP + j), pq,
                        peer_u32(smem_u32(full + prev), 1));
        }
        if (s == W) break;
        const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
        const float gc = from_lane(gq, base, 2), og1 = from_lane(gq, base, 3);
        const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
        const float dh = from_lane(sq, base, 2), dc = from_lane(sq, base, 3);
        float dz[4], zb[4], dhTbar, dcTbar, cpbar, cbar;
        adj_step<ACT>(ig, fg, gc, og1, c, cp, dh, dc, muc, dzb, dz, zb, &dhTbar, &dcTbar,
                      &cpbar, &cbar);
        muc = dcTbar;
        if (unit) {
          a.uxz1[og] = pick(zb, q);
          a.dz1w[og] = pick(dz, q);
          if (q == 0) {
            a.dhtb1w[o] = dhTbar;
            const float hr = round_to<T>(dhTbar);
            h_s[((s + 1) & 1) * 4 * KSP + hpos] = hr;
            // round(dhTbar1_s) into slot n of layer 2's ring, once layer 2
            // has read the slot's last use
            const unsigned slot = n % D;
            if (n >= D)
              while (ld_flag(smem_u32(done)) < n - D + 1) {
              }
            st_async_peer(ring_peer + 4 * (slot * SLOT + hpos), hr,
                          peer_u32(smem_u32(full + slot), 1));
          }
          if (q == 1 && s > 0) a.ucs1[o - ostep] = uc_prev + cpbar;
        }
        uc_prev = cbar;
        o += ostep;
        og += xstep;
        ++n;
        __syncthreads();
      }
      if (unit && q == 1) a.ucs1[o - ostep] = uc_prev;   // step W-1: nothing after it
    }
  } else {
    // Layer 2: dzbar2_t = base2_t + round(dhTbar1_t) . k2 + round(mu_h2) .
    // rec2, block 0's part of round(dhTbar1_t) . k2 taken from the ring as
    // lane q's start for gate q.
    const float* sp = q < 2 ? a.cs2 : q == 2 ? a.dhT2 : a.dcT2;
    for (int r = 0; r < rows; ++r) {
      const int b = cid * rows + r;
      if (b >= B) break;
      __syncthreads();
      if (unit && q == 0) h_s[hpos] = 0.0f;  // mu_h2 of step 0
      float muc = 0.0f, uc_prev = 0.0f;
      int o = b * H + (unit ? j : 0);
      int og = b * G + (unit ? q * H + j : 0);
      stage_step(step_s + tid * NST, a.zb2w, a.dz2w, og, sp, o, back, 0, unit);
      __syncthreads();
      for (int t = 0; t < W; ++t, ++n) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        const float* st = step_s + ((t & 1) * THREADS + tid) * NST;
        const float gq = st[0], bq = st[1], sq = st[2];
        if (t + 1 < W)
          stage_step(step_s + (((t + 1) & 1) * THREADS + tid) * NST, a.zb2w, a.dz2w,
                     og + xstep, sp, o + ostep, back, t + 1, unit);
        const unsigned slot = n % D;
        mbar_wait(smem_u32(full + slot), (n / D) & 1u);
        const float* sl = ring + slot * SLOT;
        const float part1 = unit ? sl[4 * KSP + q * ZP + j] : 0.0f;
        float acc[4], acc2[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = g == q ? bq + part1 : 0.0f, acc2[g] = 0.0f;
        // round(mu_h2) . rec2, then round(dhTbar1_t) . k2 over this block's
        // rows, into the same chains
        dot_rec<KR2>(reinterpret_cast<const float4*>(h_s + (t & 1) * 4 * KSP + q * KSP), w,
                     rec_s, tid, acc, acc2);
        const float4* h1p = reinterpret_cast<const float4*>(sl + q * KSP);
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
        float dzb[4];
        quad_sums(acc, acc2, dzb);
        const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
        const float gc = from_lane(gq, base, 2), og2 = from_lane(gq, base, 3);
        const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
        const float dh = from_lane(sq, base, 2), dc = from_lane(sq, base, 3);
        float dz[4], zb[4], dhTbar, dcTbar, cpbar, cbar;
        adj_step<ACT>(ig, fg, gc, og2, c, cp, dh, dc, muc, dzb, dz, zb, &dhTbar, &dcTbar,
                      &cpbar, &cbar);
        muc = dcTbar;
        if (unit) {
          a.zb2w[og] = pick(zb, q);
          a.dz2w[og] = pick(dz, q);
          if (q == 0) {
            a.udhs2[o] = dhTbar;
            h_s[((t + 1) & 1) * 4 * KSP + hpos] = round_to<T>(dhTbar);
          }
          if (q == 1 && t > 0) a.ucs2[o - ostep] = uc_prev + cpbar;
        }
        uc_prev = cbar;
        o += ostep;
        og += xstep;
        __syncthreads();
        // every thread has read slot n: layer 1 may refill it
        if (tid == THREADS - 1) {                // a thread with no unit
          mbar_expect(smem_u32(full + slot), 20 * H);   // slot n's next use, n + D
          st_flag_peer(peer_u32(smem_u32(done), 0), n + 1);
        }
      }
      if (unit && q == 1) a.ucs2[o - ostep] = uc_prev;
    }
  }
  cluster.sync();                            // no block leaves while the other may reach it
}

// The transposed products, off the chain, with _stack_adj_call's h-shift
// in the row reads (terms of step W are zero), over the W*B rows:
//   output 0: uhs1_t = round(zbar2_t) . k2^T + dz2_t . vk2^T
//                      + dz1_{t+1} . vr1^T + round(zbar1_{t+1}) . rec1^T
//   output 1: uhs2_t = dz2_{t+1} . vr2^T + round(zbar2_{t+1}) . rec2^T
// A row's vector is its terms' rows end to end, each padded to a whole
// number of k pieces, and each term's (H, 4H) matrix is read by rows
// (tile::product's transposed B).  One (W*B, H) output tile a cluster of
// `splits` (1, 2 or 4) blocks along blockIdx.z (output = blockIdx.z /
// splits): block `split` sums a splits-th of the pieces, so that a tile's
// chain of pieces is shorter when there are few tiles (at the epoch's W*B a
// block's whole chain of 100 pieces made the pass latency-bound); then
// block `split` adds rows split, split + splits, ... of every thread's 4 x
// 4 tile over the cluster's blocks, in split order, through distributed
// shared memory: no atomics.
template <typename T>
__global__ void __launch_bounds__(tile::THREADS)
stack_adj_post_kernel(const T* __restrict__ rec1, const T* __restrict__ k2,
                      const T* __restrict__ rec2, StackAdjArgs a, int R, int B, int H) {
  using namespace tile;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(16) Smem s;
  __shared__ float4 sums[4][THREADS];       // row i of each thread's 4 x 4 tile
  const int G = 4 * H, seg = (G + K - 1) / K * K;
  const int m0 = blockIdx.x * M, n0 = blockIdx.y * N;
  const int tid = threadIdx.x;
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int out = blockIdx.z / splits;
  const int first = out ? 4 : 0;            // the output's first term
  auto piece = [&](int k0, float (&va)[LA], float (&vb)[LB]) {
    const int c0 = k0 % seg;
    const float* av;                         // the term's row vectors, (W*B, 4H)
    int shift;                               // rows: B reads step t+1
    bool rnd;                                // rounded to the operand dtype
    const T* mt = nullptr;                   // its matrix, operand dtype or float32
    const float* mf = nullptr;
    switch (first + k0 / seg) {
      case 0: av = a.zb2w, shift = 0, rnd = true, mt = k2; break;
      case 1: av = a.dz2w, shift = 0, rnd = false, mf = a.vk2; break;
      case 2: av = a.dz1w, shift = B, rnd = false, mf = a.vr1; break;
      case 3: av = a.uxz1, shift = B, rnd = true, mt = rec1; break;
      case 4: av = a.dz2w, shift = B, rnd = false, mf = a.vr2; break;
      default: av = a.zb2w, shift = B, rnd = true, mt = rec2; break;
    }
    // each load loop reads one type, and the rounding follows the loads, so
    // that a piece's loads are all in flight at once
#pragma unroll
    for (int u = 0; u < LA; ++u) {
      const int i = tid + u * THREADS;
      const int c = c0 + i % K, row = m0 + i / K + shift;
      va[u] = row < R && c < G ? av[row * G + c] : 0.0f;
    }
    if (rnd)
#pragma unroll
      for (int u = 0; u < LA; ++u) va[u] = round_to<T>(va[u]);
    if (mt != nullptr) {
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int c = c0 + i % K, n = n0 + i / K;
        vb[u] = c < G && n < H ? to_f(mt[n * G + c]) : 0.0f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int i = tid + u * THREADS;
        const int c = c0 + i % K, n = n0 + i / K;
        vb[u] = c < G && n < H ? mf[n * G + c] : 0.0f;
      }
    }
  };
  const int pieces = (out ? 2 : 4) * seg / K, per = (pieces + splits - 1) / splits;
  float acc[4][4];
  product<true>(piece, min(split * per, pieces) * K, min((split + 1) * per, pieces) * K, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) sums[i][tid] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  const int tx = tid % (N / 4), ty = tid / (N / 4);
  float* o = out ? a.uhs2 : a.uhs1;
  for (int i = split; i < 4; i += splits) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < splits; ++b) {
      const float4 p = cluster.map_shared_rank(&sums[i][0], b)[tid];
      v = b == 0 ? p : make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
    }
    const int r = m0 + 4 * ty + i;
    const float vv[4] = {v.x, v.y, v.z, v.w};
    if (r < R)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + 4 * tx + jj;
        if (n < H) o[r * H + n] = vv[jj];
      }
  }
  cluster.sync();                            // no block leaves while another reads its sums
}

template <typename T, int ACT>
cudaError_t launch_sweep_cluster(const void* rec1, const void* k2, const void* rec2,
                                 const StackAdjArgs& a, int W, int B, int H, int rows,
                                 cudaStream_t stream) {
  const size_t smem = ca::smem_bytes(H, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(stack_adj_cluster_kernel<T, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int clusters = (B + rows - 1) / rows;
  stack_adj_cluster_kernel<T, ACT><<<2 * clusters, cl::THREADS, smem, stream>>>(
      static_cast<const T*>(rec1), static_cast<const T*>(k2), static_cast<const T*>(rec2), a,
      W, B, H, rows);
  return cudaGetLastError();
}

// the pre-pass, the sweep, then the post-pass
template <typename T, int ACT>
cudaError_t launch_cluster(const void* xz1, const void* rec1, const void* k2, const void* b2,
                           const void* rec2, const StackAdjArgs& a, int W, int B, int H,
                           int rows, cudaStream_t stream) {
  if (H > 4 * cl::KS || static_cast<long long>(W) * B * 4 * H >= (1LL << 31))
    return cudaErrorInvalidValue;                // the kernels' 32-bit offsets
  const int R = W * B;
  const GatesArgs g{a.hs1, a.hs2, a.uxz1, a.zb2w, a.u1, a.vr1, a.vk2, a.vb2, a.vr2,
                    a.dz1w, a.dz2w};
  cudaError_t e = launch_gates<T, ACT, true>(xz1, rec1, k2, b2, rec2, g, R, B, H, stream);
  if (e == cudaSuccess) e = launch_sweep_cluster<T, ACT>(rec1, k2, rec2, a, W, B, H, rows, stream);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const dim3 tiles((R + tile::M - 1) / tile::M, (H + tile::N - 1) / tile::N, 2);
  const int splits = post_splits(static_cast<int>(tiles.x * tiles.y * tiles.z), sms);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles.x, tiles.y, tiles.z * splits);
  cfg.blockDim = dim3(tile::THREADS, 1, 1);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, stack_adj_post_kernel<T>, static_cast<const T*>(rec1),
                            static_cast<const T*>(k2), static_cast<const T*>(rec2), a, R, B, H);
}

enum { LAYOUT_CLUSTER = 0, LAYOUT_WIDE = 1 };

template <typename T>
cudaError_t launch_mode(int layout, int act, const void* xz1, const void* rec1,
                        const void* k2, const void* k2t, const void* b2, const void* rec2,
                        const void* rec2t, const StackAdjArgs& a, int W, int B, int H,
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

// The sweep, then ur1, uk2, ub2 and ur2 over the W*B rows, all on
// `stream`.  dz1w, dz2w, zb2w ((W, B, 4H)) and dhtb1w ((W, B, H)) are
// float32 workspaces.  `layout` (0 cluster, 1 wide), `threads` and
// `rows` (batch rows a cluster, or a block) are the wrapper's launch rule
// (cuda_lstm_stack.stack_adj_layout); the transposed copies (k2t, rec2t,
// vr1t, vk2t, vr2t) are read by the wide layout only and may be null in
// the cluster one.  Returns the first CUDA error of a launch (0 = ok).
int hfrep_stack_adj(const void* xz1, const void* rec1, const void* k2, const void* k2t,
                    const void* b2, const void* rec2, const void* rec2t, const void* vr1,
                    const void* vr1t, const void* vk2, const void* vk2t, const void* vb2,
                    const void* vr2, const void* vr2t, const void* hs1, const void* cs1,
                    const void* hs2, const void* cs2, const void* dhT1, const void* dcT1,
                    const void* dhT2, const void* dcT2, const void* u1, void* uxz1,
                    void* uhs1, void* ucs1, void* uhs2, void* ucs2, void* udhs2,
                    void* dz1w, void* dz2w, void* zb2w, void* dhtb1w, void* ur1,
                    void* uk2, void* ub2, void* ur2, int W, int B, int H, int act,
                    int bf16, int rows, int device, void* stream, int layout, int threads) {
  const int want = layout == LAYOUT_CLUSTER ? cl::THREADS : ((rows * H + 31) / 32) * 32;
  if (threads != want || (layout == LAYOUT_WIDE &&
                          (k2t == nullptr || rec2t == nullptr || vr1t == nullptr ||
                           vk2t == nullptr || vr2t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
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
  e = bf16 ? launch_mode<__nv_bfloat16>(layout, act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a,
                                       W, B, H, rows, s)
           : launch_mode<float>(layout, act, xz1, rec1, k2, k2t, b2, rec2, rec2t, a, W, B, H,
                                rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // mu_h1 of step t is dhTbar1 of step t-1, mu_h2 is udhs2 of step t-1:
  // ur1, uk2 and ur2 in one launch, then ub2
  ws::Batch sums{};
  sums.n = 3;
  sums.s[0] = ws::sum_of(mf(ur1), B, a.dhtb1w, a.dz1w, nullptr, a.hs1, a.uxz1);
  sums.s[1] = ws::sum_of(mf(uk2), 0, a.hs1, a.zb2w, nullptr, a.dhtb1w, a.dz2w);
  sums.s[2] = ws::sum_of(mf(ur2), B, a.udhs2, a.dz2w, nullptr, a.hs2, a.zb2w);
  e = ws::weight_sums(sums, 2, W * B, H, 4 * H, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ws::Batch bias{};
  bias.n = 1;
  bias.s[0] = ws::sum_of(mf(ub2), 0, nullptr, a.zb2w);
  e = ws::weight_sums(bias, 1, W * B, 1, 4 * H, s);
  return static_cast<int>(e);
}

// Clusters of the cluster layout (tanh) that can be resident on `device` at
// once at width H, by cudaOccupancyMaxActiveClusters; a negative value is a
// CUDA error code.
int hfrep_stack_adj_clusters(int H, int bf16, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const void* kern = bf16 ? reinterpret_cast<const void*>(
                                stack_adj_cluster_kernel<__nv_bfloat16, ACT_TANH>)
                          : reinterpret_cast<const void*>(stack_adj_cluster_kernel<float, ACT_TANH>);
  const size_t smem = ca::smem_bytes(H, bf16 ? 2 : 4);
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
