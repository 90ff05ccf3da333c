// Single-layer LSTM backward sweep for Hopper (sm_90a).
//
// Replaces: hfrep_tpu/ops/pallas_lstm.py::_bwd_kernel, launched through
// _bwd_call: the backward of lstm_fwd_res (with a direct cell-state
// cotangent, dcs, at second order) and the primal of lstm_bwd_seq (with
// the per-step carries the adjoint needs), each also in the carry0 mode
// (lstm_fwd_res_carry's backward, lstm_bwd_seq_carry), with any mix of
// the three.  Walks t = W-1 .. 0 with the carries dh and dc starting at
// zero (carry0: dc at dc_fin, the cotangent of the emitted final c, zero
// when not given); step 0's previous state is zero (_shifted), or the
// injected (h0, c0).  Per step, recomputing the gates from the saved
// h_{t-1}:
//
//     z      = xz_t + h_{t-1} . rec            gates i, f, g = act(z_c), o
//     dh     = dhs_t + dh_carry
//     dc     = dc_carry + dh * o * act'(act(c_t)) [+ dcs_t]
//     dz     = [dc g i(1-i), dc c_{t-1} f(1-f), dc i act'(g), dh act(c_t) o(1-o)]
//     dxz_t  = dz;  [dhT_t = dh, dcT_t = dc]
//     dh_carry = dz . rec^T;   dc_carry = dc * f
//
// and then drec = sum_t h_{t-1}^T dz_t (carry0: its t = 0 term is
// h0^T dz_0, the reduction's head operand).  carry0 also writes the
// carries left after step 0, dh0 = dz_0 . rec^T and dc0 = dc_0 * f_0: the
// cotangents of h0 and c0.  The mode is a template flag (CARRY), so the
// carry-free instantiation is the code it was before the mode existed;
// h0, c0, dc_fin, dh0 and dc0 are float32 (B, H).  Operands xz and rec are float32
// or bf16; hs, cs, dhs, dcs and every output are float32.  As in the TPU
// kernel, h_{t-1} is rounded to the operand dtype before the dot with rec
// and dz before the dot with rec^T; drec is formed from the float32
// values.  Sigmoid is 1/(1+expf(-x)), no fast math.
//
// What bounds it.  At the critic's shape in the epoch (W=48, B=64, H=100,
// float32) it must move 13.84 MB (xz and dxz 4.92 MB each, hs, cs and dhs
// 1.23 MB each, rec and drec 0.16 MB each) — >= 4.1 us at 3.35 TB/s — and
// do 737 MFLOP (three products of 2*W*B*H*4H: the gate recompute, dz .
// rec^T and drec) — >= 11.0 us at 67 TFLOP/s float32 (carry0 adds h0, c0,
// dc_fin, dh0 and dc0: 0.13 MB, off the serial chain).  Neither sets the
// pace: dh_carry of step t is an input of step t-1, so the sweep is W
// dependent steps, each two dot chains (length H, then length 4H) and two
// block barriers.
//
// What the design does about it.  One block owns a tile of batch rows and
// walks all W steps itself, as the TPU's sequential grid did.  rec sits
// once in dynamic shared memory (160,400 B in float32 at H=100, with a
// one-entry row pad) and is read there both ways: thread (b, j) reads
// column j of each gate block for the recompute (neighbouring threads,
// neighbouring words) and row j for dz . rec^T (the pad puts neighbouring
// rows in other banks).  h_{t-1} and dz of the tile's rows are staged in
// shared memory; dh_carry and dc_carry stay in registers, since thread j
// both produces and consumes unit j.  drec, a sum over batch and time,
// is not accumulated in the sweep: blocks run in no order, so a second
// kernel (lstm_common.cuh: outer_sum) reduces h_{t-1}^T dz over the W*B
// rows the sweep wrote, deterministically and without atomics.  The
// wrapper refuses a width whose rec does not fit one block.

#include "lstm_common.cuh"

namespace {

using namespace hfrep;

template <typename T, int ACT, bool CARRY>
__global__ void lstm_bwd_kernel(const T* __restrict__ xz,
                                const T* __restrict__ rec,
                                const float* __restrict__ hs,
                                const float* __restrict__ cs,
                                const float* __restrict__ dhs,
                                const float* __restrict__ dcs,   // nullable
                                const float* __restrict__ h0,    // CARRY
                                const float* __restrict__ c0,    // CARRY
                                const float* __restrict__ dcfin, // CARRY, nullable
                                float* __restrict__ dxz,
                                float* __restrict__ dhT,         // nullable
                                float* __restrict__ dcT,         // nullable
                                float* __restrict__ dh0,         // CARRY
                                float* __restrict__ dc0,         // CARRY
                                int W, int B, int H, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * H;
  const int ld = G + 1;
  T* rec_s = reinterpret_cast<T*>(smem_raw);                          // H x ld
  float* hp_s = reinterpret_cast<float*>(smem_raw + rec_smem_bytes(H, sizeof(T)));
  float* dz_s = hp_s + static_cast<size_t>(rows) * H;                 // rows x G

  const int tid = threadIdx.x;
  for (int i = tid; i < H * G; i += blockDim.x) {
    const int k = i / G;
    rec_s[static_cast<size_t>(k) * ld + (i - k * G)] = rec[i];
  }

  const int bl = tid / H;                 // row inside the tile
  const int j = tid - bl * H;             // hidden unit
  const int b = blockIdx.x * rows + bl;   // batch row
  const bool live = bl < rows && b < B;
  const size_t hstep = static_cast<size_t>(B) * H;
  float* hp_row = hp_s + bl * H;
  float* dz_row = dz_s + static_cast<size_t>(bl) * G;
  const size_t st = static_cast<size_t>(live ? b : 0) * H + j;   // (B, H) carry
  float dh_c = 0.f;
  float dc_c = CARRY && live && dcfin != nullptr ? dcfin[st] : 0.f;

  for (int t = W - 1; t >= 0; --t) {
    const size_t o = (static_cast<size_t>(t) * B + b) * H + j;
    if (live) hp_row[j] = t > 0 ? round_to<T>(hs[o - hstep])
                                : (CARRY ? round_to<T>(h0[st]) : 0.f);
    __syncthreads();
    if (live) {
      const T* xr = xz + (static_cast<size_t>(t) * B + b) * G + j;
      float di = 0.f, df = 0.f, dg = 0.f, d_o = 0.f;
      const T* col = rec_s + j;
      for (int k = 0; k < H; ++k) {
        const float hk = hp_row[k];
        const T* r = col + static_cast<size_t>(k) * ld;
        di = fmaf(hk, to_f(r[0]), di);
        df = fmaf(hk, to_f(r[H]), df);
        dg = fmaf(hk, to_f(r[2 * H]), dg);
        d_o = fmaf(hk, to_f(r[3 * H]), d_o);
      }
      const float ig = sigmoid_f(to_f(xr[0]) + di);
      const float fg = sigmoid_f(to_f(xr[H]) + df);
      const float gc = act_f<ACT>(to_f(xr[2 * H]) + dg);
      const float og = sigmoid_f(to_f(xr[3 * H]) + d_o);
      const float c = cs[o];
      const float c_prev = t > 0 ? cs[o - hstep] : (CARRY ? c0[st] : 0.f);
      const float a_c = act_f<ACT>(c);

      const float dh = dhs[o] + dh_c;
      const float d_out = dh * a_c;
      const float dzo = d_out * og * (1.0f - og);
      float dc = dc_c + dh * og * act_prime<ACT>(a_c);
      if (dcs != nullptr) dc = dc + dcs[o];
      const float dzi = dc * gc * ig * (1.0f - ig);
      const float dzf = dc * c_prev * fg * (1.0f - fg);
      const float dzc = dc * ig * act_prime<ACT>(gc);

      float* dr = dxz + (static_cast<size_t>(t) * B + b) * G + j;
      dr[0] = dzi;
      dr[H] = dzf;
      dr[2 * H] = dzc;
      dr[3 * H] = dzo;
      if (dhT != nullptr) {
        dhT[o] = dh;
        dcT[o] = dc;
      }
      dz_row[j] = round_to<T>(dzi);
      dz_row[H + j] = round_to<T>(dzf);
      dz_row[2 * H + j] = round_to<T>(dzc);
      dz_row[3 * H + j] = round_to<T>(dzo);
      dc_c = dc * fg;
    }
    __syncthreads();
    if (live) {                            // dh_carry = dz . rec^T, row j
      const T* rr = rec_s + static_cast<size_t>(j) * ld;
      float acc = 0.f;
      for (int m = 0; m < G; ++m) acc = fmaf(dz_row[m], to_f(rr[m]), acc);
      dh_c = acc;
    }
  }
  // after step 0: the carries into the injected state are its cotangents
  if (CARRY && live) {
    dh0[st] = dh_c;
    dc0[st] = dc_c;
  }
}

struct BwdArgs {
  const void* xz;
  const void* rec;
  const float* hs;
  const float* cs;
  const float* dhs;
  const float* dcs;     // null: no direct cell-state cotangent
  const float* h0;      // null: no carry
  const float* c0;
  const float* dcfin;   // null: zero
  float* dxz;
  float* dhT;           // null: no per-step carries
  float* dcT;
  float* dh0;
  float* dc0;
  int W, B, H, rows;
};

template <typename T, int ACT, bool CARRY>
cudaError_t launch_sweep(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = rec_smem_bytes(a.H, sizeof(T))
                      + static_cast<size_t>(a.rows) * 5 * a.H * sizeof(float);
  const int threads = ((a.rows * a.H + 31) / 32) * 32;
  const int blocks = (a.B + a.rows - 1) / a.rows;
  cudaError_t e = cudaFuncSetAttribute(lstm_bwd_kernel<T, ACT, CARRY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_bwd_kernel<T, ACT, CARRY><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.xz), static_cast<const T*>(a.rec), a.hs, a.cs, a.dhs, a.dcs,
      a.h0, a.c0, a.dcfin, a.dxz, a.dhT, a.dcT, a.dh0, a.dc0, a.W, a.B, a.H, a.rows);
  return cudaGetLastError();
}

template <typename T, bool CARRY>
cudaError_t launch_act(const BwdArgs& a, int act, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR: return launch_sweep<T, ACT_LINEAR, CARRY>(a, s);
    case ACT_SIGMOID: return launch_sweep<T, ACT_SIGMOID, CARRY>(a, s);
    case ACT_TANH: return launch_sweep<T, ACT_TANH, CARRY>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The sweep, then drec = sum h_{t-1}^T dz over the W*B rows (h0 the head
// of h_{t-1} in carry0 mode), both on `stream`.
int run(const BwdArgs& a, void* drec, void* part, int act, int bf16, int splits,
        int rows_per_split, int device, void* stream) {
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
  e = outer_sum<1>(a.hs, a.dxz, nullptr, nullptr, static_cast<float*>(drec),
                   static_cast<float*>(part), a.W * a.B, a.B, a.H, 4 * a.H, splits,
                   rows_per_split, s, a.h0);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// The sweep and drec on `stream`.  dcs null: no direct cell-state
// cotangent; dhT/dcT null: no carries.  `part` holds splits x H x 4H
// floats when splits > 1.  Returns the first CUDA error of a launch (0 = ok).
int hfrep_lstm_bwd(const void* xz, const void* rec, const void* hs,
                   const void* cs, const void* dhs, const void* dcs, void* dxz,
                   void* dhT, void* dcT, void* drec, void* part, int W, int B,
                   int H, int act, int bf16, int rows, int splits,
                   int rows_per_split, int device, void* stream) {
  const BwdArgs a{xz, rec, static_cast<const float*>(hs), static_cast<const float*>(cs),
                  static_cast<const float*>(dhs), static_cast<const float*>(dcs),
                  nullptr, nullptr, nullptr, static_cast<float*>(dxz),
                  static_cast<float*>(dhT), static_cast<float*>(dcT), nullptr, nullptr,
                  W, B, H, rows};
  return run(a, drec, part, act, bf16, splits, rows_per_split, device, stream);
}

// The carry0 mode, combinable with dcs and dhT/dcT as above: step 0 reads
// h0 and c0 (B, H), the dc carry starts at dc_fin (null: zero), and the
// cotangents of h0 and c0 go to dh0 and dc0 (B, H).
int hfrep_lstm_bwd_carry(const void* xz, const void* rec, const void* hs,
                         const void* cs, const void* dhs, const void* dcs,
                         const void* h0, const void* c0, const void* dcfin,
                         void* dxz, void* dhT, void* dcT, void* dh0, void* dc0,
                         void* drec, void* part, int W, int B, int H, int act,
                         int bf16, int rows, int splits, int rows_per_split,
                         int device, void* stream) {
  if (h0 == nullptr || c0 == nullptr || dh0 == nullptr || dc0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{xz, rec, static_cast<const float*>(hs), static_cast<const float*>(cs),
                  static_cast<const float*>(dhs), static_cast<const float*>(dcs),
                  static_cast<const float*>(h0), static_cast<const float*>(c0),
                  static_cast<const float*>(dcfin), static_cast<float*>(dxz),
                  static_cast<float*>(dhT), static_cast<float*>(dcT),
                  static_cast<float*>(dh0), static_cast<float*>(dc0), W, B, H, rows};
  return run(a, drec, part, act, bf16, splits, rows_per_split, device, stream);
}

}  // extern "C"
