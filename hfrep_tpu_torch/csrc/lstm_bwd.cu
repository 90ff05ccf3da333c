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
// What bounds it.  At the generator's shape in the epoch (W=48, B=32,
// H=100, float32) it must move 7.1 MB (xz and dxz 2.46 MB each, hs, cs and
// dhs 0.61 MB each, rec and drec 0.16 MB each) — >= 2.1 us at 3.35 TB/s —
// and do 369 MFLOP (three products of 2*W*B*H*4H: the gate recompute, dz .
// rec^T and drec) — >= 5.5 us at 67 TFLOP/s float32 (carry0 adds h0, c0,
// dc_fin, dh0 and dc0, off the serial chain).  Neither sets the pace:
// dh_carry of step t is an input of step t-1, so the sweep is W dependent
// steps.  Only dz . rec^T sits on that chain; the recompute reads saved
// states alone, and drec is a sum over all rows.
//
// The register layout, for H <= 4*KS = 100, which every preset width takes
// (the first block of lstm_stack_bwd.cu's cluster, fed from dhs instead of
// a ring):
// - The recompute leaves the chain: lstm_stack.cuh's stack_gates_kernel
//   (the stack backward's pre-pass, its layer-1 product alone) forms every
//   step's gates for all W*B rows at once, a tiled float32 product with h0
//   as the head of h_{t-1} in carry0 (no tensor cores: TF32 or bf16
//   products of float32 operands would break the float32 bars), and writes
//   them into dxz, where the sweep writes dz later.
// - The sweep (lstm_bwd_kernel): one block of 416 threads a batch row (or
//   a few, walked one after another), a quad a hidden unit k: thread (k, q)
//   holds chunks c < KS of row k's gate-q columns of rec (lstm_stack.cuh's
//   bq layout), KR in registers and the rest in shared memory, so
//   dh_carry[k] = dz . rec^T[k] is 100 FMAs a thread against dz broadcast
//   from shared memory as float4s, and a quad sum of two shuffles that
//   leaves it in all four lanes.  Each lane runs unit k's gate math itself
//   (lane q keeps dz[q]), so the carries never leave the quad and a step
//   has one block barrier (dz double-buffered by step parity).
// - Each lane stages its gate's value and one of the step's state values a
//   step ahead (c_t, c_{t-1} — c0 at t = 0 in carry0 — dcs_t, dhs_t) with
//   cp.async, which holds no registers, and the quad trades them by
//   shuffles.  Loop offsets are 32-bit.
// - Registers: ptxas grants the 13 warps 128 registers a thread; KR is the
//   most chunks that spill in no instantiation (tools/
//   torch_stack_fwd_sweep.py --kernel lstm_bwd --rows), and the build phase
//   of chip_smoke.py fails on a spill.
// A width rec's rows cannot be dealt out to (100 < H) runs the wide layout
// (lstm_bwd_wide_kernel), the port's first backward, unchanged: one block
// owns a tile of batch rows and walks all W steps with the recompute on
// the chain; rec sits once in dynamic shared memory (160,400 B in float32
// at H=100, with a one-entry row pad) and is read there both ways: thread
// (b, j) reads column j of each gate block for the recompute and row j for
// dz . rec^T; h_{t-1} and dz of the tile's rows are staged in shared
// memory, two block barriers a step.  The wrapper chooses the layout by a
// rule on (H, dtype, B, SMs) (cuda_lstm.bwd_layout) and passes it here; it
// never tries one and falls back.  In both layouts drec, a sum over batch
// and time, is formed after the sweep by weight_sum.cuh over the W*B rows
// the sweep wrote, deterministically and without atomics.

#include "lstm_stack.cuh"
#include "weight_sum.cuh"

namespace {

using namespace hfrep;

template <typename T, int ACT, bool CARRY>
__global__ void lstm_bwd_wide_kernel(const T* __restrict__ xz,
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
  cudaError_t e = cudaFuncSetAttribute(lstm_bwd_wide_kernel<T, ACT, CARRY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_bwd_wide_kernel<T, ACT, CARRY><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.xz), static_cast<const T*>(a.rec), a.hs, a.cs, a.dhs, a.dcs,
      a.h0, a.c0, a.dcfin, a.dxz, a.dhT, a.dcT, a.dh0, a.dc0, a.W, a.B, a.H, a.rows);
  return cudaGetLastError();
}


// ----------------------------------------------------- register layout
// The gate recompute, off the chain, is lstm_stack.cuh's
// stack_gates_kernel, its layer-1 product alone: act(xz + round(h_{t-1})
// . rec) for all W*B rows, h0 the head of h_{t-1} in the carry mode,
// written into dxz, where the sweep writes dz later.

namespace rb {

using namespace bq;
// Of a thread's KS chunks of rec, the first KR_F32 (float32) or KR_BF16
// (bf16) are held in registers, the rest in shared memory: ptxas grants 13
// warps 128 registers a thread, and the counts that spill in no
// instantiation are found by compiling them
// (tools/torch_stack_fwd_sweep.py --kernel lstm_bwd --rows).
constexpr int KR_F32 = 17, KR_BF16 = 17;
template <typename T>
struct Keep {
  static constexpr int r = KR_F32;
};
template <>
struct Keep<__nv_bfloat16> {
  static constexpr int r = KR_BF16;
};

// The fixed part of the block's shared memory, in floats: two dz buffers,
// each thread's two staged step inputs for two steps, the chunks of rec
// past KR (a float4 a thread each).
__host__ __device__ constexpr int fixed_floats(size_t item) {
  return 8 * ZP + 4 * THREADS + 4 * (KS - (item == 4 ? KR_F32 : KR_BF16)) * THREADS;
}

// then a staging area for a PARTS-th of rec's rows, for the prologue
constexpr int PARTS = 2;
__host__ __device__ inline size_t smem_bytes(int H, size_t item) {
  return fixed_floats(item) * sizeof(float)
         + static_cast<size_t>((H + PARTS - 1) / PARTS) * 4 * H * item;
}

}  // namespace rb

// Launched after the pre-pass has written the gates into dxz, one block of
// bq::THREADS threads walking batch rows blockIdx.x * rows .. + rows - 1
// one after another, all W steps each.
template <typename T, int ACT, bool CARRY>
__global__ void __launch_bounds__(bq::THREADS, 1)
lstm_bwd_kernel(const T* __restrict__ rec, BwdArgs a) {
  using namespace rb;
  constexpr int KR = Keep<T>::r;
  extern __shared__ __align__(16) float fsm[];
  float* dz_s = fsm;                         // round(dz_t): 2 buffers (step parity) x 4 x ZP
  float* step_s = dz_s + 8 * ZP;             // step inputs: 2 (step parity) x THREADS x 2
  float4* rec_s = reinterpret_cast<float4*>(step_s + 4 * THREADS);   // chunks c >= KR
  T* stage = reinterpret_cast<T*>(fsm + fixed_floats(sizeof(T)));
  const int W = a.W, B = a.B, H = a.H, G = 4 * H;
  const int tid = threadIdx.x;
  const int q = tid & 3;                     // gate q's columns of row k; state stream q
  const int k = (tid >> 5) * 8 + ((tid & 31) >> 2);   // hidden unit: row k of rec
  const int base = tid & 28;                 // the quad's first lane
  const bool unit = k < H;

  // dz buffers start at zero; entries past H stay zero, multiplied by zero
  // weights.  rec, a PARTS-th of the rows at a time: chunks c < KR into
  // registers, the rest into shared memory.
  for (int i = tid; i < 8 * ZP; i += THREADS) dz_s[i] = 0.0f;
  float w[4][KR];
#pragma unroll
  for (int c = 0; c < KR; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e][c] = 0.0f;
  for (int c = 0; c < KS - KR; ++c) rec_s[c * THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int part = (H + PARTS - 1) / PARTS;
  for (int lo = 0; lo < H; lo += part) {
    const int n = min(part, H - lo);
    copy_issue<THREADS>(rec + static_cast<size_t>(lo) * G, stage, n * G);
    copy_wait();
    deal_rec<T, KR>(stage, lo, n, H, q, k, unit, w, rec_s);
    __syncthreads();                         // the staged rows are read
  }

  // 32-bit element offsets (the launch checks that W*B*4H fits)
  const int xstep = B * G;
  const int ostep = B * H;
  const int back = q == 1 ? ostep : 0;       // lane 1 reads c_{t-1}
  const float* sp = q < 2 ? a.cs : q == 2 ? a.dcs : a.dhs;
  unsigned n = 0;                            // steps so far: dz buffer and step inputs n % 2
  for (int r = 0; r < a.rows; ++r) {
    const int b = blockIdx.x * a.rows + r;
    if (b >= B) break;                       // the same for the whole block
    __syncthreads();
    const int sb = b * H + (unit ? k : 0);   // (B, H) offset of the carry-mode arrays
    const float* first = CARRY ? a.c0 + sb : nullptr;
    float dh = 0.0f;
    float dc = CARRY && a.dcfin != nullptr ? a.dcfin[sb] : 0.0f;
    int o = ((W - 1) * B + b) * H + (unit ? k : 0);        // (W, B, H) offset, step t
    int og = ((W - 1) * B + b) * G + (unit ? q * H + k : 0);   // gate q's, (W, B, 4H)
    stage_step(step_s + ((n & 1u) * THREADS + tid) * 2, a.dxz, og, sp, o, back, W - 1, unit,
               first);
    for (int t = W - 1; t >= 0; --t, ++n) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      const float* st = step_s + ((n & 1u) * THREADS + tid) * 2;
      const float gq = st[0], sq = st[1];
      if (t > 0)
        stage_step(step_s + (((n + 1) & 1u) * THREADS + tid) * 2, a.dxz, og - xstep, sp,
                   o - ostep, back, t - 1, unit, first);
      const float ig = from_lane(gq, base, 0), fg = from_lane(gq, base, 1);
      const float gc = from_lane(gq, base, 2), og4 = from_lane(gq, base, 3);
      const float c = from_lane(sq, base, 0), cp = from_lane(sq, base, 1);
      const float dcs = from_lane(sq, base, 2), dhs = from_lane(sq, base, 3);
      const float a_c = act_f<ACT>(c);
      const float dht = dhs + dh;
      const float d_out = dht * a_c;
      float dct = dc + dht * og4 * act_prime<ACT>(a_c);
      if (a.dcs != nullptr) dct = dct + dcs;
      const float dzq = q == 0   ? dct * gc * ig * (1.0f - ig)
                        : q == 1 ? dct * cp * fg * (1.0f - fg)
                        : q == 2 ? dct * ig * act_prime<ACT>(gc)
                                 : d_out * og4 * (1.0f - og4);
      dc = dct * fg;
      const int buf = static_cast<int>(n & 1u) * 4 * ZP;
      if (unit) {
        a.dxz[og] = dzq;
        if (a.dhT != nullptr) {
          if (q == 0) a.dhT[o] = dht;
          if (q == 1) a.dcT[o] = dct;
        }
        dz_s[buf + q * ZP + k] = round_to<T>(dzq);
      }
      __syncthreads();
      dh = quad_sum(dot_rec<KR>(reinterpret_cast<const float4*>(dz_s + buf + q * ZP), w, rec_s,
                                tid));
      o -= ostep;
      og -= xstep;
    }
    // after step 0: the carries into the injected state are its cotangents
    if (CARRY && unit) {
      if (q == 0) a.dh0[sb] = dh;
      if (q == 1) a.dc0[sb] = dc;
    }
  }
}

// the pre-pass, then the sweep
template <typename T, int ACT, bool CARRY>
cudaError_t launch_registers(const BwdArgs& a, cudaStream_t stream) {
  if (a.H > 4 * bq::KS || static_cast<long long>(a.W) * a.B * 4 * a.H >= (1LL << 31))
    return cudaErrorInvalidValue;                // the layout's width, its 32-bit offsets
  GatesArgs g{};
  g.hs1 = a.hs, g.g1 = a.dxz, g.h0 = a.h0;
  cudaError_t e = launch_gates<T, ACT, false>(a.xz, a.rec, nullptr, nullptr, nullptr, g,
                                              a.W * a.B, a.B, a.H, stream, true);
  if (e != cudaSuccess) return e;
  const size_t smem = rb::smem_bytes(a.H, sizeof(T));
  e = cudaFuncSetAttribute(lstm_bwd_kernel<T, ACT, CARRY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  lstm_bwd_kernel<T, ACT, CARRY><<<(a.B + a.rows - 1) / a.rows, bq::THREADS, smem, stream>>>(
      static_cast<const T*>(a.rec), a);
  return cudaGetLastError();
}

enum { LAYOUT_REGISTERS = 0, LAYOUT_WIDE = 1 };

template <typename T, int ACT, bool CARRY>
cudaError_t launch_layout(const BwdArgs& a, int layout, cudaStream_t s) {
  if (layout == LAYOUT_WIDE) return launch_sweep<T, ACT, CARRY>(a, s);
  if (layout == LAYOUT_REGISTERS) return launch_registers<T, ACT, CARRY>(a, s);
  return cudaErrorInvalidValue;
}

template <typename T, bool CARRY>
cudaError_t launch_act(const BwdArgs& a, int act, int layout, cudaStream_t s) {
  switch (act) {
    case ACT_LINEAR: return launch_layout<T, ACT_LINEAR, CARRY>(a, layout, s);
    case ACT_SIGMOID: return launch_layout<T, ACT_SIGMOID, CARRY>(a, layout, s);
    case ACT_TANH: return launch_layout<T, ACT_TANH, CARRY>(a, layout, s);
    default: return cudaErrorInvalidValue;
  }
}

// The sweep in `layout` (0 registers, 1 wide; `threads` the block's
// threads), then drec = sum h_{t-1}^T dz over the W*B rows (h0 the head
// of h_{t-1} in carry0 mode), all on `stream`.
int run(const BwdArgs& a, void* drec, int act, int bf16, int device, void* stream, int layout,
        int threads) {
  const int want = layout == LAYOUT_REGISTERS ? bq::THREADS : ((a.rows * a.H + 31) / 32) * 32;
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
  sum.s[0] = ws::sum_of(static_cast<float*>(drec), a.B, a.hs, a.dxz, a.h0);
  e = ws::weight_sums(sum, 1, a.W * a.B, a.H, 4 * a.H, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// The sweep and drec on `stream`.  dcs null: no direct cell-state
// cotangent; dhT/dcT null: no carries.  Returns the first CUDA error of a
// launch (0 = ok).
int hfrep_lstm_bwd(const void* xz, const void* rec, const void* hs,
                   const void* cs, const void* dhs, const void* dcs, void* dxz,
                   void* dhT, void* dcT, void* drec, int W, int B, int H, int act,
                   int bf16, int rows, int device, void* stream, int layout, int threads) {
  const BwdArgs a{xz, rec, static_cast<const float*>(hs), static_cast<const float*>(cs),
                  static_cast<const float*>(dhs), static_cast<const float*>(dcs),
                  nullptr, nullptr, nullptr, static_cast<float*>(dxz),
                  static_cast<float*>(dhT), static_cast<float*>(dcT), nullptr, nullptr,
                  W, B, H, rows};
  return run(a, drec, act, bf16, device, stream, layout, threads);
}

// The carry0 mode, combinable with dcs and dhT/dcT as above: step 0 reads
// h0 and c0 (B, H), the dc carry starts at dc_fin (null: zero), and the
// cotangents of h0 and c0 go to dh0 and dc0 (B, H).
int hfrep_lstm_bwd_carry(const void* xz, const void* rec, const void* hs,
                         const void* cs, const void* dhs, const void* dcs,
                         const void* h0, const void* c0, const void* dcfin,
                         void* dxz, void* dhT, void* dcT, void* dh0, void* dc0,
                         void* drec, int W, int B, int H, int act, int bf16, int rows,
                         int device, void* stream, int layout, int threads) {
  if (h0 == nullptr || c0 == nullptr || dh0 == nullptr || dc0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{xz, rec, static_cast<const float*>(hs), static_cast<const float*>(cs),
                  static_cast<const float*>(dhs), static_cast<const float*>(dcs),
                  static_cast<const float*>(h0), static_cast<const float*>(c0),
                  static_cast<const float*>(dcfin), static_cast<float*>(dxz),
                  static_cast<float*>(dhT), static_cast<float*>(dcT),
                  static_cast<float*>(dh0), static_cast<float*>(dc0), W, B, H, rows};
  return run(a, drec, act, bf16, device, stream, layout, threads);
}

}  // extern "C"
