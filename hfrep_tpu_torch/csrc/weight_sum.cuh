// The weight sums of every backward and adjoint kernel (lstm_bwd.cu,
// lstm_adj.cu, lstm_stack_bwd.cu, lstm_stack_adj.cu) for Hopper (sm_90a).
//
// Replaces: the weight-gradient sums the TPU kernels form in their own
// body, across their sequential grid — hfrep_tpu/ops/pallas_lstm.py
// _bwd_kernel's drec (:336) and _adj_kernel's urec, and
// pallas_lstm_stack.py _stack_bwd_kernel's drec1, dk2, db2, drec2
// (:176-188) and _stack_adj_kernel's ur1, uk2, ub2, ur2.
//
// What it computes.  C (M, N) = sum_p A_p'^T B_p over R rows, for up to
// two pairs (A_p (R, M), B_p (R, N), float32), where A_p' is A_p moved
// down by `shift` rows: its first `shift` rows are the head operand (the
// carry modes' step-0 state, h0 or the adjoint's mu_h0, a (shift, M)
// array), or zeros without one (the previous-step sequence of a
// time-major (W, B, H) array is the array moved down by B rows).  A null
// A_p is a column of ones (M = 1): C is then the column sums of B_p, as a
// bias gradient needs.  Up to MAX_SUMS sums of the same shape (one call's
// products, each with its own operands, shift and output) go in one launch.
//
// What bounds it.  At the epoch's shapes (R = W*B = 1536 .. 10752, M = 100,
// N = 400) a one-pair sum reads 3.1-21.5 MB and does 2*R*M*N = 0.12-0.86
// GFLOP: >= 1.8-12.8 us at 67 TFLOP/s float32 (no tensor cores: TF32 or
// bf16 products of float32 operands would break the float32 bars), and
// >= 0.9-6.4 us of memory.  Operations bound it.  But an (M, N) output of
// 100 x 400 is only 2 x 7 tiles of 64 x 64, for 132 SMs: a tile a block
// walking all R rows would leave most of the card idle and wait on one
// block's chain of R / 16 pieces.
//
// What the design does about it.
// - Tiles: 64 x 64 outputs a block, each thread a TM x TM = 8 x 8 tile of
//   sums (its rows and columns in float4 groups 32 apart, so a piece's
//   shared-memory reads are float4s without bank conflicts: four for 64
//   FMAs, where a 4 x 4 tile's two for 16 measured slower, PERF.md); the
//   k range goes K = 16 rows at a time through shared memory,
//   the next piece loaded into registers while the current one is
//   multiplied.  A and B are read row by row (neighbouring threads,
//   neighbouring words; float4 loads where M and N are multiples of four),
//   so no operand is transposed first.  64 threads a block: the splits
//   below give the SMs several blocks each.
// - A two-pair sum is one k range: pair 0's rows, then pair 1's, each
//   padded to whole pieces.
// - Splits: the k range of each output tile is split over a thread-block
//   cluster of 1, 2, 4, 8 or 16 blocks (along blockIdx.z; 16 is a
//   non-portable cluster size the H100 takes); each block sums its
//   part of the pieces in order, then block `split` adds a split-th of the
//   cluster's partial tiles, in split order, through distributed shared
//   memory and writes them.  No atomics and no workspace: each output adds
//   its pieces in a fixed order, so two launches give the same bits.  The
//   cluster size is a rule on the tile and piece counts and the SM count
//   (splits_for; its Python twin is cuda_lstm.sum_splits).
// - The bias sums (M = 1) take their own kernel, a column sum: threads read
//   neighbouring columns (float4s) of B's rows, 16 row lanes a block,
//   added in lane order, then over the cluster in split order.
// - A null head and a head of zeros give the same bits: the rows above the
//   shift are read as zero or as the head and go through the same FMAs.
// - Counted where launched: weight_sums adds one to its launch shape's
//   counter at each launch it makes; every library that includes this
//   header exports its own counters (hfrep_weight_sum_launches, below).

#pragma once

#include <cooperative_groups.h>

#include <atomic>

#include "lstm_common.cuh"

namespace hfrep {
namespace ws {

constexpr int BM = 64, BN = 64, K = 16;   // output tile, rows a piece
constexpr int MAX_SUMS = 3;
// the most blocks a cluster may have on the H100 (past 8, the portable
// size, a launch opts in to non-portable cluster sizes)
constexpr int MAX_SPLITS = 16;
// the split rule: the most of 16, 8, 4, 2, 1 blocks an output tile that
// keeps the launch within BLOCKS_PER_SM blocks an SM and gives each block
// at least MIN_PIECES pieces of K rows
constexpr int BLOCKS_PER_SM = 8, MIN_PIECES = 4;
// a thread's tile of sums, TM x TM, and the threads of a block
constexpr int TM = 8, THREADS = (BM / TM) * (BN / TM);
// the column sum: CX column groups (of four columns with float4 loads) by
// RY row lanes
constexpr int CS_THREADS = 256, CX = 16, RY = CS_THREADS / CX;

struct Sum {
  const float* a[2];      // (R, M) row operands; null: a column of ones
  const float* b[2];      // (R, N)
  const float* head[2];   // (shift, M) head operands; null: zeros
  float* out;             // (M, N)
  int shift;
};

struct Batch {
  Sum s[MAX_SUMS];
  int n;
};

__host__ inline int splits_for(int tiles, int pieces, int sms) {
  for (int s = MAX_SPLITS; s > 1; s /= 2)
    if (s * tiles <= BLOCKS_PER_SM * sms && pieces >= s * MIN_PIECES) return s;
  return 1;
}

// sum `which` of the batch, read with constant indices (a dynamic index
// into the parameter space would copy the batch to local memory)
__device__ __forceinline__ Sum pick(const Batch& batch, int which) {
  Sum s = batch.s[0];
#pragma unroll
  for (int i = 1; i < MAX_SUMS; ++i)
    if (which == i) s = batch.s[i];
  return s;
}

// V entries of A_p' at row r, columns m .. m + V - 1 (all within M or all
// past it)
template <int V>
__device__ __forceinline__ void a_row(const float* a, const float* head, int r, int m, int R,
                                      int M, int shift, float (&v)[V]) {
  const float* p = nullptr;
  float fill = 0.0f;
  if (r < R && m < M) {
    if (r >= shift) {
      if (a != nullptr) p = a + static_cast<size_t>(r - shift) * M + m;
      else fill = 1.0f;
    } else if (head != nullptr) {
      p = head + static_cast<size_t>(r) * M + m;
    }
  }
  if (V == 4 && p != nullptr) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[V > 1 ? 1 : 0] = x.y, v[V > 2 ? 2 : 0] = x.z, v[V > 3 ? 3 : 0] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = p != nullptr ? __ldg(p + e) : fill;
  }
}

// V entries of B at row r, columns n .. n + V - 1
template <int V>
__device__ __forceinline__ void b_row(const float* b, int r, int n, int R, int N,
                                      float (&v)[V]) {
  if (r < R && n < N) {
    const float* p = b + static_cast<size_t>(r) * N + n;
    if (V == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = x.x, v[V > 1 ? 1 : 0] = x.y, v[V > 2 ? 2 : 0] = x.z, v[V > 3 ? 3 : 0] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __ldg(p + e);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.0f;
  }
}

// One 64 x 64 output tile of sum blockIdx.y / mtiles, a split-th of its
// pieces (blockIdx.z, the rank in the cluster), then the cluster's
// partial tiles added in split order.  V = 4: float4 loads (M and N
// multiples of four, operands 16-byte aligned).
template <int V>
__global__ void __launch_bounds__(THREADS)
weight_sum_kernel(Batch batch, int npair, int R, int M, int N) {
  namespace cg = cooperative_groups;
  constexpr int T = THREADS;
  constexpr int QM = TM / 4;              // float4 groups of a thread's rows (columns)
  constexpr int GS = BM / QM;             // their stride
  constexpr int NU = K * BM / V / T;      // loads of V entries a thread a piece, each operand
  constexpr int U = TM * QM;              // float4s of a thread's tile
  __shared__ __align__(16) float as[K][BM + 4];
  __shared__ __align__(16) float bs[K][BN + 4];
  __shared__ __align__(16) float4 red[U][T];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int mtiles = (M + BM - 1) / BM;
  const Sum s = pick(batch, blockIdx.y / mtiles);
  const int m0 = (blockIdx.y % mtiles) * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TM), ty = tid / (BN / TM);
  const int rp = (R + K - 1) / K * K;     // a pair's rows, in whole pieces
  const int pieces = npair * rp / K, per = (pieces + splits - 1) / splits;
  const int kb = min(split * per, pieces) * K, ke = min((split + 1) * per, pieces) * K;

  float va[NU][V], vb[NU][V];
  auto piece = [&](int k0) {
    const int p = k0 >= rp;
    const float* a = p ? s.a[1] : s.a[0];
    const float* hd = p ? s.head[1] : s.head[0];
    const float* b = p ? s.b[1] : s.b[0];
    const int r0 = k0 - p * rp;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int i = tid + u * T;
      const int kk = i / (BM / V), c = i % (BM / V) * V;
      a_row<V>(a, hd, r0 + kk, m0 + c, R, M, s.shift, va[u]);
      b_row<V>(b, r0 + kk, n0 + c, R, N, vb[u]);
    }
  };
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
  if (kb < ke) piece(kb);
  for (int k0 = kb; k0 < ke; k0 += K) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int i = tid + u * T;
      const int kk = i / (BM / V), c = i % (BM / V) * V;
      if (V == 4) {
        *reinterpret_cast<float4*>(&as[kk][c]) =
            make_float4(va[u][0], va[u][V > 1 ? 1 : 0], va[u][V > 2 ? 2 : 0], va[u][V > 3 ? 3 : 0]);
        *reinterpret_cast<float4*>(&bs[kk][c]) =
            make_float4(vb[u][0], vb[u][V > 1 ? 1 : 0], vb[u][V > 2 ? 2 : 0], vb[u][V > 3 ? 3 : 0]);
      } else {
        as[kk][c] = va[u][0];
        bs[kk][c] = vb[u][0];
      }
    }
    __syncthreads();
    if (k0 + K < ke) piece(k0 + K);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float av[TM], bv[TM];
#pragma unroll
      for (int g = 0; g < QM; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(&as[kk][g * GS + 4 * ty]);
        const float4 y = *reinterpret_cast<const float4*>(&bs[kk][g * GS + 4 * tx]);
        av[4 * g] = x.x, av[4 * g + 1] = x.y, av[4 * g + 2] = x.z, av[4 * g + 3] = x.w;
        bv[4 * g] = y.x, bv[4 * g + 1] = y.y, bv[4 * g + 2] = y.z, bv[4 * g + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  // thread tile row i, column group g: float4 i * QM + g
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < QM; ++g)
      red[i * QM + g][tid] = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                         acc[i][4 * g + 3]);
  cluster.sync();
  const int chunk = U * T / splits;
  for (int f = split * chunk + tid; f < (split + 1) * chunk; f += T) {
    float4 v = cluster.map_shared_rank(&red[0][0], 0)[f];
    for (int b = 1; b < splits; ++b) {
      const float4 q = cluster.map_shared_rank(&red[0][0], b)[f];
      v = make_float4(v.x + q.x, v.y + q.y, v.z + q.z, v.w + q.w);
    }
    const int q = f / T, t = f % T, i = q / QM, g = q % QM;
    const int m = m0 + (i / 4) * GS + 4 * (t / (BN / TM)) + i % 4;
    const int n = n0 + g * GS + 4 * (t % (BN / TM));
    if (m < M) {
      float* o = s.out + static_cast<size_t>(m) * N + n;
      if (V == 4 && n < N) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = vv[e];
      }
    }
  }
  cluster.sync();                          // no block leaves while another reads its tiles
}

// The M = 1 sums: C[n] = sum over the npair * R rows of A_p'[r] B_p[r, n],
// sum blockIdx.y, columns blockIdx.x * CX * V .., a split-th of the rows
// (blockIdx.z), thread (row lane ry, column group cx) rows ry, ry + RY, ...
template <int V>
__global__ void __launch_bounds__(CS_THREADS)
col_sum_kernel(Batch batch, int npair, int R, int N) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) float4 lane[RY][CX];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const Sum s = pick(batch, blockIdx.y);
  const int tid = threadIdx.x, cx = tid % CX, ry = tid / CX;
  const int n = (blockIdx.x * CX + cx) * V;
  const int total = npair * R, per = (total + splits - 1) / splits;
  const int gb = min(split * per, total), ge = min((split + 1) * per, total);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int g = gb + ry; g < ge; g += RY) {
    const int p = g >= R, r = g - p * R;
    float av[1], bv[V];
    a_row<1>(p ? s.a[1] : s.a[0], p ? s.head[1] : s.head[0], r, 0, R, 1, s.shift, av);
    b_row<V>(p ? s.b[1] : s.b[0], r, n, R, N, bv);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = fmaf(av[0], bv[e], acc[e]);
  }
  lane[ry][cx] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (ry == 0) {
    float4 v = lane[0][cx];
    for (int y = 1; y < RY; ++y) {
      const float4 q = lane[y][cx];
      v = make_float4(v.x + q.x, v.y + q.y, v.z + q.z, v.w + q.w);
    }
    lane[0][cx] = v;
  }
  cluster.sync();
  if (tid < CX && tid % splits == split && n < N) {
    float4 v = cluster.map_shared_rank(&lane[0][0], 0)[tid];
    for (int b = 1; b < splits; ++b) {
      const float4 q = cluster.map_shared_rank(&lane[0][0], b)[tid];
      v = make_float4(v.x + q.x, v.y + q.y, v.z + q.z, v.w + q.w);
    }
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (n + e < N) s.out[n + e] = vv[e];
  }
  cluster.sync();
}

// The grid of one launch: (tiles along x and y, the pieces of K rows of a
// tile's k range), as cuda_lstm.sum_plan reckons it.
__host__ inline dim3 grid_for(int nsum, int npair, int R, int M, int N, bool vec, int* pieces) {
  *pieces = npair * ((R + K - 1) / K);
  if (M == 1) return dim3((N + CX * (vec ? 4 : 1) - 1) / (CX * (vec ? 4 : 1)), nsum, 1);
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM * nsum, 1);
}

// The launches weight_sums made, one counter a launch shape: sums a launch
// (1 .. MAX_SUMS) by pairs (1, 2) by kernel (weight_sum_kernel, then
// col_sum_kernel for M = 1).  Static: each library that includes this
// header counts its own launches.
constexpr int SHAPES = 2 * 2 * MAX_SUMS;
static std::atomic<long long> launches[SHAPES];

__host__ inline int shape_of(int nsum, int npair, int M) {
  return ((M == 1) * 2 + npair - 1) * MAX_SUMS + nsum - 1;
}

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch the batch's sums on `stream`: npair pairs over R rows each, C
// (M, N).  `splits` 0 takes the rule's cluster size (splits_for); 1, 2, 4,
// 8 or 16 forces one.
inline cudaError_t weight_sums(const Batch& batch, int npair, int R, int M, int N,
                               cudaStream_t stream, int splits = 0) {
  if (batch.n < 1 || batch.n > MAX_SUMS || npair < 1 || npair > 2 || R < 0 || M < 1 ||
      N < 1 || splits < 0 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0)
    return cudaErrorInvalidValue;
  bool vec = N % 4 == 0 && (M == 1 || M % 4 == 0);
  for (int i = 0; i < batch.n; ++i) {
    const Sum& s = batch.s[i];
    if (s.out == nullptr || s.b[0] == nullptr || (npair == 2 && s.b[1] == nullptr) ||
        s.shift < 0)
      return cudaErrorInvalidValue;
    for (int p = 0; p < npair; ++p)
      vec = vec && aligned16(s.b[p]) && (M == 1 || (aligned16(s.a[p]) && aligned16(s.head[p])));
    vec = vec && aligned16(s.out);
  }
  int dev = 0, sms = 0, pieces = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  dim3 grid = grid_for(batch.n, npair, R, M, N, vec, &pieces);
  const int s = splits > 0 ? splits : splits_for(static_cast<int>(grid.x * grid.y), pieces, sms);
  grid.z = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = s;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const void* kern;
  if (M == 1) {
    cfg.blockDim = dim3(CS_THREADS, 1, 1);
    kern = vec ? reinterpret_cast<const void*>(col_sum_kernel<4>)
               : reinterpret_cast<const void*>(col_sum_kernel<1>);
  } else {
    cfg.blockDim = dim3(THREADS, 1, 1);
    kern = vec ? reinterpret_cast<const void*>(weight_sum_kernel<4>)
               : reinterpret_cast<const void*>(weight_sum_kernel<1>);
  }
  if (s > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (M == 1)
    e = vec ? cudaLaunchKernelEx(&cfg, col_sum_kernel<4>, batch, npair, R, N)
            : cudaLaunchKernelEx(&cfg, col_sum_kernel<1>, batch, npair, R, N);
  else
    e = vec ? cudaLaunchKernelEx(&cfg, weight_sum_kernel<4>, batch, npair, R, M, N)
            : cudaLaunchKernelEx(&cfg, weight_sum_kernel<1>, batch, npair, R, M, N);
  if (e == cudaSuccess) launches[shape_of(batch.n, npair, M)].fetch_add(1, std::memory_order_relaxed);
  return e;
}

// One sum of one or two pairs: the batch of one.
inline Sum sum_of(float* out, int shift, const float* a0, const float* b0,
                  const float* head0 = nullptr, const float* a1 = nullptr,
                  const float* b1 = nullptr, const float* head1 = nullptr) {
  Sum s;
  s.a[0] = a0, s.a[1] = a1;
  s.b[0] = b0, s.b[1] = b1;
  s.head[0] = head0, s.head[1] = head1;
  s.out = out;
  s.shift = shift;
  return s;
}

}  // namespace ws
}  // namespace hfrep

// This library's weight-sum launches by shape (ws::shape_of's order) into
// out[0 .. SHAPES); with `reset` nonzero each counter is set to zero as it
// is read.  Returns SHAPES.
extern "C" int hfrep_weight_sum_launches(long long* out, int reset) {
  for (int i = 0; i < hfrep::ws::SHAPES; ++i)
    out[i] = reset ? hfrep::ws::launches[i].exchange(0) : hfrep::ws::launches[i].load();
  return hfrep::ws::SHAPES;
}
