// Exact-reverse recovery term of the B + M (v1) formulation for Hopper
// (sm_90a), forward and backward.  Per branch n:
//
//   S_n[b, m] = sum of slot_val[s, k] over the rev-ELL cells (s, k) of row b
//               (slots row_ptr[b] .. row_ptr[b + 1]) with
//               c_indices[slot_col[s, k], n] = m
//   a         = al[n, b] + arcb[n, m],  att = exp(a >= 0 ? a : 0.2 a)
//   G         = <xb[n, b, :], gbar[n, m, :]>                    (Dg wide)
//   info[n]   = sum over (b, m) of relu(S_n[b, m]) * att * G
//
// and its VJP for a per-branch cotangent g[n], with Satt = relu(S) * att and
// d_a = Satt * (a >= 0 ? 1 : 0.2) * G:
//
//   d_xb[n, b, :] = g[n] * sum over m of Satt * gbar[n, m, :]
//   d_al[n, b]    = g[n] * sum over m of d_a
//   d_arcb[n, m]  = g[n] * sum over b of d_a
//
// The relu applies to the per-(row, codeword) sum, not per cell: cells of
// opposite sign that meet in one codeword cancel before the clamp (the v1
// mapper's coalesce + keep-positive, vq_gnn_v1/utils/dataloader.py:153-180).
//
// Two folds of S, as the TPU kernel's VQ_GNN_REV_FOLD modes
// (vq_gnn_tpu/ops/pallas_rev.py:194-270):
// - f32 (x2, highest; fold_bf16 = 0): the cells' values summed in f32;
// - bf16 (fast; fold_bf16 = 1): each value rounded to bf16, a codeword's
//   cells of one K-cell slot summed in k order with a bf16 rounding after
//   every add, and those slot parts widened and summed in f32.  Both the
//   forward and the backward form S so (the backward recomputes it).
//
// Replaces the TPU kernels vq_gnn_tpu/ops/pallas_rev.py:_fwd_kernel and
// _bwd_kernel (rev_recovery_info).  The TPU kernels build dense [rows, M]
// codeword histograms with one-hot selects and fold them with MXU matmuls;
// here no dense grid exists: a batch row has a handful of cells per branch.
//
// What bounds it on the H100: latency, far below the byte bound (the
// rev-ELL arrays, xb, al, arcb and gbar read once, the outputs written
// once) and any arithmetic limit (a few flops per cell and branch).  Each
// row is a chain of dependent loads: offsets -> cells -> codewords -> the
// (gbar, arcb) table rows.  The design walks that chain once per row, not
// once per (row, branch), and keeps enough warps resident to overlap it:
// - short rows (the rows of at most long_rows[0] slots, which the caller
//   keeps to at most 32 cells), one warp a row, the branches across the lanes (groups of 32 for
//   nb > 32).  The lanes load the row's cells together and list the live
//   ones in shared memory; each lane reads its branch's codewords of them (a
//   cell's c_indices row is one 64-byte line for the warp) and merges its
//   equal codewords in cell order, O(cells^2) compares on a median of 6
//   cells, in shared memory so that registers stay few;
// - long rows (listed by the host, rows of more slots; ~320 a batch, a
//   fifth of the cells) take one warp per (row, branch), the lanes over the
//   cells: equal codewords are summed into a per-warp [M] shared histogram
//   (found with __match_any_sync, summed by the lowest lane in lane order,
//   chunks in order), then each distinct codeword is visited once and its
//   entry reset to 0, so a later repeat adds nothing and the histogram is
//   clean again.  Their blocks come first in the grid, so they start first;
// - gbar and arcb are packed per call into one table row of 8 (or 16)
//   floats per (branch, codeword): a group's gather is one 32-byte sector;
// - the forward writes each (row, branch) share of info, summed per branch
//   in a fixed order by two small kernels; the backward writes d_xb and d_al
//   directly and each group's d_a into a [nb, cells] buffer at the group's
//   first live cell (0 at the other cells, its codeword beside it; a short
//   row writes them through a shared tile, a branch's cells contiguous).  A
//   codeword pass folds the buffer into per-chunk [M] partials (cells in
//   order within each warp, warps in order within a block) and a last
//   kernel adds the chunks in order and scales by g[n].  No float atomics:
//   the same bits on every run;
// - the entry points own every size: vq_rev_scratch_bytes gives the scratch
//   a call needs (the table, row shares, buffer and partials in one block),
//   and each entry point checks the block it is given against it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps a block of the row pass: small blocks, so that a block's slow row
// does not hold the resources of many finished ones
constexpr int kRowWarps = 2;
constexpr int kWarps = 8;   // warps a block of the other kernels (at most)
constexpr int kSmemBytes = 227 * 1024;  // dynamic shared memory a block may take (sm_90)
constexpr int kChunkCells = 8192;  // cells a codeword-pass block folds, at least
constexpr int kMaxChunks = 64;     // cap on the codeword pass's [chunks, nb, M] partials
constexpr int kTile = 33;   // row stride of a short row's [32 cells][32 lanes] tiles
constexpr int kPrefetch = 4;  // 32-cell tiles the codeword pass loads ahead
constexpr int kSumRows = 128;  // rows a block of the forward's first sum takes
// a short-row warp's shared memory: the codeword tile, the live cells'
// values, neighbours and slots, and in the backward the d_a tile
constexpr int short_bytes(bool bwd) {
  return 32 * kTile * 2 + 32 * 8 + 32 + (bwd ? 32 * kTile * 4 : 0);
}

// A codeword-pass warp's shared memory: its [M] histogram and a tile's values.
__host__ __device__ __forceinline__ int codeword_region(int M) {
  return (M + 32) * 4;
}

// x rounded to the nearest bfloat16, ties to even (finite x), kept as f32.
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

struct RevArgs {
  const short* c_indices;  // [n1, nb]
  int64_t n1;
  const int* slot_col;    // [S, K]
  const float* slot_val;  // [S, K]
  int K;
  int fold_bf16;         // 1: the bf16 fold of S (fast), 0: f32
  const int* row_ptr;    // [B_pad + 1] slot offsets
  const int* long_rows;  // [1 + n_long]: the threshold in slots, then the rows
  int n_long;
  const float* xb;   // [nb, B_pad, Dg]
  const float* al;   // [nb, B_pad]
  const float* tab;  // [nb, M, W]: gbar[n, m, :], arcb[n, m], zeros
  int nb;
  int64_t B_pad;
  int M;
  int Dg;
  int warp_bytes;  // shared memory per warp
  const float* g;  // backward: [nb]
  float* rowinfo;  // forward: [B_pad, nb] per-(row, branch) shares of info
  float* d_xb;     // backward: [nb, B_pad, Dg]
  float* d_al;     // backward: [nb, B_pad]
  float* dbuf;     // backward: [nb, cap] d_a at each group's first cell, else 0
  short* cbuf;     // backward: [nb, cap] the cell's codeword
  int64_t cap;     // cells in the slots, S * K
};

__device__ __forceinline__ int code_of(const RevArgs& p, int64_t col, int n) {
  col = col < 0 ? 0 : (col >= p.n1 ? p.n1 - 1 : col);
  const int m = (int)__ldg(p.c_indices + col * p.nb + n);
  return m < 0 ? 0 : (m >= p.M ? p.M - 1 : m);
}

// xb[n, b, :] into xr (zeros past Dg); returns al[n, b].
template <int W>
__device__ __forceinline__ float load_row(const RevArgs& p, int n, int64_t b, float* xr) {
  const float* x = p.xb + ((int64_t)n * p.B_pad + b) * p.Dg;
#pragma unroll
  for (int d = 0; d < W; ++d) xr[d] = d < p.Dg ? __ldg(x + d) : 0.f;
  return __ldg(p.al + (int64_t)n * p.B_pad + b);
}

// The table row of (n, m): one or two 32-byte sectors.
template <int W>
__device__ __forceinline__ void load_tab(const RevArgs& p, int n, int m, float* t) {
  const float4* r = reinterpret_cast<const float4*>(p.tab + ((int64_t)n * p.M + m) * W);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = __ldg(r + q);
    t[4 * q] = v.x;
    t[4 * q + 1] = v.y;
    t[4 * q + 2] = v.z;
    t[4 * q + 3] = v.w;
  }
}

// One (row, codeword) group with merged value s > 0 and table row t: the
// forward adds its term to acc; the backward adds to dx and dal and
// returns d_a.
template <bool BWD, int W>
__device__ __forceinline__ float group_term(const RevArgs& p, const float* t, float s,
                                            float al_b, const float* xr, float& acc, float* dx,
                                            float& dal) {
  float arc = 0.f, G = 0.f;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    if (d < p.Dg) G += xr[d] * t[d];
    if (d == p.Dg) arc = t[d];
  }
  const float a = al_b + arc;
  const float att = expf(a >= 0.f ? a : 0.2f * a);
  const float satt = s * att;
  if constexpr (BWD) {
#pragma unroll
    for (int d = 0; d < W; ++d)
      if (d < p.Dg) dx[d] += satt * t[d];
    const float da = satt * (a >= 0.f ? 1.f : 0.2f) * G;
    dal += da;
    return da;
  } else {
    acc += satt * G;
    return 0.f;
  }
}

// The row's outputs for branch n.
template <bool BWD, int W>
__device__ __forceinline__ void store_row(const RevArgs& p, int n, int64_t b, float acc,
                                          const float* dx, float dal) {
  if constexpr (BWD) {
    const float gn = __ldg(p.g + n);
    float* o = p.d_xb + ((int64_t)n * p.B_pad + b) * p.Dg;
#pragma unroll
    for (int d = 0; d < W; ++d)
      if (d < p.Dg) o[d] = gn * dx[d];
    p.d_al[(int64_t)n * p.B_pad + b] = gn * dal;
  } else {
    p.rowinfo[b * p.nb + n] = acc;
  }
}

// A row of at most 32 cells: one warp, branch n0 + lane in each lane.
template <bool BWD, int W>
__device__ void short_row(const RevArgs& p, int64_t b, int s0, int L, int lane,
                          unsigned char* sm) {
  short* tc = reinterpret_cast<short*>(sm);                    // [32][kTile] codewords
  float* tv = reinterpret_cast<float*>(sm + 32 * kTile * 2);  // [32] live values
  int* tcol = reinterpret_cast<int*>(tv + 32);                 // [32] their neighbours
  unsigned char* tk = reinterpret_cast<unsigned char*>(tcol + 32);  // [32] their slots
  float* ts = reinterpret_cast<float*>(tk + 32);               // backward: [32][kTile] d_a
  const int64_t c0 = (int64_t)s0 * p.K;
  float v = 0.f;
  int col = 0;
  if (lane < L) {
    v = __ldg(p.slot_val + c0 + lane);
    col = __ldg(p.slot_col + c0 + lane);
  }
  const unsigned live = __ballot_sync(kFull, v != 0.f);
  const int nl = __popc(live);
  const int rk = __popc(live & ((1u << lane) - 1u));  // this lane's cell among the live ones
  if (v != 0.f) {
    tv[rk] = p.fold_bf16 ? round_bf16(v) : v;
    tcol[rk] = col;
    tk[rk] = (unsigned char)(lane / p.K);
  }
  __syncwarp();
  for (int n0 = 0; n0 < p.nb; n0 += 32) {
    const int n = n0 + lane;
    if (n < p.nb) {
#pragma unroll 8
      for (int j = 0; j < nl; ++j) tc[j * kTile + lane] = (short)code_of(p, tcol[j], n);
      float xr[W];
      const float al_b = load_row<W>(p, n, b, xr);
      float acc = 0.f, dal = 0.f;
      float dx[BWD ? W : 1];
#pragma unroll
      for (int d = 0; d < (BWD ? W : 1); ++d) dx[d] = 0.f;
      // in cell order: a group's sum at its first live cell, its term if > 0
      for (int i = 0; i < nl; ++i) {
        const int m = tc[i * kTile + lane];
        bool first = true;
#pragma unroll 4
        for (int j = 0; j < i; ++j) first &= tc[j * kTile + lane] != m;
        float da = 0.f;
        if (first) {
          float s = tv[i];
          if (p.fold_bf16) {  // bf16 sums within a slot, f32 across slots
            float part = s;
            int slot = tk[i];
            s = 0.f;
            for (int j = i + 1; j < nl; ++j) {
              if (tc[j * kTile + lane] != m) continue;
              if (tk[j] != slot) {
                s += part;
                part = 0.f;
                slot = tk[j];
              }
              part = round_bf16(part + tv[j]);
            }
            s += part;
          } else {
#pragma unroll 4
            for (int j = i + 1; j < nl; ++j) s += tc[j * kTile + lane] == m ? tv[j] : 0.f;
          }
          if (s > 0.f) {
            float t[W];
            load_tab<W>(p, n, m, t);
            da = group_term<BWD, W>(p, t, s, al_b, xr, acc, dx, dal);
          }
        }
        if constexpr (BWD) ts[i * kTile + lane] = da;
      }
      store_row<BWD, W>(p, n, b, acc, dx, dal);
    }
    if constexpr (BWD) {
      // d_a and codewords, transposed: lane k writes cell k of each branch
      __syncwarp();
      const int nn = p.nb - n0 < 32 ? p.nb - n0 : 32;
      if (lane < L) {
        const bool lv = (live >> lane) & 1u;
        for (int q = 0; q < nn; ++q) {
          const int64_t o = (int64_t)(n0 + q) * p.cap + c0 + lane;
          p.dbuf[o] = lv ? ts[rk * kTile + q] : 0.f;
          p.cbuf[o] = lv ? tc[rk * kTile + q] : (short)0;
        }
      }
    }
    __syncwarp();
  }
}

// One lane's cell j of a long row for branch n: its value (0: none) and
// codeword.
__device__ __forceinline__ float long_cell(const RevArgs& p, int64_t c0, int L, int j, int n,
                                           int& m) {
  const float v = j < L ? __ldg(p.slot_val + c0 + j) : 0.f;
  m = v != 0.f ? code_of(p, __ldg(p.slot_col + c0 + j), n) : 0;
  return v;
}

// Equal codewords of one 32-cell chunk summed into h (lane order).  Under
// the bf16 fold the values are rounded to bf16 and each slot's part (lanes
// lane / K alike; a chunk starts on a slot edge, as K divides 32) is summed
// in bf16, the parts in f32.
__device__ __forceinline__ void merge_chunk(const RevArgs& p, float v, int m, int lane,
                                            float* h, float* tv) {
  const bool on = v != 0.f;
  const unsigned grp = __match_any_sync(kFull, on ? m : -1 - lane);
  tv[lane] = p.fold_bf16 ? round_bf16(v) : v;
  __syncwarp();
  if (on && (__ffs(grp) - 1) == lane) {
    float s = 0.f;
    if (p.fold_bf16) {
      float part = 0.f;
      int slot = lane / p.K;
      for (unsigned r = grp; r != 0u; r &= r - 1u) {
        const int q = __ffs(r) - 1;
        if (q / p.K != slot) {
          s += part;
          part = 0.f;
          slot = q / p.K;
        }
        part = round_bf16(part + tv[q]);
      }
      s += part;
    } else {
      for (unsigned r = grp; r != 0u; r &= r - 1u) s += tv[__ffs(r) - 1];
    }
    h[m] += s;
  }
  __syncwarp();
}

// Each distinct codeword of one chunk at its first live cell j: its merged
// sum taken from h (and h reset to 0, so a later repeat adds nothing) and
// its term; the backward writes d_a and the codeword at cell j.
template <bool BWD, int W>
__device__ __forceinline__ void visit_chunk(const RevArgs& p, float v, int m, int j, int n,
                                            int64_t c0, int L, int lane, float* h, float al_b,
                                            const float* xr, float& acc, float* dx,
                                            float& dal) {
  const bool on = v != 0.f;
  const unsigned grp = __match_any_sync(kFull, on ? m : -1 - lane);
  float da = 0.f;
  if (on && (__ffs(grp) - 1) == lane) {
    const float s = h[m];
    h[m] = 0.f;
    if (s > 0.f) {
      float t[W];
      load_tab<W>(p, n, m, t);
      da = group_term<BWD, W>(p, t, s, al_b, xr, acc, dx, dal);
    }
  }
  if constexpr (BWD) {
    if (j < L) {
      p.dbuf[(int64_t)n * p.cap + c0 + j] = da;
      p.cbuf[(int64_t)n * p.cap + c0 + j] = (short)m;
    }
  }
  __syncwarp();
}

// A long row for branch n: one warp, the lanes over the cells, the merge in
// the warp's [M] shared histogram h (all zero on entry and on exit).
template <bool BWD, int W>
__device__ void long_row(const RevArgs& p, int64_t b, int s0, int L, int n, int lane, float* h,
                         float* tv) {
  const int64_t c0 = (int64_t)s0 * p.K;
  float xr[W];
  const float al_b = load_row<W>(p, n, b, xr);
  float acc = 0.f, dal = 0.f;
  float dx[BWD ? W : 1];
#pragma unroll
  for (int d = 0; d < (BWD ? W : 1); ++d) dx[d] = 0.f;
  {
    for (int j0 = 0; j0 < L; j0 += 32) {
      int m;
      const float v = long_cell(p, c0, L, j0 + lane, n, m);
      merge_chunk(p, v, m, lane, h, tv);
    }
    for (int j0 = 0; j0 < L; j0 += 32) {
      int m;
      const float v = long_cell(p, c0, L, j0 + lane, n, m);
      visit_chunk<BWD, W>(p, v, m, j0 + lane, n, c0, L, lane, h, al_b, xr, acc, dx, dal);
    }
  }
  acc = warp_sum(acc);
  if constexpr (BWD) {
#pragma unroll
    for (int d = 0; d < W; ++d)
      if (d < p.Dg) dx[d] = warp_sum(dx[d]);
    dal = warp_sum(dal);
  }
  if (lane == 0) store_row<BWD, W>(p, n, b, acc, dx, dal);
}

// The row pass.  Blocks [0, long_blocks): the long rows' (row, branch) tasks;
// the rest: every other row in index order, a warp each.  The forward fits
// 40 warps an SM; the backward's dx and d_a tile need more registers.
template <bool BWD, int W>
__global__ void __launch_bounds__(kRowWarps * 32, BWD ? 10 : 20)
    rev_rows_kernel(RevArgs p, int long_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* sm = smem + (size_t)w * p.warp_bytes;
  float* h = reinterpret_cast<float*>(sm);  // the long path's histogram, then 32 values
  const int thr = __ldg(p.long_rows);  // a short row: at most thr * K <= 32 cells
  if ((int)blockIdx.x < long_blocks) {
    for (int m = lane; m < p.M; m += 32) h[m] = 0.f;
    __syncwarp();
    const int64_t t = (int64_t)blockIdx.x * kRowWarps + w;
    if (t >= (int64_t)p.n_long * p.nb) return;  // whole warp; no block barrier follows
    const int64_t b = __ldg(p.long_rows + 1 + t / p.nb);
    const int s0 = __ldg(p.row_ptr + b), s1 = __ldg(p.row_ptr + b + 1);
    if (s1 - s0 <= thr) return;  // not long: the short pass takes it
    long_row<BWD, W>(p, b, s0, (s1 - s0) * p.K, (int)(t % p.nb), lane, h, h + p.M);
    return;
  }
  const int64_t b = (int64_t)(blockIdx.x - long_blocks) * kRowWarps + w;
  if (b >= p.B_pad) return;
  const int s0 = __ldg(p.row_ptr + b), s1 = __ldg(p.row_ptr + b + 1);
  if (s1 - s0 > thr) return;  // a long row
  short_row<BWD, W>(p, b, s0, (s1 - s0) * p.K, lane, sm);
}

// tab[n, m, :] = gbar[n, m, :Dg], arcb[n, m], zeros to W.
template <int W>
__global__ void pack_table_kernel(const float* __restrict__ gbar, const float* __restrict__ arcb,
                                  int64_t rows, int Dg, float* __restrict__ tab) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= rows * W) return;
  const int64_t r = i / W;
  const int d = (int)(i % W);
  tab[i] = d < Dg ? gbar[r * Dg + d] : (d == Dg ? arcb[r] : 0.f);
}

// part[blk, n] = sum over the block's kSumRows rows b of rowinfo[b, n]: each
// warp its rows in order, the warps added in order.
__global__ void sum_rows_kernel(const float* __restrict__ rowinfo, int64_t B_pad, int nb,
                                float* __restrict__ part) {
  __shared__ float red[kWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b0 = (int64_t)blockIdx.x * kSumRows;
  const int64_t b1 = b0 + kSumRows < B_pad ? b0 + kSumRows : B_pad;
  for (int n0 = 0; n0 < nb; n0 += 32) {
    const int n = n0 + lane;
    float s = 0.f;
    if (n < nb) {
#pragma unroll 4
      for (int64_t b = b0 + w; b < b1; b += kWarps) s += rowinfo[b * nb + n];
    }
    red[w][lane] = s;
    __syncthreads();
    if (w == 0 && n < nb) {
      float t = 0.f;
      for (int w2 = 0; w2 < kWarps; ++w2) t += red[w2][lane];
      part[(int64_t)blockIdx.x * nb + n] = t;
    }
    __syncthreads();
  }
}

// The codeword pass: block (chunk, n) folds its chunk of the live cell range
// of dbuf[n] into part[chunk, n, :]: each warp its 32-cell tiles in order
// into its own [M] histogram (a tile's equal codewords found with
// __match_any_sync and summed by the lowest lane in lane order), the warps
// added in order.  kW warps a block: as many histograms as fit (Layout).
template <int kW>
__global__ void __launch_bounds__(kW * 32)
    codeword_pass_kernel(const float* __restrict__ dbuf, const short* __restrict__ cbuf,
                         int64_t cap, const int* __restrict__ row_ptr, int64_t B_pad, int K,
                         int M, int nb, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int region = codeword_region(M);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* h = reinterpret_cast<float*>(smem + (size_t)w * region);
  float* sd = h + M;  // [32] a tile's d_a
  for (int m = lane; m < M; m += 32) h[m] = 0.f;
  __syncwarp();
  const int n = blockIdx.y;
  const int64_t chunks = gridDim.x;
  const int64_t used = (int64_t)__ldg(row_ptr + B_pad) * K;
  const int64_t per = ((used + chunks - 1) / chunks + 31) / 32 * 32;
  const int64_t c_beg = blockIdx.x * per;
  const int64_t c_end = c_beg + per < used ? c_beg + per : used;
  const float* dn = dbuf + (int64_t)n * cap;
  const short* cn = cbuf + (int64_t)n * cap;
  constexpr int kStep = kW * 32;
  for (int64_t c = c_beg + w * 32; c < c_end; c += kStep * kPrefetch) {
    float d[kPrefetch];
    int mm[kPrefetch];
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int64_t j = c + q * kStep + lane;
      d[q] = j < c_end ? dn[j] : 0.f;
      mm[q] = j < c_end ? (int)cn[j] : 0;
    }
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const bool on = d[q] != 0.f;
      const unsigned act = __ballot_sync(kFull, on);
      if (act == 0u) continue;
      const int m = mm[q] < 0 ? 0 : (mm[q] >= M ? M - 1 : mm[q]);
      const unsigned grp = __match_any_sync(kFull, on ? m : -1 - lane);
      sd[lane] = d[q];
      __syncwarp();
      if (on && (__ffs(grp) - 1) == lane) {
        float s = 0.f;
        for (unsigned r = grp; r != 0u; r &= r - 1u) s += sd[__ffs(r) - 1];
        h[m] += s;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* o = part + ((int64_t)blockIdx.x * nb + n) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float s = 0.f;
    for (int w2 = 0; w2 < kW; ++w2)
      s += reinterpret_cast<const float*>(smem + (size_t)w2 * region)[m];
    o[m] = s;
  }
}

// out[i] = scale[i / per] * sum over chunks of part[chunk * total + i], in
// chunk order (scale null: 1).
__global__ void reduce_chunks_kernel(const float* __restrict__ part, int64_t chunks,
                                     int64_t total, int64_t per,
                                     const float* __restrict__ scale, float* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int64_t c = 0; c < chunks; ++c) acc += part[c * total + i];
  out[i] = scale != nullptr ? __ldg(scale + i / per) * acc : acc;
}

// A call's launch sizes and scratch: the packed table, then the forward's
// row shares and their block sums, or the backward's d_a buffer, its
// codewords and the codeword pass's chunk partials, each region 256-byte
// aligned.
struct Layout {
  int W;          // floats a table row: gbar[n, m, :Dg], arcb[n, m], zeros
  int row_bytes;  // shared memory a row-pass warp
  int cw_warps;   // warps a codeword-pass block: 8, 4, 2 or 1, as many [M] histograms as fit
  int chunks;     // codeword-pass blocks a branch
  size_t tab, rowinfo, dbuf, cbuf, part, bytes;  // byte offsets; the total
};

size_t aligned(size_t x) { return (x + 255) / 256 * 256; }

// False for shapes the kernels do not take: Dg + 1 above a 16-float table
// row, K above a warp (or, under the bf16 fold, not dividing 32: a long
// row's 32-cell chunks must start on slot edges), or M whose [M]
// histograms do not fit a block.
bool make_layout(bool bwd, int nb, int64_t B_pad, int M, int Dg, int64_t S, int K,
                 int fold_bf16, Layout& z) {
  if (nb < 1 || B_pad < 1 || M < 1 || Dg < 1 || Dg + 1 > 16 || S < 1 || K < 1 || K > 32 ||
      (fold_bf16 && 32 % K != 0))
    return false;
  z = {};
  z.W = Dg + 1 <= 8 ? 8 : 16;
  const int long_b = codeword_region(M);  // the long path's histogram and values
  const int short_b = short_bytes(bwd);
  z.row_bytes = ((long_b > short_b ? long_b : short_b) + 15) / 16 * 16;
  if ((int64_t)kRowWarps * z.row_bytes > kSmemBytes) return false;
  z.cw_warps = kWarps;
  while (z.cw_warps > 1 && z.cw_warps * codeword_region(M) > kSmemBytes) z.cw_warps /= 2;
  const int64_t cells = S * K;
  const int64_t chunks = (cells + kChunkCells - 1) / kChunkCells;
  z.chunks = (int)(chunks < 1 ? 1 : (chunks > kMaxChunks ? kMaxChunks : chunks));
  size_t o = aligned((size_t)nb * M * z.W * 4);  // tab at 0
  if (bwd) {
    z.dbuf = o;
    o += aligned((size_t)nb * cells * 4);
    z.cbuf = o;
    o += aligned((size_t)nb * cells * 2);
    z.part = o;
    o += aligned((size_t)z.chunks * nb * M * 4);
  } else {
    z.rowinfo = o;
    o += aligned((size_t)(B_pad + (B_pad + kSumRows - 1) / kSumRows) * nb * 4);
  }
  z.bytes = o;
  return true;
}

// The codeword pass with kW warps a block, then the chunk sums into d_arcb.
template <int kW>
cudaError_t launch_codewords(const RevArgs& p, int chunks, const int* row_ptr, float* part,
                             const float* g, float* d_arcb, cudaStream_t st) {
  const size_t smem = (size_t)kW * codeword_region(p.M);
  auto kern = codeword_pass_kernel<kW>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)chunks, (unsigned)p.nb), kW * 32, smem, st>>>(
      p.dbuf, p.cbuf, p.cap, row_ptr, p.B_pad, p.K, p.M, p.nb, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t total = (int64_t)p.nb * p.M;
  reduce_chunks_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, chunks, total,
                                                                        p.M, g, d_arcb);
  return cudaGetLastError();
}

template <bool BWD, int W>
cudaError_t launch_rows(RevArgs p, const Layout& z, const float* gbar, const float* arcb,
                        float* tab, cudaStream_t st) {
  const int64_t rows = (int64_t)p.nb * p.M;
  pack_table_kernel<W><<<(unsigned)((rows * W + 255) / 256), 256, 0, st>>>(gbar, arcb, rows,
                                                                             p.Dg, tab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  p.tab = tab;
  p.warp_bytes = z.row_bytes;
  const size_t smem = (size_t)kRowWarps * p.warp_bytes;
  auto kern = rev_rows_kernel<BWD, W>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t long_blocks = ((int64_t)p.n_long * p.nb + kRowWarps - 1) / kRowWarps;
  const int64_t short_blocks = (p.B_pad + kRowWarps - 1) / kRowWarps;
  kern<<<(unsigned)(long_blocks + short_blocks), kRowWarps * 32, smem, st>>>(
      p, (int)long_blocks);
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t launch_rows(const RevArgs& p, const Layout& z, const float* gbar, const float* arcb,
                        float* tab, cudaStream_t st) {
  return z.W == 8 ? launch_rows<BWD, 8>(p, z, gbar, arcb, tab, st)
                  : launch_rows<BWD, 16>(p, z, gbar, arcb, tab, st);
}

RevArgs make_args(const short* c_indices, int64_t n1, const int* slot_col,
                  const float* slot_val, int64_t S, int K, int fold_bf16, const int* row_ptr,
                  const int* long_rows, int n_long, const float* xb, const float* al, int nb,
                  int64_t B_pad, int M, int Dg) {
  RevArgs p = {};
  p.c_indices = c_indices;
  p.n1 = n1;
  p.slot_col = slot_col;
  p.slot_val = slot_val;
  p.K = K;
  p.fold_bf16 = fold_bf16;
  p.row_ptr = row_ptr;
  p.long_rows = long_rows;
  p.n_long = n_long;
  p.xb = xb;
  p.al = al;
  p.nb = nb;
  p.B_pad = B_pad;
  p.M = M;
  p.Dg = Dg;
  p.cap = S * K;
  return p;
}

}  // namespace

// The bytes of scratch the forward (bwd = 0) or the backward (bwd = 1) needs
// for these shapes and fold, into *bytes; cudaErrorInvalidValue for shapes
// the kernels do not take.
extern "C" int vq_rev_scratch_bytes(int bwd, int nb, int64_t B_pad, int M, int Dg, int64_t S,
                                    int K, int fold_bf16, int64_t* bytes) {
  Layout z;
  if (!make_layout(bwd != 0, nb, B_pad, M, Dg, S, K, fold_bf16, z))
    return (int)cudaErrorInvalidValue;
  *bytes = (int64_t)z.bytes;
  return 0;
}

// Forward.  scratch: scratch_bytes of device memory, at least what
// vq_rev_scratch_bytes(0, ...) gives, 256-byte aligned.
extern "C" int vq_rev_forward(const short* c_indices, int64_t n1, const int* slot_col,
                              const float* slot_val, int64_t S, int K, int fold_bf16,
                              const int* row_ptr,
                              const int* long_rows, int n_long, const float* xb, const float* al,
                              const float* arcb, const float* gbar, int nb, int64_t B_pad, int M,
                              int Dg, void* scratch, int64_t scratch_bytes, float* info,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Layout z;
  if (!make_layout(false, nb, B_pad, M, Dg, S, K, fold_bf16, z) || n_long < 0 ||
      scratch_bytes < (int64_t)z.bytes)
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  RevArgs p = make_args(c_indices, n1, slot_col, slot_val, S, K, fold_bf16, row_ptr, long_rows,
                        n_long, xb, al, nb, B_pad, M, Dg);
  float* rowinfo = reinterpret_cast<float*>(sc + z.rowinfo);
  p.rowinfo = rowinfo;
  cudaError_t e = launch_rows<false>(p, z, gbar, arcb, reinterpret_cast<float*>(sc + z.tab), st);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (B_pad + kSumRows - 1) / kSumRows;
  float* part = rowinfo + B_pad * nb;
  sum_rows_kernel<<<(unsigned)blocks, kWarps * 32, 0, st>>>(rowinfo, B_pad, nb, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_chunks_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(part, blocks, nb, 1,
                                                                     nullptr, info);
  return (int)cudaGetLastError();
}

// Backward.  scratch as for the forward, from vq_rev_scratch_bytes(1, ...).
extern "C" int vq_rev_backward(const short* c_indices, int64_t n1, const int* slot_col,
                               const float* slot_val, int64_t S, int K, int fold_bf16,
                               const int* row_ptr,
                               const int* long_rows, int n_long, const float* xb,
                               const float* al, const float* arcb, const float* gbar, int nb,
                               int64_t B_pad, int M, int Dg, void* scratch,
                               int64_t scratch_bytes, const float* g, float* d_xb, float* d_al,
                               float* d_arcb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Layout z;
  if (!make_layout(true, nb, B_pad, M, Dg, S, K, fold_bf16, z) || n_long < 0 ||
      scratch_bytes < (int64_t)z.bytes)
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  RevArgs p = make_args(c_indices, n1, slot_col, slot_val, S, K, fold_bf16, row_ptr, long_rows,
                        n_long, xb, al, nb, B_pad, M, Dg);
  p.g = g;
  p.d_xb = d_xb;
  p.d_al = d_al;
  p.dbuf = reinterpret_cast<float*>(sc + z.dbuf);
  p.cbuf = reinterpret_cast<short*>(sc + z.cbuf);
  float* part = reinterpret_cast<float*>(sc + z.part);
  const cudaError_t e =
      launch_rows<true>(p, z, gbar, arcb, reinterpret_cast<float*>(sc + z.tab), st);
  if (e != cudaSuccess) return (int)e;
  switch (z.cw_warps) {
    case 8: return (int)launch_codewords<8>(p, z.chunks, row_ptr, part, g, d_arcb, st);
    case 4: return (int)launch_codewords<4>(p, z.chunks, row_ptr, part, g, d_arcb, st);
    case 2: return (int)launch_codewords<2>(p, z.chunks, row_ptr, part, g, d_arcb, st);
    default: return (int)launch_codewords<1>(p, z.chunks, row_ptr, part, g, d_arcb, st);
  }
}
