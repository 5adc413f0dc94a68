// GAT attention aggregate, backward, over the transposed slot-ELL, for
// Hopper (sm_90a).  In the transposed layout a slot's row is the source node
// s of its edges and its columns are their destinations d:
//
//   a      = al[s] + ar[clip(d)]
//   ev     = exp(leaky_relu(a, 0.2)) * val
//   g_ev   = <g_agg[d, :], x[s, :]> + g_rowsum[d]
//   dx_agg[s, :] = sum over the cells of row s of ev * g_agg[d, :]
//   d_al[s]      = sum over the cells of row s of g_ev * ev * (a > 0 ? 1 : 0.2)
//
// x, g_agg, g_rowsum and ar are f32, or all four bf16 or all four f16 under
// compute_dtype='bfloat16' or 'float16' (the TPU kernels' 16-bit gathered
// block of g_agg, g_rowsum and ar, and 16-bit x): their values are widened
// to f32 in registers; al, the sums, dx_agg and d_al are f32 in every mode.
//
// d_al for every row s < num_rows (the B' rows carry logits too); dx_agg
// only for the rows s < dx_rows, the rows whose cotangent has a consumer:
// the rows above get zeros, and with dx_rows = 0 there is no dx_agg at all.
//
// Replaces both TPU backward kernels: vq_gnn_tpu/ops/pallas_ell.py:
// _make_bwd_kernel_merged (C = 128, via gat_bwd_fused_merged) and
// _make_bwd_kernel (C = 256, 384, ..., via gat_bwd_fused), together with the
// cotangent gathers XLA ran in front of them (ops/gat.py:516-545).  Their
// merged or split gathers, one-hot x windows and lane-0 basis dots were
// workarounds for Mosaic; here one kernel reads the cotangent rows itself, at
// any C.  al and ar are per node, precomputed by the caller (gat_aggregate.cu
// says how).
//
// What bounds it on the H100: the latency of its dependent loads, as kernel 1
// (ell_aggregate.cu, whose measurements PERF.md §6 keeps).  A live cell costs
// an exp, a dot over C and one multiply-add per channel, far below the
// 67 TFLOP/s f32 rate; its bytes are a 4*C-byte row of g_agg, which L2 holds
// in part, and each row reads x[s] and writes dx_agg[s] once (3 x 4*C bytes
// a row in all, twice what kernel 1 moves).  What costs is each row's chain
// (offsets, then cells, then the gathers and ar[d]) and how many rows are in
// flight: the times move with the warps an SM holds, not with the gathers a
// warp keeps in flight (PERF.md §6).
//
// Design:
// - a group of G lanes per row, rows in index order (a warp per row at
//   C = 128 and 256; 8 or 16 lanes for a narrower x), one float4 of x[s] and
//   of the dx_agg accumulator per lane per 128 channels, held in registers
//   for the whole row (two of each at C = 256): no shared memory.  Wider
//   rows are walked in chunks of 128 channels with each cell's partial dot
//   carried across the chunks in a register, and the accumulator kept in
//   the row's own dx_agg output (one lane per address, so no barrier);
// - each group loads a window of G cells, takes the live ones (val != 0)
//   from a ballot and gathers their g_agg rows in batches, kLoads cells a
//   batch (one at C = 256, where a lane gathers two vectors a cell), with
//   the predicated loads of ell_common.cuh.  Batches of 8 were slower at
//   both widths: they cost registers, and so warps, and gain no bandwidth.
//   Slot padding and zero cells cost no load, no shuffle and no arithmetic.
//   Each lane loads ar[d] and g_rowsum[d] of its own cell of the window
//   beside the first gathers, and forms ev and the d_al coefficient
//   ev * slope'(a) while they are in flight; the next window's cells load
//   meanwhile.  x is read once, with a load that L2 evicts first;
// - the dots are reduced all at once: d_al is linear in them, so each lane
//   adds its partial dot of each cell times that cell's coefficient
//   (broadcast from the cell's lane, one shuffle a cell), and one group sum
//   at the end of the row reduces every dot of the row.  A cell costs two
//   or three shuffles (column, coefficient, and ev where dx_agg is wanted),
//   against five for a reduction of its own;
// - one warp a block: a block's slot on the SM frees as soon as its row is
//   done, not when the slowest of several rows is, and the register budget
//   (72 registers at C <= 128, 64 at C = 256) lets an SM hold 24 to 32;
// - the rows of more than t slots (a list built on the host with the batch,
//   longest first, that carries its threshold t) take a warp each in the
//   first blocks, so the longest chains start first instead of finishing
//   last; the groups in index order skip them by the same t;
// - rows >= dx_rows do none of dx_agg's shuffles or multiply-adds;
// - each output row is written once, by one group, summing its live cells in
//   slot order: no atomics, the same bits in every run and at every dx_rows
//   (and, where a row takes a warp anyway, with or without the long-row
//   list; a narrow row's d_al sums its lanes in another order in a warp);
// - row offsets (ptr[r] = first slot of row r, over every row) come with the
//   batch; a caller without them gets them from row_offsets_kernel first.
//   They are clamped to [0, St].  Rows >= num_rows (padding) are dropped;
//   rows without a slot give d_al = 0 and dx_agg = 0; padding columns clamp
//   to the last row of g_agg.  float4 lanes need C % 4 == 0 and 16-byte
//   aligned x, g_agg and dx_agg (16-bit lanes of 8 channels, 16 bytes, C % 8
//   == 0: 16 lanes a row at C = 128, a warp at 256); otherwise a lane covers
//   one channel.

#include "ell_common.cuh"

namespace {

constexpr float kNegSlope = 0.2f;  // PyG GATConv default
constexpr int kThreads = 32;  // one warp a block
constexpr int kLoads = 4;  // cells a batch with one vector a lane

struct Args {
  const void* x;  // x, g, g_rs, ar: float, or all bf16_t, or all f16_t
  int C;
  const int *ptr, *col;
  const float* val;
  int64_t St;
  int K;
  const void *g, *g_rs, *ar;
  int64_t g_rows;
  const float* al;
  int64_t num_rows, dx_rows;
  // [1 + n_long]: a threshold, then the rows of more than that many slots,
  // longest first; null for none
  const int* long_rows;
  int64_t n_long;
  float* dx;  // null when dx_rows == 0
  float* dal;
};

// A live cell's weight ev = exp(leaky_relu(a)) * val and its d_al
// coefficient ev * slope'(a); both 0 for a dead cell.
struct Cell {
  float ev, coef;
};
__device__ __forceinline__ Cell cell_weights(float a, float val, bool live) {
  const float ev = live ? expf(a >= 0.f ? a : kNegSlope * a) * val : 0.f;
  return {ev, a > 0.f ? ev : kNegSlope * ev};
}

// Row r by a group of G lanes (the group's first lane is gbase in the warp).
// NV: the vectors of VEC channels a lane holds, every G * VEC channels;
// WIDE: C is wider than that, walked in chunks; x, g, g_rs and ar hold E.
template <typename E, int VEC, int G, int NV, bool WIDE>
__device__ __forceinline__ void row_backward(const Args& a, int64_t r, int gl, int gbase) {
  using V = Row<E, VEC>;
  using T = typename V::T;
  using R = typename V::R;
  const E* g = static_cast<const E*>(a.g);
  constexpr int L = NV == 1 ? kLoads : 1;  // cells a batch
  constexpr unsigned gbits = 0xffffffffu >> (32 - G);
  constexpr int kStride = G * VEC;  // channels from one of a lane's vectors to the next
  const unsigned gmask = gbits << gbase;
  const int C = a.C;
  const int64_t c0 = slot_at(a.ptr, r, a.St) * a.K;  // cell range of this row
  const int64_t c1 = slot_at(a.ptr, r + 1, a.St) * a.K;
  const int last = (int)(a.g_rows - 1);
  const bool want_dx = r < a.dx_rows;  // the same in every lane of the group
  const float al_r = __ldg(a.al + r);
  const E* xr = static_cast<const E*>(a.x) + r * (int64_t)C;
  float* dxr = a.dx ? a.dx + r * (int64_t)C : nullptr;

  T xv[NV], acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    acc[v] = V::zero();
    const int c = v * kStride + gl * VEC;
    xv[v] = !WIDE && c < C ? V::load_once(xr + c) : V::zero();
  }
  if (WIDE && dxr) {  // the accumulator lives in the output row
    for (int c = gl * VEC; c < C; c += kStride) V::store(dxr + c, V::zero());
  }

  float dal = 0.f;  // this lane's share of d_al[r]
  int nxt_col = 0;
  float nxt_val = 0.f;
  if (c0 + gl < c1) {
    nxt_col = __ldcs(a.col + c0 + gl);
    nxt_val = __ldcs(a.val + c0 + gl);
  }
  for (int64_t base = c0; base < c1; base += G) {
    const int my_col = nxt_col;
    const float my_val = nxt_val;
    const int64_t nxt = base + G + gl;  // the next window, in flight meanwhile
    nxt_col = 0;
    nxt_val = 0.f;
    if (nxt < c1) {
      nxt_col = __ldcs(a.col + nxt);
      nxt_val = __ldcs(a.val + nxt);
    }
    // this lane's cell: its column, and its ar and g_rowsum, loaded beside
    // the first batch's gathers (not before them) and used after them
    const bool mine = my_val != 0.f;
    const int my_d = min(max(my_col, 0), last);
    E ar_e{}, grs_e{};  // zeros, widened where they are used, after the gathers
    gather(ar_e, static_cast<const E*>(a.ar) + my_d, mine);
    gather(grs_e, static_cast<const E*>(a.g_rs) + my_d, mine);
    // bit j: cell base + j is live; the same in every lane of the group
    unsigned live = (__ballot_sync(gmask, mine) >> gbase) & gbits;
    bool first = true;  // the window's first batch
    while (live) {
      const int n = __popc(live);
      int src[L];  // the lanes that own this batch's cells
#pragma unroll
      for (int u = 0; u < L; ++u) {
        src[u] = (__ffs(live) - 1) & (G - 1);
        live &= live - 1;
      }
      if constexpr (!WIDE) {
        R t[L][NV];
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const int d = __shfl_sync(gmask, my_d, src[u], G);
          const E* gd = g + (int64_t)d * C;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * kStride + gl * VEC;
            t[u][v] = V::rzero();
            gather(t[u][v], gd + c, u < n && c < C);
          }
        }
        const Cell my = cell_weights(al_r + widen(ar_e), my_val, mine);
        if (first) dal += widen(grs_e) * my.coef;  // the g_rowsum part of its term
        first = false;
        // past the n live cells t = 0 and the weights are 0
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const float cf = __shfl_sync(gmask, my.coef, src[u], G);
          float p = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v) p += V::dot(t[u][v], xv[v]);
          dal += (u < n ? cf : 0.f) * p;
        }
        if (want_dx) {
#pragma unroll
          for (int u = 0; u < L; ++u) {
            const float e = __shfl_sync(gmask, my.ev, src[u], G);
#pragma unroll
            for (int v = 0; v < NV; ++v) V::fma(acc[v], u < n ? e : 0.f, t[u][v]);
          }
        }
      } else {
        const Cell my = cell_weights(al_r + widen(ar_e), my_val, mine);
        if (first) dal += widen(grs_e) * my.coef;  // the g_rowsum part of its term
        first = false;
        const E* gd[L];
        float e[L], p[L];
#pragma unroll
        for (int u = 0; u < L; ++u) {
          gd[u] = g + (int64_t)__shfl_sync(gmask, my_d, src[u], G) * C;
          const float eu = want_dx ? __shfl_sync(gmask, my.ev, src[u], G) : 0.f;
          e[u] = u < n ? eu : 0.f;
          p[u] = 0.f;
        }
        for (int cb = gl * VEC; cb < C; cb += NV * kStride) {
          R t[L][NV];
          T xc[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = cb + v * kStride;
            xc[v] = c < C ? V::load_once(xr + c) : V::zero();
#pragma unroll
            for (int u = 0; u < L; ++u) {
              t[u][v] = V::rzero();
              gather(t[u][v], gd[u] + c, u < n && c < C);
            }
          }
#pragma unroll
          for (int v = 0; v < NV; ++v) {
#pragma unroll
            for (int u = 0; u < L; ++u) p[u] += V::dot(t[u][v], xc[v]);
            const int c = cb + v * kStride;
            if (want_dx && c < C) {
              T s = V::ld(dxr + c);
#pragma unroll
              for (int u = 0; u < L; ++u) V::fma(s, e[u], t[u][v]);
              V::store(dxr + c, s);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const float cf = __shfl_sync(gmask, my.coef, src[u], G);
          dal += (u < n ? cf : 0.f) * p[u];
        }
      }
    }
  }
  if (!WIDE && dxr) {  // zeros in the rows >= dx_rows
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * kStride + gl * VEC;
      if (c < C) store_streaming(dxr + c, acc[v]);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) dal += __shfl_xor_sync(gmask, dal, off);
  if (gl == 0) a.dal[r] = dal;
}

// Blocks [0, n_long): the long rows, in the list's order.  The rest: a
// group of G lanes per row, in index order, skipping the long rows.  The
// register budget: 24 blocks an SM (72 registers), 32 (64) with two vectors
// a lane, where a batch is one cell.
template <typename E, int VEC, int G, int NV, bool WIDE>
__global__ void __launch_bounds__(kThreads, NV == 1 ? 24 : 32) gat_backward_kernel(const Args a) {
  if (blockIdx.x < a.n_long) {
    const int r = __ldg(a.long_rows + 1 + blockIdx.x);
    if (r >= 0 && r < a.num_rows) row_backward<E, VEC, 32, NV, WIDE>(a, r, threadIdx.x, 0);
    return;
  }
  const int64_t r = ((blockIdx.x - a.n_long) * (int64_t)kThreads + threadIdx.x) / G;
  if (r >= a.num_rows) return;  // the row's whole group leaves together
  // a long row: the list's warp takes it, by the list's own threshold
  if (a.long_rows && __ldg(a.ptr + r + 1) - __ldg(a.ptr + r) > __ldg(a.long_rows)) return;
  row_backward<E, VEC, G, NV, WIDE>(a, r, threadIdx.x & (G - 1), threadIdx.x & 31 & ~(G - 1));
}

template <typename E, int VEC, int G, int NV, bool WIDE>
void launch(const Args& a, cudaStream_t st) {
  const unsigned blocks = (unsigned)(a.n_long + (a.num_rows * G + kThreads - 1) / kThreads);
  gat_backward_kernel<E, VEC, G, NV, WIDE><<<blocks, kThreads, 0, st>>>(a);
}

// G and NV from the vectors of VEC channels a row has: 8 or 16 lanes for a
// narrow x, a warp with one or two vectors a lane up to 64 vectors, and the
// chunked walk of one vector a lane beyond.
template <typename E, int VEC>
void launch_shape(const Args& a, cudaStream_t st) {
  const int vecs = (a.C + VEC - 1) / VEC;
  if (vecs <= 8) {
    launch<E, VEC, 8, 1, false>(a, st);
  } else if (vecs <= 16) {
    launch<E, VEC, 16, 1, false>(a, st);
  } else if (vecs <= 32) {
    launch<E, VEC, 32, 1, false>(a, st);
  } else if (vecs <= 64) {
    launch<E, VEC, 32, 2, false>(a, st);
  } else {
    launch<E, VEC, 32, 1, true>(a, st);
  }
}

// 16-bit rows: 8 values a lane where C and the pointers allow
template <typename E>
void launch16(const Args& a, bool x16, cudaStream_t st) {
  if (a.C % 8 == 0 && x16) {
    launch_shape<E, 8>(a, st);
  } else {
    launch_shape<E, 1>(a, st);
  }
}

}  // namespace

// ptr: [num_rows + 1] row offsets over every row; built here from t_row when
// build_ptr is set, else read as given (clamped to [0, St]).  long_rows:
// [1 + n_long], a threshold t >= 0, then exactly the rows of more than t
// slots, in the order their warps start; null for none.  dx_rows in
// [0, num_rows]: dx_agg for the rows below it and zeros above; with 0, dx
// may be null and nothing is written to it.  x_type: what x, g, g_rs and ar
// hold (RowType: 0 float, 1 bfloat16, 2 float16 values).
extern "C" int vq_gat_backward(const void* x, int x_type, int C, const int* t_row,
                               const int* t_col, const float* t_val, int64_t St, int K,
                               const void* g, const void* g_rs, const void* ar, int64_t g_rows,
                               const float* al, int64_t num_rows, int64_t dx_rows, int* ptr,
                               int build_ptr, const int* long_rows, int64_t n_long, float* dx,
                               float* dal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  if (K <= 0 || g_rows <= 0 || n_long < 0 || dx_rows < 0 || dx_rows > num_rows ||
      x_type < kRowF32 || x_type > kRowF16)
    return (int)cudaErrorInvalidValue;
  if (build_ptr) launch_row_offsets(t_row, St, num_rows, ptr, st);
  Args a{x, C, ptr, t_col, t_val, St, K, g, g_rs, ar, g_rows, al, num_rows, dx_rows,
         long_rows, long_rows ? n_long : 0, dx_rows > 0 ? dx : nullptr, dal};
  const bool x16 = aligned16(x) && aligned16(g) && (!a.dx || aligned16(a.dx));
  if (x_type == kRowBf16) {
    launch16<bf16_t>(a, x16, st);
  } else if (x_type == kRowF16) {
    launch16<f16_t>(a, x16, st);
  } else if (C % 4 == 0 && x16) {
    launch_shape<float, 4>(a, st);
  } else {
    launch_shape<float, 1>(a, st);
  }
  return (int)cudaGetLastError();
}
